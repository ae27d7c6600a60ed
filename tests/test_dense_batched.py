"""The batched executor of the generic dense exponential steppers
(exp/dense_fast.py: one stacked batched expm for every chain exponent of a
step) and its stepper wiring, checked against direct per-lane expm
composition and against the vmapped scalar path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.expm import expm
from vec_ode_tpu.exp import dense_fast as df
from vec_ode_tpu.parallel import ensemble_solve

B, D = 16, 128


def _rand_ops(n, scale=0.15, seed=0):
    rng = np.random.default_rng(seed)
    return [
        jnp.asarray(
            rng.standard_normal((B, D, D)).astype(np.float32) * scale / D**0.5
        )
        for _ in range(n)
    ]


def _x():
    rng = np.random.default_rng(1)
    return jnp.asarray(rng.standard_normal((B, D)).astype(np.float32))


def _chains(chains, xw, adaptive=True):
    """run_batched_chains over a real DenseSplit (y, err_norm)."""
    return df.run_batched_chains(
        vexp.DenseSplit(), xw, jnp.zeros((xw.shape[0],), xw.dtype),
        lambda: chains, adaptive=adaptive)


def _apply_chain(chain, xw):
    v = xw.astype(jnp.float64)
    for W in chain:
        v = jnp.einsum("bij,bj->bi", expm(W.astype(jnp.float64),
                                          method="taylor"), v)
    return v


def test_batched_chains_match_expm():
    """The stacked-expm executor == per-lane expm-based propagator
    application, and the error norm is the chains' distance."""
    (W,) = _rand_ops(1)
    xw = _x()
    y, e = _chains([[W], [0.5 * W]], xw)
    y_ref = _apply_chain([W], xw)
    assert float(jnp.max(jnp.abs(y - y_ref.astype(jnp.float32)))) < 1e-5
    e_ref = jnp.linalg.norm(_apply_chain([0.5 * W], xw) - y_ref, axis=-1)
    assert float(jnp.max(jnp.abs(e - e_ref.astype(jnp.float32)))) < 1e-5


def test_batched_magnus_like_chains_match_expm():
    """A 2-chain Magnus-like structure with a commutator exponent."""
    from vec_ode_tpu.utils.prec import HIGHEST

    A1, A2 = _rand_ops(2)
    xw = _x()
    dt = jnp.asarray(
        np.random.default_rng(2).uniform(0.05, 0.2, B).astype(np.float32)
    )
    dt3 = dt[:, None, None]
    w1 = 0.5 * dt3 * (A1 + A2)
    mmb = lambda a, b: jnp.matmul(a, b, precision=HIGHEST)  # noqa: E731
    omega = w1 + 0.1 * dt3 * dt3 * (mmb(A1, A2) - mmb(A2, A1))
    y, e = _chains([[omega], [w1]], xw)
    y_ref = _apply_chain([omega], xw)
    e_ref = jnp.linalg.norm(_apply_chain([w1], xw) - y_ref, axis=-1)
    # f32 executor against the f64 truth: f32 rounding of O(1) states
    # through 128-wide products
    assert float(jnp.max(jnp.abs(y - y_ref))) < 4e-6
    assert float(jnp.max(jnp.abs(e - e_ref))) < 4e-6


def test_batched_chains_large_norm_squares():
    """Batch-uniform scaling engages (one lane with a large-norm exponent)
    and every lane still matches its own expm."""
    (W,) = _rand_ops(1)
    W = W.at[3].mul(40.0)  # push lane 3 past theta -> s > 0
    xw = _x()
    y, _ = _chains([[W]], xw, adaptive=False)
    y_ref = _apply_chain([W], xw)
    # per-lane RELATIVE error: the boosted lane's propagator amplifies the
    # state, so absolute tolerances are meaningless there
    scale = jnp.maximum(jnp.max(jnp.abs(y_ref), axis=1), 1.0)
    rel = jnp.max(jnp.abs(y - y_ref.astype(jnp.float32)), axis=1) / scale
    assert float(jnp.max(rel)) < 2e-4


@pytest.mark.parametrize("make", [
    lambda **kw: vexp.Magnus4(vexp.DenseCplxSplit(), **kw),
    lambda **kw: vexp.CFM4(vexp.DenseCplxSplit(), **kw),
    lambda **kw: vexp.Magnus6(vexp.DenseCplxSplit(), **kw),
])
def test_batched_stepper_matches_scalar_vmap_f64(make):
    """Natively-batched generic steppers reproduce
    the vmapped scalar path bit-near-exactly in f64."""
    model = DrivenDense.make(d=64, seed=0)
    rng = np.random.default_rng(0)
    psi = rng.standard_normal((B, 64)) + 1j * rng.standard_normal((B, 64))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float64)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.25)

    def solve(stepper):
        return ensemble_solve(
            lambda t: model.op_pair(t, jnp.float64), y0, 0.0, 0.5,
            stepper=stepper, adaptive=True, ctl=ctl, h0=1e-2,
            time_dtype=jnp.float64,
        )

    a = solve(make())
    b = solve(make(batched=False))
    assert bool(jnp.all(a.success)) and bool(jnp.all(b.success))
    assert np.array_equal(np.asarray(a.n_accept), np.asarray(b.n_accept))
    for pa, pb in [(a.y_final.re, b.y_final.re), (a.y_final.im, b.y_final.im)]:
        assert float(jnp.max(jnp.abs(pa - pb))) < 5e-9


@pytest.mark.parametrize("make", [
    lambda **kw: vexp.Magnus4(vexp.DenseCplxSplit(), **kw),
    lambda **kw: vexp.CFM4(vexp.DenseCplxSplit(), **kw),
    lambda **kw: vexp.ExpMidpoint(vexp.DenseCplxSplit(), **kw),
    lambda **kw: vexp.Magnus6(vexp.DenseCplxSplit(), **kw),
])
def test_batched_stepper_f32_matches_scalar_vmap(make):
    """The batched executor in f32 matches the vmapped scalar path in f32
    through a full ensemble solve (f32 rounding of two expm schedules)."""
    model = DrivenDense.make(d=16, seed=0)
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((B, 16)) + 1j * rng.standard_normal((B, 16))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float32)
    ctl = vo.StepControl(rtol=1e-5, min_dt=1e-5, max_dt=0.25)
    adaptive = not isinstance(make(), vexp.ExpMidpoint)

    def solve(stepper):
        return ensemble_solve(
            lambda t: model.op_pair(t, jnp.float32), y0, 0.0, 0.3,
            stepper=stepper, adaptive=adaptive, ctl=ctl, h0=1e-2,
            time_dtype=jnp.float32,
        )

    a = solve(make())
    b = solve(make(batched=False))
    assert bool(jnp.all(a.success))
    for pa, pb in [(a.y_final.re, b.y_final.re), (a.y_final.im, b.y_final.im)]:
        assert float(jnp.max(jnp.abs(pa - pb))) < 1e-5


def test_unequal_chain_lengths():
    """CFM error chains are SHORTER than the main chain — no zero-row
    padding; the executor handles per-chain lengths natively."""
    A1, A2 = _rand_ops(2, scale=0.3, seed=5)
    xw = _x()
    y, e = _chains([[0.3 * A1, 0.3 * A2], [0.15 * (A1 + A2)]], xw)
    y_ref = _apply_chain([0.3 * A1, 0.3 * A2], xw)
    e_ref = jnp.linalg.norm(_apply_chain([0.15 * (A1 + A2)], xw) - y_ref,
                            axis=-1)
    assert float(jnp.max(jnp.abs(y - y_ref))) < 1e-5
    assert float(jnp.max(jnp.abs(e - e_ref))) < 1e-5


def test_nan_lane_stays_local():
    """A NaN operator in one lane must not poison other lanes (the scaling
    guard keeps control flow finite)."""
    (W,) = _rand_ops(1)
    W = W.at[2].set(jnp.nan)
    xw = _x()
    y, e = _chains([[W], [0.5 * W]], xw)
    assert bool(jnp.all(jnp.isnan(y[2])))
    assert bool(jnp.all(jnp.isfinite(jnp.delete(y, 2, axis=0))))
    assert bool(jnp.all(jnp.isfinite(jnp.delete(e, 2, axis=0))))


def test_scalar_solve_linear_unchanged():
    """solve_linear (scalar path) still runs the reference-shaped pytree
    math for batched-capable steppers."""
    model = DrivenDense.make(d=8, seed=0)
    rng = np.random.default_rng(4)
    psi = rng.standard_normal(8) + 1j * rng.standard_normal(8)
    psi /= np.linalg.norm(psi)
    y0 = cp.from_complex(psi, jnp.float64)
    sol = vo.solve_linear(
        lambda t: model.op_pair(t, jnp.float64), 0.0, 0.5, y0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()), adaptive=True,
        ctl=vo.StepControl(rtol=1e-8, max_dt=0.25), h0=1e-2,
    )
    assert int(sol.status) == vo.DONE
    nrm = float(jnp.sqrt(jnp.sum(sol.y_final.re**2 + sol.y_final.im**2)))
    assert abs(nrm - 1.0) < 1e-6


def _split_pair_ops(d=8, seed=11):
    """ops_fn(t) -> (La, Lb) Cplx pair for a driven split system."""
    rng = np.random.default_rng(seed)

    def herm():
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        return (M + M.conj().T) / (2 * np.sqrt(d))

    HA, HB = herm(), herm()
    Ar = jnp.asarray(HA.imag, jnp.float64)
    Ai = jnp.asarray(-HA.real, jnp.float64)
    Br = jnp.asarray(HB.imag, jnp.float64)
    Bi = jnp.asarray(-HB.real, jnp.float64)

    def ops_fn(t):
        c = jnp.cos(1.3 * jnp.asarray(t))
        return (cp.Cplx(Ar * c, Ai * c), cp.Cplx(Br, Bi))

    return ops_fn


@pytest.mark.parametrize("make", [
    lambda **kw: vexp.SplitMidpoint(
        vexp.DenseCplxSplit(), vexp.DenseCplxSplit(), **kw),
    lambda **kw: vexp.SplitMidpoint(
        vexp.DenseCplxSplit(), vexp.DenseCplxSplit(),
        strict_reference_compat=True, **kw),
    lambda **kw: vexp.SplitCFM(
        vexp.DenseCplxSplit(), vexp.DenseCplxSplit(),
        rho=((0.5, 0.5),), sigma=((0.5, 0.0), (0.0, 0.5)),
        c=(0.2113248654051871, 0.7886751345948129), **kw),
])
def test_split_solvers_batched_matches_scalar_vmap(make):
    """SplitMidpoint / SplitCFM over dense pairs execute natively
    batched (stacked expm of the whole factor palindrome) — must match
    the vmapped scalar path exactly."""
    d = 8
    ops_fn = _split_pair_ops(d=d)
    rng = np.random.default_rng(1)
    psi = rng.standard_normal((8, d)) + 1j * rng.standard_normal((8, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float64)

    def solve(stepper):
        return ensemble_solve(
            ops_fn, y0, 0.0, 0.4, stepper=stepper, adaptive=False,
            h0=0.02, time_dtype=jnp.float64,
        )

    a = solve(make())
    assert a.path == "xla-driver"
    b = solve(make(batched=False))
    assert bool(jnp.all(a.success))
    for pa, pb in [(a.y_final.re, b.y_final.re), (a.y_final.im, b.y_final.im)]:
        assert float(jnp.max(jnp.abs(pa - pb))) < 1e-12
