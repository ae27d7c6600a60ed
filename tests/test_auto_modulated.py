"""auto_modulated: structure recovery from black-box operator callbacks
(the bridge from the reference's generic contract, magnus.rs:32, onto the
shared-basis fast path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _y0(B, d, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return cp.from_complex(psi, dtype)


def test_recovers_rank_two_structure():
    model = DrivenDense.make(d=16, seed=0)
    op_fn = lambda t: model.op_pair(t, jnp.float64)
    mod = vexp.auto_modulated(op_fn, 0.0, 2.0)
    assert mod is not None
    assert mod.n_terms == 2  # H0 + cos(wt) V
    # reconstruction at an arbitrary time
    t = 0.7137
    A = op_fn(t)
    R = mod.assemble(jnp.asarray(t, jnp.float64))
    assert float(jnp.max(jnp.abs(R.re - A.re))) < 1e-10
    assert float(jnp.max(jnp.abs(R.im - A.im))) < 1e-10


def test_rejects_unstructured_operator():
    d = 8
    rng = np.random.default_rng(1)
    Ms = rng.standard_normal((40, d, d))

    def op_fn(t):
        # 40 Chebyshev-weighted directions: rank > k_max over [0, 1]
        w = jnp.cos(jnp.arange(40) * 2.1 * jnp.asarray(t))
        return cp.Cplx(
            jnp.einsum("k,kij->ij", w, jnp.asarray(Ms)),
            jnp.zeros((d, d)),
        )

    assert vexp.auto_modulated(op_fn, 0.0, 1.0, k_max=8) is None


def test_rejects_nan_operator():
    def op_fn(t):
        return cp.Cplx(jnp.full((4, 4), jnp.nan), jnp.zeros((4, 4)))

    assert vexp.auto_modulated(op_fn, 0.0, 1.0) is None


def test_zero_operator_returns_none():
    def op_fn(t):
        return cp.Cplx(jnp.zeros((4, 4)), jnp.zeros((4, 4)))

    assert vexp.auto_modulated(op_fn, 0.0, 1.0) is None


def test_solve_via_auto_matches_generic():
    """End to end: black-box op_fn -> auto_modulated -> MagnusModulated4
    reproduces the generic Magnus4(DenseCplxSplit) solve."""
    model = DrivenDense.make(d=16, seed=0)
    op_fn = lambda t: model.op_pair(t, jnp.float64)
    mod = vexp.auto_modulated(op_fn, 0.0, 1.0)
    assert mod is not None
    B = 8
    y0 = _y0(B, 16)
    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)

    sol_a = ensemble_solve(
        None, y0, 0.0, 1.0, stepper=vexp.MagnusModulated4(mod),
        adaptive=True, ctl=ctl, h0=1e-2, time_dtype=jnp.float64,
    )
    sol_g = ensemble_solve(
        op_fn, y0, 0.0, 1.0, stepper=vexp.Magnus4(vexp.DenseCplxSplit()),
        adaptive=True, ctl=ctl, h0=1e-2, time_dtype=jnp.float64,
    )
    assert bool(jnp.all(sol_a.success))
    for pa, pb in [(sol_a.y_final.re, sol_g.y_final.re),
                   (sol_a.y_final.im, sol_g.y_final.im)]:
        assert float(jnp.max(jnp.abs(pa - pb))) < 1e-7


def test_real_operator_support():
    A0 = np.diag(np.arange(1.0, 5.0))
    A1 = np.eye(4)[::-1].copy()

    def op_fn(t):
        return jnp.asarray(A0) + jnp.sin(jnp.asarray(t)) * jnp.asarray(A1)

    mod = vexp.auto_modulated(op_fn, 0.0, 3.0)
    assert mod is not None and mod.n_terms == 2 and not mod.is_cplx
    R = mod.assemble(jnp.asarray(1.234))
    ref = op_fn(1.234)
    assert float(jnp.max(jnp.abs(R - ref))) < 1e-10


def test_auto_op_small_dim_ensemble_matches_generic():
    """A black-box 2-level operator recovered by auto_modulated drives the
    batched modulated stepper over a 256-trajectory f32 ensemble; it
    agrees with the generic dense-split stepper on the same callback."""
    from vec_ode_tpu.models import LandauZener

    lz = LandauZener(v=2.0, delta=0.4)
    op_fn = lambda t: lz.op_pair(t, jnp.float32)  # noqa: E731
    mod = vexp.auto_modulated(op_fn, -20.0, 20.0, dtype=jnp.float32)
    assert mod is not None and mod.n_terms == 2

    B = 256
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float32)
    ctl = vo.StepControl(rtol=1e-5, max_steps=20000)
    sol = ensemble_solve(
        None, y0, -20.0, 20.0, stepper=vexp.MagnusModulated4(mod),
        ctl=ctl, h0=0.05, time_dtype=jnp.float32)
    oracle = ensemble_solve(
        op_fn, y0, -20.0, 20.0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), batched=False),
        ctl=ctl, h0=0.05, time_dtype=jnp.float32,
    )
    assert (np.asarray(sol.status) == vo.DONE).all()
    for a, b in [(sol.y_final.re, oracle.y_final.re),
                 (sol.y_final.im, oracle.y_final.im)]:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=5e-4)


def test_recovers_rapidly_oscillating_coefficient():
    """Structure recovery depends on the operator's matrix subspace, not
    on the smoothness of its coefficient: a chirp with ~1000 oscillations
    is still rank 1, and the projection reconstructs it exactly."""
    sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float64)

    def op_fn(t):
        t = jnp.asarray(t)
        return jnp.cos(8.0 * t * t) * sz

    mod = vexp.auto_modulated(op_fn, 0.0, 30.0)
    assert mod is not None and mod.n_terms == 1
    for tv in (0.3, 7.77, 29.1):
        R = mod.assemble(jnp.asarray(tv))
        assert float(jnp.max(jnp.abs(R - op_fn(tv)))) < 1e-10


def test_coeff_fn_batched_times():
    """coeff_fn accepts per-trajectory (B,) times (the batched drivers'
    quadrature nodes) and equals the scalar calls stacked."""
    sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float64)
    sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float64)
    mod = vexp.auto_modulated(
        lambda t: jnp.sin(jnp.asarray(t)) * sz + 0.3 * sx, 0.0, 3.0)
    assert mod is not None and mod.n_terms == 2
    ts = jnp.asarray([0.1, 0.9, 2.5])
    batched = np.asarray(mod.coeff_fn(ts))
    assert batched.shape == (3, 2)
    for i, tv in enumerate(ts):
        np.testing.assert_allclose(batched[i], np.asarray(mod.coeff_fn(tv)),
                                   rtol=1e-14, atol=1e-14)
