"""fast_error on the MODULATED Magnus-4 (exp/modulated.py): the embedded
error becomes ONE commutator-basis contraction on the advanced state
(dv = w2*xf) instead of a second full Taylor chain — the modulated twin of
exp/magnus.py Magnus4(fast_error=True), with exact f64 parity to it.

Checked per step and per solve against the generic dense-split
fast_error stepper, on small-d and 2-level ensembles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _psi0(d, B=None, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    shape = (d,) if B is None else (B, d)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return cp.from_complex(z, dtype)


def test_fast_error_matches_generic_exactly():
    """f64, single trajectory: modulated fast_error == generic dense-split
    Magnus4(fast_error=True) — identical accept/reject sequences (the two
    paths compute the SAME w2·xf estimate)."""
    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float64)
    psi0 = _psi0(8, seed=5)
    op_fn = lambda t: model.op_pair(t, jnp.float64)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)
    sm = vo.solve_linear(
        None, 0.0, 1.5, psi0,
        stepper=vexp.MagnusModulated4(mod, fast_error=True),
        adaptive=True, ctl=ctl, h0=1e-2)
    sg = vo.solve_linear(
        op_fn, 0.0, 1.5, psi0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True),
        adaptive=True, ctl=ctl, h0=1e-2)
    assert int(sm.status) == vo.DONE == int(sg.status)
    assert int(sm.n_accept) == int(sg.n_accept)
    assert int(sm.n_reject) == int(sg.n_reject)
    np.testing.assert_allclose(np.asarray(sm.y_final.re),
                               np.asarray(sg.y_final.re),
                               rtol=1e-12, atol=1e-12)


def test_fast_error_accuracy_vs_pair():
    """The fast estimate changes only the error CONSTANT: at the same
    rtol, the accepted solution stays within tolerance-scale distance of
    the pair default's, and unitarity holds."""
    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float64)
    psi0 = _psi0(8, seed=7)
    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.3)
    sf = vo.solve_linear(None, 0.0, 2.0, psi0,
                         stepper=vexp.MagnusModulated4(mod,
                                                       fast_error=True),
                         adaptive=True, ctl=ctl, h0=1e-2)
    sp = vo.solve_linear(None, 0.0, 2.0, psi0,
                         stepper=vexp.MagnusModulated4(mod),
                         adaptive=True, ctl=ctl, h0=1e-2)
    n = float(jnp.sum(sf.y_final.re ** 2 + sf.y_final.im ** 2))
    assert abs(n - 1) < 1e-10
    d = float(jnp.abs(sf.y_final.re - sp.y_final.re).max())
    assert d < 1e-6, d


def test_fast_error_batched_solve_matches_generic():
    """Batched ensemble with fast_error: the same step sequences and
    trajectories as the generic fast_error stepper solved per trajectory
    (f64)."""
    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float64)
    op_fn = lambda t: model.op_pair(t, jnp.float64)  # noqa: E731
    y0 = _psi0(8, B=6, seed=21)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-5, max_dt=0.2, max_steps=500)
    kw = dict(adaptive=True, ctl=ctl, h0=1e-2, time_dtype=jnp.float64)
    sol_b = ensemble_solve(
        None, y0, 0.0, 0.5,
        stepper=vexp.MagnusModulated4(mod, fast_error=True), **kw)
    sol_g = ensemble_solve(
        op_fn, y0, 0.0, 0.5,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True,
                             batched=False), **kw)
    assert (np.asarray(sol_b.status) == vo.DONE).all()
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(sol_g.n_accept))
    np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                               np.asarray(sol_g.y_final.re), atol=1e-9)


def test_fast_error_batched_step_matches_generic():
    """One batched fast_error step == the generic fast_error step taken
    per trajectory: y and the error estimate (f64)."""
    from vec_ode_tpu import lc

    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float64)
    op_fn = lambda t: model.op_pair(t, jnp.float64)  # noqa: E731
    B = 6
    y0 = _psi0(8, B=B, seed=3)
    t = jnp.asarray(np.linspace(0.0, 0.5, B))
    dt = jnp.full((B,), 5e-2)
    yf, e = vexp.MagnusModulated4(mod, fast_error=True).make_step_fn()(
        t, y0, dt)
    gen = vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True).make_step_fn(
        op_fn)
    for b in range(B):
        yb, eb = gen(t[b], cp.Cplx(y0.re[b], y0.im[b]), dt[b])
        np.testing.assert_allclose(np.asarray(yf.re[b]), np.asarray(yb.re),
                                   rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(float(e[b]), float(lc.norm_l2(eb)),
                                   rtol=1e-8)
    assert float(np.asarray(e).max()) > 0.0


def test_fast_error_small_dim_ensemble():
    """2-level f32 ensemble with fast_error on the batched driver matches
    the generic fast_error stepper on the same operator."""
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float32)
    B = 256
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float32)
    ctl = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4,
                         max_dt=1.0)
    kw = dict(adaptive=True, h0=1e-2, ctl=ctl, time_dtype=jnp.float32)
    sol = ensemble_solve(
        None, y0, -20.0, 20.0,
        stepper=vexp.MagnusModulated4(mod, fast_error=True), **kw)
    oracle = ensemble_solve(
        lambda t: lz.op_pair(t, jnp.float32), y0, -20.0, 20.0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True,
                             batched=False), **kw)
    assert (np.asarray(sol.status) == vo.DONE).all()
    a_f, a_x = np.asarray(sol.n_accept), np.asarray(oracle.n_accept)
    assert (a_f == a_x).mean() > 0.8, (a_f, a_x)
    np.testing.assert_allclose(np.asarray(sol.y_final.re),
                               np.asarray(oracle.y_final.re),
                               rtol=2e-4, atol=2e-4)


def test_fast_error_with_weighted_norm():
    """fast_error + a declared WeightedNorm compose: the w2*xf estimate is
    normed by the declaration — exact f64 parity with the generic
    fast_error stepper under the same norm as a driver-applied callable,
    also on a 2-level f32 ensemble."""
    from vec_ode_tpu import lc

    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float64)
    psi0 = _psi0(8, seed=5)
    op_fn = lambda t: model.op_pair(t, jnp.float64)
    w = np.linspace(0.25, 3.0, 8)
    wn = lc.WeightedNorm("l2", weights=w)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)
    sm = vo.solve_linear(
        None, 0.0, 1.5, psi0,
        stepper=vexp.MagnusModulated4(mod, fast_error=True, norm=wn),
        adaptive=True, ctl=ctl, h0=1e-2)
    sg = vo.solve_linear(
        op_fn, 0.0, 1.5, psi0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True),
        error_norm=wn, adaptive=True, ctl=ctl, h0=1e-2)
    assert int(sm.n_accept) == int(sg.n_accept)
    assert int(sm.n_reject) == int(sg.n_reject)
    np.testing.assert_allclose(np.asarray(sm.y_final.re),
                               np.asarray(sg.y_final.re),
                               rtol=1e-12, atol=1e-12)

    # batched f32 ensemble x fast_error x norm vs the generic stepper
    lz = LandauZener(v=2.0, delta=0.4)
    modz = lz.modulated(jnp.float32)
    B = 256
    p0 = np.zeros((B, 2), np.complex64)
    p0[:, 0] = 1.0
    y0 = cp.from_complex(p0, jnp.float32)
    wnz = lc.WeightedNorm("l2", weights=np.asarray([2.0, 0.5], np.float32))
    ctlz = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4,
                          max_dt=1.0)
    kw = dict(adaptive=True, h0=1e-2, ctl=ctlz, time_dtype=jnp.float32)
    sol = ensemble_solve(
        None, y0, -20.0, 20.0,
        stepper=vexp.MagnusModulated4(modz, fast_error=True, norm=wnz), **kw)
    oracle = ensemble_solve(
        lambda t: lz.op_pair(t, jnp.float32), y0, -20.0, 20.0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True,
                             batched=False),
        error_norm=wnz, **kw)
    a_f, a_x = np.asarray(sol.n_accept), np.asarray(oracle.n_accept)
    assert (a_f == a_x).mean() > 0.8, (a_f, a_x)
    np.testing.assert_allclose(np.asarray(sol.y_final.re),
                               np.asarray(oracle.y_final.re),
                               rtol=2e-4, atol=2e-4)
