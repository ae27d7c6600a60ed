"""Small-dimensional ensembles on the batched driver: many 2-level
trajectories (the reference's bread-and-butter regime, BASELINE config 3,
magnus.rs:10-26 semantics) integrated as ONE batch. Every per-trajectory
scalar (t, h, status, error norm, counters) is its own lane of the batched
carry, so fixed-step, adaptive control and per-trajectory h0 keep exact
per-trajectory semantics: the batched results are pinned against each
trajectory solved alone, and against f64 references.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve

LZ = LandauZener(v=2.0, delta=0.4)


def _lz_setup(B=256, dtype=jnp.float32):
    mod = LZ.modulated(dtype)
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    return LZ, mod, cp.from_complex(psi0, dtype)


def _random_states(B, seed, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, 2)) + 1j * rng.standard_normal((B, 2))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return cp.from_complex(psi, dtype)


def _alone(stepper, y0, b, t0, tf, **kw):
    """Trajectory b solved on its own (unbatched driver)."""
    return vo.solve_linear(None, t0, tf, cp.Cplx(y0.re[b], y0.im[b]),
                           stepper=stepper, **kw)


def _batched(stepper, y0, t0, tf, **kw):
    return ensemble_solve(None, y0, t0, tf, stepper=stepper, **kw)


def _check_against_alone(stepper, y0, t0, tf, lanes, atol, counters=True,
                         **kw):
    sol = _batched(stepper, y0, t0, tf, **kw)
    for b in lanes:
        one = _alone(stepper, y0, b, t0, tf, **kw)
        assert int(one.status) == int(sol.status[b])
        if counters:
            assert int(one.n_accept) == int(sol.n_accept[b])
            assert int(one.n_reject) == int(sol.n_reject[b])
        np.testing.assert_allclose(np.asarray(sol.y_final.re[b]),
                                   np.asarray(one.y_final.re), atol=atol)
        np.testing.assert_allclose(np.asarray(sol.y_final.im[b]),
                                   np.asarray(one.y_final.im), atol=atol)
    return sol


def test_midpoint_fixed_step_matches_alone():
    _, mod, y0 = _lz_setup()
    sol = _check_against_alone(
        vexp.MidpointModulated(mod), y0, -20.0, 20.0, (0, 255), atol=1e-6,
        adaptive=False, h0=40.0 / 500, time_dtype=jnp.float32)
    assert (np.asarray(sol.status) == vo.DONE).all()
    assert (np.asarray(sol.n_accept) == 500).all()


def test_magnus4_fixed_step_matches_reference():
    """Fixed-step Magnus-4 on the batch: the populations match a tight f64
    reference, which matches the asymptotic LZ formula."""
    _, mod, y0 = _lz_setup()
    sol = _batched(vexp.MagnusModulated4(mod, adaptive=False), y0,
                   -20.0, 20.0, adaptive=False, h0=40.0 / 3200,
                   ctl=vo.StepControl(max_steps=4000),
                   time_dtype=jnp.float32)
    assert (np.asarray(sol.status) == vo.DONE).all()
    _, mod64, y64 = _lz_setup(B=1, dtype=jnp.float64)
    ref = _alone(vexp.MagnusModulated4(mod64), y64, 0, -20.0, 20.0,
                 adaptive=True, h0=1e-2,
                 ctl=vo.StepControl(rtol=1e-9, max_steps=40000))
    assert int(ref.status) == vo.DONE
    # populations (the global phase of a 40-unit sweep carries the
    # fixed-step phase error; the transition probability hardly does)
    pop = np.asarray(sol.y_final.re) ** 2 + np.asarray(sol.y_final.im) ** 2
    pop_ref = (np.asarray(ref.y_final.re) ** 2
               + np.asarray(ref.y_final.im) ** 2)
    np.testing.assert_allclose(pop, np.broadcast_to(pop_ref, (256, 2)),
                               atol=1e-4)
    assert abs(pop_ref[0] - LZ.p_transition) < 5e-3


def test_interior_saves_match_alone():
    _, mod, y0 = _lz_setup()
    save = np.asarray([-5.0, 0.0, 5.0])
    st = vexp.MidpointModulated(mod)
    kw = dict(adaptive=False, h0=40.0 / 400, save_at=save,
              time_dtype=jnp.float32)
    sol = _batched(st, y0, -20.0, 20.0, **kw)
    one = _alone(st, y0, 7, -20.0, 20.0, **kw)
    assert sol.ys.re.shape == (256, 5, 2)
    np.testing.assert_allclose(np.asarray(sol.ys.re[7]),
                               np.asarray(one.ys.re), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol.ys.im[7]),
                               np.asarray(one.ys.im), atol=1e-6)


def test_unitarity_and_no_cross_talk():
    """Distinct initial states per trajectory: each lane evolves exactly
    as its own solve (no coupling through the batch), norms stay 1."""
    _, mod, _ = _lz_setup()
    y0 = _random_states(64, seed=3, dtype=jnp.float32)
    sol = _check_against_alone(
        vexp.MidpointModulated(mod), y0, -20.0, 20.0, (0, 17, 63),
        atol=2e-6, adaptive=False, h0=40.0 / 500, time_dtype=jnp.float32)
    n = np.asarray(sol.y_final.re) ** 2 + np.asarray(sol.y_final.im) ** 2
    np.testing.assert_allclose(n.sum(-1), 1.0, atol=1e-4)


def test_odd_batch_size():
    """Any batch size runs (no tile or group multiple): B = 37."""
    _, mod, y0 = _lz_setup(B=37)
    sol = _check_against_alone(
        vexp.MidpointModulated(mod), y0, -20.0, 20.0, (36,), atol=1e-6,
        adaptive=False, h0=40.0 / 500, time_dtype=jnp.float32)
    assert sol.y_final.re.shape == (37, 2)
    assert (np.asarray(sol.status) == vo.DONE).all()


def test_adaptive_magnus4_matches_alone():
    """ADAPTIVE control is per trajectory: counters and accept/reject
    sequences match each trajectory solved alone (f64)."""
    _, mod, _ = _lz_setup(dtype=jnp.float64)
    y0 = _random_states(16, seed=5)
    _check_against_alone(
        vexp.MagnusModulated4(mod), y0, -8.0, 8.0, (0, 9, 15), atol=1e-10,
        adaptive=True, h0=0.05,
        ctl=vo.StepControl(rtol=1e-8, max_steps=20000))


def test_adaptive_divergent_control_per_trajectory():
    """Heterogeneous difficulty across the batch: per-trajectory error
    estimates differ, so h sequences diverge between lanes — counters
    still match each trajectory's own solve, and they do differ."""
    _, mod, _ = _lz_setup(dtype=jnp.float64)
    y0 = _random_states(8, seed=9)
    y0 = cp.Cplx(y0.re * jnp.asarray([1, 3, 1, 5, 1, 1, 2, 1.0])[:, None],
                 y0.im * jnp.asarray([1, 3, 1, 5, 1, 1, 2, 1.0])[:, None])
    sol = _check_against_alone(
        vexp.MagnusModulated4(mod), y0, -8.0, 8.0, range(8), atol=1e-9,
        adaptive=True, h0=0.05,
        ctl=vo.StepControl(rtol=1e-8, max_steps=20000))
    assert np.ptp(np.asarray(sol.n_accept)) > 0


def test_nan_containment():
    """A trajectory with a NaN initial state must NOT poison its batch
    neighbors: it stays NaN, every other lane is clean and matches the
    run without it (fixed step)."""
    _, mod, y0 = _lz_setup()
    y0n = cp.Cplx(y0.re.at[5, 0].set(jnp.nan), y0.im)
    st = vexp.MidpointModulated(mod)
    kw = dict(adaptive=False, h0=40.0 / 500, time_dtype=jnp.float32)
    sol = _batched(st, y0n, -20.0, 20.0, **kw)
    clean = _batched(st, y0, -20.0, 20.0, **kw)
    re = np.asarray(sol.y_final.re)
    im = np.asarray(sol.y_final.im)
    assert np.isnan(re[5]).all()
    keep = np.ones(256, bool)
    keep[5] = False
    assert np.isfinite(re[keep]).all() and np.isfinite(im[keep]).all()
    np.testing.assert_allclose(re[keep],
                               np.asarray(clean.y_final.re)[keep],
                               atol=2e-5)


def test_adaptive_nan_trajectory_stalls_alone():
    """Adaptive: the NaN trajectory permanently rejects and stalls
    (ERR_STALLED), neighbors finish DONE — per trajectory."""
    _, mod, y0 = _lz_setup()
    y0n = cp.Cplx(y0.re.at[5, 0].set(jnp.nan), y0.im)
    sol = _batched(vexp.MagnusModulated4(mod), y0n, -8.0, 8.0,
                   adaptive=True, h0=0.05, time_dtype=jnp.float32,
                   ctl=vo.StepControl(rtol=1e-5, max_steps=4000,
                                      max_reject_streak=50))
    status = np.asarray(sol.status)
    assert status[5] == vo.ERR_STALLED, status[5]
    keep = np.ones(256, bool)
    keep[5] = False
    assert (status[keep] == vo.DONE).all()


def test_rk_stepper_small_dim_matches_generic():
    """The natively batched RK stepper on a d=2 modulated-linear system
    matches the generic RungeKutta stepper per trajectory (f64)."""
    from vec_ode_tpu.models import DrivenDense
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=2, seed=4)
    y0 = _random_states(32, seed=13)
    kw = dict(adaptive=True, h0=1e-2, time_dtype=jnp.float64,
              ctl=vo.StepControl(rtol=1e-8, max_steps=4000))
    sol_b = ensemble_solve(
        None, y0, 0.0, 3.0,
        stepper=FusedModulatedLinearRK.from_driven_dense(model,
                                                         jnp.float64), **kw)
    sol_g = ensemble_solve(
        lambda t, y: model.rhs_pair(t, y, jnp.float64), y0, 0.0, 3.0,
        stepper=vo.RungeKutta(vo.RKF45), **kw)
    assert (np.asarray(sol_b.status) == vo.DONE).all()
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(sol_g.n_accept))
    np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                               np.asarray(sol_g.y_final.re), atol=1e-12)


def test_cfm4_adaptive_matches_alone():
    _, mod, _ = _lz_setup(dtype=jnp.float64)
    y0 = _random_states(16, seed=17)
    _check_against_alone(
        vexp.CFM4Modulated(mod), y0, -8.0, 8.0, (0, 8, 15), atol=1e-10,
        adaptive=True, h0=0.05,
        ctl=vo.StepControl(rtol=1e-8, max_steps=20000))


def test_small_dim_adjoint_gradient_matches_fd():
    """A d=2 control problem over a 64-trajectory batch: the reversible
    adjoint's gradient matches central finite differences (f64)."""
    from vec_ode_tpu import diff

    sx = jnp.asarray([[0.0, 1.0], [1.0, 0.0]])
    sz = jnp.asarray([[1.0, 0.0], [0.0, -1.0]])
    basis = cp.Cplx(jnp.zeros((2, 2, 2)), -jnp.stack([sx, sz]))

    def coeff_fn(t, th):
        t = jnp.asarray(t)
        return jnp.stack(
            [jnp.ones_like(t), th[0] * jnp.cos(th[1] * t)], axis=-1)

    y0 = _random_states(64, seed=11)
    theta = jnp.asarray([0.6, 1.3])

    def loss(th):
        yf = diff.adjoint_solve(basis, coeff_fn, th, y0, 0.0, 1.5, 24,
                                order=4)
        return jnp.sum(yf.re ** 2 + yf.re * yf.im)

    v, g = jax.value_and_grad(loss)(theta)
    eps = 1e-6
    for i in range(2):
        e = jnp.zeros(2).at[i].set(eps)
        fd = (loss(theta + e) - loss(theta - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-6,
                                   atol=1e-9)


def test_adaptive_interior_saves_match_alone():
    """Interior save_at grid hits under ADAPTIVE control: each lane's
    recorded states match its own solve (f64)."""
    _, mod, _ = _lz_setup(dtype=jnp.float64)
    y0 = _random_states(16, seed=19)
    st = vexp.MagnusModulated4(mod)
    kw = dict(adaptive=True, h0=0.05, save_at=np.asarray([-2.0, 3.0]),
              ctl=vo.StepControl(rtol=1e-8, max_steps=20000))
    sol = _batched(st, y0, -8.0, 8.0, **kw)
    for b in (0, 15):
        one = _alone(st, y0, b, -8.0, 8.0, **kw)
        np.testing.assert_allclose(np.asarray(sol.ys.re[b]),
                                   np.asarray(one.ys.re), atol=1e-10)
        np.testing.assert_allclose(np.asarray(sol.ys.im[b]),
                                   np.asarray(one.ys.im), atol=1e-10)


def test_magnus6_adaptive_matches_alone():
    _, mod, _ = _lz_setup(dtype=jnp.float64)
    y0 = _random_states(16, seed=23)
    _check_against_alone(
        vexp.MagnusModulated6(mod), y0, -8.0, 8.0, (0, 15), atol=1e-10,
        adaptive=True, h0=0.05,
        ctl=vo.StepControl(rtol=1e-9, max_steps=20000, order=7))


def test_f32_ensemble_counter_bound():
    """The f32 batch against the same batch in f64: fixed steps (control
    out of the loop) differ only by f32 rounding summed over 400 steps;
    adaptive counters stay within +-2 of the f64 run (a marginal step,
    with f = rtol/err within an ulp of 1, may flip its accept)."""
    st32 = vexp.MagnusModulated4(_lz_setup()[1], adaptive=False)
    _, mod64, y64 = _lz_setup(dtype=jnp.float64)
    y32 = _lz_setup()[2]
    kw = dict(adaptive=False, h0=40.0 / 400)
    s32 = _batched(st32, y32, -20.0, 20.0, time_dtype=jnp.float32, **kw)
    s64 = _batched(vexp.MagnusModulated4(mod64, adaptive=False), y64,
                   -20.0, 20.0, **kw)
    d = np.abs(np.asarray(s32.y_final.re) - np.asarray(s64.y_final.re)).max()
    assert 0.0 < d < 1e-4, d
    ctl = vo.StepControl(rtol=1e-6, max_steps=2000)
    a32 = _batched(vexp.MagnusModulated4(_lz_setup()[1]), y32, -20.0, 20.0,
                   adaptive=True, h0=0.05, ctl=ctl, time_dtype=jnp.float32)
    a64 = _batched(vexp.MagnusModulated4(mod64), y64, -20.0, 20.0,
                   adaptive=True, h0=0.05, ctl=ctl)
    assert np.abs(np.asarray(a32.n_accept)
                  - np.asarray(a64.n_accept)).max() <= 2
    assert np.abs(np.asarray(a32.n_reject)
                  - np.asarray(a64.n_reject)).max() <= 2
