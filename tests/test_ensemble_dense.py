"""Dense output on batched ensembles (ensemble_solve(dense=True)).

The batched driver integrates [t0, tf] free-running and fills each
interior save time with the cubic Hermite of the step that crossed it,
endpoint slopes A(t)x (dense.integrate_interp). The tests pin it against
each trajectory's own dense solve (dense.solve_linear_dense), against a
hand-built interpolating driver, and against tight grid-hitting solves.

Reference contract being beaten: the reference's only save mechanism
truncates steps onto t_list (ode.rs:165-176) — saves perturb the step
sequence; here they do not.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import dense as dn
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.events import Event, LinearObservable
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve
from vec_ode_tpu.utils.prec import HIGHEST

CTL = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-5, max_dt=1.0)


def _dd_setup(B=8, d=16):
    dd = DrivenDense.make(d=d, seed=3)
    mod = dd.modulated(jnp.float32)
    rng = np.random.default_rng(0)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    return mod, cp.from_complex(psi.astype(np.complex64), jnp.float32)


def _lz_setup(B=256):
    mod = LandauZener(v=2.0, delta=0.4).modulated(jnp.float32)
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    return mod, cp.from_complex(psi0, jnp.float32)


def _xla_dense_ref(stepper, mod, y0, t_grid, h0, ctl, adaptive=True):
    """A hand-built interpolating driver: integrate_interp with
    operator-slope Hermite endpoints."""
    step = stepper.make_step_fn()
    basis = mod.basis

    def slope(t, x):
        c = mod.coeff_fn(t)
        A = cp.Cplx(
            jnp.einsum("bk,kij->bij", c, basis.re, precision=HIGHEST),
            jnp.einsum("bk,kij->bij", c, basis.im, precision=HIGHEST),
        )
        return cp.cmatvec(A, x)

    def sfd(t, x, dt):
        xn, err = step(t, x, dt)
        return xn, err, (slope(t, x), slope(t + dt, xn))

    B = y0.re.shape[0]
    return dn.integrate_interp(
        sfd, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
        error_norm=lambda e: e, interp_kind="hermite", tab=None,
        batch_shape=(B,),
    )


def _assert_sol_close(sol, ref, rtol=2e-5, atol=3e-6, counter_tol=0):
    assert np.all(np.asarray(sol.status) == np.asarray(ref.status))
    cdiff = np.max(np.abs(np.asarray(sol.n_accept, np.int64)
                          - np.asarray(ref.n_accept, np.int64)))
    assert cdiff <= counter_tol, cdiff
    for part in ("re", "im"):
        a = np.asarray(getattr(sol.ys, part))
        b = np.asarray(getattr(ref.ys, part))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _f64_setup(B=6, d=8, seed=0):
    dd = DrivenDense.make(d=d, seed=3)
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    return dd.modulated(jnp.float64), cp.from_complex(psi, jnp.float64)


def _dense_vs_alone(st, mod, y0, t0, tf, save, lanes, adaptive=True,
                    ctl=CTL, h0=0.02):
    kw = dict(h0=h0, ctl=ctl, save_at=save, adaptive=adaptive)
    sol = ensemble_solve(None, y0, t0, tf, stepper=st, dense=True, **kw)
    assert sol.path == "xla-driver-dense"
    for b in lanes:
        one = vo.solve_linear_dense(None, t0, tf,
                                    cp.Cplx(y0.re[b], y0.im[b]),
                                    stepper=st, **kw)
        assert int(one.n_accept) == int(sol.n_accept[b])
        np.testing.assert_allclose(np.asarray(sol.ys.re[b]),
                                   np.asarray(one.ys.re), atol=1e-12)
        np.testing.assert_allclose(np.asarray(sol.ys.im[b]),
                                   np.asarray(one.ys.im), atol=1e-12)
    return sol


def test_batched_dense_matches_per_trajectory():
    """Magnus-4 dense ensemble == each trajectory's dense solve (f64);
    free-running: the same step counts as a run without saves."""
    mod, y0 = _f64_setup()
    st = vexp.MagnusModulated4(mod)
    save = np.linspace(0.0, 2.0, 8)[1:-1]
    sol = _dense_vs_alone(st, mod, y0, 0.0, 2.0, save, (0, 5))
    bare = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02, ctl=CTL)
    np.testing.assert_array_equal(np.asarray(sol.n_accept),
                                  np.asarray(bare.n_accept))


def test_small_dim_dense_matches_alone():
    """2-level Landau-Zener dense ensemble == each trajectory alone."""
    mod = LandauZener(v=2.0, delta=0.4).modulated(jnp.float64)
    psi0 = np.zeros((64, 2), np.complex128)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float64)
    _dense_vs_alone(vexp.MagnusModulated4(mod), mod, y0, -6.0, 6.0,
                    np.linspace(-6.0, 6.0, 7)[1:-1], (0, 63), h0=0.01)


def test_dense_cfm_and_midpoint():
    mod, y0 = _f64_setup(seed=2)
    save = np.linspace(0.0, 1.5, 6)[1:-1]
    _dense_vs_alone(vexp.CFM4Modulated(mod), mod, y0, 0.0, 1.5, save,
                    (1,))
    _dense_vs_alone(vexp.MidpointModulated(mod), mod, y0, 0.0, 1.5, save,
                    (1,), adaptive=False,
                    ctl=dataclasses.replace(CTL, max_dt=0.05), h0=0.05)


def test_dense_interpolant_accuracy():
    """The Hermite saves sit within interpolation accuracy of a tight
    grid-hitting solve at the same times (the interpolant's error is
    O(h^4) of the free-running steps)."""
    mod, y0 = _f64_setup(seed=4)
    st = vexp.MagnusModulated4(mod)
    save = np.linspace(0.0, 2.0, 8)[1:-1]
    ctl = dataclasses.replace(CTL, rtol=1e-8)
    sol = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02, ctl=ctl,
                         save_at=save, dense=True)
    ref = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02,
                         ctl=dataclasses.replace(CTL, rtol=1e-11,
                                                 max_steps=20000),
                         save_at=save)
    assert (np.asarray(ref.status) == vo.DONE).all()
    for part in ("re", "im"):
        np.testing.assert_allclose(np.asarray(getattr(sol.ys, part)),
                                   np.asarray(getattr(ref.ys, part)),
                                   atol=1e-6)


def test_dense_many_save_times_and_bare_grid():
    """18 interior save times fill from the same free-running steps; a
    bare [t0, tf] grid reproduces the plain solve."""
    mod, y0 = _f64_setup(seed=6)
    st = vexp.MagnusModulated4(mod)
    big = np.linspace(0.0, 2.0, 20)[1:-1]
    _dense_vs_alone(st, mod, y0, 0.0, 2.0, big, (3,))
    sol = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02, ctl=CTL,
                         dense=True)
    plain = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02,
                           ctl=CTL)
    np.testing.assert_array_equal(np.asarray(sol.n_accept),
                                  np.asarray(plain.n_accept))
    np.testing.assert_allclose(np.asarray(sol.y_final.re),
                               np.asarray(plain.y_final.re), atol=1e-14)


def test_ensemble_dense_matches_hand_built_tier():
    """ensemble_solve(dense=True) on the batched modulated stepper == the
    hand-built integrate_interp driver with operator-slope Hermite (f32),
    save grid broadcast per trajectory."""
    mod, y0 = _dd_setup(B=8, d=16)
    st = vexp.MagnusModulated4(mod)
    save = np.linspace(0.0, 2.0, 8)[1:-1]
    sol = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02, ctl=CTL,
                         save_at=save, dense=True, time_dtype=jnp.float32)
    assert sol.path == "xla-driver-dense"
    assert sol.ts.shape == (8, 8)
    t_grid = jnp.asarray(np.concatenate([[0.0], save, [2.0]]), jnp.float32)
    ref = _xla_dense_ref(st, mod, y0, t_grid, 0.02, CTL)
    _assert_sol_close(sol, ref)


def test_ensemble_dense_vmapped_rk_matches_solve_ivp_dense():
    def f(t, y):
        return -y + 0.1 * jnp.sin(t) * y**2

    rng = np.random.default_rng(1)
    y0 = jnp.asarray(rng.standard_normal((4, 3)))
    save = np.linspace(0.0, 2.0, 5)[1:-1]
    sol = ensemble_solve(f, y0, 0.0, 2.0, stepper=vo.RungeKutta(), h0=0.05,
                         ctl=CTL, save_at=save, dense=True)
    ref = vo.solve_ivp_dense(f, 0.0, 2.0, y0[2], h0=0.05, ctl=CTL,
                             save_at=save)
    np.testing.assert_allclose(np.asarray(sol.ys[2]), np.asarray(ref.ys),
                               rtol=1e-12, atol=1e-14)


def test_ensemble_dense_events_unsupported():
    mod, y0 = _dd_setup(B=8, d=64)
    st = vexp.MagnusModulated4(mod)
    w = np.zeros(128, np.float32)
    w[0] = 1.0
    ev = (LinearObservable(w=w, c=0.35),)
    with pytest.raises(ValueError, match="dense=True with events"):
        ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.02, ctl=CTL,
                       save_at=np.asarray([1.0]), dense=True, events=ev,
                       time_dtype=jnp.float32)


def test_rk_stepper_dense_matches_hand_built_tier():
    """The headline RK stepper (ops/modulated_rk.FusedModulatedLinearRK)
    through ensemble_solve(dense=True) == integrate_interp with its
    hermite_slope endpoints f = (M0 + u(t) M1) x."""
    from vec_ode_tpu.dense import integrate_interp
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=16, seed=0)
    rng = np.random.default_rng(41)
    B = 16
    z = rng.standard_normal((B, 16)) + 1j * rng.standard_normal((B, 16))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float32)
    ctl = dataclasses.replace(CTL, rtol=1e-4)
    save = np.linspace(0.0, 0.5, 7)[1:-1]
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float32)
    sol = ensemble_solve(None, y0, 0.0, 0.5, stepper=st, h0=1e-2, ctl=ctl,
                         save_at=save, dense=True, time_dtype=jnp.float32)
    assert sol.path == "xla-driver-dense"

    fn = st.make_step_fn()

    def sfd(t, x, dt):
        xn, err = fn(t, x, dt)
        return xn, err, (st.hermite_slope(t, x),
                         st.hermite_slope(t + dt, xn))

    t_grid = jnp.asarray(np.concatenate([[0.0], save, [0.5]]), jnp.float32)
    ref = integrate_interp(
        sfd, y0, t_grid, 1e-2, adaptive=True, ctl=ctl,
        error_norm=st.error_norm, interp_kind="hermite", tab=None,
        batch_shape=(B,),
    )
    _assert_sol_close(sol, ref)


def test_ensemble_dense_rk_fallback_uses_hermite_slope():
    """ensemble_solve(dense=True) with the batched RK stepper off-kernel
    lands on the XLA dense tier through hermite_slope (no ModulatedOperator
    needed) and matches the per-trajectory dense.py driver."""
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=64, seed=0)
    rng = np.random.default_rng(5)
    B = 4
    z = rng.standard_normal((B, 64)) + 1j * rng.standard_normal((B, 64))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float32)
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float32)
    save = np.linspace(0.0, 0.5, 5)[1:-1]
    sol = ensemble_solve(None, y0, 0.0, 0.5, stepper=st, h0=1e-2, ctl=CTL,
                         save_at=save, dense=True, time_dtype=jnp.float32)
    assert sol.path == "xla-driver-dense"
    # per-trajectory twin through the generic linear dense driver
    mod = model.modulated(jnp.float32)
    ref = ensemble_solve(None, y0, 0.0, 0.5,
                         stepper=vexp.MagnusModulated4(mod),
                         h0=1e-2, ctl=CTL, save_at=save, dense=True,
                         time_dtype=jnp.float32)
    # different steppers (RKF45 vs Magnus-4): compare at solve accuracy
    for part in ("re", "im"):
        a = np.asarray(getattr(sol.ys, part))
        b = np.asarray(getattr(ref.ys, part))
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-4)


def test_dense_unreached_slots_are_zero():
    """Lanes that die (max_steps) leave later dense slots zeroed — the
    dense driver's never-crossed convention."""
    mod, y0 = _dd_setup(B=8, d=16)
    st = vexp.MagnusModulated4(mod)
    ctl = dataclasses.replace(CTL, max_steps=6, max_dt=0.05)
    save = np.linspace(0.0, 2.0, 6)[1:-1]
    sol = ensemble_solve(None, y0, 0.0, 2.0, stepper=st, h0=0.05, ctl=ctl,
                         save_at=save, dense=True, time_dtype=jnp.float32)
    t_grid = jnp.asarray(np.concatenate([[0.0], save, [2.0]]), jnp.float32)
    ref = _xla_dense_ref(st, mod, y0, t_grid, 0.05, ctl)
    assert np.all(np.asarray(sol.status) == vo.ERR_MAX_STEPS)
    _assert_sol_close(sol, ref)
    # the last slots really are zeros (never crossed in 6 steps of <=0.05)
    assert np.all(np.asarray(sol.ys.re)[:, -1] == 0.0)
