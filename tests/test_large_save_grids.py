"""Large save grids on the batched driver.

The reference's t_list checkpointing (/root/reference/src/base/ode.rs:
165-176) has no batch and re-perturbs h at every save. Here a batched
ensemble hits every save time of a large grid exactly: the recorded states
and counters match each trajectory solved alone (f64), a terminal event
freezes its lane (later save slots stay zero), and the natively batched RK
stepper records the same grid as the generic RK stepper.
"""

import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.events import Event, EventConfig, QuadraticObservable
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _rand_state(B, d, seed=3, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return cp.from_complex(z, dtype)


CTL = vo.StepControl(rtol=1e-7, min_dt=1e-5, max_dt=0.2, max_steps=4000)


def _grid_vs_alone(stepper, y0, tf, save_at, lanes, **kw):
    kw = dict(adaptive=True, ctl=CTL, h0=1e-2, save_at=save_at, **kw)
    sol = ensemble_solve(None, y0, 0.0, tf, stepper=stepper, **kw)
    assert (np.asarray(sol.status) == vo.DONE).all()
    np.testing.assert_array_equal(np.asarray(sol.ts[0, 1:-1]), save_at)
    for b in lanes:
        one = vo.solve_linear(None, 0.0, tf, cp.Cplx(y0.re[b], y0.im[b]),
                              stepper=stepper, **kw)
        assert int(one.n_accept) == int(sol.n_accept[b])
        assert int(one.n_iters) == int(sol.n_iters[b])
        np.testing.assert_allclose(np.asarray(sol.ys.re[b]),
                                   np.asarray(one.ys.re), atol=1e-10)
        np.testing.assert_allclose(np.asarray(sol.ys.im[b]),
                                   np.asarray(one.ys.im), atol=1e-10)
    return sol


def test_40pt_grid_matches_alone():
    mod = DrivenDense.make(d=8, seed=0).modulated(jnp.float64)
    save_at = np.linspace(0.0, 0.6, 42)[1:-1]
    sol = _grid_vs_alone(vexp.MagnusModulated4(mod), _rand_state(6, 8), 0.6,
                         save_at, (0, 5))
    assert sol.ys.re.shape == (6, 42, 8)


def test_65pt_grid_matches_alone():
    mod = DrivenDense.make(d=8, seed=0).modulated(jnp.float64)
    save_at = np.linspace(0.0, 0.8, 65)[1:-1]
    _grid_vs_alone(vexp.MagnusModulated4(mod), _rand_state(6, 8, seed=4),
                   0.8, save_at, (2,))


def test_small_dim_ensemble_256pt_grid():
    """256 identical 2-level trajectories, 256 save times: every lane
    records its own solve's states."""
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float64)
    psi0 = np.zeros((64, 2), np.complex128)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float64)
    save_at = np.linspace(0.0, 4.0, 258)[1:-1]
    sol = _grid_vs_alone(vexp.MagnusModulated4(mod), y0, 4.0, save_at,
                         (0, 63))
    pops = np.asarray(sol.ys.re) ** 2 + np.asarray(sol.ys.im) ** 2
    np.testing.assert_allclose(pops.sum(-1), 1.0, atol=1e-9)


def test_terminal_event_freezes_lane():
    """A terminal event fires mid-grid: later save slots stay zero, the
    located time is the trajectory's own, and the saves before it match
    the solve alone."""
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float64)
    psi0 = np.zeros((16, 2), np.complex128)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float64)
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.05)
    ev = EventConfig(events=(Event(obs, direction=1, terminal=True),),
                     t_tol=1e-9)
    save_at = np.linspace(-20.0, 20.0, 80)[1:-1]
    kw = dict(adaptive=True, ctl=vo.StepControl(rtol=1e-7, max_steps=8000),
              h0=1e-2, save_at=save_at, events=ev)
    st = vexp.MagnusModulated4(mod)
    sol = ensemble_solve(None, y0, -20.0, 20.0, stepper=st, **kw)
    one = vo.solve_linear(None, -20.0, 20.0, cp.Cplx(y0.re[0], y0.im[0]),
                          stepper=st, **kw)
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    t_ev = float(one.event_t[0])
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0], t_ev,
                               atol=1e-9)
    after = np.nonzero(save_at > t_ev)[0] + 1
    before = np.nonzero(save_at < t_ev)[0] + 1
    assert after.size and before.size
    assert (np.asarray(sol.ys.re)[:, after] == 0).all()
    np.testing.assert_allclose(np.asarray(sol.ys.re)[:, before],
                               np.broadcast_to(
                                   np.asarray(one.ys.re)[before],
                                   (16, before.size, 2)), atol=1e-10)


def test_rk_stepper_large_grid_matches_generic():
    """The natively batched RK stepper records a 40-point grid exactly as
    the generic RungeKutta stepper on the same pair RHS."""
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=8, seed=0)
    y0 = _rand_state(6, 8, seed=7)
    save_at = np.linspace(0.0, 0.6, 42)[1:-1]
    kw = dict(adaptive=True, ctl=CTL, h0=1e-2, save_at=save_at,
              time_dtype=jnp.float64)
    sol_b = ensemble_solve(
        None, y0, 0.0, 0.6,
        stepper=FusedModulatedLinearRK.from_driven_dense(model,
                                                         jnp.float64), **kw)
    sol_g = ensemble_solve(
        lambda t, y: model.rhs_pair(t, y, jnp.float64), y0, 0.0, 0.6,
        stepper=vo.RungeKutta(vo.RKF45), **kw)
    np.testing.assert_array_equal(np.asarray(sol_b.n_iters),
                                  np.asarray(sol_g.n_iters))
    np.testing.assert_allclose(np.asarray(sol_b.ys.re),
                               np.asarray(sol_g.ys.re), atol=1e-12)
    np.testing.assert_allclose(np.asarray(sol_b.ys.im),
                               np.asarray(sol_g.ys.im), atol=1e-12)
