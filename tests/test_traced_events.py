"""Traced (plain-jnp) event callables on the batched drivers.

A declared observable (LinearObservable/QuadraticObservable) and a
hand-written jnp callable g(t, x) are both evaluated per trajectory by
``EventConfig.evaluate`` (vmapped over the batch) inside the batched XLA
driver. Untraceable callables (ones that concretize a tracer) cannot run
under jit and raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.events import (Event, EventConfig, LinearObservable,
                                QuadraticObservable)
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _driven(B=6, seed=21, d=8):
    model = DrivenDense.make(d=d, seed=0)
    mod = model.modulated(jnp.float64)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return model, mod, cp.from_complex(z, jnp.float64)


CTL = vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2, max_steps=2000)


def _per_trajectory(mod, y0, tf, ev, b):
    return vo.solve_linear(
        None, 0.0, tf, cp.Cplx(y0.re[b], y0.im[b]),
        stepper=vexp.MagnusModulated4(mod), adaptive=True, h0=1e-2,
        ctl=CTL, events=ev)


# ------------------------------------------------------------ evaluate --


def test_evaluate_batched_matches_per_trajectory_calls():
    fn = lambda t, x: x.re[3] - 0.1 * t
    cfg = EventConfig(events=(Event(fn),))
    _, _, y = _driven()
    t = jnp.asarray(np.linspace(0.0, 1.0, 6))
    got = np.asarray(cfg.evaluate(t, y))
    assert got.shape == (6, 1)
    want = np.asarray(y.re)[:, 3] - 0.1 * np.asarray(t)
    np.testing.assert_allclose(got[:, 0], want, rtol=1e-14)


def test_untraceable_event_raises():
    fn = lambda t, x: float(np.asarray(x.re).max())  # concretizes
    _, mod, y0 = _driven()
    with pytest.raises(Exception):
        ensemble_solve(mod, y0, 0.0, 0.5, stepper=vexp.MagnusModulated4(mod),
                       adaptive=True, h0=1e-2, ctl=CTL,
                       events=EventConfig(events=(Event(fn),)))


def test_evaluate_mixes_declared_and_traced():
    w = np.zeros(16)
    w[3] = 1.0
    fn = lambda t, x: jnp.sum(x.re ** 2 + x.im ** 2) - 0.5
    cfg = EventConfig(events=(Event(LinearObservable(w=w)), Event(fn)))
    _, _, y = _driven()
    got = np.asarray(cfg.evaluate(jnp.zeros(6), y))
    np.testing.assert_allclose(got[:, 0], np.asarray(y.re)[:, 3],
                               rtol=1e-14)
    np.testing.assert_allclose(got[:, 1], 0.5, atol=1e-14)


# ------------------------------------------------- batched vs alone --


def test_traced_event_matches_per_trajectory():
    """A hand-written jnp event fn on the batched driver locates the same
    crossings (found mask, times, states) as each trajectory solved
    alone with the same callable (f64)."""
    _, mod, y0 = _driven()
    fn = lambda t, x: x.re[3]          # Re z_3 crossing zero
    ev = EventConfig(events=(Event(fn),), t_tol=1e-10)
    sol = ensemble_solve(mod, y0, 0.0, 4.0,
                         stepper=vexp.MagnusModulated4(mod), adaptive=True,
                         h0=1e-2, ctl=CTL, events=ev)
    found = np.asarray(sol.event_found)[:, 0]
    assert found.any()
    for b in range(y0.re.shape[0]):
        one = _per_trajectory(mod, y0, 4.0, ev, b)
        assert bool(one.event_found[0]) == bool(found[b])
        assert int(one.n_accept) == int(sol.n_accept[b])
        if found[b]:
            np.testing.assert_allclose(float(sol.event_t[b, 0]),
                                       float(one.event_t[0]), atol=1e-9)
            np.testing.assert_allclose(np.asarray(sol.event_y.re[b, 0]),
                                       np.asarray(one.event_y.re[0]),
                                       atol=1e-9)


def test_traced_event_matches_declared_equivalent():
    """A traced |z_1|^2 - c IS QuadraticObservable written by hand: both
    runs must locate identical event times."""
    _, mod, y0 = _driven(seed=33)
    c = 0.04
    fn = lambda t, x: x.re[1] ** 2 + x.im[1] ** 2 - c
    obs = QuadraticObservable(q=np.eye(8)[1], c=c)
    kw = dict(stepper=vexp.MagnusModulated4(mod), adaptive=True, h0=1e-2,
              ctl=CTL)
    sol_t = ensemble_solve(mod, y0, 0.0, 1.0, events=EventConfig(
        events=(Event(fn, direction=1),), t_tol=1e-10), **kw)
    sol_d = ensemble_solve(mod, y0, 0.0, 1.0, events=EventConfig(
        events=(Event(obs, direction=1),), t_tol=1e-10), **kw)
    np.testing.assert_array_equal(np.asarray(sol_t.event_found),
                                  np.asarray(sol_d.event_found))
    m = np.asarray(sol_t.event_found)[:, 0]
    np.testing.assert_allclose(np.asarray(sol_t.event_t)[m],
                               np.asarray(sol_d.event_t)[m], atol=1e-12)


def test_traced_terminal_event_time_dependent():
    """g depends on t too (the full g(t, x) contract): a time-shifted
    threshold terminates each trajectory; unitary evolution keeps
    sum|z|^2 == 1, so g = 0.2 t - 0.1 crosses zero (rising) at t = 0.5,
    reached only through the state-dependent term."""
    _, mod, y0 = _driven(seed=5)
    fn = lambda t, x: jnp.sum(x.re ** 2 + x.im ** 2) * 0.2 * t - 0.1
    ev = EventConfig(events=(Event(fn, direction=1, terminal=True),),
                     t_tol=1e-10)
    sol = ensemble_solve(mod, y0, 0.0, 1.0,
                         stepper=vexp.MagnusModulated4(mod), adaptive=True,
                         h0=1e-2, ctl=CTL, events=ev)
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0], 0.5,
                               atol=1e-8)


def test_rk_stepper_traced_event():
    """The natively batched RK stepper runs traced events too: it locates
    the same crossings as the generic RungeKutta stepper per trajectory
    on the same pair RHS (f64)."""
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model, _, y0 = _driven(seed=41)
    fn = lambda t, x: x.re[3]
    ev = EventConfig(events=(Event(fn),), t_tol=1e-10)
    kw = dict(adaptive=True, h0=1e-2, ctl=CTL, time_dtype=jnp.float64,
              events=ev)
    sol_b = ensemble_solve(
        None, y0, 0.0, 4.0,
        stepper=FusedModulatedLinearRK.from_driven_dense(model,
                                                         jnp.float64),
        **kw)
    sol_g = ensemble_solve(
        lambda t, y: model.rhs_pair(t, y, jnp.float64), y0, 0.0, 4.0,
        stepper=vo.RungeKutta(vo.RKF45), **kw)
    f_b = np.asarray(sol_b.event_found)
    np.testing.assert_array_equal(f_b, np.asarray(sol_g.event_found))
    m = f_b[:, 0]
    assert m.any()
    np.testing.assert_allclose(np.asarray(sol_b.event_t)[m],
                               np.asarray(sol_g.event_t)[m], atol=1e-9)


def test_traced_terminal_event_small_dim_ensemble():
    """2-level f32 ensemble, terminal traced event: every trajectory ends
    DONE_EVENT at the time a single f64 solve of the same trajectory
    locates (the population crosses 0.05 with a clear slope)."""
    lz = LandauZener(v=2.0, delta=0.4)
    psi0 = np.zeros((64, 2), np.complex64)
    psi0[:, 0] = 1.0
    fn = lambda t, x: x.re[1] ** 2 + x.im[1] ** 2 - 0.05
    ev = EventConfig(events=(Event(fn, direction=1, terminal=True),),
                     t_tol=1e-4)
    ctl = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4, max_dt=1.0)
    mod32 = lz.modulated(jnp.float32)
    sol = ensemble_solve(
        mod32, cp.from_complex(psi0, jnp.float32), -20.0, 20.0,
        stepper=vexp.MagnusModulated4(mod32), adaptive=True, h0=1e-2,
        ctl=ctl, time_dtype=jnp.float32, events=ev,
    )
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    mod64 = lz.modulated(jnp.float64)
    one = vo.solve_linear(
        None, -20.0, 20.0, cp.from_complex(psi0[0], jnp.float64),
        stepper=vexp.MagnusModulated4(mod64), adaptive=True, h0=1e-2,
        ctl=vo.StepControl(rtol=1e-10, max_steps=40000, min_dt=1e-6,
                           max_dt=0.2),
        events=EventConfig(events=(Event(fn, direction=1, terminal=True),),
                           t_tol=1e-9))
    assert int(one.status) == vo.DONE_EVENT
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(one.event_t[0]), atol=2e-3)


def test_traced_event_direction_filter():
    """direction=0 locates the earlier of the first rising and the first
    falling crossing of the same traced g."""
    _, mod, y0 = _driven(seed=17)
    fn = lambda t, x: x.re[2]
    kw = dict(stepper=vexp.MagnusModulated4(mod), adaptive=True, h0=1e-2,
              ctl=CTL)

    def first(direction):
        sol = ensemble_solve(mod, y0, 0.0, 4.0, events=EventConfig(
            events=(Event(fn, direction=direction),), t_tol=1e-10), **kw)
        return np.asarray(sol.event_t)[:, 0]

    t_any, t_up, t_down = first(0), first(1), first(-1)
    assert np.isfinite(t_any).any()
    np.testing.assert_allclose(t_any, np.minimum(t_up, t_down), atol=1e-9)
