"""Event detection on batched ensembles.

Declared observables (events.LinearObservable / QuadraticObservable) and
plain callables run on the batched XLA driver with the
regula-falsi-as-step-control semantics of events.event_step. The tests pin
a 256-trajectory f32 Landau-Zener ensemble against a tight f64 solve of
the same trajectory (the ensemble's trajectories are identical), and small
f64 ensembles against per-trajectory solves.

Reference contract: this generalizes the reference's only mid-run control,
the checkpoint grid (ode.rs:165-176), to state-dependent stopping times.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc
from vec_ode_tpu.events import (Event, EventConfig, LinearObservable,
                                QuadraticObservable)
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _lz_setup(B=256):
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float32)
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    return mod, cp.from_complex(psi0, jnp.float32)


CTL = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4, max_dt=1.0)
LZ = LandauZener(v=2.0, delta=0.4)
# f32 ensemble at rtol 1e-5 and t_tol 1e-4 against the f64 reference: the
# population error (~rtol summed over the sweep) over the population's
# slope at the threshold bounds the event-time error by 2e-3
TOL_T = 2e-3


def _solve(y0, ev, stepper=None, adaptive=True, h0=1e-2, **kw):
    mod = LZ.modulated(jnp.float32)
    return ensemble_solve(
        mod, y0, -20.0, 20.0,
        stepper=stepper or vexp.MagnusModulated4(mod),
        adaptive=adaptive, h0=h0, ctl=kw.pop("ctl", CTL),
        time_dtype=jnp.float32, events=ev, **kw,
    )


def _reference(ev, save_at=None):
    """Tight f64 solve of the ensemble's (common) trajectory, generic
    dense-split Magnus-4 on the same operator, events located to 1e-9."""
    import dataclasses

    psi0 = cp.Cplx(jnp.asarray([1.0, 0.0]), jnp.zeros(2))
    ref = vo.solve_linear(
        lambda t: LZ.op_pair(t, jnp.float64), -20.0, 20.0, psi0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()), adaptive=True,
        h0=1e-2, save_at=save_at,
        ctl=vo.StepControl(rtol=1e-9, max_steps=40000, min_dt=1e-7,
                           max_dt=0.2),
        events=dataclasses.replace(ev, t_tol=1e-9))
    assert int(ref.status) in (vo.DONE, vo.DONE_EVENT)
    return ref


def test_observables_are_callables():
    """The declared forms ARE the XLA-tier event functions: values match a
    hand computation on both real and complex-pair states."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    x = cp.from_complex(z, jnp.float64)
    q = np.asarray([0.5, 1.0, 0.0, 2.0])
    g = float(QuadraticObservable(q=q, c=0.3)(0.0, x))
    np.testing.assert_allclose(g, (q * np.abs(z) ** 2).sum() - 0.3,
                               rtol=1e-12)
    w = rng.standard_normal(8)
    gl = float(LinearObservable(w=w, c=-1.0)(0.0, x))
    np.testing.assert_allclose(
        gl, (w[:4] * z.real).sum() + (w[4:] * z.imag).sum() + 1.0,
        rtol=1e-12)
    xr = jnp.asarray(rng.standard_normal(5))
    w5 = rng.standard_normal(5)
    np.testing.assert_allclose(
        float(LinearObservable(w=w5)(0.0, xr)), (w5 * np.asarray(xr)).sum(),
        rtol=1e-12)


def _terminal_pop1(c=0.05, **kw):
    obs = QuadraticObservable(q=[0.0, 1.0], c=c)
    return EventConfig(events=(Event(obs, direction=1, terminal=True),),
                       t_tol=1e-4, **kw)


def test_terminal_event_matches_reference():
    """Each trajectory terminates at its population threshold: status
    DONE_EVENT, located time and state at the reference's."""
    _, y0 = _lz_setup()
    ev = _terminal_pop1()
    sol = _solve(y0, ev)
    ref = _reference(ev)
    assert int(ref.status) == vo.DONE_EVENT
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    assert np.asarray(sol.event_found).all()
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(ref.event_t[0]), atol=TOL_T)
    np.testing.assert_allclose(np.asarray(sol.event_y.re)[:, 0],
                               np.broadcast_to(np.asarray(ref.event_y.re[0]),
                                               (256, 2)), atol=TOL_T)


def test_nonterminal_event_records_and_continues():
    """Non-terminal: the first crossing is recorded and the solve runs to
    tf (status DONE) with the final state of the reference."""
    _, y0 = _lz_setup()
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.05)
    ev = EventConfig(events=(Event(obs, direction=1),), t_tol=1e-4)
    sol = _solve(y0, ev)
    ref = _reference(ev)
    assert (np.asarray(sol.status) == vo.DONE).all()
    assert np.asarray(sol.event_found).all()
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(ref.event_t[0]), atol=TOL_T)
    np.testing.assert_allclose(
        np.asarray(sol.y_final.re),
        np.broadcast_to(np.asarray(ref.y_final.re), (256, 2)), atol=TOL_T)


def test_two_events_directions():
    """Two observables with opposite directions locate independently; the
    falling-crossing event on pop0 and the rising on pop1 are the same
    physical time here (pop0 + pop1 = 1), cross-checking the bracket."""
    _, y0 = _lz_setup()
    up = QuadraticObservable(q=[0.0, 1.0], c=0.05)     # pop1 rising
    down = QuadraticObservable(q=[1.0, 0.0], c=0.95)   # pop0 falling
    ev = EventConfig(
        events=(Event(up, direction=1), Event(down, direction=-1)),
        t_tol=1e-4,
    )
    sol = _solve(y0, ev)
    tf = np.asarray(sol.event_t)
    assert np.asarray(sol.event_found).all()
    np.testing.assert_allclose(tf[:, 0], tf[:, 1], atol=2e-4)
    ref = _reference(ev)
    np.testing.assert_allclose(tf, np.broadcast_to(np.asarray(ref.event_t),
                                                   tf.shape), atol=TOL_T)


def _driven_f64(B=6, seed=21, d=8):
    model = DrivenDense.make(d=d, seed=0)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return model, cp.from_complex(z, jnp.float64)


def test_linear_event_matches_per_trajectory():
    """d=8 complex: a LinearObservable over the widened [re | im] layout
    on the batched driver locates what each trajectory solved alone
    locates (f64)."""
    model, y0 = _driven_f64()
    mod = model.modulated(jnp.float64)
    w = np.zeros(16)
    w[3] = 1.0   # Re z_3 crossing zero
    ev = EventConfig(events=(Event(LinearObservable(w=w)),), t_tol=1e-10)
    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2, max_steps=2000)
    st = vexp.MagnusModulated4(mod)
    sol = ensemble_solve(mod, y0, 0.0, 4.0, stepper=st, adaptive=True,
                         h0=1e-2, ctl=ctl, events=ev)
    found = np.asarray(sol.event_found)[:, 0]
    assert found.any()
    for b in range(6):
        one = vo.solve_linear(None, 0.0, 4.0, cp.Cplx(y0.re[b], y0.im[b]),
                              stepper=st, adaptive=True, h0=1e-2, ctl=ctl,
                              events=ev)
        assert bool(one.event_found[0]) == bool(found[b])
        if found[b]:
            np.testing.assert_allclose(float(sol.event_t[b, 0]),
                                       float(one.event_t[0]), atol=1e-9)


def test_event_state_same_on_scan_driver():
    """The bounded-scan driver carries the event state (found/searching
    bits, g_prev, located times) exactly like the while driver."""
    _, y0 = _lz_setup(B=64)
    ev = _terminal_pop1()
    sol_w = _solve(y0, ev)
    sol_s = _solve(y0, ev, method="scan")
    for name in ("status", "n_accept", "n_reject", "event_t",
                 "event_found"):
        np.testing.assert_array_equal(np.asarray(getattr(sol_w, name)),
                                      np.asarray(getattr(sol_s, name)),
                                      err_msg=name)


def test_record_y_false_skips_state_buffers():
    _, y0 = _lz_setup(B=256)
    sol = _solve(y0, _terminal_pop1(record_y=False))
    assert sol.event_y is None
    assert np.asarray(sol.event_found).all()


def test_opaque_callable_matches_declared_observable():
    """A plain-python (traceable) event fn equal to the declared
    observable gives the identical solve."""
    _, y0 = _lz_setup(B=256)
    fn = lambda t, x: x.re[1] ** 2 + x.im[1] ** 2 - 0.05
    ev_fn = EventConfig(events=(Event(fn, direction=1, terminal=True),),
                        t_tol=1e-4)
    sol_f = _solve(y0, ev_fn)
    sol_d = _solve(y0, _terminal_pop1())
    assert (np.asarray(sol_f.status) == vo.DONE_EVENT).all()
    np.testing.assert_array_equal(np.asarray(sol_f.n_accept),
                                  np.asarray(sol_d.n_accept))
    np.testing.assert_allclose(np.asarray(sol_f.event_t),
                               np.asarray(sol_d.event_t), atol=1e-6)


def test_ensemble_events_path_tag():
    """ensemble_solve(events=declared observables) runs the batched XLA
    driver and terminates every trajectory."""
    _, y0 = _lz_setup()
    sol = _solve(y0, _terminal_pop1())
    assert sol.path == "xla-driver"
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()


def test_search_iterations_do_not_pollute_reject_stats():
    """Bracket-search iterations are not numerical rejections: with a
    permissive tolerance the event search must not increment n_reject
    (events.py's true_reject discipline)."""
    _, y0 = _lz_setup(B=256)
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.05)
    ev = EventConfig(events=(Event(obs, direction=1, terminal=True),),
                     t_tol=1e-6)
    sol = _solve(y0, ev)
    assert (np.asarray(sol.n_reject) == 0).all()
    # and the search DID happen: locating to 1e-6 from h~0.1 needs > 10
    # extra iterations beyond the accepted steps
    assert (np.asarray(sol.n_iters)
            > np.asarray(sol.n_accept) + 5).all()


def test_rk_stepper_linear_event_matches_generic():
    """The headline RK stepper (ops/modulated_rk.FusedModulatedLinearRK)
    locates the same crossings as the generic RungeKutta stepper per
    trajectory on the same pair RHS (f64)."""
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model, y0 = _driven_f64(seed=41)
    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25,
                         max_steps=2000)
    w = np.zeros(16)
    w[3] = 1.0   # Re z_3 crossing zero (widened [re | im] layout)
    ev = EventConfig(events=(Event(LinearObservable(w=w)),), t_tol=1e-10)
    kw = dict(adaptive=True, h0=1e-2, ctl=ctl, time_dtype=jnp.float64,
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
    np.testing.assert_allclose(np.asarray(sol_b.event_y.re)[m],
                               np.asarray(sol_g.event_y.re)[m], atol=1e-9)


def test_blackbox_auto_modulated_events():
    """The reference's OPAQUE operator contract (magnus.rs:32) routed
    through exp.auto_modulated keeps events: the event time matches the
    hand-declared modulated operator's run."""
    mod = vexp.auto_modulated(
        lambda t: LZ.op_pair(t, jnp.float32), -20.0, 20.0,
        dtype=jnp.float32)
    assert mod is not None
    _, y0 = _lz_setup()
    ev = _terminal_pop1()
    sol = _solve(y0, ev, stepper=vexp.MagnusModulated4(mod))
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    sol_h = _solve(y0, ev)
    np.testing.assert_allclose(np.asarray(sol.event_t),
                               np.asarray(sol_h.event_t), atol=2e-4)


def test_fixed_step_events():
    """adaptive=False: the event veto/search discipline rides the fixed
    stepper too (accept is unconditionally true outside searches)."""
    mod, y0 = _lz_setup(B=256)
    ev = _terminal_pop1()
    ctl = vo.StepControl(rtol=1e-6, max_steps=4000)
    sol = _solve(y0, ev, stepper=vexp.MagnusModulated4(mod, adaptive=False),
                 adaptive=False, h0=40.0 / 800, ctl=ctl)
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(_reference(ev).event_t[0]),
                               atol=TOL_T)
    # fixed steps: the accepted-step count is the same for every lane
    assert np.ptp(np.asarray(sol.n_accept)) == 0


def test_events_with_interior_saves():
    """Non-terminal event + interior save grid: located times AND the
    recorded save states both match the reference."""
    _, y0 = _lz_setup(B=256)
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.05)
    ev = EventConfig(events=(Event(obs, direction=1),), t_tol=1e-4)
    sol = _solve(y0, ev, save_at=[0.0, 10.0])
    assert (np.asarray(sol.status) == vo.DONE).all()
    ref = _reference(ev, save_at=[0.0, 10.0])
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(ref.event_t[0]), atol=TOL_T)
    np.testing.assert_allclose(
        np.asarray(sol.ys.re)[:, 1:3],
        np.broadcast_to(np.asarray(ref.ys.re)[1:3], (256, 2, 2)),
        atol=TOL_T)


def test_terminal_event_before_interior_save():
    """A terminal event located BEFORE an interior save time leaves that
    save slot at its zero initialization."""
    _, y0 = _lz_setup(B=256)
    ev = _terminal_pop1()
    sol = _solve(y0, ev, save_at=[10.0])          # event ~ t=0.33
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    assert (np.asarray(sol.ys.re)[:, 1] == 0).all()
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(_reference(ev).event_t[0]),
                               atol=TOL_T)


@pytest.mark.parametrize("make", [
    lambda mod: vexp.MagnusModulated4(
        mod, norm=lc.WeightedNorm("l2", weights=np.asarray([2.0, 0.5],
                                                            np.float32))),
    lambda mod: vexp.CFM4Modulated(mod),
    lambda mod: vexp.MagnusModulated4(mod, fast_error=True),
], ids=["weighted-norm", "cfm4", "fast-error"])
def test_terminal_event_other_steppers(make):
    """Terminal events compose with a declared WeightedNorm, with the CFM-4
    chain stepper and with the fast_error estimate: every lane stops at
    the reference's event time."""
    mod, y0 = _lz_setup(B=256)
    ev = _terminal_pop1()
    sol = _solve(y0, ev, stepper=make(mod))
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    np.testing.assert_allclose(np.asarray(sol.event_t)[:, 0],
                               float(_reference(ev).event_t[0]),
                               atol=TOL_T)
