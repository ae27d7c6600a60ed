"""Multi-crossing events: per-event crossing counter and
first-K located times (``EventConfig.max_crossings``), plus scipy>=1.11's
integer-``terminal`` convention (stop at the n-th crossing).

Semantics: the first K matching crossings are bracket-LOCATED and recorded
in ``Solution.event_t_k`` (slot s = the (s+1)-th crossing); every further
matching crossing is still COUNTED in ``Solution.event_count`` (one count
per sign change across an accepted step) but not searched. ``event_t`` /
``event_found`` / ``event_y`` keep their first-crossing semantics.

The reference has no events at all (its only mid-run control is the
checkpoint grid, /root/reference/src/ode.rs:165-176); the contract here is
scipy's ``solve_ivp(events=...)`` — pinned directly against scipy below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import api
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.events import Event, EventConfig, QuadraticObservable
from vec_ode_tpu.models import LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve

CTL = vo.StepControl(rtol=1e-10, atol=1e-12)


def _osc(t, x):
    # x'' = -x from (1, 0): x = (cos t, -sin t); x[0] crosses 0 at
    # pi/2 + k*pi, alternating falling/rising
    return jnp.stack([x[1], -x[0]])


X0 = jnp.array([1.0, 0.0])


def test_first_k_times_match_scipy():
    """Sign-oscillating g: the first K located times match scipy's
    solve_ivp event list on the same problem."""
    scipy_integrate = pytest.importorskip("scipy.integrate")
    cfg = EventConfig(events=(Event(lambda t, x: x[0]),), max_crossings=4)
    sol = api.solve_ivp(_osc, 0.0, 13.0, X0, ctl=CTL, events=cfg)
    ref = scipy_integrate.solve_ivp(
        lambda t, x: np.array([x[1], -x[0]]), (0.0, 13.0),
        np.asarray(X0, np.float64), rtol=1e-10, atol=1e-12,
        events=lambda t, x: x[0], dense_output=False,
    )
    t_ref = ref.t_events[0]          # all crossings scipy found
    assert t_ref.shape[0] == 4       # pi/2 + k*pi for k=0..3 in [0, 13]
    np.testing.assert_allclose(np.asarray(sol.event_t_k[0]), t_ref,
                               atol=1e-7)
    assert int(sol.event_count[0]) == 4
    # first-crossing fields keep their semantics
    np.testing.assert_allclose(float(sol.event_t[0]), t_ref[0], atol=1e-7)
    assert bool(sol.event_found[0])


def test_count_continues_past_k():
    """Crossings beyond K are counted (one per accepted-step sign change)
    even though their times are no longer located."""
    cfg = EventConfig(events=(Event(lambda t, x: x[0]),), max_crossings=2)
    sol = api.solve_ivp(_osc, 0.0, 13.0, X0, ctl=CTL, events=cfg)
    exact = np.pi / 2 + np.arange(2) * np.pi
    np.testing.assert_allclose(np.asarray(sol.event_t_k[0]), exact,
                               atol=1e-7)
    assert int(sol.event_count[0]) == 4          # 4 crossings in [0, 13]
    # unreached slots of a SHORTER run hold +inf
    sol2 = api.solve_ivp(_osc, 0.0, 2.0, X0, ctl=CTL, events=cfg)
    tk = np.asarray(sol2.event_t_k[0])
    assert np.isfinite(tk[0]) and np.isinf(tk[1])
    assert int(sol2.event_count[0]) == 1


def test_direction_filter_applies_to_count():
    """direction=+1 counts only rising crossings: x[0] rises through zero
    at 3pi/2 + 2k*pi."""
    cfg = EventConfig(events=(Event(lambda t, x: x[0], direction=1),),
                      max_crossings=2)
    sol = api.solve_ivp(_osc, 0.0, 13.0, X0, ctl=CTL, events=cfg)
    exact = 3 * np.pi / 2 + np.arange(2) * 2 * np.pi
    np.testing.assert_allclose(np.asarray(sol.event_t_k[0]), exact,
                               atol=1e-7)
    assert int(sol.event_count[0]) == 2


def test_integer_terminal_stops_at_nth():
    """terminal=n (scipy>=1.11): DONE_EVENT at the n-th crossing; the
    count stops there too."""
    cfg = EventConfig(events=(Event(lambda t, x: x[0], terminal=3),),
                      max_crossings=3)
    sol = api.solve_ivp(_osc, 0.0, 50.0, X0, ctl=CTL, events=cfg)
    assert int(sol.status) == vo.DONE_EVENT
    exact3 = np.pi / 2 + 2 * np.pi
    np.testing.assert_allclose(float(sol.t_final), exact3, atol=1e-7)
    assert int(sol.event_count[0]) == 3
    # terminal=True === terminal=1 (unchanged semantics)
    cfg1 = EventConfig(events=(Event(lambda t, x: x[0], terminal=True),))
    sol1 = api.solve_ivp(_osc, 0.0, 50.0, X0, ctl=CTL, events=cfg1)
    np.testing.assert_allclose(float(sol1.t_final), np.pi / 2, atol=1e-7)


def test_validation():
    with pytest.raises(ValueError, match="max_crossings"):
        EventConfig(events=(Event(lambda t, x: x[0]),), max_crossings=0)
    with pytest.raises(ValueError, match="terminal"):
        EventConfig(events=(Event(lambda t, x: x[0], terminal=3),),
                    max_crossings=2)
    with pytest.raises(ValueError, match="terminal"):
        Event(lambda t, x: x[0], terminal=0)
    with pytest.raises(TypeError, match="terminal"):
        Event(lambda t, x: x[0], terminal=1.5)


def test_event_y_records_first_crossing_only():
    """record_y stores the FIRST crossing state regardless of K."""
    cfg = EventConfig(events=(Event(lambda t, x: x[0]),), max_crossings=3)
    sol = api.solve_ivp(_osc, 0.0, 13.0, X0, ctl=CTL, events=cfg)
    # at t = pi/2 the state is (0, -1)
    np.testing.assert_allclose(np.asarray(sol.event_y[0]),
                               [0.0, -1.0], atol=1e-6)


def test_backward_integration_remaps_slots():
    """Backward solve: slot s stays the (s+1)-th crossing along the
    integration direction; unreached slots map to -inf in user time."""
    cfg = EventConfig(events=(Event(lambda t, x: x[0]),), max_crossings=3)
    # integrate BACKWARD from 13 to 6 starting at x(13): crossings met
    # going down are 10.9955 then 7.8539
    x13 = jnp.array([np.cos(13.0), -np.sin(13.0)])
    sol = api.solve_ivp(_osc, 13.0, 6.0, x13, ctl=CTL, events=cfg)
    tk = np.asarray(sol.event_t_k[0])
    np.testing.assert_allclose(tk[0], np.pi / 2 + 3 * np.pi, atol=1e-6)
    np.testing.assert_allclose(tk[1], np.pi / 2 + 2 * np.pi, atol=1e-6)
    assert tk[2] == -np.inf
    assert int(sol.event_count[0]) == 2


def test_scan_method_multicrossing():
    """method='scan' (reverse-differentiable driver) carries the same
    multi-crossing state."""
    cfg = EventConfig(events=(Event(lambda t, x: x[0]),), max_crossings=3)
    ctl = vo.StepControl(rtol=1e-8, atol=1e-10, max_steps=600)
    sol = api.solve_ivp(_osc, 0.0, 10.0, X0, ctl=ctl, events=cfg,
                        method="scan")
    exact = np.pi / 2 + np.arange(3) * np.pi
    np.testing.assert_allclose(np.asarray(sol.event_t_k[0]), exact,
                               atol=1e-6)
    assert int(sol.event_count[0]) == 3


# ---------------------------------------------------------------------------
# batched ensembles against the closed form
# ---------------------------------------------------------------------------

def _lz_setup(B=256, v=2.0):
    lz = LandauZener(v=v, delta=0.4)
    mod = lz.modulated(jnp.float32)
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    return mod, cp.from_complex(psi0, jnp.float32)


KCTL = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4, max_dt=1.0)
# With v=0 the Hamiltonian is a pure Rabi drive (delta/2) sigma_x from
# |0> at t=-20: |c1|^2 = sin^2(delta (t+20) / 2) crosses 1/2 at
# t_k = -20 + (pi/2 + k pi) / delta — five times in [-20, 20] (spacing
# ~7.9 s >> max_dt). The f32 state error (~rtol) over the slope 0.2 of
# |c1|^2 at a crossing, plus t_tol, bounds the located-time error by 5e-4.
T_RABI = -20.0 + (np.pi / 2 + np.pi * np.arange(5)) / 0.4


def _solve_lz(mod, y0, ev):
    return ensemble_solve(
        mod, y0, -20.0, 20.0, stepper=vexp.MagnusModulated4(mod),
        adaptive=True, h0=1e-2, ctl=KCTL, time_dtype=jnp.float32,
        events=ev,
    )


def test_batched_multicrossing_matches_closed_form():
    """A 256-trajectory f32 ensemble with K=3: 3 crossings located at the
    closed-form Rabi times, all 5 counted."""
    mod, y0 = _lz_setup(v=0.0)
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.5)
    ev = EventConfig(events=(Event(obs),), max_crossings=3, t_tol=1e-4)
    sol = _solve_lz(mod, y0, ev)
    np.testing.assert_array_equal(np.asarray(sol.event_count), 5)
    assert np.asarray(sol.event_found).all()
    tk = np.asarray(sol.event_t_k)[:, 0, :]
    np.testing.assert_allclose(tk, np.broadcast_to(T_RABI[:3], tk.shape),
                               atol=5e-4)


def test_batched_integer_terminal():
    """terminal=2: DONE_EVENT at each trajectory's 2nd crossing, at the
    closed-form time."""
    mod, y0 = _lz_setup(B=256, v=0.0)
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.5)
    ev = EventConfig(events=(Event(obs, terminal=2),), max_crossings=2,
                     t_tol=1e-4)
    sol = _solve_lz(mod, y0, ev)
    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    np.testing.assert_allclose(np.asarray(sol.t_final), T_RABI[1],
                               atol=5e-4)


def test_batched_many_crossing_slots():
    """The batched driver has no slot budget: with K=33 > the crossings
    present, the 5 real crossings fill the first slots and the rest stay
    at +inf."""
    mod, y0 = _lz_setup(B=64, v=0.0)
    obs = QuadraticObservable(q=[0.0, 1.0], c=0.5)
    ev = EventConfig(events=(Event(obs),), max_crossings=33, t_tol=1e-4)
    sol = _solve_lz(mod, y0, ev)
    tk = np.asarray(sol.event_t_k)[:, 0, :]
    assert tk.shape == (64, 33)
    np.testing.assert_allclose(tk[:, :5], np.broadcast_to(T_RABI, (64, 5)),
                               atol=5e-4)
    assert np.isinf(tk[:, 5:]).all()
    np.testing.assert_array_equal(np.asarray(sol.event_count), 5)
