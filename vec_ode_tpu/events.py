"""Event detection: locate roots of g(t, x(t)) during integration.

The reference has no event mechanism (its only mid-run control is the save
grid / Chkpt path, ode.rs:165-176); this is a framework extension in the
scipy ``solve_ivp(events=...)`` tradition, redesigned for the branchless
masked driver:

**Events as step-size control.** Host-side root polishing (scipy) or dense-
output root finding (diffrax) need data-dependent control flow around the
step loop. Here an event crossing is handled like a *rejected step*: when
``g`` changes sign across an accepted trial step, the driver vetoes the
advance and retries from the same ``(t, x)`` with ``h = clip(theta, 0.1,
0.9) * dt``, where ``theta = g0/(g0 - g1)`` is the regula-falsi estimate of
the crossing inside the bracket. The bracket shrinks geometrically (>= 10%
per iteration, superlinearly in practice) until ``dt <= t_tol``; the step is
then accepted and the event recorded at ``t + theta*dt``. Consequences:

  * the located state is an *integrated* state, not an interpolant — the
    event time/state carry the stepper's own order of accuracy down to
    ``t_tol``, with zero extra RHS evaluations (only ``g``, evaluated once
    per driver iteration);
  * everything is masked elementwise arithmetic: it vmaps per trajectory,
    runs under ``lax.while_loop``/``scan`` and inside ``shard_map``
    unchanged;
  * after a location the pre-search step size is restored (the same
    ``prev_h`` discipline as the reference's checkpoint_update,
    ode.rs:192-195), so the controller state is undisturbed.

Semantics (per :class:`Event`): the first ``EventConfig.max_crossings``
(K, static, default 1) crossings in the requested ``direction`` are
LOCATED and their times recorded (``Solution.event_t_k``, shape
``(..., E, K)``); every further matching crossing is still COUNTED
(``Solution.event_count`` — a sign change across an accepted step is one
crossing) but not bracket-searched. ``terminal=True`` ends the trajectory
with ``status == DONE_EVENT`` at the first located crossing; ``terminal=n``
(int, scipy>=1.11 convention) ends it at the n-th (requires ``n <=
max_crossings`` so the terminating crossing is a located one). A zero of
``g`` at ``t0`` does not count as a crossing (sign must actually change).

**Differentiable event times.** Because the located time is plain masked
arithmetic in the integrated states (``t + theta*dt`` with regula-falsi
``theta``), reverse-mode differentiation through ``method="scan"`` yields
the implicit-function-theorem sensitivity of the event time to any solve
input (y0, parameters) with no custom rule — useful for time-to-event
losses in optimal control (see tests/test_events.py::
test_event_time_gradient_scan).

Caveats: the driver only *sees* sign changes across accepted trial steps —
a double root or a pair of crossings inside one step (g dips through zero
and back) is invisible, exactly as in scipy; cap ``StepControl.max_dt``
below the feature width if that matters. Event search steps may go below
``StepControl.min_dt`` (the bracket must be allowed to tighten) and do not
count toward ``n_reject``/``reject_streak``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Event:
    """One event function g(t, x) -> scalar (per trajectory).

    direction: +1 record only rising crossings (g: - -> +), -1 only falling,
    0 (default) both. terminal: end the trajectory at the event —
    ``True`` (= 1) at the first crossing, an int ``n >= 1`` at the n-th
    (scipy>=1.11's integer-``terminal`` convention; needs
    ``EventConfig.max_crossings >= n``).

    ``fn`` may be any traceable callable, e.g. one of the declared
    observables :class:`LinearObservable` / :class:`QuadraticObservable`.
    """

    fn: Callable
    direction: int = 0
    terminal: Any = False   # bool, or int n >= 1 (terminate at n-th crossing)

    def __post_init__(self):
        if self.direction not in (-1, 0, 1):
            raise ValueError(f"direction must be -1/0/+1, got {self.direction}")
        if isinstance(self.terminal, bool):
            pass
        elif isinstance(self.terminal, int):
            if self.terminal < 1:
                raise ValueError(
                    f"integer terminal must be >= 1, got {self.terminal}")
        else:
            raise TypeError(
                f"terminal must be bool or int, got "
                f"{type(self.terminal).__name__}")

    @property
    def terminal_count(self) -> int:
        """0 = non-terminal; n >= 1 = terminate at the n-th crossing."""
        if isinstance(self.terminal, bool):
            return 1 if self.terminal else 0
        return int(self.terminal)


def _as_f64_vec(w):
    import numpy as np

    a = np.asarray(w, np.float64)
    if a.ndim != 1:
        raise ValueError(f"observable coefficients must be 1-D, got "
                         f"shape {a.shape}")
    return a


@dataclasses.dataclass(frozen=True)
class LinearObservable:
    """g(t, x) = <w, x> - c over the state's REAL components.

    For a real state of dim d, ``w`` has length d. For a complex-pair
    state (ops/cplx.Cplx) ``w`` has length 2d over the widened layout
    [re | im] (a purely-real functional <w_re, Re z> + <w_im, Im z>).
    Covers impact/threshold observables (position, field quadrature,
    population difference of a real model...).
    """

    w: Any
    c: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "w", tuple(_as_f64_vec(self.w)))

    def __call__(self, t, x):
        import numpy as np

        w = np.asarray(self.w)
        if hasattr(x, "re"):   # Cplx pair: widened [re | im] layout
            d = x.re.shape[-1]
            if w.shape[0] != 2 * d:
                raise ValueError(
                    f"LinearObservable on a complex state needs w of "
                    f"length 2*{d} over [re | im], got {w.shape[0]}")
            wre = jnp.asarray(w[:d], x.re.dtype)
            wim = jnp.asarray(w[d:], x.re.dtype)
            return jnp.sum(wre * x.re, -1) + jnp.sum(wim * x.im, -1) - self.c
        x = jnp.asarray(x)
        return jnp.sum(jnp.asarray(w, x.dtype) * x, -1) - self.c

@dataclasses.dataclass(frozen=True)
class QuadraticObservable:
    """g(t, x) = sum_i q_i |x_i|^2 - c (diagonal quadratic form).

    ``q`` has length d (per complex component for Cplx states — re/im
    blocks share q, so each term is q_i*(re_i^2+im_i^2) = q_i|z_i|^2).
    Covers population/probability thresholds (q = one-hot: level
    population; q = ones: norm) — the bread-and-butter event class for
    quantum ensembles.
    """

    q: Any
    c: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(_as_f64_vec(self.q)))

    def __call__(self, t, x):
        import numpy as np

        q = np.asarray(self.q)
        if hasattr(x, "re"):
            if q.shape[0] != x.re.shape[-1]:
                raise ValueError(
                    f"QuadraticObservable q length {q.shape[0]} != state "
                    f"dim {x.re.shape[-1]}")
            qa = jnp.asarray(q, x.re.dtype)
            return jnp.sum(qa * (x.re * x.re + x.im * x.im), -1) - self.c
        x = jnp.asarray(x)
        return jnp.sum(jnp.asarray(q, x.dtype) * x * x, -1) - self.c

@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Static event setup (a jit-static argument): the tuple of Events plus
    the time tolerance of the bracket search.

    ``t_tol``: the event time is located to within this absolute tolerance
    (default ``64*eps(time dtype)*max(1, |t|)`` — near the time dtype's own
    resolution). ``record_y=False`` skips storing the event state (saves the
    (E,)+state buffer in the loop carry for large states).

    ``max_crossings`` (K, static): the first K crossings per event are
    bracket-located and recorded (``Solution.event_t_k``); all further
    matching crossings are counted only (``Solution.event_count``).
    ``record_y`` stores the state at the FIRST crossing only regardless
    of K (times are cheap scalars; a (E, K)+state buffer is not).
    """

    events: tuple
    t_tol: Optional[float] = None
    record_y: bool = True
    max_crossings: int = 1

    def __post_init__(self):
        if not self.events:
            raise ValueError("EventConfig needs at least one Event")
        for e in self.events:
            if not isinstance(e, Event):
                raise TypeError(f"expected Event, got {type(e).__name__}")
        k = self.max_crossings
        if not isinstance(k, int) or k < 1:
            raise ValueError(f"max_crossings must be an int >= 1, got {k!r}")
        if k > 64:
            raise ValueError(
                f"max_crossings={k} > 64: the located-times carry is "
                "(E, K) live registers; record that many crossings with a "
                "dense save grid instead")
        for e in self.events:
            if e.terminal_count > k:
                raise ValueError(
                    f"terminal={e.terminal_count} needs max_crossings >= "
                    f"{e.terminal_count} (got {k}): the terminating "
                    "crossing must be a located one")

    @property
    def n(self) -> int:
        return len(self.events)

    def directions(self, dtype=jnp.int32):
        return jnp.asarray([e.direction for e in self.events], dtype)

    def terminal_mask(self):
        return jnp.asarray(
            [e.terminal_count > 0 for e in self.events], bool)

    def terminal_counts(self, dtype=jnp.int32):
        """Per-event terminating crossing number (0 = non-terminal)."""
        return jnp.asarray([e.terminal_count for e in self.events], dtype)

    def time_tol(self, t):
        t = jnp.asarray(t)
        if self.t_tol is not None:
            return jnp.full(jnp.shape(t), self.t_tol, t.dtype)
        eps = jnp.finfo(t.dtype).eps
        return 64.0 * eps * jnp.maximum(1.0, jnp.abs(t))

    def evaluate(self, t, x):
        """Stacked g values, shape ``t.shape + (E,)``. ``t`` may carry a
        leading batch shape (natively-batched driver); the per-trajectory
        event fns are vmapped over it."""
        tdt = jnp.asarray(t).dtype

        def one(ti, xi):
            return jnp.stack(
                [jnp.asarray(e.fn(ti, xi), tdt) for e in self.events]
            )

        f = one
        for _ in range(jnp.ndim(t)):
            f = jax.vmap(f)
        return f(t, x)


def as_event_config(events) -> Optional[EventConfig]:
    """Normalize the user-facing ``events=`` argument: None, a single
    Event/callable, or a sequence of them (bare callables get default
    direction/terminal)."""
    if events is None:
        return None
    if isinstance(events, EventConfig):
        return events
    if isinstance(events, Event) or callable(events):
        events = [events]
    evs = tuple(
        e if isinstance(e, Event) else Event(e) for e in events
    )
    return EventConfig(events=evs)


class EventState(NamedTuple):
    """Per-trajectory event bookkeeping threaded through the loop carry."""

    g_prev: jax.Array    # (..., E) g at the CURRENT (t, x)
    t_ev: jax.Array      # (..., E, K) located crossing times (inf until
    #                      found); slot s holds the (s+1)-th crossing
    found: jax.Array     # (..., E) bool: any crossing recorded
    searching: jax.Array  # (...,) bool: inside a bracket search
    h_entry: jax.Array   # (...,) pre-search step size (restored on locate)
    count: jax.Array     # (..., E) int32: TOTAL matching crossings seen
    #                      (located for the first K, counted-only beyond)
    y_ev: Pytree = ()    # optional (..., E) + state.shape FIRST-crossing
    #                      states


def init_event_state(
    cfg: EventConfig, t0, x0, batch_shape: tuple = ()
) -> EventState:
    g0 = cfg.evaluate(t0, x0)
    tdt = jnp.asarray(t0).dtype
    shape = batch_shape + (cfg.n,)
    y_ev: Pytree = ()
    if cfg.record_y:
        nb = len(batch_shape)
        y_ev = jax.tree_util.tree_map(
            lambda a: jnp.zeros(
                batch_shape + (cfg.n,) + jnp.shape(a)[nb:],
                jnp.asarray(a).dtype,
            ),
            x0,
        )
    return EventState(
        g_prev=g0,
        t_ev=jnp.full(shape + (cfg.max_crossings,), jnp.inf, tdt),
        found=jnp.zeros(shape, bool),
        searching=jnp.zeros(batch_shape, bool),
        h_entry=jnp.zeros(batch_shape, tdt),
        count=jnp.zeros(shape, jnp.int32),
        y_ev=y_ev,
    )


class EventStepOut(NamedTuple):
    """What the driver splices into its masked update (see step_once)."""

    accept: jax.Array       # accept mask with search vetoes applied
    search: jax.Array       # (...,) lanes re-bracketing this iteration
    h_override: jax.Array   # step size for search lanes
    restore_h: jax.Array    # (...,) lanes restoring h_entry after a locate
    h_entry: jax.Array
    terminal_hit: jax.Array  # (...,) a terminal event was located
    ev_next: EventState      # fully-updated event state (pre-advance fields)


def event_step(
    cfg: EventConfig,
    ev: EventState,
    t,
    dt,
    x,
    x_next,
    stepping,
    accept,
) -> EventStepOut:
    """One driver iteration's event logic. Pure masked arithmetic; every
    input/output broadcasts over an optional leading batch shape."""
    g_next = cfg.evaluate(t + dt, x_next)
    d = cfg.directions()
    rising = (ev.g_prev < 0) & (g_next >= 0)
    falling = (ev.g_prev > 0) & (g_next <= 0)
    crossed = jnp.where(d > 0, rising, jnp.where(d < 0, falling,
                                                 rising | falling))

    live = stepping & accept
    # only the first K crossings are bracket-located; exhausted events
    # (count >= K) are counted-only — a sign change across an accepted
    # step is one crossing, no search
    k = cfg.max_crossings
    active = crossed & live[..., None] & (ev.count < k)
    any_active = jnp.any(active, axis=-1)

    # regula-falsi estimate of the crossing position inside (t, t+dt]
    denom = ev.g_prev - g_next
    theta = ev.g_prev / jnp.where(denom == 0, jnp.ones_like(denom), denom)
    theta = jnp.clip(theta, 0.0, 1.0)
    theta_a = jnp.where(active, theta, 1.0)
    theta_min = jnp.min(theta_a, axis=-1)

    tol = cfg.time_tol(t)
    tight = dt <= tol
    locate = any_active & tight
    search = any_active & ~tight

    # search: veto the advance, retry from (t, x) with a shrunk bracket.
    # clip(0.1, 0.9) guarantees >= 10% geometric shrink per iteration even
    # when regula falsi sticks to one end.
    accept = accept & ~search
    h_override = jnp.maximum(
        jnp.clip(theta_min, 0.1, 0.9) * dt, 0.25 * tol
    )
    entering = search & ~ev.searching
    h_entry = jnp.where(entering, jnp.asarray(dt, ev.h_entry.dtype),
                        ev.h_entry)
    restore_h = locate & ev.searching
    searching = (ev.searching | search) & ~locate

    # locate: the (tight) step is accepted; record each active event at its
    # own regula-falsi time and lerped state (bracket <= t_tol, so the lerp
    # error is O(t_tol^2 * |x''|) — below the integration error). The time
    # lands in slot ``count`` (the (count+1)-th crossing) via a one-hot
    # select over the K static slots (no scatter under vmap).
    rec = active & locate[..., None]
    t_loc = jnp.expand_dims(t, -1) + theta * jnp.expand_dims(dt, -1)
    slot = (
        jax.lax.broadcasted_iota(jnp.int32, ev.count.shape + (k,),
                                 ev.count.ndim)
        == ev.count[..., None]
    ) & rec[..., None]
    t_ev = jnp.where(slot, t_loc[..., None], ev.t_ev)
    found = ev.found | rec
    # terminal=n stops the trajectory at its n-th crossing (rec fires only
    # while count < K and n <= K is validated, so the n-th is located)
    terminal_hit = jnp.any(
        rec & (ev.count + 1 >= cfg.terminal_counts()) & cfg.terminal_mask(),
        axis=-1,
    )

    y_ev = ev.y_ev
    if cfg.record_y and len(jax.tree_util.tree_leaves(ev.y_ev)) > 0:
        nb = jnp.ndim(t)
        # the state buffer holds the FIRST crossing only (K slots of times
        # are cheap; K state copies are not)
        rec_y = rec & (ev.count == 0)

        def record(buf, a, b):
            # buf: (..., E) + s ; a/b: (...,) + s  -> lerp by per-event theta
            extra = buf.ndim - nb - 1
            # theta carries the time dtype (may be f64 while the state is
            # f32) — cast to the buffer dtype so the lerp doesn't promote
            # the carried event-state buffer
            th = theta.reshape(theta.shape + (1,) * extra).astype(buf.dtype)
            m = rec_y.reshape(rec_y.shape + (1,) * extra)
            ae = jnp.expand_dims(a, nb)
            be = jnp.expand_dims(b, nb)
            return jnp.where(m, ae + th * (be - ae), buf)

        y_ev = jax.tree_util.tree_map(
            lambda buf, a, b: record(buf, a, b), ev.y_ev, x, x_next
        )

    # g_prev tracks the CURRENT (t, x): update only where the step advances
    # (post-veto accept); vetoed/rejected lanes keep the old values.
    adv = stepping & accept
    g_prev = jnp.where(adv[..., None], g_next, ev.g_prev)
    # crossing counter: one count per matching sign change the state
    # actually advances across. Search iterations are vetoed (adv False),
    # so a located crossing counts exactly once — at its locate step; an
    # exhausted event counts at each accepted step that spans a crossing.
    counted = crossed & adv[..., None]
    count = ev.count + counted.astype(jnp.int32)

    ev_next = EventState(
        g_prev=g_prev, t_ev=t_ev, found=found, searching=searching,
        h_entry=h_entry, count=count, y_ev=y_ev,
    )
    return EventStepOut(
        accept=accept, search=search, h_override=h_override,
        restore_h=restore_h, h_entry=h_entry, terminal_hit=terminal_hit,
        ev_next=ev_next,
    )
