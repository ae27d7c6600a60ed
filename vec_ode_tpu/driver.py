"""Core integration driver: the reference's step-control state machine
(``/root/reference/src/base/ode.rs``) as a branchless ``lax.while_loop``.

Mapping from the reference (SURVEY.md §7):
  * ``ODEData``/``ODEAdaptiveData`` (ode.rs:79-137)  ->  ``IntState`` pytree
    carried through the loop (t, x, h, prev_h, save-grid cursor, counters).
  * ``ODEStep`` enum {Step, Chkpt, Reject, End} (ode.rs:42-48)  ->  masked
    arithmetic: each loop iteration computes boolean masks (stepping /
    at-checkpoint / at-end / accept) and applies ``where``-selected updates.
    ``last_event`` records the taken branch for parity tests.
  * ``step_size_of`` + ``check_step`` truncation (ode.rs:165-176, 389-399)  ->
    ``dt = min(h, t_grid[tgt] - t)``; "remaining ~ 0" via an absolute-eps test.
  * ``advance`` (swap x/next_x, ode.rs:184-188)  ->  functional ``where``
    select; XLA reuses buffers (donation) so no copies materialize.
  * ``checkpoint_update`` (tgt+=1, h=prev_h, ode.rs:192-195)  ->  masked update
    on the checkpoint iteration; the save grid is hit exactly and the
    pre-truncation step size is restored.
  * rejected steps (ode.rs:412-419)  ->  mask out the state advance, keep the
    shrunk h; the loop retries.

Every trajectory's loop state is a flat pytree of scalars+arrays, so the whole
driver vmaps: ``jax.vmap(integrate)`` yields a batched while_loop in which each
trajectory carries its own (t, h, cursor, status) and the loop runs until all
are done. That is the ensemble execution model (see vec_ode_tpu/parallel/).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import lc
from .controller import StepControl, controller_update, end_tolerance, error_measure

Pytree = Any

# Status codes (terminal loop states).
RUNNING = 0
DONE = 1
ERR_MAX_STEPS = 2
ERR_STALLED = 3   # reject streak at/below min_dt (the reference livelocks
                  # silently here, SURVEY §5 'failure detection'; we surface
                  # it when StepControl.max_reject_streak > 0)
ERR_BAD_GRID = 4  # negative remaining time: backward integration with traced
                  # endpoints or a misordered grid (would otherwise livelock)
DONE_EVENT = 5    # a terminal Event was located (events.py); t_final is the
                  # event time (within EventConfig.t_tol)


def comp_time_advance(t, t_lo, dt):
    """Compensated (double-word) time accumulation: TwoSum of (t, dt) folded
    into the residual word ``t_lo``, renormalized (Fast2Sum) so the hi word
    stays the correctly-rounded running sum. Closes the ~n*eps drift of
    plain ``t += dt`` accumulation (the reference accumulates plainly in
    f64, ode.rs:184-188; ``StepControl.time_compensated=False`` keeps that
    behavior). Shared verbatim by driver.step_once and dense._dense_step."""
    s = t + dt
    bp = s - t
    e_lo = (t - (s - bp)) + (dt - bp)
    lo = t_lo + e_lo
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo

# Event codes: which ODEStep branch the last iteration took (ode.rs:42-48).
EVT_NONE = 0
EVT_STEP = 1     # ODEStep::Step — accepted
EVT_CHKPT = 2    # ODEStep::Chkpt
EVT_REJECT = 3   # ODEStep::Reject
EVT_END = 4      # ODEStep::End


class IntState(NamedTuple):
    """Loop carry. The functional counterpart of ODEData + ODEAdaptiveData."""

    t: jax.Array
    t_lo: jax.Array       # residual word of the compensated (hi, lo) time
                          # pair (zeros when ctl.time_compensated=False);
                          # t remains the correctly-rounded value
    x: Pytree
    h: jax.Array          # current trial step size (ODEData.h)
    prev_h: jax.Array     # last step size before update (ODEData.prev_h)
    tgt_idx: jax.Array    # cursor into the save grid (ODEData.tgt_t)
    status: jax.Array     # RUNNING / DONE / ERR_MAX_STEPS
    last_event: jax.Array
    err_norm: jax.Array   # most recent error measure (ODEAdaptiveData.dx_norm)
    n_accept: jax.Array
    n_reject: jax.Array
    n_iters: jax.Array
    reject_streak: jax.Array  # consecutive rejects (livelock detector)
    ys: Pytree            # (n_grid, ...) recorded states at the save grid
    ts_grid: jax.Array    # (n_grid,) save grid, ts_grid[0]=t0, [-1]=tf
    carry: Pytree = ()    # optional stepper carry (e.g. the FSAL last-stage
                          # slope); () for carry-free steppers
    ev: Pytree = ()       # optional events.EventState; () when no events


def make_grid(t0, tf, save_at=None, dtype=None):
    """Build the save grid (the reference's t_list, default [t0, tf],
    ode.rs:144). ``save_at`` holds interior times (strictly inside (t0,tf));
    values outside the interval or out of order are rejected when concrete
    (a misordered grid would silently never be crossed/hit)."""
    if dtype is None:
        dtype = jnp.result_type(float)
    t0 = jnp.asarray(t0, dtype)
    tf = jnp.asarray(tf, dtype)
    if save_at is None:
        return jnp.stack([t0, tf])
    save_at = jnp.asarray(save_at, dtype)
    try:  # concrete values only; traced grids are the caller's contract
        import numpy as np

        arr = np.asarray(save_at)
        lo, hi = float(np.asarray(t0)), float(np.asarray(tf))
        if arr.size and (
            (arr <= lo).any() or (arr >= hi).any()
            or (np.diff(arr) <= 0).any()
        ):
            raise ValueError(
                f"save_at must be strictly increasing and strictly inside "
                f"({lo}, {hi}); got {arr}"
            )
    except jax.errors.TracerArrayConversionError:
        pass
    return jnp.concatenate([t0[None], save_at, tf[None]])


def init_state(
    x0: Pytree,
    t_grid: jax.Array,
    h0,
    batch_shape: tuple = (),
    stepper_carry: Pytree = (),
    event_state: Pytree = (),
) -> IntState:
    """Initialize the loop carry (the ODEData::new analog, ode.rs:141-150).

    ``batch_shape`` != () builds a natively-batched carry: every per-
    trajectory scalar (t, h, cursor, status, counters) gets that leading
    shape, and each x0 leaf must already carry it. This is the hot ensemble
    path — one driver loop over a batched step_fn (e.g. a fused GEMM step),
    no vmap required.
    """
    tdt = t_grid.dtype
    n_grid = t_grid.shape[0]
    t0 = jnp.broadcast_to(t_grid[0], batch_shape)
    h0 = jnp.broadcast_to(jnp.asarray(h0, tdt), batch_shape)
    ys = jax.tree_util.tree_map(
        lambda a: jnp.zeros(
            batch_shape + (n_grid,) + jnp.shape(a)[len(batch_shape):],
            jnp.asarray(a).dtype,
        ),
        x0,
    )
    zero_i = jnp.zeros(batch_shape, jnp.int32)
    return IntState(
        t=t0,
        t_lo=jnp.zeros(batch_shape, tdt),
        x=x0,
        h=h0,
        prev_h=h0,
        tgt_idx=zero_i,
        status=zero_i,
        last_event=zero_i,
        err_norm=jnp.zeros(batch_shape, tdt),
        n_accept=zero_i,
        n_reject=zero_i,
        n_iters=zero_i,
        reject_streak=zero_i,
        ys=ys,
        ts_grid=t_grid,
        carry=stepper_carry,
        ev=event_state,
    )


def step_once(
    state: IntState,
    step_fn: Callable,
    *,
    adaptive: bool,
    ctl: StepControl,
    error_norm: Callable = lc.norm_l2,
    batched: bool = False,
    record_ys: bool = True,
    event_cfg=None,
    grad_safe: bool = False,
) -> IntState:
    """One driver iteration = one ``ODESolver::step()`` /
    ``step_adaptive()`` (ode.rs:249-253, 337-341), fully branchless.

    ``grad_safe=True`` (adaptive only): decide accept/reject on a
    stop-gradient evaluation and re-run the stepper with dt zeroed on
    rejected lanes, so overflowed trial residuals can never NaN the
    reverse pass (see the inline comment; used by ``method="scan"``
    gradients through nonlinear RHS).

    ``record_ys=False`` skips the save-grid recording (the loop carries a
    zero-size ys buffer); ``resume`` uses it for the n_grid == 2 fast path
    where ys is reconstructible as [x0, x_final] after the loop.

    ``step_fn(t, x, dt) -> (x_next, err)`` is the stepper kernel; ``err`` may
    be None for fixed-only steppers. ``adaptive`` and ``ctl`` are static.

    ``batched=True`` runs the natively-batched carry (see ``init_state``):
    t/h/status carry a leading batch axis, ``step_fn`` must be batched, and
    ``error_norm`` must reduce per trajectory (``lc.norm_l2_batched``, or the
    identity if the stepper already returns per-trajectory error norms).
    """
    t_grid = state.ts_grid
    n_grid = t_grid.shape[0]
    running = state.status == RUNNING

    # --- step_size_of (ode.rs:165-176): consult the save grid ---------------
    idx = jnp.minimum(state.tgt_idx, n_grid - 1)
    chk_t = jnp.take(t_grid, idx, axis=0)
    # compensated remaining time: the true t is (t + t_lo), so the grid
    # distance subtracts the residual word too (t_lo is zeros when
    # ctl.time_compensated is off, making this a no-op then)
    rem = (chk_t - state.t) - state.t_lo
    at_grid = jnp.abs(rem) <= end_tolerance(chk_t, ctl.strict_end_test)
    past_end = state.tgt_idx >= n_grid - 1
    is_end = running & at_grid & past_end
    is_chkpt = running & at_grid & ~past_end
    bad_grid = running & ~at_grid & (rem < 0)
    stepping = running & ~at_grid & ~bad_grid
    # masked-out lanes step with dt=0 (a no-op step): keeps discarded
    # evaluations finite so reverse-mode through the scan driver is not
    # poisoned by inf/NaN from post-DONE lanes
    dt = jnp.where(stepping, jnp.minimum(state.h, rem), 0.0)

    # --- try_step: run the stepper kernel ------------------------------------
    has_carry = len(jax.tree_util.tree_leaves(state.carry)) > 0

    def call_step(args):
        with jax.named_scope("vec_ode.try_step"):
            if batched:
                # per-trajectory masking: evaluate for all lanes (dt=0
                # no-ops)
                return step_fn(*args)
            # scalar driver: skip the (possibly expensive) stepper entirely
            # on grid-hit iterations — the reference's Chkpt branch does no
            # stepper work either (ode.rs:192-195)
            out_sds = jax.eval_shape(step_fn, *args)

            def _zeros_like_sds(sds):
                return jax.tree_util.tree_map(
                    lambda a: jnp.zeros(a.shape, a.dtype), sds
                )

            return jax.lax.cond(
                stepping,
                lambda: step_fn(*args),
                lambda: _zeros_like_sds(out_sds),
            )

    def controller_block(x_next_c, err_c, x_ref, prev_err, valid=None):
        # handle_step_adaptive (ode.rs:311-334); named scope labels the
        # HLO for jax.profiler / xprof traces
        if err_c is None:
            raise ValueError("adaptive integration requires an error estimate")
        if valid is None:
            valid = stepping
        with jax.named_scope("vec_ode.controller"):
            # masked (dt=0) lanes produce err=0, whose norm has a NaN
            # reverse-mode (d||err||/derr = err/||err|| = 0/0) and whose
            # f = rtol/0 = inf poisons the controller's VJP. Double-where:
            # neutralize the norm INPUT and the measure; the masked lanes'
            # h/accept are discarded anyway.
            err_safe = lc.tree_where(
                valid, err_c, jax.tree_util.tree_map(jnp.ones_like, err_c)
            )
            measure = error_measure(error_norm, x_ref, x_next_c, err_safe,
                                    ctl)
            if jnp.ndim(measure) != jnp.ndim(stepping):
                # an unbatched norm over a batched state couples every
                # lane through ONE scalar controller decision — silently
                # wrong results; the caller must vmap the norm (or use
                # lc.norm_l2_batched)
                raise ValueError(
                    "error_norm reduced a batched state to shape "
                    f"{jnp.shape(measure)} but the batch is "
                    f"{jnp.shape(stepping)}; use a PER-TRAJECTORY norm "
                    "(jax.vmap(error_norm) / lc.norm_l2_batched)"
                )
            measure = jnp.where(valid, measure, jnp.ones_like(measure))
            new_h, accept = controller_update(
                state.h, measure, ctl, prev_err_norm=prev_err,
                prev_rejected=state.reject_streak > 0,
            )
        return measure, new_h, accept

    args = (state.t, state.x, dt) + (
        (state.carry,) if has_carry else ()
    )
    if adaptive and grad_safe:
        # GRAD-SAFE adaptive stepping (the reverse-mode NaN caveat): a
        # rejected trial evaluated at an overlarge dt can overflow inside
        # the stepper; the primal discards it, but reverse-mode still
        # linearizes that evaluation, and 0-cotangent x inf-residual = NaN
        # poisons the whole VJP. Cure (double-where on the INPUT): make the
        # accept decision on a throwaway stop-gradient pass, then
        # re-evaluate the stepper with dt zeroed on rejected lanes — the
        # differentiated evaluation never sees the overflowing trial.
        # On ACCEPTED lanes the re-evaluation reproduces the decision pass
        # exactly (same inputs, deterministic), so measure/new_h are
        # recomputed differentiably there and the smooth h-evolution
        # sensitivity is KEPT (measured: detaching it biases a Van-der-Pol
        # mu-gradient by ~4%); only the reject branch's h-shrink gradient
        # is dropped — exactly zero anyway when the trial overflowed
        # (new_h pins at min_factor*h there). Costs a second stepper
        # evaluation per iteration.
        sg = jax.lax.stop_gradient
        # stop-grad the decision pass's OUTPUTS as well as its inputs: the
        # stepper typically closes over parameters, and any non-sg consumer
        # of these values would pull a cotangent back through the
        # (possibly overflowed) evaluation. With every output sg'd the
        # cotangents are symbolic zeros and JAX never transposes the pass.
        out_dec = jax.tree_util.tree_map(
            sg, call_step(jax.tree_util.tree_map(sg, args)))
        x_dec, err_dec = out_dec[0], out_dec[1]
        measure_dec, new_h_dec, accept = controller_block(
            x_dec, err_dec, sg(state.x), sg(state.err_norm))
        accept = sg(accept)
        acc_b = jnp.broadcast_to(jnp.asarray(accept), stepping.shape)
        dt_eff = jnp.where(acc_b & stepping, dt, 0.0)
        out = call_step(
            (state.t, state.x, dt_eff)
            + ((state.carry,) if has_carry else ())
        )
        dt = dt_eff  # the advance must add the dt actually integrated
    else:
        out = call_step(args)
    if has_carry:
        x_next, err, carry_next = out
    else:
        x_next, err = out
        carry_next = ()

    if adaptive and grad_safe:
        # differentiable controller recomputation, valid on accepted lanes
        # only (rejected lanes keep the stop-gradient decision values)
        measure2, new_h2, _ = controller_block(
            x_next, err, state.x, state.err_norm, valid=acc_b & stepping)
        measure = jnp.where(acc_b, measure2, measure_dec)
        new_h = jnp.where(acc_b, new_h2, new_h_dec)
    elif adaptive:
        measure, new_h, accept = controller_block(
            x_next, err, state.x, state.err_norm)
    else:
        measure = state.err_norm
        new_h, accept = state.h, jnp.asarray(True)

    # --- event detection (events.py: crossings handled as step-size
    # control — search lanes veto the advance and retry with the regula-
    # falsi bracket) -----------------------------------------------------
    has_events = (
        event_cfg is not None
        and len(jax.tree_util.tree_leaves(state.ev)) > 0
    )
    if has_events:
        from .events import event_step

        with jax.named_scope("vec_ode.events"):
            accept = jnp.broadcast_to(jnp.asarray(accept), stepping.shape)
            eo = event_step(
                event_cfg, state.ev, state.t, dt, state.x, x_next,
                stepping, accept,
            )
        accept = eo.accept

    do_advance = stepping & accept
    do_reject = stepping & ~accept

    # --- apply_step (ode.rs:402-428), masked ----------------------------------
    if ctl.time_compensated:
        t_hi, t_lo_new = comp_time_advance(state.t, state.t_lo, dt)
        t = jnp.where(do_advance, t_hi, state.t)
        t_lo = jnp.where(do_advance, t_lo_new, state.t_lo)
    else:
        t = jnp.where(do_advance, state.t + dt, state.t)
        t_lo = state.t_lo
    x = lc.tree_where(do_advance, x_next, state.x)
    # stepper carry advances only with the state (on reject/no-op the old
    # carry — e.g. the FSAL slope f(t, x) — is still valid: t, x unchanged)
    carry = (
        lc.tree_where(do_advance, carry_next, state.carry)
        if has_carry else state.carry
    )

    # update_step_size on every attempted step (ode.rs:202-205, 326)
    prev_h = jnp.where(stepping & jnp.asarray(adaptive), state.h, state.prev_h)
    h = jnp.where(stepping & jnp.asarray(adaptive), new_h, state.h)
    # checkpoint_update (ode.rs:192-195): restore pre-truncation h
    h = jnp.where(at_grid & running, prev_h, h)
    tgt_idx = jnp.where(at_grid & running, state.tgt_idx + 1, state.tgt_idx)
    if has_events:
        # bracket search overrides the controller's h; a completed search
        # restores the pre-search step (same discipline as the grid-hit
        # prev_h restore above)
        h = jnp.where(eo.search, jnp.asarray(eo.h_override, h.dtype), h)
        h = jnp.where(eo.restore_h, jnp.asarray(eo.h_entry, h.dtype), h)
        prev_h = jnp.where(eo.restore_h, jnp.asarray(eo.h_entry, h.dtype),
                           prev_h)

    # record (t, x) on grid-hit iterations (Chkpt/End emission points).
    # One-hot select over the (small) save grid in BOTH modes: a
    # dynamic_update would become a scatter under vmap, which costs more
    # than the masked select.
    if record_ys:
        hit = (
            jax.lax.broadcasted_iota(jnp.int32, idx.shape + (n_grid,),
                                     idx.ndim)
            == idx[..., None]
        ) & (at_grid & running)[..., None]                 # (B?, n_grid)

        def record(buf, leaf):
            m = hit.reshape(hit.shape + (1,) * (leaf.ndim - idx.ndim))
            return jnp.where(m, jnp.expand_dims(leaf, idx.ndim), buf)

        ys = jax.tree_util.tree_map(record, state.ys, state.x)
    else:
        ys = state.ys

    status = jnp.where(is_end, DONE, state.status)
    status = jnp.where(bad_grid, ERR_BAD_GRID, status)
    n_iters = state.n_iters + jnp.where(running, 1, 0).astype(jnp.int32)
    status = jnp.where(
        (status == RUNNING) & (n_iters >= ctl.max_steps), ERR_MAX_STEPS, status
    )
    # event-search iterations are NOT numerical rejections: they must not
    # trip the livelock detector or pollute the reject statistics
    true_reject = do_reject & ~eo.search if has_events else do_reject
    if has_events:
        status = jnp.where(eo.terminal_hit, DONE_EVENT, status)
    streak = jnp.where(
        true_reject, state.reject_streak + 1,
        jnp.where(do_advance, 0, state.reject_streak),
    ).astype(jnp.int32)
    if ctl.max_reject_streak > 0:
        status = jnp.where(
            (status == RUNNING) & (streak >= ctl.max_reject_streak),
            ERR_STALLED, status,
        )

    event = jnp.where(
        is_end,
        EVT_END,
        jnp.where(
            is_chkpt,
            EVT_CHKPT,
            jnp.where(do_reject, EVT_REJECT,
                      jnp.where(do_advance, EVT_STEP, EVT_NONE)),
        ),
    ).astype(jnp.int32)

    return IntState(
        t=t,
        t_lo=t_lo,
        x=x,
        h=h,
        prev_h=prev_h,
        tgt_idx=tgt_idx,
        status=status,
        last_event=event,
        err_norm=jnp.where(stepping, jnp.asarray(measure, state.err_norm.dtype),
                           state.err_norm),
        n_accept=state.n_accept + do_advance.astype(jnp.int32),
        n_reject=state.n_reject + true_reject.astype(jnp.int32),
        n_iters=n_iters,
        reject_streak=streak,
        ys=ys,
        ts_grid=state.ts_grid,
        carry=carry,
        ev=eo.ev_next if has_events else state.ev,
    )


@dataclasses.dataclass
class Solution:
    """Integration result. ``ts``/``ys`` follow the save grid.

    ``path`` records WHICH execution path produced the result (static
    metadata, not a traced value):
      * ``"xla-driver"`` — the lax.while_loop/scan driver in this module;
      * ``"xla-driver-dense"`` — the free-running dense-output driver
        (parallel.ensemble_solve(dense=True) on a batched stepper)."""

    ts: jax.Array
    ys: Pytree
    t_final: jax.Array
    y_final: Pytree
    status: jax.Array
    n_accept: jax.Array
    n_reject: jax.Array
    n_iters: jax.Array
    h_final: jax.Array
    n_rhs_evals: Optional[jax.Array] = None  # iterations x stages (api layer)
    # event outputs (events.py; None when the solve had no events=...):
    # first located crossing per Event — time (inf if never found), found
    # mask, and the event-time state (None if EventConfig.record_y=False)
    event_t: Optional[jax.Array] = None      # (..., E)
    event_found: Optional[jax.Array] = None  # (..., E) bool
    event_y: Optional[Pytree] = None         # (..., E) + state shape
    # multi-crossing outputs (EventConfig.max_crossings = K): first-K
    # located times (slot s = the (s+1)-th crossing; inf when not reached)
    # and the TOTAL matching-crossing count (includes counted-only
    # crossings beyond K)
    event_t_k: Optional[jax.Array] = None    # (..., E, K)
    event_count: Optional[jax.Array] = None  # (..., E) int32
    path: str = "xla-driver"                 # static execution-path tag

    @property
    def success(self):
        # DONE_EVENT (terminal Event located) is a successful exit: the
        # integration stopped exactly where it was asked to
        return (self.status == DONE) | (self.status == DONE_EVENT)

    def __repr__(self):
        # compact: the dataclass default would print whole state arrays
        def fmt(v):
            try:
                if hasattr(v, "shape") and v.shape:
                    return f"<{v.dtype}{list(v.shape)}>"
                return str(v)
            except Exception:
                return "<...>"

        leaves = jax.tree_util.tree_leaves(self.ys)
        ys_s = fmt(leaves[0]) if leaves else "<empty>"
        return (
            f"Solution(status={fmt(self.status)}, t_final={fmt(self.t_final)},"
            f" n_accept={fmt(self.n_accept)}, n_reject={fmt(self.n_reject)},"
            f" h_final={fmt(self.h_final)}, ys={ys_s})"
        )


jax.tree_util.register_pytree_node(
    Solution,
    lambda s: (
        (s.ts, s.ys, s.t_final, s.y_final, s.status, s.n_accept, s.n_reject,
         s.n_iters, s.h_final, s.n_rhs_evals, s.event_t, s.event_found,
         s.event_y, s.event_t_k, s.event_count),
        s.path,
    ),
    lambda aux, ch: Solution(*ch, path=aux),
)


class _CarryPacker:
    """Pack a loop-carry pytree into ONE buffer per dtype.

    A backend that charges a fixed cost per CARRY LEAF per loop iteration
    pays it once per dtype instead of once per leaf (a 14-leaf IntState
    becomes 2-3 buffers); the pack/unpack slices live INSIDE the loop body
    where XLA fuses them away. Whether this pays on the GPU is not
    measured yet. This is the flatten/unflatten boundary SURVEY §7 (hard
    part 5) anticipated — applied to the carry, not the user state.
    """

    def __init__(self, tree: Pytree, batch_ndim: int):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        self.treedef = treedef
        self.batch_ndim = batch_ndim
        self.shapes = [jnp.shape(l) for l in leaves]
        self.dtypes = [jnp.asarray(l).dtype for l in leaves]
        self.groups: dict = {}
        for i, dt in enumerate(self.dtypes):
            self.groups.setdefault(dt, []).append(i)

    def _suffix_size(self, i: int) -> int:
        import math

        return math.prod(self.shapes[i][self.batch_ndim:])

    def pack(self, tree: Pytree):
        leaves = jax.tree_util.tree_flatten(tree)[0]
        bufs = []
        for idxs in self.groups.values():
            parts = [
                jnp.reshape(
                    leaves[i], self.shapes[i][: self.batch_ndim] + (-1,)
                )
                for i in idxs
            ]
            bufs.append(
                parts[0] if len(parts) == 1 else jnp.concatenate(parts, -1)
            )
        return tuple(bufs)

    def unpack(self, bufs) -> Pytree:
        leaves = [None] * len(self.shapes)
        for buf, idxs in zip(bufs, self.groups.values()):
            off = 0
            for i in idxs:
                sz = self._suffix_size(i)
                leaves[i] = jnp.reshape(
                    buf[..., off:off + sz], self.shapes[i]
                )
                off += sz
        return jax.tree_util.tree_unflatten(self.treedef, leaves)


def integrate(
    step_fn: Callable,
    x0: Pytree,
    t_grid: jax.Array,
    h0,
    *,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    error_norm: Callable = lc.norm_l2,
    method: str = "while",
    batch_shape: tuple = (),
    pack_carry: bool = False,
    init_carry_fn: Optional[Callable] = None,
    event_cfg=None,
    remat_levels: int = 0,
    grad_safe: bool = False,
) -> Solution:
    """Run the full integration loop over [t_grid[0], t_grid[-1]].

    ``init_carry_fn(t0, x0)`` (optional) seeds a stepper carry threaded
    through the loop as ``step_fn(t, x, dt, carry) -> (x_next, err,
    carry_next)`` — e.g. the FSAL first-stage slope (rk.py).

    The user-loop pattern of the reference
    (``while let ODEState::Ok(_) = solver.step()``, impls/nalgebra.rs:61-64)
    becomes a single compiled loop; use ``init_state`` + ``step_once``
    directly for a step-by-step (debugger/parity) view.

    method:
      * ``"while"`` (default) — ``lax.while_loop``; terminates as soon as all
        trajectories finish. Not reverse-mode differentiable (XLA while).
      * ``"scan"`` — exactly ``ctl.max_steps`` iterations of the self-masking
        body under ``lax.scan``: reverse-mode differentiable (the capability
        the reference's empty ``diff`` module only declared, lib.rs:12) and
        rematerialization-friendly via ``jax.checkpoint``. Pick a tight
        ``ctl.max_steps`` — every iteration costs a stepper evaluation.

    ``remat_levels=k > 0`` (scan mode only) runs the scan as k+1 NESTED
    scans of ~max_steps^(1/(k+1)) iterations each, every inner level
    wrapped in ``jax.checkpoint`` — binomial/treeverse-style checkpointing:
    reverse-mode memory drops from O(T) residuals to O((k+1)·T^(1/(k+1)))
    stored carries at the cost of re-running the forward pass k more
    times. ``k=2`` puts a 1e5-step Van-der-Pol gradient within laptop
    memory (tests/test_treeverse.py pins the compiled temp-buffer curve).
    With remat_levels > 0 the 65536-step scan guard is lifted (memory no
    longer scales with T).

    ``grad_safe=True`` (adaptive scan gradients): see :func:`step_once` —
    rejected-trial overflow can no longer NaN the VJP; costs a second
    stepper evaluation per iteration (accepted-step controller
    sensitivity is kept; only reject-branch h-shrink gradients drop).
    """
    carry0 = () if init_carry_fn is None else init_carry_fn(t_grid[0], x0)
    ev0: Pytree = ()
    if event_cfg is not None:
        from .events import init_event_state

        ev0 = init_event_state(event_cfg, jnp.broadcast_to(
            jnp.asarray(t_grid[0]), batch_shape), x0,
            batch_shape=batch_shape)
    state = init_state(x0, t_grid, h0, batch_shape=batch_shape,
                       stepper_carry=carry0, event_state=ev0)
    return resume(
        state, step_fn, adaptive=adaptive, ctl=ctl, error_norm=error_norm,
        method=method, batched=bool(batch_shape), pack_carry=pack_carry,
        event_cfg=event_cfg, remat_levels=remat_levels, grad_safe=grad_safe,
    )


def resume(
    state: IntState,
    step_fn: Callable,
    *,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    error_norm: Callable = lc.norm_l2,
    method: str = "while",
    batched: bool = False,
    pack_carry: bool = False,
    event_cfg=None,
    remat_levels: int = 0,
    grad_safe: bool = False,
) -> Solution:
    """Continue integration from an existing carry — the checkpoint/resume
    path (SURVEY §5): save an IntState mid-run (``utils.checkpointing`` or
    any pytree serializer), restore it later, and resume; the save-grid
    cursor, step size and counters all carry over."""
    # n_grid == 2 fast path: the default [t0, tf] grid records exactly
    # [x0, x_final], so ys is dropped from the LOOP (zero-size buffer, no
    # record op per iteration) and reconstructed afterwards.
    bn = jnp.ndim(state.t)
    n_grid = state.ts_grid.shape[0]
    elide_ys = n_grid == 2
    if elide_ys:
        init_x, init_ys, init_tgt = state.x, state.ys, state.tgt_idx
        state = state._replace(
            ys=jax.tree_util.tree_map(
                lambda a: jax.lax.slice_in_dim(a, 0, 0, axis=bn), state.ys
            )
        )

    body = partial(
        step_once, step_fn=step_fn, adaptive=adaptive, ctl=ctl,
        error_norm=error_norm, batched=batched, record_ys=not elide_ys,
        event_cfg=event_cfg, grad_safe=grad_safe,
    )

    # run the loop over a PACKED carry (one buffer per dtype): the loop
    # boundary is where the backend's per-leaf cost bites; the math stays
    # single-source in step_once. ts_grid is loop-invariant -> closed over.
    # ``pack_carry=False`` keeps the plain pytree carry (cheap fixed-step
    # bodies that XLA fully fuses can be faster unpacked).
    t_grid = state.ts_grid
    if pack_carry:
        stripped = state._replace(ts_grid=())
        packer = _CarryPacker(stripped, batch_ndim=jnp.ndim(state.t))

        def to_carry(s):
            return packer.pack(s._replace(ts_grid=()))

        def of_carry(bufs):
            return packer.unpack(bufs)._replace(ts_grid=t_grid)

        carry0 = packer.pack(stripped)
    else:
        # strip the loop-invariant ts_grid from the carry even unpacked
        # (a passthrough leaf can cost per-iteration copies when the body
        # doesn't fully fuse)
        to_carry = lambda s: s._replace(ts_grid=())
        of_carry = lambda s: s._replace(ts_grid=t_grid)
        carry0 = state._replace(ts_grid=())

    def body_packed(bufs):
        return to_carry(body(of_carry(bufs)))

    def status_of(bufs):
        return of_carry(bufs).status  # XLA prunes the unused slices

    if method == "while":
        if remat_levels > 0:
            raise ValueError(
                "remat_levels only applies to method='scan' (reverse-mode "
                "checkpointing of a fixed-length scan); the default "
                "while-loop driver is not reverse-differentiable"
            )
        final_bufs = jax.lax.while_loop(
            lambda b: jnp.any(status_of(b) == RUNNING), body_packed, carry0
        )
    elif method == "scan":
        if ctl.max_steps > 65536 and remat_levels == 0:
            raise ValueError(
                f"method='scan' runs EXACTLY ctl.max_steps={ctl.max_steps} "
                "iterations (every one pays a stepper evaluation). Set a "
                "tight StepControl.max_steps (the default 1,000,000 is a "
                "while-loop safety cap, not a scan length), or pass "
                "remat_levels >= 1 for checkpointed O(T^(1/(k+1))) memory."
            )
        if remat_levels > 0:
            # nested-remat (binomial/treeverse) scan: k+1 levels of
            # ~T^(1/(k+1)) iterations, each inner level rematerialized —
            # reverse-mode stores only the carries at level boundaries
            import math

            L = int(remat_levels) + 1
            n = max(2, math.ceil(ctl.max_steps ** (1.0 / L)))
            lengths = [n] * L
            # trim overshoot level-by-level (total must stay >= max_steps;
            # extra iterations are self-masking no-ops but still pay a
            # stepper evaluation each)
            for i in range(L):
                while (lengths[i] > 1
                       and (math.prod(lengths) // lengths[i])
                       * (lengths[i] - 1) >= ctl.max_steps):
                    lengths[i] -= 1

            def run_nested(carry, lens):
                if len(lens) == 1:
                    return jax.lax.scan(
                        lambda b, _: (body_packed(b), None), carry, None,
                        length=lens[0],
                    )[0]
                inner = jax.checkpoint(
                    lambda b: run_nested(b, lens[1:]))
                return jax.lax.scan(
                    lambda b, _: (inner(b), None), carry, None,
                    length=lens[0],
                )[0]

            final_bufs = run_nested(carry0, lengths)
        else:
            final_bufs, _ = jax.lax.scan(
                lambda b, _: (body_packed(b), None), carry0, None,
                length=ctl.max_steps,
            )
    else:
        raise ValueError(f"unknown integrate method: {method!r}")
    final = of_carry(final_bufs)

    if elide_ys:
        def sel(mask, a, b):
            m = mask.reshape(mask.shape + (1,) * (jnp.ndim(a) - mask.ndim))
            return jnp.where(m, a, b)

        def grid_slot(tree, i):
            return jax.tree_util.tree_map(
                lambda a: jax.lax.index_in_dim(a, i, axis=bn,
                                               keepdims=False), tree
            )

        # slot 0 records x0 iff the run started at the grid head; slot 1
        # records the final state iff the end was reached (tgt advanced
        # past it) — otherwise keep whatever the caller's state held
        ys0 = jax.tree_util.tree_map(
            partial(sel, init_tgt == 0), init_x, grid_slot(init_ys, 0)
        )
        ys1 = jax.tree_util.tree_map(
            partial(sel, final.tgt_idx >= 2), final.x, grid_slot(init_ys, 1)
        )
        final = final._replace(
            ys=jax.tree_util.tree_map(
                lambda a, b: jnp.stack([a, b], axis=bn), ys0, ys1
            )
        )
    ev_kw = {}
    if event_cfg is not None and len(
        jax.tree_util.tree_leaves(final.ev)
    ) > 0:
        ev_kw = dict(
            event_t=final.ev.t_ev[..., 0],
            event_found=final.ev.found,
            event_y=final.ev.y_ev if event_cfg.record_y else None,
            event_t_k=final.ev.t_ev,
            event_count=final.ev.count,
        )
    return Solution(
        ts=final.ts_grid,
        ys=final.ys,
        t_final=final.t,
        y_final=final.x,
        status=final.status,
        n_accept=final.n_accept,
        n_reject=final.n_reject,
        n_iters=final.n_iters,
        h_final=final.h,
        **ev_kw,
    )
