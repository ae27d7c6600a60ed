"""Dense output: interpolated saves without grid-hitting.

The reference has **no dense output / interpolation** (SURVEY §2.3(5)): its
only output mechanism is truncating steps to land exactly on t_list times,
which perturbs the step-size sequence around every save point. This module
adds the modern alternative: the controller runs free (steps are never
truncated except at tf) and crossed save times are filled by interpolation
from the step's own data.

Interpolants, per tableau:
  * tableaus carrying dense coefficients (``p_dense``: DOPRI5 order-4,
    BOSH32 order-3) use the standard continuous extension
    y(t+theta dt) = y0 + dt theta sum_j K_j P_j(theta) built from the stage
    slopes — matching the advanced (b) solution's order, at ZERO extra RHS
    evaluations;
  * otherwise cubic Hermite from (x, f) at both step ends — local O(h^4);
    FSAL tableaus get the right-endpoint slope free, others pay one extra
    RHS evaluation per attempt.

The dense driver supports ``method="scan"`` (reverse-mode differentiable)
and natively-batched carries (``batch_shape``), mirroring
:func:`~vec_ode_tpu.driver.integrate`.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from . import lc
from .controller import StepControl, controller_update, end_tolerance, error_measure
from .driver import (
    DONE,
    ERR_MAX_STEPS,
    ERR_STALLED,
    RUNNING,
    IntState,
    Solution,
    _CarryPacker,
    comp_time_advance,
    init_state,
)

Pytree = Any


def _hermite_basis(th):
    """The four cubic Hermite basis polynomials on [0, 1]."""
    h00 = 2 * th**3 - 3 * th**2 + 1
    h10 = th**3 - 2 * th**2 + th
    h01 = -2 * th**3 + 3 * th**2
    h11 = th**3 - th**2
    return h00, h10, h01, h11


def hermite_cubic(x0: Pytree, x1: Pytree, f0: Pytree, f1: Pytree, dt, theta):
    """Cubic Hermite interpolant on [0, 1] with endpoint values/slopes."""
    h00, h10, h01, h11 = _hermite_basis(theta)

    def leaf(a, b, fa, fb):
        hdt = lc._match_scalar(dt, a)
        return (
            lc._match_scalar(h00, a) * a
            + lc._match_scalar(h10, a) * hdt * fa
            + lc._match_scalar(h01, a) * b
            + lc._match_scalar(h11, a) * hdt * fb
        )

    return jax.tree_util.tree_map(leaf, x0, x1, f0, f1)


def _grid_match(s, leaf_ndim, bn):
    """Reshape a batch+(n_grid,) scalar field to broadcast against a
    batch+(n_grid,)+suffix leaf."""
    return s.reshape(s.shape + (1,) * (leaf_ndim - s.ndim))


def _interp_crossed(interp_kind, tab, x0, x1, idata, dt, theta, bn):
    """Evaluate the interpolant at every grid time at once.

    theta: batch+(n_grid,); x0/x1/idata leaves: batch+suffix.
    Returns a pytree of batch+(n_grid,)+suffix interpolated values."""
    if interp_kind == "p_dense":
        P = tab.p_dense
        s, q = P.shape
        polys = [
            sum(
                float(P[j, k]) * theta**k
                for k in range(q) if P[j, k] != 0.0
            )
            for j in range(s)
        ]
        dt_th = jnp.asarray(dt)[..., None] * theta  # batch+(n_grid,)

        def leaf(x0_l, *K_ls):
            x0e = jnp.expand_dims(x0_l, bn)
            acc = None
            for j in range(s):
                if isinstance(polys[j], (int, float)) and polys[j] == 0:
                    continue
                term = _grid_match(polys[j], x0e.ndim, bn) * jnp.expand_dims(
                    K_ls[j], bn
                )
                acc = term if acc is None else acc + term
            return x0e + _grid_match(dt_th, x0e.ndim, bn) * acc

        return jax.tree_util.tree_map(leaf, x0, *idata)

    f0, f1 = idata
    h00, h10, h01, h11 = _hermite_basis(theta)
    hdt = jnp.asarray(dt)[..., None] * jnp.ones_like(theta)

    def leaf(a, b, fa, fb):
        ae = jnp.expand_dims(a, bn)
        nd = ae.ndim
        return (
            _grid_match(h00, nd, bn) * ae
            + _grid_match(h10 * hdt, nd, bn) * jnp.expand_dims(fa, bn)
            + _grid_match(h01, nd, bn) * jnp.expand_dims(b, bn)
            + _grid_match(h11 * hdt, nd, bn) * jnp.expand_dims(fb, bn)
        )

    return jax.tree_util.tree_map(leaf, x0, x1, f0, f1)


def _dense_step(
    state: IntState,
    step_fn_dense: Callable,
    *,
    adaptive: bool,
    ctl: StepControl,
    error_norm: Callable,
    interp_kind: str,
    tab,
) -> IntState:
    """One free-running iteration: only tf truncates dt; crossed interior
    save times are recorded via interpolation. Shape-generic: works for the
    scalar carry and natively-batched (B,) carries alike."""
    t_grid = state.ts_grid
    n_grid = t_grid.shape[0]
    bn = jnp.ndim(state.t)
    running = state.status == RUNNING

    tf = t_grid[-1]
    # compensated remaining time (see driver.comp_time_advance; t_lo is
    # zeros when ctl.time_compensated is off)
    rem = (tf - state.t) - state.t_lo
    at_end = jnp.abs(rem) <= end_tolerance(tf, ctl.strict_end_test)
    stepping = running & ~at_end
    # dt=0 on masked lanes keeps discarded evaluations finite (grad-safe)
    dt = jnp.where(stepping, jnp.minimum(state.h, rem), 0.0)

    has_carry = len(jax.tree_util.tree_leaves(state.carry)) > 0
    if has_carry:
        x_next, err, idata, carry_next = step_fn_dense(
            state.t, state.x, dt, state.carry
        )
    else:
        x_next, err, idata = step_fn_dense(state.t, state.x, dt)
        carry_next = ()

    if adaptive:
        if err is None:
            raise ValueError("adaptive integration requires an error estimate")
        # double-where (see driver.step_once): masked lanes' zero err has a
        # NaN norm-VJP and an inf controller factor; neutralize both
        err_safe = lc.tree_where(
            stepping, err, jax.tree_util.tree_map(jnp.ones_like, err)
        )
        measure = error_measure(error_norm, state.x, x_next, err_safe, ctl)
        measure = jnp.where(stepping, measure, jnp.ones_like(measure))
        new_h, accept = controller_update(
            state.h, measure, ctl, prev_err_norm=state.err_norm,
            prev_rejected=state.reject_streak > 0,
        )
    else:
        measure = state.err_norm
        new_h, accept = state.h, jnp.asarray(True)

    do_advance = stepping & accept
    do_reject = stepping & ~accept
    if ctl.time_compensated:
        t_new, t_lo_new = comp_time_advance(state.t, state.t_lo, dt)
    else:
        t_new, t_lo_new = state.t + dt, state.t_lo

    # record every save time crossed by this accepted step (vectorized over
    # the whole grid; n_grid is small). Index 0 (t0) records the initial
    # state; index n_grid-1 (tf) is landed on exactly.
    tol = end_tolerance(t_grid)
    crossed = (
        do_advance[..., None]
        & (t_grid > state.t[..., None] + tol)
        & (t_grid <= t_new[..., None] + tol)
    )                                            # batch+(n_grid,)
    crossed = crossed | (
        (jnp.arange(n_grid) == 0)
        & (state.n_iters == 0)[..., None]
        & running[..., None]
    )
    # double-where: masked lanes carry dt=0, and a tiny-denominator division
    # would poison reverse-mode with inf * 0 = NaN even though the forward
    # value is discarded
    safe_dt = jnp.where(dt > 0, dt, 1.0)
    theta = jnp.clip(
        (t_grid - state.t[..., None]) / safe_dt[..., None], 0.0, 1.0
    )

    interp = _interp_crossed(
        interp_kind, tab, state.x, x_next, idata, dt, theta, bn
    )

    # slot 0 records x0 DIRECTLY, not through the interpolant: a rejected
    # first trial with overflowed stages would otherwise poison theta=0
    # as 0 * inf = NaN, and the slot-0 bit never fires again
    slot0 = (
        (jnp.arange(n_grid) == 0)
        & (state.n_iters == 0)[..., None]
        & running[..., None]
    )

    def record(buf, val, x0leaf):
        m = _grid_match(crossed, buf.ndim, bn)
        m0 = _grid_match(slot0, buf.ndim, bn)
        return jnp.where(
            m0, jnp.expand_dims(x0leaf, bn), jnp.where(m, val, buf))

    ys = jax.tree_util.tree_map(record, state.ys, interp, state.x)

    t = jnp.where(do_advance, t_new, state.t)
    t_lo = jnp.where(do_advance, t_lo_new, state.t_lo)
    x = lc.tree_where(do_advance, x_next, state.x)
    carry = (
        lc.tree_where(do_advance, carry_next, state.carry)
        if has_carry else state.carry
    )
    prev_h = jnp.where(stepping & jnp.asarray(adaptive), state.h,
                       state.prev_h)
    h = jnp.where(stepping & jnp.asarray(adaptive), new_h, state.h)
    tgt_idx = jnp.sum(
        (t_grid <= t[..., None] + end_tolerance(t_grid)), axis=-1
    ).astype(jnp.int32)

    status = jnp.where(running & at_end, DONE, state.status)
    n_iters = state.n_iters + jnp.where(running, 1, 0).astype(jnp.int32)
    status = jnp.where(
        (status == RUNNING) & (n_iters >= ctl.max_steps), ERR_MAX_STEPS,
        status,
    )
    streak = jnp.where(
        do_reject, state.reject_streak + 1,
        jnp.where(do_advance, 0, state.reject_streak),
    ).astype(jnp.int32)
    if ctl.max_reject_streak > 0:
        status = jnp.where(
            (status == RUNNING) & (streak >= ctl.max_reject_streak),
            ERR_STALLED, status,
        )

    return state._replace(
        t=t, t_lo=t_lo, x=x, h=h, prev_h=prev_h, tgt_idx=tgt_idx,
        status=status,
        err_norm=jnp.where(stepping, jnp.asarray(measure,
                                                 state.err_norm.dtype),
                           state.err_norm),
        n_accept=state.n_accept + do_advance.astype(jnp.int32),
        n_reject=state.n_reject + do_reject.astype(jnp.int32),
        n_iters=n_iters, reject_streak=streak, ys=ys, carry=carry,
    )


def integrate_interp(
    step_fn_dense: Callable,
    x0: Pytree,
    t_grid: jax.Array,
    h0,
    *,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    error_norm: Callable = lc.norm_l2,
    interp_kind: str = "hermite",
    tab=None,
    method: str = "while",
    batch_shape: tuple = (),
    init_carry_fn: Optional[Callable] = None,
    pack_carry: bool = False,
) -> Solution:
    """Free-running integration with interpolated saves at ``t_grid``.

    Unlike :func:`~vec_ode_tpu.driver.integrate` ("hit" semantics), save
    times never perturb the step sequence: the controller's h evolution is
    identical to a run with no save points at all. At the final grid time
    the last recorded value is the interpolant of the step that crossed it;
    tf itself is still landed on exactly so ``y_final`` is non-interpolated.

    ``method="scan"`` runs exactly ``ctl.max_steps`` self-masking iterations
    under ``lax.scan`` — reverse-mode differentiable. ``batch_shape`` builds
    a natively-batched carry (per-trajectory t/h/status; ``step_fn_dense``
    must be batched and ``error_norm`` per-trajectory).
    """
    carry0 = () if init_carry_fn is None else init_carry_fn(t_grid[0], x0)
    state = init_state(x0, t_grid, h0, batch_shape=batch_shape,
                       stepper_carry=carry0)
    body = partial(
        _dense_step, step_fn_dense=step_fn_dense, adaptive=adaptive,
        ctl=ctl, error_norm=error_norm, interp_kind=interp_kind, tab=tab,
    )

    t_grid_c = state.ts_grid
    if pack_carry:
        stripped = state._replace(ts_grid=())
        packer = _CarryPacker(stripped, batch_ndim=jnp.ndim(state.t))
        to_c = lambda s: packer.pack(s._replace(ts_grid=()))
        of_c = lambda b: packer.unpack(b)._replace(ts_grid=t_grid_c)
        carry_init = packer.pack(stripped)
    else:
        to_c = lambda s: s
        of_c = lambda s: s
        carry_init = state

    def body_c(c):
        return to_c(body(of_c(c)))

    if method == "while":
        final_c = jax.lax.while_loop(
            lambda c: jnp.any(of_c(c).status == RUNNING), body_c, carry_init
        )
    elif method == "scan":
        if ctl.max_steps > 65536:
            raise ValueError(
                f"method='scan' runs EXACTLY ctl.max_steps={ctl.max_steps} "
                "iterations; set a tight StepControl.max_steps"
            )
        final_c, _ = jax.lax.scan(
            lambda c, _: (body_c(c), None), carry_init, None,
            length=ctl.max_steps,
        )
    else:
        raise ValueError(f"unknown integrate_interp method: {method!r}")
    final = of_c(final_c)

    # tf is landed on exactly -> overwrite the last slot with the true
    # state, but only for lanes that actually REACHED tf (a failed lane's
    # mid-integration state must not masquerade as y(tf); its slot keeps
    # the recorded value — zeros if never reached, like the hit driver)
    bn = jnp.ndim(final.t)
    done = final.status == DONE

    def _overwrite_last(buf, leaf):
        last = jax.lax.index_in_dim(buf, buf.shape[bn] - 1, axis=bn,
                                    keepdims=False)
        nd = jnp.expand_dims(
            jnp.where(
                jnp.reshape(done, done.shape + (1,) * (leaf.ndim - bn)),
                leaf, last),
            bn)
        return jnp.concatenate(
            [jax.lax.slice_in_dim(buf, 0, buf.shape[bn] - 1, axis=bn), nd],
            axis=bn,
        )

    ys = jax.tree_util.tree_map(_overwrite_last, final.ys, final.x)
    return Solution(
        ts=final.ts_grid,
        ys=ys,
        t_final=final.t,
        y_final=final.x,
        status=final.status,
        n_accept=final.n_accept,
        n_reject=final.n_reject,
        n_iters=final.n_iters,
        h_final=final.h,
    )


def solve_ivp_dense(
    f: Callable,
    t0,
    tf,
    y0: Pytree,
    *,
    tableau=None,
    h0=None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype=None,
    advance_lower: Optional[bool] = None,
    method: str = "while",
    batch_shape: tuple = (),
) -> Solution:
    """solve_ivp with interpolated (non-perturbing) saves.

    Interpolant selection (see module docstring): tableaus with dense
    coefficients AND ``advance_lower=False`` use their order-matched
    continuous extension from the stage slopes (zero extra RHS
    evaluations; FSAL reuse included); otherwise cubic Hermite, whose
    right-endpoint slope costs one extra evaluation per attempt unless the
    tableau is FSAL.

    ``advance_lower`` defaults to the reference semantics (True) for RKF45
    and to False (advance the b solution) for tableaus with dense
    coefficients, where the interpolant requires it.
    """
    from .driver import make_grid
    from .rk import rk_step_stages
    from .tableaus import RKF45

    if tableau is None:
        tableau = RKF45
    if advance_lower is None:
        advance_lower = tableau.p_dense is None
    if time_dtype is None:
        time_dtype = jnp.result_type(jnp.asarray(t0), jnp.asarray(tf), float)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype)
    if h0 is None:
        h0 = ctl.init_h()

    use_p = tableau.p_dense is not None and not advance_lower
    use_fsal = tableau.is_fsal and not advance_lower
    interp_kind = "p_dense" if use_p else "hermite"

    if use_fsal:
        def step_fn_dense(t, x, dt, k0):
            x_next, err, K, _ = rk_step_stages(
                f, t, x, dt, tableau, advance_lower=False, k0=k0,
            )
            idata = tuple(K) if use_p else (K[0], K[-1])
            return x_next, err, idata, K[-1]

        init_carry_fn = lambda t, x: f(t, x)
    else:
        def step_fn_dense(t, x, dt):
            x_next, err, K, _ = rk_step_stages(
                f, t, x, dt, tableau, advance_lower=advance_lower,
            )
            if use_p:
                idata = tuple(K)
            else:
                # this branch only runs when use_fsal is False, so the
                # right-endpoint slope is a genuine extra eval (K[-1]
                # would be the slope at x_b, wrong under advance_lower)
                idata = (K[0], f(t + dt, x_next))
            return x_next, err, idata

        init_carry_fn = None

    return integrate_interp(
        step_fn_dense, y0, t_grid, h0,
        adaptive=adaptive, ctl=ctl, error_norm=error_norm,
        interp_kind=interp_kind, tab=tableau, method=method,
        batch_shape=batch_shape, init_carry_fn=init_carry_fn,
    )


def solve_linear_dense(
    op_fn: Callable,
    t0,
    tf,
    y0: Pytree,
    *,
    stepper,
    h0=None,
    adaptive: bool = False,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype=None,
    method: str = "while",
) -> Solution:
    """solve_linear with interpolated saves: the Hermite endpoint slopes are
    the operator action dx/dt = A(t) x via the split's ``apply_l``.

    ``stepper`` is an exp stepper carrying its split (ExpMidpoint / Magnus4 /
    CFM...) or a split-pair solver (SplitMidpoint, whose op_fn yields
    (La, Lb))."""
    from .driver import make_grid

    if time_dtype is None:
        time_dtype = jnp.result_type(jnp.asarray(t0), jnp.asarray(tf), float)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype)
    if h0 is None:
        h0 = ctl.init_h()

    # split-PAIR solvers first: they also expose a `.split` property
    # (= sp_a, the batched-execution convention), but their op_fn yields an
    # (La, Lb) tuple that must go through the pair slope
    if hasattr(stepper, "sp_a"):
        from .exp.splits import _Pair

        pair = _Pair(stepper.sp_a, stepper.sp_b)

        def slope(t, x):
            return pair.apply_l(op_fn(t), x)
    elif hasattr(stepper, "split") and stepper.split is not None:
        split = stepper.split

        def slope(t, x):
            return split.apply_l(op_fn(t), x)
    elif hasattr(stepper, "op") and stepper.op is not None:
        op = stepper.op

        def slope(t, x):
            A = op.assemble(t)
            from .ops.cplx import Cplx, cmatvec

            if isinstance(A, Cplx):
                return cmatvec(A, x)
            from .utils.prec import HIGHEST

            return jnp.einsum("...ij,...j->...i", A, x, precision=HIGHEST)
    else:
        raise ValueError(
            "stepper must carry its split(s) for dense output slopes"
        )

    inner = stepper.make_step_fn(op_fn)

    def step_fn_dense(t, x, dt):
        x_next, err = inner(t, x, dt)
        return x_next, err, (slope(t, x), slope(t + dt, x_next))

    return integrate_interp(
        step_fn_dense, y0, t_grid, h0,
        adaptive=adaptive, ctl=ctl, error_norm=error_norm,
        interp_kind="hermite", tab=None, method=method,
    )
