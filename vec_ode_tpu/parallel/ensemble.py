"""Ensemble propagation: many independent trajectories, batched and sharded.

The reference is a single-trajectory, single-thread integrator; its only
scaling axis is running many independent trajectories externally (SURVEY.md
§5 "long-context/sequence parallelism" entry). Here that becomes a
first-class execution model:

  * ``ensemble_solve`` — ``vmap`` of the full while_loop driver: each
    trajectory carries its own (t, h, save-cursor, status); the batched loop
    body is masked per-trajectory and runs until all trajectories in the
    shard finish (SURVEY §7 hard-part #1).
  * with a ``jax.sharding.Mesh``, the batch axis is sharded over devices via
    ``shard_map``. Trajectories are embarrassingly parallel, so the mapped
    body contains NO collectives — each device runs its own while_loop and
    finishes independently (no cross-device straggler sync until the final
    gather of results).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import lc
from ..controller import StepControl
from ..driver import Solution, integrate, make_grid
from ..rk import RungeKutta

Pytree = Any


from ..controller import check_h0 as _check_h0  # noqa: E402 (shared
# with_init_step validation, ode.rs:287-296 — see controller.check_h0)


def ensemble_solve(
    rhs_or_op: Callable,
    y0_batch: Pytree,
    t0,
    tf,
    *,
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype=None,
    mesh: Optional[Mesh] = None,
    axis_name: str = "traj",
    method: str = "while",
    params: Optional[Pytree] = None,
    events=None,
    dense: bool = False,
) -> Solution:
    """Integrate a batch of independent trajectories (leading axis of every
    leaf of ``y0_batch``).

    ``rhs_or_op`` is the per-trajectory RHS ``f(t, y)`` (RK steppers) or
    operator assembly ``op_fn(t)`` (exp steppers) — unbatched; the ensemble
    dimension comes from ``vmap``. With ``mesh``, the batch axis must divide
    the mesh size and is sharded across devices (ICI) via ``shard_map``.

    ``params``: optional pytree with the same leading batch axis, mapped
    alongside the state — the signature becomes ``f(t, y, p)`` /
    ``op_fn(t, p)``, so ensembles can sweep model parameters (e.g. one
    Landau-Zener rate per trajectory), not just initial conditions.
    Unsupported for natively-batched steppers (they embed their own RHS).

    ``h0`` may be a (B,)-shaped array for per-trajectory warm starts (e.g.
    the ``h_final`` of a previous chained solve).

    ``dense=True`` switches the save semantics from grid-HITTING to
    dense.py's free-running interpolation: interior ``save_at`` times never
    perturb the controller's step sequence; each is filled by the cubic
    Hermite of the step that crossed it (dense.integrate_interp; endpoint
    slopes from the stepper's ``hermite_slope`` method or its
    ModulatedOperator; ``Solution.path`` gains a ``-dense`` suffix).
    Supported across the batched families (modulated exp steppers AND
    ops/modulated_rk.FusedModulatedLinearRK) and the vmapped tier
    (RungeKutta stage-slope/Hermite, exp-split Hermite). ``dense`` and
    ``events`` are exclusive (the dense driver carries no event state).
    """
    from ..events import as_event_config

    if stepper is None:
        stepper = RungeKutta()
    if time_dtype is None:
        time_dtype = jnp.result_type(jnp.asarray(t0), jnp.asarray(tf), float)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype)
    h0 = _check_h0(h0, ctl, adaptive)
    event_cfg = as_event_config(events)
    use_batched = bool(getattr(stepper, "is_batched", False))
    if use_batched:
        import dataclasses as _dc

        stepper_norm = getattr(stepper, "error_norm", None)
        custom_norm = error_norm is not lc.norm_l2
        if custom_norm and isinstance(error_norm, lc.WeightedNorm):
            if ctl.scaled_error:
                raise ValueError(
                    "scaled_error and a WeightedNorm are mutually "
                    "exclusive (both redefine the error measure)"
                )
            declares_norm = _dc.is_dataclass(stepper) and any(
                f.name == "norm" for f in _dc.fields(stepper)
            )
            if stepper_norm is not None and declares_norm:
                # norm-returning stepper with native WeightedNorm support:
                # install the declaration — its step executes it
                # (reference NormFn, cfm.rs:131-155)
                existing = getattr(stepper, "norm", None)
                if existing is None:
                    stepper = _dc.replace(stepper, norm=error_norm)
                else:
                    try:
                        same = bool(existing == error_norm)
                    except Exception:
                        # pytree array weights defeat dataclass __eq__
                        same = existing is error_norm
                    if not same:
                        raise ValueError(
                            "stepper already declares a different norm= "
                            "than the error_norm= passed to ensemble_solve"
                        )
                custom_norm = False  # handled natively
            elif stepper_norm is None:
                # vector-returning batched stepper: reduce per trajectory
                # with the declared norm's batched form (below)
                custom_norm = False
                error_norm = error_norm.batched
        elif custom_norm and not ctl.scaled_error:
            # TRACE, don't declare: an opaque error_norm=
            # callable that jax.eval_shape-traces to a scalar on a
            # per-trajectory state abstract keeps the BATCHED tier — as a
            # TracedNorm in the stepper's norm slot (norm-returning
            # steppers apply it to the batched error vector on the XLA
            # executor) or vmapped into the
            # driver's reducer (vector-returning steppers). Genuinely
            # untraceable callables keep the drop-to-vmapped/raise paths
            # below. Reference contract: NormFn closure, cfm.rs:131-155.
            probe = jax.tree_util.tree_map(
                lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                y0_batch,
            )
            traced = lc.try_trace_norm(error_norm, probe)
            if traced is not None:
                declares_norm = _dc.is_dataclass(stepper) and any(
                    f.name == "norm" for f in _dc.fields(stepper)
                )
                if (stepper_norm is not None and declares_norm
                        and getattr(stepper, "norm", None) is None):
                    stepper = _dc.replace(stepper, norm=traced)
                    custom_norm = False
                elif stepper_norm is None:
                    error_norm = traced.batched
                    custom_norm = False
        norm_conflict = stepper_norm is not None and custom_norm
        scaled_conflict = ctl.scaled_error and stepper_norm is not None
        if (norm_conflict or scaled_conflict) and getattr(
            stepper, "auto_batched", False
        ):
            # AUTO-batched dense steppers quietly keep the vmapped path
            # for calls its batched conventions cannot express (opaque
            # error_norm callables; scaled_error needs the error VECTOR):
            # those calls were valid before batching existed and stay valid
            use_batched = False
        elif norm_conflict:
            raise ValueError(
                "this stepper computes its own per-trajectory error "
                "norms; an OPAQUE error_norm callable cannot be applied "
                "(declare an lc.WeightedNorm for native execution, or use "
                "batched=False dense-split steppers for the vmapped path)"
            )
        elif scaled_conflict:
            # error_measure rescales the error VECTOR; this stepper
            # returns per-trajectory norms
            raise ValueError(
                "scaled_error needs the error vector, but this stepper "
                "returns per-trajectory norms (dense-split exp steppers "
                "accept batched=False for the vmapped path)"
            )

    if params is None:
        step_fn = stepper.make_step_fn(rhs_or_op)
    else:
        if use_batched:
            if not getattr(stepper, "supports_batched_params", False):
                raise ValueError(
                    "params is unsupported for natively-batched steppers "
                    "(this stepper embeds its own RHS); for the generic "
                    "exp steppers pass batched=False to use the vmapped "
                    "path instead"
                )
            # batched dense steppers: op_fn(t, p) vmapped over (t, params);
            # the step_fn binds the LOCAL params shard inside the mapped
            # body (below), so shard_map slices it correctly
            step_fn = None
        else:
            step_fn = None  # built per-trajectory below

    h_batched = hasattr(h0, "ndim") and jnp.ndim(h0) == 1

    if use_batched:
        # natively-batched stepper (e.g. the fused RK step): one
        # driver loop over the whole (local) batch, no vmap. error_norm at
        # this point is already per-trajectory-reducing (a WeightedNorm's
        # .batched form) when a declared norm reached a vector-returning
        # stepper above.
        enorm = stepper_norm or (
            error_norm if error_norm is not lc.norm_l2
            else lc.norm_l2_batched
        )

        def batched(y0, p, h):
            import dataclasses as dc

            fn = (
                step_fn if p is None
                else stepper.make_step_fn(rhs_or_op, params=p)
            )
            b = jax.tree_util.tree_leaves(y0)[0].shape[0]
            init_cf = (
                # batched steppers with a carry (e.g. the compensated
                # tier's lo word) seed it over the whole batch — their
                # make_init_carry is shape-polymorphic (zeros_like)
                stepper.make_init_carry(rhs_or_op)
                if getattr(stepper, "has_carry", False) else None
            )
            if dense:
                if event_cfg is not None:
                    raise ValueError(
                        "dense=True with events= is unsupported (the dense "
                        "driver carries no event state)"
                    )
                return _batched_dense_fallback(
                    stepper, fn, y0, t_grid, h, adaptive=adaptive, ctl=ctl,
                    error_norm=enorm, method=method, batch_shape=(b,),
                    init_carry_fn=init_cf,
                )
            else:
                sol = integrate(
                    fn, y0, t_grid, h,
                    adaptive=adaptive, ctl=ctl,
                    error_norm=enorm, method=method,
                    batch_shape=(b,),
                    pack_carry=getattr(stepper, "prefers_packed_carry",
                                       False),
                    init_carry_fn=init_cf,
                    event_cfg=event_cfg,
                )
            # match the vmap path's output batching (uniform out_specs under
            # shard_map): broadcast the shared save grid per trajectory
            return dc.replace(
                sol, ts=jnp.broadcast_to(sol.ts, (b,) + sol.ts.shape)
            )
    elif dense:
        # vmapped dense tier: per-trajectory free-running interpolation via
        # the dense.py solvers (RK: stage-slope / Hermite; exp: operator-
        # slope Hermite), mapped over the batch like the hit driver below
        if event_cfg is not None:
            raise ValueError(
                "dense=True with events= is unsupported (the dense "
                "driver carries no event state)"
            )
        from ..dense import solve_ivp_dense, solve_linear_dense

        def single(y0, p, h):
            if getattr(stepper, "takes_state", False):
                if not isinstance(stepper, RungeKutta):
                    raise ValueError(
                        "dense=True supports RungeKutta and exp steppers "
                        "on the vmapped tier"
                    )
                if stepper.compensated:
                    raise ValueError(
                        "dense=True has no compensated-RK variant (the "
                        "dense driver carries no lo word); use "
                        "compensated=False"
                    )
                f = (rhs_or_op if p is None
                     else (lambda t, y: rhs_or_op(t, y, p)))
                return solve_ivp_dense(
                    f, t0, tf, y0, tableau=stepper.tableau, h0=h,
                    adaptive=adaptive, ctl=ctl, save_at=save_at,
                    error_norm=error_norm, time_dtype=time_dtype,
                    advance_lower=stepper.advance_lower, method=method,
                )
            op_fn = rhs_or_op if p is None else (lambda t: rhs_or_op(t, p))
            return solve_linear_dense(
                op_fn, t0, tf, y0, stepper=stepper, h0=h,
                adaptive=adaptive, ctl=ctl, save_at=save_at,
                error_norm=error_norm, time_dtype=time_dtype,
                method=method,
            )

        in_axes = (0, 0 if params is not None else None,
                   0 if h_batched else None)
        batched = jax.vmap(single, in_axes=in_axes)
    else:
        def single(y0, p, h):
            if params is None:
                fn = step_fn
            else:
                import inspect

                takes_state = getattr(stepper, "takes_state", False)
                want = 3 if takes_state else 2
                try:
                    n_args = len(inspect.signature(rhs_or_op).parameters)
                except (TypeError, ValueError):
                    n_args = want
                if n_args != want:
                    sig = "(t, y, p)" if takes_state else "(t, p)"
                    raise ValueError(
                        f"with params, this stepper expects rhs_or_op{sig}; "
                        f"got a {n_args}-parameter callable"
                    )
                if takes_state:       # f(t, y, p) — RK steppers
                    fn = stepper.make_step_fn(
                        lambda t, y: rhs_or_op(t, y, p)
                    )
                else:                 # op_fn(t, p) — exp steppers
                    fn = stepper.make_step_fn(lambda t: rhs_or_op(t, p))
            return integrate(
                fn, y0, t_grid, h,
                adaptive=adaptive, ctl=ctl,
                error_norm=error_norm, method=method,
                pack_carry=getattr(stepper, "prefers_packed_carry", False),
                event_cfg=event_cfg,
                init_carry_fn=(
                    stepper.make_init_carry(
                        rhs_or_op if params is None
                        else (lambda t, y: rhs_or_op(t, y, p))
                    )
                    if getattr(stepper, "has_carry", False) else None
                ),
            )

        in_axes = (0, 0 if params is not None else None,
                   0 if h_batched else None)
        batched = jax.vmap(single, in_axes=in_axes)

    # uniform (y0, params, h0) argument layout for both paths so h0 warm
    # starts shard correctly through shard_map
    args = (y0_batch, params, h0)
    if mesh is not None:
        ax = mesh.axis_names[0]
        in_specs = (
            P(ax),
            P(ax) if params is not None else P(),
            P(ax) if h_batched else P(),
        )

    if mesh is None:
        return batched(*args)

    n_shards = mesh.devices.size
    lead = jax.tree_util.tree_leaves(y0_batch)[0].shape[0]
    if lead % n_shards != 0:
        raise ValueError(
            f"ensemble size {lead} must divide the mesh size {n_shards}"
        )
    mesh_axis = mesh.axis_names[0]
    sharded = jax.shard_map(
        batched,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(mesh_axis),
        check_vma=False,
    )
    return sharded(*args)


def _batched_dense_fallback(stepper, fn, y0, t_grid, h, *, adaptive, ctl,
                            error_norm, method, batch_shape, init_carry_fn):
    """XLA dense tier for natively-batched steppers: free-running
    integrate_interp with cubic-Hermite saves whose endpoint slopes are the
    operator action A(t)x of the stepper's ModulatedOperator (the same
    slope dense.solve_linear_dense computes from a split)."""
    import dataclasses as dc

    from ..dense import integrate_interp
    from ..utils.prec import HIGHEST

    slope = getattr(stepper, "hermite_slope", None)
    if slope is None:
        op = getattr(stepper, "op", None)
        if op is None or not hasattr(op, "coeff_fn"):
            raise ValueError(
                "dense=True on a natively-batched stepper needs its "
                "ModulatedOperator (or a hermite_slope method) for the "
                "Hermite endpoint slopes; for generic exp steppers pass "
                "batched=False (the vmapped dense driver computes slopes "
                "from the split)"
            )
        from ..exp.modulated import _real_basis, _unwiden, _widen

        basis_w = _real_basis(op.basis)
        is_cplx = op.is_cplx

        def slope(t, x):
            xw = _widen(x, is_cplx)
            c = jnp.asarray(op.coeff_fn(t))             # (B, K)
            fw = jnp.einsum("bk,kij,bj->bi", c, basis_w, xw,
                            precision=HIGHEST)
            return _unwiden(fw, is_cplx)

    has_carry = getattr(stepper, "has_carry", False)
    if has_carry:
        def sfd(t, x, dt, carry):
            xn, err, c2 = fn(t, x, dt, carry)
            return xn, err, (slope(t, x), slope(t + dt, xn)), c2
    else:
        def sfd(t, x, dt):
            xn, err = fn(t, x, dt)
            return xn, err, (slope(t, x), slope(t + dt, xn))

    sol = integrate_interp(
        sfd, y0, t_grid, h, adaptive=adaptive, ctl=ctl,
        error_norm=error_norm, interp_kind="hermite", tab=None,
        method=method, batch_shape=batch_shape,
        init_carry_fn=init_carry_fn,
    )
    sol = dc.replace(sol, path="xla-driver-dense")
    if sol.ts.ndim == 1:   # uniform (B, n_grid) save grid like the hit path
        sol = dc.replace(
            sol, ts=jnp.broadcast_to(sol.ts, batch_shape + sol.ts.shape))
    return sol


def ensemble_mesh(n_devices: Optional[int] = None, axis: str = "traj") -> Mesh:
    """1-D device mesh over all (or the first n) local devices for
    trajectory sharding."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), (axis,))


def shard_batch(y0_batch: Pytree, mesh: Mesh) -> Pytree:
    """Place a host batch with its leading axis sharded over the mesh, so the
    subsequent ensemble_solve runs without a gather."""
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sharding), y0_batch
    )

def step_efficiency(sol: Solution, n_shards: int = 1,
                    per_shard: bool = False):
    """Straggler accounting for a batched/ensemble Solution.

    The batched while_loop runs every lane until the slowest trajectory in
    its shard finishes, so executed lane-iterations = max(n_iters) * B per
    shard while useful ones = sum(n_iters). Returns useful/executed in
    [0, 1] (1.0 = no straggler waste). ``n_shards`` splits the leading batch
    axis the way the mesh did (each device runs its own loop);
    ``per_shard=True`` returns the (n_shards,) per-device efficiencies
    instead of the aggregate (the sharded path's accounting)."""
    ni = jnp.asarray(sol.n_iters)
    ni = ni.reshape(n_shards, -1)
    per = jnp.sum(ni, axis=1) / (jnp.max(ni, axis=1) * ni.shape[1])
    if per_shard:
        return per
    executed = jnp.sum(jnp.max(ni, axis=1) * ni.shape[1])
    return jnp.sum(ni) / executed


def cost_sorted_permutation(cost_hint) -> "np.ndarray":
    """Mesh-composable straggler mitigation by PLACEMENT: a permutation
    that sorts trajectories by expected cost so contiguous shards (the way
    shard_batch splits the batch) hold homogeneous work.

    Each device runs its own independent while_loop (no cross-device
    sync), so per-shard waste is (max - mean) iterations within the shard;
    sorting by any monotone cost proxy — a sweep rate, a stiffness
    estimate, ``h_final`` of a previous chained solve, or ``n_iters`` of a
    warmup run — collapses that spread. Host-side compaction
    (:func:`ensemble_solve_compact`) is single-host by design; placement
    is the mitigation that composes with a mesh.

    Apply with ``jax.tree_util.tree_map(lambda a: a[perm], y0_batch)``
    (and to params/h0 alike); un-permute outputs with
    ``inverse_permutation(perm)``."""
    import numpy as np

    return np.argsort(np.asarray(cost_hint), kind="stable")


def inverse_permutation(perm) -> "np.ndarray":
    import numpy as np

    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _run_chunk(state, step_fn, *, adaptive, ctl, error_norm, chunk):
    """Advance a batched carry by at most ``chunk`` driver iterations."""
    from functools import partial as _partial

    from ..driver import RUNNING as _RUNNING
    from ..driver import step_once

    body = _partial(
        step_once, step_fn=step_fn, adaptive=adaptive, ctl=ctl,
        error_norm=error_norm, batched=True,
    )

    def cond(c):
        k, s = c
        return (k < chunk) & jnp.any(s.status == _RUNNING)

    def bd(c):
        k, s = c
        return k + 1, body(s)

    _, out = jax.lax.while_loop(cond, bd, (jnp.zeros((), jnp.int32), state))
    return out


def ensemble_solve_compact(
    rhs_or_op: Callable,
    y0_batch: Pytree,
    t0,
    tf,
    *,
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype=None,
    chunk_iters: int = 64,
    min_batch: int = 8,
    bucket_multiple: Optional[int] = None,
):
    """Straggler-mitigated ensemble integration: host-driven chunks with
    re-batching of unfinished lanes.

    The plain batched loop wastes (1 - step_efficiency) of its lane
    iterations stepping already-DONE trajectories until the slowest one
    finishes. This variant runs ``chunk_iters``-bounded chunks and, between
    chunks, COMPACTS the batch to the still-running lanes (padded up to a
    multiple of ``bucket_multiple``, never below ``min_batch``, to bound
    recompilation), so fast trajectories stop consuming device work as
    soon as their bucket drains.

    Compacted sizes are rounded up to a multiple of ``bucket_multiple``
    (default max(min_batch, B//16)) — finer granularity compacts earlier
    (higher efficiency) at the cost of more distinct batch shapes to
    compile (at most ~B/bucket_multiple).

    Host-driven (not jittable, no mesh); returns
    ``(Solution, {"executed_lane_iters", "useful_lane_iters",
    "efficiency"})`` where efficiency = useful/executed — the counter the
    plain path exposes post-hoc via :func:`step_efficiency`.
    """
    import numpy as np

    from ..driver import RUNNING as _RUNNING
    from ..driver import init_state, make_grid

    if stepper is None:
        stepper = RungeKutta()
    has_carry = getattr(stepper, "has_carry", False)
    use_batched = bool(getattr(stepper, "is_batched", False))
    if use_batched:
        stepper_norm = getattr(stepper, "error_norm", None)
        if stepper_norm is not None and error_norm is not lc.norm_l2:
            if getattr(stepper, "auto_batched", False):
                use_batched = False   # vmapped path (see ensemble_solve)
            else:
                raise ValueError(
                    "this stepper computes its own per-trajectory error "
                    "norms; a custom error_norm cannot be applied"
                )
    if use_batched:
        step_fn = stepper.make_step_fn(rhs_or_op)
        enorm = stepper_norm or lc.norm_l2_batched
    else:
        # vmap the per-trajectory stepper into a batched step_fn; the
        # PER-TRAJECTORY norm is vmapped too (same as ensemble_solve —
        # an unbatched norm would couple every lane through one scalar
        # controller decision)
        base = stepper.make_step_fn(rhs_or_op)
        step_fn = jax.vmap(
            base, in_axes=(0, 0, 0, 0) if has_carry else (0, 0, 0)
        )
        enorm = jax.vmap(error_norm)
    if time_dtype is None:
        time_dtype = jnp.result_type(jnp.asarray(t0), jnp.asarray(tf), float)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype)
    h0 = _check_h0(h0, ctl, adaptive)

    B = jax.tree_util.tree_leaves(y0_batch)[0].shape[0]
    carry0 = ()
    if has_carry:
        # seed the stepper carry (e.g. the FSAL slope) per trajectory
        carry0 = jax.vmap(
            stepper.make_init_carry(rhs_or_op), in_axes=(None, 0)
        )(t_grid[0], y0_batch)
    state = init_state(y0_batch, t_grid, h0, batch_shape=(B,),
                       stepper_carry=carry0)
    ts_grid = state.ts_grid

    run = jax.jit(
        lambda s: _run_chunk(
            s, step_fn, adaptive=adaptive, ctl=ctl, error_norm=enorm,
            chunk=chunk_iters,
        )
    )

    # host-side result assembly (original lane order)
    done_states: dict = {}
    active = np.arange(B)
    executed = 0

    m = bucket_multiple or max(min_batch, B // 16, 1)

    def bucket(n):
        return max(min_batch, -(-n // m) * m, 1)

    while True:
        n_act = len(active)
        iters_before = np.asarray(state.n_iters)[:n_act]
        state = run(state)
        # pad lanes (frozen DONE copies beyond n_act) are excluded from all
        # host-side bookkeeping
        status = np.asarray(state.status)[:n_act]
        executed += int(
            np.max(np.asarray(state.n_iters)[:n_act] - iters_before) * n_act
        )
        running = status == _RUNNING
        if not running.any():
            for j, lane in enumerate(active):
                done_states[int(lane)] = jax.tree_util.tree_map(
                    lambda a, j=j: np.asarray(a)[j],
                    state._replace(ts_grid=()),
                )
            break
        n_run = int(running.sum())
        new_b = bucket(n_run)
        if new_b >= n_act:
            continue
        # bank finished lanes, compact to the running ones
        for j in np.nonzero(~running)[0]:
            done_states[int(active[j])] = jax.tree_util.tree_map(
                lambda a, j=j: np.asarray(a)[j], state._replace(ts_grid=()),
            )
        keep = np.nonzero(running)[0]
        pad = np.concatenate([keep, np.repeat(keep[:1], new_b - n_run)])
        stripped = state._replace(ts_grid=())
        state = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)[pad]), stripped
        )._replace(ts_grid=ts_grid)
        if new_b > n_run:
            # padding lanes: freeze them (DONE) so they cost nothing real
            st = np.array(np.asarray(state.status), copy=True)
            st[n_run:] = 1  # DONE
            state = state._replace(status=jnp.asarray(st))
        active = active[keep]

    import dataclasses as dc

    def gather(field):
        return jnp.asarray(
            np.stack([getattr(done_states[i], field) for i in range(B)])
        )

    ys = jax.tree_util.tree_map(
        lambda *leaves: jnp.asarray(np.stack(leaves)),
        *[done_states[i].ys for i in range(B)],
    )
    x = jax.tree_util.tree_map(
        lambda *leaves: jnp.asarray(np.stack(leaves)),
        *[done_states[i].x for i in range(B)],
    )
    sol = Solution(
        ts=jnp.broadcast_to(ts_grid, (B,) + ts_grid.shape),
        ys=ys,
        t_final=gather("t"),
        y_final=x,
        status=gather("status"),
        n_accept=gather("n_accept"),
        n_reject=gather("n_reject"),
        n_iters=gather("n_iters"),
        h_final=gather("h"),
    )
    useful = int(np.asarray(sol.n_iters).sum())
    stats = {
        "executed_lane_iters": executed,
        "useful_lane_iters": useful,
        "efficiency": useful / max(executed, 1),
    }
    return sol, stats
