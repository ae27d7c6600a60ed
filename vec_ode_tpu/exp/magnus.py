"""Exponential midpoint (Magnus-2) and adaptive Magnus-4 steppers.

JAX counterpart of ``/root/reference/src/exp/magnus.rs``. Both solve
the linear system dx/dt = A(t) x where the user supplies an operator-assembly
function ``op_fn(t) -> L`` (scalar time in, operator pytree out); solvers that
need several time samples ``vmap`` it over the quadrature nodes, turning the
reference's Vec-of-operators callback (magnus.rs:32) into one batched
assembly.

Reference-bug fix (SURVEY.md §2.3(6)): the reference's adaptive Magnus-4 norms
a stale buffer (``adaptive_dat.dx`` initialized to x0 and never updated,
magnus.rs:180-184 vs 274-276) so its step control is keyed off a constant. We
return the actual error vector xe = e^{Ω1} x0 - e^{Ω} x0 (magnus.rs:76-79) to
the driver, which norms it — the *intended* behavior.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .protocol import ExponentialSplit

# Gauss-Legendre 2-node half-offset: 1/(2 sqrt(3)) (magnus.rs:42).
_C_MID = 0.5 / math.sqrt(3.0)
# Magnus-4 commutator weight: -sqrt(3)/12 (magnus.rs:44-45).
_B2 = -math.sqrt(3.0) / 12.0
# Yoshida triple-jump exponents: composing the SYMMETRIC Magnus-4 step
# over [g1, 1-2g1, g1]*dt with g1 = 1/(2 - 2^{1/5}) raises the order to 6
# (no such scheme exists in the reference — beyond-parity capability).
_G1 = 1.0 / (2.0 - 2.0 ** 0.2)
_SUB_OFF = (0.0, _G1, 1.0 - _G1)
_SUB_LEN = (_G1, 1.0 - 2.0 * _G1, _G1)


def midpoint_step(op_fn, split: ExponentialSplit, t, x, dt):
    """xf = exp(dt * A(t + dt/2)) x — magnus.rs:10-26."""
    l_mid = op_fn(t + 0.5 * dt)
    u = split.exp(split.scale_l(l_mid, dt))
    return split.map_exp(u, x), None


def midpoint_step_comp(op_fn, split: ExponentialSplit, t, x, dt, lo):
    """Compensated (double-f32) exponential midpoint: increment form
    D = (e^{dt A} - I) x via exp_m1, TwoSum state update (comp.py)."""
    from .. import comp

    l_mid = op_fn(t + 0.5 * dt)
    phi = split.exp_m1(split.scale_l(l_mid, dt))
    D = split.map_exp(phi, x)
    hi, lo2 = comp.update(x, lo, D)
    return hi, None, lo2


def _m4_omega(op_fn, split: ExponentialSplit, t, dt):
    """The Magnus-4 exponent Ω over [t, t+dt] (GL2 nodes) — magnus.rs:46-61.
    Returns (Ω, w1, w2) with Ω = w1 + w2 (order-2 part + commutator term)."""
    t_mid = t + 0.5 * dt
    t_nodes = jax.numpy.stack(
        [t_mid - _C_MID * dt, t_mid + _C_MID * dt]
    )
    l_nodes = jax.vmap(op_fn)(t_nodes)
    l1 = jax.tree_util.tree_map(lambda a: a[0], l_nodes)
    l2 = jax.tree_util.tree_map(lambda a: a[1], l_nodes)
    w2 = split.scale_l(split.commutator(l1, l2), _B2 * dt * dt)
    w1 = split.scale_l(split.add_l(l1, l2), 0.5 * dt)
    return split.add_l(w1, w2), w1, w2


def magnus6_step(op_fn, split: ExponentialSplit, t, x, dt, *,
                 adaptive: bool = True):
    """6th-order step: Yoshida triple-jump of the symmetric Magnus-4 step.

    xf = e^{Ω(t+ (1-g1)dt, g1 dt)} e^{Ω(t+g1 dt, (1-2g1)dt)} e^{Ω(t, g1 dt)} x
    err = e^{Ω(t, dt)} x - xf   (the plain order-4 step as the embedded
    lower-order comparison — the same samples economy as CFM: all 3 (+1)
    exponentials stack into ONE batched expm via exp_many).
    """
    from .. import lc
    from .protocol import index_u

    omegas = [
        _m4_omega(op_fn, split, t + o * dt, g * dt)[0]
        for o, g in zip(_SUB_OFF, _SUB_LEN)
    ]
    if adaptive:
        omegas.append(_m4_omega(op_fn, split, t, dt)[0])
    us = split.exp_many(omegas)
    xf = x
    for i in range(3):
        xf = split.map_exp(index_u(us, i), xf)
    if not adaptive:
        return xf, None
    err = lc.sub(split.map_exp(index_u(us, 3), x), xf)
    return xf, err


def _midpoint_batched_step(assemble, split, t, x, dt, *,
                           max_squarings=16, lo=None):
    """Batched exponential midpoint on per-trajectory dense operators
    (stacked batched expm, exp/dense_fast.py). ``assemble(t_vec)`` ->
    per-trajectory operators."""
    from . import dense_fast as df

    A = assemble(t + 0.5 * dt)
    E = df.embed_node(split, A)

    def xla_chains():
        return [[dt[..., None, None].astype(E.dtype) * E]]

    return df.run_batched_chains(
        split, x, dt, xla_chains,
        adaptive=False, max_squarings=max_squarings, lo=lo,
    )


def _magnus4_batched_step(assemble, split, t, x, dt, *, adaptive,
                          max_squarings=16, fast_error=False, wnorm=None,
                          lo=None):
    """Batched Magnus-4 on per-trajectory dense operators: the batched
    commutator + ONE stacked batched expm of the order-4/2 exponent pair
    (exp/dense_fast.py). ``fast_error`` replaces the comparison propagator
    with the w2·xf estimate (see magnus4_step) — the expm stack halves."""
    from ..utils.prec import HIGHEST
    from . import dense_fast as df

    t_mid = t + 0.5 * dt
    # ONE stacked assemble + embed for both quadrature nodes (halves the
    # sampling launches; the callback itself stays per-scalar-time,
    # reference semantics magnus.rs:32)
    B = jnp.shape(t)[0] if jnp.ndim(t) else None
    t12 = jnp.concatenate([t_mid - _C_MID * dt, t_mid + _C_MID * dt])
    A12 = assemble(t12)
    E12 = df.embed_node(split, A12)
    E1, E2 = E12[:B], E12[B:]

    def _comm(scale):
        # both commutator products in ONE batched GEMM
        from ..utils.prec import mm

        P = mm(jnp.concatenate([E1, E2]), jnp.concatenate([E2, E1]))
        return scale * (P[:B] - P[B:])

    if adaptive and fast_error:
        dt3 = dt[..., None, None].astype(E12.dtype)
        w2 = _comm(_B2 * dt3 * dt3)
        omega = 0.5 * dt3 * (E1 + E2) + w2

        out = df.run_batched_chains(
            split, x, dt, lambda: [[omega]],
            adaptive=False, max_squarings=max_squarings, lo=lo,
        )
        y = out[0]
        yw = df.widen(df.split_parts(split, y))
        dv = jnp.einsum("...ij,...j->...i", w2.astype(yw.dtype), yw,
                        precision=HIGHEST)
        from ..lc import apply_weighted_norm

        e = apply_weighted_norm(dv, wnorm)
        if lo is not None:
            return y, e, out[2]
        return y, e

    def xla_chains():
        dt3 = dt[..., None, None].astype(E12.dtype)
        w1 = 0.5 * dt3 * (E1 + E2)
        omega = w1 + _comm(_B2 * dt3 * dt3)
        return [[omega], [w1]] if adaptive else [[omega]]

    return df.run_batched_chains(
        split, x, dt, xla_chains,
        adaptive=adaptive, max_squarings=max_squarings, wnorm=wnorm, lo=lo,
    )


def _magnus6_batched_step(assemble, split, t, x, dt, *, adaptive,
                          max_squarings=16, wnorm=None, lo=None):
    """Batched Magnus-6 (Yoshida triple-jump of the symmetric Magnus-4
    step) on per-trajectory dense operators: 3 sub-interval Magnus-4
    exponents (+ the embedded full-interval comparison) built from 6 (8)
    node samples; default executor = one stacked batched expm of all
    exponents (see exp/dense_fast.py)."""
    from . import dense_fast as df

    n_sub = len(_SUB_OFF)
    # node samples: GL2 pair per sub-interval (+ full-interval pair),
    # ALL sampled in one stacked assemble + embed (one launch)
    spans = [(o, ln) for o, ln in zip(_SUB_OFF, _SUB_LEN)]
    if adaptive:
        spans.append((0.0, 1.0))
    B = jnp.shape(t)[0] if jnp.ndim(t) else None
    ts = []
    for o, ln in spans:
        tm = t + (o + 0.5 * ln) * dt
        ts += [tm - _C_MID * ln * dt, tm + _C_MID * ln * dt]
    E_all = df.embed_node(split, assemble(jnp.concatenate(ts)))
    Es = [E_all[i * B:(i + 1) * B] for i in range(len(ts))]

    def xla_chains():
        from ..utils.prec import mm

        dt3 = dt[..., None, None].astype(Es[0].dtype)
        # every sub-interval commutator pair rides ONE batched GEMM
        n_pair = len(Es) // 2
        L = jnp.concatenate([Es[2 * i] for i in range(n_pair)]
                            + [Es[2 * i + 1] for i in range(n_pair)])
        R = jnp.concatenate([Es[2 * i + 1] for i in range(n_pair)]
                            + [Es[2 * i] for i in range(n_pair)])
        P = mm(L, R)
        nb = n_pair * B

        def m4_omega(i, dts):
            Ma, Mb = Es[2 * i], Es[2 * i + 1]
            w1 = 0.5 * dts * (Ma + Mb)
            comm = P[i * B:(i + 1) * B] - P[nb + i * B:nb + (i + 1) * B]
            return w1 + (_B2 * dts * dts) * comm

        main = [
            m4_omega(i, float(_SUB_LEN[i]) * dt3) for i in range(n_sub)
        ]
        if not adaptive:
            return [main]
        return [main, [m4_omega(3, dt3)]]

    return df.run_batched_chains(
        split, x, dt, xla_chains, wnorm=wnorm,
        adaptive=adaptive, max_squarings=max_squarings, lo=lo,
    )


def magnus4_step(op_fn, split: ExponentialSplit, t, x, dt, *,
                 adaptive: bool = True, fast_error: bool = False):
    """4th-order Magnus with 2-node GL quadrature — magnus.rs:28-83.

    Ω  = (A1 + A2) dt/2 - (sqrt(3)/12) dt^2 [A1, A2]
    xf = e^{Ω} x0 ;  err = e^{Ω1} x0 - xf with Ω1 the order-2 part.

    Economy: with ``adaptive`` the order-4 and order-2 exponentials are
    ONE stacked batched expm (``exp_many``) instead of two dispatches; with
    ``adaptive=False`` (the ``no_adaptive`` economy the reference's Magnus
    lacks — it always computes both, magnus.rs:63-79) the order-2
    propagator is skipped entirely: one expm per step, err=None.

    ``fast_error``: estimate the order-2-vs-4 gap as w2·xf (the leading
    term of (e^{Ω1} − e^{Ω}) x — w2 is already in hand from the exponent
    build) instead of propagating the comparison exponential: one expm per
    adaptive step, ~sqrt-of-expm-cost cheaper. Same order, different
    constant → accept/reject sequences deviate from the reference pair;
    opt-in (see Magnus4.fast_error).
    """
    from .protocol import index_u

    omega, w1, w2 = _m4_omega(op_fn, split, t, dt)

    if not adaptive:
        return split.map_exp(split.exp(omega), x), None
    if fast_error:
        xf = split.map_exp(split.exp(omega), x)
        return xf, split.apply_l(w2, xf)

    u_pair = split.exp_many([omega, w1])
    xf = split.map_exp(index_u(u_pair, 0), x)
    from .. import lc

    err = lc.sub(split.map_exp(index_u(u_pair, 1), x), xf)
    return xf, err


def magnus4_step_comp(op_fn, split: ExponentialSplit, t, x, dt, lo, *,
                      adaptive: bool = True, fast_error: bool = False):
    """Compensated Magnus-4 (see :func:`magnus4_step` / comp.py): the
    advance is the increment D = (e^Ω - I) x folded into the (x, lo) pair;
    the embedded estimate is the DIFFERENCE OF INCREMENTS
    (e^{Ω1} - I) x - D, whose f32 noise floor is eps*|D| instead of the
    plain pair's eps*|x|."""
    from .. import comp, lc
    from .protocol import index_u

    omega, w1, w2 = _m4_omega(op_fn, split, t, dt)
    if not adaptive or fast_error:
        D = split.map_exp(split.exp_m1(omega), x)
        hi, lo2 = comp.update(x, lo, D)
        err = split.apply_l(w2, hi) if (adaptive and fast_error) else None
        return hi, err, lo2
    phis = split.exp_many_m1([omega, w1])
    D = split.map_exp(index_u(phis, 0), x)
    err = lc.sub(split.map_exp(index_u(phis, 1), x), D)
    hi, lo2 = comp.update(x, lo, D)
    return hi, err, lo2


def magnus6_step_comp(op_fn, split: ExponentialSplit, t, x, dt, lo, *,
                      adaptive: bool = True):
    """Compensated Magnus-6 (see :func:`magnus6_step` / comp.py): the
    triple-jump chain runs in increment form (comp.chain_increment) and the
    embedded order-4 comparison becomes an increment difference — which is
    what lifts the estimator's f32 noise floor (~1e-7 absolute, the reason
    plain-f32 Magnus-6 rejects everything at rtol<=1e-7) down to
    eps*|dy|."""
    from .. import comp, lc
    from .protocol import index_u

    omegas = [
        _m4_omega(op_fn, split, t + o * dt, g * dt)[0]
        for o, g in zip(_SUB_OFF, _SUB_LEN)
    ]
    if adaptive:
        omegas.append(_m4_omega(op_fn, split, t, dt)[0])
    phis = split.exp_many_m1(omegas)
    D = comp.chain_increment(
        split.map_exp, [index_u(phis, i) for i in range(3)], x
    )
    err = None
    if adaptive:
        err = lc.sub(split.map_exp(index_u(phis, 3), x), D)
    hi, lo2 = comp.update(x, lo, D)
    return hi, err, lo2


class _DenseBatchedStepper:
    """Shared batched-execution surface for the generic exp steppers.

    When the split is a dense leaf (``supports_batched_dense``:
    DenseSplit / DenseCplxSplit), the stepper is natively batched
    (``is_batched``): the ensemble driver hands it batched (t, x, dt), all
    chain exponentials run as ONE stacked batched expm, and the step
    returns the per-trajectory error NORM (``error_norm`` = identity). Scalar solves
    (solve_linear) keep the reference-shaped pytree path unchanged. Set
    ``batched=False`` to force the vmapped scalar path (required for
    ensemble ``params``)."""

    prefers_packed_carry = True
    error_norm = staticmethod(lambda e: e)
    # ensemble_solve params support: op_fn(t, p) vmapped over (t, params)
    supports_batched_params = True

    # compensated (double-f32) tier: the residual word ``lo`` rides the
    # stepper-carry channel (step_fn(t, x, dt, lo) -> (x_next, err, lo));
    # see vec_ode_tpu/comp.py
    @property
    def has_carry(self) -> bool:
        return bool(getattr(self, "compensated", False))

    def make_init_carry(self, fn=None, params=None):
        from .. import comp

        return lambda t, x: comp.zero_lo(x)

    def _wnorm_parts(self, x):
        """kernel_parts of the declared ``norm`` (lc.WeightedNorm) over
        this split's widened layout, a widened-vector CALLABLE for a
        traced norm (lc.TracedNorm — the batched XLA executor applies it),
        or None. Batched-mode only — the scalar/vmapped path takes the
        norm via error_norm= instead."""
        wn = getattr(self, "norm", None)
        if wn is None:
            return None
        from ..lc import TracedNorm

        if isinstance(wn, TracedNorm):
            from . import dense_fast as df

            split = self.split

            def _traced_exec(dv):
                err = df.unwiden(split, dv)
                if dv.ndim == 1:
                    return wn(err)
                return wn.batched(err)

            return _traced_exec
        if not hasattr(wn, "kernel_parts"):
            raise TypeError(
                "norm= must be a DECLARED lc.WeightedNorm; opaque "
                "callables go through error_norm= on the vmapped path")
        from . import dense_fast as df

        parts = df.split_parts(self.split, x)
        kp = wn.kernel_parts(parts[0].shape[-1], len(parts))
        if kp is None:
            raise ValueError(
                "WeightedNorm.weights must be a single per-(complex-)"
                f"component array of length {parts[0].shape[-1]} for the "
                "batched dense tier")
        return kp

    def _assembler(self, fn, params):
        """Batched node assembly: vmap the scalar-contract callback over
        per-trajectory times (and params, when given). The steppers stack
        ALL quadrature nodes into one call (times of length n_nodes*B), so
        per-trajectory params tile to match."""
        if params is None:
            return lambda tv: jax.vmap(fn)(tv)
        pb = jax.tree_util.tree_leaves(params)[0].shape[0]

        def assemble(tv):
            rep = tv.shape[0] // pb
            p = params if rep == 1 else jax.tree_util.tree_map(
                lambda a: jnp.concatenate([a] * rep), params
            )
            return jax.vmap(fn)(tv, p)

        return assemble

    @property
    def is_batched(self) -> bool:
        if self.batched is not None:
            if self.batched and not getattr(
                self.split, "supports_batched_dense", False
            ):
                raise ValueError(
                    f"batched=True requires a dense split (DenseSplit / "
                    f"DenseCplxSplit); {type(self.split).__name__} cannot "
                    "batch per-trajectory operators"
                )
            return self.batched
        return bool(getattr(self.split, "supports_batched_dense", False))

    # ensemble_solve may quietly route an AUTO-batched stepper down the
    # vmapped path when the batched conventions conflict with the call
    # (custom error_norm, scaled_error); an EXPLICIT
    # batched=True keeps the hard error instead
    @property
    def auto_batched(self) -> bool:
        return self.batched is None

    def _batched_mode(self, t) -> bool:
        return (
            jnp.ndim(t) >= 1
            and self.is_batched
            and getattr(self.split, "supports_batched_dense", False)
        )

@dataclasses.dataclass(frozen=True)
class ExpMidpoint(_DenseBatchedStepper):
    """Fixed-step exponential midpoint (MidpointExpLinearSolver,
    magnus.rs:85-148). Order 2, no error estimate."""

    split: ExponentialSplit
    op_fn: Callable = None  # set via make_step_fn argument instead if None
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    compensated: bool = False  # double-f32 state pair (comp.py)

    nfev_per_step: int = 1

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                return _midpoint_batched_step(
                    assemble, self.split, t, x, dt,
                    max_squarings=self.max_squarings, lo=lo,
                )
            if params is not None:
                raise ValueError("params requires the batched driver")
            if lo is not None:
                return midpoint_step_comp(fn, self.split, t, x, dt, lo)
            return midpoint_step(fn, self.split, t, x, dt)

        if self.compensated:
            return lambda t, x, dt, lo: step_core(t, x, dt, lo)
        return lambda t, x, dt: step_core(t, x, dt)


@dataclasses.dataclass(frozen=True)
class Magnus4(_DenseBatchedStepper):
    """Adaptive Magnus-4 (MagnusExpLinearSolver, magnus.rs:151-285), with the
    error norm wired correctly (see module docstring).

    ``adaptive=False`` skips the order-2 comparison propagator entirely
    (one expm per step) — the fixed-step economy the reference never
    implemented for Magnus (its magnus_42 always computes both,
    magnus.rs:63-79).

    Over a dense split, ensembles execute natively batched (see
    _DenseBatchedStepper)."""

    split: ExponentialSplit
    op_fn: Callable = None
    adaptive: bool = True
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    # declared error norm (lc.WeightedNorm), batched tier only (reference
    # NormFn, cfm.rs:131-155); the vmapped path takes error_norm= instead
    norm: Optional[object] = None
    # estimate the error as w2·xf (leading term of the order-2/4 gap; the
    # commutator term is already in hand) instead of propagating the
    # comparison exponential: one expm per adaptive step instead of two.
    # Opt-in: same order, different constant, so accept/reject sequences
    # deviate from the reference's pair (magnus.rs:63-79).
    fast_error: bool = False
    compensated: bool = False  # double-f32 state pair (comp.py)

    nfev_per_step: int = 2

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                return _magnus4_batched_step(
                    assemble, self.split, t, x, dt, adaptive=self.adaptive,
                    max_squarings=self.max_squarings,
                    fast_error=self.fast_error,
                    wnorm=self._wnorm_parts(x), lo=lo,
                )
            if params is not None:
                raise ValueError("params requires the batched driver")
            if self.norm is not None:
                raise ValueError(
                    "norm= runs on the batched dense tier; the scalar/"
                    "vmapped path takes the norm via error_norm=")
            if lo is not None:
                return magnus4_step_comp(fn, self.split, t, x, dt, lo,
                                         adaptive=self.adaptive,
                                         fast_error=self.fast_error)
            return magnus4_step(fn, self.split, t, x, dt,
                                adaptive=self.adaptive,
                                fast_error=self.fast_error)

        if self.compensated:
            return lambda t, x, dt, lo: step_core(t, x, dt, lo)
        return lambda t, x, dt: step_core(t, x, dt)


@dataclasses.dataclass(frozen=True)
class Magnus6(_DenseBatchedStepper):
    """Adaptive Magnus-6: Yoshida triple-jump composition of the symmetric
    Magnus-4 step, embedded against the plain Magnus-4 step over the full
    interval (err = x4 - x6). Order 6 at 3 exponentials/step (4 adaptive);
    the reference tops out at order 4.

    Over a dense split, ensembles execute natively batched (see
    _DenseBatchedStepper)."""

    split: ExponentialSplit
    op_fn: Callable = None
    adaptive: bool = True
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    norm: Optional[object] = None    # declared WeightedNorm (batched tier)
    compensated: bool = False  # double-f32 state pair (comp.py) — the tier
    # that makes this solver usable on f32 hardware: the increment-form
    # estimate lifts the ~1e-7 f32 noise floor that made rtol<=1e-7 reject
    # every step

    @property
    def nfev_per_step(self) -> int:
        # 3 sub-interval GL2 pairs + the full-interval pair when adaptive
        return 8 if self.adaptive else 6

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                return _magnus6_batched_step(
                    assemble, self.split, t, x, dt, adaptive=self.adaptive,
                    max_squarings=self.max_squarings,
                    wnorm=self._wnorm_parts(x), lo=lo,
                )
            if params is not None:
                raise ValueError("params requires the batched driver")
            if self.norm is not None:
                raise ValueError(
                    "norm= runs on the batched dense tier; the scalar/"
                    "vmapped path takes the norm via error_norm=")
            if lo is not None:
                return magnus6_step_comp(fn, self.split, t, x, dt, lo,
                                         adaptive=self.adaptive)
            return magnus6_step(fn, self.split, t, x, dt,
                                adaptive=self.adaptive)

        if self.compensated:
            return lambda t, x, dt, lo: step_core(t, x, dt, lo)
        return lambda t, x, dt: step_core(t, x, dt)
