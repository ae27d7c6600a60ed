"""Pytree vector-space layer: linear-combination primitives over arbitrary pytrees.

This is the JAX counterpart of the reference's vector-space abstraction
(``/root/reference/src/lc.rs:7-118``). The reference makes steppers generic over
storage types via the ``LinearCombination`` / ``LinearCombinationSpace`` traits
(five primitive ops: scale, scalar_multiply_to, add_scalar_mul, add_assign_ref,
delta, plus derived ``linear_combination``). In JAX the pytree system already
provides that genericity, so here every op is a pure function over pytrees of
arrays; any pytree whose leaves are JAX arrays is a valid state. In-place /
scratch-register discipline (``rk.rs:104-115``) is replaced by XLA buffer reuse
and donation — all functions are pure.

Norms: the reference ships ``Normed`` impls only for real scalars (abs) and
complex scalars (modulus) (``base/rk.rs:204-214``); vector norms are
user-supplied. We provide the natural extensions (L2 over all leaves, max-abs,
RMS) with L2 as the framework default error norm.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

Pytree = Any


def _match_scalar(k, leaf):
    """Cast a (possibly per-trajectory) scalar coefficient to the leaf dtype
    and align it for broadcasting.

    Python scalars are weakly typed (no promotion hazard). Traced scalars are
    cast so that e.g. an f64 time-step never promotes an f32/c64 state leaf to
    a wider dtype: state math stays in the state dtype, time math in the time
    dtype. A batched coefficient (leading batch axes only, e.g. a (B,) dt
    against (B, d) leaves in the natively-batched driver) gets trailing axes
    appended so it scales per trajectory.
    """
    if isinstance(k, (int, float, complex)):
        return k
    k = jnp.asarray(k)
    leaf = jnp.asarray(leaf)
    if k.dtype != leaf.dtype:
        k = k.astype(leaf.dtype)
    if 0 < k.ndim < leaf.ndim:
        k = k.reshape(k.shape + (1,) * (leaf.ndim - k.ndim))
    return k


def scale(v: Pytree, k) -> Pytree:
    """k * v  (reference ``LC::scale``, lc.rs:10)."""
    return jax.tree_util.tree_map(lambda a: a * _match_scalar(k, a), v)


def add(v: Pytree, u: Pytree) -> Pytree:
    """v + u  (reference ``LC::add_assign_ref``, lc.rs:16)."""
    return jax.tree_util.tree_map(jnp.add, v, u)


def sub(v: Pytree, u: Pytree) -> Pytree:
    """v - u  (reference ``LC::delta``, lc.rs:18)."""
    return jax.tree_util.tree_map(jnp.subtract, v, u)


def axpy(k, u: Pytree, v: Pytree) -> Pytree:
    """v + k * u  (reference ``LC::add_scalar_mul``, lc.rs:14)."""
    return jax.tree_util.tree_map(
        lambda a, b: a + _match_scalar(k, b) * b, v, u
    )


def lincomb(vs: Sequence[Pytree], ks: Sequence) -> Pytree:
    """sum_i ks[i] * vs[i]  (reference ``LC::linear_combination``, lc.rs:20-35).

    ``vs`` is a Python sequence of same-structure pytrees with static length
    (Butcher stages are statically unrolled), so XLA fuses the whole sum into
    one elementwise pass per leaf.
    """
    if len(vs) == 0 or len(ks) == 0:
        raise ValueError("lincomb: sequences cannot be empty")
    if len(vs) != len(ks):
        raise ValueError("lincomb: sequences must be the same length")

    def leaf_comb(*leaves):
        acc = leaves[0] * _match_scalar(ks[0], leaves[0])
        for k, leaf in zip(ks[1:], leaves[1:]):
            acc = acc + _match_scalar(k, leaf) * leaf
        return acc

    return jax.tree_util.tree_map(leaf_comb, *vs)


def zeros_like(v: Pytree) -> Pytree:
    return jax.tree_util.tree_map(jnp.zeros_like, v)


def _reduce_leaves(v: Pytree, leaf_fn: Callable, combine: Callable):
    leaves = jax.tree_util.tree_leaves(v)
    vals = [leaf_fn(a) for a in leaves]
    acc = vals[0]
    for x in vals[1:]:
        acc = combine(acc, x)
    return acc


def norm_l2(v: Pytree):
    """Flat L2 norm over all leaves (real result, even for complex leaves)."""
    sq = _reduce_leaves(
        v, lambda a: jnp.sum(jnp.real(a * jnp.conj(a))), jnp.add
    )
    return jnp.sqrt(sq)


def norm_max(v: Pytree):
    """max |v_i| over all leaves."""
    return _reduce_leaves(v, lambda a: jnp.max(jnp.abs(a)), jnp.maximum)


def norm_l2_batched(v: Pytree):
    """Per-trajectory L2 norm: reduce every axis except the leading batch
    axis of each leaf. For natively-batched driver states (B, ...)."""
    leaves = jax.tree_util.tree_leaves(v)
    acc = None
    for a in leaves:
        s = jnp.sum(
            jnp.real(a * jnp.conj(a)), axis=tuple(range(1, a.ndim))
        )
        acc = s if acc is None else acc + s
    return jnp.sqrt(acc)


def norm_rms(v: Pytree):
    """RMS norm: L2 / sqrt(n)."""
    n = sum(a.size for a in jax.tree_util.tree_leaves(v))
    n2 = norm_l2(v)
    return n2 / jnp.sqrt(jnp.asarray(float(n), dtype=n2.dtype))


def vdot(u: Pytree, v: Pytree):
    """<u, v> with conjugation on u, summed over all leaves."""
    return _reduce_leaves(
        jax.tree_util.tree_map(lambda a, b: jnp.sum(jnp.conj(a) * b), u, v),
        lambda a: a,
        jnp.add,
    )


def tree_where(mask, a: Pytree, b: Pytree) -> Pytree:
    """Select a where mask else b, broadcasting the (scalar or batched) mask
    against each leaf's leading axes. Used for branchless accept/reject."""

    def sel(x, y):
        m = mask
        extra = x.ndim - m.ndim
        if extra < 0:
            # silently inflating a low-rank leaf to the mask's shape would
            # change the carry structure mid-loop (opaque while_loop error
            # far from the cause) — fail loudly here instead
            raise ValueError(
                f"tree_where: leaf of shape {x.shape} has lower rank than "
                f"the mask {jnp.shape(m)}; batched selects need every leaf "
                "to carry the batch axes"
            )
        if extra > 0:
            m = m.reshape(m.shape + (1,) * extra)
        return jnp.where(m, x, y)

    return jax.tree_util.tree_map(sel, a, b)


import dataclasses as _dc
import math as _math


@_dc.dataclass(frozen=True)
class WeightedNorm:
    """A DECLARED error-norm family the fast tiers can execute natively.

    The reference's ``ExpCFMSolver`` takes an arbitrary user ``NormFn``
    (``/root/reference/src/exp/cfm.rs:131-155``). An opaque callable works
    here too (``error_norm=``, vmapped tier), but natively-batched steppers
    compute their norms inside the step, over their widened real layout.
    This class declares the practically-universal family — weighted l2 /
    rms / max over the REAL components of the state — in a form every tier
    (vmapped driver, batched driver, batched steppers) executes with
    identical semantics.

    ``weights``: None (all ones), one array broadcast against each leaf's
    trailing axes (a Cplx state's re/im blocks share it), or a pytree
    matching the error's structure. For complex-pair states the norm is
    taken over the real representation: l2 then equals
    sqrt(sum_i w_i^2 |e_i|^2) exactly; max is max over real/imag parts
    (within sqrt(2) of the complex-magnitude max).

    kind: "l2"  -> sqrt(sum (w e)^2)
          "rms" -> l2 / sqrt(n_real_components)
          "max" -> max |w e|

    Callable per trajectory, so it drops into any ``error_norm=`` slot;
    ``.batched`` reduces per-trajectory over a leading batch axis.
    """

    kind: str = "l2"
    weights: Any = None

    def __post_init__(self):
        if self.kind not in ("l2", "rms", "max"):
            raise ValueError(
                f"WeightedNorm kind must be l2|rms|max, got {self.kind!r}"
            )
        # normalize flat array weights to a tuple: keeps the frozen
        # dataclass comparable/hashable (an ndarray field makes __eq__
        # return an array, so 'norm != other' would raise the ambiguous-
        # truth-value error); pytree weights stay as-is
        if self.weights is not None:
            import numpy as _np

            try:
                w = _np.asarray(self.weights, _np.float64)
            except Exception:
                return
            if w.ndim == 1:
                object.__setattr__(self, "weights", tuple(w.tolist()))

    def _weighted_leaves(self, err):
        leaves = jax.tree_util.tree_leaves(err)
        if self.weights is None:
            return leaves, leaves
        try:
            wl = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(
                    lambda e, w: e * jnp.asarray(w, e.dtype), err,
                    self.weights,
                )
            )
            return wl, leaves
        except ValueError:
            pass  # not a matching pytree: broadcast one array to every leaf
        w = jnp.asarray(self.weights)
        return [l * w.astype(l.dtype) for l in leaves], leaves

    def _reduce(self, err, batch_ndim: int):
        wl, leaves = self._weighted_leaves(err)
        axes = lambda l: tuple(range(batch_ndim, l.ndim))
        if self.kind == "max":
            vals = [jnp.max(jnp.abs(l), axis=axes(l)) for l in wl]
            out = vals[0]
            for v in vals[1:]:
                out = jnp.maximum(out, v)
            return out
        ss = None
        for l in wl:
            s = jnp.sum(l * l, axis=axes(l))
            ss = s if ss is None else ss + s
        if self.kind == "rms":
            n = sum(_math.prod(l.shape[batch_ndim:]) for l in leaves)
            ss = ss / n
        return jnp.sqrt(ss)

    def __call__(self, err):
        return self._reduce(err, 0)

    def batched(self, err):
        return self._reduce(err, 1)

    def kernel_parts(self, d_part: int, n_parts: int):
        """(w_row, post, kind) for the batched steppers' widened-real
        layout: a numpy (1, n_parts*d_part) row or None, a constant
        post-factor, and the reduction kind.
        Returns None when the declaration cannot be laid out (weights that
        are a pytree rather than one per-component array)."""
        import numpy as np

        D = n_parts * d_part
        if self.weights is None:
            row = None
        else:
            try:
                w = np.asarray(self.weights, np.float64)
            except Exception:
                return None
            if w.ndim != 1 or w.shape[0] != d_part:
                return None
            row = np.concatenate([w] * n_parts)[None, :]
        post = 1.0 / _math.sqrt(D) if self.kind == "rms" else 1.0
        kind = "max" if self.kind == "max" else "l2"
        return row, post, kind


class TracedNorm:
    """An opaque-but-traceable per-trajectory error-norm callable promoted
    to the batched tier (trace, don't declare).

    The reference's NormFn is an arbitrary closure
    (``/root/reference/src/exp/cfm.rs:131-155``). A declared
    :class:`WeightedNorm` runs natively on every tier; this wrapper covers
    the rest of the traceable space: ``ensemble_solve`` probes an opaque
    ``error_norm=`` callable with ``jax.eval_shape`` on a per-trajectory
    state abstract, and when it traces to a scalar wraps it here and keeps
    the BATCHED tier (vmapping it over the batch / unwidening the batched
    error vector) instead of dropping to the vmapped tier or raising.
    ``FusedModulatedLinearRK`` rejects it: it executes declared norms
    only."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, err):
        return self.fn(err)

    def batched(self, err):
        return jax.vmap(self.fn)(err)


def try_trace_norm(fn, example_err):
    """Probe ``fn`` (a per-trajectory error-norm callable) against an
    abstract per-trajectory error pytree. Returns a :class:`TracedNorm`
    when it traces cleanly to a scalar, else None (genuinely untraceable
    callables keep the legacy fallback paths)."""
    try:
        out = jax.eval_shape(fn, example_err)
    except Exception:
        return None
    if getattr(out, "shape", None) != ():
        return None
    return TracedNorm(fn)


def apply_weighted_norm(dv, wnorm, axis=-1):
    """post * ||w_row * dv|| with kind l2|max over ``axis`` — the ONE
    XLA-side executor of a ``WeightedNorm.kernel_parts`` declaration
    (``wnorm=(w_row, post, kind)`` or None for plain l2), or a CALLABLE
    ``wnorm`` (a TracedNorm's widened-vector executor, built by the
    steppers) applied to ``dv`` directly."""
    if wnorm is None:
        return jnp.sqrt(jnp.sum(dv * dv, axis=axis))
    if callable(wnorm):
        return wnorm(dv)
    w_row, post, kind = wnorm
    if w_row is not None:
        dv = dv * jnp.asarray(w_row, dv.dtype).reshape(-1)
    e = (jnp.max(jnp.abs(dv), axis=axis) if kind == "max"
         else jnp.sqrt(jnp.sum(dv * dv, axis=axis)))
    return e if post == 1.0 else e * post
