"""Operator-splitting combinators.

Counterpart of ``/root/reference/src/exp/split_exp.rs:24-517``.
Each combinator composes two child splits over a direct-sum operator
L = (La, Lb) (the reference's ``DirectSumL``, split_exp.rs:48-99 — here just a
tuple, since pytrees subsume the direct-sum linear algebra). ``exp`` returns a
tuple of child propagators (possibly stacked via one batched ``multi_exp``)
and ``map_exp`` applies the published factor sequence.

Factor sequences reproduce the reference exactly:
  * :class:`CommutativeSplit`  — U = (UA, UB), x -> UB UA x
    (split_exp.rs:143-177)
  * :class:`StrangSplit`       — e^{B/2} e^{A} e^{B/2} (split_exp.rs:229-275)
  * :class:`SemiComplexO4Split` — 9-factor palindrome with complex B weights
    (split_exp.rs:336-383, coefficients dat/mod.rs:56-62)
  * :class:`TripleJumpSplit`   — 7-factor complex triple jump
    (split_exp.rs:410-446, coefficients dat/mod.rs:46-54)
  * :class:`RKNR4Split`        — 13-factor real RKN order-4
    (split_exp.rs:482-517, coefficients dat/mod.rs:34-40)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import tableaus as tb
from .protocol import ExponentialSplit, index_u


@dataclasses.dataclass(frozen=True)
class _Pair(ExponentialSplit):
    sp_a: ExponentialSplit
    sp_b: ExponentialSplit

    def scale_l(self, L, k):
        la, lb = L
        return (self.sp_a.scale_l(la, k), self.sp_b.scale_l(lb, k))

    def add_l(self, La, Lb):
        return (
            self.sp_a.add_l(La[0], Lb[0]),
            self.sp_b.add_l(La[1], Lb[1]),
        )

    def commutator(self, La, Lb):
        # direct sum of child commutators (split_exp.rs:191-203)
        return (
            self.sp_a.commutator(La[0], Lb[0]),
            self.sp_b.commutator(La[1], Lb[1]),
        )

    def apply_l(self, L, x):
        # the direct-sum operator acts as the SUM of the parts: (A+B) x
        from .. import lc

        la, lb = L
        return lc.add(self.sp_a.apply_l(la, x), self.sp_b.apply_l(lb, x))

    def multi_exp(self, L, ks):
        # per-scaling loop (the reference's semantics, exp/mod.rs:28-34):
        # the protocol's stacked default would interleave a nested child's
        # own multi_exp axis in front of this one, corrupting index_u
        # selection under composition nesting. ks is a small trace-time
        # array, so the loop unrolls into one fused XLA program anyway.
        import numpy as np

        us = [self.exp(self.scale_l(L, k)) for k in np.asarray(ks)]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *us)

    def exp_many(self, Ls):
        # per-operator loop for the same reason as multi_exp above: the
        # protocol's stacked default runs ONE composite exp whose internal
        # multi_exp calls put THEIR axis in front of the stacked axis,
        # so index_u would select the wrong axis (silently wrong
        # propagators under Magnus/CFM adaptive pairs)
        us = [self.exp(L) for L in Ls]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *us)


class CommutativeSplit(_Pair):
    """exp(A+B) = exp(A)exp(B) for commuting A, B (split_exp.rs:24-177)."""

    def exp(self, L):
        la, lb = L
        return (self.sp_a.exp(la), self.sp_b.exp(lb))

    def map_exp(self, U, x):
        ua, ub = U
        return self.sp_b.map_exp(ub, self.sp_a.map_exp(ua, x))

    def multi_exp(self, L, ks):
        la, lb = L
        return (self.sp_a.multi_exp(la, ks), self.sp_b.multi_exp(lb, ks))


class StrangSplit(_Pair):
    """Strang composition e^{B/2} e^{A} e^{B/2} (split_exp.rs:229-275)."""

    def exp(self, L):
        la, lb = L
        ua = self.sp_a.exp(la)
        ub = self.sp_b.exp(self.sp_b.scale_l(lb, 0.5))
        return (ua, ub)

    def map_exp(self, U, x):
        ua, ub = U
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(ub, x))
        return self.sp_b.map_exp(ub, y)

    def multi_exp(self, L, ks):
        la, lb = L
        return (
            self.sp_a.multi_exp(la, ks),
            self.sp_b.multi_exp(self.sp_b.scale_l(lb, 0.5), ks),
        )


class SemiComplexO4Split(_Pair):
    """Semi-complex order-4: 4 equal A factors (1/4 each) interleaved with a
    complex-weight B palindrome b0 b1 b2 b1 b0 (split_exp.rs:336-383)."""

    def exp(self, L):
        la, lb = L
        ua = self.sp_a.exp(self.sp_a.scale_l(la, 0.25))
        ub = self.sp_b.multi_exp(lb, tb.SEMI_COMPLEX_O4_B)  # stacked (3, ...)
        return (ua, ub)

    def map_exp(self, U, x):
        ua, ub = U
        b = [index_u(ub, k) for k in range(3)]
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[0], x))
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[1], y))
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[2], y))
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[1], y))
        return self.sp_b.map_exp(b[0], y)


class TripleJumpSplit(_Pair):
    """Complex triple-jump order-4 (split_exp.rs:410-446)."""

    def exp(self, L):
        la, lb = L
        ua = self.sp_a.multi_exp(la, tb.TJ_O4_A)  # stacked (2, ...)
        ub = self.sp_b.multi_exp(lb, tb.TJ_O4_B)  # stacked (2, ...)
        return (ua, ub)

    def map_exp(self, U, x):
        ua, ub = U
        a = [index_u(ua, k) for k in range(2)]
        b = [index_u(ub, k) for k in range(2)]
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[0], x))
        y = self.sp_a.map_exp(a[1], self.sp_b.map_exp(b[1], y))
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[1], y))
        return self.sp_b.map_exp(b[0], y)


class RKNR4Split(_Pair):
    """Blanes-Moan RKN order-4 (BAB), 13 factors (split_exp.rs:482-517)."""

    def exp(self, L):
        la, lb = L
        ua = self.sp_a.multi_exp(la, tb.RKN_O4_A)  # stacked (3, ...)
        ub = self.sp_b.multi_exp(lb, tb.RKN_O4_B)  # stacked (4, ...)
        return (ua, ub)

    def map_exp(self, U, x):
        ua, ub = U
        a = [index_u(ua, k) for k in range(3)]
        b = [index_u(ub, k) for k in range(4)]
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[0], x))
        y = self.sp_a.map_exp(a[1], self.sp_b.map_exp(b[1], y))
        y = self.sp_a.map_exp(a[2], self.sp_b.map_exp(b[2], y))
        y = self.sp_a.map_exp(a[2], self.sp_b.map_exp(b[3], y))
        y = self.sp_a.map_exp(a[1], self.sp_b.map_exp(b[2], y))
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[1], y))
        return self.sp_b.map_exp(b[0], y)
