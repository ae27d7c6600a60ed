"""Exponential-split operator protocol.

Counterpart of the reference trait family
(``/root/reference/src/exp/mod.rs:11-54``): an ``ExponentialSplit`` knows how
to exponentiate a linear operator L and apply the propagator U to a state x.

Differences from the reference, by design:
  * Splits are stateless dataclasses of pure functions; operators L and
    propagators U are pytrees of arrays, so everything jits / vmaps / shards.
  * ``multi_exp`` (exp of several rescalings of one operator,
    exp/mod.rs:28-34) returns a *stacked* propagator pytree (leading axis =
    number of rescalings) computed by ONE batched expm, instead of a Vec of
    propagators from a Python loop.
  * ``NormedExponentialSplit`` is unnecessary: error norms are taken by the
    driver on state pytrees (vec_ode_tpu.lc norms).
  * ``lin_zero`` is unnecessary: there is no scratch-buffer discipline.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

Pytree = Any


class ExponentialSplit:
    """Base protocol. L: operator pytree. U: propagator pytree."""

    def exp(self, L: Pytree) -> Pytree:
        raise NotImplementedError

    def map_exp(self, U: Pytree, x: Pytree) -> Pytree:
        raise NotImplementedError

    def scale_l(self, L: Pytree, k) -> Pytree:
        """k * L (the operator linear combination the reference demands via
        ``Sp::LC``; here a plain pytree scale)."""
        from .. import lc

        return lc.scale(L, k)

    def add_l(self, La: Pytree, Lb: Pytree) -> Pytree:
        from .. import lc

        return lc.add(La, Lb)

    def lincomb_l(self, Ls, ks) -> Pytree:
        from .. import lc

        return lc.lincomb(Ls, ks)

    def multi_exp(self, L: Pytree, ks) -> Pytree:
        """Stacked exp(k_i * L) for a vector of scalings ks.

        Default: stack the rescaled operators on a new leading axis and take
        ONE batched exponential (the reference's default loops per scaling,
        exp/mod.rs:28-34)."""
        ks = jnp.asarray(ks)

        def stack_leaf(a):
            # dtype rule: keep the operator's width; adopt complex kind if the
            # scalings are complex (triple-jump/semi-complex coefficients on a
            # real operator), never widen f32->f64 just because ks is f64.
            ld = a.dtype
            if jnp.issubdtype(ks.dtype, jnp.complexfloating) and not (
                jnp.issubdtype(ld, jnp.complexfloating)
            ):
                ld = (
                    jnp.complex64
                    if jnp.finfo(ld).bits == 32
                    else jnp.complex128
                )
            k = ks.reshape(ks.shape + (1,) * jnp.ndim(a)).astype(ld)
            return k * a[None].astype(ld)

        stacked = jax.tree_util.tree_map(stack_leaf, L)
        return self.exp(stacked)

    def exp_many(self, Ls) -> Pytree:
        """Stacked exp of SEVERAL same-structure operators: one batched expm
        over a new leading axis (len(Ls)); select results with ``index_u``.

        Complements ``multi_exp`` (rescalings of one operator). Steppers that
        need k propagators per step (Magnus-4's order-4/2 pair, CFM's s+1
        exponentials) use this to fuse k expm dispatches into one batched
        call — the batch-uniform squaring count in ``ops.expm`` already
        handles the mixed norms."""
        stacked = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves),
                                         *Ls)
        return self.exp(stacked)

    def exp_m1(self, L: Pytree) -> Pytree:
        """phi = exp(L) - I with RELATIVE accuracy (no I-subtraction), in
        the same representation as a propagator, so ``map_exp(phi, x)``
        yields the state increment (U - I) x. Required by the compensated
        (double-f32) tier (vec_ode_tpu.comp); leaves implement it via
        ``ops.expm.expm_m1`` / elementwise expm1 analogs."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define exp_m1 — the "
            "compensated tier needs an increment-form propagator; use a "
            "dense/diagonal/anti-Hermitian leaf or implement exp_m1"
        )

    def exp_many_m1(self, Ls) -> Pytree:
        """Stacked :meth:`exp_m1` of several same-structure operators (one
        batched call, like :meth:`exp_many`)."""
        stacked = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves),
                                         *Ls)
        return self.exp_m1(stacked)

    def commutator(self, La: Pytree, Lb: Pytree) -> Pytree:
        """[La, Lb] (the reference's Commutator trait, exp/mod.rs:47-54)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a commutator"
        )

    def apply_l(self, L: Pytree, x: Pytree) -> Pytree:
        """L @ x — the operator action itself (dx/dt at state x). Needed by
        dense output (Hermite endpoint slopes); optional otherwise."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define apply_l"
        )


def index_u(U: Pytree, k: int) -> Pytree:
    """Select the k-th propagator from a stacked multi_exp result."""
    return jax.tree_util.tree_map(lambda a: a[k], U)
