"""Natively-batched execution for the GENERIC dense exponential steppers.

The reference's exponential solvers take a black-box operator callback
(``Fun: FnMut(&[T]) -> Vec<L>``, magnus.rs:32, cfm.rs:54); under an
adaptive ensemble every trajectory carries its own time, so the samples
A_b(t_i) are per-trajectory dense matrices with no shared structure. This
module executes that contract as batched XLA work:

  * one ``jax.vmap(op_fn)`` per quadrature node assembles the batched
    samples (the callback itself stays scalar-time, reference semantics);
  * ALL chain exponentials run as ONE stacked batched expm (ops.expm —
    Paterson-Stockmeyer Taylor on batched GEMMs) followed by the cheap
    sequential matvecs.

The steppers in exp/magnus.py and exp/cfm.py call into this module when
their split advertises ``supports_batched_dense`` (DenseSplit /
DenseCplxSplit) and the driver hands them batched (t, x, dt).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .protocol import ExponentialSplit

def split_parts(split, x):
    """State as real 2-D parts: (re, im) for Cplx splits, (x,) for real."""
    if getattr(split, "is_cplx_split", False):
        return (x.re, x.im)
    return (x,)


def embed_node(split, L):
    """Per-trajectory operator sample -> real working matrix (B, D, D)."""
    if getattr(split, "is_cplx_split", False):
        from ..ops.cplx import embed

        return embed(L)
    return jnp.asarray(L)


def widen(parts):
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)


def unwiden(split, yw):
    if getattr(split, "is_cplx_split", False):
        from ..ops.cplx import Cplx

        d = yw.shape[-1] // 2
        return Cplx(yw[..., :d], yw[..., d:])
    return yw


def run_batched_chains(
    split: ExponentialSplit,
    x,
    dt: jax.Array,                       # (B,)
    xla_chains: Callable,                # () -> [C][R_c] (B, D, D) exponents
    *,
    adaptive: bool,
    max_squarings: int = 16,
    wnorm=None,
    lo=None,
):
    """Execute the chain structure. Returns (y, err_norm or None) with err
    as a PER-TRAJECTORY NORM (the batched drivers use error_norm=identity).

    ``wnorm=(w_row, post, kind)`` (lc.WeightedNorm.kernel_parts): declared
    error norm over the widened layout, or a traced-norm callable.

    ``lo`` (state-structured pytree) switches to the COMPENSATED tier
    (vec_ode_tpu.comp): chain propagators run in increment
    form via ``ops.expm.expm_m1`` (D <- D + phi_i (x + D), every term
    O(|dy|)), the error estimate is a DIFFERENCE OF INCREMENTS (noise floor
    eps*|dy| instead of eps*|y|), and the step returns
    (y, err_norm, lo_next) with (y, lo_next) the TwoSum-renormalized pair."""
    parts = split_parts(split, x)
    dtype = parts[0].dtype

    if lo is not None:
        return _run_batched_chains_comp(
            split, parts, lo, xla_chains, dtype,
            adaptive=adaptive, max_squarings=max_squarings, wnorm=wnorm,
        )

    from ..ops.expm import expm
    from ..utils.prec import HIGHEST

    chains = xla_chains()
    flat = [W.astype(dtype) for chain in chains for W in chain]
    # STACK (K, B, D, D) rather than concatenating to (K*B, D, D): B stays
    # the minor batch dim. The squaring count is batch-uniform either way
    # (ops/expm.py), so the math is identical.
    U = expm(jnp.stack(flat), max_squarings=max_squarings)
    xw = widen(parts)
    B = xw.shape[0]

    from ..lc import apply_weighted_norm as _enorm_w

    def _enorm(dv):
        return _enorm_w(dv, wnorm)

    if all(len(c) == 1 for c in chains):
        # every chain is a single propagator: apply ALL of them in one
        # batched matvec over the stacked U (2 launches -> 1; the y/err
        # pair is the common adaptive case, magnus.rs:63-79)
        Uf = U.reshape((-1,) + U.shape[2:])
        xs = jnp.concatenate([xw] * len(chains))
        ys = jnp.einsum("...ij,...j->...i", Uf, xs, precision=HIGHEST)
        y = ys[:B]
        if len(chains) < 2:
            return unwiden(split, y), None
        dv = ys[B:2 * B] - y
        e = _enorm(dv)
        return unwiden(split, y), (e if adaptive else None)

    def apply_chain(idx0, chain_len, v):
        for i in range(chain_len):
            v = jnp.einsum("...ij,...j->...i", U[idx0 + i], v,
                           precision=HIGHEST)
        return v

    y = apply_chain(0, len(chains[0]), xw)
    if len(chains) < 2:
        return unwiden(split, y), None
    ev = apply_chain(len(chains[0]), len(chains[1]), xw)
    dv = ev - y
    e = _enorm(dv)
    return unwiden(split, y), (e if adaptive else None)


def _run_batched_chains_comp(split, parts, lo, xla_chains, dtype, *,
                             adaptive, max_squarings, wnorm):
    """Compensated executor (see run_batched_chains ``lo=``): stacked
    batched expm_m1 + increment-form chain applications + TwoSum state
    update, all on the widened real layout."""
    from .. import comp
    from ..lc import apply_weighted_norm
    from ..ops.expm import expm_m1
    from ..utils.prec import HIGHEST

    chains = xla_chains()
    flat = [W.astype(dtype) for chain in chains for W in chain]
    # same stacked-(K, B, D, D) layout rationale as the plain executor
    Phi = expm_m1(jnp.stack(flat), max_squarings=max_squarings)
    xw = widen(parts)
    lo_w = widen(split_parts(split, lo))

    def chain_increment(idx0, chain_len):
        D = jnp.einsum("...ij,...j->...i", Phi[idx0], xw, precision=HIGHEST)
        for i in range(1, chain_len):
            v = xw + D
            D = D + jnp.einsum("...ij,...j->...i", Phi[idx0 + i], v,
                               precision=HIGHEST)
        return D

    D = chain_increment(0, len(chains[0]))
    e = None
    if len(chains) >= 2 and adaptive:
        De = chain_increment(len(chains[0]), len(chains[1]))
        e = apply_weighted_norm(De - D, wnorm)
    hi2, lo2 = comp._update_leaf(xw, lo_w, D)
    return unwiden(split, hi2), e, unwiden(split, lo2)
