"""Batched matrix exponential.

The reference ships *no* exponential-map implementation — its
``ExponentialSplit::exp`` is entirely user-supplied (``exp/mod.rs:11-35``,
SURVEY.md §1 "crucial architectural fact"). This module provides the missing
leaves: a batch-uniform scaling-and-squaring expm that jits and vmaps, for
real and complex matrices.

Design notes:
  * Padé-13 with a **batch-uniform squaring count**: the number of squarings
    is computed from the max 1-norm over the whole batch (one scalar), so the
    squaring loop has static-friendly uniform control flow instead of
    per-matrix dynamic loop trips (SURVEY §7 hard-part #2). For known operator
    classes (e.g. dt*H with bounded ||H||) a static ``max_squarings`` keeps
    everything fully static.
  * All matmuls batch over leading axes via ``jnp.matmul``, so XLA lowers
    them to batched GEMMs.
  * Complex support: the arithmetic below is dtype-generic; the framework's
    own complex paths go through ``ops.cplx`` (``cexpm`` / the
    ``*CplxSplit`` leaves, real-pair ring embedding).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.prec import mm

# Padé-13 coefficients (Higham 2005, "The scaling and squaring method for the
# matrix exponential revisited") — standard published constants.
_PADE13_B = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)

# theta_13: 1-norm threshold below which Padé-13 is accurate at unit scaling.
_THETA13 = 5.371920351148152
_THETA13_F32 = 4.25  # f32 analog (Higham tab. for single precision, m=13)


def _pade13(A, A2, A4, A6, ident):
    b = _PADE13_B
    U = mm(A, (
        mm(A6, b[13] * A6 + b[11] * A4 + b[9] * A2)
        + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident
    ))
    V = (
        mm(A6, b[12] * A6 + b[10] * A4 + b[8] * A2)
        + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    )
    return U, V


# Taylor/Paterson-Stockmeyer threshold: degree-12 truncation e^t - T12(t)
# at |t| <= 1 is ~4e-10 — below f32 eps. Matmul-only (no linear solve).
_THETA_TAYLOR12 = 1.0


def _taylor12_ps(As, ident):
    """Degree-12 Taylor of exp via Paterson-Stockmeyer: 5 matmuls.

    p(A) = B0 + A4 (B1 + A4 (B2 + A4 B3)),  B_j = sum_{i<4} A^i/(4j+i)!
    """
    import math

    c = [1.0 / math.factorial(k) for k in range(13)]
    A2 = mm(As, As)
    A3 = mm(A2, As)
    A4 = mm(A3, As)

    def block(j):
        return (
            c[4 * j] * ident + c[4 * j + 1] * As
            + c[4 * j + 2] * A2 + c[4 * j + 3] * A3
        )

    acc = block(2) + c[12] * A4             # B2 + A4*B3 (B3 = c12*I only)
    acc = block(1) + mm(A4, acc)
    return block(0) + mm(A4, acc)


def _taylor12_ps_m1(As, ident):
    """Degree-12 Taylor of expm1 (e^A - I) via Paterson-Stockmeyer.

    Identical to :func:`_taylor12_ps` except the constant I term of block 0
    is dropped, so the result is phi = e^A - I computed WITHOUT the
    catastrophic I-subtraction: every term is O(|A|), giving phi a relative
    (not |I|-absolute) rounding error. This is the primitive behind the
    compensated (double-f32) exponential steppers (vec_ode_tpu.comp)."""
    import math

    c = [1.0 / math.factorial(k) for k in range(13)]
    A2 = mm(As, As)
    A3 = mm(A2, As)
    A4 = mm(A3, As)

    def block(j):
        return (
            c[4 * j] * ident + c[4 * j + 1] * As
            + c[4 * j + 2] * A2 + c[4 * j + 3] * A3
        )

    blk0_m1 = As + c[2] * A2 + c[3] * A3   # block(0) - I
    acc = block(2) + c[12] * A4
    acc = block(1) + mm(A4, acc)
    return blk0_m1 + mm(A4, acc)


def _expm_impl(A: jax.Array, max_squarings: int,
               method: str = "auto", differentiable: bool = False,
               minus_one: bool = False) -> jax.Array:
    A = jnp.asarray(A)
    d = A.shape[-1]
    if A.shape[-2] != d:
        raise ValueError(f"expm expects (..., d, d), got {A.shape}")
    real_dtype = jnp.finfo(A.dtype).dtype  # float32 for complex64, etc.
    is_f64 = jnp.finfo(real_dtype).bits >= 64
    if method == "auto":
        # in f32 the matmul-only Taylor-12 path avoids the batched
        # linalg.solve of the Padé denominator and is accurate to f32 eps;
        # f64 keeps Padé-13.
        method = "pade13" if is_f64 else "taylor"
    theta = {
        "pade13": _THETA13 if is_f64 else _THETA13_F32,
        "taylor": _THETA_TAYLOR12,
    }[method]

    # max 1-norm over the batch (scalar) -> uniform squaring count s
    one_norm = jnp.max(
        jnp.sum(jnp.abs(A), axis=-2), axis=-1
    )  # (...,) per-matrix 1-norm
    max_norm = jnp.max(one_norm)
    # s = max(0, ceil(log2(max_norm / theta)))
    s_f = jnp.ceil(jnp.log2(jnp.maximum(max_norm / theta, 1.0)))
    s = jnp.clip(s_f, 0, max_squarings).astype(jnp.int32)
    scale = jnp.asarray(2.0, real_dtype) ** (-s.astype(real_dtype))
    As = A * scale.astype(A.dtype)

    ident = jnp.broadcast_to(jnp.eye(d, dtype=A.dtype), A.shape)
    if method == "taylor":
        R = (_taylor12_ps_m1 if minus_one else _taylor12_ps)(As, ident)
    else:
        A2 = mm(As, As)
        A4 = mm(A2, A2)
        A6 = mm(A4, A2)
        U, V = _pade13(As, A2, A4, A6, ident)
        P = V + U
        Q = V - U
        # minus_one: phi = Q^{-1}P - I = Q^{-1}(P - Q) = Q^{-1}(2U) — the
        # I-subtraction happens in exact arithmetic (P - Q == 2U), so phi
        # keeps a relative error bound like the Taylor m1 path
        R = jnp.linalg.solve(Q, 2.0 * U if minus_one else P)

    # uniform squaring: R <- R^2, s times (minus_one: phi <- phi^2 + 2 phi,
    # since (I+phi)^2 - I = phi^2 + 2 phi — every term stays O(|phi|)).
    # s is one scalar for the whole batch, so this while_loop has uniform
    # trip count across the ensemble.
    # ``differentiable=True`` swaps the dynamic while_loop for a bounded
    # masked scan (reverse-mode differentiable; always pays max_squarings
    # matmuls) — used by expm_frechet so second-order gradients work.
    def square(Rc):
        if minus_one:
            return mm(Rc, Rc) + Rc + Rc
        return mm(Rc, Rc)

    if differentiable:
        def sq(Rc, i):
            return jnp.where(i < s, square(Rc), Rc), None

        R, _ = jax.lax.scan(sq, R, jnp.arange(max_squarings))
        return R

    def cond(c):
        i, _ = c
        return i < s

    def body(c):
        i, Rc = c
        return i + 1, square(Rc)

    _, R = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), R))
    return R


def expm_frechet(A: jax.Array, E: jax.Array, *,
                 max_squarings: int = 16, method: str = "auto") -> jax.Array:
    """Fréchet derivative L(A, E) = d/ds expm(A + sE)|_0 via the block
    identity expm([[A, E], [0, A]]) = [[expm(A), L(A, E)], [0, expm(A)]]."""
    d = A.shape[-1]
    E = jnp.asarray(E, A.dtype)
    top = jnp.concatenate([A, E], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(A), A], axis=-1)
    F = _expm_impl(jnp.concatenate([top, bot], axis=-2), max_squarings,
                   method, differentiable=True)
    return F[..., :d, d:]


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _expm_core(A: jax.Array, max_squarings: int, method: str) -> jax.Array:
    return _expm_impl(A, max_squarings, method)


def _expm_fwd(A, max_squarings, method):
    return _expm_impl(A, max_squarings, method), A


def _expm_bwd(max_squarings, method, A, G):
    # adjoint of the Fréchet derivative: L*(A, G) = L(A^H, G) — exp has real
    # Taylor coefficients, so the adjoint is the Fréchet derivative at the
    # conjugate transpose (Higham 2008, ch. 10).
    AH = jnp.conj(jnp.swapaxes(A, -1, -2))
    return (expm_frechet(AH, G, max_squarings=max_squarings, method=method),)


_expm_core.defvjp(_expm_fwd, _expm_bwd)


@partial(jax.jit, static_argnames=("max_squarings", "method"))
def expm(A: jax.Array, *, max_squarings: int = 16,
         method: str = "auto") -> jax.Array:
    """Matrix exponential of (..., d, d) via Padé-13 scaling-and-squaring.

    Batch-uniform: one squaring count for the whole batch, derived from the
    max 1-norm (keeps the squaring loop uniform across a vmapped/sharded
    ensemble). ``max_squarings`` bounds the dynamic squaring loop; matrices
    needing more squarings than that lose accuracy rather than erroring.

    Reverse-mode differentiable via an exact Fréchet-adjoint VJP (one block
    2d-by-2d expm), so ``jax.grad`` works through the dynamic squaring loop.
    For forward-mode sensitivities use :func:`expm_frechet` directly.

    method: "pade13" (Higham scaling-and-squaring, needs a linear solve),
    "taylor" (degree-12 Paterson-Stockmeyer, matmul-only, no linear solve,
    accurate to f32 eps), or "auto" (taylor for <=f32, pade13 for f64).
    """
    return _expm_core(A, max_squarings, method)


@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def _expm_m1_core(A: jax.Array, max_squarings: int, method: str) -> jax.Array:
    return _expm_impl(A, max_squarings, method, minus_one=True)


def _expm_m1_fwd(A, max_squarings, method):
    return _expm_impl(A, max_squarings, method, minus_one=True), A


_expm_m1_core.defvjp(_expm_m1_fwd, _expm_bwd)  # d(e^A - I) = d(e^A)


@partial(jax.jit, static_argnames=("max_squarings", "method"))
def expm_m1(A: jax.Array, *, max_squarings: int = 16,
            method: str = "auto") -> jax.Array:
    """phi = expm(A) - I, computed WITHOUT the I-subtraction (the matrix
    analog of ``expm1``).

    Same scaling-and-squaring scheme as :func:`expm` (batch-uniform squaring
    count, same methods/VJP), but every intermediate stays O(|phi|):
      * Taylor path drops the identity term from the PS block-0;
      * Pade path solves Q phi = 2U (P - Q == 2U exactly);
      * squaring uses (I+phi)^2 - I = phi^2 + 2 phi.
    So for dt*||A|| << 1 the result has RELATIVE accuracy ~eps where
    ``expm(A) - I`` would be floored at the ABSOLUTE eps*|I| — the primitive
    that lets the compensated (double-f32) exponential steppers
    (vec_ode_tpu.comp) advance states in increment form y += phi @ y with
    per-step rounding O(eps*|dy|) instead of O(eps*|y|)."""
    return _expm_m1_core(A, max_squarings, method)


def expm_apply(A: jax.Array, x: jax.Array, **kw) -> jax.Array:
    """exp(A) @ x for (..., d, d) A and (..., d) x."""
    from ..utils.prec import HIGHEST

    U = expm(A, **kw)
    return jnp.einsum("...ij,...j->...i", U, x, precision=HIGHEST)
