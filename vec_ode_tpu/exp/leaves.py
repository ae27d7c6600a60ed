"""Concrete exponential-split leaves.

The reference ships *no* leaf ``ExponentialSplit`` implementations — dense
expm / matvec are left to downstream users (SURVEY.md §1). These are the
leaves the framework supplies so the exponential solvers are usable:

  * :class:`DenseSplit` — L is a dense (..., d, d) matrix; exp is a batched
    Padé-13 scaling-and-squaring expm; apply is a (batched) matvec.
  * :class:`DiagonalSplit` — L is the diagonal (..., d); everything is
    elementwise (exact, cheapest).
  * :class:`AntiHermitianSplit` — L = -i*H*dt with H Hermitian (Schrödinger
    propagation); exp via eigendecomposition, exactly unitary up to eigh
    accuracy.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops.expm import expm, expm_frechet, expm_m1
from ..utils.prec import HIGHEST, mm
from .protocol import ExponentialSplit


def _check_max_squarings(v):
    """The operator function belongs to solve_linear(op_fn, ...), not the
    leaf; DenseSplit(Ht) would otherwise silently bind Ht to this field."""
    import numbers

    if not isinstance(v, numbers.Integral):
        raise TypeError(
            "max_squarings must be an int; split leaves take no operator "
            "argument — pass the operator function to solve_linear / the "
            f"solver instead (got {type(v).__name__})"
        )


def cp_embed(L):
    from ..ops import cplx as cp

    return cp.embed(L)


@jax.custom_vjp
def _skew_expm(M):
    """exp of a real skew-symmetric M via one symmetric eigh:
    exp(M) = cos(P) + M sinc(P), P = sqrt(-M²). Exactly orthogonal.

    Needs a custom VJP: the embedding makes every eigenvalue of -M² (at
    least) doubly degenerate, so eigh's own VJP (which divides by eigenvalue
    gaps) is ill-posed on EVERY input and returns silently wrong gradients.
    The backward pass uses the exact Fréchet adjoint L*(M, G) = L(Mᵀ, G)
    via the matmul-only block-expm path instead.
    """
    M2 = -mm(M, M)                       # = P², symmetric PSD
    theta2, V = jnp.linalg.eigh(M2)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    cos_t = jnp.cos(theta)
    sinc_t = jnp.sinc(theta / jnp.pi)    # sin(θ)/θ, θ→0 safe
    Vt = jnp.swapaxes(V, -1, -2)
    MV = mm(M, V)
    return mm(V * cos_t[..., None, :] + MV * sinc_t[..., None, :], Vt)


def _skew_expm_fwd(M):
    return _skew_expm(M), M


def _skew_expm_bwd(M, G):
    return (expm_frechet(jnp.swapaxes(M, -1, -2), G),)


_skew_expm.defvjp(_skew_expm_fwd, _skew_expm_bwd)


def _skew_expm_m1(M):
    """exp(M) - I for skew-symmetric M without the I-subtraction:
    exp(M) - I = (cos(P) - I) + M sinc(P) with cos(θ) - 1 = -2 sin²(θ/2),
    so every term is O(|M|) and the increment keeps relative accuracy."""
    M2 = -mm(M, M)
    theta2, V = jnp.linalg.eigh(M2)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    half = jnp.sin(0.5 * theta)
    cos_m1 = -2.0 * half * half
    sinc_t = jnp.sinc(theta / jnp.pi)
    Vt = jnp.swapaxes(V, -1, -2)
    MV = mm(M, V)
    return mm(V * cos_m1[..., None, :] + MV * sinc_t[..., None, :], Vt)


@dataclasses.dataclass(frozen=True)
class DenseSplit(ExponentialSplit):
    """Dense-matrix operator leaf. L: (..., d, d). U: (..., d, d)."""

    max_squarings: int = 16

    # generic steppers over this leaf batch natively through the stacked
    # batched-expm executor (exp/dense_fast.py)
    supports_batched_dense = True

    def __post_init__(self):
        _check_max_squarings(self.max_squarings)

    def exp(self, L):
        return expm(L, max_squarings=self.max_squarings)

    def exp_m1(self, L):
        return expm_m1(L, max_squarings=self.max_squarings)

    def map_exp(self, U, x):
        return jnp.einsum("...ij,...j->...i", U, x, precision=HIGHEST)

    def commutator(self, La, Lb):
        return mm(La, Lb) - mm(Lb, La)

    def apply_l(self, L, x):
        return jnp.einsum("...ij,...j->...i", L, x, precision=HIGHEST)


@dataclasses.dataclass(frozen=True)
class DiagonalSplit(ExponentialSplit):
    """Diagonal operator leaf. L: (..., d) diagonal entries. U: (..., d)."""

    def exp(self, L):
        return jnp.exp(L)

    def exp_m1(self, L):
        return jnp.expm1(L)

    def map_exp(self, U, x):
        return U * x

    def commutator(self, La, Lb):
        return jnp.zeros_like(La)

    def apply_l(self, L, x):
        return L * x


class _CplxSplitBase(ExponentialSplit):
    """Shared operator algebra for real-pair complex splits (see
    vec_ode_tpu/ops/cplx.py): operators and states are
    :class:`~vec_ode_tpu.ops.cplx.Cplx` pairs and the scalar ops route
    through cscale_any (complex trace-time coefficients, real traced
    dt). Propagators are EMBEDDED real (..., 2d, 2d) matrices; the shared
    map_exp applies them with one widened real matmul."""

    # states are Cplx (re, im) pairs; dense_fast widens them to (B, 2d)
    is_cplx_split = True

    def map_exp(self, U, x):
        from ..ops import cplx as cp

        return cp.apply_embedded(U, x)

    def commutator(self, La, Lb):
        from ..ops import cplx as cp

        return cp.cmatmul(La, Lb) - cp.cmatmul(Lb, La)

    def apply_l(self, L, x):
        from ..ops import cplx as cp

        return cp.cmatvec(L, x)

    def scale_l(self, L, k):
        from ..ops import cplx as cp

        return cp.cscale_any(L, k)

    def add_l(self, La, Lb):
        return La + Lb

    def lincomb_l(self, Ls, ks):
        from ..ops import cplx as cp

        acc = cp.cscale_any(Ls[0], ks[0])
        for L, k in zip(Ls[1:], ks[1:]):
            acc = acc + cp.cscale_any(L, k)
        return acc

    def multi_exp(self, L, ks):
        import numpy as np

        from ..ops import cplx as cp

        ks = np.asarray(ks)
        scaled = [cp.cscale_any(L, k) for k in ks]
        stacked = cp.Cplx(
            jnp.stack([s.re for s in scaled]),
            jnp.stack([s.im for s in scaled]),
        )
        return self.exp(stacked)


@dataclasses.dataclass(frozen=True)
class DenseCplxSplit(_CplxSplitBase):
    """Dense complex-matrix leaf in real-pair representation.

    L: Cplx of (..., d, d). exp via the real ring embedding (one real
    (2d, 2d) expm — for d=64, 128-wide real GEMMs).
    Diagonal Padé is unitary on anti-Hermitian input, so Schrödinger
    propagators stay norm-conserving to roundoff — use this leaf for
    quantum problems in f32 (no eigh required)."""

    max_squarings: int = 16

    # generic steppers over this leaf batch natively through the stacked
    # batched-expm executor (exp/dense_fast.py)
    supports_batched_dense = True

    def __post_init__(self):
        _check_max_squarings(self.max_squarings)

    def exp(self, L):
        # keep the propagator in EMBEDDED real (..., 2d, 2d) form: apply is
        # then one widened real matmul, with no per-application re-embedding
        from ..ops import cplx as cp
        from ..ops.expm import expm

        return expm(cp.embed(L), max_squarings=self.max_squarings)

    def exp_m1(self, L):
        from ..ops import cplx as cp

        return expm_m1(cp.embed(L), max_squarings=self.max_squarings)


@dataclasses.dataclass(frozen=True)
class DiagonalCplxSplit(_CplxSplitBase):
    """Diagonal complex leaf in real-pair representation. L: Cplx (..., d)."""

    def exp(self, L):
        from ..ops import cplx as cp

        return cp.cexp(L)

    def exp_m1(self, L):
        from ..ops import cplx as cp

        return cp.cexpm1(L)

    def map_exp(self, U, x):
        return U * x

    def commutator(self, La, Lb):
        return jax.tree_util.tree_map(jnp.zeros_like, La)

    def apply_l(self, L, x):
        return L * x


@dataclasses.dataclass(frozen=True)
class AntiHermitianCplxSplit(_CplxSplitBase):
    """Exactly-unitary anti-Hermitian leaf in real-pair representation.

    For anti-Hermitian L (L† = -L, e.g. -i dt H with H Hermitian) the real
    embedding M = embed(L) is skew-symmetric, so

        exp(M) = cos(P) + M sinc(P),   P = sqrt(-M²)  (symmetric PSD)

    computed with ONE real eigh of -M² plus three real matmuls — no complex
    arithmetic anywhere and exactly orthogonal (=> the
    complex propagator is exactly unitary) up to eigh accuracy. Use for
    long Schrödinger integrations where Padé/Taylor unitarity drift over
    many steps matters; DenseCplxSplit is cheaper per step.

    Only valid for anti-Hermitian operators with REAL rescalings: the
    complex-coefficient compositions (TripleJumpSplit, SemiComplexO4Split)
    break anti-Hermiticity and are rejected by multi_exp — use
    DenseCplxSplit there.
    """

    def exp(self, L):
        return _skew_expm(cp_embed(L))

    def exp_m1(self, L):
        return _skew_expm_m1(cp_embed(L))

    def _reject_complex(self, k):
        import numbers

        import numpy as np

        bad = isinstance(k, (complex, np.complexfloating)) and not isinstance(
            k, numbers.Real)
        if not bad:
            try:
                bad = np.iscomplexobj(np.asarray(k))
            except Exception:
                bad = False
        if bad:
            raise ValueError(
                "AntiHermitianCplxSplit requires real rescalings: complex "
                "coefficients (TripleJumpSplit / SemiComplexO4Split) break "
                "anti-Hermiticity — use DenseCplxSplit for those"
            )

    def scale_l(self, L, k):
        # complex k reaches this leaf through nested composites' per-factor
        # scale_l (bypassing multi_exp); _skew_expm would then silently
        # return a wrong propagator, so guard here too
        self._reject_complex(k)
        return super().scale_l(L, k)

    def multi_exp(self, L, ks):
        self._reject_complex(ks)
        return super().multi_exp(L, ks)


@dataclasses.dataclass(frozen=True)
class AntiHermitianSplit(ExponentialSplit):
    """Anti-Hermitian operator leaf (L† = -L), e.g. L = -i*dt*H(t).

    exp(L) = V diag(e^{i w}) V† where i*L = V diag(w) V† is Hermitian —
    exactly unitary, the natural choice for Schrödinger/Magnus steps where
    norm conservation matters more than raw expm speed.
    """

    def exp(self, L):
        H = 1j * L  # Hermitian
        w, V = jnp.linalg.eigh(H)
        phase = jnp.exp(-1j * w.astype(L.dtype))
        return jnp.einsum(
            "...ik,...k,...jk->...ij", V, phase, jnp.conj(V),
            precision=HIGHEST,
        )

    def exp_m1(self, L):
        # e^{-iw} - 1 = -2 sin²(w/2) - i sin(w): O(|w|) termwise, so the
        # increment-form propagator keeps relative accuracy
        H = 1j * L
        w, V = jnp.linalg.eigh(H)
        w = w.astype(jnp.real(L).dtype)
        half = jnp.sin(0.5 * w)
        phase_m1 = (-2.0 * half * half - 1j * jnp.sin(w)).astype(L.dtype)
        return jnp.einsum(
            "...ik,...k,...jk->...ij", V, phase_m1, jnp.conj(V),
            precision=HIGHEST,
        )

    def map_exp(self, U, x):
        return jnp.einsum("...ij,...j->...i", U, x, precision=HIGHEST)

    def commutator(self, La, Lb):
        return mm(La, Lb) - mm(Lb, La)

    def apply_l(self, L, x):
        return jnp.einsum("...ij,...j->...i", L, x, precision=HIGHEST)
