"""Linear ODE model family: dx/dt = A x and dx/dt = A(t) x.

Problem library backing the parity/benchmark configs (BASELINE.md configs
1, 4, 5). The reference has no model zoo — its tests hand-roll exponential
decay (impls/nalgebra.rs:52-107); these are the framework-native equivalents
with closed-form solutions for golden tests.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


def stable_dense_matrix(d: int, seed: int = 0, dtype=jnp.float64):
    """Random stable matrix A = -(I + W Wᵀ/d) + skew part: spectrum in the
    left half plane, well-conditioned for golden exp(At) comparisons.
    ``dtype=None`` returns the host numpy f64 array (no device transfer)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, d))
    S = rng.standard_normal((d, d))
    A = -(np.eye(d) + W @ W.T / d) * 0.5 + (S - S.T) * 0.3
    if dtype is None:
        return A
    return jnp.asarray(A, dtype)


@dataclasses.dataclass(frozen=True)
class LinearConstant:
    """dx/dt = A x with constant A; exact solution exp(A t) x0."""

    A: jnp.ndarray

    def rhs(self, t, y):
        from ..utils.prec import HIGHEST

        return jnp.einsum("ij,...j->...i", self.A, y, precision=HIGHEST)

    def op(self, t):
        return self.A

    def exact(self, t, y0):
        from ..ops.expm import expm
        from ..utils.prec import HIGHEST

        t = jnp.asarray(t, jnp.result_type(self.A.dtype, float))
        # batch-aware matvec at HIGHEST precision (a bare `@` may run with
        # reduced-precision f32 products AND consume a (B, d) batch as a
        # matrix product)
        return jnp.einsum("ij,...j->...i",
                          expm(self.A * t.astype(self.A.dtype)), y0,
                          precision=HIGHEST)


@dataclasses.dataclass(frozen=True)
class DecayDiag:
    """Diagonal decay y_i' = rates_i * y_i — the reference's inline test
    problem (impls/nalgebra.rs:52-89)."""

    rates: jnp.ndarray

    def rhs(self, t, y):
        return self.rates * y

    def op(self, t):
        return self.rates  # diagonal operator (DiagonalSplit leaf)

    def exact(self, t, y0):
        return y0 * jnp.exp(self.rates * t)
