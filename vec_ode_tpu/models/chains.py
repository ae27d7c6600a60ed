"""Lattice-chain model family: natural A+B split structure.

A driven tight-binding chain — dψ/dt = -i (H_hop + v(t) H_onsite) ψ — is the
canonical use case for the operator-splitting solvers: the hopping part is a
dense-but-structured anti-Hermitian generator (DenseCplxSplit / DenseSplit
leaf) and the onsite part is diagonal (DiagonalCplxSplit leaf), so the split
propagator needs only one small expm plus elementwise phases per factor.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class TightBindingChain:
    """n-site chain: H_hop = -J sum |k><k+1| + h.c. (+ periodic wrap),
    H_onsite(t) = v(t) * diag(site_energies)."""

    n: int = 16
    J: float = 1.0
    periodic: bool = False
    seed: int = 0
    w: float = 1.0  # drive frequency for v(t) = cos(w t)

    def hop_matrix(self) -> np.ndarray:
        H = np.zeros((self.n, self.n))
        for k in range(self.n - 1):
            H[k, k + 1] = H[k + 1, k] = -self.J
        if self.periodic:
            H[0, -1] = H[-1, 0] = -self.J
        return H

    def onsite_energies(self) -> np.ndarray:
        return np.random.default_rng(self.seed).uniform(-1, 1, self.n)

    def v(self, t):
        return jnp.cos(self.w * jnp.asarray(t))

    # --- split operators, real-pair representation ------------------------
    def ops_pair(self, t, dtype=jnp.float32):
        """(La, Lb) for SplitMidpoint/RKNR4 over (DenseCplx, DiagonalCplx):
        La = -i H_hop (constant), Lb = -i v(t) diag(e)."""
        from ..ops.cplx import Cplx

        Hh = jnp.asarray(self.hop_matrix(), dtype)
        e = jnp.asarray(self.onsite_energies(), dtype)
        vt = self.v(t).astype(dtype)
        La = Cplx(jnp.zeros_like(Hh), -Hh)
        Lb = Cplx(jnp.zeros_like(e), -vt * e)
        return (La, Lb)

    # --- full operator (golden reference, complex dtype, CPU) ---------------
    def op(self, t, dtype=jnp.complex128):
        Hh = jnp.asarray(self.hop_matrix(), dtype)
        e = jnp.asarray(np.diag(self.onsite_energies()), dtype)
        vt = self.v(t).astype(dtype)
        return -1j * (Hh + vt * e)
