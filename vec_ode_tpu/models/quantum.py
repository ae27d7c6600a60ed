"""Quantum model family: time-dependent Schrödinger problems
dψ/dt = -i H(t) ψ — the exponential integrators' raison d'être
(BASELINE.md configs 3 and 4).

Landau-Zener has a closed-form asymptotic transition probability
P = exp(-2 pi Δ² / (4 v)) for golden tests; the driven dense Hamiltonian is
the 64-dim benchmark operator.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class LandauZener:
    """2-level avoided crossing: H(t) = (v t) σ_z / 2 + (Δ/2) σ_x.

    Asymptotic transition probability (diabatic basis, sweep -T -> +T):
    P_LZ = exp(-pi Δ² / (2 v)).
    """

    v: float = 1.0      # sweep rate
    delta: float = 0.5  # gap

    def hamiltonian(self, t):
        sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.complex128)
        sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.complex128)
        td = jnp.asarray(t).astype(jnp.float64)
        return (self.v * td).astype(jnp.complex128) * sz + self.delta * sx

    def op(self, t):
        """A(t) = -i H(t): the anti-Hermitian generator."""
        return -1j * self.hamiltonian(t)

    @property
    def p_transition(self) -> float:
        return math.exp(-math.pi * self.delta**2 / (2.0 * self.v))

    def op_pair(self, t, dtype=jnp.float32):
        """A(t) = -i H(t) in real-pair (Cplx) representation (ops/cplx.py).
        H = vt*sz + delta*sx is real here, so -iH = Cplx(0, -H)."""
        from ..ops.cplx import Cplx

        sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], dtype)
        sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], dtype)
        H = jnp.asarray(t).astype(dtype) * self.v * sz + self.delta * sx
        return Cplx(jnp.zeros_like(H), -H)

    def modulated(self, dtype=jnp.float32):
        """A(t) = v*t * (-i sz) + delta * (-i sx) as a ModulatedOperator."""
        from ..exp.modulated import ModulatedOperator
        from ..ops.cplx import Cplx

        sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], dtype)
        sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], dtype)
        basis = Cplx(
            jnp.zeros((2, 2, 2), dtype), jnp.stack([-sz, -sx])
        )
        v, delta = self.v, self.delta

        def coeff(t):
            t = jnp.asarray(t).astype(dtype)
            return jnp.stack([v * t, jnp.full_like(t, delta)], axis=-1)

        return ModulatedOperator(basis=basis, coeff_fn=coeff)


@dataclasses.dataclass(frozen=True)
class DrivenDense:
    """Driven dense Hamiltonian H(t) = H0 + cos(w t) V, d-dimensional —
    the 64-dim complex benchmark operator (BASELINE config 4)."""

    H0: np.ndarray  # host-side complex; device complex only on CPU paths
    V: np.ndarray
    w: float = 1.0

    @staticmethod
    def make(d: int = 64, seed: int = 0, w: float = 1.0):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        V = (N + N.conj().T) / (2 * math.sqrt(d))
        return DrivenDense(H0=H0, V=V, w=w)

    def hamiltonian(self, t, dtype=jnp.complex128):
        td = jnp.asarray(t).astype(jnp.float64)
        c = jnp.cos(self.w * td).astype(dtype)
        return jnp.asarray(self.H0, dtype) + c * jnp.asarray(self.V, dtype)

    def op(self, t):
        return -1j * self.hamiltonian(t)

    def rhs(self, t, psi):
        from ..utils.prec import HIGHEST

        return jnp.einsum("ij,...j->...i", self.op(t), psi,
                          precision=HIGHEST)

    def pair_parts(self, dtype=jnp.float32):
        """(H0, V) as Cplx pairs in the given real dtype."""
        from ..ops.cplx import from_complex

        return (
            from_complex(self.H0, dtype),
            from_complex(self.V, dtype),
        )

    def op_pair(self, t, dtype=jnp.float32):
        """A(t) = -i H(t) as a Cplx pair: -i(Hr + iHi) = (Hi, -Hr)."""
        from ..ops.cplx import Cplx

        H0, V = self.pair_parts(dtype)
        c = jnp.cos(self.w * jnp.asarray(t).astype(dtype))
        Hr = H0.re + c * V.re
        Hi = H0.im + c * V.im
        return Cplx(Hi, -Hr)

    def modulated(self, dtype=jnp.float32):
        """A(t) = -i H0 + cos(wt) * (-i V) as a
        :class:`~vec_ode_tpu.exp.ModulatedOperator` — the shared-basis fast
        path for the exponential integrators (exp/modulated.py)."""
        from ..exp.modulated import ModulatedOperator
        from ..ops.cplx import Cplx

        H0, V = self.pair_parts(dtype)
        basis = Cplx(
            jnp.stack([H0.im, V.im]),      # re(-iH) = im(H)
            jnp.stack([-H0.re, -V.re]),    # im(-iH) = -re(H)
        )
        w = self.w

        def coeff(t):
            t = jnp.asarray(t).astype(dtype)
            return jnp.stack([jnp.ones_like(t), jnp.cos(w * t)], axis=-1)

        return ModulatedOperator(basis=basis, coeff_fn=coeff)

    def rhs_pair(self, t, psi, dtype=jnp.float32):
        """dpsi/dt = -i H(t) psi on Cplx states — the ensemble RHS.

        Exploits the H(t) = H0 + cos(wt) V structure: two SHARED (2d)-wide
        real matmuls with the per-trajectory scalar cos(wt) applied to the
        V-term *output vector*. Under vmap the matrices stay unbatched, so a
        16k-trajectory ensemble does two (B, 2d) @ (2d, 2d) GEMMs per stage
        instead of materializing a (B, d, d) operator batch (d times less
        memory traffic)."""
        from ..ops.cplx import Cplx, cmatvec

        H0, V = self.pair_parts(dtype)
        A0 = Cplx(H0.im, -H0.re)   # -i H0
        AV = Cplx(V.im, -V.re)     # -i V
        c = jnp.cos(self.w * jnp.asarray(t).astype(dtype))
        y0 = cmatvec(A0, psi)
        yv = cmatvec(AV, psi)
        return Cplx(y0.re + c * yv.re, y0.im + c * yv.im)


@dataclasses.dataclass(frozen=True)
class PulseControl:
    """Quantum optimal control (state transfer): H(t; θ) = H0 + u(t; θ) Hc
    with a sine-series pulse u(t; θ) = Σ_j θ_j sin(jπ t / T) (so u vanishes
    at both endpoints). The control task — maximize the transfer fidelity
    \\|<tgt|ψ(T)>\\|² over θ — is the canonical workload for
    :func:`vec_ode_tpu.diff.adjoint_solve`: thousands of optimizer steps,
    each a full solve + O(1)-memory gradient.

    The reference crate has no control/autodiff machinery at all (its diff
    module is declared empty, lib.rs:12); this model exists to exercise and
    demonstrate capability the rebuild adds.
    """

    H0: np.ndarray          # (d, d) complex Hermitian drift
    Hc: np.ndarray          # (d, d) complex Hermitian control
    T: float = 3.0          # pulse duration
    n_modes: int = 4        # sine modes in the pulse parameterization

    @staticmethod
    def make(d: int = 4, seed: int = 0, T: float = 3.0, n_modes: int = 4):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        Hc = (N + N.conj().T) / (2 * math.sqrt(d))
        return PulseControl(H0=H0, Hc=Hc, T=T, n_modes=n_modes)

    def basis_pair(self, dtype=jnp.float64):
        """Cplx (2, d, d) basis [-iH0, -iHc] for the modulated adjoint path."""
        from ..ops.cplx import Cplx, from_complex

        H0 = from_complex(self.H0, dtype)
        Hc = from_complex(self.Hc, dtype)
        return Cplx(jnp.stack([H0.im, Hc.im]), jnp.stack([-H0.re, -Hc.re]))

    def coeff_fn(self, t, theta):
        """(…, 2) modulation coefficients [1, u(t; θ)] — trailing-K, batched
        t safe; differentiable w.r.t. θ and t (adjoint requirements)."""
        t = jnp.asarray(t)
        j = jnp.arange(1, self.n_modes + 1, dtype=theta.dtype)
        u = jnp.sum(theta * jnp.sin(j * (jnp.pi / self.T) * t[..., None]),
                    axis=-1)
        return jnp.stack([jnp.ones_like(u), u], axis=-1)

    def pulse(self, t, theta):
        """u(t; θ) alone (plotting/diagnostics)."""
        return self.coeff_fn(t, theta)[..., 1]

    def fidelity(self, psi, tgt):
        """\\|<tgt|psi>\\|² for Cplx states (trailing state axis)."""
        re = jnp.sum(tgt.re * psi.re + tgt.im * psi.im, axis=-1)
        im = jnp.sum(tgt.re * psi.im - tgt.im * psi.re, axis=-1)
        return re * re + im * im

    def infidelity(self, theta, psi0, tgt, *, n_steps=256, order=4,
                   dtype=jnp.float64):
        """1 − fidelity of the θ-controlled transfer ψ0 → tgt at t = T,
        differentiable via the O(1)-memory reversible adjoint."""
        from ..diff import adjoint_solve

        yf = adjoint_solve(self.basis_pair(dtype), self.coeff_fn, theta,
                           psi0, 0.0, self.T, n_steps=n_steps, order=order)
        return 1.0 - jnp.sum(self.fidelity(yf, tgt))

    def gate_infidelity(self, theta, U_target, *, n_steps=256, order=4,
                        dtype=jnp.float64):
        """1 − \\|tr(U†_target U(T; θ))/d\\)² — unitary gate synthesis: the
        propagator is obtained by driving the d basis columns through the
        same adjoint solve as one batch (the adjoint never materializes
        propagators, so a gate loss is just a d-column state-transfer)."""
        from ..diff import adjoint_solve
        from ..ops.cplx import Cplx

        Ut = np.asarray(U_target)
        d = Ut.shape[-1]
        cols0 = Cplx(jnp.eye(d, dtype=dtype), jnp.zeros((d, d), dtype))
        yf = adjoint_solve(self.basis_pair(dtype), self.coeff_fn, theta,
                           cols0, 0.0, self.T, n_steps=n_steps, order=order)
        # yf rows are U(T) columns: yf[j] = U e_j; overlap tr(Ut† U)/d
        Ur, Ui = jnp.asarray(Ut.real, dtype), jnp.asarray(Ut.imag, dtype)
        re = jnp.sum(Ur.T * yf.re + Ui.T * yf.im) / d
        im = jnp.sum(Ur.T * yf.im - Ui.T * yf.re) / d
        return 1.0 - (re * re + im * im)


@dataclasses.dataclass(frozen=True)
class Lindblad:
    """Open-system (Lindblad master equation) dynamics as a MODULATED
    linear ODE over vectorized density matrices:

        dρ/dt = -i[H0 + u(t) Hc, ρ] + Σ_j γ_j D[L_j] ρ
        D[L]ρ = L ρ L† − ½{L†L, ρ}

    Column-stacking vec(ρ) turns every term into a d²-dim superoperator:
    -i[H, ·] → -i(I⊗H − Hᵀ⊗I) and D[L] → L̄⊗L − ½(I⊗L†L + (L†L)ᵀ⊗I), so
    A(t) = S_drift + u(t)·S_ctrl is exactly the Σ f_k(t) M_k structure the
    modulated fast path and the reversible adjoint consume (basis size
    K = 2; for d = 8 the widened dimension is 2d² = 128).

    The reference crate has no open-system support at all. NOTE for
    gradients: dissipation makes backward trajectory RECONSTRUCTION
    amplify (the adjoint docstring's caveat) — for strongly dissipative
    problems prefer ``method="scan"`` or short horizons.
    """

    H0: np.ndarray                  # (d, d) complex Hermitian drift
    Hc: np.ndarray                  # (d, d) complex Hermitian control
    jumps: tuple                    # ((gamma_j, L_j (d, d) complex), ...)

    @staticmethod
    def make(d: int = 4, seed: int = 0, gamma: float = 0.1):
        """Random drift/control + one amplitude-damping-like jump."""
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        Hc = (N + N.conj().T) / (2 * math.sqrt(d))
        L = np.diag(np.ones(d - 1), k=1).astype(complex)  # lowering ladder
        return Lindblad(H0=H0, Hc=Hc, jumps=((gamma, L),))

    def _super_commutator(self, H):
        d = H.shape[0]
        eye = np.eye(d)
        return -1j * (np.kron(eye, H) - np.kron(H.T, eye))

    def _super_dissipator(self):
        d = self.H0.shape[0]
        eye = np.eye(d)
        S = np.zeros((d * d, d * d), complex)
        for g, L in self.jumps:
            LdL = L.conj().T @ L
            S += g * (np.kron(L.conj(), L)
                      - 0.5 * (np.kron(eye, LdL) + np.kron(LdL.T, eye)))
        return S

    def superop_basis(self, dtype=jnp.float64):
        """Cplx (2, d², d²): [drift+dissipators, control commutator]."""
        from ..ops.cplx import Cplx

        S0 = self._super_commutator(self.H0) + self._super_dissipator()
        S1 = self._super_commutator(self.Hc)
        S = np.stack([S0, S1])
        return Cplx(jnp.asarray(S.real, dtype), jnp.asarray(S.imag, dtype))

    def modulated(self, u_fn, dtype=jnp.float64):
        """ModulatedOperator A(t) = S0 + u(t)·S1 for the exp solvers
        (``u_fn(t)`` scalar/batched control envelope)."""
        from ..exp.modulated import ModulatedOperator

        basis = self.superop_basis(dtype)

        def coeff(t):
            t = jnp.asarray(t)
            return jnp.stack([jnp.ones_like(t), u_fn(t)], axis=-1)

        return ModulatedOperator(basis=basis, coeff_fn=coeff)

    @staticmethod
    def vec_rho(rho, dtype=jnp.float64):
        """Density matrix (…, d, d) complex → Cplx (…, d²) column-stacked
        vector (Fortran order to match the ⊗ convention)."""
        from ..ops.cplx import from_complex

        r = np.asarray(rho)
        v = np.reshape(np.swapaxes(r, -1, -2), r.shape[:-2] + (-1,))
        return from_complex(v, dtype)

    @staticmethod
    def unvec_rho(v):
        """Cplx (…, d²) → complex ndarray (…, d, d)."""
        z = np.asarray(v.re) + 1j * np.asarray(v.im)
        d = int(round(math.sqrt(z.shape[-1])))
        return np.swapaxes(z.reshape(z.shape[:-1] + (d, d)), -1, -2)
