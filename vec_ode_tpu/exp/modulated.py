"""Modulated-operator fast path: A(t) = sum_k f_k(t) * M_k.

The reference's exponential solvers treat the operator as a black box
sampled at quadrature nodes (``Fun: FnMut(&[T]) -> Vec<L>``, magnus.rs:32,
cfm.rs:54): every step materializes dense per-step operators and
exponentiates them. For the dominant batched use case — driven Hamiltonians
H(t) = H0 + f(t) V — that cost model is wrong: per-trajectory batched (d, d)
expm/matvec work is memory-bound, while *shared-matrix* x *batched-vector*
contractions are plain large GEMMs (the same observation behind the fused
RK step, ops/modulated_rk.py).

This module exploits the linear structure the reference's API erases:

  * :class:`ModulatedOperator` — K shared basis matrices M_k (real-pair
    complex or plain real) + a scalar coefficient function c(t) -> (K,).
  * Magnus/CFM steps become COEFFICIENT arithmetic: every exponent the
    stepper needs (Magnus Ω and its order-2 part, each CFM row) is a linear
    combination of the basis — for Magnus-4 extended with the precomputed
    commutators [M_j, M_k] (computed once at stepper construction, NOT per
    step: [A(t1), A(t2)] = sum_{j<k} (g1_j g2_k - g1_k g2_j) [M_j, M_k]).
  * The propagator is never materialized: e^Ω x is evaluated by a
    scaling-and-Taylor action (:func:`modulated_exp_apply`) whose inner
    operation is ONE shared (D, K*D) matmul per Taylor term — under vmap
    over an ensemble this is a (B*L, D) @ (D, K*D) GEMM with no
    per-trajectory matrices anywhere.

Cost per Magnus-4 step at d=64, K=2 (driven Hamiltonian): ~m=12 GEMMs of
(2B, 128) @ (128, 3*128) vs the generic path's two batched (B, 128, 128)
expm (~8 batched matmuls of B 128x128 blocks) + a per-step commutator —
about an order of magnitude less arithmetic AND it stays GEMM-shaped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import Cplx, cmatmul, embed
from ..ops.chain import chain_expmv_xla
from ..utils.prec import HIGHEST
from .magnus import _B2, _C_MID, _SUB_LEN, _SUB_OFF

Pytree = Any

# Taylor-action (degree, theta) per dtype: smallest degree whose remainder
# |e^t - T_m(t)| at |t| <= theta sits well under dtype eps (f32: m=8 gives
# 2.3e-10 at 0.35; f64: m=12 gives 2.4e-18 at 0.25). Lower degree = fewer
# GEMM passes per exponential.
_TAYLOR_CFG = {32: (8, 0.35), 64: (12, 0.25)}


def _taylor_params(dtype, m=None, theta=None):
    """Resolve (m, theta) for a dtype; an explicit m gets a theta making the
    truncation error ~eps for that degree."""
    import math

    bits = jnp.finfo(dtype).bits
    m_def, theta_def = _TAYLOR_CFG[bits]
    if m is None:
        m = m_def
    if theta is None:
        if m == m_def:
            theta = theta_def
        else:
            eps = 2.0 ** (-(23 if bits == 32 else 52))
            lo, hi = 1e-6, 10.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                r = sum(mid ** k / math.factorial(k)
                        for k in range(m + 1, m + 30))
                lo, hi = (mid, hi) if r < 0.25 * eps else (lo, mid)
            theta = lo
    return m, theta


def _real_basis(basis) -> jax.Array:
    """(K, D, D) real working basis: ring-embed a Cplx basis, pass real
    through."""
    if isinstance(basis, Cplx):
        return embed(basis)
    return jnp.asarray(basis)


def _widen(x, is_cplx: bool) -> jax.Array:
    if is_cplx:
        return jnp.concatenate([x.re, x.im], axis=-1)
    return x


def _unwiden(xw, is_cplx: bool):
    if is_cplx:
        d = xw.shape[-1] // 2
        return Cplx(xw[..., :d], xw[..., d:])
    return xw


@dataclasses.dataclass(frozen=True)
class ModulatedOperator:
    """A(t) = sum_k coeff_fn(t)[k] * basis[k].

    basis: Cplx of (K, d, d) (real-pair complex) or a real (K, d, d) array.
    coeff_fn: scalar t -> (K,) REAL coefficients (traced; complex structure
    belongs inside the basis matrices, e.g. M = -i*H).
    """

    basis: Any
    coeff_fn: Callable

    @property
    def is_cplx(self) -> bool:
        return isinstance(self.basis, Cplx)

    @property
    def n_terms(self) -> int:
        return jax.tree_util.tree_leaves(self.basis)[0].shape[0]

    def assemble(self, t):
        """Dense A(t) — the generic-path / test view of this operator."""
        c = self.coeff_fn(t)
        if self.is_cplx:
            return Cplx(
                jnp.einsum("k,kij->ij", c, self.basis.re, precision=HIGHEST),
                jnp.einsum("k,kij->ij", c, self.basis.im, precision=HIGHEST),
            )
        return jnp.einsum("k,kij->ij", c, self.basis, precision=HIGHEST)

    def commutator_extension(self):
        """(extended_basis, pair_indices): basis followed by the P=K(K-1)/2
        commutators C_{jk} = [M_j, M_k] (j<k). Concrete arrays — call at
        stepper construction, outside jit."""
        K = self.n_terms
        pairs = [(j, k) for j in range(K) for k in range(j + 1, K)]
        if self.is_cplx:
            def take(i):
                return Cplx(self.basis.re[i], self.basis.im[i])

            comms = [
                cmatmul(take(j), take(k)) - cmatmul(take(k), take(j))
                for (j, k) in pairs
            ]
            ext = Cplx(
                jnp.concatenate(
                    [self.basis.re] + [c.re[None] for c in comms]
                ),
                jnp.concatenate(
                    [self.basis.im] + [c.im[None] for c in comms]
                ),
            )
        else:
            from ..utils.prec import mm

            comms = [
                mm(self.basis[j], self.basis[k])
                - mm(self.basis[k], self.basis[j])
                for (j, k) in pairs
            ]
            ext = jnp.concatenate(
                [jnp.asarray(self.basis)] + [c[None] for c in comms]
            )
        return ext, pairs


def modulated_exp_apply(
    basis_w: jax.Array,
    coeffs: jax.Array,
    xw: jax.Array,
    *,
    m: Optional[int] = None,
    max_squarings: int = 16,
    theta: Optional[float] = None,
) -> jax.Array:
    """y = exp(sum_k coeffs[..., k] * basis_w[k]) @ xw, without materializing
    the exponent or its propagator.

    basis_w: (K, D, D) shared real working basis.
    coeffs:  (..., K) real; xw: (..., D). Batch dims broadcast elementwise.

    Scaling-and-Taylor on the ACTION: uniform squaring count s from the
    1-norm bound sum_k |c_k| ||M_k||_1 (max over the batch — same
    batch-uniform discipline as ops.expm), then 2^s sequential applications
    of the degree-m Taylor polynomial, each Taylor term one shared
    (..., D) x (K, D, D) contraction that XLA lowers to a single
    (prod(batch), D) @ (D, K*D) matmul.
    """
    dtype = xw.dtype
    m, theta = _taylor_params(dtype, m, theta)
    norms = jnp.max(jnp.sum(jnp.abs(basis_w), axis=-2), axis=-1)   # (K,)
    cs, n_pass = _scale_chains(
        coeffs[..., None, None, :].astype(dtype), norms, dtype,
        max_squarings, theta,
    )
    y, _ = chain_expmv_xla(cs, n_pass, xw, basis_w.astype(dtype), m=m)
    return y


def _scale_chains(chains, norms, dtype, max_squarings, theta=None):
    """Uniform scaling for chain coefficients (..., C, R, K): the squaring
    count s comes from the GLOBAL max of the 1-norm bound sum_k |c_k|
    ||M_k||_1 (batch-uniform control flow, as in ops.expm); returns
    (chains / 2^s, n_pass = 2^s)."""
    if theta is None:
        theta = _taylor_params(dtype)[1]
    bound = jnp.sum(jnp.abs(chains) * norms.astype(dtype), axis=-1)
    mx = jnp.max(bound)
    # NaN coefficients (diverged lanes): keep s finite; the NaNs still
    # propagate into the result so the controller rejects those lanes.
    mx = jnp.where(jnp.isfinite(mx), mx, theta)
    s = jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(mx / theta, 1.0))), 0, max_squarings
    ).astype(jnp.int32)
    cs = chains * jnp.asarray(2.0, dtype) ** (-s.astype(dtype))
    return cs, jnp.left_shift(jnp.ones((), jnp.int32), s)


def _stepper_wnorm(stepper, parts):
    """(w_row, post, kind) of the stepper's declared ``norm``
    (lc.WeightedNorm) over the widened-real layout, a widened-vector
    CALLABLE for a traced norm (lc.TracedNorm), or None. Raises for
    weights the batched tiers cannot lay out (the vmapped tier with a plain
    ``error_norm=`` callable handles those)."""
    wn = getattr(stepper, "norm", None)
    if wn is None:
        return None
    from ..lc import TracedNorm

    if isinstance(wn, TracedNorm):
        is_cplx = stepper.op.is_cplx

        def _traced_exec(dv):
            err = _unwiden(dv, is_cplx)
            if dv.ndim == 1:
                return wn(err)
            return wn.batched(err)

        return _traced_exec
    if not hasattr(wn, "kernel_parts"):
        raise TypeError(
            "norm= must be a DECLARED lc.WeightedNorm (batched steppers "
            "execute it natively); opaque callables go through "
            "error_norm= on a non-batched stepper"
        )
    kp = wn.kernel_parts(parts[0].shape[-1], len(parts))
    if kp is None:
        raise ValueError(
            "WeightedNorm.weights must be a single per-(complex-)component "
            f"array of length {parts[0].shape[-1]} for the batched "
            "tiers; pass the norm as error_norm= on a non-batched stepper "
            "for arbitrary pytree weights"
        )
    return kp


def _apply_chains(op: ModulatedOperator, basis_w, norms, chains, x, *,
                  m, max_squarings, wnorm=None):
    """Run the chain-exponential action (ops/chain.py) on state x.

    chains: (..., C, R, K) coefficient rows; chain 0 is the advance result,
    chain 1 (if present) the embedded comparison whose distance to chain 0
    is returned as the per-trajectory error norm. Works for scalar AND
    natively-batched (t, x, dt).
    """
    parts = (x.re, x.im) if op.is_cplx else (x,)
    dtype = parts[0].dtype
    m, theta = _taylor_params(dtype, m)
    xw = _widen(x, op.is_cplx)
    cs, n_pass = _scale_chains(chains.astype(dtype), norms, dtype,
                               max_squarings, theta)
    y, e = chain_expmv_xla(cs, n_pass, xw, basis_w.astype(dtype), m=m,
                           wnorm=wnorm)
    return _unwiden(y, op.is_cplx), e


@dataclasses.dataclass(frozen=True)
class MidpointModulated:
    """Exponential midpoint (Magnus-2) on a modulated operator: the
    propagator action e^{dt A(t+dt/2)} x via shared-basis Taylor — no dense
    operator, no expm (cf. magnus.rs:10-26 for the generic semantics)."""

    op: ModulatedOperator
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16

    nfev_per_step: int = 1
    # step math is pure trailing-axis broadcasting, so the same step_fn
    # serves scalar solves AND the batched-carry ensemble driver (which
    # avoids the vmapped driver's higher per-iteration overhead)
    is_batched = True
    # err comes back as a per-trajectory NORM, not an
    # error vector — the driver applies error_norm=identity (the same
    # convention as ops.modulated_rk.FusedModulatedLinearRK)
    error_norm = staticmethod(lambda e: e)
    prefers_packed_carry = True   # many-GEMM loop body (ROADMAP D4)

    def make_step_fn(self, op_fn=None):
        basis_w = _real_basis(self.op.basis)
        norms = jnp.max(jnp.sum(jnp.abs(basis_w), axis=-2), axis=-1)

        def step_fn(t, x, dt):
            g = self.op.coeff_fn(t + 0.5 * dt)               # (..., K)
            dt1 = jnp.asarray(dt)[..., None]
            chains = (dt1 * g)[..., None, None, :]
            xf, _ = _apply_chains(
                self.op, basis_w, norms, chains, x,
                m=self.m, max_squarings=self.max_squarings,
            )
            return xf, None

        return step_fn

@dataclasses.dataclass(frozen=True)
class MagnusModulated4:
    """Magnus-4 on a modulated operator (generic semantics: magnus.rs:28-83,
    with the error norm wired correctly as in exp/magnus.py).

    The per-step commutator [A(t1), A(t2)] collapses onto the PRECOMPUTED
    commutator basis [M_j, M_k]; the order-4 and order-2 propagator actions
    run as two coefficient lanes of one shared-basis Taylor apply."""

    op: ModulatedOperator
    adaptive: bool = True
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16
    # declared error norm (lc.WeightedNorm) — executed natively on every
    # tier (reference NormFn, cfm.rs:131-155)
    norm: Optional[Any] = None
    # estimate the error as w2*xf (leading term of the order-2/4 gap; ONE
    # basis contraction on the advanced state) instead of propagating the
    # order-2 comparison chain: nearly halves the per-step Taylor work.
    # Same semantics as exp/magnus.py Magnus4(fast_error=True) — exact
    # f64 parity with it; opt-in (different error CONSTANT than the pair)
    fast_error: bool = False

    nfev_per_step: int = 2
    is_batched = True     # see MidpointModulated
    error_norm = staticmethod(lambda e: e)
    prefers_packed_carry = True

    def __post_init__(self):
        ext, pairs = self.op.commutator_extension()
        object.__setattr__(self, "_ext_basis_w", _real_basis(ext))
        object.__setattr__(self, "_pairs", pairs)

    def make_step_fn(self, op_fn=None):
        basis_w = self._ext_basis_w
        pairs = self._pairs
        norms = jnp.max(jnp.sum(jnp.abs(basis_w), axis=-2), axis=-1)

        K0 = self.op.n_terms
        adaptive = self.adaptive
        fast_err = adaptive and self.fast_error

        def step_fn(t, x, dt):
            dt1 = jnp.asarray(dt)[..., None]                 # (..., 1)
            t_mid = t + 0.5 * dt
            g1 = self.op.coeff_fn(t_mid - _C_MID * dt)       # (..., K)
            g2 = self.op.coeff_fn(t_mid + _C_MID * dt)

            w1 = 0.5 * dt1 * (g1 + g2)                       # (..., K)
            if pairs:
                j = np.array([p[0] for p in pairs])
                k = np.array([p[1] for p in pairs])
                w2 = (_B2 * dt1 * dt1) * (
                    g1[..., j] * g2[..., k] - g1[..., k] * g2[..., j]
                )                                            # (..., P)
            else:
                w2 = jnp.zeros(w1.shape[:-1] + (0,), w1.dtype)
            main = jnp.concatenate([w1, w2], axis=-1)        # (..., K + P)
            if not adaptive or fast_err:
                chains = main[..., None, None, :]            # (..., 1, 1, K')
            else:
                low = jnp.concatenate([w1, jnp.zeros_like(w2)], axis=-1)
                chains = jnp.stack([main, low], axis=-2)[..., :, None, :]
            wn = _stepper_wnorm(
                self, (x.re, x.im) if self.op.is_cplx else (x,))
            xf, e = _apply_chains(
                self.op, basis_w, norms, chains, x,
                m=self.m, max_squarings=self.max_squarings,
                # C=1 under fast_err: the pair error (and its norm) is
                # not computed there — the estimate below owns the norm
                wnorm=None if fast_err else wn,
            )
            if fast_err:
                # dv = w2*xf over the commutator sub-basis (magnus.py
                # fast_error semantics, exact f64 parity)
                from ..lc import apply_weighted_norm

                xw = _widen(xf, self.op.is_cplx)
                comm_w = basis_w[K0:].astype(xw.dtype)
                mv = jnp.einsum("kij,...j->...ki", comm_w, xw,
                                precision=HIGHEST)
                dv = jnp.einsum("...k,...ki->...i", w2.astype(xw.dtype),
                                mv, precision=HIGHEST)
                e = apply_weighted_norm(dv, wn)
            return xf, e

        return step_fn

@dataclasses.dataclass(frozen=True)
class MagnusModulated6:
    """Magnus-6 (Yoshida triple-jump of the symmetric Magnus-4 step, see
    exp/magnus.py:magnus6_step) on a modulated operator. The three
    sub-interval exponents and the embedded full-interval Magnus-4
    comparison all collapse onto the shared commutator-extended basis:
    main chain = 3 coefficient rows, error chain = [full-M4 row, 0, 0]
    (e^0 = I exactly), one chain action per step. No order-6 scheme exists
    anywhere in the reference."""

    op: ModulatedOperator
    adaptive: bool = True
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16
    norm: Optional[Any] = None   # declared WeightedNorm, see MagnusModulated4

    is_batched = True     # see MidpointModulated
    error_norm = staticmethod(lambda e: e)
    prefers_packed_carry = True

    @property
    def nfev_per_step(self) -> int:
        # 3 sub-intervals x 2 GL nodes, plus the 2 full-interval comparison
        # nodes only in adaptive mode
        return 8 if self.adaptive else 6

    def __post_init__(self):
        ext, pairs = self.op.commutator_extension()
        object.__setattr__(self, "_ext_basis_w", _real_basis(ext))
        object.__setattr__(self, "_pairs", pairs)

    def _node_times(self, t, dt):
        """8 GL2 sample times: (sub0_a, sub0_b, sub1_a, sub1_b, sub2_a,
        sub2_b[, full_a, full_b])."""
        ts = []
        for off, ln in zip(_SUB_OFF, _SUB_LEN):
            tm = t + (off + 0.5 * ln) * dt
            ts += [tm - _C_MID * ln * dt, tm + _C_MID * ln * dt]
        if self.adaptive:
            tm = t + 0.5 * dt
            ts += [tm - _C_MID * dt, tm + _C_MID * dt]
        return ts

    def make_step_fn(self, op_fn=None):
        basis_w = self._ext_basis_w
        pairs = self._pairs
        norms = jnp.max(jnp.sum(jnp.abs(basis_w), axis=-2), axis=-1)
        adaptive = self.adaptive

        def step_fn(t, x, dt):
            dt1 = jnp.asarray(dt)[..., None]                 # (..., 1)
            gs = [self.op.coeff_fn(tn) for tn in self._node_times(t, dt)]

            def m4_row(ga, gb, dts):
                w1 = 0.5 * dts * (ga + gb)                   # (..., K)
                if pairs:
                    j = np.array([p[0] for p in pairs])
                    k = np.array([p[1] for p in pairs])
                    w2 = (_B2 * dts * dts) * (
                        ga[..., j] * gb[..., k] - ga[..., k] * gb[..., j]
                    )
                else:
                    w2 = jnp.zeros(w1.shape[:-1] + (0,), w1.dtype)
                return jnp.concatenate([w1, w2], axis=-1)    # (..., K + P)

            main = jnp.stack(
                [m4_row(gs[2 * i], gs[2 * i + 1], float(_SUB_LEN[i]) * dt1)
                 for i in range(3)], axis=-2)                # (..., 3, K')
            if not adaptive:
                chains = main[..., None, :, :]               # (..., 1, 3, K')
            else:
                full = m4_row(gs[6], gs[7], dt1)
                err = jnp.concatenate(
                    [full[..., None, :],
                     jnp.zeros(full.shape[:-1] + (2, full.shape[-1]),
                               full.dtype)], axis=-2)        # (..., 3, K')
                chains = jnp.stack([main, err], axis=-3)     # (..., 2, 3, K')
            return _apply_chains(
                self.op, basis_w, norms, chains, x,
                m=self.m, max_squarings=self.max_squarings,
                wnorm=_stepper_wnorm(
                    self, (x.re, x.im) if self.op.is_cplx else (x,)),
            )

        return step_fn

@dataclasses.dataclass(frozen=True)
class CFMModulated:
    """Commutator-free Magnus on a modulated operator (generic semantics:
    cfm_general, cfm.rs:43-100). Each exponential's operator is a pure basis
    lincomb: rho_i = dt * sum_j alpha[i, j] * c(t + c_j dt) — no dense
    operator assembly, no expm.

    Applications within one chain are sequential (x_i = e^{rho_i} x_{i-1}),
    but the main and error chains both start from x, so round r applies the
    available lanes of both chains in ONE shared Taylor call."""

    op: ModulatedOperator
    alpha: tuple
    c: tuple
    alpha_err: Optional[tuple] = None
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16
    norm: Optional[Any] = None   # declared WeightedNorm, see MagnusModulated4

    is_batched = True     # see MidpointModulated
    error_norm = staticmethod(lambda e: e)
    prefers_packed_carry = True

    @property
    def nfev_per_step(self) -> int:
        return len(self.c)

    def make_step_fn(self, op_fn=None):
        basis_w = _real_basis(self.op.basis)
        alpha = np.asarray(self.alpha)
        c_nodes = np.asarray(self.c)
        alpha_err = (
            None if self.alpha_err is None else np.asarray(self.alpha_err)
        )
        n_main = alpha.shape[0]
        n_err = 0 if alpha_err is None else alpha_err.shape[0]

        if n_err > n_main:
            raise ValueError(
                "error chain longer than the main chain is unsupported "
                f"({n_err} > {n_main})"
            )
        norms = jnp.max(jnp.sum(jnp.abs(basis_w), axis=-2), axis=-1)

        def step_fn(t, x, dt):
            dt1 = jnp.asarray(dt)[..., None]                 # (..., 1)
            gs = [self.op.coeff_fn(t + float(cj) * dt) for cj in c_nodes]

            g = jnp.stack(gs, axis=-2)                       # (..., J, K)
            # HIGHEST: these coefficients become exponents; default-precision
            # bf16 passes would poison the embedded error estimates
            rho = dt1[..., None] * jnp.einsum(
                "sj,...jk->...sk", jnp.asarray(alpha, g.dtype), g,
                precision=HIGHEST,
            )                                               # (..., s, K)
            if alpha_err is None:
                chains = rho[..., None, :, :]                # (..., 1, s, K)
            else:
                rho_err = dt1[..., None] * jnp.einsum(
                    "sj,...jk->...sk", jnp.asarray(alpha_err, g.dtype), g,
                    precision=HIGHEST,
                )                                           # (..., s_err, K)
                # pad the error chain with ZERO rows (e^0 = I exactly) so
                # both chains run the same number of rounds in one action
                pad = jnp.zeros(
                    rho_err.shape[:-2] + (n_main - n_err, rho_err.shape[-1]),
                    rho_err.dtype,
                )
                chains = jnp.stack(
                    [rho, jnp.concatenate([rho_err, pad], axis=-2)], axis=-3
                )                                           # (..., 2, s, K)
            return _apply_chains(
                self.op, basis_w, norms, chains, x,
                m=self.m, max_squarings=self.max_squarings,
                wnorm=_stepper_wnorm(
                    self, (x.re, x.im) if self.op.is_cplx else (x,)),
            )

        return step_fn

def CFM4Modulated(op: ModulatedOperator, *, adaptive: bool = True,
                  m: Optional[int] = None, max_squarings: int = 16,
                  norm: Optional[Any] = None) -> CFMModulated:
    """The reference ExpCFMSolver configuration (cfm.rs:131-162) on the
    modulated fast path: order 4/2 pair on 2-node Gauss-Legendre.
    ``norm``: a declared lc.WeightedNorm — the reference's user NormFn
    (cfm.rs:131-155), executed natively on every tier."""
    from .. import tableaus as tb

    return CFMModulated(
        op=op,
        alpha=tuple(map(tuple, tb.CFM_R4_J2_GL)),
        c=tuple(tb.C_GAUSS_LEGENDRE_4),
        alpha_err=tuple(map(tuple, tb.CFM_R2_J1_GL)) if adaptive else None,
        m=m,
        max_squarings=max_squarings,
        norm=norm,
    )
