"""Automatic structure detection for black-box operator callbacks.

The reference's exponential solvers only ever see an opaque callback
``Fun: FnMut(&[T]) -> Vec<L>`` (magnus.rs:32, cfm.rs:54). That generic
contract has a hard FLOP floor (per-trajectory dense propagators; see
exp/dense_fast.py) — but nearly every PHYSICAL time-dependent operator
actually lives in a low-dimensional matrix subspace:

    A(t) = sum_k c_k(t) * M_k,    K small (driven Hamiltonians: K = 2-4).

:func:`auto_modulated` recovers that structure from the black box alone —
sample A(t) at probe times, SVD the sample matrix over the REAL vector
space of (re, im) matrix pairs, keep the numerical row space — and returns
a :class:`~vec_ode_tpu.exp.modulated.ModulatedOperator` whose ``coeff_fn``
projects A(t) onto the recovered orthonormal basis (one operator assembly
+ one (2d^2, K) matmul per quadrature node). The result plugs into the
shared-basis fast steppers (MagnusModulated4 / CFM4Modulated / ...), whose
steps are shared-matrix GEMMs instead of per-trajectory expms — so a
black-box user recovers the structured path whenever the structure exists,
with the dense path as the honest fallback when it does not.

The detection is exact-rank, not approximation: candidates are validated
at held-out probe times and ``None`` is returned unless the reconstruction
is tight (relative residual <= ``validate_tol``), so a falsely-"structured"
operator can never silently corrupt an integration.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import Cplx
from ..utils.prec import HIGHEST
from .modulated import ModulatedOperator


def _vec_host(L, is_cplx: bool) -> np.ndarray:
    if is_cplx:
        return np.concatenate([
            np.asarray(L.re, np.float64).ravel(),
            np.asarray(L.im, np.float64).ravel(),
        ])
    return np.asarray(L, np.float64).ravel()


def auto_modulated(
    op_fn: Callable,
    t0: float,
    tf: float,
    *,
    k_max: int = 8,
    n_probe: Optional[int] = None,
    rank_tol: float = 1e-7,
    validate_tol: float = 1e-5,
    dtype=None,
) -> Optional[ModulatedOperator]:
    """Recover ``A(t) = sum_k c_k(t) M_k`` structure from a black-box
    ``op_fn(t) -> L`` (L: Cplx (d, d) pair or real (d, d) array).

    Returns a ModulatedOperator on success, or None when the operator's
    range over [t0, tf] is not (numerically) contained in a <= k_max
    dimensional matrix subspace — callers should then keep the generic
    dense stepper.

    Host-side, call once at setup (outside jit): evaluates ``op_fn`` at
    ``n_probe`` concrete times. The returned ``coeff_fn`` evaluates
    ``op_fn`` per quadrature node and projects — traced, batched via an
    internal vmap for (B,)-shaped times.
    """
    if n_probe is None:
        n_probe = 2 * k_max + 8
    t0f, tff = float(t0), float(tf)
    # probe grid: uniform + golden-ratio-offset midpoints held out for
    # validation (an equispaced-only grid can alias periodic coefficients)
    ts_fit = np.linspace(t0f, tff, n_probe)
    phi = 0.6180339887498949
    ts_val = t0f + ((np.arange(1, k_max + 5) * phi) % 1.0) * (tff - t0f)

    sample0 = op_fn(ts_fit[0])
    is_cplx = isinstance(sample0, Cplx)
    if dtype is None:
        dtype = (sample0.re if is_cplx else jnp.asarray(sample0)).dtype
    d = (sample0.re if is_cplx else np.asarray(sample0)).shape[-1]

    S = np.stack(
        [_vec_host(sample0, is_cplx)]
        + [_vec_host(op_fn(float(t)), is_cplx) for t in ts_fit[1:]]
    )
    if not np.all(np.isfinite(S)):
        return None
    _, sig, Vt = np.linalg.svd(S, full_matrices=False)
    if sig.size == 0 or sig[0] == 0.0:
        return None  # identically zero operator: nothing to modulate
    K = int(np.sum(sig > rank_tol * sig[0]))
    if K == 0 or K > k_max:
        return None
    V = Vt[:K]                        # (K, n_vec) orthonormal rows

    # validation at held-out times: projection must reconstruct A(t)
    for t in ts_val:
        v = _vec_host(op_fn(float(t)), is_cplx)
        nrm = np.linalg.norm(v)
        if nrm == 0.0:
            continue
        resid = np.linalg.norm(v - V.T @ (V @ v)) / nrm
        if not np.isfinite(resid) or resid > validate_tol:
            return None

    if is_cplx:
        basis = Cplx(
            jnp.asarray(V[:, : d * d].reshape(K, d, d), dtype),
            jnp.asarray(V[:, d * d:].reshape(K, d, d), dtype),
        )
    else:
        basis = jnp.asarray(V.reshape(K, d, d), dtype)
    V_j = jnp.asarray(V.T, dtype)     # (n_vec, K)

    def coeff_fn(t):
        t = jnp.asarray(t)
        if t.ndim > 0:                # batched quadrature-node times
            return jax.vmap(coeff_fn)(t)
        L = op_fn(t)
        v = (
            jnp.concatenate([L.re.ravel(), L.im.ravel()])
            if is_cplx else jnp.asarray(L).ravel()
        ).astype(dtype)
        return jnp.matmul(v, V_j, precision=HIGHEST)   # (K,)

    return ModulatedOperator(basis=basis, coeff_fn=coeff_fn)
