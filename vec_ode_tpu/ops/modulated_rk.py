"""Batched Runge-Kutta step for modulated-linear ensembles.

The flagship workload (BASELINE config 5) is an ensemble of independent
trajectories of dx/dt = (A0 + u(t) A1) x with SHARED matrices A0, A1 and a
per-trajectory scalar modulation u(t) (e.g. a driven Hamiltonian
H(t) = H0 + cos(wt) V in real-pair representation).

``xla_rk_step`` takes the whole embedded step over the (B, D) batch at
once: each stage evaluation is two shared-matrix (B, D) @ (D, D) GEMMs in
full f32 (``utils/prec.py``), and the stage combinations, the embedded error
and its per-trajectory norm are elementwise work that XLA fuses around them.
The driver consumes the (B,) error norm directly.

A hand-written Pallas-Triton kernel of the same step (all stages in one
kernel, full-f32 FMA dots) was measured on an H100 against this XLA step
and lost by more than an order of magnitude end to end, so the step is plain
XLA (PERF.md, Findings).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..tableaus import RKF45, ButcherTableau
from ..utils.prec import HIGHEST
from .chain import row_matmul as _row_matmul


def xla_rk_step(t, dt, xw, M0, M1, *, u_fn, tab=RKF45, advance_lower=True,
                wnorm=None):
    """One embedded RK step over the whole ensemble: (xw_next (B, D),
    err_norm (B,) or None without an embedded pair). ``wnorm=(w_row, post,
    kind)`` (lc.WeightedNorm.kernel_parts): the error norm becomes
    post * ||w_row * err|| with kind "l2" or "max"."""
    s = tab.stages
    dtc = dt[:, None]
    tc = t[:, None]

    def f(ti, xi):
        u = u_fn(ti)
        return _row_matmul(xi, M0) + u * _row_matmul(xi, M1)

    K = [None] * s
    K[0] = f(tc, xw)
    for i in range(1, s):
        ti = tc + float(tab.c[i]) * dtc
        acc = None
        for j in range(i):
            if tab.a[i, j] == 0.0:
                continue
            term = float(tab.a[i, j]) * K[j]
            acc = term if acc is None else acc + term
        xi = xw if acc is None else xw + dtc * acc
        K[i] = f(ti, xi)
    x_b = xw + dtc * sum(float(tab.b[j]) * K[j] for j in range(s)
                         if tab.b[j] != 0.0)
    if tab.b_err is None:
        return x_b, None
    db = tab.b - tab.b_err
    err = dtc * sum(float(db[j]) * K[j] for j in range(s) if db[j] != 0.0)
    x_next = (x_b - err) if advance_lower else x_b
    from ..lc import apply_weighted_norm

    return x_next, apply_weighted_norm(err, wnorm, axis=1)


@dataclasses.dataclass(frozen=True)
class FusedModulatedLinearRK:
    """Natively-batched stepper for dx/dt = (A0 + u(t) A1) x over Cplx pairs.

    Plugs into the batched driver (``is_batched=True``): states are Cplx
    (B, d) pairs widened to (B, 2d) internally, the step returns the
    per-trajectory error norm directly (``error_norm`` = identity).
    """

    M0: jax.Array               # (2d, 2d) embedded -i*H0 (or A0)
    M1: jax.Array               # (2d, 2d) embedded -i*V (or A1)
    u_fn: Callable              # (B, 1) times -> (B, 1) modulation
    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    # declared error norm (lc.WeightedNorm) — executed natively by the
    # step (reference NormFn, cfm.rs:131-155)
    norm: Optional[object] = None

    is_batched = True
    error_norm = staticmethod(lambda e: e)

    def _wnorm(self, d: int):
        """(w_row, post, kind) of the declared ``norm`` over the widened
        [re | im] layout (lc.WeightedNorm.kernel_parts), or None. Raises
        for weights the batched layout cannot express."""
        if self.norm is None:
            return None
        if not hasattr(self.norm, "kernel_parts"):
            raise TypeError(
                "norm= must be a DECLARED lc.WeightedNorm (this batched "
                "stepper executes it inside its step)")
        kp = self.norm.kernel_parts(d, 2)
        if kp is None:
            raise ValueError(
                "WeightedNorm.weights must be a single per-(complex-)"
                f"component array of length {d} for this batched stepper"
            )
        return kp

    @property
    def nfev_per_step(self) -> int:
        return self.tableau.stages

    @staticmethod
    def from_driven_dense(model, dtype=jnp.float32, **kw):
        """Build from a models.quantum.DrivenDense (H(t) = H0 + cos(wt) V).

        The embedded matrices are kept as host numpy constants, baked
        into the jitted program at trace time."""

        def embed_np(re, im):
            return np.block([[re, -im], [im, re]])

        np_dtype = np.dtype(jnp.zeros((), dtype).dtype.name)
        H0r, H0i = model.H0.real.astype(np_dtype), model.H0.imag.astype(np_dtype)
        Vr, Vi = model.V.real.astype(np_dtype), model.V.imag.astype(np_dtype)
        # -i H = (Hi, -Hr) as a (re, im) pair
        M0 = embed_np(H0i, -H0r)
        M1 = embed_np(Vi, -Vr)
        w = float(model.w)
        return FusedModulatedLinearRK(
            M0=M0, M1=M1, u_fn=lambda t: jnp.cos(w * t), **kw
        )

    def hermite_slope(self, t, x):
        """Endpoint slope f(t, x) = (M0 + u(t) M1) x for dense-output
        Hermite interpolation (parallel.ensemble._batched_dense_fallback);
        Cplx in/out over the widened real embed."""
        from ..ops.cplx import Cplx

        xw = jnp.concatenate([x.re, x.im], axis=-1)
        M0w = jnp.asarray(self.M0, xw.dtype)
        M1w = jnp.asarray(self.M1, xw.dtype)
        u = jnp.asarray(self.u_fn(t))[..., None]
        fw = (jnp.einsum("...j,ij->...i", xw, M0w, precision=HIGHEST)
              + u * jnp.einsum("...j,ij->...i", xw, M1w,
                               precision=HIGHEST))
        d = x.re.shape[-1]
        return Cplx(fw[..., :d], fw[..., d:])

    def make_step_fn(self, rhs=None):
        if rhs is not None:
            raise ValueError(
                "FusedModulatedLinearRK embeds its own RHS; pass rhs=None"
            )
        has_err = self.tableau.b_err is not None

        def step_fn(t, x, dt):
            from ..ops.cplx import Cplx

            d = x.re.shape[-1]
            xw = jnp.concatenate([x.re, x.im], axis=-1)
            ox, oe = xla_rk_step(
                t, dt, xw, self.M0, self.M1,
                u_fn=self.u_fn, tab=self.tableau,
                advance_lower=self.advance_lower,
                wnorm=self._wnorm(d),
            )
            # no embedded pair -> no error estimate: return None so the
            # adaptive driver raises instead of silently accepting on a
            # zero-valued estimate (matches rk.rk_step)
            return Cplx(ox[..., :d], ox[..., d:]), (oe if has_err else None)

        return step_fn
