"""Split-operator solvers for dx/dt = (A(t) + B(t)) x.

Counterpart of ``/root/reference/src/exp/split_exp.rs:520-706``.
The operator-assembly callback is ``ops_fn(t) -> (La, Lb)``.

Reference-bug fix (SURVEY.md §2.3(7)): the reference's ``split_exp_midpoint``
scales KB[0] by dt/2 instead of dt (split_exp.rs:540-546; the commented-out
line 548-549 shows the intent) and samples the operators at t rather than
t + dt/2 (split_exp.rs:542). The default here is the *correct* Strang
midpoint e^{A dt/2} e^{B dt} e^{A dt/2} with midpoint sampling;
``strict_reference_compat=True`` reproduces the reference's literal behavior
(B at half weight, sampling at t) for parity experiments.

``split_cfm_step`` completes the reference's unfinished CFM-over-splits path
(the kernel exists at split_exp.rs:568-609 but its ExpSplitCFMSolver shell,
split_exp.rs:688-706, was never wired to any solver trait).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .magnus import _DenseBatchedStepper
from .protocol import ExponentialSplit


class _SplitBatched(_DenseBatchedStepper):
    """Batched-execution surface for the split solvers: engages when BOTH
    sub-splits are dense leaves of the same representation; the whole
    factor palindrome then runs as one stacked batched expm per step
    (exp/dense_fast.py)."""

    @property
    def split(self):
        # state widening conventions follow sp_a (both match, enforced)
        return self.sp_a

    def _both_dense(self) -> bool:
        return (
            getattr(self.sp_a, "supports_batched_dense", False)
            and getattr(self.sp_b, "supports_batched_dense", False)
            and getattr(self.sp_a, "is_cplx_split", False)
            == getattr(self.sp_b, "is_cplx_split", False)
        )

    @property
    def is_batched(self) -> bool:
        if self.batched is not None:
            if self.batched and not self._both_dense():
                raise ValueError(
                    "batched=True requires BOTH sub-splits to be dense "
                    "leaves of the same representation (DenseSplit / "
                    "DenseCplxSplit)"
                )
            return self.batched
        return self._both_dense()

    def _batched_mode(self, t) -> bool:
        return jnp.ndim(t) >= 1 and self.is_batched and self._both_dense()


def _split_midpoint_batched_step(assemble, sp_a, sp_b, t, x, dt, *,
                                 strict, max_squarings=16):
    """Batched Strang midpoint over dense pairs: the three factors run as
    one stacked batched expm per step (exp/dense_fast.py)."""
    from . import dense_fast as df

    ts = t if strict else t + 0.5 * dt
    la, lb = assemble(ts)
    EA = df.embed_node(sp_a, la)
    EB = df.embed_node(sp_b, lb)
    w_b = 0.5 if strict else 1.0     # reference's dt/2 bug under strict

    def xla_chains():
        dt3 = dt[..., None, None].astype(EA.dtype)
        return [[0.5 * dt3 * EA, w_b * dt3 * EB, 0.5 * dt3 * EA]]

    return df.run_batched_chains(
        sp_a, x, dt, xla_chains,
        adaptive=False, max_squarings=max_squarings,
    )


def _split_cfm_batched_step(assemble, sp_a, sp_b, t, x, dt, rho, sigma, c,
                            *, max_squarings=16):
    """Batched CFM-over-splits: the full BAB factor sequence
    expB(sigma_s) expA(rho_{s-1}) ... expB(sigma_0) as ONE stacked
    batched expm per step."""
    from . import dense_fast as df

    J = len(c)
    Es_a, Es_b = [], []
    for cj in c:
        la, lb = assemble(t + float(cj) * dt)
        Es_a.append(df.embed_node(sp_a, la))
        Es_b.append(df.embed_node(sp_b, lb))

    def _row(mats, coeffs, scale):
        acc = None
        for j in range(J):
            if coeffs[j] == 0.0:
                continue
            term = float(coeffs[j]) * mats[j]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = jnp.zeros_like(mats[0])
        return scale * acc

    def _chain(mats_a, mats_b, scale):
        rows = []
        for i in range(rho.shape[0]):
            rows.append(_row(mats_b, sigma[i], scale))
            rows.append(_row(mats_a, rho[i], scale))
        rows.append(_row(mats_b, sigma[-1], scale))
        return [rows]

    def xla_chains():
        dt3 = dt[..., None, None].astype(Es_a[0].dtype)
        return _chain(Es_a, Es_b, dt3)

    return df.run_batched_chains(
        sp_a, x, dt, xla_chains,
        adaptive=False, max_squarings=max_squarings,
    )


def split_midpoint_step(
    ops_fn, sp_a, sp_b, t, x, dt, *, strict_reference_compat=False
):
    """Strang-type split midpoint step (split_exp.rs:520-562)."""
    if strict_reference_compat:
        la, lb = ops_fn(t)                       # reference samples at t
        b_weight = 0.5 * dt                      # reference's dt/2 bug
    else:
        la, lb = ops_fn(t + 0.5 * dt)            # midpoint sampling
        b_weight = dt
    ua = sp_a.exp(sp_a.scale_l(la, 0.5 * dt))
    ub = sp_b.exp(sp_b.scale_l(lb, b_weight))
    y = sp_a.map_exp(ua, x)
    y = sp_b.map_exp(ub, y)
    y = sp_a.map_exp(ua, y)
    return y, None


def split_cfm_step(ops_fn, sp_a, sp_b, t, x, dt, rho, sigma, c):
    """BAB CFM step over a split (split_exp.rs:568-609).

    rho: (s, k) A-coefficients; sigma: (s+1, k) B-coefficients; c: (k,) nodes.
    x <- expB(sigma[s]) expA(rho[s-1]) ... expB(sigma[1]) expA(rho[0])
         expB(sigma[0]) x, each exponent dt * sum_j coeff[j] * L(t_j).
    """
    from .cfm import cfm_exp

    rho = np.asarray(rho)
    sigma = np.asarray(sigma)
    c = np.asarray(c)
    if rho.ndim != 2 or sigma.ndim != 2:
        raise ValueError(
            "split_cfm: rho and sigma must be 2-D (rows of quadrature "
            f"coefficients); got shapes {rho.shape} and {sigma.shape} — "
            "wrap a single row as ((...),)"
        )
    if rho.shape[1] != len(c) or sigma.shape[1] != len(c):
        raise ValueError("split_cfm: incompatible array dimensions")
    if sigma.shape[0] != rho.shape[0] + 1:
        raise ValueError("split_cfm: sigma must have one more row than rho")

    t_nodes = jnp.stack([t + float(ci) * dt for ci in c])
    l_nodes = jax.vmap(ops_fn)(t_nodes)
    va = [
        jax.tree_util.tree_map(lambda a, j=j: a[j], l_nodes[0])
        for j in range(len(c))
    ]
    vb = [
        jax.tree_util.tree_map(lambda a, j=j: a[j], l_nodes[1])
        for j in range(len(c))
    ]

    y = x
    for i in range(rho.shape[0]):
        y = cfm_exp(sp_b, y, dt, vb, sigma[i])
        y = cfm_exp(sp_a, y, dt, va, rho[i])
    y = cfm_exp(sp_b, y, dt, vb, sigma[-1])
    return y, None


@dataclasses.dataclass(frozen=True)
class SplitMidpoint(_SplitBatched):
    """Fixed-step split midpoint (ExpSplitMidpointSolver,
    split_exp.rs:613-685). Over dense pairs, ensembles execute natively
    batched (see _SplitBatched)."""

    sp_a: ExponentialSplit
    sp_b: ExponentialSplit
    strict_reference_compat: bool = False
    ops_fn: Callable = None
    batched: Optional[bool] = None   # None = auto (see _SplitBatched)
    max_squarings: int = 16

    nfev_per_step: int = 1

    def make_step_fn(self, ops_fn=None, params=None):
        fn = ops_fn if ops_fn is not None else self.ops_fn
        assemble = self._assembler(fn, params)

        def step_fn(t, x, dt):
            if self._batched_mode(t):
                return _split_midpoint_batched_step(
                    assemble, self.sp_a, self.sp_b, t, x, dt,
                    strict=self.strict_reference_compat,
                    max_squarings=self.max_squarings,
                )
            if params is not None:
                raise ValueError("params requires the batched driver")
            return split_midpoint_step(
                fn, self.sp_a, self.sp_b, t, x, dt,
                strict_reference_compat=self.strict_reference_compat,
            )

        return step_fn


@dataclasses.dataclass(frozen=True)
class SplitCFM(_SplitBatched):
    """CFM-over-splits stepper (completes the reference's dead
    ExpSplitCFMSolver, split_exp.rs:688-706). Over dense pairs, ensembles
    execute natively batched (see _SplitBatched)."""

    sp_a: ExponentialSplit
    sp_b: ExponentialSplit
    rho: tuple
    sigma: tuple
    c: tuple
    ops_fn: Callable = None
    batched: Optional[bool] = None   # None = auto (see _SplitBatched)
    max_squarings: int = 16

    @property
    def nfev_per_step(self) -> int:
        return len(self.c)

    def make_step_fn(self, ops_fn=None, params=None):
        fn = ops_fn if ops_fn is not None else self.ops_fn
        assemble = self._assembler(fn, params)
        rho = np.asarray(self.rho)
        sigma = np.asarray(self.sigma)

        def step_fn(t, x, dt):
            if self._batched_mode(t):
                return _split_cfm_batched_step(
                    assemble, self.sp_a, self.sp_b, t, x, dt,
                    rho, sigma, np.asarray(self.c),
                    max_squarings=self.max_squarings,
                )
            if params is not None:
                raise ValueError("params requires the batched driver")
            return split_cfm_step(
                fn, self.sp_a, self.sp_b, t, x, dt,
                self.rho, self.sigma, self.c,
            )

        return step_fn
