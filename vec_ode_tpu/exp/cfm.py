"""Commutator-free Magnus (CFM) steppers.

JAX counterpart of ``/root/reference/src/exp/cfm.rs``. A CFM step
samples A(t) at quadrature nodes t + c_j dt and applies s exponentials of
linear combinations of the samples:

    x_{i} = exp(dt * sum_j alpha[i][j] A(t_j)) x_{i-1}      (cfm.rs:20-40)

The adaptive pair runs a lower-order pass (alpha_err) from the same samples
and uses err = x_err - xf (cfm.rs:83-97). The reference wires this solver's
norm correctly (cfm.rs:193-195) — behavior preserved.

Coefficient sets shipped (dat/mod.rs:66-81):
  * CFM4: alpha = CFM_R4_J2_GL (2 exps x 2 GL nodes, order 4),
    alpha_err = CFM_R2_J1_GL (1 exp, order 2) — the reference's ExpCFMSolver
    configuration (cfm.rs:131-155).
  * CFM4_BLANES17: alpha = BLANES17_R4_J4 (4 exps x 3 GL nodes) — defined but
    unused in the reference; wired up here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import tableaus as tb
from .magnus import _DenseBatchedStepper
from .protocol import ExponentialSplit


def cfm_exp(split, x, dt, samples, a_row):
    """One CFM exponential: x <- exp(dt * sum_j a_j M_j) x (cfm.rs:20-40).

    ``samples`` is a list of operator pytrees (A at the quadrature nodes)."""
    k = split.lincomb_l(samples, list(a_row))
    u = split.exp(split.scale_l(k, dt))
    return split.map_exp(u, x)


def cfm_step(
    op_fn,
    split: ExponentialSplit,
    t,
    x,
    dt,
    alpha: np.ndarray,
    c: np.ndarray,
    alpha_err: Optional[np.ndarray],
):
    """s-exponential CFM step with optional embedded error pass
    (cfm_general, cfm.rs:43-100).

    Economy: every exponential's OPERATOR depends only on the quadrature
    samples (not on the evolving state), so all s + s_err exponentials are
    computed upfront in ONE stacked batched expm (``exp_many``) and only the
    cheap propagator applications run sequentially — vs the reference's
    s + s_err separate exp calls (cfm.rs:74-97).
    """
    from .protocol import index_u

    c = np.asarray(c)
    t_nodes = jnp.stack([t + float(ci) * dt for ci in c])
    l_nodes = jax.vmap(op_fn)(t_nodes)
    samples = [
        jax.tree_util.tree_map(lambda a, j=j: a[j], l_nodes)
        for j in range(len(c))
    ]

    def row_op(a_row):
        k = split.lincomb_l(samples, list(a_row))
        return split.scale_l(k, dt)

    n_main = alpha.shape[0]
    rows = [row_op(alpha[i]) for i in range(n_main)]
    if alpha_err is not None:
        rows += [row_op(alpha_err[i]) for i in range(alpha_err.shape[0])]

    u_all = split.exp_many(rows) if len(rows) > 1 else None

    def u_at(i):
        return index_u(u_all, i) if u_all is not None else split.exp(rows[0])

    xf = x
    for i in range(n_main):
        xf = split.map_exp(u_at(i), xf)

    if alpha_err is None:
        return xf, None

    xe = x
    for i in range(alpha_err.shape[0]):
        xe = split.map_exp(u_at(n_main + i), xe)
    from .. import lc

    return xf, lc.sub(xe, xf)


def cfm_step_comp(op_fn, split, t, x, dt, alpha, c, alpha_err, lo):
    """Compensated (double-f32) CFM step (see :func:`cfm_step` / comp.py):
    main and error chains run in increment form via exp_m1, the embedded
    estimate is the difference of increments, and the advance folds into
    the (x, lo) pair."""
    from .. import comp, lc
    from .protocol import index_u

    c = np.asarray(c)
    t_nodes = jnp.stack([t + float(ci) * dt for ci in c])
    l_nodes = jax.vmap(op_fn)(t_nodes)
    samples = [
        jax.tree_util.tree_map(lambda a, j=j: a[j], l_nodes)
        for j in range(len(c))
    ]

    def row_op(a_row):
        k = split.lincomb_l(samples, list(a_row))
        return split.scale_l(k, dt)

    n_main = alpha.shape[0]
    rows = [row_op(alpha[i]) for i in range(n_main)]
    if alpha_err is not None:
        rows += [row_op(alpha_err[i]) for i in range(alpha_err.shape[0])]
    phis = split.exp_many_m1(rows) if len(rows) > 1 else None

    def phi_at(i):
        return index_u(phis, i) if phis is not None else split.exp_m1(
            rows[0])

    D = comp.chain_increment(
        split.map_exp, [phi_at(i) for i in range(n_main)], x
    )
    err = None
    if alpha_err is not None:
        De = comp.chain_increment(
            split.map_exp,
            [phi_at(n_main + i) for i in range(alpha_err.shape[0])], x,
        )
        err = lc.sub(De, D)
    hi, lo2 = comp.update(x, lo, D)
    return hi, err, lo2


def _cfm_batched_step(assemble, split, t, x, dt, alpha, c, alpha_err, *,
                      max_squarings=16, wnorm=None, lo=None):
    """Batched CFM on per-trajectory dense operators: all main + error
    exponentials in ONE stacked batched expm (exp/dense_fast.py). Unequal
    main/error chain lengths are native: no zero-row padding."""
    from . import dense_fast as df

    J = len(c)
    # ONE stacked assemble + embed for all quadrature nodes (halves/thirds
    # the sampling launches; callback stays scalar-time, cfm.rs:54)
    B = jnp.shape(t)[0] if jnp.ndim(t) else None
    ts = jnp.concatenate([t + float(cj) * dt for cj in c])
    E_all = df.embed_node(split, assemble(ts))
    Es = [E_all[j * B:(j + 1) * B] for j in range(J)]

    def _rows(mats, mat, scale):
        out = []
        for i in range(mat.shape[0]):
            acc = None
            for j in range(J):
                if mat[i, j] == 0.0:
                    continue
                term = float(mat[i, j]) * mats[j]
                acc = term if acc is None else acc + term
            if acc is None:      # all-zero row: exponent 0 (e^0 = I)
                acc = jnp.zeros_like(mats[0])
            out.append(scale * acc)
        return out

    def xla_chains():
        dt3 = dt[..., None, None].astype(Es[0].dtype)
        main = _rows(Es, alpha, dt3)
        if alpha_err is None:
            return [main]
        return [main, _rows(Es, alpha_err, dt3)]

    return df.run_batched_chains(
        split, x, dt, xla_chains,
        adaptive=alpha_err is not None, max_squarings=max_squarings,
        wnorm=wnorm, lo=lo,
    )


@dataclasses.dataclass(frozen=True)
class CFM(_DenseBatchedStepper):
    """Generic CFM stepper from coefficient matrices.

    alpha: (s, k) — s exponentials over k quadrature samples.
    c: (k,) — quadrature nodes on [0, 1].
    alpha_err: optional (s_err, k) embedded lower-order pass.

    Over a dense split, ensembles execute natively batched (see
    exp/magnus.py:_DenseBatchedStepper).
    """

    split: ExponentialSplit
    alpha: tuple
    c: tuple
    alpha_err: Optional[tuple] = None
    op_fn: Callable = None
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    norm: Optional[object] = None    # declared WeightedNorm (batched tier)
    compensated: bool = False  # double-f32 state pair (comp.py)

    @property
    def nfev_per_step(self) -> int:
        return len(self.c)

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)
        alpha = np.asarray(self.alpha)
        c = np.asarray(self.c)
        alpha_err = None if self.alpha_err is None else np.asarray(
            self.alpha_err
        )

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                return _cfm_batched_step(
                    assemble, self.split, t, x, dt, alpha, c, alpha_err,
                    max_squarings=self.max_squarings,
                    wnorm=self._wnorm_parts(x), lo=lo,
                )
            if params is not None:
                raise ValueError("params requires the batched driver")
            if self.norm is not None:
                raise ValueError(
                    "norm= runs on the batched dense tier; the scalar/"
                    "vmapped path takes the norm via error_norm=")
            if lo is not None:
                return cfm_step_comp(fn, self.split, t, x, dt, alpha, c,
                                     alpha_err, lo)
            return cfm_step(fn, self.split, t, x, dt, alpha, c, alpha_err)

        if self.compensated:
            return lambda t, x, dt, lo: step_core(t, x, dt, lo)
        return lambda t, x, dt: step_core(t, x, dt)


def _tupled(a):
    return tuple(map(tuple, np.asarray(a)))


def CFM4(split: ExponentialSplit, op_fn: Callable = None, *,
         adaptive: bool = True, **kw) -> CFM:
    """The reference ExpCFMSolver configuration (cfm.rs:131-162): order 4/2
    pair on 2-node Gauss-Legendre. ``adaptive=False`` is ``no_adaptive()``.
    Extra kwargs (batched / max_squarings / norm / compensated) pass
    through to :class:`CFM`."""
    return CFM(
        split=split,
        alpha=_tupled(tb.CFM_R4_J2_GL),
        c=tuple(tb.C_GAUSS_LEGENDRE_4),
        alpha_err=_tupled(tb.CFM_R2_J1_GL) if adaptive else None,
        op_fn=op_fn,
        **kw,
    )


def CFM4_BLANES17(split: ExponentialSplit, op_fn: Callable = None, *,
                  adaptive: bool = True, **kw) -> CFM:
    """Blanes 4-exponential order-4 CFM on 3-node Gauss-Legendre — the
    coefficient set the reference defines but never uses (dat/mod.rs:76-80)."""
    return CFM(
        split=split,
        alpha=_tupled(tb.BLANES17_R4_J4),
        c=tuple(tb.C_GAUSS_LEGENDRE_6),
        # order-2 error pass: one exponential of the full GL-3 quadrature of
        # A (weights 5/18, 4/9, 5/18), the 3-node analog of CFM_R2_J1_GL
        alpha_err=_tupled(np.array([[5 / 18, 4 / 9, 5 / 18]]))
        if adaptive
        else None,
        op_fn=op_fn,
        **kw,
    )
