"""Differentiable integration.

The reference publicly declares an autodiff module and ships it empty
(``/root/reference/src/diff/mod.rs`` = 0 lines, declared at lib.rs:12). The
JAX rebuild realizes it: solutions are differentiable end-to-end.

Three regimes:
  * ``method="scan"`` integration (driver.py) is reverse-mode differentiable
    out of the box — :func:`grad_terminal` / :func:`value_and_grad_terminal`
    wrap the common "gradient of a terminal-state loss w.r.t. parameters"
    case, with optional rematerialization (``jax.checkpoint``) so memory
    stays O(sqrt(steps)) instead of O(steps).
  * forward sensitivities of matrix exponentials via
    :func:`~vec_ode_tpu.ops.expm.expm_frechet`; ``expm`` itself carries an
    exact Fréchet-adjoint VJP, so exponential integrators are reverse-mode
    differentiable too.
  * **O(1)-memory reversible adjoint** for modulated linear ODEs
    (:func:`adjoint_solve` / :func:`make_adjoint_solver`): the backward
    pass reconstructs the trajectory with inverse propagators instead of
    storing it — exactly stable for norm-preserving (anti-Hermitian)
    operators, the quantum-control case. Gradients of the DISCRETE scheme,
    computed without differentiating through any loop: state cotangents
    propagate by transposed-basis exponential actions, and per-step
    coefficient cotangents come from the augmented-matrix Fréchet identity
    exp([[M, V], [0, M]]) = [[e^M, D_V e^M], [0, e^M]], all expressed as
    the SAME shared-basis Taylor actions the forward pass uses.
    ``save_at_steps`` extends the same machinery to TRAJECTORY losses
    (states at S chosen steps, O(S) memory): the backward sweep injects
    each save point's cotangent as it crosses it and re-anchors the
    reconstruction on the saved state.
    :func:`adjoint_solve_adaptive` extends this to the REAL adaptive
    driver: the forward pass records only the per-iteration times
    ((max_steps, B) scalars, not the trajectory) and the backward sweep
    replays the accepted step sequence in reverse (frozen-step-sequence
    discrete adjoint); non-advancing iterations have dt = 0, which zeroes
    both the backward map and the coefficient Jacobian, so rejected-trial
    overflow can never reach the gradient.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .controller import StepControl
from .driver import Solution, integrate, make_grid
# Yoshida triple-jump exponents (single source of truth in exp/magnus.py):
# composing a SYMMETRIC order-4 step (Magnus-4 with GL2 quadrature is
# self-adjoint) over sub-intervals [g1, g2, g1]·dt with
# g1 = 1/(2 − 2^{1/5}) raises the order to 6.
from .exp.magnus import _SUB_LEN as _YOSHIDA_LEN, _SUB_OFF as _YOSHIDA_OFF

Pytree = Any


def solve_for_grad(
    step_fn_factory: Callable,
    params: Pytree,
    y0: Pytree,
    t0,
    tf,
    h0,
    *,
    adaptive: bool = False,
    ctl: StepControl = StepControl(max_steps=4096),
    remat: bool = False,
    remat_levels: int = 0,
    grad_safe: Optional[bool] = None,
    **kw,
) -> Solution:
    """Differentiable solve: ``step_fn_factory(params) -> step_fn``; the
    returned Solution is a pytree whose leaves carry gradients w.r.t.
    ``params`` and ``y0``.

    Uses the bounded-scan driver; ``ctl.max_steps`` is the scan length — pick
    it tight, every iteration costs a stepper evaluation. ``remat=True``
    wraps the loop body in ``jax.checkpoint`` (recompute instead of storing
    per-step residuals — the answer to deep integration graphs).

    ``remat_levels=k`` runs the scan as k+1 nested rematerialized scans
    (binomial/treeverse checkpointing): reverse-mode memory O((k+1) *
    max_steps^(1/(k+1))) instead of O(max_steps) — 1e5-step nonlinear
    gradients fit comfortably at k=2 (driver.resume). Composes with
    ``remat`` (per-step) if wanted.

    ``grad_safe`` (default: on for adaptive runs) makes rejected trials
    overflow-proof in reverse mode: the accept decision runs on a
    stop-gradient pass and the differentiated stepper evaluation sees
    dt=0 on rejected lanes, closing the documented NaN caveat for
    nonlinear adaptive gradients (PARITY.md). The smooth step-size
    sensitivity on accepted steps is kept (the re-evaluation reproduces
    the decision pass exactly there); only the reject branch's h-shrink
    gradient is dropped. Costs a second stepper evaluation per iteration;
    pass ``grad_safe=False`` for the bare scan.
    """
    step_fn = step_fn_factory(params)
    if remat:
        step_fn = jax.checkpoint(step_fn)
    if grad_safe is None:
        grad_safe = bool(adaptive)
    t_grid = make_grid(t0, tf, dtype=jnp.result_type(
        jnp.asarray(t0), jnp.asarray(tf), float))
    return integrate(
        step_fn, y0, t_grid, h0,
        adaptive=adaptive, ctl=ctl, method="scan",
        remat_levels=remat_levels, grad_safe=grad_safe, **kw,
    )


def grad_terminal(
    loss_fn: Callable,
    step_fn_factory: Callable,
    y0: Pytree,
    t0,
    tf,
    h0,
    **kw,
) -> Callable:
    """Returns ``grad(params)``: the gradient of ``loss_fn(y_final)`` w.r.t.
    stepper parameters, through the full integration."""

    def objective(params):
        sol = solve_for_grad(step_fn_factory, params, y0, t0, tf, h0, **kw)
        return loss_fn(sol.y_final)

    return jax.grad(objective)


def value_and_grad_terminal(loss_fn, step_fn_factory, y0, t0, tf, h0, **kw):
    def objective(params):
        sol = solve_for_grad(step_fn_factory, params, y0, t0, tf, h0, **kw)
        return loss_fn(sol.y_final)

    return jax.value_and_grad(objective)


# ---------------------------------------------------------------------------
# O(1)-memory reversible adjoint for modulated linear ODEs
# ---------------------------------------------------------------------------

def _magnus_cols(coeff_fn, K0, pairs, order, theta, t, dt):
    """Per-step exponent coefficients over the (extended) working basis.

    order=2: c = dt * g(t + dt/2)                       (magnus.rs:10-26)
    order=4: c = [w1, w2] with the Magnus-4 GL2 formulas (magnus.rs:28-83),
             w2 living on the precomputed commutator extension."""
    from .exp.magnus import _B2, _C_MID

    if order == 2:
        return dt * coeff_fn(t + 0.5 * dt, theta)
    tm = t + 0.5 * dt
    g1 = coeff_fn(tm - _C_MID * dt, theta)
    g2 = coeff_fn(tm + _C_MID * dt, theta)
    w1 = 0.5 * dt * (g1 + g2)
    if pairs:
        j = np.array([p[0] for p in pairs])
        k = np.array([p[1] for p in pairs])
        w2 = (_B2 * dt * dt) * (g1[j] * g2[k] - g1[k] * g2[j])
        return jnp.concatenate([w1, w2])
    return w1


def _adjoint_core(basis, coeff_fn, *, order, m, max_squarings):
    """Shared reversible-adjoint machinery: the working basis (with
    commutator extension for orders 4/6), its transpose, the augmented
    Fréchet basis, the per-ROW coefficient formulas, and the chain-action
    apply. Returns a namespace with (cols, apply, W, WT, WA, Kp, D, K0)
    — K0 is the ORIGINAL basis size (W[:K0] is the un-extended basis).
    Order 6 (Yoshida-composed Magnus-4) shares the order-4 row formulas;
    the 3-rows-per-step structure lives in the solver's row builder."""
    from .exp.modulated import (
        ModulatedOperator,
        _real_basis,
        modulated_exp_apply,
    )
    from .ops.cplx import Cplx

    if order not in (2, 4, 6):
        raise ValueError(f"order must be 2, 4 or 6, got {order}")
    if order in (4, 6):
        op0 = ModulatedOperator(basis, lambda t: None)
        ext, pairs = op0.commutator_extension()
        W = _real_basis(ext)
    else:
        W = _real_basis(basis)
        pairs = []
    K0 = (basis.re if isinstance(basis, Cplx) else jnp.asarray(basis)).shape[0]
    Kp, D = W.shape[0], W.shape[1]
    WT = jnp.swapaxes(W, -1, -2)
    # augmented Fréchet basis (2Kp, 2D, 2D): diagonal embeds then upper embeds
    zero = jnp.zeros_like(W)
    WD = jnp.concatenate(
        [jnp.concatenate([W, zero], axis=-1),
         jnp.concatenate([zero, W], axis=-1)], axis=-2,
    )
    WU = jnp.concatenate(
        [jnp.concatenate([zero, W], axis=-1),
         jnp.concatenate([zero, zero], axis=-1)], axis=-2,
    )
    WA = jnp.concatenate([WD, WU], axis=0)

    # order-6 rows ARE order-4 rows over Yoshida sub-intervals
    cols = partial(_magnus_cols, coeff_fn, K0, pairs, min(order, 4))

    def _apply(c, xw, basis_w):
        return modulated_exp_apply(basis_w, c, xw, m=m,
                                   max_squarings=max_squarings)

    from types import SimpleNamespace

    return SimpleNamespace(
        cols=cols, apply=_apply, W=W, WT=WT, WA=WA, Kp=Kp, D=D, K0=K0,
    )


def make_adjoint_solver(
    basis,
    coeff_fn: Callable,
    *,
    n_steps: int,
    order: int = 4,
    m: Optional[int] = None,
    max_squarings: int = 16,
):
    """Build ``solve(theta, y0w, t0, tf) -> y_final_w`` over the WIDENED
    real representation, with a custom O(1)-memory reversible-adjoint VJP
    w.r.t. ``theta`` and ``y0w``.

    basis: ``Cplx`` (K, d, d) or real (K, D, D) operator basis, treated as
    CONSTANT here (for gradients w.r.t. the basis matrices themselves —
    Hamiltonian learning — use :func:`make_adjoint_basis_solver` /
    ``adjoint_solve(..., basis_grad=True)``).
    coeff_fn(t, theta) -> (K,) real modulation coefficients; ``theta`` is an
    arbitrary differentiable pytree.

    Fixed-step Magnus scheme (order 2 = exponential midpoint, order 4 =
    Magnus-4 on the commutator-extended basis, order 6 = Yoshida
    triple-jump composition of the symmetric Magnus-4 step — three
    sub-rows per step over [g1, 1−2g1, g1]·dt with g1 = 1/(2 − 2^{1/5}));
    every exponential is a shared-basis scaling-and-Taylor ACTION
    (exp/modulated.py), forward and backward alike.

    The backward sweep per step n (from the terminal state, nothing stored):
      1. x_n      = e^{-M_n} x_{n+1}           (trajectory reconstruction —
                    exactly stable when the basis is anti-Hermitian; for
                    dissipative operators use ``adjoint_solve(...,
                    anchor_every=k)``: checkpointed re-anchoring bounds the
                    amplification per k-step segment)
      2. a_n      = e^{M_n^T} a_{n+1}          (state cotangent; transposed
                    working basis, same coefficients)
      3. c̄_k      = <a_{n+1}, D_{W_k} e^{M_n} x_n>  for every basis element,
                    via ONE batched augmented action: the 2D-dim basis
                    [[W_k, 0], [0, W_k]] ∪ [[0, W_k], [0, 0]] with one-hot
                    upper coefficients computes all K' Fréchet directions as
                    K' batch rows.
      4. theta̅   += vjp of the coefficient formulas (pure scalar math).

    Gradients are exact for the discrete scheme up to the Taylor truncation
    of the action (~eps) and the reconstruction drift (~n_steps * eps for
    norm-preserving operators). Cotangents for t0/tf are the EXACT
    gradients of the discrete map: t_n = t0 + n·dt and dt = (tf − t0)/N
    are differentiated through every step's coefficient formulas.
    """
    core = _adjoint_core(
        basis, coeff_fn, order=order, m=m, max_squarings=max_squarings,
    )
    rows_all = _make_rows_all(core.cols, order, n_steps)

    @jax.custom_vjp
    def solve(theta, y0w, t0, tf):
        return _rows_forward(core, rows_all(theta, t0, tf), y0w)

    def fwd(theta, y0w, t0, tf):
        yf = solve(theta, y0w, t0, tf)
        return yf, (theta, yf, t0, tf)

    def bwd(res, ybar):
        theta, yf, t0, tf = res
        c_all, c_all_vjp = jax.vjp(rows_all, theta, t0, tf)
        a0, cb_all = _rows_backward(core, c_all, yf, ybar)
        th_bar, t0_bar, tf_bar = c_all_vjp(cb_all.astype(c_all.dtype))
        return (th_bar, a0, t0_bar.astype(jnp.asarray(t0).dtype),
                tf_bar.astype(jnp.asarray(tf).dtype))

    solve.defvjp(fwd, bwd)
    return solve


def rows_per_step(order: int) -> int:
    return 3 if order == 6 else 1


# ---------------------------------------------------------------------------
# basis-matrix gradients (Hamiltonian learning): d loss / d basis
# ---------------------------------------------------------------------------

def _extend_w(W0, pairs):
    """Traced commutator extension of the real working basis: W0 followed
    by [W0_j, W0_k] for j < k — the differentiable counterpart of
    ModulatedOperator.commutator_extension (which builds CONCRETE arrays at
    stepper construction)."""
    from .utils.prec import mm

    if not pairs:
        return W0
    comms = [mm(W0[j], W0[k]) - mm(W0[k], W0[j]) for j, k in pairs]
    return jnp.concatenate([W0, jnp.stack(comms)])


def make_adjoint_basis_solver(
    basis,
    coeff_fn: Callable,
    *,
    n_steps: int,
    order: int = 4,
    m: Optional[int] = None,
    max_squarings: int = 16,
):
    """Like :func:`make_adjoint_solver` but ALSO differentiable w.r.t. the
    basis matrices themselves (closing the gap Hamiltonian-learning
    workloads need): ``solve(theta, y0w, t0, tf, W0) -> y_final_w`` where
    ``W0`` is the (K0, D, D) REAL working basis (``exp.modulated._real_
    basis(basis)`` — for Cplx bases the ring embedding, which is plain
    differentiable concatenation, so ``jax.grad`` w.r.t. the Cplx pair
    flows through automatically when the embedding happens outside).

    Backward pass: the same reversible reconstruction/transport sweep, but
    each row additionally emits its summed outer product
    G_r = sum_b a_{r+1,b} x_{r,b}^T; ONE batched Frechet-adjoint
    L(M_r^T, G_r) (block-expm identity, ops.expm.expm_frechet) then yields
    BOTH the coefficient cotangents (<W_k, Gbar_r> — replacing the
    augmented-action trick) and the basis cotangents
    (W_ext_bar_k = sum_r c_{r,k} Gbar_r), with the commutator extension's
    chain rule handled by jax.vjp through the traced extension. Memory is
    O(R * D^2) for the stacked outer products — inherent to a (K, D, D)
    basis gradient, not a regression of the O(1) state sweep.
    """
    from .exp.modulated import modulated_exp_apply
    from .ops.cplx import Cplx
    from .ops.expm import expm_frechet

    if order not in (2, 4, 6):
        raise ValueError(f"order must be 2, 4 or 6, got {order}")
    K0 = (basis.re if isinstance(basis, Cplx)
          else jnp.asarray(basis)).shape[0]
    pairs = ([(j, k) for j in range(K0) for k in range(j + 1, K0)]
             if order in (4, 6) else [])
    cols = partial(_magnus_cols, coeff_fn, K0, pairs, min(order, 4))
    rows_all = _make_rows_all(cols, order, n_steps)

    def _apply(c, xw, basis_w):
        return modulated_exp_apply(basis_w, c, xw, m=m,
                                   max_squarings=max_squarings)

    def _forward(theta, y0w, t0, tf, W0):
        W_ext = _extend_w(W0, pairs)
        c_all = rows_all(theta, t0, tf)

        def body(x, c_row):
            return _apply(c_row, x, W_ext), None

        xf, _ = jax.lax.scan(body, y0w, c_all)
        return xf

    @jax.custom_vjp
    def solve(theta, y0w, t0, tf, W0):
        return _forward(theta, y0w, t0, tf, W0)

    def fwd(theta, y0w, t0, tf, W0):
        yf = solve(theta, y0w, t0, tf, W0)
        return yf, (theta, yf, t0, tf, W0)

    def bwd(res, ybar):
        theta, yf, t0, tf, W0 = res
        W_ext, ext_vjp = jax.vjp(lambda w: _extend_w(w, pairs), W0)
        WT = jnp.swapaxes(W_ext, -1, -2)
        c_all, c_all_vjp = jax.vjp(rows_all, theta, t0, tf)

        def body(carry, c_row):
            x_next, a_next = carry
            x_n = _apply(-c_row, x_next, W_ext)   # reconstruct
            a_n = _apply(c_row, a_next, WT)       # transport
            # summed outer product: G_r = sum_b a_{r+1,b} x_{r,b}^T
            G = (
                jnp.einsum("...i,...j->ij", a_next, x_n)
                if x_n.ndim > 1 else jnp.outer(a_next, x_n)
            )
            return (x_n, a_n), G

        (x0_r, a0), G_rev = jax.lax.scan(body, (yf, ybar), c_all[::-1])
        del x0_r
        G_all = G_rev[::-1]                        # (R, D, D)

        # one batched Frechet adjoint per row: Gbar_r = L(M_r^T, G_r)
        M_all = jnp.einsum("rk,kij->rij", c_all.astype(W_ext.dtype), W_ext)
        Gbar = expm_frechet(jnp.swapaxes(M_all, -1, -2), G_all,
                            max_squarings=max_squarings)
        cb_all = jnp.einsum("kij,rij->rk", W_ext, Gbar)
        Wext_bar = jnp.einsum("rk,rij->kij", c_all.astype(Gbar.dtype), Gbar)
        (W0_bar,) = ext_vjp(Wext_bar.astype(W_ext.dtype))
        th_bar, t0_bar, tf_bar = c_all_vjp(cb_all.astype(c_all.dtype))
        return (th_bar, a0, t0_bar.astype(jnp.asarray(t0).dtype),
                tf_bar.astype(jnp.asarray(tf).dtype), W0_bar)

    solve.defvjp(fwd, bwd)
    return solve


def _make_rows_all_multi(multi_cols, rps, n_steps):
    """rows_all(theta, t0, tf) -> (n_steps * rps, Kp) for schemes whose
    per-step rows are not parameterized by (t, dt) alone (CFM: rows share
    the step's quadrature samples but differ by their alpha row).
    ``multi_cols(theta, t, dt) -> (rps, Kp)``."""

    def rows(theta, t0, tf):
        tdt = jnp.asarray(t0).dtype
        dt = (jnp.asarray(tf) - t0) / n_steps
        ns = jnp.arange(n_steps, dtype=tdt)
        out = jax.vmap(lambda t_: multi_cols(theta, t_, dt))(t0 + ns * dt)
        return out.reshape(n_steps * rps, out.shape[-1])

    return rows


def make_adjoint_cfm_solver(
    basis,
    coeff_fn: Callable,
    *,
    n_steps: int,
    alpha=None,
    c=None,
    m: Optional[int] = None,
    max_squarings: int = 16,
):
    """Fixed-step COMMUTATOR-FREE Magnus adjoint: the reversible O(1)-memory
    machinery of :func:`make_adjoint_solver` over CFM rows
    c_i = dt * sum_j alpha[i, j] g(t + c_j dt) on the UN-extended basis (no
    commutators — cfm.rs:20-40 semantics). Defaults to the reference
    ExpCFMSolver order-4 configuration (CFM_R4_J2_GL over GL2 nodes,
    cfm.rs:131-155); pass ``alpha``/``c`` for other CFM schemes.

    ``solve(theta, y0w, t0, tf) -> y_final_w`` with the same cotangent
    guarantees (exact discrete theta/t0/tf gradients via one vjp of the
    row table)."""
    from . import tableaus as tb

    if alpha is None:
        alpha = tb.CFM_R4_J2_GL
    if c is None:
        c = tb.C_GAUSS_LEGENDRE_4
    alpha = np.asarray(alpha, np.float64)
    c_nodes = tuple(float(cj) for cj in np.asarray(c))
    if alpha.ndim != 2 or alpha.shape[1] != len(c_nodes):
        raise ValueError(
            f"alpha must be (s, {len(c_nodes)}); got {alpha.shape}")
    # order=2 core: W = the un-extended basis, no commutator pairs — the
    # CFM rows never touch commutator directions
    core = _adjoint_core(
        basis, coeff_fn, order=2, m=m, max_squarings=max_squarings,
    )
    s_rows = alpha.shape[0]

    def multi_cols(theta, t, dt):
        gs = [coeff_fn(t + cj * dt, theta) for cj in c_nodes]
        rows = []
        for i in range(s_rows):
            acc = None
            for j, g in enumerate(gs):
                if alpha[i, j] == 0.0:
                    continue
                term = float(alpha[i, j]) * g
                acc = term if acc is None else acc + term
            rows.append(dt * (acc if acc is not None
                              else jnp.zeros_like(gs[0])))
        return jnp.stack(rows)

    rows_all = _make_rows_all_multi(multi_cols, s_rows, n_steps)

    @jax.custom_vjp
    def solve(theta, y0w, t0, tf):
        return _rows_forward(core, rows_all(theta, t0, tf), y0w)

    def fwd(theta, y0w, t0, tf):
        yf = solve(theta, y0w, t0, tf)
        return yf, (theta, yf, t0, tf)

    def bwd(res, ybar):
        theta, yf, t0, tf = res
        c_all, c_all_vjp = jax.vjp(rows_all, theta, t0, tf)
        a0, cb_all = _rows_backward(core, c_all, yf, ybar)
        th_bar, t0_bar, tf_bar = c_all_vjp(cb_all.astype(c_all.dtype))
        return (th_bar, a0, t0_bar.astype(jnp.asarray(t0).dtype),
                tf_bar.astype(jnp.asarray(tf).dtype))

    solve.defvjp(fwd, bwd)
    return solve


def _make_rows_all(cols, order, n_steps):
    """rows_all(theta, t0, tf) -> (R, Kp): every exponential row of the
    whole fixed-step solve, vectorized. One XLA computation whose vjp
    w.r.t. (theta, t0, tf) IS the full discrete parameter/endpoint
    gradient (all sub-times chain through automatically). Orders 2/4 emit
    one row per step; order 6 emits the three Yoshida sub-rows."""

    def rows(theta, t0, tf):
        tdt = jnp.asarray(t0).dtype
        dt = (jnp.asarray(tf) - t0) / n_steps
        ns = jnp.arange(n_steps, dtype=tdt)
        if order == 6:
            off = jnp.asarray(_YOSHIDA_OFF, tdt)
            ln = jnp.asarray(_YOSHIDA_LEN, tdt)
            t_r = (t0 + ns[:, None] * dt + off * dt).reshape(-1)
            dt_r = jnp.broadcast_to(ln * dt, (n_steps, 3)).reshape(-1)
        else:
            t_r = t0 + ns * dt
            dt_r = jnp.broadcast_to(dt, t_r.shape)
        return jax.vmap(lambda t_, d_: cols(theta, t_, d_))(t_r, dt_r)

    return rows


def _rows_forward(core, c_all, y0w):
    """Apply R sequential exponentials: a scan over the precomputed
    rows."""

    def body(x, c_row):
        return core.apply(c_row, x, core.W), None

    xf, _ = jax.lax.scan(body, y0w, c_all)
    return xf


def _rows_backward(core, c_all, yf, ybar):
    """Reverse sweep over rows -> (a0, cbar_all (R, Kp)): a scan emitting
    one cotangent row per exponential (theta/t0/tf recovery happens in the
    caller via ONE vjp of the row builder)."""

    def body(carry, c_row):
        x_next, a_next = carry
        x_n, a_n, cb_row = _bwd_row(core, c_row, x_next, a_next)
        return (x_n, a_n), cb_row

    (x0_r, a0), cb_rev = jax.lax.scan(body, (yf, ybar), c_all[::-1])
    del x0_r  # reconstructed y0 (diagnostic only)
    return a0, cb_rev[::-1]


def _bwd_row(core, c, x_next, a_next, *, reduce=True):
    """One reverse exponential row: reconstruct x, transport the state
    cotangent, and form the Kp coefficient cotangents.

    ``c`` may be a step-shared row (Kp,) or per-lane rows (B, Kp).
    ``reduce=True`` sums cb over the batch (shared-row convention);
    ``reduce=False`` returns per-lane cb with trailing Kp."""
    Kp, D = core.Kp, core.D
    x_n = core.apply(-c, x_next, core.W)       # 1. reconstruct
    a_n = core.apply(c, a_next, core.WT)       # 2. cotangent transport
    # 3. all Kp Fréchet directions as one batched augmented action
    xa = jnp.concatenate([jnp.zeros_like(x_n), x_n], axis=-1)
    xa = jnp.broadcast_to(xa, (Kp,) + xa.shape)
    batch_c = c.shape[:-1]                     # () shared / (B,) per-lane
    eye = jnp.eye(Kp, dtype=c.dtype).reshape(
        (Kp,) + (1,) * len(batch_c) + (Kp,))
    ca = jnp.concatenate(
        [jnp.broadcast_to(c, (Kp,) + c.shape),
         jnp.broadcast_to(eye, (Kp,) + c.shape)], axis=-1,
    )                                          # (Kp, *batch_c, 2Kp)
    extra = x_n.ndim - 1 - len(batch_c)        # x batch axes c lacks
    ca = ca.reshape((Kp,) + (1,) * extra + batch_c + (2 * Kp,))
    fre = core.apply(ca, xa, core.WA)[..., :D]  # (Kp, ..., D)
    cb = jnp.sum(fre * a_next, axis=-1)        # (Kp, *xbatch)
    if reduce:
        cb = jnp.sum(cb, axis=tuple(range(1, cb.ndim)))
    else:
        cb = jnp.moveaxis(cb, 0, -1)           # (*xbatch, Kp)
    return x_n, a_n, cb.astype(c.dtype)


def make_adjoint_saves_solver(
    basis,
    coeff_fn: Callable,
    *,
    n_steps: int,
    save_at_steps,
    order: int = 4,
    m: Optional[int] = None,
    max_squarings: int = 16,
):
    """Trajectory-loss variant of :func:`make_adjoint_solver`:
    ``solve(theta, y0w, t0, tf) -> ys`` returns the states at the requested
    step indices, stacked on a new LEADING axis (S, ...), so losses over
    the whole trajectory — tracking errors, time-averaged observables,
    multi-time gate fidelities — are differentiable with O(S) memory
    (the S saved states; nothing per step).

    ``save_at_steps``: strictly increasing ints in [1, n_steps]; the solve
    integrates exactly to the last one (``dt`` is still (tf−t0)/n_steps).
    The backward sweep walks the segments in reverse, INJECTING each save
    point's cotangent as it crosses it and re-anchoring the trajectory
    reconstruction on the saved state (so reconstruction drift cannot
    accumulate across segments — the state never crosses a boundary at
    all; only the cotangent does). Uniformly spaced saves run as one
    nested scan; irregular spacings unroll one segment each (compile time
    scales with S)."""
    core = _adjoint_core(
        basis, coeff_fn, order=order, m=m, max_squarings=max_squarings,
    )
    saves = tuple(int(s) for s in save_at_steps)
    bounds = (0,) + saves
    if (not saves or saves[-1] > n_steps
            or any(b <= a for a, b in zip(bounds[:-1], bounds[1:]))):
        raise ValueError(
            "save_at_steps must be strictly increasing ints in "
            f"[1, n_steps={n_steps}]; got {saves}"
        )
    S = len(saves)
    rps = rows_per_step(order)
    rbounds = tuple(b * rps for b in bounds)
    n_used = rbounds[-1]
    seg_rows = tuple(b - a for a, b in zip(rbounds[:-1], rbounds[1:]))
    uniform = len(set(seg_rows)) == 1
    Lr = seg_rows[0]
    rows_all = _make_rows_all(core.cols, order, n_steps)

    @jax.custom_vjp
    def solve(theta, y0w, t0, tf):
        c_used = rows_all(theta, t0, tf)[:n_used]
        if uniform:
            def seg(x, c_seg):
                xe = _rows_forward(core, c_seg, x)
                return xe, xe

            _, ys = jax.lax.scan(
                seg, y0w, c_used.reshape(S, Lr, c_used.shape[-1]))
        else:
            parts, x = [], y0w
            for a, b in zip(rbounds[:-1], rbounds[1:]):
                x = _rows_forward(core, c_used[a:b], x)
                parts.append(x)
            ys = jnp.stack(parts)
        return ys

    def fwd(theta, y0w, t0, tf):
        ys = solve(theta, y0w, t0, tf)
        return ys, (theta, ys, t0, tf)

    def bwd(res, ysbar):
        theta, ys, t0, tf = res
        c_all, c_all_vjp = jax.vjp(rows_all, theta, t0, tf)
        c_used = c_all[:n_used]

        # segment j's backward starts from x = ys[j] (the anchor) and
        # a = transported-cotangent-from-j+1 + ysbar[j]
        if uniform:
            def seg(a_in, inp):
                c_seg, y_end, yb = inp
                a0_seg, cb_seg = _rows_backward(core, c_seg, y_end,
                                                a_in + yb)
                return a0_seg, cb_seg

            a0, cb_rev = jax.lax.scan(
                seg, jnp.zeros_like(ysbar[-1]),
                (c_used.reshape(S, Lr, c_used.shape[-1])[::-1],
                 ys[::-1], ysbar[::-1]))
            cb_used = cb_rev[::-1].reshape(n_used, c_used.shape[-1])
        else:
            a_in = jnp.zeros_like(ysbar[-1])
            chunks = [None] * S
            for j in range(S - 1, -1, -1):
                a_, b_ = rbounds[j], rbounds[j + 1]
                a_in, cb_seg = _rows_backward(core, c_used[a_:b_], ys[j],
                                              a_in + ysbar[j])
                chunks[j] = cb_seg
            a0 = a_in
            cb_used = jnp.concatenate(chunks, axis=0)

        cb_all = jnp.concatenate(
            [cb_used, jnp.zeros_like(c_all[n_used:])], axis=0)
        th_bar, t0_bar, tf_bar = c_all_vjp(cb_all.astype(c_all.dtype))
        return (th_bar, a0, t0_bar.astype(jnp.asarray(t0).dtype),
                tf_bar.astype(jnp.asarray(tf).dtype))

    solve.defvjp(fwd, bwd)
    return solve


def make_adaptive_adjoint_solver(
    basis,
    coeff_fn: Callable,
    *,
    ctl: StepControl,
    order: int = 4,
    scheme: str = "magnus",
    m: Optional[int] = None,
    max_squarings: int = 16,
):
    """Adaptive-step variant of :func:`make_adjoint_solver` (orders 4/6):
    ``solve(theta, y0w, t0, tf, h0) -> y_final_w`` runs the REAL adaptive
    driver forward (driver.step_once semantics, ``ctl.max_steps`` bounded
    iterations like ``method="scan"``), recording ONLY the per-iteration
    times — a (max_steps, B) scalar buffer, not the trajectory. The
    backward sweep replays the ACCEPTED step sequence in reverse with the
    reversible-adjoint machinery; the step sizes are treated as constants
    w.r.t. theta (the standard frozen-step-sequence discrete adjoint).

    Iterations that did not advance (rejected trials, grid hits, finished
    lanes) have dt = 0, which makes their exponent coefficients exactly
    zero: the backward map is the identity and the coefficient Jacobian
    vanishes, so rejected trials need no masking AND their (possibly
    overflowed) values never enter the gradient — the NaN-through-rejects
    hazard of differentiating the scan driver does not exist here.

    Endpoint cotangents use the continuous adjoint identity
    dL/dtf = <a(tf), A(tf)x(tf)> (and its t0 negative) — exact to the
    integration order; h0's cotangent is zero by construction (the frozen
    sequence absorbs it).

    Returns ``(y_final_w, status)`` — status per lane, exactly the
    driver's codes. A lane that exhausts ``ctl.max_steps`` before
    reaching ``tf`` holds a mid-integration state; callers must check
    status (the :func:`adjoint_solve_adaptive` wrapper NaN-poisons such
    lanes by default so truncation can never be silent)."""
    from .exp.modulated import (
        MagnusModulated4,
        MagnusModulated6,
        ModulatedOperator,
        _unwiden,
        _widen,
    )
    from .ops.cplx import Cplx

    if scheme not in ("magnus", "cfm4"):
        raise ValueError(f"scheme must be 'magnus' or 'cfm4', got {scheme}")
    if scheme == "cfm4":
        # CFM rows live on the UN-extended basis (order=2 core: no
        # commutator pairs); the forward stepper is CFM4Modulated
        core = _adjoint_core(
            basis, coeff_fn, order=2, m=m, max_squarings=max_squarings,
        )
        from .tableaus import C_GAUSS_LEGENDRE_4, CFM_R4_J2_GL

        _alpha = np.asarray(CFM_R4_J2_GL)
        _cn = [float(cj) for cj in np.asarray(C_GAUSS_LEGENDRE_4)]
        n_sub_rows = _alpha.shape[0]

        def step_rows(th, t_, d_):
            gs = [coeff_fn(t_ + cj * d_, th) for cj in _cn]
            return jnp.stack([
                d_ * sum(float(_alpha[i, j]) * gs[j]
                         for j in range(len(_cn)))
                for i in range(n_sub_rows)
            ])
    else:
        if order not in (4, 6):
            raise ValueError(
                f"adaptive adjoint order must be 4 or 6, got {order}")
        core = _adjoint_core(
            basis, coeff_fn, order=order, m=m, max_squarings=max_squarings,
        )
        # order 6 replays the three Yoshida sub-rows per recorded step
        subs = (tuple(zip(_YOSHIDA_OFF, _YOSHIDA_LEN)) if order == 6
                else ((0.0, 1.0),))
        n_sub_rows = len(subs)

        def step_rows(th, t_, d_):
            return jnp.stack([
                core.cols(th, t_ + o * d_, ln * d_) for o, ln in subs
            ])
    cols, W, K0 = core.cols, core.W, core.K0
    is_cplx = isinstance(basis, Cplx)

    if ctl.max_steps > 65536:
        raise ValueError(
            "the adaptive adjoint runs EXACTLY ctl.max_steps forward "
            f"iterations (got {ctl.max_steps}); set a tight max_steps"
        )

    @jax.custom_vjp
    def solve(theta, y0w, t0, tf, h0):
        yfw, status, ts_all = _forward(theta, y0w, t0, tf, h0)
        return yfw, status

    def _forward(theta, y0w, t0, tf, h0):
        from .driver import init_state, step_once

        if y0w.ndim != 2:
            raise ValueError(
                "the adaptive adjoint needs a BATCHED state: y0 with a "
                f"leading trajectory axis, widened to (B, 2d); got ndim="
                f"{y0w.ndim}. For a single trajectory add a length-1 "
                "batch axis (y0[None])."
            )
        op_mod = ModulatedOperator(basis, lambda t: coeff_fn(t, theta))
        if scheme == "cfm4":
            from .exp.modulated import CFM4Modulated

            stepper = CFM4Modulated(
                op_mod, adaptive=True, m=m, max_squarings=max_squarings,
            )
        else:
            stepper_cls = (MagnusModulated6 if order == 6
                           else MagnusModulated4)
            stepper = stepper_cls(
                op_mod, adaptive=True, m=m, max_squarings=max_squarings,
            )
        step_fn = stepper.make_step_fn()
        x0 = _unwiden(y0w, is_cplx)
        B = y0w.shape[0]
        # ONE time dtype for the whole solve: controller math promotes h
        # by the state/error dtype, so fold that in too. Endpoint
        # COTANGENTS still carry their own primal dtypes (see bwd).
        tdt = jnp.result_type(jnp.asarray(t0).dtype, jnp.asarray(tf).dtype,
                              jnp.asarray(h0).dtype, y0w.dtype)
        t_grid = jnp.stack([jnp.asarray(t0, tdt), jnp.asarray(tf, tdt)])
        state = init_state(x0, t_grid, jnp.asarray(h0, tdt),
                           batch_shape=(B,))

        def body(s, _):
            s2 = step_once(s, step_fn, adaptive=True, ctl=ctl,
                           error_norm=stepper.error_norm, batched=True)
            return s2, s.t

        final, ts_hist = jax.lax.scan(body, state, None,
                                      length=ctl.max_steps)
        ts_all = jnp.concatenate([ts_hist, final.t[None]], axis=0)
        return _widen(final.x, is_cplx), final.status, ts_all

    def fwd(theta, y0w, t0, tf, h0):
        yfw, status, ts_all = _forward(theta, y0w, t0, tf, h0)
        return (yfw, status), (theta, yfw, ts_all, t0, tf, h0)

    def bwd(res, cts):
        ybar, _ = cts                            # int status: float0 cotangent
        theta, yfw, ts_all, t0, tf, h0 = res
        theta0 = jax.tree_util.tree_map(jnp.zeros_like, theta)

        def body(carry, r):
            x_next, a_next, th_bar = carry
            t_r = ts_all[r]
            dt_r = ts_all[r + 1] - ts_all[r]     # 0 on non-advancing rows

            def rows_of(th):
                # (n_rows, B, Kp): the scheme's per-step rows; dt_r = 0
                # rows stay exactly zero for every sub-row
                return jnp.moveaxis(
                    jax.vmap(lambda t, d: step_rows(th, t, d))(t_r, dt_r),
                    1, 0,
                )

            rows, r_vjp = jax.vjp(rows_of, theta)
            cbs = []
            for j in range(n_sub_rows - 1, -1, -1):
                x_next, a_next, cb = _bwd_row(core, rows[j], x_next,
                                              a_next, reduce=False)
                cbs.append(cb)
            (th_step,) = r_vjp(jnp.stack(cbs[::-1]))
            th_bar = jax.tree_util.tree_map(jnp.add, th_bar, th_step)
            return (x_next, a_next, th_bar), None

        n_it = ts_all.shape[0] - 1
        (x0_r, a0, th_bar), _ = jax.lax.scan(
            body, (yfw, ybar, theta0),
            jnp.arange(n_it - 1, -1, -1),
        )

        # endpoint gradients via the continuous adjoint identity
        # dL/dtf = <a(tf), A(tf) x(tf)>, dL/dt0 = -<a(t0), A(t0) x(t0)>
        # (the frozen step sequence has no differentiable endpoint
        # dependence of its own; these are the true ODE sensitivities,
        # accurate to the integration order). Per-lane final times cover
        # truncated lanes; the wrapper's NaN-poison VJP zeroes their ybar.
        from .utils.prec import HIGHEST

        def At_x(t_b, x):
            g = jax.vmap(lambda t: coeff_fn(t, theta))(t_b)   # (B, K0)
            return jnp.einsum("bk,kij,bj->bi", g, W[:K0], x,
                              precision=HIGHEST)

        tf_bar = jnp.sum(ybar * At_x(ts_all[-1], yfw))
        t0_bar = -jnp.sum(a0 * At_x(ts_all[0], x0_r))
        # h0 shapes the accepted sequence, which the discrete adjoint
        # freezes — its cotangent is zero by construction; each cotangent
        # must carry ITS primal's dtype (mixed time dtypes are legal)
        return (th_bar, a0,
                t0_bar.astype(jnp.asarray(t0).dtype),
                tf_bar.astype(jnp.asarray(tf).dtype),
                jnp.zeros_like(jnp.asarray(h0)))

    solve.defvjp(fwd, bwd)
    return solve


def adjoint_solve_adaptive(
    basis,
    coeff_fn: Callable,
    theta: Pytree,
    y0: Pytree,
    t0,
    tf,
    *,
    ctl: StepControl,
    order: int = 4,
    scheme: str = "magnus",
    h0=None,
    m: Optional[int] = None,
    max_squarings: int = 16,
    return_status: bool = False,
):
    """Terminal state of the ADAPTIVE solve (Magnus order 4 or 6, or
    ``scheme="cfm4"`` for the commutator-free stepper) of
    dx/dt = A(t;theta) x,
    differentiable w.r.t. ``theta`` and ``y0`` with O(max_steps) scalar
    memory (per-iteration times only — no stored trajectory). See
    :func:`make_adaptive_adjoint_solver`.

    Lanes that fail to reach ``tf`` within ``ctl.max_steps`` iterations are
    NaN-POISONED (driver semantics would return a valid mid-integration
    state + an error status; an optimizer loss must never silently train on
    a truncated solve). Pass ``return_status=True`` to instead get
    ``(y_final, status)`` with the un-poisoned states and per-lane driver
    status codes."""
    from .driver import DONE
    from .exp.modulated import _unwiden, _widen
    from .ops.cplx import Cplx

    solver = make_adaptive_adjoint_solver(
        basis, coeff_fn, ctl=ctl, order=order, scheme=scheme, m=m,
        max_squarings=max_squarings,
    )
    if h0 is None:
        h0 = ctl.init_h()
    is_cplx = isinstance(y0, Cplx)
    yfw, status = solver(theta, _widen(y0, is_cplx), t0, tf, h0)
    if return_status:
        return _unwiden(yfw, is_cplx), status
    ok = (status == DONE)[:, None]
    yfw = jnp.where(ok, yfw, jnp.asarray(jnp.nan, yfw.dtype))
    return _unwiden(yfw, is_cplx)


def adjoint_solve(
    basis,
    coeff_fn: Callable,
    theta: Pytree,
    y0: Pytree,
    t0,
    tf,
    n_steps: int,
    *,
    order: int = 4,
    m: Optional[int] = None,
    max_squarings: int = 16,
    save_at_steps=None,
    basis_grad: bool = False,
    anchor_every: Optional[int] = None,
):
    """Terminal state of dx/dt = (Σ_k coeff_fn(t, theta)[k] · basis[k]) x
    after ``n_steps`` fixed Magnus steps, differentiable w.r.t. ``theta``
    and ``y0`` with O(1) memory (see :func:`make_adjoint_solver`).

    With ``save_at_steps`` (strictly increasing ints in [1, n_steps]) the
    states at those steps are returned instead, stacked on a new leading
    axis — trajectory losses over every saved state stay differentiable
    with O(S) memory (see :func:`make_adjoint_saves_solver`).

    With ``basis_grad=True`` the result is ALSO differentiable w.r.t. the
    basis matrices themselves (Hamiltonian learning; O(n_steps * D^2)
    backward memory — see :func:`make_adjoint_basis_solver`).

    ``anchor_every=k`` enables ANCHORED reconstruction for DISSIPATIVE
    (non-norm-preserving) operators — Lindblad superoperators, decaying
    modes: the plain O(1) sweep reconstructs x backward with inverse
    propagators, which amplifies roundoff by ~e^{2*gamma*T} over the whole
    horizon; anchoring stores the state every k steps (the save_at_steps
    machinery, with only the terminal state returned) and re-starts each
    backward segment from its stored anchor, bounding the amplification at
    e^{2*gamma*k*dt} per segment for O(n_steps/k) memory. Pick k so
    gamma*k*dt <~ 1.

    ``basis``/``y0`` may be ``Cplx`` (real-pair complex); the widening is
    ordinary differentiable concatenation outside the custom VJP."""
    from .exp.modulated import _unwiden, _widen
    from .ops.cplx import Cplx

    if anchor_every is not None:
        if save_at_steps is not None or basis_grad:
            raise ValueError(
                "anchor_every composes with neither save_at_steps (saves "
                "ARE anchors already) nor basis_grad")
        k = int(anchor_every)
        if k < 1:
            raise ValueError(f"anchor_every must be >= 1, got {anchor_every}")
        anchors = tuple(range(k, n_steps, k)) + (n_steps,)
        solver = make_adjoint_saves_solver(
            basis, coeff_fn, n_steps=n_steps, save_at_steps=anchors,
            order=order, m=m, max_squarings=max_squarings,
        )
        is_cplx = isinstance(y0, Cplx)
        yfw = solver(theta, _widen(y0, is_cplx), t0, tf)[-1]
        return _unwiden(yfw, is_cplx)

    if basis_grad:
        if save_at_steps is not None:
            raise ValueError("basis_grad with save_at_steps is unsupported")
        from .exp.modulated import _real_basis

        solver = make_adjoint_basis_solver(
            basis, coeff_fn, n_steps=n_steps, order=order, m=m,
            max_squarings=max_squarings,
        )
        is_cplx = isinstance(y0, Cplx)
        # the embedding is differentiable concatenation OUTSIDE the custom
        # VJP, so grads w.r.t. a Cplx basis pytree flow automatically
        yfw = solver(theta, _widen(y0, is_cplx), t0, tf, _real_basis(basis))
        return _unwiden(yfw, is_cplx)

    if save_at_steps is not None:
        solver = make_adjoint_saves_solver(
            basis, coeff_fn, n_steps=n_steps, save_at_steps=save_at_steps,
            order=order, m=m, max_squarings=max_squarings,
        )
    else:
        solver = make_adjoint_solver(
            basis, coeff_fn, n_steps=n_steps, order=order, m=m,
            max_squarings=max_squarings,
        )
    is_cplx = isinstance(y0, Cplx)
    yfw = solver(theta, _widen(y0, is_cplx), t0, tf)
    return _unwiden(yfw, is_cplx)


# ---------------------------------------------------------------------------
# Reversible adjoint for BLACK-BOX dense operators (the reference's actual
# operator contract: an opaque A(t) callback, magnus.rs:32 / cfm.rs:54 —
# no Σ f_k(t) M_k structure assumed)
# ---------------------------------------------------------------------------


def make_adjoint_dense_solver(
    op_fn: Callable,
    *,
    n_steps: int,
    order: int = 4,
    max_squarings: int = 16,
    anchor_every: Optional[int] = None,
):
    """Build ``solve(theta, y0w, t0, tf) -> y_final_w`` for the GENERIC
    dense-operator contract ``op_fn(t, theta) -> A`` (real (D, D) array or
    ``Cplx`` (d, d) — the reference's black-box callback, magnus.rs:32),
    with an O(1)-memory reversible-adjoint VJP w.r.t. ``theta``, ``y0w``,
    ``t0`` and ``tf``.

    Fixed-step Magnus scheme over per-step exponent matrices (order 2 =
    exponential midpoint, magnus.rs:10-26; order 4 = Magnus-4 with GL2
    nodes + commutator, magnus.rs:28-83; order 6 = the Yoshida triple-jump
    of the symmetric order-4 step, 3 exponent rows per step — exactly the
    exponents exp/magnus.py's steppers build, so forward states match
    ``solve_linear(stepper=Magnus4(DenseSplit()), adaptive=False)``).

    Where the modulated adjoint (:func:`make_adjoint_solver`) propagates
    COEFFICIENT cotangents over a shared basis, here each backward row
    recomputes its exponent Ω_r from ``op_fn`` and uses the matrix-valued
    machinery directly (nothing is stored across rows — O(D²) memory,
    O(1) in n_steps):

      1. x_r  = e^{-Ω_r} x_{r+1}       (reconstruction; exactly stable for
                anti-Hermitian Ω — for dissipative operators pass
                ``anchor_every=k``: the forward stores the state every k
                STEPS and each backward segment re-anchors on its stored
                state, bounding the roundoff amplification at
                ~e^{2·gamma·k·dt} per segment for O(n_steps/k) memory —
                the same discipline as ``adjoint_solve(anchor_every=k)``)
      2. (Ω̄_r, a_r) = vjp of (Ω, x) ↦ e^{Ω} x at (Ω_r, x_r) applied to
                a_{r+1} — the Fréchet-adjoint VJP that ops/expm.py's
                ``expm`` already carries gives the MATRIX cotangent Ω̄
                exactly (no finite differences), and a_r = e^{Ω_rᵀ} a_{r+1}
      3. (θ̄, t̄0, t̄f) += vjp of the Ω_r assembly (two ``op_fn`` samples,
                the commutator, and the row's (t_r, dt_r) map)

    Gradients are exact for the discrete scheme up to the Padé/Taylor
    truncation of ``expm`` and the reconstruction drift. ``y0w`` is the
    widened real state ((..., D); a leading batch axis broadcasts against
    the shared per-row Ω). For complex systems ``op_fn`` returns ``Cplx``
    and the ring embedding (ops/cplx.py:embed) happens here, inside the
    differentiated assembly, so ``theta`` gradients flow through it.
    """
    from .ops.cplx import Cplx, embed
    from .ops.expm import expm
    from .utils.prec import HIGHEST
    # single source of truth for the scheme constants (exp/magnus.py)
    from .exp.magnus import _B2, _C_MID

    if order not in (2, 4, 6):
        raise ValueError(f"order must be 2, 4 or 6, got {order}")
    rps = rows_per_step(order)
    R = n_steps * rps
    sub_off = jnp.asarray(_YOSHIDA_OFF)
    sub_len = jnp.asarray(_YOSHIDA_LEN)
    if anchor_every is not None and int(anchor_every) < 1:
        raise ValueError(f"anchor_every must be >= 1, got {anchor_every}")
    # segment bounds in ROW space (anchor_every counts STEPS); one segment
    # == the plain O(1) sweep
    seg_rows = R if anchor_every is None else int(anchor_every) * rps
    seg_bounds = [
        (s0, min(s0 + seg_rows, R)) for s0 in range(0, R, seg_rows)
    ]

    def _assemble_w(t, theta):
        A = op_fn(t, theta)
        if isinstance(A, Cplx):
            return embed(A)
        return jnp.asarray(A)

    def _row_td(t0, tf, r):
        dt = (tf - t0) / n_steps
        if order == 6:
            n = r // rps
            j = r % rps
            t_n = t0 + n.astype(dt.dtype) * dt
            return t_n + sub_off[j] * dt, sub_len[j] * dt
        return t0 + r.astype(dt.dtype) * dt, dt

    def _omega(theta, t0, tf, r):
        t_r, dt_r = _row_td(
            jnp.asarray(t0), jnp.asarray(tf), jnp.asarray(r)
        )
        if order == 2:
            return dt_r * _assemble_w(t_r + 0.5 * dt_r, theta)
        t_mid = t_r + 0.5 * dt_r
        A1 = _assemble_w(t_mid - _C_MID * dt_r, theta)
        A2 = _assemble_w(t_mid + _C_MID * dt_r, theta)
        comm = (
            jnp.matmul(A1, A2, precision=HIGHEST)
            - jnp.matmul(A2, A1, precision=HIGHEST)
        )
        return 0.5 * dt_r * (A1 + A2) + (_B2 * dt_r * dt_r) * comm

    def _mv(P, x):
        return jnp.einsum("ij,...j->...i", P, x, precision=HIGHEST)

    def _row_map(theta, t0, tf, r, x):
        return _mv(expm(_omega(theta, t0, tf, r),
                        max_squarings=max_squarings), x)

    @jax.custom_vjp
    def solve(theta, y0w, t0, tf):
        def body(x, r):
            return _row_map(theta, t0, tf, r, x), None

        yf, _ = jax.lax.scan(body, y0w, jnp.arange(R))
        return yf

    def fwd(theta, y0w, t0, tf):
        if anchor_every is None:
            yf = solve(theta, y0w, t0, tf)
            return yf, (theta, (yf,), t0, tf)
        # segmented forward: store the state at every anchor (same fp op
        # sequence as the single scan — segmenting only splits the loop)
        def body(x, r):
            return _row_map(theta, t0, tf, r, x), None

        x = y0w
        anchors = []
        for s0, s1 in seg_bounds:
            x, _ = jax.lax.scan(body, x, jnp.arange(s0, s1))
            anchors.append(x)
        return anchors[-1], (theta, tuple(anchors), t0, tf)

    def bwd(res, ybar):
        theta, anchors, t0, tf = res
        zero_th = jax.tree_util.tree_map(
            lambda a: jnp.zeros_like(a), theta
        )
        t0a, tfa = jnp.asarray(t0), jnp.asarray(tf)

        def body(carry, r):
            x_next, a_next, g_th, g_t0, g_tf = carry
            Om = _omega(theta, t0, tf, r)
            x_r = _mv(expm(-Om, max_squarings=max_squarings), x_next)
            _, vjp = jax.vjp(
                lambda th, a0, a1, x: _row_map(th, a0, a1, r, x),
                theta, t0a, tfa, x_r,
            )
            th_b, t0_b, tf_b, a_r = vjp(a_next)
            carry = (
                x_r, a_r,
                jax.tree_util.tree_map(jnp.add, g_th, th_b),
                g_t0 + t0_b, g_tf + tf_b,
            )
            return carry, None

        carry = (anchors[-1], ybar, zero_th, jnp.zeros_like(t0a),
                 jnp.zeros_like(tfa))
        for i in reversed(range(len(seg_bounds))):
            s0, s1 = seg_bounds[i]
            # re-anchor the reconstruction on the stored segment-end state
            carry = (anchors[i],) + carry[1:]
            carry, _ = jax.lax.scan(
                body, carry, jnp.arange(s1 - 1, s0 - 1, -1)
            )
        (x0, a0, g_th, g_t0, g_tf) = carry
        return (g_th, a0, g_t0.astype(t0a.dtype), g_tf.astype(tfa.dtype))

    solve.defvjp(fwd, bwd)
    return solve


def adjoint_solve_dense(
    op_fn: Callable,
    theta: Pytree,
    y0: Pytree,
    t0,
    tf,
    n_steps: int,
    *,
    order: int = 4,
    max_squarings: int = 16,
    anchor_every: Optional[int] = None,
):
    """Terminal state of dx/dt = A(t; theta) x for a BLACK-BOX operator
    callback ``op_fn(t, theta)`` (real matrix or ``Cplx``) after
    ``n_steps`` fixed Magnus steps, differentiable w.r.t. ``theta`` and
    ``y0`` with O(1) memory in ``n_steps`` — the reversible-adjoint
    counterpart of the reference's generic operator contract
    (magnus.rs:32); no Σ f_k(t) M_k structure required (for structured
    operators :func:`adjoint_solve` is much faster — shared-basis actions
    instead of per-row expm). For DISSIPATIVE operators pass
    ``anchor_every=k`` (checkpointed re-anchoring, O(n_steps/k) memory).
    See :func:`make_adjoint_dense_solver`."""
    from .exp.modulated import _unwiden, _widen
    from .ops.cplx import Cplx

    solver = make_adjoint_dense_solver(
        op_fn, n_steps=n_steps, order=order, max_squarings=max_squarings,
        anchor_every=anchor_every,
    )
    is_cplx = isinstance(y0, Cplx)
    yfw = solver(theta, _widen(y0, is_cplx), t0, tf)
    return _unwiden(yfw, is_cplx)


# ---------------------------------------------------------------------------
# On-device optimization loops: N optimizer iterations in ONE dispatch.
#
# A host-synced optimizer loop (solve -> grad -> update, one dispatch per
# iteration) pays a dispatch and a host sync per iteration. The reference's
# user contract is exactly such a host loop
# (/root/reference/src/impls/nalgebra.rs:61-64 — `while let ODEState::Ok(_) =
# solver.step()`); the rebuild's answer is to put the whole optimization
# inside one jitted lax.scan so the per-iteration cost is the solve+grad
# itself, not the dispatch.
# ---------------------------------------------------------------------------


class FitResult(NamedTuple):
    """Result of :func:`fit_loop` / :func:`make_fit_loop`.

    ``losses[i]`` is the loss evaluated at the PRE-update parameters of
    iteration ``i`` (the standard convention: ``losses[0]`` is the loss at
    ``theta0``). With early stopping (``tol``) entries past ``n_done`` are
    NaN. ``aux`` is the stacked per-iteration auxiliary output when the
    loss has ``has_aux=True`` (None otherwise; None under ``tol`` early
    stopping, where iteration count is dynamic).
    """

    params: Any
    opt_state: Any
    losses: jax.Array
    n_done: jax.Array
    aux: Any = None


def make_fit_loop(
    loss_fn: Callable,
    optimizer,
    *,
    n_iters: int,
    has_aux: bool = False,
    tol: Optional[float] = None,
    unroll: int = 1,
    verbose_every: int = 0,
    jit: bool = True,
):
    """Build ``fit(theta0, *args) -> FitResult`` running ``n_iters``
    optimizer iterations — ``value_and_grad(loss_fn)`` + ``optimizer``
    update — inside ONE jitted dispatch.

    ``loss_fn(theta, *args) -> scalar`` (or ``(scalar, aux)`` with
    ``has_aux=True``) is any differentiable loss; with a solver inside
    (``adjoint_solve``, ``value_and_grad_terminal``'s objective, a
    ``method="scan"`` solve) the entire optimization runs on-device: no
    host round-trip between iterations, so the per-iteration cost is the
    solve+grad itself instead of a dispatch and a host sync.

    ``optimizer`` is any optax-style pair: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)`` with additive
    updates. ``*args`` are static-shaped extra loss inputs (data batches,
    targets) passed through unchanged.

    ``tol`` switches the fixed-length ``lax.scan`` to a
    ``lax.while_loop`` that stops as soon as the loss at the current
    parameters is <= ``tol`` (still one dispatch; ``losses`` keeps its
    static ``(n_iters,)`` shape with NaN past ``n_done``).

    ``verbose_every=k`` prints the iteration/loss every k iterations from
    inside the compiled loop (``jax.debug.print``) — the only way to watch
    progress without breaking the single dispatch.

    The loop is reverse-differentiated per-iteration only (value_and_grad
    inside the body); nothing differentiates THROUGH the optimizer loop,
    so there is no stored-trajectory memory cost beyond the loss's own.
    """
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    vg = jax.value_and_grad(loss_fn, has_aux=has_aux)

    def _eval_update(theta, opt_state, args):
        if has_aux:
            (v, aux), g = vg(theta, *args)
        else:
            v, g = vg(theta, *args)
            aux = None
        updates, opt_state = optimizer.update(g, opt_state, theta)
        theta = jax.tree_util.tree_map(
            lambda p, u: p + u.astype(p.dtype), theta, updates)
        return v, aux, theta, opt_state

    def _maybe_print(i, v):
        if verbose_every > 0:
            jax.lax.cond(
                i % verbose_every == 0,
                lambda: jax.debug.print(
                    "fit_loop iter {i}  loss {v}", i=i, v=v),
                lambda: None,
            )

    def run(theta0, *args):
        opt_state0 = optimizer.init(theta0)
        if tol is None:
            def body(carry, i):
                theta, opt_state = carry
                v, aux, theta, opt_state = _eval_update(
                    theta, opt_state, args)
                _maybe_print(i, v)
                out = (v, aux) if has_aux else v
                return (theta, opt_state), out

            (theta, opt_state), hist = jax.lax.scan(
                body, (theta0, opt_state0), jnp.arange(n_iters),
                unroll=unroll)
            losses, aux = hist if has_aux else (hist, None)
            return FitResult(theta, opt_state, losses,
                             jnp.asarray(n_iters, jnp.int32), aux)

        # early-stopping variant: dynamic iteration count, one dispatch
        losses0 = jnp.full((n_iters,), jnp.nan,
                           jax.eval_shape(
                               lambda th: loss_fn(th, *args)[0]
                               if has_aux else loss_fn(th, *args),
                               theta0).dtype)

        def cond(carry):
            i, _, _, _, last_v = carry
            return (i < n_iters) & (last_v > tol)

        def body(carry):
            i, theta, opt_state, losses, _ = carry
            v, _, theta, opt_state = _eval_update(theta, opt_state, args)
            _maybe_print(i, v)
            return (i + 1, theta, opt_state, losses.at[i].set(v), v)

        i, theta, opt_state, losses, _ = jax.lax.while_loop(
            cond, body,
            (jnp.asarray(0, jnp.int32), theta0, opt_state0, losses0,
             jnp.asarray(jnp.inf, losses0.dtype)))
        return FitResult(theta, opt_state, losses, i, None)

    return jax.jit(run) if jit else run


def fit_loop(
    loss_fn: Callable,
    theta0: Pytree,
    *args,
    optimizer,
    n_iters: int,
    has_aux: bool = False,
    tol: Optional[float] = None,
    unroll: int = 1,
    verbose_every: int = 0,
) -> FitResult:
    """Run ``n_iters`` optimizer iterations of ``loss_fn`` starting from
    ``theta0`` inside ONE jitted dispatch (see :func:`make_fit_loop`;
    build the loop once with that factory when calling repeatedly —
    this convenience wrapper re-jits per call)."""
    fit = make_fit_loop(
        loss_fn, optimizer, n_iters=n_iters, has_aux=has_aux, tol=tol,
        unroll=unroll, verbose_every=verbose_every)
    return fit(theta0, *args)
