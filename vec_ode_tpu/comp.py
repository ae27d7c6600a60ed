"""Compensated (double-word / "double-f32") state arithmetic.

The reference integrates in f64 end-to-end (``/root/reference/src/lib.rs:20-34``;
its own test runs ``with_tolerance(1.0e-10, 1.0e-10)``,
``/root/reference/src/impls/nalgebra.rs:97-99``). The accelerator path is
f32, whose plain state accumulation ``y += dy`` drifts by ~n*eps_f32*|y|
over an n-step solve and floors usable tolerances around rtol~1e-6.

This module closes that gap with error-free transforms (EFT), the same
trick as the driver's compensated TIME carry
(``driver.comp_time_advance``), applied to the STATE:

  * the state is carried as a renormalized pair (hi, lo) with
    fl(hi + lo) == hi (hi is the correctly-rounded running sum);
  * steppers compute the per-step INCREMENT dy (never the full next state),
    so its rounding is O(eps*|dy|), and fold it into the pair with
    TwoSum + renormalize — accumulation across steps is then exact;
  * exponential steppers get increment-form propagation via
    ``ops.expm.expm_m1`` (phi = e^O - I with relative accuracy): a chain
    U_k ... U_1 x becomes D <- D + phi_k (x + D), every term O(|dy|);
  * embedded error estimates become DIFFERENCES OF INCREMENTS
    (phi_err x - D), dropping their noise floor from eps*|y| (~1e-7, the
    measured Magnus-6 f32 estimator floor) to eps*|dy| — which is what makes
    rtol=1e-8..1e-9 controller decisions meaningful in f32.

Wiring: the ``lo`` word rides the stepper-carry channel
(``step_fn(t, x, dt, lo) -> (x_next, err, lo_next)``), so the driver,
events, norms and save-grid recording all see the plain ``hi`` state and
stay untouched; on rejects the carry is not advanced, which is exactly
right (x unchanged). Enable with ``compensated=True`` on ``RungeKutta`` /
``ExpMidpoint`` / ``Magnus4`` / ``Magnus6`` / ``CFM``.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

Pytree = Any


def two_sum(a, b):
    """Knuth TwoSum: s = fl(a+b), e the exact residual (a+b == s+e).
    Branchless, valid for any magnitudes; 6 flops. XLA does not reassociate
    float arithmetic, so the transform survives compilation (the driver's
    time carry relies on the same fact)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _update_leaf(hi, lo, d):
    """Fold increment d into the pair: TwoSum then renormalize (Fast2Sum),
    keeping hi the correctly-rounded value of the running sum."""
    s, e = two_sum(hi, d)
    lo = lo + e
    hi2 = s + lo
    lo2 = lo - (hi2 - s)
    return hi2, lo2


def update(hi: Pytree, lo: Pytree, d: Pytree) -> Tuple[Pytree, Pytree]:
    """(hi, lo) <- (hi, lo) + d over matching pytrees. Returns the new pair;
    fl(hi' + lo') == hi'."""
    h_leaves, treedef = jax.tree_util.tree_flatten(hi)
    l_leaves = jax.tree_util.tree_leaves(lo)
    d_leaves = jax.tree_util.tree_leaves(d)
    out_h, out_l = [], []
    for h, l, dd in zip(h_leaves, l_leaves, d_leaves):
        h2, l2 = _update_leaf(h, l, dd)
        out_h.append(h2)
        out_l.append(l2)
    return (
        jax.tree_util.tree_unflatten(treedef, out_h),
        jax.tree_util.tree_unflatten(treedef, out_l),
    )


def zero_lo(x: Pytree) -> Pytree:
    """The initial residual word (zeros shaped like the state)."""
    return jax.tree_util.tree_map(jnp.zeros_like, x)


def chain_increment(map_exp, phis, x: Pytree) -> Pytree:
    """Total increment of a propagator chain in increment form.

    Given phis = [phi_1, ..., phi_n] with U_i = I + phi_i, computes
    D = U_n ... U_1 x - x as

        D <- D + phi_i (x + D)        (i = 1..n)

    where every term is O(|D|): the full-state rounding eps*|x| of the
    intermediate x + D enters only multiplied by |phi| ~ |dy|/|y|, keeping
    the chain's noise at O(eps*|dy|). ``map_exp(phi, v)`` applies one phi
    (a split's propagator application works unchanged — phi is a matrix of
    the same shape as U)."""
    from . import lc

    D = map_exp(phis[0], x)
    for phi in phis[1:]:
        v = lc.add(x, D)
        D = lc.add(D, map_exp(phi, v))
    return D
