"""Anchored adjoint for DISSIPATIVE operators:
on a strongly damped system, backward reconstruction with inverse
propagators amplifies roundoff ~e^{2 gamma T}; anchoring every k steps
bounds it per segment. Oracle: jax.grad through the differentiable scan
driver on the same discrete scheme."""

import jax
import jax.numpy as jnp
import numpy as np

from vec_ode_tpu import diff
from vec_ode_tpu.ops.expm import expm


def _damped_setup(gamma=6.0, seed=0):
    """K=2 real basis: a rotation generator and a STRONG contraction —
    over T=1 the propagator contracts by ~e^-gamma, so backward
    reconstruction amplifies by ~e^{+gamma} per unit time."""
    rng = np.random.default_rng(seed)
    D = 8
    S = rng.standard_normal((D, D))
    W1 = jnp.asarray((S - S.T) * 0.7, jnp.float64)
    diag = -gamma * (0.5 + rng.uniform(0, 1, D))
    W2 = jnp.asarray(np.diag(diag), jnp.float64)
    basis = jnp.stack([W1, W2])
    theta = jnp.asarray([1.0, 0.9], jnp.float64)

    def coeff(t, th):
        return jnp.stack([th[0] * jnp.cos(2.0 * t),
                          th[1] * jnp.ones_like(t)])

    B = 4
    y0w = jnp.asarray(rng.standard_normal((B, D)), jnp.float64)
    w = jnp.asarray(rng.standard_normal((B, D)), jnp.float64)
    return basis, theta, coeff, y0w, w


def _oracle_grad(basis, coeff, theta, y0w, w, n_steps, order):
    """Direct differentiable propagator scan (stores everything)."""
    from functools import partial

    K0 = basis.shape[0]
    pairs = [(j, k) for j in range(K0) for k in range(j + 1, K0)]
    W_ext = diff._extend_w(basis, pairs)
    cols = partial(diff._magnus_cols, coeff, K0, pairs, min(order, 4))
    rows_all = diff._make_rows_all(cols, order, n_steps)

    def loss(th):
        c_all = rows_all(th, 0.0, 1.0)
        M_all = jnp.einsum("rk,kij->rij", c_all, W_ext)
        U_all = expm(M_all, method="pade13")

        def body(x, U):
            return jnp.einsum("ij,...j->...i", U, x), None

        xf, _ = jax.lax.scan(body, y0w, U_all)
        return jnp.sum(w * xf)

    return jax.grad(loss)(theta)


def test_anchoring_bounds_dissipative_gradient_error():
    # gamma*T = 40: backward amplification e^{~80} makes the plain
    # sweep lose ~7 digits even in f64; anchoring stays at eps
    basis, theta, coeff, y0w, w = _damped_setup(gamma=40.0)
    n_steps = 64
    g_ref = _oracle_grad(basis, coeff, theta, y0w, w, n_steps, order=4)

    def grad_with(anchor_every):
        def loss(th):
            yf = diff.adjoint_solve(
                basis, coeff, th, y0w, 0.0, 1.0, n_steps, order=4,
                anchor_every=anchor_every)
            return jnp.sum(w * yf)

        return jax.grad(loss)(theta)

    scale = float(jnp.max(jnp.abs(g_ref)))
    err_plain = float(jnp.max(jnp.abs(grad_with(None) - g_ref))) / scale
    err_anchor = float(jnp.max(jnp.abs(grad_with(8) - g_ref))) / scale

    # anchored gradients are oracle-tight; the plain O(1) sweep must be
    # MEASURABLY worse on this contraction (else the test guards nothing)
    assert err_anchor < 1e-12, err_anchor
    assert err_plain > 1e-10, err_plain
    assert err_plain > 100 * err_anchor, (err_plain, err_anchor)


def test_anchored_primal_matches_plain():
    """Anchoring changes the backward factorization only — the forward
    solve is the identical discrete scheme."""
    basis, theta, coeff, y0w, _ = _damped_setup(gamma=3.0)
    kw = dict(order=4)
    yf_a = diff.adjoint_solve(basis, coeff, theta, y0w, 0.0, 1.0, 32,
                              anchor_every=8, **kw)
    yf_p = diff.adjoint_solve(basis, coeff, theta, y0w, 0.0, 1.0, 32, **kw)
    np.testing.assert_allclose(np.asarray(yf_a), np.asarray(yf_p),
                               rtol=1e-12, atol=1e-14)


def test_anchor_every_validation():
    basis, theta, coeff, y0w, _ = _damped_setup()
    import pytest

    with pytest.raises(ValueError):
        diff.adjoint_solve(basis, coeff, theta, y0w, 0.0, 1.0, 16,
                           anchor_every=0)
    with pytest.raises(ValueError):
        diff.adjoint_solve(basis, coeff, theta, y0w, 0.0, 1.0, 16,
                           anchor_every=4, save_at_steps=(8, 16))
    with pytest.raises(ValueError):
        diff.adjoint_solve(basis, coeff, theta, y0w, 0.0, 1.0, 16,
                           anchor_every=4, basis_grad=True)
