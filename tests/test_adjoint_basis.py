"""Basis-matrix gradients through the reversible adjoint
(diff.make_adjoint_basis_solver): oracle is
jax.grad through a direct expm-based differentiable scan of the SAME
discrete scheme."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vec_ode_tpu import diff
from vec_ode_tpu.exp.modulated import _real_basis
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.expm import expm

D0 = 4  # complex dim; embedded D = 8


def _setup(seed=0, K=2):
    rng = np.random.default_rng(seed)

    def herm(_):
        M = rng.standard_normal((D0, D0)) + 1j * rng.standard_normal(
            (D0, D0))
        return (M + M.conj().T) / 2

    Hs = [herm(k) for k in range(K)]
    basis = cp.Cplx(
        jnp.asarray(np.stack([H.imag for H in Hs]), jnp.float64),
        jnp.asarray(np.stack([-H.real for H in Hs]), jnp.float64),
    )  # -i H_k
    theta = jnp.asarray([0.8, -0.3], jnp.float64)

    def coeff(t, th):
        return jnp.stack([jnp.ones_like(t) * th[0],
                          th[1] * jnp.sin(3.0 * t)])

    B = 3
    psi = rng.standard_normal((B, D0)) + 1j * rng.standard_normal((B, D0))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float64)
    y0w = jnp.concatenate([y0.re, y0.im], axis=-1)
    w = jnp.asarray(rng.standard_normal((B, 2 * D0)), jnp.float64)
    return basis, theta, coeff, y0w, w


def _direct_solver(coeff, n_steps, order):
    """Differentiable oracle: expm-propagator scan of the same rows."""
    from functools import partial

    def solve(theta, y0w, t0, tf, W0):
        K0 = W0.shape[0]
        pairs = ([(j, k) for j in range(K0) for k in range(j + 1, K0)]
                 if order in (4, 6) else [])
        W_ext = diff._extend_w(W0, pairs)
        cols = partial(diff._magnus_cols, coeff, K0, pairs, min(order, 4))
        c_all = diff._make_rows_all(cols, order, n_steps)(theta, t0, tf)
        M_all = jnp.einsum("rk,kij->rij", c_all, W_ext)
        U_all = expm(M_all, method="pade13")

        def body(x, U):
            return jnp.einsum("ij,...j->...i", U, x), None

        xf, _ = jax.lax.scan(body, y0w, U_all)
        return xf

    return solve


@pytest.mark.parametrize("order", [2, 4, 6])
def test_basis_grad_matches_direct(order):
    basis, theta, coeff, y0w, w = _setup()
    n_steps = 6
    W0 = _real_basis(basis)
    adj = diff.make_adjoint_basis_solver(
        basis, coeff, n_steps=n_steps, order=order)
    direct = _direct_solver(coeff, n_steps, order)

    def loss(solver):
        return lambda th, y, W: jnp.sum(
            w * solver(th, y, 0.0, 0.7, W))

    ga = jax.grad(loss(adj), argnums=(0, 1, 2))(theta, y0w, W0)
    gd = jax.grad(loss(direct), argnums=(0, 1, 2))(theta, y0w, W0)
    for a, d, name in zip(ga, gd, ("theta", "y0", "basis")):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(d), rtol=1e-7, atol=1e-9,
            err_msg=f"order {order}: {name} gradient mismatch")


def test_basis_grad_through_cplx_pair():
    """adjoint_solve(basis_grad=True): gradients w.r.t. the Cplx basis
    pytree flow through the ring embedding."""
    basis, theta, coeff, y0w, w = _setup(seed=3)
    y0 = cp.Cplx(y0w[..., :D0], y0w[..., D0:])

    def loss(b):
        yf = diff.adjoint_solve(
            b, coeff, theta, y0, 0.0, 0.5, 5, order=4, basis_grad=True)
        return jnp.sum(w[..., :D0] * yf.re) + jnp.sum(w[..., D0:] * yf.im)

    g = jax.grad(loss)(basis)
    assert g.re.shape == basis.re.shape and g.im.shape == basis.im.shape

    # finite-difference check on a single basis entry (re and im)
    eps = 1e-6
    for part in ("re", "im"):
        db = cp.Cplx(jnp.zeros_like(basis.re), jnp.zeros_like(basis.im))
        db = db._replace(**{part: db._asdict()[part].at[1, 2, 3].set(1.0)})
        lp = loss(cp.Cplx(basis.re + eps * db.re, basis.im + eps * db.im))
        lm = loss(cp.Cplx(basis.re - eps * db.re, basis.im - eps * db.im))
        fd = (lp - lm) / (2 * eps)
        an = getattr(g, part)[1, 2, 3]
        np.testing.assert_allclose(np.asarray(an), np.asarray(fd),
                                   rtol=1e-5, atol=1e-7, err_msg=part)


def test_basis_grad_endpoint_and_theta_consistency():
    """The basis-grad solver's theta/t0/tf cotangents must agree with the
    production make_adjoint_solver (same discrete scheme, different
    cotangent factorization: <W_k, Gbar_r> vs augmented actions)."""
    basis, theta, coeff, y0w, w = _setup(seed=5)
    n_steps = 5
    W0 = _real_basis(basis)
    adj_b = diff.make_adjoint_basis_solver(
        basis, coeff, n_steps=n_steps, order=4)
    adj = diff.make_adjoint_solver(
        basis, coeff, n_steps=n_steps, order=4)

    gb = jax.grad(
        lambda th, t0, tf: jnp.sum(w * adj_b(th, y0w, t0, tf, W0)),
        argnums=(0, 1, 2))(theta, 0.1, 0.9)
    ga = jax.grad(
        lambda th, t0, tf: jnp.sum(w * adj(th, y0w, t0, tf)),
        argnums=(0, 1, 2))(theta, 0.1, 0.9)
    for a, b, name in zip(ga, gb, ("theta", "t0", "tf")):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-8, atol=1e-10, err_msg=name)
