"""Reversible adjoint over CFM rows (diff.make_adjoint_cfm_solver):
primal == the fixed-step CFM main chain; gradients oracle-checked against
jax.grad through a direct expm scan of the same rows."""

import jax
import jax.numpy as jnp
import numpy as np

from vec_ode_tpu import diff
from vec_ode_tpu import tableaus as tb
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.expm import expm


def _setup(seed=0, d=4, B=3):
    rng = np.random.default_rng(seed)

    def herm():
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        return (M + M.conj().T) / 2

    Hs = [herm(), herm()]
    basis = cp.Cplx(
        jnp.asarray(np.stack([H.imag for H in Hs]), jnp.float64),
        jnp.asarray(np.stack([-H.real for H in Hs]), jnp.float64),
    )
    theta = jnp.asarray([0.7, -0.4], jnp.float64)

    def coeff(t, th):
        # K on the LAST axis: the modulated steppers call this with
        # batched (B,) times during the adaptive forward pass
        return jnp.stack([th[0] * jnp.ones_like(t),
                          th[1] * jnp.cos(2.0 * t)], axis=-1)

    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float64)
    y0w = jnp.concatenate([y0.re, y0.im], axis=-1)
    w = jnp.asarray(rng.standard_normal((B, 2 * d)), jnp.float64)
    return basis, theta, coeff, y0w, w


def _direct(basis, coeff, n_steps):
    from vec_ode_tpu.exp.modulated import _real_basis

    W = _real_basis(basis)
    alpha = np.asarray(tb.CFM_R4_J2_GL)
    c_nodes = [float(c) for c in tb.C_GAUSS_LEGENDRE_4]

    def solve(theta, y0w, t0, tf):
        dt = (tf - t0) / n_steps

        def rows_of(t):
            gs = [coeff(t + cj * dt, theta) for cj in c_nodes]
            return [dt * sum(float(alpha[i, j]) * gs[j]
                             for j in range(len(c_nodes)))
                    for i in range(alpha.shape[0])]

        def body(x, n):
            t = t0 + n * dt
            for r in rows_of(t):
                M = jnp.einsum("k,kij->ij", r, W)
                x = jnp.einsum("ij,...j->...i", expm(M, method="pade13"), x)
            return x, None

        xf, _ = jax.lax.scan(body, y0w, jnp.arange(n_steps, dtype=y0w.dtype))
        return xf

    return solve


def test_cfm_adjoint_primal_and_grads_match_direct():
    basis, theta, coeff, y0w, w = _setup()
    n_steps = 6
    adj = diff.make_adjoint_cfm_solver(
        basis, coeff, n_steps=n_steps)
    direct = _direct(basis, coeff, n_steps)

    yf_a = adj(theta, y0w, 0.1, 0.9)
    yf_d = direct(theta, y0w, 0.1, 0.9)
    np.testing.assert_allclose(np.asarray(yf_a), np.asarray(yf_d),
                               rtol=1e-9, atol=1e-11)

    def loss(solver):
        return lambda th, y, t0, tf: jnp.sum(w * solver(th, y, t0, tf))

    ga = jax.grad(loss(adj), argnums=(0, 1, 2, 3))(theta, y0w, 0.1, 0.9)
    gd = jax.grad(loss(direct), argnums=(0, 1, 2, 3))(theta, y0w, 0.1, 0.9)
    for a, d, name in zip(ga, gd, ("theta", "y0", "t0", "tf")):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(d), rtol=1e-7, atol=1e-9,
            err_msg=f"CFM adjoint {name} gradient mismatch")


def test_cfm_adjoint_custom_scheme_validation():
    basis, theta, coeff, y0w, _ = _setup(seed=2)
    import pytest

    with pytest.raises(ValueError, match="alpha must be"):
        diff.make_adjoint_cfm_solver(
            basis, coeff, n_steps=4, alpha=((0.5,),),
            c=(0.2, 0.8))

    # a custom 1-row scheme (exponential Euler on the GL2 average) runs
    solver = diff.make_adjoint_cfm_solver(
        basis, coeff, n_steps=8, alpha=((0.5, 0.5),),
        c=tuple(tb.C_GAUSS_LEGENDRE_4))
    yf = solver(theta, y0w, 0.0, 0.5)
    assert np.all(np.isfinite(np.asarray(yf)))


def test_cfm_adaptive_adjoint_matches_replay_oracle():
    """Adaptive CFM-4 adjoint (scheme='cfm4'): frozen-step-sequence
    gradients must equal jax.grad of the replayed discrete map."""
    import vec_ode_tpu as vo
    from vec_ode_tpu.exp.modulated import _real_basis

    basis, theta, coeff, y0w, w = _setup(seed=4)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.3, max_steps=64)
    solver = diff.make_adaptive_adjoint_solver(
        basis, coeff, ctl=ctl, scheme="cfm4")

    yf, status = solver(theta, y0w, 0.0, 0.8, 1e-2)
    assert (np.asarray(status) == 1).all()

    def loss(th):
        y, _ = solver(th, y0w, 0.0, 0.8, 1e-2)
        return jnp.sum(w * y)

    g = jax.grad(loss)(theta)

    # replay oracle: re-run the solve to harvest (t, dt) rows, then
    # differentiate the explicit product of CFM exponentials
    W = _real_basis(basis)
    alpha = np.asarray(tb.CFM_R4_J2_GL)
    cn = [float(c) for c in tb.C_GAUSS_LEGENDRE_4]

    # recover the accepted sequence by running the forward again and
    # diffing recorded times (the solver records ts internally; rebuild
    # it here from a fresh fixed replay through the public machinery)
    from vec_ode_tpu.driver import init_state, step_once
    from vec_ode_tpu.exp.modulated import CFM4Modulated, ModulatedOperator

    stepper = CFM4Modulated(
        ModulatedOperator(basis, lambda t: coeff(t, theta)))
    t_grid = vo.make_grid(0.0, 0.8, dtype=jnp.float64)
    st = init_state(
        cp.Cplx(y0w[..., :4], y0w[..., 4:]), t_grid,
        jnp.asarray(1e-2, jnp.float64), batch_shape=(y0w.shape[0],))
    ts = [st.t]
    for _ in range(ctl.max_steps):
        st = step_once(st, stepper.make_step_fn(), adaptive=True, ctl=ctl,
                       error_norm=stepper.error_norm, batched=True)
        ts.append(st.t)
    ts = jnp.stack(ts)          # (n_it+1, B)

    def loss_replay(th):
        x = y0w
        for r in range(ts.shape[0] - 1):
            t_r, dt_r = ts[r], ts[r + 1] - ts[r]
            gs = [jax.vmap(lambda t, d: coeff(t + cj * d, th))(t_r, dt_r)
                  for cj in cn]
            for i in range(alpha.shape[0]):
                row = dt_r[:, None] * sum(
                    float(alpha[i, j]) * gs[j].T for j in range(len(cn))
                ).T
                M = jnp.einsum("bk,kij->bij", row, W)
                U = expm(M, method="pade13")
                x = jnp.einsum("bij,bj->bi", U, x)
        return jnp.sum(w * x)

    g_ref = jax.grad(loss_replay)(theta)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-6, atol=1e-9)
