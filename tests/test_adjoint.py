"""O(1)-memory reversible-adjoint gradients (diff.adjoint_solve).

Oracle: jax.grad through a lax.scan of dense expm steps with the IDENTICAL
Magnus discretization (ops.expm carries an exact Fréchet-adjoint VJP), on
CPU f64 — the adjoint's gradients must match to near machine precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vec_ode_tpu import diff
from vec_ode_tpu.diff import _magnus_cols, adjoint_solve
from vec_ode_tpu.exp.modulated import ModulatedOperator, _real_basis
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.expm import expm
from vec_ode_tpu.utils.prec import HIGHEST


def _random_antiherm_basis(K, d, seed):
    """Cplx (K, d, d) basis of -i * H with H Hermitian (norm-preserving)."""
    rng = np.random.default_rng(seed)
    Hs = rng.standard_normal((K, d, d)) + 1j * rng.standard_normal((K, d, d))
    Hs = 0.5 * (Hs + np.conj(np.swapaxes(Hs, -1, -2)))
    M = -1j * Hs
    return cp.Cplx(jnp.asarray(M.real), jnp.asarray(M.imag))


def _coeff_fn(t, theta):
    # trailing-K convention (ModulatedOperator: batched t -> (..., K))
    return jnp.stack([jnp.ones_like(jnp.asarray(t)) * 1.0,
                      theta[0] * jnp.cos(theta[1] * t)], axis=-1)


def _oracle_solve(basis, theta, y0w, t0, tf, n_steps, order):
    """Same discrete scheme via dense expm (differentiable custom VJP)."""
    if order == 4:
        ext, pairs = ModulatedOperator(basis, lambda t: None
                                       ).commutator_extension()
        W = _real_basis(ext)
    else:
        W = _real_basis(basis)
        pairs = []
    K0 = basis.re.shape[0]
    dt = (tf - t0) / n_steps

    def body(x, n):
        c = _magnus_cols(_coeff_fn, K0, pairs, order, theta, t0 + n * dt, dt)
        M = jnp.einsum("k,kij->ij", c, W, precision=HIGHEST)
        U = expm(M)
        return jnp.einsum("ij,...j->...i", U, x, precision=HIGHEST), None

    xf, _ = jax.lax.scan(body, y0w, jnp.arange(n_steps, dtype=y0w.dtype))
    return xf


@pytest.mark.parametrize("order", [2, 4])
def test_adjoint_gradients_match_expm_oracle(order):
    d, K, n_steps = 3, 2, 24
    basis = _random_antiherm_basis(K, d, seed=1)
    rng = np.random.default_rng(2)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    y0 = cp.from_complex(z, jnp.float64)
    tgt = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    tgt /= np.linalg.norm(tgt)
    tgtw = jnp.concatenate([jnp.asarray(tgt.real), jnp.asarray(tgt.imag)])
    theta = jnp.asarray([0.8, 2.5], jnp.float64)

    def loss_adj(th, y):
        yf = adjoint_solve(basis, _coeff_fn, th, y, 0.0, 1.5, n_steps,
                           order=order)
        yw = jnp.concatenate([yf.re, yf.im], axis=-1)
        return -jnp.sum(yw * tgtw) ** 2

    def loss_orc(th, y):
        y0w = jnp.concatenate([y.re, y.im], axis=-1)
        yw = _oracle_solve(basis, th, y0w, 0.0, 1.5, n_steps, order)
        return -jnp.sum(yw * tgtw) ** 2

    va, (ga_th, ga_y) = jax.value_and_grad(loss_adj, argnums=(0, 1))(theta, y0)
    vo_, (go_th, go_y) = jax.value_and_grad(loss_orc, argnums=(0, 1))(theta, y0)
    np.testing.assert_allclose(float(va), float(vo_), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(ga_th), np.asarray(go_th),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ga_y.re), np.asarray(go_y.re),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ga_y.im), np.asarray(go_y.im),
                               rtol=1e-8, atol=1e-11)


def test_adjoint_batched_and_pytree_theta():
    """Batched ensemble states + pytree parameters; gradients match the
    oracle summed over the batch."""
    d, K, B, n_steps = 3, 2, 4, 16
    basis = _random_antiherm_basis(K, d, seed=3)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = {"amp": jnp.asarray(0.7, jnp.float64),
             "w": jnp.asarray(3.0, jnp.float64)}

    def cfn(t, th):
        return jnp.stack([jnp.ones_like(jnp.asarray(t)),
                          th["amp"] * jnp.sin(th["w"] * t)])

    def loss_adj(th):
        yf = adjoint_solve(basis, cfn, th, y0, 0.0, 1.0, n_steps, order=4)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 0] ** 2)

    def loss_orc(th):
        ext, pairs = ModulatedOperator(basis, lambda t: None
                                       ).commutator_extension()
        W = _real_basis(ext)
        dt = 1.0 / n_steps
        y0w = jnp.concatenate([y0.re, y0.im], axis=-1)

        def body(x, n):
            c = _magnus_cols(cfn, K, pairs, 4, th, n * dt, dt)
            U = expm(jnp.einsum("k,kij->ij", c, W, precision=HIGHEST))
            return jnp.einsum("ij,bj->bi", U, x, precision=HIGHEST), None

        xf, _ = jax.lax.scan(body, y0w,
                             jnp.arange(n_steps, dtype=jnp.float64))
        return jnp.sum(xf[:, 0] ** 2 + xf[:, d] ** 2)

    va, ga = jax.value_and_grad(loss_adj)(theta)
    vo_, go = jax.value_and_grad(loss_orc)(theta)
    np.testing.assert_allclose(float(va), float(vo_), rtol=1e-11)
    for k in ("amp", "w"):
        np.testing.assert_allclose(np.asarray(ga[k]), np.asarray(go[k]),
                                   rtol=1e-8, atol=1e-12)


def test_adjoint_forward_value_and_unitarity():
    """Forward value agrees with the generic adaptive Magnus-4 solver and
    stays on the unit sphere (anti-Hermitian basis)."""
    import vec_ode_tpu as vo
    from vec_ode_tpu import exp as vexp

    d, K, n_steps = 4, 2, 200
    basis = _random_antiherm_basis(K, d, seed=5)
    rng = np.random.default_rng(6)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.5, 1.7], jnp.float64)

    yf = adjoint_solve(basis, _coeff_fn, theta, y0, 0.0, 1.0, n_steps,
                       order=4)
    nrm = float(jnp.sqrt(jnp.sum(yf.re**2 + yf.im**2)))
    assert abs(nrm - 1.0) < 1e-10

    mod = ModulatedOperator(basis, lambda t: _coeff_fn(t, theta))
    sol = vo.solve_linear(
        mod.assemble, 0.0, 1.0, y0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()), adaptive=True,
        ctl=vo.StepControl(rtol=1e-10, atol=1e-12, min_dt=1e-8, max_dt=0.1),
        h0=1e-3, time_dtype=jnp.float64,
    )
    np.testing.assert_allclose(np.asarray(yf.re), np.asarray(sol.y_final.re),
                               atol=5e-8)
    np.testing.assert_allclose(np.asarray(yf.im), np.asarray(sol.y_final.im),
                               atol=5e-8)


def test_adaptive_adjoint_matches_frozen_sequence_oracle():
    """adjoint_solve_adaptive: gradients equal jax.grad of the discrete
    map over the RECORDED accepted step sequence (frozen-step-sequence
    discrete adjoint). The oracle replays the sequence with differentiable
    expm steps; the sequence itself comes from driving the public
    init_state/step_once machinery."""
    import vec_ode_tpu as vo
    from vec_ode_tpu.diff import adjoint_solve_adaptive
    from vec_ode_tpu.driver import init_state, make_grid, step_once
    from vec_ode_tpu.exp.modulated import MagnusModulated4

    d, K, B = 3, 2, 4
    basis = _random_antiherm_basis(K, d, seed=8)
    rng = np.random.default_rng(9)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.9, 2.2], jnp.float64)
    # large h0 forces early rejects -> the dt=0 identity rows are exercised
    ctl = vo.StepControl(rtol=1e-7, atol=1e-9, min_dt=1e-7, max_dt=0.4,
                         max_steps=256)
    h0 = 0.4

    def loss_adj(th, y):
        yf = adjoint_solve_adaptive(basis, _coeff_fn, th, y, 0.0, 1.0,
                                    ctl=ctl, h0=h0)
        yw = jnp.concatenate([yf.re, yf.im], axis=-1)
        return jnp.sum(yw[:, 0] ** 2)

    va, (ga_th, ga_y) = jax.value_and_grad(
        loss_adj, argnums=(0, 1))(theta, y0)

    # record the accepted step sequence with the same stepper/controller
    stepper = MagnusModulated4(
        __import__("vec_ode_tpu.exp.modulated", fromlist=["ModulatedOperator"]
                   ).ModulatedOperator(basis, lambda t: _coeff_fn(t, theta)),
        adaptive=True, )
    step_fn = stepper.make_step_fn()
    t_grid = make_grid(jnp.float64(0.0), jnp.float64(1.0),
                       dtype=jnp.float64)
    s = init_state(y0, t_grid, h0, batch_shape=(B,))
    step1 = jax.jit(lambda st: step_once(
        st, step_fn, adaptive=True, ctl=ctl,
        error_norm=stepper.error_norm, batched=True))
    ts = [np.asarray(s.t)]
    for _ in range(ctl.max_steps):
        s = step1(s)
        ts.append(np.asarray(s.t))
    assert (np.asarray(s.status) == vo.DONE).all()
    assert int(np.asarray(s.n_reject).sum()) > 0, "want rejects in the run"
    ts_all = jnp.asarray(np.stack(ts))            # (n_it+1, B)

    ext, pairs = ModulatedOperator(basis, lambda t: None
                                   ).commutator_extension()
    W = _real_basis(ext)

    def loss_orc(th, y):
        y0w = jnp.concatenate([y.re, y.im], axis=-1)

        def body(x, r):
            t_r, dt_r = ts_all[r], ts_all[r + 1] - ts_all[r]
            c = jax.vmap(
                lambda t, dt: _magnus_cols(_coeff_fn, K, pairs, 4, th, t, dt)
            )(t_r, dt_r)                          # (B, K'); 0 on dt=0 rows
            M = jnp.einsum("bk,kij->bij", c, W, precision=HIGHEST)
            U = jax.vmap(expm)(M)
            return jnp.einsum("bij,bj->bi", U, x, precision=HIGHEST), None

        xf, _ = jax.lax.scan(body, y0w, jnp.arange(ts_all.shape[0] - 1))
        return jnp.sum(xf[:, 0] ** 2)

    vo_, (go_th, go_y) = jax.value_and_grad(
        loss_orc, argnums=(0, 1))(theta, y0)
    np.testing.assert_allclose(float(va), float(vo_), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ga_th), np.asarray(go_th),
                               rtol=1e-7, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ga_y.re), np.asarray(go_y.re),
                               rtol=1e-7, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ga_y.im), np.asarray(go_y.im),
                               rtol=1e-7, atol=1e-11)


def test_adaptive_adjoint_truncation_is_loud():
    """A lane that exhausts ctl.max_steps before tf must come back NaN
    (default) or carry ERR_MAX_STEPS (return_status=True) — never a
    silently-truncated mid-integration state."""
    import vec_ode_tpu as vo
    from vec_ode_tpu.diff import adjoint_solve_adaptive

    d, K, B = 3, 2, 2
    basis = _random_antiherm_basis(K, d, seed=8)
    rng = np.random.default_rng(9)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.9, 2.2], jnp.float64)
    ctl = vo.StepControl(rtol=1e-10, atol=1e-12, min_dt=1e-9, max_dt=0.05,
                         max_steps=4)  # cannot reach tf=1.0

    yf = adjoint_solve_adaptive(basis, _coeff_fn, theta, y0, 0.0, 1.0,
                                ctl=ctl, h0=0.05)
    assert np.isnan(np.asarray(yf.re)).all()
    yf2, st = adjoint_solve_adaptive(basis, _coeff_fn, theta, y0, 0.0, 1.0,
                                     ctl=ctl, h0=0.05, return_status=True)
    assert (np.asarray(st) == vo.ERR_MAX_STEPS).all()
    assert np.isfinite(np.asarray(yf2.re)).all()
    # finished runs stay finite under the default poisoning path
    ctl_ok = vo.StepControl(rtol=1e-7, atol=1e-9, min_dt=1e-7, max_dt=0.4,
                            max_steps=256)
    yf3 = adjoint_solve_adaptive(basis, _coeff_fn, theta, y0, 0.0, 1.0,
                                 ctl=ctl_ok, h0=0.4)
    assert np.isfinite(np.asarray(yf3.re)).all()


def test_adjoint_memory_is_step_independent():
    """The residuals saved by the custom VJP must not scale with n_steps —
    check the jaxpr of the fwd pass closes over O(1) arrays (the point of
    the reversible adjoint vs method='scan')."""
    d, K = 3, 2
    basis = _random_antiherm_basis(K, d, seed=7)
    y0 = cp.from_complex(np.ones(d) / np.sqrt(d) + 0j, jnp.float64)
    theta = jnp.asarray([0.8, 2.5], jnp.float64)

    def loss(th, n_steps):
        yf = adjoint_solve(basis, _coeff_fn, th, y0, 0.0, 1.0, n_steps)
        return jnp.sum(yf.re**2)

    # residual pytree = (theta, y_final, t0, tf): count leaves x sizes
    for n in (8, 512):
        _, vjp_fn = jax.vjp(lambda th: loss(th, n), theta)
        res_size = sum(
            np.prod(np.shape(l))
            for l in jax.tree_util.tree_leaves(vjp_fn)
        )
        assert res_size < 200, (n, res_size)


def test_adjoint_time_endpoint_gradients():
    """t0/tf cotangents of the fixed-step adjoint are the EXACT discrete
    gradients — central finite differences of the same solve at the same
    n_steps must match to FD truncation error."""
    import vec_ode_tpu as vo

    d, K = 3, 2
    basis = _random_antiherm_basis(K, d, seed=12)
    rng = np.random.default_rng(13)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    y0 = cp.from_complex(z[None], jnp.float64)
    theta = jnp.asarray([0.7, 2.1], jnp.float64)

    def loss(t0, tf):
        yf = adjoint_solve(basis, _coeff_fn, theta, y0, t0, tf,
                           n_steps=64, order=4)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 1] ** 2)

    t0v, tfv = jnp.float64(0.1), jnp.float64(1.3)
    g0, gf = jax.grad(loss, argnums=(0, 1))(t0v, tfv)
    eps = 1e-6
    fd0 = (loss(t0v + eps, tfv) - loss(t0v - eps, tfv)) / (2 * eps)
    fdf = (loss(t0v, tfv + eps) - loss(t0v, tfv - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g0), float(fd0), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(float(gf), float(fdf), rtol=1e-7, atol=1e-10)


def test_adaptive_adjoint_time_endpoint_gradients():
    """Adaptive endpoint cotangents use the continuous identity
    dL/dtf = <a(tf), A(tf)x(tf)>; check against finite differences of the
    adaptive solve itself (noise ~ rtol/eps, so tolerances are loose)."""
    import vec_ode_tpu as vo
    from vec_ode_tpu.diff import adjoint_solve_adaptive

    d, K, B = 3, 2, 2
    basis = _random_antiherm_basis(K, d, seed=14)
    rng = np.random.default_rng(15)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.7, 2.1], jnp.float64)
    ctl = vo.StepControl(rtol=1e-9, atol=1e-11, min_dt=1e-9, max_dt=0.2,
                         max_steps=1024)

    def loss(t0, tf):
        yf = adjoint_solve_adaptive(basis, _coeff_fn, theta, y0, t0, tf,
                                    ctl=ctl, h0=0.05)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 1] ** 2)

    t0v, tfv = jnp.float64(0.1), jnp.float64(1.1)
    v, (g0, gf) = jax.value_and_grad(loss, argnums=(0, 1))(t0v, tfv)
    assert np.isfinite(float(v)), "base solve truncated — retune ctl"
    eps = 1e-4  # FD noise ~ rtol/eps = 1e-5 relative; truncation ~ eps^2
    fd0 = (loss(t0v + eps, tfv) - loss(t0v - eps, tfv)) / (2 * eps)
    fdf = (loss(t0v, tfv + eps) - loss(t0v, tfv - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g0), float(fd0), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(float(gf), float(fdf), rtol=2e-3, atol=1e-6)


def test_pulse_control_optimization_end_to_end():
    """Quantum optimal control through the reversible adjoint: Adam on the
    sine-mode pulse of models.PulseControl drives a 4-level state transfer
    from fidelity ~0.01 to >0.98 — the full capability chain (model →
    adjoint_solve → jax.value_and_grad → optax) in one loop."""
    import optax

    from vec_ode_tpu.models import PulseControl

    pc = PulseControl.make(d=4, seed=0, T=5.0, n_modes=6)
    psi0 = cp.from_complex(np.eye(4)[0][None].astype(complex), jnp.float64)
    tgt = cp.from_complex(np.eye(4)[2][None].astype(complex), jnp.float64)
    theta = 0.1 * jnp.ones(6, jnp.float64)

    vg = jax.jit(jax.value_and_grad(
        lambda th: pc.infidelity(th, psi0, tgt, n_steps=192)))
    opt = optax.adam(0.3)
    st = opt.init(theta)
    hist = []
    for _ in range(150):
        v, g = vg(theta)
        hist.append(float(v))
        up, st = opt.update(g, st)
        theta = optax.apply_updates(theta, up)
    assert hist[0] > 0.9, "initial transfer should be near-orthogonal"
    assert min(hist) < 0.02, f"optimization stalled: best inf {min(hist)}"


@pytest.mark.parametrize("saves", [(8, 16, 24), (5, 16, 24), (24,)])
def test_adjoint_trajectory_saves_match_oracle(saves):
    """save_at_steps: multi-time trajectory losses — values and ALL
    gradients (theta, y0, t0, tf) equal jax.grad of the expm-scan oracle
    accumulating the same loss at the same steps. Covers the uniform
    (nested-scan), irregular (unrolled), and terminal-only cases."""
    d, K, B, N = 3, 2, 2, 24
    basis = _random_antiherm_basis(K, d, seed=1)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.8, 2.5], jnp.float64)

    def loss(th, y, t0, tf):
        ys = adjoint_solve(basis, _coeff_fn, th, y, t0, tf, N, order=4,
                           save_at_steps=saves)
        return jnp.sum(ys.re[..., 0] ** 2) + 0.5 * jnp.sum(ys.im[..., 1] ** 2)

    ext, pairs = ModulatedOperator(basis, lambda t: None
                                   ).commutator_extension()
    W = _real_basis(ext)

    def loss_orc(th, y, t0, tf):
        dt = (tf - t0) / N
        y0w = jnp.concatenate([y.re, y.im], axis=-1)

        def body(x, n):
            c = _magnus_cols(_coeff_fn, K, pairs, 4, th, t0 + n * dt, dt)
            U = expm(jnp.einsum("k,kij->ij", c, W, precision=HIGHEST))
            return jnp.einsum("ij,bj->bi", U, x, precision=HIGHEST), None

        acc, x, prev = 0.0, y0w, 0
        for s in saves:
            x, _ = jax.lax.scan(body, x,
                                jnp.arange(prev, s, dtype=jnp.float64))
            prev = s
            acc = acc + (jnp.sum(x[:, :d][..., 0] ** 2)
                         + 0.5 * jnp.sum(x[:, d:][..., 1] ** 2))
        return acc

    args = (theta, y0, jnp.float64(0.2), jnp.float64(1.4))
    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(*args)
    vo_, go = jax.value_and_grad(loss_orc, argnums=(0, 1, 2, 3))(*args)
    np.testing.assert_allclose(float(v), float(vo_), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(g[0]), np.asarray(go[0]),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(g[1].re), np.asarray(go[1].re),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(g[1].im), np.asarray(go[1].im),
                               rtol=1e-8, atol=1e-11)
    for i in (2, 3):
        np.testing.assert_allclose(float(g[i]), float(go[i]),
                                   rtol=1e-8, atol=1e-11)


def test_adjoint_saves_validation():
    basis = _random_antiherm_basis(2, 3, seed=1)
    y0 = cp.from_complex(np.ones((1, 3)).astype(complex), jnp.float64)
    theta = jnp.asarray([0.8, 2.5], jnp.float64)
    for bad in [(0, 4), (4, 4), (5, 3), (9,), ()]:
        with pytest.raises(ValueError, match="save_at_steps"):
            adjoint_solve(basis, _coeff_fn, theta, y0, 0.0, 1.0, 8,
                          save_at_steps=bad)


def test_gate_synthesis_end_to_end():
    """Unitary synthesis through the adjoint: optimize the pulse to realize
    a Hadamard on a 2-level system (phase-invariant trace fidelity)."""
    import optax

    from vec_ode_tpu.models import PulseControl

    pc = PulseControl.make(d=2, seed=0, T=5.0, n_modes=6)
    H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    theta = 0.1 * jnp.ones(6, jnp.float64)
    vg = jax.jit(jax.value_and_grad(
        lambda th: pc.gate_infidelity(th, H, n_steps=192)))
    opt = optax.adam(0.3)
    st = opt.init(theta)
    hist = []
    for _ in range(200):
        v, g = vg(theta)
        hist.append(float(v))
        up, st = opt.update(g, st)
        theta = optax.apply_updates(theta, up)
    assert hist[0] > 0.5
    assert min(hist) < 1e-6, f"gate synthesis stalled: {min(hist)}"


def _real_core(Kp=3, D=8, seed=21):
    """An adjoint core over a random real (Kp, D, D) basis (order 2: the
    basis is used as given)."""
    rng = np.random.default_rng(seed)
    W = jnp.asarray(rng.standard_normal((Kp, D, D)) / np.sqrt(D))
    core = diff._adjoint_core(W, lambda t, th: None, order=2, m=None,
                              max_squarings=16)
    return rng, W, core


def test_adjoint_bwd_row_matches_expm_frechet():
    """One reverse row (reconstruct, transport, all-K Fréchet inner
    products) against dense f64 linear algebra: x_n = e^{-M} x_{n+1},
    a_n = (e^{M})^T a_{n+1}, cbar_k = <a_{n+1}, L(M, W_k) x_n> with L the
    Fréchet derivative of expm (ops.expm.expm_frechet)."""
    from vec_ode_tpu.ops.expm import expm_frechet

    rng, W, core = _real_core()
    Kp, D, B = W.shape[0], W.shape[1], 4
    c = jnp.asarray(rng.standard_normal((B, Kp)) * 0.4)
    x_next = jnp.asarray(rng.standard_normal((B, D)))
    a_next = jnp.asarray(rng.standard_normal((B, D)))
    xn, an, cb = diff._bwd_row(core, c, x_next, a_next, reduce=False)
    for b in range(B):
        M = jnp.einsum("k,kij->ij", c[b], W)
        U = expm(M)
        np.testing.assert_allclose(np.asarray(xn[b]),
                                   np.asarray(expm(-M) @ x_next[b]),
                                   rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(np.asarray(an[b]),
                                   np.asarray(U.T @ a_next[b]),
                                   rtol=1e-11, atol=1e-11)
        cb_ref = [float(a_next[b] @ (expm_frechet(M, W[k]) @ xn[b]))
                  for k in range(Kp)]
        np.testing.assert_allclose(np.asarray(cb[b]), cb_ref,
                                   rtol=1e-9, atol=1e-11)


def test_adjoint_gradient_shards_over_mesh():
    """Multi-chip gradients: value_and_grad of an adjoint-solve loss with
    the trajectory batch sharded over an 8-device mesh equals the
    replicated result — the adjoint is batch-parallel, so GSPMD partitions
    both sweeps and inserts the theta-reduction psums automatically."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vec_ode_tpu.parallel import ensemble_mesh

    if jax.device_count() < 8:
        pytest.skip("needs the 8-device CPU mesh")

    d, K, B = 3, 2, 16
    basis = _random_antiherm_basis(K, d, seed=17)
    rng = np.random.default_rng(18)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.8, 2.5], jnp.float64)

    def loss(th, y):
        yf = adjoint_solve(basis, _coeff_fn, th, y, 0.0, 1.0, 32,
                           order=4)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 0] ** 2)

    v0, g0 = jax.value_and_grad(loss)(theta, y0)

    mesh = ensemble_mesh()
    sh = NamedSharding(mesh, P("traj"))
    y0s = cp.Cplx(jax.device_put(y0.re, sh), jax.device_put(y0.im, sh))
    v1, g1 = jax.jit(jax.value_and_grad(loss))(theta, y0s)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-10)


def test_rows_sweeps_match_dense_vjp():
    """Forward R-row sweep == R sequential dense expm applications;
    backward sweep's (a0, per-row cbar) == jax.vjp of that dense forward
    composition w.r.t. (x0, rows) (f64)."""
    rng, W, core = _real_core(seed=23)
    Kp, D, B, R = W.shape[0], W.shape[1], 4, 5
    c_all = jnp.asarray(rng.standard_normal((R, Kp)) * 0.3)
    x0 = jnp.asarray(rng.standard_normal((B, D)))
    abar = jnp.asarray(rng.standard_normal((B, D)))

    def dense_forward(x, rows):
        for r in range(R):
            U = expm(jnp.einsum("k,kij->ij", rows[r], W))
            x = jnp.einsum("ij,bj->bi", U, x, precision=HIGHEST)
        return x

    yk = diff._rows_forward(core, c_all, x0)
    yr, vjp = jax.vjp(dense_forward, x0, c_all)
    np.testing.assert_allclose(np.asarray(yk), np.asarray(yr),
                               rtol=1e-11, atol=1e-11)
    a0_r, cb_r = vjp(abar)
    a0_k, cb_k = diff._rows_backward(core, c_all, yk, abar)
    np.testing.assert_allclose(np.asarray(a0_k), np.asarray(a0_r),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(cb_k), np.asarray(cb_r),
                               rtol=1e-8, atol=1e-10)


def test_adjoint_order6_convergence():
    """order=6 (Yoshida triple-jump of the symmetric Magnus-4 step):
    terminal-state error must shrink ~h^6, clearly separated from order
    4 at the same step counts."""
    from vec_ode_tpu.diff import _YOSHIDA_LEN

    assert abs(sum(_YOSHIDA_LEN) - 1.0) < 1e-15
    d, K = 4, 2
    basis = _random_antiherm_basis(K, d, seed=31)
    rng = np.random.default_rng(32)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.9, 2.4], jnp.float64)

    ref = adjoint_solve(basis, _coeff_fn, theta, y0, 0.0, 1.5, 512,
                        order=6)
    refw = np.concatenate([np.asarray(ref.re), np.asarray(ref.im)])

    def err(n, order):
        yf = adjoint_solve(basis, _coeff_fn, theta, y0, 0.0, 1.5, n,
                           order=order)
        yw = np.concatenate([np.asarray(yf.re), np.asarray(yf.im)])
        return np.linalg.norm(yw - refw)

    ns = np.array([6, 12, 24])
    e6 = np.array([err(int(n), 6) for n in ns])
    slope6 = np.polyfit(np.log(ns), np.log(e6), 1)[0]
    assert -6.8 < slope6 < -5.5, (slope6, e6)
    # order 6 beats order 4 outright at equal step count
    e4 = err(24, 4)
    assert e6[-1] < e4 / 30, (e6[-1], e4)


def test_adjoint_order6_gradients_match_expm_oracle():
    """order=6 gradients (theta, y0, t0, tf) equal jax.grad of an expm
    scan replaying the same three Yoshida sub-rows per step."""
    from vec_ode_tpu.diff import _YOSHIDA_LEN, _YOSHIDA_OFF

    d, K, N = 3, 2, 12
    basis = _random_antiherm_basis(K, d, seed=33)
    rng = np.random.default_rng(34)
    z = rng.standard_normal((2, d)) + 1j * rng.standard_normal((2, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.8, 2.5], jnp.float64)

    def loss(th, y, t0, tf):
        yf = adjoint_solve(basis, _coeff_fn, th, y, t0, tf, N, order=6)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 1] ** 2)

    ext, pairs = ModulatedOperator(basis, lambda t: None
                                   ).commutator_extension()
    W = _real_basis(ext)

    def loss_orc(th, y, t0, tf):
        dt = (tf - t0) / N
        y0w = jnp.concatenate([y.re, y.im], axis=-1)
        x = y0w
        for n in range(N):
            tn = t0 + n * dt
            for o, l in zip(_YOSHIDA_OFF, _YOSHIDA_LEN):
                c = _magnus_cols(_coeff_fn, K, pairs, 4, th,
                                 tn + o * dt, l * dt)
                U = expm(jnp.einsum("k,kij->ij", c, W, precision=HIGHEST))
                x = jnp.einsum("ij,bj->bi", U, x, precision=HIGHEST)
        return jnp.sum(x[:, :d][:, 0] ** 2 + x[:, d:][:, 1] ** 2)

    args = (theta, y0, jnp.float64(0.1), jnp.float64(1.2))
    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(*args)
    vo_, go = jax.value_and_grad(loss_orc, argnums=(0, 1, 2, 3))(*args)
    np.testing.assert_allclose(float(v), float(vo_), rtol=1e-11)
    np.testing.assert_allclose(np.asarray(g[0]), np.asarray(go[0]),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(g[1].re), np.asarray(go[1].re),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(g[1].im), np.asarray(go[1].im),
                               rtol=1e-8, atol=1e-11)
    for i in (2, 3):
        np.testing.assert_allclose(float(g[i]), float(go[i]),
                                   rtol=1e-8, atol=1e-11)


def test_adaptive_adjoint_rejects_unbatched_state():
    import vec_ode_tpu as vo
    from vec_ode_tpu.diff import adjoint_solve_adaptive

    basis = _random_antiherm_basis(2, 3, seed=8)
    y0 = cp.from_complex(np.ones(3).astype(complex) / np.sqrt(3),
                         jnp.float64)  # NO batch axis
    theta = jnp.asarray([0.9, 2.2], jnp.float64)
    ctl = vo.StepControl(rtol=1e-6, max_steps=64)
    with pytest.raises(ValueError, match="BATCHED"):
        adjoint_solve_adaptive(basis, _coeff_fn, theta, y0, 0.0, 1.0,
                               ctl=ctl, h0=0.1)


def test_adaptive_adjoint_mixed_time_dtypes():
    """t0/tf/h0 cotangents must carry their OWN primal dtypes."""
    import vec_ode_tpu as vo
    from vec_ode_tpu.diff import adjoint_solve_adaptive

    d, K, B = 3, 2, 2
    basis = _random_antiherm_basis(K, d, seed=8)
    rng = np.random.default_rng(9)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.9, 2.2], jnp.float64)
    ctl = vo.StepControl(rtol=1e-6, atol=1e-8, min_dt=1e-7, max_dt=0.4,
                         max_steps=128)

    def loss(t0, tf, h0):
        yf = adjoint_solve_adaptive(basis, _coeff_fn, theta, y0,
                                    t0, tf, ctl=ctl, h0=h0)
        return jnp.sum(yf.re[:, 0] ** 2).astype(jnp.float32)

    g0, gf, gh = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.float32(0.0), jnp.float64(1.0), jnp.float64(0.2))
    assert g0.dtype == jnp.float32 and gf.dtype == jnp.float64
    assert gh.dtype == jnp.float64 and float(gh) == 0.0
    assert np.isfinite(float(g0)) and np.isfinite(float(gf))


def test_adjoint_three_controls_matches_oracle():
    """K=3 basis (two independent controls + drift): the commutator
    extension grows to Kp = 6; gradients must still match the expm oracle
    exactly (exercises the adjoint's generic-K machinery, orders 4 and 6)."""
    d, K, N = 3, 3, 10
    basis = _random_antiherm_basis(K, d, seed=41)
    rng = np.random.default_rng(42)
    z = rng.standard_normal((2, d)) + 1j * rng.standard_normal((2, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.8, 2.5, -0.6, 1.4], jnp.float64)

    def cfn(t, th):
        t = jnp.asarray(t)
        return jnp.stack([jnp.ones_like(t),
                          th[0] * jnp.cos(th[1] * t),
                          th[2] * jnp.sin(th[3] * t)], axis=-1)

    for order in (4, 6):
        def loss(th):
            yf = adjoint_solve(basis, cfn, th, y0, 0.0, 1.2, N,
                               order=order)
            return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 1] ** 2)

        ext, pairs = ModulatedOperator(basis, lambda t: None
                                       ).commutator_extension()
        assert len(pairs) == 3 and ext.re.shape[0] == 6
        W = _real_basis(ext)

        def loss_orc(th):
            from vec_ode_tpu.diff import _YOSHIDA_LEN, _YOSHIDA_OFF

            subs = (list(zip(_YOSHIDA_OFF, _YOSHIDA_LEN))
                    if order == 6 else [(0.0, 1.0)])
            dt = 1.2 / N
            x = jnp.concatenate([y0.re, y0.im], axis=-1)
            for n in range(N):
                tn = n * dt
                for o, l in subs:
                    c = _magnus_cols(cfn, K, pairs, 4, th,
                                     tn + o * dt, l * dt)
                    U = expm(jnp.einsum("k,kij->ij", c, W,
                                        precision=HIGHEST))
                    x = jnp.einsum("ij,bj->bi", U, x, precision=HIGHEST)
            return jnp.sum(x[:, :d][:, 0] ** 2 + x[:, d:][:, 1] ** 2)

        v, g = jax.value_and_grad(loss)(theta)
        vo_, go = jax.value_and_grad(loss_orc)(theta)
        np.testing.assert_allclose(float(v), float(vo_), rtol=1e-11)
        np.testing.assert_allclose(np.asarray(g), np.asarray(go),
                                   rtol=1e-8, atol=1e-11)


def test_adaptive_adjoint_order6():
    """order=6 adaptive adjoint: forward equals the public Magnus-6
    adaptive solve; theta gradients match central finite differences of
    the solve itself (FD noise ~ rtol/eps)."""
    import vec_ode_tpu as vo
    from vec_ode_tpu.diff import adjoint_solve_adaptive

    d, K, B = 3, 2, 2
    basis = _random_antiherm_basis(K, d, seed=51)
    rng = np.random.default_rng(52)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    theta = jnp.asarray([0.9, 2.2], jnp.float64)
    ctl = vo.StepControl(rtol=1e-9, atol=1e-11, min_dt=1e-9, max_dt=0.4,
                         max_steps=256)

    def loss(th):
        yf = adjoint_solve_adaptive(basis, _coeff_fn, th, y0, 0.0, 1.0,
                                    ctl=ctl, order=6, h0=0.2)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 1] ** 2)

    v, g = jax.value_and_grad(loss)(theta)
    assert np.isfinite(float(v))
    eps = 1e-4
    for i in range(2):
        e = jnp.zeros(2).at[i].set(eps)
        fd = (loss(theta + e) - loss(theta - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd),
                                   rtol=2e-3, atol=1e-6)

    # order 6 takes far fewer accepted iterations than order 4 at this rtol
    _, st6 = adjoint_solve_adaptive(basis, _coeff_fn, theta, y0, 0.0, 1.0,
                                    ctl=ctl, order=6, h0=0.2,
                                    return_status=True)
    assert (np.asarray(st6) == vo.DONE).all()


def test_duration_gradient_total_derivative():
    """Time-optimal control: d/dT of a loss where T is BOTH the endpoint
    and a pulse-shape parameter (u = sum_j a_j sin(j pi t / T)) — the
    exact-discrete tf cotangent and the coeff_fn theta path must compose
    into the correct total derivative (checked by finite differences)."""
    d, K, N = 3, 2, 48
    basis = _random_antiherm_basis(K, d, seed=61)
    rng = np.random.default_rng(62)
    z = rng.standard_normal((1, d)) + 1j * rng.standard_normal((1, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    amps = jnp.asarray([0.4, -0.3, 0.2], jnp.float64)

    def cfn(t, th):
        t = jnp.asarray(t)
        j = jnp.arange(1, 4, dtype=jnp.float64)
        u = jnp.sum(th["a"] * jnp.sin(j * (jnp.pi / th["T"]) * t[..., None]),
                    axis=-1)
        return jnp.stack([jnp.ones_like(u), u], axis=-1)

    def loss(T):
        th = {"a": amps, "T": T}
        yf = adjoint_solve(basis, cfn, th, y0, 0.0, T, N, order=4)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 1] ** 2)

    T0 = jnp.float64(2.3)
    g = jax.grad(loss)(T0)
    eps = 1e-6
    fd = (loss(T0 + eps) - loss(T0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-6, atol=1e-10)


def test_adjoint_vmaps_over_pulses():
    """jax.vmap composes over the adjoint solve: P independent pulse
    parameter sets optimized in ONE batched program (GRAPE over many
    targets / robust-control ensembles). Values and gradients must equal
    the per-pulse loop."""
    d, K, P = 3, 2, 5
    basis = _random_antiherm_basis(K, d, seed=71)
    rng = np.random.default_rng(72)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    y0 = cp.from_complex(z[None], jnp.float64)
    thetas = jnp.asarray(rng.standard_normal((P, 2)), jnp.float64)

    def loss(th):
        yf = adjoint_solve(basis, _coeff_fn, th, y0, 0.0, 1.0, 32)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 0] ** 2)

    vv, gv = jax.vmap(jax.value_and_grad(loss))(thetas)
    for p in range(P):
        v, g = jax.value_and_grad(loss)(thetas[p])
        np.testing.assert_allclose(float(vv[p]), float(v), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(gv[p]), np.asarray(g),
                                   rtol=1e-10)
