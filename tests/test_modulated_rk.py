"""Batched modulated-linear RK step (ops/modulated_rk.py) against the
generic driver path and per-trajectory solves."""

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK, xla_rk_step
from vec_ode_tpu.parallel import ensemble_solve


def setup(B=8, d=64, dtype=jnp.float32):
    model = DrivenDense.make(d=d, seed=0)
    rng = np.random.default_rng(3)
    psi0 = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi0, dtype)
    stepper = FusedModulatedLinearRK.from_driven_dense(model, dtype)
    return model, y0, stepper


def test_xla_step_matches_generic_rhs():
    model, y0, st = setup(B=4, d=64, dtype=jnp.float64)
    t = jnp.asarray([0.0, 0.1, 0.2, 0.3], jnp.float64)
    dt = jnp.full((4,), 0.01, jnp.float64)
    xw = jnp.concatenate([y0.re, y0.im], axis=-1)
    ox, oe = xla_rk_step(
        t, dt, xw,
        st.M0.astype(jnp.float64), st.M1.astype(jnp.float64),
        u_fn=st.u_fn,
    )
    # generic path: vmapped rk_step over the pair rhs
    from vec_ode_tpu.rk import rk_step

    def one(ti, yi_re, yi_im, dti):
        xn, err = rk_step(
            lambda tt, y: model.rhs_pair(tt, y, jnp.float64),
            ti, cp.Cplx(yi_re, yi_im), dti, vo.RKF45,
        )
        from vec_ode_tpu import lc

        return xn, lc.norm_l2(err)

    xn, en = jax.vmap(one)(t, y0.re, y0.im, dt)
    # same math, different contraction/association order -> ~1e-11 slack
    np.testing.assert_allclose(
        np.asarray(ox[:, :64]), np.asarray(xn.re), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(ox[:, 64:]), np.asarray(xn.im), atol=1e-9
    )
    np.testing.assert_allclose(np.asarray(oe), np.asarray(en), rtol=1e-3)


def test_xla_step_f32_matches_f64():
    """The f32 step against the same step in f64: the state agrees to f32
    rounding of O(1) values; the error norm is a small difference of
    nearly equal stage sums, so it agrees to f32 rounding of |x|."""
    model, y0, st = setup(B=256, d=64, dtype=jnp.float64)
    t = jnp.linspace(0.0, 0.5, 256, dtype=jnp.float64)
    dt = jnp.full((256,), 0.05, jnp.float64)
    xw = jnp.concatenate([y0.re, y0.im], axis=-1)
    ox64, oe64 = xla_rk_step(t, dt, xw, st.M0, st.M1, u_fn=st.u_fn)
    ox32, oe32 = xla_rk_step(
        t.astype(jnp.float32), dt.astype(jnp.float32),
        xw.astype(jnp.float32), st.M0.astype(np.float32),
        st.M1.astype(np.float32), u_fn=st.u_fn)
    assert ox32.dtype == jnp.float32 and oe32.shape == (256,)
    np.testing.assert_allclose(np.asarray(ox32), np.asarray(ox64), atol=2e-6)
    np.testing.assert_allclose(np.asarray(oe32), np.asarray(oe64), atol=2e-6)


def test_fused_stepper_ensemble_matches_generic():
    model, y0, st = setup(B=16, d=64, dtype=jnp.float64)
    st64 = FusedModulatedLinearRK(
        M0=st.M0.astype(jnp.float64), M1=st.M1.astype(jnp.float64),
        u_fn=st.u_fn,
    )
    ctl = vo.StepControl(rtol=1e-8, max_dt=0.25)
    sol_f = ensemble_solve(
        None, y0, 0.0, 0.5, stepper=st64, ctl=ctl, h0=1e-3,
        time_dtype=jnp.float64,
    )
    sol_g = ensemble_solve(
        lambda t, y: model.rhs_pair(t, y, jnp.float64), y0, 0.0, 0.5,
        ctl=ctl, h0=1e-3, time_dtype=jnp.float64,
    )
    assert all(int(s) == vo.DONE for s in sol_f.status)
    np.testing.assert_array_equal(
        np.asarray(sol_f.n_accept), np.asarray(sol_g.n_accept)
    )
    np.testing.assert_allclose(
        np.asarray(sol_f.y_final.re), np.asarray(sol_g.y_final.re),
        atol=1e-9,
    )
    assert sol_f.ts.shape == (16, 2)


def test_fused_stepper_sharded():
    from vec_ode_tpu.parallel import ensemble_mesh, shard_batch

    model, y0, st = setup(B=32, d=64, dtype=jnp.float32)
    mesh = ensemble_mesh()
    ctl = vo.StepControl(rtol=1e-6, max_dt=0.25)
    sol = ensemble_solve(
        None, shard_batch(y0, mesh), 0.0, 0.3, stepper=st, ctl=ctl,
        h0=1e-3, time_dtype=jnp.float32, mesh=mesh,
    )
    assert all(int(s) == vo.DONE for s in sol.status)
    norms = np.linalg.norm(np.asarray(cp.to_complex(sol.y_final)), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_fused_rejects_rhs():
    _, _, st = setup()
    try:
        st.make_step_fn(lambda t, y: y)
        assert False
    except ValueError:
        pass


def test_fused_non_embedded_tableau_adaptive_raises():
    # RK4 has no embedded pair: the adaptive driver must raise, not silently
    # accept on a zero error estimate
    _, y0, st = setup(B=8, d=64, dtype=jnp.float64)
    st4 = FusedModulatedLinearRK(
        M0=st.M0.astype(jnp.float64), M1=st.M1.astype(jnp.float64),
        u_fn=st.u_fn, tableau=vo.RK4,
    )
    try:
        ensemble_solve(None, y0, 0.0, 0.1, stepper=st4, adaptive=True,
                       h0=1e-2, time_dtype=jnp.float64)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "error estimate" in str(e)
    # fixed-step mode works fine
    sol = ensemble_solve(None, y0, 0.0, 0.1, stepper=st4, adaptive=False,
                         h0=1e-2, time_dtype=jnp.float64)
    assert all(int(s) == vo.DONE for s in sol.status)


def test_batched_ensemble_matches_per_trajectory_solves():
    """The natively batched stepper under the XLA driver against each
    trajectory solved alone (unbatched solve_ivp on the same pair RHS):
    per-trajectory control must make each lane's step sequence its own."""
    model = DrivenDense.make(d=8, seed=0)
    rng = np.random.default_rng(31)
    B = 6
    z = rng.standard_normal((B, 8)) + 1j * rng.standard_normal((B, 8))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    z[0] *= 3.0        # lanes with different scales take different steps
    y0 = cp.from_complex(z, jnp.float64)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.25, max_steps=500)
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float64)
    sol = ensemble_solve(None, y0, 0.0, 0.7, stepper=st, ctl=ctl, h0=1e-2,
                         time_dtype=jnp.float64)
    assert sol.path == "xla-driver"
    for b in range(B):
        yb = cp.Cplx(y0.re[b], y0.im[b])
        ref = vo.solve_ivp(
            lambda t, y: model.rhs_pair(t, y, jnp.float64), 0.0, 0.7, yb,
            ctl=ctl, h0=1e-2)
        assert int(ref.status) == vo.DONE
        assert int(sol.n_accept[b]) == int(ref.n_accept)
        np.testing.assert_allclose(np.asarray(sol.y_final.re[b]),
                                   np.asarray(ref.y_final.re), atol=1e-12)
        np.testing.assert_allclose(np.asarray(sol.y_final.im[b]),
                                   np.asarray(ref.y_final.im), atol=1e-12)


def test_scaled_error_needs_vector_stepper():
    """scaled_error rescales the error VECTOR: the norm-returning batched
    stepper refuses it, and the vector-error RungeKutta stepper over the
    same widened RHS (the supported route) honours it — stricter than the
    plain absolute norm on unit-sphere states at a tiny atol."""
    from vec_ode_tpu.utils.prec import HIGHEST

    model = DrivenDense.make(d=8, seed=0)
    rng = np.random.default_rng(33)
    B = 4
    z = rng.standard_normal((B, 8)) + 1j * rng.standard_normal((B, 8))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float64)
    scaled = vo.StepControl(rtol=1e-4, atol=1e-8, scaled_error=True,
                            min_dt=1e-6, max_dt=0.25, max_steps=500)
    plain = vo.StepControl(rtol=1e-4, min_dt=1e-6, max_dt=0.25,
                           max_steps=500)
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float64)
    try:
        ensemble_solve(None, y0, 0.0, 0.3, stepper=st, ctl=scaled, h0=1e-2,
                       time_dtype=jnp.float64)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "scaled_error" in str(e)

    M0, M1 = jnp.asarray(st.M0), jnp.asarray(st.M1)

    def rhs(t, xw):
        u = jnp.cos(model.w * t)
        return (jnp.einsum("ij,j->i", M0, xw, precision=HIGHEST)
                + u * jnp.einsum("ij,j->i", M1, xw, precision=HIGHEST))

    yw0 = jnp.concatenate([y0.re, y0.im], axis=-1)
    runs = {
        name: ensemble_solve(rhs, yw0, 0.0, 0.3,
                             stepper=vo.RungeKutta(vo.RKF45), ctl=c,
                             h0=1e-2, time_dtype=jnp.float64)
        for name, c in (("scaled", scaled), ("plain", plain))
    }
    for sol in runs.values():
        assert (np.asarray(sol.status) == vo.DONE).all()
    assert (np.asarray(runs["scaled"].n_accept)
            >= np.asarray(runs["plain"].n_accept)).all()
    # the plain vector-stepper run is the batched stepper's own semantics
    sol_b = ensemble_solve(None, y0, 0.0, 0.3, stepper=st, ctl=plain,
                           h0=1e-2, time_dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(runs["plain"].n_accept))
