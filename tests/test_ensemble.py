"""Ensemble batching + sharding on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_mesh, ensemble_solve, shard_batch


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def rhs_decay(t, y):
    return -y


def test_ensemble_matches_single():
    y0 = jnp.linspace(0.5, 2.0, 16, dtype=jnp.float64)[:, None] * jnp.ones(
        (16, 4), jnp.float64
    )
    sols = ensemble_solve(
        rhs_decay, y0, 0.0, 1.0, ctl=vo.StepControl(rtol=1e-8), h0=1e-2,
    )
    assert sols.status.shape == (16,)
    assert all(int(s) == vo.DONE for s in sols.status)
    single = vo.solve_ivp(
        rhs_decay, 0.0, 1.0, y0[3], ctl=vo.StepControl(rtol=1e-8), h0=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(sols.y_final[3]), np.asarray(single.y_final), rtol=1e-14
    )
    assert int(sols.n_accept[3]) == int(single.n_accept)


def test_sharded_ensemble_matches_unsharded():
    mesh = ensemble_mesh()
    y0 = jnp.asarray(
        np.random.default_rng(0).uniform(0.5, 1.5, (32, 8)), jnp.float64
    )
    plain = ensemble_solve(
        rhs_decay, y0, 0.0, 1.0, ctl=vo.StepControl(rtol=1e-8), h0=1e-2
    )
    sharded = ensemble_solve(
        rhs_decay, shard_batch(y0, mesh), 0.0, 1.0,
        ctl=vo.StepControl(rtol=1e-8), h0=1e-2, mesh=mesh,
    )
    np.testing.assert_allclose(
        np.asarray(sharded.y_final), np.asarray(plain.y_final), rtol=1e-14
    )
    np.testing.assert_array_equal(
        np.asarray(sharded.n_accept), np.asarray(plain.n_accept)
    )
    # outputs carry the mesh sharding (no implicit gather)
    assert not sharded.y_final.is_fully_replicated


def test_sharded_complex_pair_ensemble():
    # BASELINE config 5 in miniature: complex 8-dim ensemble, Cplx pairs,
    # adaptive RKF45, sharded over 8 virtual devices
    model = DrivenDense.make(d=8, seed=7)
    B = 64
    rng = np.random.default_rng(1)
    psi0 = rng.standard_normal((B, 8)) + 1j * rng.standard_normal((B, 8))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi0, jnp.float64)

    mesh = ensemble_mesh()
    sols = ensemble_solve(
        lambda t, y: model.rhs_pair(t, y, dtype=jnp.float64),
        shard_batch(y0, mesh),
        0.0, 0.5,
        ctl=vo.StepControl(rtol=1e-8), h0=1e-2, mesh=mesh,
    )
    assert all(int(s) == vo.DONE for s in sols.status)
    yf = np.asarray(cp.to_complex(sols.y_final))
    # unitary dynamics: norms preserved
    np.testing.assert_allclose(
        np.linalg.norm(yf, axis=-1), 1.0, atol=1e-7
    )
    # spot-check one trajectory against the unbatched complex-dtype solve
    ref = vo.solve_ivp(
        lambda t, y: model.op(t) @ y, 0.0, 0.5, jnp.asarray(psi0[5]),
        ctl=vo.StepControl(rtol=1e-8), h0=1e-2,
    )
    np.testing.assert_allclose(yf[5], np.asarray(ref.y_final), atol=1e-10)


def test_ensemble_exp_stepper():
    # exponential midpoint over an ensemble of initial states
    from vec_ode_tpu import exp as vexp

    A = jnp.asarray([[0.0, 1.0], [-1.0, 0.0]], jnp.float64)
    y0 = jnp.asarray(np.random.default_rng(2).standard_normal((8, 2)))
    sols = ensemble_solve(
        lambda t: A, y0, 0.0, 1.0,
        stepper=vexp.ExpMidpoint(vexp.DenseSplit()),
        adaptive=False, h0=0.1,
    )
    import scipy.linalg

    want = y0 @ jnp.asarray(scipy.linalg.expm(np.asarray(A)).T)
    np.testing.assert_allclose(np.asarray(sols.y_final), want, atol=1e-12)


def test_ensemble_size_must_divide_mesh():
    mesh = ensemble_mesh()
    y0 = jnp.ones((12, 2), jnp.float64)  # 12 % 8 != 0
    try:
        ensemble_solve(rhs_decay, y0, 0.0, 1.0, mesh=mesh, h0=1e-2)
        assert False, "expected ValueError"
    except ValueError as e:
        assert "divide" in str(e)


def test_ensemble_per_trajectory_params():
    # sweep decay rates: one parameter per trajectory
    rates = jnp.linspace(-2.0, -0.5, 8, dtype=jnp.float64)
    y0 = jnp.ones((8, 1), jnp.float64)
    sols = ensemble_solve(
        lambda t, y, p: p * y, y0, 0.0, 1.0,
        ctl=vo.StepControl(rtol=1e-8), h0=1e-2, params=rates,
    )
    assert all(int(s) == vo.DONE for s in sols.status)
    np.testing.assert_allclose(
        np.asarray(sols.y_final)[:, 0], np.exp(np.asarray(rates)), atol=1e-6
    )


def test_ensemble_params_exp_stepper_sharded():
    # Landau-Zener sweep-rate scan with an exponential stepper, sharded
    from vec_ode_tpu import exp as vexp
    from vec_ode_tpu.ops import cplx as cp

    B = 16
    vs = jnp.linspace(0.5, 4.0, B, dtype=jnp.float64)
    psi0 = np.zeros((B, 2), np.complex128)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float64)

    def op(t, v):
        from vec_ode_tpu.ops.cplx import Cplx

        sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float64)
        sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float64)
        H = v * t * sz + 0.4 * sx
        return Cplx(jnp.zeros_like(H), -H)

    mesh = ensemble_mesh()
    sols = ensemble_solve(
        op, shard_batch(y0, mesh), -12.0, 12.0,
        stepper=vexp.ExpMidpoint(vexp.DenseCplxSplit()),
        adaptive=False, h0=0.02, mesh=mesh,
        params=shard_batch(vs, mesh),
    )
    assert all(int(s) == vo.DONE for s in sols.status)
    p_stay = np.asarray(cp.cabs2(sols.y_final))[:, 0]
    want = np.exp(-np.pi * 0.4**2 / (2.0 * np.asarray(vs)))
    # finite-T corrections + Stueckelberg oscillations -> loose tolerance
    np.testing.assert_allclose(p_stay, want, atol=0.08)
    # overall trend: faster sweeps -> higher stay probability (LZ physics)
    assert p_stay[-1] > p_stay[0] + 0.2


def test_per_trajectory_h0_warm_start():
    # chained solves: feed h_final back as per-trajectory h0
    y0 = jnp.asarray(np.random.default_rng(4).uniform(0.5, 2.0, (8, 4)))
    ctl = vo.StepControl(rtol=1e-8)
    first = ensemble_solve(rhs_decay, y0, 0.0, 1.0, ctl=ctl, h0=1e-3)
    warm = ensemble_solve(
        rhs_decay, first.y_final, 1.0, 2.0, ctl=ctl, h0=first.h_final,
    )
    assert all(int(s) == vo.DONE for s in warm.status)
    # warm start skips the h-growth phase: fewer iterations than cold start
    cold = ensemble_solve(
        rhs_decay, first.y_final, 1.0, 2.0, ctl=ctl, h0=1e-3,
    )
    assert int(warm.n_iters.max()) < int(cold.n_iters.max())
    # sharded variant with batched h0
    mesh = ensemble_mesh()
    y0s = jnp.asarray(np.random.default_rng(5).uniform(0.5, 2.0, (16, 4)))
    h0s = jnp.full((16,), 0.05, jnp.float64)
    s = ensemble_solve(
        rhs_decay, shard_batch(y0s, mesh), 0.0, 1.0, ctl=ctl,
        h0=shard_batch(h0s, mesh), mesh=mesh,
    )
    assert all(int(x) == vo.DONE for x in s.status)


def test_batched_stepper_warm_start_sharded():
    """Regression: (B,)-shaped h0 must shard correctly through shard_map for
    natively-batched steppers (was a closure-capture crash)."""
    from vec_ode_tpu.models import DrivenDense
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=64, seed=9)
    B = 16
    rng = np.random.default_rng(6)
    psi0 = rng.standard_normal((B, 64)) + 1j * rng.standard_normal((B, 64))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi0, jnp.float64)
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float64)
    mesh = ensemble_mesh()
    ctl = vo.StepControl(rtol=1e-8, max_dt=0.25)
    h0s = jnp.full((B,), 0.02, jnp.float64)
    sol = ensemble_solve(
        None, shard_batch(y0, mesh), 0.0, 0.3, stepper=st, ctl=ctl,
        h0=shard_batch(h0s, mesh), mesh=mesh, time_dtype=jnp.float64,
    )
    assert all(int(s) == vo.DONE for s in sol.status)


def test_step_efficiency_counter():
    """Heterogeneous ensemble: efficiency < 1 and equals the analytic
    useful/executed ratio."""
    from vec_ode_tpu.parallel import step_efficiency

    rates = jnp.asarray([0.5, 1.0, 4.0, 16.0])  # stiffer -> more steps
    y0 = jnp.ones((4, 1))
    sol = ensemble_solve(
        lambda t, y, r: -r * y, y0, 0.0, 1.0,
        params=rates, ctl=vo.StepControl(rtol=1e-8), h0=1e-3,
    )
    assert (np.asarray(sol.status) == vo.DONE).all()
    ni = np.asarray(sol.n_iters)
    eff = float(step_efficiency(sol))
    assert abs(eff - ni.sum() / (ni.max() * len(ni))) < 1e-9
    assert eff < 0.9  # genuinely heterogeneous


def test_ensemble_solve_compact_matches_and_improves():
    """Compaction: identical trajectories, efficiency above the plain path."""
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.parallel import ensemble_solve_compact, step_efficiency

    # heterogeneous Landau-Zener sweep: per-lane velocity rides in the state
    # (ensemble_solve_compact has no params channel)
    B = 32
    vs = jnp.asarray(np.linspace(0.5, 8.0, B))
    psi0 = np.zeros((B, 2), np.complex128)
    psi0[:, 0] = 1.0
    y0 = (cp.from_complex(psi0, jnp.float64), vs[:, None])

    def rhs(t, y):
        psi, v = y
        H_re = jnp.asarray([[0.5, 0.0], [0.0, -0.5]]) * (v[0] * t) + \
            0.4 * jnp.asarray([[0.0, 0.5], [0.5, 0.0]])
        return (cp.Cplx(H_re @ psi.im, -(H_re @ psi.re)),
                jnp.zeros_like(v))

    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.5,
                         max_steps=20000)
    sol_plain = ensemble_solve(rhs, y0, -8.0, 8.0, ctl=ctl, h0=1e-2)
    eff_plain = float(step_efficiency(sol_plain))

    sol_c, stats = ensemble_solve_compact(
        rhs, y0, -8.0, 8.0, ctl=ctl, h0=1e-2,
        chunk_iters=16, min_batch=1, bucket_multiple=1,
    )
    assert (np.asarray(sol_c.status) == vo.DONE).all()
    # identical per-lane trajectories (same stepper/controller math)
    np.testing.assert_array_equal(np.asarray(sol_c.n_accept),
                                  np.asarray(sol_plain.n_accept))
    np.testing.assert_allclose(np.asarray(sol_c.y_final[0].re),
                               np.asarray(sol_plain.y_final[0].re),
                               rtol=0, atol=5e-14)
    assert stats["efficiency"] > eff_plain, (stats, eff_plain)
    assert stats["efficiency"] > 0.97, stats


def test_ensemble_h0_range_validation():
    """with_init_step range check (ode.rs:287-296) now also guards the
    ensemble path."""
    y0 = jnp.ones((4, 2))
    ctl = vo.StepControl(min_dt=1e-6, max_dt=0.5)
    f = lambda t, y: -y
    with pytest.raises(ValueError, match="not inside the range"):
        ensemble_solve(f, y0, 0.0, 1.0, ctl=ctl, h0=1.0)
    with pytest.raises(ValueError, match="not inside the range"):
        ensemble_solve(f, y0, 0.0, 1.0, ctl=ctl,
                       h0=jnp.asarray([1e-2, 1e-2, 0.9, 1e-2]))
    # fixed-step mode is exempt (as in the reference's no_adaptive flow)
    sol = ensemble_solve(f, y0, 0.0, 1.0, ctl=ctl, h0=1e-2)
    assert (np.asarray(sol.status) == vo.DONE).all()


def test_compact_with_fsal_stepper():
    """ensemble_solve_compact threads the FSAL carry (regression: the
    vmapped carry-stepper needs 4-arg in_axes and a seeded carry)."""
    from vec_ode_tpu.parallel import ensemble_solve_compact
    from vec_ode_tpu.tableaus import DOPRI5

    rng = np.random.default_rng(2)
    rates = jnp.asarray([0.5, 1.0, 3.0, 9.0])
    y0 = (jnp.ones((4, 1)), rates[:, None])

    def rhs(t, y):
        x, r = y
        return (-r * x, jnp.zeros_like(r))

    st = vo.RungeKutta(DOPRI5, advance_lower=False)
    assert st.has_carry
    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-8, max_dt=0.5)
    sol_c, stats = ensemble_solve_compact(
        rhs, y0, 0.0, 1.0, stepper=st, ctl=ctl, h0=1e-2,
        chunk_iters=16, min_batch=1, bucket_multiple=1,
    )
    sol_p = ensemble_solve(rhs, y0, 0.0, 1.0, stepper=st, ctl=ctl, h0=1e-2)
    assert (np.asarray(sol_c.status) == vo.DONE).all()
    np.testing.assert_array_equal(np.asarray(sol_c.n_accept),
                                  np.asarray(sol_p.n_accept))
    np.testing.assert_allclose(np.asarray(sol_c.y_final[0]),
                               np.asarray(sol_p.y_final[0]), rtol=0, atol=0)


def test_compact_custom_norm_is_per_trajectory():
    """Regression: a custom error_norm must be applied PER LANE in
    ensemble_solve_compact (an unbatched norm would couple every lane
    through one scalar controller decision). Results must match
    ensemble_solve with the same norm."""
    from vec_ode_tpu import lc
    from vec_ode_tpu.parallel import ensemble_solve, ensemble_solve_compact

    def rhs(t, y):
        return -y * (1.0 + 0.5 * jnp.sin(t))

    rng = np.random.default_rng(5)
    y0 = jnp.asarray(rng.uniform(0.5, 2.0, (12, 3)), jnp.float64)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-7, max_dt=0.5, max_steps=4000)

    sol = ensemble_solve(rhs, y0, 0.0, 2.0, ctl=ctl,
                         error_norm=lc.norm_rms)
    sol_c, stats = ensemble_solve_compact(rhs, y0, 0.0, 2.0, ctl=ctl,
                                          error_norm=lc.norm_rms)
    assert (np.asarray(sol_c.status) == vo.DONE).all()
    np.testing.assert_array_equal(np.asarray(sol_c.n_accept),
                                  np.asarray(sol.n_accept))
    np.testing.assert_allclose(np.asarray(sol_c.y_final),
                               np.asarray(sol.y_final), rtol=1e-12)


def test_compact_validates_h0_range():
    import pytest

    from vec_ode_tpu.parallel import ensemble_solve_compact

    y0 = jnp.ones((4, 2), jnp.float64)
    with pytest.raises(ValueError, match="not inside the range"):
        ensemble_solve_compact(lambda t, y: -y, y0, 0.0, 1.0, h0=5.0,
                               ctl=vo.StepControl(max_dt=1.0))
