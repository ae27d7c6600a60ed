"""State-dimension sharding: row-parallel matvec + psum error norms on the
8-device virtual CPU mesh, vs unsharded golden results."""

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu.models import stable_dense_matrix
from vec_ode_tpu.parallel.state_parallel import (
    ensemble_solve_state_sharded,
    mesh_2d,
    solve_linear_state_sharded,
)


def test_state_sharded_matches_unsharded():
    D = 64  # 8 devices x 8 rows
    A = jnp.asarray(stable_dense_matrix(D, seed=11), jnp.float64)
    y0 = jnp.asarray(np.random.default_rng(0).standard_normal(D))
    from vec_ode_tpu.parallel import ensemble_mesh

    mesh = ensemble_mesh(axis="state")
    ctl = vo.StepControl(rtol=1e-8, max_dt=0.5)

    sharded = solve_linear_state_sharded(
        A, y0, 0.0, 1.0, mesh=mesh, ctl=ctl, h0=1e-2,
    )
    plain = vo.solve_ivp(
        lambda t, y: jnp.einsum("ij,j->i", A, y,
                                precision=jax.lax.Precision.HIGHEST),
        0.0, 1.0, y0, ctl=ctl, h0=1e-2,
    )
    assert int(sharded.status) == vo.DONE
    np.testing.assert_allclose(
        np.asarray(sharded.y_final), np.asarray(plain.y_final), rtol=1e-12
    )
    # identical controller decisions: the psum'd norm equals the global norm
    assert int(sharded.n_accept) == int(plain.n_accept)
    assert int(sharded.n_reject) == int(plain.n_reject)
    np.testing.assert_allclose(float(sharded.h_final), float(plain.h_final),
                               rtol=1e-12)


def test_2d_mesh_traj_x_state():
    # 2-D mesh: 2 trajectory shards x 4 state shards
    D, B = 32, 6
    A = jnp.asarray(stable_dense_matrix(D, seed=12), jnp.float64)
    y0 = jnp.asarray(np.random.default_rng(1).standard_normal((B, D)))
    mesh = mesh_2d(2, 4)
    ctl = vo.StepControl(rtol=1e-8, max_dt=0.5)

    sols = ensemble_solve_state_sharded(
        A, y0, 0.0, 1.0, mesh=mesh, ctl=ctl, h0=1e-2,
    )
    assert sols.status.shape == (B,)
    assert all(int(s) == vo.DONE for s in sols.status)
    for i in range(B):
        ref = vo.solve_ivp(
            lambda t, y: jnp.einsum("ij,j->i", A, y,
                                    precision=jax.lax.Precision.HIGHEST),
            0.0, 1.0, y0[i], ctl=ctl, h0=1e-2,
        )
        np.testing.assert_allclose(
            np.asarray(sols.y_final[i]), np.asarray(ref.y_final), rtol=1e-11
        )
        assert int(sols.n_accept[i]) == int(ref.n_accept)


def test_mesh_2d_validation():
    try:
        mesh_2d(4, 4)  # 16 devices needed, only 8
        assert False
    except ValueError as e:
        assert "devices" in str(e)


def test_time_dependent_state_sharded_driven_dense():
    """Driven Hamiltonian (time-dependent A(t)) state-sharded over an
    8-device mesh matches the unsharded solve to 1e-6 (sharding beyond a constant A)."""
    from vec_ode_tpu.models import DrivenDense
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.parallel import (
        ensemble_mesh,
        local_rows,
        solve_linear_state_sharded,
    )

    model = DrivenDense.make(d=8, seed=3)
    mesh = ensemble_mesh(8, axis="state")
    D = 16  # embedded real dimension 2d

    def assemble(t):
        A = model.op_pair(t, jnp.float64)   # Cplx (8, 8)
        return cp.embed(A)                  # real (16, 16)

    rng = np.random.default_rng(5)
    z = rng.standard_normal(8) + 1j * rng.standard_normal(8)
    z /= np.linalg.norm(z)
    y0w = jnp.concatenate([jnp.asarray(z.real), jnp.asarray(z.imag)])

    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-7, max_dt=0.2)
    sol = solve_linear_state_sharded(
        local_rows(assemble, mesh), y0w, 0.0, 1.0, mesh=mesh, ctl=ctl,
        h0=1e-2,
    )
    assert int(sol.status) == vo.DONE

    sol_ref = vo.solve_ivp(
        lambda t, y: assemble(t) @ y, 0.0, 1.0, y0w, ctl=ctl, h0=1e-2,
    )
    np.testing.assert_allclose(np.asarray(sol.y_final),
                               np.asarray(sol_ref.y_final),
                               rtol=1e-6, atol=1e-9)
    # unitarity of the underlying complex evolution
    n = float(jnp.linalg.norm(sol.y_final))
    assert abs(n - 1.0) < 1e-7


def test_time_dependent_2d_mesh_ensemble():
    """2-D (traj x state) mesh with a time-dependent assemble_local."""
    from vec_ode_tpu.models import DrivenDense
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.parallel import (
        ensemble_solve_state_sharded,
        local_rows,
        mesh_2d,
    )

    model = DrivenDense.make(d=4, seed=4)
    mesh = mesh_2d(4, 2)

    def assemble(t):
        return cp.embed(model.op_pair(t, jnp.float64))  # (8, 8)

    rng = np.random.default_rng(6)
    B = 8
    z = rng.standard_normal((B, 4)) + 1j * rng.standard_normal((B, 4))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0w = jnp.concatenate([jnp.asarray(z.real), jnp.asarray(z.imag)],
                          axis=-1)

    ctl = vo.StepControl(rtol=1e-8, min_dt=1e-7, max_dt=0.2)
    sol = ensemble_solve_state_sharded(
        local_rows(assemble, mesh, axis="state"), y0w, 0.0, 0.7,
        mesh=mesh, ctl=ctl, h0=1e-2,
    )
    assert (np.asarray(sol.status) == vo.DONE).all()

    sol_ref = vo.solve_ivp(
        lambda t, y: assemble(t) @ y, 0.0, 0.7, y0w[2], ctl=ctl, h0=1e-2,
    )
    np.testing.assert_allclose(np.asarray(sol.y_final[2]),
                               np.asarray(sol_ref.y_final),
                               rtol=1e-6, atol=1e-9)
