"""shard_map x natively batched steppers on the 8-device CPU mesh: the
sharded ensemble must reproduce the unsharded run (trajectories are
independent, so each shard runs its own driver loop)."""

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_mesh, ensemble_solve, shard_batch


def _y0(B, d, dtype=jnp.float32, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return cp.from_complex(psi, dtype)


def test_modulated_ensemble_inside_shard_map():
    """MagnusModulated4's batched driver loop runs INSIDE shard_map on the
    8-device mesh and matches the unsharded run: same step counts, states
    to f32 rounding."""
    d, B = 8, 64
    model = DrivenDense.make(d=d, seed=5)
    stepper = vexp.MagnusModulated4(model.modulated(jnp.float32))
    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=200)
    y0 = _y0(B, d)
    mesh = ensemble_mesh()
    assert mesh.devices.size == 8

    def solve(y, mesh_):
        return ensemble_solve(
            None, y, 0.0, 0.05, stepper=stepper, adaptive=True, ctl=ctl,
            h0=1e-2, time_dtype=jnp.float32, mesh=mesh_,
        )

    sol_sh = solve(shard_batch(y0, mesh), mesh)
    assert sol_sh.path == "xla-driver"
    assert (np.asarray(sol_sh.status) == vo.DONE).all()
    sol_ref = solve(y0, None)
    np.testing.assert_array_equal(np.asarray(sol_sh.n_accept),
                                  np.asarray(sol_ref.n_accept))
    np.testing.assert_allclose(np.asarray(sol_sh.y_final.re),
                               np.asarray(sol_ref.y_final.re), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol_sh.y_final.im),
                               np.asarray(sol_ref.y_final.im), atol=1e-6)


def test_traced_norm_and_saves_inside_shard_map():
    """A traced opaque error_norm keeps the batched driver, and interior
    saves round-trip through the sharded driver."""
    d, B = 8, 64
    model = DrivenDense.make(d=d, seed=6)
    stepper = vexp.MagnusModulated4(model.modulated(jnp.float32))
    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=200)
    y0 = _y0(B, d, seed=1)
    mesh = ensemble_mesh()
    save_at = np.linspace(0.005, 0.045, 40)

    def solve(y, mesh_):
        return ensemble_solve(
            None, y, 0.0, 0.05, stepper=stepper, adaptive=True, ctl=ctl,
            h0=1e-2, save_at=save_at, time_dtype=jnp.float32, mesh=mesh_,
            error_norm=lambda e: jnp.sqrt(jnp.sum(e.re**2)
                                          + jnp.sum(e.im**2)),
        )

    sol_sh = solve(shard_batch(y0, mesh), mesh)
    assert (np.asarray(sol_sh.status) == vo.DONE).all()
    sol_ref = solve(y0, None)
    np.testing.assert_allclose(np.asarray(sol_sh.y_final.re),
                               np.asarray(sol_ref.y_final.re), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol_sh.ys.im),
                               np.asarray(sol_ref.ys.im), atol=1e-6)


def test_generic_dense_batched_inside_shard_map():
    """The generic dense-split stepper's batched executor (stacked expm)
    under shard_map matches its unsharded run."""
    d, B = 8, 64
    model = DrivenDense.make(d=d, seed=7)
    stepper = vexp.Magnus4(vexp.DenseCplxSplit())
    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=200)
    y0 = _y0(B, d, seed=2)
    mesh = ensemble_mesh()

    def solve(y, mesh_):
        return ensemble_solve(
            lambda t: model.op_pair(t, jnp.float32), y, 0.0, 0.05,
            stepper=stepper, adaptive=True, ctl=ctl,
            h0=1e-2, time_dtype=jnp.float32, mesh=mesh_,
        )

    sol_sh = solve(shard_batch(y0, mesh), mesh)
    assert (np.asarray(sol_sh.status) == vo.DONE).all()
    sol_ref = solve(y0, None)
    np.testing.assert_array_equal(np.asarray(sol_sh.n_accept),
                                  np.asarray(sol_ref.n_accept))
    np.testing.assert_allclose(np.asarray(sol_sh.y_final.re),
                               np.asarray(sol_ref.y_final.re), atol=1e-6)
