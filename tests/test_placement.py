"""Mesh-composable straggler mitigation:
per-shard efficiency accounting + cost-sorted placement on the 8-device
CPU mesh with a heterogeneous Landau-Zener sweep."""

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import (
    cost_sorted_permutation,
    ensemble_mesh,
    ensemble_solve,
    inverse_permutation,
    shard_batch,
    step_efficiency,
)


def _lz_rhs(t, y, v):
    psi = y
    sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float64)
    sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float64)
    H = sz * (v * t) + 0.4 * sx
    return cp.Cplx(H @ psi.im, -(H @ psi.re))


def _solve(y0, vs, mesh):
    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.5,
                         max_steps=100000)
    return ensemble_solve(
        _lz_rhs, y0, -8.0, 8.0, ctl=ctl, h0=1e-2, params=vs,
        time_dtype=jnp.float64, mesh=mesh,
    )


def test_cost_sorted_placement_beats_adversarial():
    B = 64
    rng = np.random.default_rng(0)
    # adversarially SHUFFLED sweep velocities: every shard gets the full
    # cost spread (slow sweeps take ~10x the steps of fast ones)
    vs_np = rng.permutation(np.linspace(0.4, 8.0, B))
    vs = jnp.asarray(vs_np)
    psi0 = np.zeros((B, 2), np.complex128)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float64)
    mesh = ensemble_mesh()
    n_sh = int(mesh.devices.size)
    assert n_sh == 8

    sol_bad = _solve(shard_batch(y0, mesh), shard_batch(vs, mesh), mesh)
    eff_bad = float(step_efficiency(sol_bad, n_shards=n_sh))
    per_bad = np.asarray(step_efficiency(sol_bad, n_shards=n_sh,
                                         per_shard=True))
    assert per_bad.shape == (n_sh,)

    # cost proxy: slow sweeps (small v) need more steps -> sort by -v
    perm = cost_sorted_permutation(-vs_np)
    y0s = jax.tree_util.tree_map(lambda a: a[perm], y0)
    vss = vs[perm]
    sol_srt = _solve(shard_batch(y0s, mesh), shard_batch(vss, mesh), mesh)
    eff_srt = float(step_efficiency(sol_srt, n_shards=n_sh))

    assert eff_srt >= 0.9, eff_srt
    assert eff_srt > eff_bad + 0.05, (eff_srt, eff_bad)

    # un-permute and compare against the unsorted run lane by lane
    inv = inverse_permutation(perm)
    ni_srt = np.asarray(sol_srt.n_iters)[inv]
    np.testing.assert_array_equal(ni_srt, np.asarray(sol_bad.n_iters))
    yf = jax.tree_util.tree_map(lambda a: np.asarray(a)[inv],
                                sol_srt.y_final)
    np.testing.assert_allclose(yf.re, np.asarray(sol_bad.y_final.re),
                               atol=1e-12)


def test_inverse_permutation_roundtrip():
    rng = np.random.default_rng(1)
    perm = rng.permutation(17)
    inv = inverse_permutation(perm)
    x = rng.standard_normal(17)
    np.testing.assert_array_equal(x[perm][inv], x)
