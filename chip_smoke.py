"""Smoke test of the solver's main path on the GPU.

    python chip_smoke.py               # one card: headline + XLA paths
    python chip_smoke.py --four-cards  # four cards: the multi-card paths only

One process. It stops with an error (and prints no result) when JAX finds no
GPU; it never falls back to the CPU. Earlier lines print the card's name and
power limit, the JAX version and each phase's result and wall time; a failed
check ends the run with a non-zero exit. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Phases on one card:
  1. headline: adaptive RKF45 over 16,384 x 64c driven Schrodinger
     trajectories (f32, rtol 1e-8) through ``ensemble_solve``; 64 sampled
     trajectories against an f64 scipy DOP853 reference (rtol=atol=1e-12).
  2. modulated Magnus-4: 256 trajectories, f32 on the card against the same
     solve in f64 on the host CPU device.
  3. Landau-Zener: a 1,024-velocity sweep against the asymptotic formula.
  4. adjoint: value_and_grad of PulseControl.infidelity through
     diff.adjoint_solve (f64) against central finite differences.
Phases on four cards (``--four-cards``):
  5. the headline over ``ensemble_mesh(4)`` against the one-card solve, and
     the compiled trajectory-sharded program's collective count (must be 0);
  6. ``ensemble_solve_state_sharded`` on ``mesh_2d(2, 2)`` against the
     unsharded solve.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu.utils import runtime

# f32 headline against the f64 reference (whose own error is ~1e-12): the
# controller holds each step's local error under rtol = 1e-8 (absolute
# norm), <= 3.3e-7 over the ~33 accepted steps of a trajectory, and f32
# rounding of the O(1) state adds <= ~1e-7 per step, <= 3.3e-6 summed
# linearly. Measured on an H100: 1.15e-7 (CHANGES.md).
HEADLINE_TOL = 5e-6
# unitary evolution: RKF45 is not norm-preserving, so |psi| drifts from 1
# by the same local-error and rounding budget (measured 1.19e-7)
NORM_TOL = 5e-6
COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter",
               "collective-broadcast")


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def _phase(name, fn):
    t0 = time.perf_counter()
    info = fn()
    wall = time.perf_counter() - t0
    print(f"phase {name}: ok, {wall:.2f} s, {info}", flush=True)


def scipy_reference(model, psi0, tf):
    """f64 DOP853 solve of dpsi/dt = -i (H0 + cos(w t) V) psi for each row
    of ``psi0`` (complex (n, d)) on [0, tf]."""
    from scipy.integrate import solve_ivp

    H0, V, w = np.asarray(model.H0), np.asarray(model.V), float(model.w)
    n, d = psi0.shape

    def f(t, y):
        Y = y.reshape(n, d)
        H = H0 + np.cos(w * t) * V
        return (-1j * Y @ H.T).reshape(-1)

    sol = solve_ivp(f, (0.0, tf), psi0.reshape(-1).astype(complex),
                    method="DOP853", rtol=1e-12, atol=1e-12)
    require(sol.success, sol.message)
    return sol.y[:, -1].reshape(n, d)


def collective_counts(hlo_text: str) -> dict:
    return {name: len(re.findall(r"\b" + re.escape(name), hlo_text))
            for name in COLLECTIVES}


def phase_headline():
    import bench
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = bench.headline_model()
    psi0, y0 = bench.headline_y0(bench.N_TRAJ)
    stepper = FusedModulatedLinearRK.from_driven_dense(model, jnp.float32)
    fn = bench.headline_solver(stepper)
    t_first, sol = bench.timed(fn, y0)
    wall, sol = bench.timed(fn, y0)
    status = np.asarray(sol.status)
    require((status == vo.DONE).all(), np.unique(status, return_counts=True))
    require(sol.path == "xla-driver", sol.path)
    yf = np.asarray(cp.to_complex(sol.y_final))
    norm_err = float(np.abs(np.linalg.norm(yf, axis=-1) - 1.0).max())
    require(norm_err < NORM_TOL, norm_err)
    idx = np.random.default_rng(7).choice(bench.N_TRAJ, 64, replace=False)
    ref = scipy_reference(model, psi0[idx], bench.TF)
    err = float(np.abs(yf[idx] - ref).max())
    require(err < HEADLINE_TOL, err)
    acc = int(np.asarray(sol.n_accept).sum())
    return (f"{bench.N_TRAJ}x{bench.DIM}c rtol={bench.RTOL:g} "
            f"path={sol.path} first call {t_first:.2f} s, solve "
            f"{wall:.4f} s, {acc} accepted steps, {acc / wall:.4g} "
            f"accepted steps/s, max |y - y_ref| over 64 sampled "
            f"trajectories {err:.3g} (tol {HEADLINE_TOL:g}), max "
            f"||y|-1| {norm_err:.3g}")


def phase_magnus():
    from vec_ode_tpu import exp as vexp
    from vec_ode_tpu.models import DrivenDense
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.parallel import ensemble_solve

    model = DrivenDense.make(d=64, seed=1)
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((256, 64)) + 1j * rng.standard_normal((256, 64))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.25)

    def solve(dtype):
        st = vexp.MagnusModulated4(model.modulated(dtype))
        return jax.jit(lambda y: ensemble_solve(
            None, y, 0.0, 1.0, stepper=st, ctl=ctl, h0=1e-2,
            time_dtype=dtype))(cp.from_complex(psi, dtype))

    sol = jax.block_until_ready(solve(jnp.float32))
    require((np.asarray(sol.status) == vo.DONE).all(), "status not DONE")
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        ref = solve(jnp.float64)
        ref_y = np.asarray(cp.to_complex(ref.y_final))
    err = float(np.abs(np.asarray(cp.to_complex(sol.y_final)) - ref_y).max())
    # f32 Taylor actions vs f64: f32 rounding over the accepted steps;
    # the step sequences may differ by marginal accepts at rtol 1e-6
    require(err < 1e-4, err)
    return (f"256x64c MagnusModulated4 rtol=1e-6 path={sol.path}, max "
            f"|y32 - y64(cpu)| {err:.3g}")


def phase_landau_zener():
    from vec_ode_tpu import exp as vexp
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.parallel import ensemble_solve

    B, delta = 1024, 0.4
    vs = np.linspace(1.0, 4.0, B)
    psi0 = np.zeros((B, 2), complex)
    psi0[:, 0] = 1.0
    sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float32)
    sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float32)

    def op_fn(t, v):
        H = v * t * sz + delta * sx
        return cp.Cplx(jnp.zeros_like(H), -H)

    sol = jax.jit(lambda y, p: ensemble_solve(
        op_fn, y, -25.0, 25.0, stepper=vexp.Magnus4(vexp.DenseCplxSplit()),
        params=p, ctl=vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.5,
                                     max_steps=100000),
        h0=1e-2, time_dtype=jnp.float32))(
        cp.from_complex(psi0, jnp.float32), jnp.asarray(vs, jnp.float32))
    require((np.asarray(sol.status) == vo.DONE).all(), "status not DONE")
    p_stay = np.asarray(sol.y_final.re[:, 0] ** 2 + sol.y_final.im[:, 0] ** 2)
    p_lz = np.exp(-np.pi * delta ** 2 / (2 * vs))
    dev = float(np.abs(p_stay - p_lz).max())
    require(dev < 0.02, dev)
    return f"{B} sweeps, max |P_stay - P_LZ| {dev:.3g} (tol 0.02)"


def phase_adjoint():
    from vec_ode_tpu.models import PulseControl
    from vec_ode_tpu.ops import cplx as cp

    with jax.enable_x64(True):
        pc = PulseControl.make(d=4, seed=0, T=3.0, n_modes=4)
        psi0 = cp.from_complex(np.eye(4)[0][None].astype(complex),
                               jnp.float64)
        tgt = cp.from_complex(np.eye(4)[2][None].astype(complex),
                              jnp.float64)
        theta = jnp.asarray([0.3, -0.2, 0.5, 0.1], jnp.float64)

        def loss(th):
            return pc.infidelity(th, psi0, tgt, n_steps=128)

        v, g = jax.jit(jax.value_and_grad(loss))(theta)
        loss_j = jax.jit(loss)
        eps = 1e-6
        fd = np.asarray([
            (float(loss_j(theta.at[i].add(eps)))
             - float(loss_j(theta.at[i].add(-eps)))) / (2 * eps)
            for i in range(theta.shape[0])])
        err = float(np.abs(np.asarray(g) - fd).max())
        # central differences at eps 1e-6 in f64: O(eps^2) truncation plus
        # ~1e-16/eps rounding
        tol = 1e-7 * max(1.0, float(np.abs(fd).max())) + 1e-8
        require(err < tol, (g, fd))
        gnorm = float(jnp.linalg.norm(g))
    return (f"infidelity {float(v):.6f}, |grad| {gnorm:.4g}, max |grad - "
            f"central FD| {err:.3g}")


def phase_trajectory_sharding():
    import bench
    from vec_ode_tpu.ops import cplx as cp
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK
    from vec_ode_tpu.parallel import ensemble_mesh, shard_batch

    model = bench.headline_model()
    _, y0 = bench.headline_y0(bench.N_TRAJ)
    stepper = FusedModulatedLinearRK.from_driven_dense(model, jnp.float32)
    one = jax.block_until_ready(bench.headline_solver(stepper)(y0))
    mesh = ensemble_mesh(4)
    fn = bench.headline_solver(stepper, mesh=mesh)
    ys = shard_batch(y0, mesh)
    counts = collective_counts(fn.lower(ys).compile().as_text())
    require(sum(counts.values()) == 0, counts)
    t_first, sh = bench.timed(fn, ys)
    wall, sh = bench.timed(fn, ys)
    require((np.asarray(sh.status) == vo.DONE).all(), "status not DONE")
    same_acc = float(np.mean(np.asarray(sh.n_accept)
                             == np.asarray(one.n_accept)))
    err = float(np.abs(np.asarray(cp.to_complex(sh.y_final))
                       - np.asarray(cp.to_complex(one.y_final))).max())
    # per-shard GEMMs may round differently from the one-card batch, which
    # at rtol 1e-8 in f32 can flip a marginal accept on a few trajectories
    require(same_acc > 0.99, same_acc)
    require(err < HEADLINE_TOL, err)
    acc = int(np.asarray(sh.n_accept).sum())
    return (f"headline over ensemble_mesh(4): collectives in the compiled "
            f"program {counts}, first call {t_first:.2f} s, solve "
            f"{wall:.4f} s, {acc / wall:.4g} accepted steps/s, identical "
            f"accept counts on {same_acc:.4f} of trajectories, max |y_4 - "
            f"y_1| {err:.3g}")


def phase_state_sharding():
    from vec_ode_tpu.models import stable_dense_matrix
    from vec_ode_tpu.parallel import ensemble_solve
    from vec_ode_tpu.parallel.state_parallel import (
        ensemble_solve_state_sharded, mesh_2d)
    from vec_ode_tpu.utils.prec import HIGHEST

    D, B = 256, 64
    A = jnp.asarray(stable_dense_matrix(D, seed=12, dtype=None), jnp.float32)
    y0 = jnp.asarray(np.random.default_rng(1).standard_normal((B, D)),
                     jnp.float32)
    ctl = vo.StepControl(rtol=1e-5, max_dt=0.5)
    sh = ensemble_solve_state_sharded(A, y0, 0.0, 1.0, mesh=mesh_2d(2, 2),
                                      ctl=ctl, h0=1e-2,
                                      time_dtype=jnp.float32)
    ref = ensemble_solve(
        lambda t, y: jnp.einsum("ij,j->i", A, y, precision=HIGHEST),
        y0, 0.0, 1.0, ctl=ctl, h0=1e-2, time_dtype=jnp.float32)
    require((np.asarray(sh.status) == vo.DONE).all(), "status not DONE")
    err = float(jnp.max(jnp.abs(sh.y_final - ref.y_final)))
    scale = float(jnp.max(jnp.abs(ref.y_final)))
    same_acc = float(np.mean(np.asarray(sh.n_accept)
                             == np.asarray(ref.n_accept)))
    # row-parallel products and psum'd norms sum in another order than
    # the unsharded GEMM: f32 rounding of the state
    require(err < 1e-5 * max(1.0, scale), (err, scale))
    require(same_acc > 0.9, same_acc)
    return (f"{B}x{D} on mesh_2d(2, 2) (all_gather + psum): max |y_2d - "
            f"y_1| {err:.3g} (scale {scale:.3g}), identical accept counts "
            f"on {same_acc:.3f} of trajectories")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card phases, on four cards")
    args = ap.parse_args(argv)

    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.card_name_and_power(), flush=True)
    print(f"jax {jax.__version__}, devices {jax.devices()}", flush=True)
    if args.four_cards:
        if len(jax.devices()) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found "
                             f"{len(jax.devices())}")
        _phase("trajectory-sharding", phase_trajectory_sharding)
        _phase("state-sharding", phase_state_sharding)
    else:
        _phase("headline", phase_headline)
        _phase("magnus4-modulated", phase_magnus)
        _phase("landau-zener-sweep", phase_landau_zener)
        _phase("adjoint-gradient", phase_adjoint)
    print(json.dumps({"ok": True, "device": runtime.device_record()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
