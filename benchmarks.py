"""Secondary benchmarks: the BASELINE.md config matrix beyond the headline.

``bench.py`` measures the headline (config 5). This script measures the
other configs on the GPU and prints one JSON line per row:

    python benchmarks.py            # all rows
    python benchmarks.py rk4 cfm    # substring filter

Every solve is jitted, compiled and warmed up once, then timed from the call
to ``block_until_ready``; a row's value is the median of ``REPEATS`` calls.
"""

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense, LandauZener, VanDerPol
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve
from vec_ode_tpu.utils import runtime

REPEATS = 5
CTL = vo.StepControl(rtol=1e-5, min_dt=1e-5, max_dt=0.25)


def timed(fn, *args):
    """(median wall of REPEATS calls after a warm-up call, last output)."""
    out = jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), out


def solve_rate(solve, y0):
    """Accepted steps/sec of the jitted ``solve(y0)`` over its median wall,
    and the counts behind it."""
    wall, sol = timed(solve, y0)
    steps = int(np.asarray(sol.n_accept).sum())
    rejects = int(np.asarray(sol.n_reject).sum())
    return steps / wall, {"wall_s": wall, "accepted_steps": steps,
                          "rejected_steps": rejects}


def solve_row(metric, solve, y0, **extra):
    rate, detail = solve_rate(solve, y0)
    return {"metric": metric, "value": rate, "unit": "steps/sec",
            "detail": {**detail, **extra}}


def random_states(B, d, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return cp.from_complex(psi, jnp.float32)


def lz_ground(B):
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    return cp.from_complex(psi0, jnp.float32)


def driven_solver(stepper, op=None, ctl=CTL, **kw):
    """Jitted adaptive solve on [0, 1] of the 64-dim driven system; ``op``
    is the generic dense operator callback, or None for a modulated
    stepper that carries its operator."""
    return jax.jit(lambda y: ensemble_solve(
        op, y, 0.0, 1.0, stepper=stepper, adaptive=True, ctl=ctl, h0=1e-2,
        time_dtype=jnp.float32, **kw))


def bench_rk4_vdp():
    """Config 2: fixed-step RK4, Van der Pol batch."""
    B, n_steps = 4096, 1000
    m = VanDerPol(mu=1.5)
    y0 = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (B, 2)),
                     jnp.float32)
    solve = jax.jit(lambda y: ensemble_solve(
        m.rhs, y, 0.0, 10.0, stepper=vo.RungeKutta(vo.RK4), adaptive=False,
        h0=10.0 / n_steps, time_dtype=jnp.float32))
    yield solve_row(f"fixed RK4 steps/sec, VdP {B}-trajectory batch",
                    solve, y0)


def bench_magnus2_lz():
    """Config 3: exponential midpoint on Landau-Zener sweeps (pair rep)."""
    B, n_steps = 1024, 2000
    lz = LandauZener(v=2.0, delta=0.4)
    solve = jax.jit(lambda y: ensemble_solve(
        lambda t: lz.op_pair(t, jnp.float32), y, -20.0, 20.0,
        stepper=vexp.ExpMidpoint(vexp.DenseCplxSplit()), adaptive=False,
        h0=40.0 / n_steps, time_dtype=jnp.float32))
    yield solve_row(f"Magnus-2 Landau-Zener steps/sec, {B} sweeps "
                    "(per-trajectory 2x2 expm)", solve, lz_ground(B))


def _generic_dense(stepper, label, seed):
    model = DrivenDense.make(d=64, seed=0)
    solve = driven_solver(stepper, lambda t: model.op_pair(t, jnp.float32))
    yield solve_row(f"{label}, 256x64-dim complex", solve,
                    random_states(256, 64, seed))


def bench_cfm4_driven():
    """Config 4: adaptive CFM-4 with GL-2 quadrature, 64-dim complex."""
    yield from _generic_dense(
        vexp.CFM4(vexp.DenseCplxSplit()),
        "adaptive CFM-4 (GL2) steps/sec (batched stacked expm)", 1)


def bench_magnus4_driven():
    yield from _generic_dense(
        vexp.Magnus4(vexp.DenseCplxSplit()),
        "adaptive Magnus-4 steps/sec (batched commutator + stacked expm "
        "pair)", 2)


def bench_magnus4_driven_fast():
    """fast_error: the order-2 comparison propagator is replaced by the
    w2*xf estimate (exp/magnus.py), halving the per-step expm stack."""
    yield from _generic_dense(
        vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True),
        "adaptive Magnus-4 steps/sec (fast_error: single-expm step)", 2)


def _modulated(make_stepper, label, B=256):
    """Adaptive exponential integrator on the Bx64 driven Hamiltonian via
    the shared-basis fast path (exp/modulated.py)."""
    mod = DrivenDense.make(d=64, seed=0).modulated(jnp.float32)
    solve = driven_solver(make_stepper(mod))
    yield solve_row(f"{label}, {B}x64-dim complex (modulated shared-basis "
                    "Taylor action)", solve, random_states(B, 64, 3))


def bench_magnus4_auto():
    """The reference's black-box operator contract (magnus.rs:32) routed
    through exp.auto_modulated: structure recovered from op_fn samples at
    set-up, then the shared-basis fast path."""
    model = DrivenDense.make(d=64, seed=0)
    mod = vexp.auto_modulated(lambda t: model.op_pair(t, jnp.float32),
                              0.0, 1.0)
    if mod is None or mod.n_terms != 2:
        raise RuntimeError("auto_modulated did not recover the 2-term basis")
    solve = driven_solver(vexp.MagnusModulated4(mod))
    yield solve_row("adaptive Magnus-4 steps/sec, 256x64-dim complex, "
                    "black-box op_fn via auto_modulated", solve,
                    random_states(256, 64, 2))


def bench_magnus4_modulated_fast():
    """fast_error: one Taylor chain + one basis contraction per adaptive
    step (vs the pair's two chains)."""
    yield from _modulated(
        lambda mod: vexp.MagnusModulated4(mod, fast_error=True),
        "adaptive Magnus-4 fast_error steps/sec")


def bench_cfm4_modulated():
    yield from _modulated(vexp.CFM4Modulated,
                          "adaptive CFM-4 (GL2) steps/sec")


def bench_magnus4_modulated():
    yield from _modulated(vexp.MagnusModulated4, "adaptive Magnus-4 steps/sec")


def bench_magnus6_modulated():
    yield from _modulated(vexp.MagnusModulated6,
                          "adaptive Magnus-6 (Yoshida) steps/sec")


def bench_magnus4_modulated_4k():
    yield from _modulated(vexp.MagnusModulated4, "adaptive Magnus-4 steps/sec",
                          B=4096)


def bench_dense_output(B=256, n_save=8):
    """Dense output: free-running cubic-Hermite saves at 8 interior times
    (dense.py), against the same solve without saves."""
    mod = DrivenDense.make(d=64, seed=0).modulated(jnp.float32)
    stepper = vexp.MagnusModulated4(mod)
    save = np.linspace(0.0, 1.0, n_save + 2)[1:-1]
    y0 = random_states(B, 64, 2)
    plain, _ = timed(driven_solver(stepper), y0)
    yield solve_row(
        f"adaptive Magnus-4 dense-output steps/sec, {B}x64-dim complex, "
        f"{n_save} free-running Hermite saves",
        driven_solver(stepper, save_at=save, dense=True), y0,
        no_saves_wall_s=plain)


def bench_lindblad(B=256, d=8):
    """Open-system throughput: adaptive Magnus-4 on the vectorized Lindblad
    superoperator (2d^2 = 128 real state width at d=8)."""
    from vec_ode_tpu.models import Lindblad

    lb = Lindblad.make(d=d, seed=9, gamma=0.2)
    mod = lb.modulated(lambda t: 0.8 * jnp.sin(2.1 * jnp.asarray(t)),
                       dtype=jnp.float32)
    rng = np.random.default_rng(3)
    # random valid density matrices: rho = V V† / tr
    V = rng.standard_normal((B, d, d)) + 1j * rng.standard_normal((B, d, d))
    rho = np.einsum("bij,bkj->bik", V, V.conj())
    rho /= np.trace(rho, axis1=-2, axis2=-1)[:, None, None]
    solve = driven_solver(vexp.MagnusModulated4(mod))
    yield solve_row(f"adaptive Magnus-4 Lindblad steps/sec, {B} open-system "
                    f"trajectories d={d} (vectorized superoperator)", solve,
                    Lindblad.vec_rho(rho, jnp.float32))


def _pulse_loss(B, d, n_steps):
    from vec_ode_tpu.models import PulseControl

    pc = PulseControl.make(d=d, seed=0, T=1.0, n_modes=6)
    y0 = random_states(B, d, 3)
    tg = cp.Cplx(jnp.roll(y0.re, 1, axis=-1), jnp.roll(y0.im, 1, axis=-1))
    return lambda th: pc.infidelity(th, y0, tg, n_steps=n_steps,
                                    dtype=jnp.float32)


def bench_adjoint_grad(B=256, d=64, n_steps=256):
    """Reversible-adjoint gradient: value_and_grad of a transfer fidelity
    through a fixed-step Magnus-4 solve (forward, backward reconstruction
    and Fréchet cotangents). Steps count both sweeps (2 * n_steps)."""
    vg = jax.jit(jax.value_and_grad(_pulse_loss(B, d, n_steps)))
    wall, _ = timed(vg, jnp.full((6,), 0.1, jnp.float32))
    yield {"metric": f"adjoint value_and_grad steps/sec, {B}x{d}-dim "
                     f"complex, Magnus-4 n_steps={n_steps} (fwd+bwd counted)",
           "value": 2 * n_steps * B / wall, "unit": "steps/sec",
           "detail": {"wall_s": wall}}


def bench_fit_loop(B=256, d=64, n_steps=256, n_iters=8):
    """On-device optimizer loop (diff.make_fit_loop): n_iters iterations of
    value_and_grad(adjoint infidelity) + Adam in one jitted call, against
    the host loop a user would otherwise write (one value_and_grad call per
    iteration). Same config as adjoint_grad."""
    import optax

    from vec_ode_tpu.diff import make_fit_loop

    loss = _pulse_loss(B, d, n_steps)
    theta = jnp.full((6,), 0.1, jnp.float32)
    wall, res = timed(make_fit_loop(loss, optax.adam(0.05), n_iters=n_iters),
                      theta)
    host_wall, _ = timed(jax.jit(jax.value_and_grad(loss)), theta)
    yield {"metric": f"fit_loop on-device Adam steps/sec, {B}x{d}-dim "
                     f"complex, Magnus-4 adjoint n_steps={n_steps}, "
                     f"{n_iters} iters per call (fwd+bwd counted)",
           "value": 2 * n_steps * B * n_iters / wall, "unit": "steps/sec",
           "detail": {"iters_per_sec": n_iters / wall,
                      "host_loop_iters_per_sec": 1.0 / host_wall,
                      "final_loss": float(res.losses[-1])}}


def bench_compensated(B=256, d=64):
    """Compensated double-f32 state tier (comp.py): what the (hi, lo) pair
    costs at rtol=1e-5, and what it buys at rtol=1e-8, where plain f32
    reject-storms on the eps*|y| estimator noise floor and adaptive
    Magnus-6 in plain f32 ends in ERR_MAX_STEPS."""
    model = DrivenDense.make(d=d, seed=0)
    op = lambda t: model.op_pair(t, jnp.float32)  # noqa: E731
    y0 = random_states(B, d, 2)

    def pair(rtol):
        ctl = vo.StepControl(rtol=rtol, min_dt=1e-6, max_dt=0.25,
                             max_steps=4000)
        (r_plain, plain), (r_comp, comp) = [solve_rate(driven_solver(
            vexp.Magnus4(vexp.DenseCplxSplit(), compensated=c), op, ctl),
            y0) for c in (False, True)]
        return {"metric": f"compensated Magnus-4 steps/sec, {B}x{d}-dim "
                          f"complex, rtol={rtol:g}",
                "value": r_comp, "unit": "steps/sec",
                "detail": {"plain_f32_rate": r_plain, "plain": plain,
                           "compensated": comp}}

    yield pair(1e-5)
    yield pair(1e-8)
    ctl6 = vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25,
                          max_steps=2000)
    sol = driven_solver(vexp.Magnus6(vexp.DenseCplxSplit(), compensated=True),
                        op, ctl6)(y0)
    yield {"metric": f"compensated adaptive Magnus-6 rtol=1e-8, {B}x{d}-dim "
                     "complex: DONE fraction (plain f32 is ERR_MAX_STEPS)",
           "value": float(np.mean(np.asarray(sol.status) == vo.DONE)),
           "unit": "fraction DONE",
           "detail": {"median_accepts": int(np.median(sol.n_accept)),
                      "median_rejects": int(np.median(sol.n_reject))}}


def bench_lz_sweep_efficiency():
    """Straggler accounting on a heterogeneous Landau-Zener sweep: plain
    batched loop vs host-compacted re-batching."""
    from vec_ode_tpu.parallel import ensemble_solve_compact, step_efficiency

    B = 256
    vs = jnp.asarray(np.linspace(0.4, 8.0, B), jnp.float32)
    y0 = (lz_ground(B), vs[:, None])
    sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float32)
    sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float32)

    def rhs(t, y):
        psi, v = y
        H = sz * (v[0] * t) + 0.4 * sx
        return (cp.Cplx(H @ psi.im, -(H @ psi.re)), jnp.zeros_like(v))

    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.5,
                         max_steps=100000)
    sol = ensemble_solve(rhs, y0, -8.0, 8.0, ctl=ctl, h0=1e-2,
                         time_dtype=jnp.float32)
    t0 = time.perf_counter()
    _, stats = ensemble_solve_compact(
        rhs, y0, -8.0, 8.0, ctl=ctl, h0=1e-2, time_dtype=jnp.float32,
        chunk_iters=16, min_batch=4, bucket_multiple=4)
    wall = time.perf_counter() - t0
    yield {"metric": f"LZ-sweep straggler efficiency, {B} heterogeneous "
                     "trajectories (useful/executed trajectory-iterations)",
           "value": stats["efficiency"], "unit": "fraction",
           "detail": {
               "plain_batched_efficiency": float(step_efficiency(sol)),
               # what an 8-shard split of this (velocity-sorted) batch
               # would waste per device
               "sorted_8shard_efficiency": float(
                   step_efficiency(sol, n_shards=8)),
               "compact_wall_s": wall,
               "useful_lane_iters": stats["useful_lane_iters"]}}


def bench_dense_profile():
    """Phase profile of the generic adaptive Magnus-4 step (256x64c,
    stacked-expm executor): each cumulative phase — sample (assemble and
    embed both nodes), commutator GEMM, stacked expm, matvec and norm — is
    timed as a scan of L iterations over the step's shapes."""
    from vec_ode_tpu.exp import dense_fast as df
    from vec_ode_tpu.exp.magnus import _B2, _C_MID
    from vec_ode_tpu.ops.expm import expm
    from vec_ode_tpu.utils.prec import HIGHEST, mm

    B, L = 256, 64
    model = DrivenDense.make(d=64, seed=0)
    y0 = random_states(B, 64, 2)
    xw = jnp.concatenate([y0.re, y0.im], axis=1)
    split = vexp.DenseCplxSplit()
    assemble = jax.vmap(lambda t: model.op_pair(t, jnp.float32))
    t0v = jnp.linspace(0.0, 1.0, B).astype(jnp.float32)
    dtv = jnp.full((B,), 1e-2, jnp.float32)
    dt3 = dtv[:, None, None]

    def sample(t):
        t12 = jnp.concatenate([t - _C_MID * dtv, t + _C_MID * dtv])
        E12 = df.embed_node(split, assemble(t12))
        return E12[:B], E12[B:]

    def omegas(t):
        E1, E2 = sample(t)
        P = mm(jnp.concatenate([E1, E2]), jnp.concatenate([E2, E1]))
        w1 = 0.5 * dt3 * (E1 + E2)
        return w1 + (_B2 * dt3 * dt3) * (P[:B] - P[B:]), w1

    def phase_expm(t):
        return expm(jnp.concatenate(omegas(t)))

    def phase_full(t):
        U = phase_expm(t)
        ys = jnp.einsum("...ij,...j->...i", U, jnp.concatenate([xw, xw]),
                        precision=HIGHEST)
        dv = ys[B:] - ys[:B]
        return jnp.sqrt(jnp.sum(dv * dv, axis=-1))

    def scanned(fn):
        def body(t, _):
            out = jax.tree_util.tree_leaves(fn(t))[0]
            return t + 1e-6 * out.ravel()[0], None
        return jax.jit(lambda t: jax.lax.scan(body, t, None, length=L)[0])

    detail = {}
    for name, fn in [("sample", sample), ("+comm", omegas),
                     ("+expm", phase_expm), ("+matvec+norm", phase_full)]:
        wall, _ = timed(scanned(fn), t0v)
        detail[name] = {"ms_per_step": wall / L * 1e3}
    yield {"metric": "generic adaptive Magnus-4 step phase profile, 256x64c "
                     f"(cumulative phases, scan of {L})",
           "value": detail["+matvec+norm"]["ms_per_step"], "unit": "ms/step",
           "detail": detail}


ALL = {
    "rk4_vdp": bench_rk4_vdp,
    "magnus2_lz": bench_magnus2_lz,
    "cfm4_driven": bench_cfm4_driven,
    "magnus4_driven": bench_magnus4_driven,
    "magnus4_driven_fast": bench_magnus4_driven_fast,
    "dense_profile": bench_dense_profile,
    "dense_output": bench_dense_output,
    "magnus4_auto": bench_magnus4_auto,
    "cfm4_modulated": bench_cfm4_modulated,
    "magnus4_modulated": bench_magnus4_modulated,
    "magnus4_modulated_fast": bench_magnus4_modulated_fast,
    "magnus6_modulated": bench_magnus6_modulated,
    "magnus4_modulated_4k": bench_magnus4_modulated_4k,
    "lindblad": bench_lindblad,
    "adjoint_grad": bench_adjoint_grad,
    "fit_loop": bench_fit_loop,
    "compensated": bench_compensated,
    "lz_sweep_efficiency": bench_lz_sweep_efficiency,
}


def main(argv=None):
    filters = sys.argv[1:] if argv is None else argv
    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.card_name_and_power(), flush=True)
    failed = False
    for name, fn in ALL.items():
        if filters and not any(f in name for f in filters):
            continue
        try:
            for row in fn():
                print(json.dumps(row), flush=True)
        except Exception as e:  # noqa: BLE001 — report the row, run the rest
            failed = True
            print(json.dumps({"metric": name, "error": str(e)[:200]}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
