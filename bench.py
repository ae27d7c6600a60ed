"""Headline benchmark on the GPU.

Adaptive RKF45 over an ensemble of 16,384 trajectories of a 64-dimensional
complex driven Schrodinger system, H(t) = H0 + cos(w t) V (BASELINE config
5), in f32 at rtol 1e-8, through ``parallel.ensemble_solve`` with the
natively batched ``FusedModulatedLinearRK`` stepper.

    python bench.py                       # the headline, one JSON line
    python bench.py --batch 2048          # another ensemble size

One process. It refuses to run without a GPU. Each solve is timed from the
call to ``block_until_ready`` after a warm-up solve (compilation is
reported as set-up), and the median over ``--repeats`` solves is kept.
The card's name and power limit are printed before the JSON line and
carried in it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK
from vec_ode_tpu.parallel import ensemble_solve
from vec_ode_tpu.utils import runtime

N_TRAJ = 16384
DIM = 64
RTOL = 1e-8
TF = 1.0
CTL = vo.StepControl(rtol=RTOL, min_dt=1e-6, max_dt=0.25)
H0 = 1e-3


def headline_model(dim: int = DIM, seed: int = 0) -> DrivenDense:
    return DrivenDense.make(d=dim, seed=seed)


def headline_y0(batch: int, dim: int = DIM, seed: int = 42):
    """Random normalised complex initial states as an f32 Cplx pair."""
    rng = np.random.default_rng(seed)
    psi0 = rng.standard_normal((batch, dim)) + 1j * rng.standard_normal(
        (batch, dim))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    return psi0, cp.from_complex(psi0, jnp.float32)


def headline_solver(stepper, mesh=None):
    """The jitted headline solve y0 -> Solution on [0, TF]."""
    return jax.jit(lambda y0: ensemble_solve(
        None, y0, 0.0, TF, stepper=stepper, ctl=CTL, h0=H0, adaptive=True,
        time_dtype=jnp.float32, mesh=mesh))


def timed(fn, y0):
    t0 = time.perf_counter()
    sol = jax.block_until_ready(fn(y0))
    return time.perf_counter() - t0, sol


def measure(stepper, y0, repeats: int) -> dict:
    """Compile + warm up, then the median wall of ``repeats`` solves."""
    fn = headline_solver(stepper)
    compile_s, sol = timed(fn, y0)
    walls = [timed(fn, y0)[0] for _ in range(repeats)]
    return _summary(sol, walls, compile_s)


def _summary(sol, walls, compile_s) -> dict:
    acc = int(np.sum(np.asarray(sol.n_accept)))
    wall = statistics.median(walls)
    return {
        "path": sol.path,
        "batch": int(sol.status.shape[0]),
        "wall_s_median": wall,
        "walls_s": walls,
        "first_call_s": compile_s,
        "accepted_steps": acc,
        "rejected_steps": int(np.sum(np.asarray(sol.n_reject))),
        "max_iters": int(np.max(np.asarray(sol.n_iters))),
        "accepted_steps_per_s": acc / wall,
        "all_done": bool(np.all(np.asarray(sol.status) == vo.DONE)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=N_TRAJ)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    runtime.enable_compile_cache()
    runtime.require_gpu()
    card = runtime.card_name_and_power()
    print(card, flush=True)
    model = headline_model()
    result = {
        "metric": (f"adaptive RKF45 accepted steps/s, {args.batch}x{DIM} "
                   f"complex driven ensemble, rtol={RTOL:g}, f32"),
        "device": runtime.device_record(),
        "card": card,
        "jax": jax.__version__,
    }
    _, y0 = headline_y0(args.batch)
    stepper = FusedModulatedLinearRK.from_driven_dense(model, jnp.float32)
    r = measure(stepper, y0, args.repeats)
    result.update(value=r["accepted_steps_per_s"], unit="steps/s", detail=r)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
