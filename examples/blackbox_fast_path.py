"""The reference's OPAQUE operator contract on the structured fast path.

A vec-ode user hands the solver nothing but a black-box callback
``op_fn(t) -> A(t)`` (magnus.rs:32). This example shows the escalation the
rebuild offers for that exact contract, on the reference's bread-and-butter
problem (a 2-level Landau-Zener sweep):

  1. generic dense path  — per-trajectory expm, no structure assumed;
  2. auto_modulated      — SVD over probe samples recovers
                           A(t) = c1(t)·(-i sz) + c2(t)·(-i sx),
                           validated at held-out times, and the solve runs
                           on shared-basis Taylor actions (plain GEMMs, no
                           per-trajectory matrices).

Both produce the same physics (checked against the closed-form asymptotic
transition probability). Runs in f32 on the default JAX backend:

    python examples/blackbox_fast_path.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def main():
    dtype = jnp.float32
    lz = LandauZener(v=2.0, delta=0.4)

    # the ONLY thing the user provides: an opaque operator callback
    def op_fn(t):
        return lz.op_pair(t, dtype)

    B = 256
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, dtype)
    ctl = vo.StepControl(rtol=1e-6, max_steps=40000)

    # --- 1. generic dense path: correct for ANY op_fn ----------------------
    sol_dense = ensemble_solve(
        op_fn, y0, -20.0, 20.0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()),
        ctl=ctl, h0=0.05, time_dtype=dtype,
    )

    # --- 2. automatic structure recovery ----------------------------------
    mod = vexp.auto_modulated(op_fn, -20.0, 20.0, dtype=dtype)
    assert mod is not None, "LZ is rank-2 modulated; detection must succeed"
    print(f"recovered structure: K = {mod.n_terms} basis matrices")

    sol_fast = ensemble_solve(
        mod, y0, -20.0, 20.0,
        stepper=vexp.MagnusModulated4(mod),
        ctl=ctl, h0=0.05, time_dtype=dtype,
    )

    # --- same physics, both paths -----------------------------------------
    for name, sol in [("dense", sol_dense), ("fast", sol_fast)]:
        assert (np.asarray(sol.status) == vo.DONE).all()
        re, im = np.asarray(sol.y_final.re[0]), np.asarray(sol.y_final.im[0])
        p_stay = float(re[0] ** 2 + im[0] ** 2)
        print(f"{name:5s}: P_stay = {p_stay:.4f}  "
              f"(closed form {lz.p_transition:.4f}), "
              f"mean accepted steps "
              f"{float(np.asarray(sol.n_accept).mean()):.0f}")
        assert abs(p_stay - lz.p_transition) < 0.02
    d = max(
        np.abs(np.asarray(sol_dense.y_final.re)
               - np.asarray(sol_fast.y_final.re)).max(),
        np.abs(np.asarray(sol_dense.y_final.im)
               - np.asarray(sol_fast.y_final.im)).max(),
    )
    print(f"max |dense - fast| final-state difference: {d:.2e}")
    print("ok")


if __name__ == "__main__":
    main()
