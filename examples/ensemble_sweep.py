"""Landau-Zener parameter sweep: one adaptive solve per sweep velocity,
batched with vmap and (if several devices are visible) sharded over the
mesh. Compares against the asymptotic Landau-Zener formula.

    python examples/ensemble_sweep.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def main():
    B = 16
    vs = np.linspace(1.0, 4.0, B)
    delta = 0.4
    psi0 = np.zeros((B, 2), complex)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float64)

    def op_fn(t, v):
        # A(t) = -i H(t), H = v t sz/2 + delta sx/2, per-trajectory v
        sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float64)
        sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float64)
        H = v * t * sz + delta * sx
        return cp.Cplx(jnp.zeros_like(H), -H)

    sol = ensemble_solve(
        op_fn, y0, -25.0, 25.0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()),
        params=jnp.asarray(vs),
        ctl=vo.StepControl(rtol=1e-9, min_dt=1e-6, max_dt=0.5,
                           max_steps=100000),
        h0=1e-2,
    )
    p_stay = np.asarray(sol.y_final.re[:, 0] ** 2 + sol.y_final.im[:, 0] ** 2)
    p_lz = np.exp(-np.pi * delta**2 / (2 * vs))
    print(" v     P(stay)   P_LZ")
    for v, p, pl in zip(vs, p_stay, p_lz):
        print(f"{v:4.2f}  {p:.5f}  {pl:.5f}")
    assert np.all(np.abs(p_stay - p_lz) < 0.02)


if __name__ == "__main__":
    main()
