"""Open quantum system: driven, damped qudit via the Lindblad master
equation on the modulated-superoperator fast path.

    python examples/lindblad_open_system.py
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
from vec_ode_tpu.models import Lindblad


def main():
    d = 3
    lb = Lindblad.make(d=d, seed=9, gamma=0.25)
    mod = lb.modulated(lambda t: 0.8 * jnp.sin(2.1 * jnp.asarray(t)))

    rho0 = np.zeros((d, d), complex)
    rho0[d - 1, d - 1] = 1.0                     # start fully excited
    v0 = Lindblad.vec_rho(rho0[None])

    sol = vo.solve_linear(
        None, 0.0, 4.0, v0, stepper=vexp.MagnusModulated4(mod),
        adaptive=True,
        ctl=vo.StepControl(rtol=1e-9, atol=1e-11, min_dt=1e-8, max_dt=0.1),
    )
    rho = Lindblad.unvec_rho(sol.y_final)[0]
    pops = np.real(np.diag(rho))
    print(f"accepted steps: {int(sol.n_accept)}")
    print("final populations:", pops.round(4), " trace:",
          float(np.trace(rho).real))
    assert abs(np.trace(rho).real - 1.0) < 1e-8
    assert pops[d - 1] < 0.6                      # decay happened


if __name__ == "__main__":
    main()
