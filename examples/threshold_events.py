"""Stop each trajectory of an ensemble at a population threshold.

A Landau-Zener sweep ensemble integrates until each trajectory's excited-
state population first crosses a threshold. The event function is a
declared observable (events.QuadraticObservable: g = Σ qᵢ|xᵢ|² − c); the
batched driver's regula-falsi search — crossing detection, bracket
shrinking, terminal stop at DONE_EVENT, located time/state recording — runs
as masked arithmetic inside the one driver loop. Runs in f32 on the default
JAX backend:

    python examples/threshold_events.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.events import Event, EventConfig, QuadraticObservable
from vec_ode_tpu.models import LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve

B = 256
THRESHOLD = 0.05


def main():
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float32)
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float32)

    # g(t, psi) = |psi_1|^2 - threshold, rising crossing, terminal
    event = Event(
        QuadraticObservable(q=[0.0, 1.0], c=THRESHOLD),
        direction=1, terminal=True,
    )
    cfg = EventConfig(events=(event,), t_tol=1e-4)

    sol = ensemble_solve(
        mod, y0, -20.0, 20.0, stepper=vexp.MagnusModulated4(mod),
        adaptive=True, h0=1e-2, time_dtype=jnp.float32, events=cfg,
        ctl=vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4,
                           max_dt=1.0),
    )

    assert (np.asarray(sol.status) == vo.DONE_EVENT).all()
    t_hit = np.asarray(sol.event_t)[:, 0]
    pop = (np.asarray(sol.event_y.re)[:, 0, 1] ** 2
           + np.asarray(sol.event_y.im)[:, 0, 1] ** 2)
    print(f"execution path : {sol.path}")
    print(f"threshold hit  : t* = {t_hit[0]:.5f} "
          f"(all {B} trajectories, spread {np.ptp(t_hit):.1e})")
    print(f"population(t*) : {pop[0]:.5f} (threshold {THRESHOLD})")
    assert abs(pop[0] - THRESHOLD) < 1e-3


if __name__ == "__main__":
    main()
