"""Event detection + differentiable event times: projectile range with drag.

A projectile with quadratic drag has no closed-form impact time; the
classic way to find the range is a terminal event on altitude z = 0
(scipy's solve_ivp(events=...) tutorial problem). Here the whole pipeline
is branchless masked arithmetic (vec_ode_tpu/events.py):

  1. an ENSEMBLE of launch angles integrates in one batched adaptive
     solve, each trajectory stopping at ITS OWN impact event
     (status DONE_EVENT), with the impact state recorded to ~64*eps;
  2. the range R(angle) = x(t*) at the event is DIFFERENTIATED through the
     solver (method="scan") — the implicit-function-theorem sensitivity of
     an event-located state with no custom rule — and a few Newton steps
     find the drag-optimal launch angle (< 45 deg, as physics demands).

Runs on CPU in ~30 s:

    python examples/impact_events.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import vec_ode_tpu as vo
from vec_ode_tpu.events import Event
from vec_ode_tpu.parallel import ensemble_solve

G = 9.81      # gravity
K = 0.02      # quadratic drag coefficient
V0 = 50.0     # launch speed


def rhs(t, s):
    # s = [x, z, vx, vz]; quadratic drag opposes the velocity
    v = jnp.sqrt(s[2] ** 2 + s[3] ** 2)
    return jnp.stack([s[2], s[3], -K * v * s[2], -G - K * v * s[3]])


def launch_state(angle):
    return jnp.stack([
        jnp.zeros_like(angle), jnp.zeros_like(angle) + 1e-9,
        V0 * jnp.cos(angle), V0 * jnp.sin(angle),
    ])


IMPACT = Event(lambda t, s: s[1], direction=-1, terminal=True)
CTL = vo.StepControl(rtol=1e-8, max_steps=400)


def main():
    # --- 1. ensemble of launch angles, one batched event-terminated solve
    angles = jnp.asarray(np.deg2rad(np.linspace(15.0, 75.0, 13)))
    s0 = jax.vmap(launch_state)(angles)
    sol = ensemble_solve(rhs, s0, 0.0, 20.0, ctl=CTL, events=IMPACT)
    assert np.all(np.asarray(sol.status) == vo.DONE_EVENT)
    t_imp = np.asarray(sol.event_t)[:, 0]
    ranges = np.asarray(sol.event_y)[:, 0, 0]
    print(" angle[deg]   t_impact[s]   range[m]")
    for a, t, r in zip(np.rad2deg(angles), t_imp, ranges):
        print(f"   {a:6.1f}      {t:7.3f}     {r:8.2f}")

    # --- 2. drag-optimal angle by differentiating THROUGH the impact event
    def neg_range(angle):
        sol = vo.solve_ivp(
            rhs, 0.0, 20.0, launch_state(angle), ctl=CTL,
            method="scan", events=IMPACT,
        )
        return -sol.event_y[0][0]

    angle = jnp.asarray(np.deg2rad(40.0))
    grad = jax.grad(neg_range)
    for _ in range(25):
        angle = angle - 0.002 * grad(angle)
    best = float(np.rad2deg(angle))
    print(f"\noptimal launch angle with drag: {best:.2f} deg "
          f"(vacuum: 45.00), range {-float(neg_range(angle)):.2f} m")
    # with drag the optimum is strictly below 45 degrees
    assert 35.0 < best < 45.0
    # stationarity: dR/dangle ~ 0 at the optimum
    assert abs(float(grad(angle))) < 2.0
    print("OK")


if __name__ == "__main__":
    main()
