"""Compensated (double-word) time accumulation.

The reference carries t in f64 and accumulates plainly (t += dt,
/root/reference/src/base/ode.rs:184-188). An f32 solve carries t in f32,
where plain accumulation drifts by ~n*eps_f32 over a long solve — every
A(t) sample shifts. ``StepControl.time_compensated`` (default True) carries
t as a TwoSum (hi, lo) pair in the driver and the dense-output driver,
restoring f64-grade time grids in f32.

Measured baseline (this file pins it): 1e4 fixed f32 steps of h=1e-3 drift
by ~4e-5 relative under plain accumulation vs <1e-8 compensated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _flat_step(t, x, dt):
    return x + 0.0 * dt, None


def _drift(comp: bool) -> float:
    """Relative error of t after 1e4 fixed f32 steps vs exact f64
    accumulation of the same f32 step size."""
    h = np.float32(0.001)  # inexact in binary: every add rounds
    N = 10000
    ctl = vo.StepControl(max_steps=N, max_dt=1.0, time_compensated=comp)
    t_grid = vo.make_grid(0.0, 1e9, dtype=jnp.float32)  # tf unreachable
    sol = vo.integrate(_flat_step, jnp.zeros((), jnp.float32), t_grid, h,
                       adaptive=False, ctl=ctl, method="scan")
    n = int(sol.n_accept)
    assert n >= N - 1
    t_true = n * float(h)  # exact in f64
    return abs(float(sol.t_final) - t_true) / t_true


def test_f32_time_grid_matches_f64_accumulation():
    err_comp = _drift(True)
    err_plain = _drift(False)
    # done-criterion: <1e-6 relative after 1e4 steps
    assert err_comp < 1e-6, err_comp
    # sub-ulp in practice (measured 7.4e-9)
    assert err_comp < 5e-8, err_comp
    # the documented baseline drift of plain accumulation (measured 4.1e-5);
    # compensation must beat it by orders of magnitude
    assert err_plain > 1e-5, err_plain
    assert err_plain > 100 * err_comp, (err_plain, err_comp)


def test_compensated_off_is_plain_accumulation():
    # time_compensated=False reproduces the reference's plain t += dt
    # bit-for-bit: t_lo stays exactly zero
    h = np.float32(0.001)
    ctl = vo.StepControl(max_steps=100, max_dt=1.0, time_compensated=False)
    t_grid = vo.make_grid(0.0, 1e9, dtype=jnp.float32)
    state = vo.init_state(jnp.zeros((), jnp.float32), t_grid, h)
    step = jax.jit(lambda s: vo.step_once(
        s, step_fn=_flat_step, adaptive=False, ctl=ctl))
    for _ in range(50):
        state = step(state)
    t_plain = np.float32(0.0)
    for _ in range(int(state.n_accept)):  # iter 1 is the t0 grid hit
        t_plain = np.float32(t_plain + h)
    assert float(state.t_lo) == 0.0
    assert np.float32(float(state.t)) == t_plain


def _unreachable_solve(stepper, y0, h, n_steps, time_dtype):
    ctl = vo.StepControl(max_steps=n_steps, max_dt=1.0, min_dt=1e-6)
    return ensemble_solve(
        None, y0, 0.0, 1.0e6, stepper=stepper, adaptive=False, h0=h,
        ctl=ctl, time_dtype=time_dtype,
    )


def test_batched_time_compensation_matches_f64_clock():
    """The batched driver's TwoSum clock over 3000 f32 fixed steps tracks
    the exact f64 accumulation, and the plain f32 clock of the same solve
    (time_compensated=False) visibly drifts — the compensation is doing
    the work."""
    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float32)
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float32)
    h = np.float32(0.001)
    N = 3000

    st = vexp.MidpointModulated(mod)
    s_c = _unreachable_solve(st, y0, h, N, jnp.float32)
    assert s_c.path == "xla-driver"
    n = int(np.asarray(s_c.n_accept)[0])
    t_true = n * float(h)
    rel = np.abs(np.asarray(s_c.t_final, np.float64) - t_true) / t_true
    assert rel.max() < 5e-8, rel.max()
    s_p = ensemble_solve(
        None, y0, 0.0, 1.0e6, stepper=st, adaptive=False, h0=h,
        ctl=vo.StepControl(max_steps=N, max_dt=1.0, min_dt=1e-6,
                           time_compensated=False),
        time_dtype=jnp.float32)
    rel_p = np.abs(np.asarray(s_p.t_final, np.float64) - t_true) / t_true
    assert rel_p.max() > 10 * rel.max(), (rel_p.max(), rel.max())


def test_small_dim_ensemble_time_compensation():
    """A large 2-level ensemble (one compensated clock per trajectory)
    starting away from zero keeps every clock at the ulp floor."""
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float32)
    B = 512
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cp.from_complex(psi0, jnp.float32)
    h = np.float32(0.01)
    N = 2000

    ctl = vo.StepControl(max_steps=N, max_dt=1.0, min_dt=1e-6)
    s_k = ensemble_solve(
        mod, y0, -20.0, 1.0e6, stepper=vexp.MidpointModulated(mod),
        adaptive=False, h0=h, ctl=ctl, time_dtype=jnp.float32,
    )
    n = int(np.asarray(s_k.n_accept)[0])
    t_true = -20.0 + n * float(h)
    rel = np.abs(np.asarray(s_k.t_final, np.float64) - t_true) / abs(t_true)
    # plain f32 accumulation from -20 with h=0.01 drifts ~1e-5 by n=2000;
    # the compensated clocks stay at the ulp floor
    assert rel.max() < 2e-7, rel.max()

