"""Compensated (double-f32) state arithmetic (vec_ode_tpu/comp.py).

Goal: reach the reference's f64 accuracy regime
(/root/reference/src/impls/nalgebra.rs:97-99 integrates at rtol=1e-10) on
f32 hardware. These tests pin, on CPU f32 vs the f64 driver:

  * expm_m1 / cexpm1 / leaf exp_m1: phi = e^O - I with RELATIVE accuracy;
  * fixed-step accumulation drift elimination (RK + exp steppers);
  * adaptive Magnus-4 at rtol=1e-9: reject storm collapses, trajectory
    error drops ~100x vs plain f32;
  * adaptive Magnus-6 at rtol=1e-8: plain f32 livelocks into ERR_MAX_STEPS
    (the ~1e-7 estimator noise floor), compensated is DONE;
  * the batched (ensemble) tier matches the scalar compensated path;
  * what remains is the documented irreducible floor: f32 operator/exponent
    quantization, eps*int(||A||dt)-class — a perturbation of the problem,
    not state arithmetic (comp.py module docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import comp, exp as vexp
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.expm import expm, expm_m1
from vec_ode_tpu.parallel import ensemble_solve


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_two_sum_exact():
    a = jnp.float32(1.0)
    b = jnp.float32(1e-9)
    s, e = comp.two_sum(a, b)
    # the pair represents a+b EXACTLY: s + e == 1 + 1e-9 in f64
    assert float(s) + float(e) == pytest.approx(1.0 + 1e-9, abs=1e-17)
    assert float(s) == 1.0  # rounded sum
    assert float(e) == pytest.approx(1e-9, rel=1e-6)


def test_comp_update_accumulates_exactly():
    # 10^5 additions of an increment that plain f32 cannot absorb
    hi = jnp.float32(1.0)
    lo = jnp.float32(0.0)
    d = jnp.float32(1e-9)

    def body(c, _):
        h, l = c
        return comp._update_leaf(h, l, d), None

    (hi2, lo2), _ = jax.lax.scan(body, (hi, lo), None, length=100_000)
    total = float(hi2) + float(lo2)
    assert total == pytest.approx(1.0 + 1e-4, rel=1e-7)
    # plain f32 accumulation is stuck at 1.0 (1e-9 < ulp(1)/2)
    plain = jax.lax.scan(
        lambda c, _: (c + d, None), jnp.float32(1.0), None, length=100_000
    )[0]
    assert float(plain) == 1.0


def test_expm_m1_matches_expm_minus_identity_f64():
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((3, 8, 8)) * 2.0)  # exercises squaring
    phi = expm_m1(A)
    ref = expm(A) - jnp.eye(8)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(ref),
                               rtol=1e-12, atol=1e-13)


def test_expm_m1_f32_relative_accuracy_small_norm():
    # |A| ~ 1e-3: naive expm(A)-I is floored at eps*|I|/|phi| ~ 1e-4
    # relative; expm_m1 must stay ~eps relative
    import scipy.linalg as sl

    rng = np.random.default_rng(1)
    A = (rng.standard_normal((4, 8, 8)) * 1e-3).astype(np.float32)
    ref = np.stack([sl.expm(a.astype(np.float64)) - np.eye(8) for a in A])
    phi = np.asarray(expm_m1(jnp.asarray(A))).astype(np.float64)
    rel = np.max(np.abs(phi - ref)) / np.max(np.abs(ref))
    assert rel < 5e-7
    naive = np.asarray(expm(jnp.asarray(A))).astype(np.float64) - np.eye(8)
    rel_naive = np.max(np.abs(naive - ref)) / np.max(np.abs(ref))
    assert rel_naive > 20 * rel  # the m1 path is the point


def test_expm_m1_vjp_matches_expm():
    rng = np.random.default_rng(2)
    A = jnp.asarray(rng.standard_normal((6, 6)))
    g1 = jax.grad(lambda a: jnp.trace(expm_m1(a)))(A)
    g2 = jax.grad(lambda a: jnp.trace(expm(a)))(A)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-12)


@pytest.mark.parametrize("leaf", [
    vexp.DenseSplit(),
    vexp.DiagonalSplit(),
    vexp.DenseCplxSplit(),
    vexp.DiagonalCplxSplit(),
    vexp.AntiHermitianCplxSplit(),
])
def test_leaf_exp_m1_consistent(leaf):
    rng = np.random.default_rng(3)
    d = 6
    if isinstance(leaf, vexp.DiagonalSplit):
        L = jnp.asarray(rng.standard_normal(d) * 0.3)
    elif isinstance(leaf, vexp.DenseSplit):
        L = jnp.asarray(rng.standard_normal((d, d)) * 0.3)
    elif isinstance(leaf, vexp.AntiHermitianCplxSplit):
        H = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H = 0.5 * (H + H.conj().T)
        L = cp.from_complex(-1j * 0.3 * H)
    elif isinstance(leaf, vexp.DiagonalCplxSplit):
        L = cp.from_complex(
            (rng.standard_normal(d) + 1j * rng.standard_normal(d)) * 0.3
        )
    else:
        L = cp.from_complex(
            (rng.standard_normal((d, d))
             + 1j * rng.standard_normal((d, d))) * 0.3
        )
    x = (
        cp.from_complex(rng.standard_normal(d) + 1j * rng.standard_normal(d))
        if getattr(leaf, "is_cplx_split", False)
        else jnp.asarray(rng.standard_normal(d))
    )
    y_full = leaf.map_exp(leaf.exp(L), x)
    y_incr = jax.tree_util.tree_map(
        jnp.add, x, leaf.map_exp(leaf.exp_m1(L), x)
    )
    for a, b in zip(jax.tree_util.tree_leaves(y_full),
                    jax.tree_util.tree_leaves(y_incr)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-10, atol=1e-12)


def test_cexpm1_elementwise():
    z = np.array([1e-4 + 1e-5j, -0.3 + 2.0j, 0.0 + 0.0j])
    out = cp.cexpm1(cp.from_complex(z))
    ref = np.expm1(z)  # numpy complex expm1 via exp
    ref = np.exp(z) - 1.0
    got = np.asarray(out.re) + 1j * np.asarray(out.im)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # relative accuracy at tiny |z| in f32
    z32 = np.array([1e-5 + 2e-5j], np.complex64)
    o32 = cp.cexpm1(cp.from_complex(z32, jnp.float32))
    g = complex(np.asarray(o32.re)[0]) + 1j * complex(np.asarray(o32.im)[0])
    r = np.exp(z32.astype(np.complex128))[0] - 1.0
    assert abs(g - r) / abs(r) < 1e-6


# ---------------------------------------------------------------------------
# fixed-step accumulation drift (rounding isolation: same h sequence)
# ---------------------------------------------------------------------------

def _skew_problem():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((8, 8)) * 0.5
    A = A - A.T
    y0 = rng.standard_normal(8)
    y0 /= np.linalg.norm(y0)
    return A, y0


def _run_rk_fixed(A, y0, dtype, compensated, n=8000, T=8.0):
    Ad = jnp.asarray(A, dtype)
    st = vo.RungeKutta(vo.RKF45, compensated=compensated)
    sol = vo.solve_ivp(
        lambda t, y: Ad @ y, 0.0, T, jnp.asarray(y0, dtype),
        stepper=st, adaptive=False, h0=T / n,
        ctl=vo.StepControl(max_steps=n + 10, min_dt=1e-9),
        time_dtype=jnp.float64,
    )
    assert int(sol.status) == vo.DONE
    return np.asarray(sol.y_final, np.float64)


def test_rk_fixed_step_drift_eliminated():
    A, y0 = _skew_problem()
    ref = _run_rk_fixed(A, y0, jnp.float64, False)
    plain = _run_rk_fixed(A, y0, jnp.float32, False)
    compd = _run_rk_fixed(A, y0, jnp.float32, True)
    e_plain = np.max(np.abs(plain - ref))
    e_comp = np.max(np.abs(compd - ref))
    assert e_comp < e_plain / 5.0
    assert e_comp < 3e-7


def _lz_op(dtype):
    from vec_ode_tpu.models import LandauZener

    lz = LandauZener(v=2.0, delta=0.5)
    return lambda t: lz.op_pair(t, dtype)


def test_magnus4_fixed_step_drift_eliminated():
    # exponential-midpoint increment form via expm_m1: same h sequence in
    # both precisions -> the difference is pure state-arithmetic rounding
    psi0 = np.zeros(2, np.complex128)
    psi0[0] = 1.0

    def run(dtype, compensated):
        st = vexp.Magnus4(vexp.DenseCplxSplit(), compensated=compensated)
        sol = vo.solve_linear(
            _lz_op(dtype), -5.0, 5.0, cp.from_complex(psi0, dtype),
            stepper=st, adaptive=False, h0=10.0 / 4000,
            ctl=vo.StepControl(max_steps=4100, min_dt=1e-9),
            time_dtype=jnp.float64,
        )
        assert int(sol.status) == vo.DONE
        return (np.asarray(sol.y_final.re, np.float64)
                + 1j * np.asarray(sol.y_final.im, np.float64))

    ref = run(jnp.float64, False)
    plain = run(jnp.float32, False)
    compd = run(jnp.float32, True)
    e_plain = np.linalg.norm(plain - ref)
    e_comp = np.linalg.norm(compd - ref)
    assert e_comp < e_plain / 4.0
    assert e_comp < 5e-7


# ---------------------------------------------------------------------------
# adaptive: the rtol=1e-9 regime (scalar path)
# ---------------------------------------------------------------------------

def _driven_dense(scale=0.5):
    rng = np.random.default_rng(1)
    d = 8

    def mk(s):
        H = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H = 0.5 * (H + H.conj().T)
        return H * s / np.linalg.norm(H, 2)

    H0, H1 = mk(scale), mk(scale / 2)
    psi0 = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    psi0 /= np.linalg.norm(psi0)

    def op_pair(t, dtype):
        # assembly quantized to f32 for EVERY dtype: both drivers then
        # integrate the same ODE and the comparison isolates state
        # arithmetic (f32 sample quantization is a perturbation of the
        # PROBLEM — see module docstring)
        s = jnp.asarray(jnp.sin(1.3 * jnp.asarray(t, jnp.float32)),
                        jnp.float32)
        Hre = (jnp.asarray(H0.real, jnp.float32)
               + s * jnp.asarray(H1.real, jnp.float32))
        Him = (jnp.asarray(H0.imag, jnp.float32)
               + s * jnp.asarray(H1.imag, jnp.float32))
        return cp.Cplx(Him.astype(dtype), (-Hre).astype(dtype))

    return op_pair, psi0


def _adaptive_solve(op_pair, psi0, dtype, rtol, stepper):
    sol = vo.solve_linear(
        lambda t: op_pair(t, dtype), 0.0, 2.0,
        cp.from_complex(psi0, dtype), stepper=stepper, adaptive=True,
        ctl=vo.StepControl(rtol=rtol, min_dt=1e-9, max_dt=0.5,
                           max_steps=100_000),
        h0=1e-3, time_dtype=jnp.float64,
    )
    z = (np.asarray(sol.y_final.re, np.float64)
         + 1j * np.asarray(sol.y_final.im, np.float64))
    return sol, z


def test_magnus4_adaptive_rtol_1e9():
    op_pair, psi0 = _driven_dense()
    _, zref = _adaptive_solve(
        op_pair, psi0, jnp.float64, 1e-12,
        vexp.Magnus4(vexp.DenseCplxSplit()),
    )
    sp, zp = _adaptive_solve(
        op_pair, psi0, jnp.float32, 1e-9,
        vexp.Magnus4(vexp.DenseCplxSplit()),
    )
    sc, zc = _adaptive_solve(
        op_pair, psi0, jnp.float32, 1e-9,
        vexp.Magnus4(vexp.DenseCplxSplit(), compensated=True),
    )
    assert int(sc.status) == vo.DONE
    e_plain = np.linalg.norm(zp - zref) / np.linalg.norm(zref)
    e_comp = np.linalg.norm(zc - zref) / np.linalg.norm(zref)
    # measured (r5): plain 3.0e-6 with a reject storm (417 rejects);
    # compensated 3.6e-8 with ~1 reject — the increment-form estimate is
    # the difference (eps*|dy| noise floor instead of eps*|y|)
    assert e_comp < 1e-7
    assert e_comp < e_plain / 20.0
    assert int(sc.n_reject) < int(sp.n_reject) / 10


def test_magnus6_adaptive_usable_at_rtol_1e8():
    # plain-f32 Magnus-6 rejects every step
    # at rtol<=1e-7 (estimator noise ~1e-7 absolute) and dies with
    # ERR_MAX_STEPS; the compensated increment-form estimate fixes it.
    op_pair, psi0 = _driven_dense()
    _, zref = _adaptive_solve(
        op_pair, psi0, jnp.float64, 1e-12,
        vexp.Magnus4(vexp.DenseCplxSplit()),
    )
    sp, _ = _adaptive_solve(
        op_pair, psi0, jnp.float32, 1e-8,
        vexp.Magnus6(vexp.DenseCplxSplit()),
    )
    assert int(sp.status) == vo.ERR_MAX_STEPS  # the r4 failure, pinned
    sc, zc = _adaptive_solve(
        op_pair, psi0, jnp.float32, 1e-8,
        vexp.Magnus6(vexp.DenseCplxSplit(), compensated=True),
    )
    assert int(sc.status) == vo.DONE
    assert int(sc.n_accept) < 2000  # real steps, not a min-dt crawl
    e = np.linalg.norm(zc - zref) / np.linalg.norm(zref)
    assert e < 2e-7


def test_cfm4_compensated_adaptive():
    op_pair, psi0 = _driven_dense()
    _, zref = _adaptive_solve(
        op_pair, psi0, jnp.float64, 1e-12,
        vexp.Magnus4(vexp.DenseCplxSplit()),
    )
    sc, zc = _adaptive_solve(
        op_pair, psi0, jnp.float32, 1e-9,
        vexp.CFM4(vexp.DenseCplxSplit(), compensated=True),
    )
    assert int(sc.status) == vo.DONE
    assert np.linalg.norm(zc - zref) / np.linalg.norm(zref) < 2e-7


def test_expmidpoint_compensated_runs():
    op_pair, psi0 = _driven_dense()
    st = vexp.ExpMidpoint(vexp.DenseCplxSplit(), compensated=True)
    sol = vo.solve_linear(
        lambda t: op_pair(t, jnp.float32), 0.0, 1.0,
        cp.from_complex(psi0, jnp.float32), stepper=st, adaptive=False,
        h0=1e-2, ctl=vo.StepControl(max_steps=200, min_dt=1e-9),
        time_dtype=jnp.float64,
    )
    assert int(sol.status) == vo.DONE


def test_rk_compensated_adaptive_with_save_grid_and_rejects():
    # rejects + grid hits: the lo carry must only advance with the state
    A, y0 = _skew_problem()
    Ad32 = jnp.asarray(A, jnp.float32)
    Ad64 = jnp.asarray(A, jnp.float64)

    def run(dtype, Ad, compensated, rtol):
        st = vo.RungeKutta(vo.RKF45, compensated=compensated)
        return vo.solve_ivp(
            lambda t, y: Ad @ y, 0.0, 4.0, jnp.asarray(y0, dtype),
            stepper=st, adaptive=True, save_at=jnp.asarray([1.0, 2.5]),
            ctl=vo.StepControl(rtol=rtol, min_dt=1e-9, max_dt=0.5,
                               max_steps=100_000),
            time_dtype=jnp.float64,
        )

    ref = run(jnp.float64, Ad64, False, 1e-12)
    sc = run(jnp.float32, Ad32, True, 1e-8)
    assert int(sc.status) == vo.DONE
    ys_ref = np.asarray(ref.ys, np.float64)
    ys_c = np.asarray(sc.ys, np.float64)
    # interior saves and final state agree to the adaptive tolerance
    assert np.max(np.abs(ys_c - ys_ref)) < 5e-6


def test_dopri5_fsal_compensated():
    # carry = (FSAL slope, lo): both channels thread through the driver
    A, y0 = _skew_problem()
    Ad = jnp.asarray(A, jnp.float32)
    st = vo.RungeKutta(vo.DOPRI5, advance_lower=False, compensated=True)
    assert st.has_carry and st.use_fsal
    sol = vo.solve_ivp(
        lambda t, y: Ad @ y, 0.0, 4.0, jnp.asarray(y0, jnp.float32),
        stepper=st, adaptive=True,
        ctl=vo.StepControl(rtol=1e-7, min_dt=1e-9, max_dt=0.5,
                           max_steps=100_000),
        time_dtype=jnp.float64,
    )
    assert int(sol.status) == vo.DONE
    ref = _run_rk_fixed(A, y0, jnp.float64, False, n=4000, T=4.0)
    assert np.max(np.abs(np.asarray(sol.y_final, np.float64) - ref)) < 1e-5


# ---------------------------------------------------------------------------
# batched (ensemble) tier
# ---------------------------------------------------------------------------

def _batch_op(op_pair):
    return lambda t: op_pair(t, jnp.float32)


def test_batched_compensated_matches_scalar():
    op_pair, psi0 = _driven_dense()
    B = 3
    rng = np.random.default_rng(7)
    psis = rng.standard_normal((B, 8)) + 1j * rng.standard_normal((B, 8))
    psis /= np.linalg.norm(psis, axis=1, keepdims=True)
    st = vexp.Magnus4(vexp.DenseCplxSplit(), compensated=True)
    ctl = vo.StepControl(rtol=1e-9, min_dt=1e-9, max_dt=0.5,
                         max_steps=100_000)
    sol_b = ensemble_solve(
        _batch_op(op_pair), cp.from_complex(psis, jnp.float32), 0.0, 2.0,
        stepper=st, adaptive=True, ctl=ctl, h0=1e-3,
        time_dtype=jnp.float64,
    )
    assert np.all(np.asarray(sol_b.status) == vo.DONE)
    for i in range(B):
        sol_s = vo.solve_linear(
            _batch_op(op_pair), 0.0, 2.0,
            cp.from_complex(psis[i], jnp.float32), stepper=st,
            adaptive=True, ctl=ctl, h0=1e-3, time_dtype=jnp.float64,
        )
        zb = (np.asarray(sol_b.y_final.re)[i]
              + 1j * np.asarray(sol_b.y_final.im)[i])
        zs = (np.asarray(sol_s.y_final.re)
              + 1j * np.asarray(sol_s.y_final.im))
        # same tier semantics; tiny deviations from batched-uniform expm
        # squaring counts are allowed
        assert np.linalg.norm(zb - zs) < 1e-6
        assert int(np.asarray(sol_b.n_accept)[i]) == int(sol_s.n_accept) or \
            abs(int(np.asarray(sol_b.n_accept)[i]) - int(sol_s.n_accept)) <= 2


def test_batched_compensated_improves_lz():
    B = 2
    psi0 = np.zeros((B, 2), np.complex128)
    psi0[:, 0] = 1.0
    ctl9 = vo.StepControl(rtol=1e-9, min_dt=1e-9, max_dt=0.5,
                          max_steps=400_000)

    def run(dtype, compensated, rtol):
        st = vexp.Magnus4(vexp.DenseCplxSplit(), compensated=compensated)
        ctl = vo.StepControl(rtol=rtol, min_dt=1e-9, max_dt=0.5,
                             max_steps=400_000)
        sol = ensemble_solve(
            _lz_op(dtype), cp.from_complex(psi0, dtype), -10.0, 10.0,
            stepper=st, adaptive=True, ctl=ctl, h0=1e-3,
            time_dtype=jnp.float64,
        )
        assert np.all(np.asarray(sol.status) == vo.DONE)
        return (np.asarray(sol.y_final.re, np.float64)
                + 1j * np.asarray(sol.y_final.im, np.float64))

    zref = run(jnp.float64, False, 1e-12)
    zp = run(jnp.float32, False, 1e-9)
    zc = run(jnp.float32, True, 1e-9)
    e_plain = np.linalg.norm(zp[0] - zref[0])
    e_comp = np.linalg.norm(zc[0] - zref[0])
    assert e_comp < e_plain / 5.0


def test_batched_magnus6_compensated_rtol_1e8():
    op_pair, _ = _driven_dense()
    B = 2
    rng = np.random.default_rng(9)
    psis = rng.standard_normal((B, 8)) + 1j * rng.standard_normal((B, 8))
    psis /= np.linalg.norm(psis, axis=1, keepdims=True)
    st = vexp.Magnus6(vexp.DenseCplxSplit(), compensated=True)
    sol = ensemble_solve(
        _batch_op(op_pair), cp.from_complex(psis, jnp.float32), 0.0, 2.0,
        stepper=st, adaptive=True,
        ctl=vo.StepControl(rtol=1e-8, min_dt=1e-9, max_dt=0.5,
                           max_steps=100_000),
        h0=1e-3, time_dtype=jnp.float64,
    )
    assert np.all(np.asarray(sol.status) == vo.DONE)
    assert np.all(np.asarray(sol.n_accept) < 2000)


def test_batched_fast_error_compensated():
    op_pair, _ = _driven_dense()
    B = 2
    rng = np.random.default_rng(11)
    psis = rng.standard_normal((B, 8)) + 1j * rng.standard_normal((B, 8))
    psis /= np.linalg.norm(psis, axis=1, keepdims=True)
    st = vexp.Magnus4(vexp.DenseCplxSplit(), compensated=True,
                      fast_error=True)
    sol = ensemble_solve(
        _batch_op(op_pair), cp.from_complex(psis, jnp.float32), 0.0, 2.0,
        stepper=st, adaptive=True,
        ctl=vo.StepControl(rtol=1e-7, min_dt=1e-9, max_dt=0.5,
                           max_steps=100_000),
        h0=1e-3, time_dtype=jnp.float64,
    )
    assert np.all(np.asarray(sol.status) == vo.DONE)


def test_compensated_with_events():
    # events evaluate g on the plain hi state: nothing special needed
    A, y0 = _skew_problem()
    Ad = jnp.asarray(A, jnp.float32)
    st = vo.RungeKutta(vo.RKF45, compensated=True)
    ev = vo.Event(lambda t, y: y[0])
    sol = vo.solve_ivp(
        lambda t, y: Ad @ y, 0.0, 6.0, jnp.asarray(y0, jnp.float32),
        stepper=st, adaptive=True, events=ev,
        ctl=vo.StepControl(rtol=1e-7, min_dt=1e-9, max_dt=0.5,
                           max_steps=100_000),
        time_dtype=jnp.float64,
    )
    assert int(sol.status) == vo.DONE
    if bool(np.asarray(sol.event_found)[0]):
        ref = vo.solve_ivp(
            lambda t, y: jnp.asarray(A) @ y, 0.0, 6.0,
            jnp.asarray(y0, jnp.float64), adaptive=True,
            events=vo.Event(lambda t, y: y[0]),
            ctl=vo.StepControl(rtol=1e-10, min_dt=1e-12, max_dt=0.5),
            time_dtype=jnp.float64,
        )
        assert abs(float(np.asarray(sol.event_t)[0])
                   - float(np.asarray(ref.event_t)[0])) < 1e-3
