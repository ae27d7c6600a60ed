"""Modulated-operator fast path (exp/modulated.py): shared-basis Taylor
propagator actions must match the generic dense-split solvers.

Generic semantics under test: magnus.rs:10-26 (midpoint), magnus.rs:28-83
(Magnus-4), cfm.rs:43-100 (CFM) — already validated for the dense splits in
test_exp_solvers.py; here the modulated path is compared against those.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.exp.modulated import ModulatedOperator, modulated_exp_apply
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.expm import expm
from vec_ode_tpu.parallel import ensemble_solve


def _psi0(d, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    return cp.from_complex(z, dtype)


def test_exp_apply_matches_expm():
    """modulated_exp_apply == expm(sum c_k M_k) @ x for random real basis."""
    rng = np.random.default_rng(3)
    K, D = 3, 16
    basis = jnp.asarray(rng.standard_normal((K, D, D)) * 0.4)
    coeffs = jnp.asarray(rng.standard_normal((5, K)))
    x = jnp.asarray(rng.standard_normal((5, D)))

    y = modulated_exp_apply(basis, coeffs, x)
    A = jnp.einsum("lk,kij->lij", coeffs, basis)
    y_ref = jnp.einsum("lij,lj->li", expm(A), x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-12, atol=1e-12)


def test_exp_apply_large_norm_scaling():
    """Squaring path: ||A|| >> theta still accurate (batch-uniform s)."""
    rng = np.random.default_rng(4)
    D = 8
    basis = jnp.asarray(rng.standard_normal((2, D, D)))
    coeffs = jnp.asarray([[3.0, -2.0]])
    x = jnp.asarray(rng.standard_normal((1, D)))
    y = modulated_exp_apply(basis, coeffs, x)
    A = jnp.einsum("lk,kij->lij", coeffs, basis)
    y_ref = jnp.einsum("lij,lj->li", expm(A), x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=1e-10, atol=1e-10)


def test_exp_apply_zero_dt_is_identity():
    rng = np.random.default_rng(5)
    basis = jnp.asarray(rng.standard_normal((2, 6, 6)))
    x = jnp.asarray(rng.standard_normal((6,)))
    y = modulated_exp_apply(basis, jnp.zeros((2,)), x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=0, atol=0)


def _driven_setup(d=8, dtype=jnp.float64):
    model = DrivenDense.make(d=d, seed=0)
    mod = model.modulated(dtype)
    op_fn = lambda t: model.op_pair(t, dtype)
    return model, mod, op_fn


def test_modulated_assemble_matches_dense():
    _, mod, op_fn = _driven_setup()
    for t in (0.0, 0.37, 1.9):
        A_mod = mod.assemble(jnp.asarray(t, jnp.float64))
        A_ref = op_fn(t)
        np.testing.assert_allclose(np.asarray(A_mod.re), np.asarray(A_ref.re),
                                   atol=1e-14)
        np.testing.assert_allclose(np.asarray(A_mod.im), np.asarray(A_ref.im),
                                   atol=1e-14)


@pytest.mark.parametrize("make_pair", [
    lambda mod, op_fn: (
        vexp.MidpointModulated(mod),
        vexp.ExpMidpoint(vexp.DenseCplxSplit()),
        False,
    ),
    lambda mod, op_fn: (
        vexp.MagnusModulated4(mod),
        vexp.Magnus4(vexp.DenseCplxSplit()),
        True,
    ),
    lambda mod, op_fn: (
        vexp.CFM4Modulated(mod),
        vexp.CFM4(vexp.DenseCplxSplit()),
        True,
    ),
    lambda mod, op_fn: (
        vexp.MagnusModulated6(mod),
        vexp.Magnus6(vexp.DenseCplxSplit()),
        True,
    ),
])
def test_modulated_matches_generic_trajectory(make_pair):
    """Full adaptive/fixed solve: modulated stepper == generic dense-split
    stepper on the same driven Hamiltonian (identical step sequences in
    f64)."""
    _, mod, op_fn = _driven_setup()
    st_mod, st_gen, adaptive = make_pair(mod, op_fn)
    psi0 = _psi0(8)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)

    sol_m = vo.solve_linear(None, 0.0, 1.5, psi0, stepper=st_mod,
                            adaptive=adaptive, ctl=ctl, h0=1e-2)
    sol_g = vo.solve_linear(op_fn, 0.0, 1.5, psi0, stepper=st_gen,
                            adaptive=adaptive, ctl=ctl, h0=1e-2)

    assert int(sol_m.status) == vo.DONE and int(sol_g.status) == vo.DONE
    assert int(sol_m.n_accept) == int(sol_g.n_accept)
    assert int(sol_m.n_reject) == int(sol_g.n_reject)
    np.testing.assert_allclose(np.asarray(sol_m.y_final.re),
                               np.asarray(sol_g.y_final.re),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(sol_m.y_final.im),
                               np.asarray(sol_g.y_final.im),
                               rtol=1e-9, atol=1e-9)


def test_magnus_modulated_fixed_step_order4():
    """Global error slope ~4 for fixed-step MagnusModulated4."""
    _, mod, op_fn = _driven_setup()
    psi0 = _psi0(8, seed=1)
    st = vexp.MagnusModulated4(mod, adaptive=False)

    ref = vo.solve_linear(None, 0.0, 1.0, psi0, stepper=st,
                          adaptive=False, h0=1.0 / 512,
                          ctl=vo.StepControl(max_steps=4000))
    errs = []
    hs = [1.0 / 8, 1.0 / 16, 1.0 / 32]
    for h in hs:
        s = vo.solve_linear(None, 0.0, 1.0, psi0, stepper=st,
                            adaptive=False, h0=h,
                            ctl=vo.StepControl(max_steps=4000))
        d = np.linalg.norm(
            np.asarray(s.y_final.re - ref.y_final.re)
            + 1j * np.asarray(s.y_final.im - ref.y_final.im)
        )
        errs.append(d)
    slopes = np.diff(np.log(errs)) / np.diff(np.log(hs))
    assert slopes.mean() > 3.5, (errs, slopes)


def test_magnus_modulated_unitarity():
    _, mod, _ = _driven_setup(d=8)
    psi0 = _psi0(8, seed=2)
    sol = vo.solve_linear(None, 0.0, 4.0, psi0,
                          stepper=vexp.MagnusModulated4(mod), adaptive=True,
                          ctl=vo.StepControl(rtol=1e-8, max_dt=0.5))
    n = float(jnp.sqrt(jnp.sum(sol.y_final.re**2 + sol.y_final.im**2)))
    assert int(sol.status) == vo.DONE
    assert abs(n - 1.0) < 1e-8


def test_landau_zener_modulated_transition():
    """Golden physics: LZ transition probability via the modulated path."""
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float64)
    psi0 = cp.Cplx(jnp.asarray([1.0, 0.0], jnp.float64),
                   jnp.zeros(2, jnp.float64))
    sol = vo.solve_linear(None, -25.0, 25.0, psi0,
                          stepper=vexp.MagnusModulated4(mod), adaptive=True,
                          ctl=vo.StepControl(rtol=1e-9, min_dt=1e-6,
                                             max_dt=0.5, max_steps=100000))
    assert int(sol.status) == vo.DONE
    p_stay = float(sol.y_final.re[0] ** 2 + sol.y_final.im[0] ** 2)
    assert abs(p_stay - lz.p_transition) < 5e-3, (p_stay, lz.p_transition)


def test_modulated_ensemble_vmap_and_mesh():
    """Ensemble of driven trajectories under vmap + 8-device mesh matches
    per-trajectory solves."""
    from vec_ode_tpu.parallel import ensemble_mesh, shard_batch

    model, mod, op_fn = _driven_setup(d=8, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    z = rng.standard_normal((16, 8)) + 1j * rng.standard_normal((16, 8))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    y0 = cp.from_complex(z, jnp.float32)
    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.3)
    st = vexp.MagnusModulated4(mod)

    mesh = ensemble_mesh(8)
    sol = ensemble_solve(None, shard_batch(y0, mesh), 0.0, 0.5,
                         stepper=st, ctl=ctl, h0=1e-2,
                         time_dtype=jnp.float32, mesh=mesh)
    assert (np.asarray(sol.status) == vo.DONE).all()

    one = vo.solve_linear(
        None, 0.0, 0.5,
        cp.Cplx(y0.re[3], y0.im[3]), stepper=st, adaptive=True,
        ctl=ctl, h0=1e-2, time_dtype=jnp.float32,
    )
    np.testing.assert_allclose(np.asarray(sol.y_final.re[3]),
                               np.asarray(one.y_final.re),
                               rtol=2e-5, atol=2e-5)


def test_real_modulated_operator():
    """Plain-real basis (no Cplx): damped driven linear system."""
    rng = np.random.default_rng(9)
    d = 6
    M0 = jnp.asarray(-np.eye(d) - 0.2 * rng.standard_normal((d, d)))
    M1 = jnp.asarray(0.3 * rng.standard_normal((d, d)))
    mod = ModulatedOperator(
        basis=jnp.stack([M0, M1]),
        coeff_fn=lambda t: jnp.stack(
            [jnp.ones_like(jnp.asarray(t, jnp.float64)),
             jnp.sin(jnp.asarray(t, jnp.float64))]
        ),
    )
    y0 = jnp.asarray(rng.standard_normal(d))
    sol = vo.solve_linear(None, 0.0, 2.0, y0,
                          stepper=vexp.MagnusModulated4(mod), adaptive=True,
                          ctl=vo.StepControl(rtol=1e-8, max_dt=0.25))
    # reference: generic Magnus4 on DenseSplit with assembled operator
    sol_ref = vo.solve_linear(
        mod.assemble, 0.0, 2.0, y0,
        stepper=vexp.Magnus4(vexp.DenseSplit()), adaptive=True,
        ctl=vo.StepControl(rtol=1e-8, max_dt=0.25),
    )
    assert int(sol.status) == vo.DONE
    np.testing.assert_allclose(np.asarray(sol.y_final),
                               np.asarray(sol_ref.y_final),
                               rtol=1e-8, atol=1e-10)


def test_chain_expmv_matches_expm():
    """Chain-exponential action (ops/chain.py, pre-scaled rows, uniform
    pass count) vs direct expm composition: the advance chain and the
    per-trajectory distance of the comparison chain."""
    from vec_ode_tpu.ops.chain import chain_expmv_xla

    rng = np.random.default_rng(11)
    B, D, C, R, K = 16, 32, 2, 2, 3
    basis = jnp.asarray(rng.standard_normal((K, D, D)) * 0.05)
    chains = jnp.asarray(rng.standard_normal((B, C, R, K)) * 0.6)
    xw = jnp.asarray(rng.standard_normal((B, D)))

    y, e = chain_expmv_xla(chains / 4.0, jnp.asarray(4, jnp.int32), xw, basis,
                           m=12)

    A = jnp.einsum("bcrk,kij->bcrij", chains, basis)
    ys = []
    for c in range(C):
        v = xw
        for r in range(R):
            v = jnp.einsum("bij,bj->bi", expm(A[:, c, r]), v)
        ys.append(v)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ys[0]),
                               rtol=1e-12, atol=1e-12)
    e_direct = np.linalg.norm(np.asarray(ys[1] - ys[0]), axis=-1)
    np.testing.assert_allclose(np.asarray(e), e_direct, rtol=1e-10)


def _batched_step_vs_generic(st_mod, st_gen, op_fn, d=8):
    """One batched modulated step over B trajectories against the generic
    dense-split step taken trajectory by trajectory (f64): state and
    per-trajectory error norm."""
    from vec_ode_tpu import lc

    rng = np.random.default_rng(12)
    B = 6
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    y0 = cp.from_complex(z, jnp.float64)
    t = jnp.asarray(np.linspace(0.1, 0.9, B))
    dt = jnp.asarray(np.linspace(0.02, 0.08, B))
    xf, e = st_mod.make_step_fn()(t, y0, dt)
    gen = st_gen.make_step_fn(op_fn)
    for b in range(B):
        xb, eb = gen(t[b], cp.Cplx(y0.re[b], y0.im[b]), dt[b])
        np.testing.assert_allclose(np.asarray(xf.re[b]), np.asarray(xb.re),
                                   rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(np.asarray(xf.im[b]), np.asarray(xb.im),
                                   rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(float(e[b]), float(lc.norm_l2(eb)),
                                   rtol=1e-6, atol=1e-14)


def test_magnus_modulated_batched_step_matches_generic():
    """Batched Magnus-4 modulated step == generic Magnus-4 dense step."""
    _, mod, op_fn = _driven_setup()
    _batched_step_vs_generic(vexp.MagnusModulated4(mod),
                             vexp.Magnus4(vexp.DenseCplxSplit()), op_fn)


def _ensemble_y0(B=6, d=8, seed=21, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return cp.from_complex(z, dtype)


class TestBatchedDriver:
    """Natively batched modulated steppers under the XLA driver against
    the generic dense-split steppers solved per trajectory (vmapped, f64):
    statuses, counters, trajectories and save grids."""

    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-5, max_dt=0.2, max_steps=500)

    def _solve(self, stepper, y0, op_fn=None, ctl=None, adaptive=True,
               **kw):
        return ensemble_solve(op_fn, y0, 0.0, 0.5, stepper=stepper,
                              adaptive=adaptive, ctl=ctl or self.ctl,
                              h0=1e-2, time_dtype=jnp.float64, **kw)

    @pytest.mark.parametrize("make", [
        lambda mod: (vexp.MagnusModulated4(mod),
                     vexp.Magnus4(vexp.DenseCplxSplit(), batched=False),
                     True),
        lambda mod: (vexp.CFM4Modulated(mod),
                     vexp.CFM4(vexp.DenseCplxSplit(), batched=False), True),
        lambda mod: (vexp.MidpointModulated(mod),
                     vexp.ExpMidpoint(vexp.DenseCplxSplit(), batched=False),
                     False),
        lambda mod: (vexp.MagnusModulated6(mod),
                     vexp.Magnus6(vexp.DenseCplxSplit(), batched=False),
                     True),
    ])
    def test_matches_generic_per_trajectory(self, make):
        _, mod, op_fn = _driven_setup()
        st_b, st_g, adaptive = make(mod)
        y0 = _ensemble_y0()
        sol_b = self._solve(st_b, y0, adaptive=adaptive)
        sol_g = self._solve(st_g, y0, op_fn, adaptive=adaptive)
        assert sol_b.path == "xla-driver"
        assert (np.asarray(sol_b.status) == vo.DONE).all()
        np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                      np.asarray(sol_g.n_accept))
        np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                                   np.asarray(sol_g.y_final.re), atol=1e-9)
        np.testing.assert_allclose(np.asarray(sol_b.y_final.im),
                                   np.asarray(sol_g.y_final.im), atol=1e-9)
        # ys = [x0, x_final]
        np.testing.assert_array_equal(np.asarray(sol_b.ys.re[:, 0]),
                                      np.asarray(y0.re))
        np.testing.assert_array_equal(np.asarray(sol_b.ys.re[:, 1]),
                                      np.asarray(sol_b.y_final.re))

    def test_pi_controller_matches_generic(self):
        """Opt-in PI (Gustafsson) control on the batched driver: the same
        step sequences as the generic stepper under PI, and different from
        the I controller."""
        _, mod, op_fn = _driven_setup()
        y0 = _ensemble_y0()
        ctl = vo.StepControl(rtol=1e-6, min_dt=1e-5, max_dt=0.2,
                             max_steps=500, pi=True, pi_order=4.0)
        sol_b = self._solve(vexp.MagnusModulated4(mod), y0, ctl=ctl)
        sol_g = self._solve(vexp.Magnus4(vexp.DenseCplxSplit(),
                                         batched=False), y0, op_fn, ctl=ctl)
        assert (np.asarray(sol_b.status) == vo.DONE).all()
        np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                      np.asarray(sol_g.n_accept))
        np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                                   np.asarray(sol_g.y_final.re), atol=1e-9)
        sol_i = self._solve(vexp.MagnusModulated4(mod), y0)
        assert ((np.asarray(sol_i.n_accept) != np.asarray(sol_b.n_accept))
                | (np.asarray(sol_i.n_reject)
                   != np.asarray(sol_b.n_reject))).any()

    def test_strict_end_test_matches_default(self):
        """strict_end_test (the reference's unscaled eps end test) is, for
        |t| ~ 1, behaviorally identical to the default scaled test (see
        controller.end_tolerance) — results must be bit-identical."""
        _, mod, _ = _driven_setup()
        y0 = _ensemble_y0()
        st = vexp.MagnusModulated4(mod)
        base = dict(rtol=1e-6, min_dt=1e-5, max_dt=0.2, max_steps=500)
        sol_s = self._solve(st, y0,
                            ctl=vo.StepControl(strict_end_test=True, **base))
        sol_d = self._solve(st, y0, ctl=vo.StepControl(**base))
        assert (np.asarray(sol_s.status) == vo.DONE).all()
        np.testing.assert_array_equal(np.asarray(sol_s.n_accept),
                                      np.asarray(sol_d.n_accept))
        np.testing.assert_array_equal(np.asarray(sol_s.y_final.re),
                                      np.asarray(sol_d.y_final.re))

    def test_scaled_error_on_vector_error_stepper(self):
        """scaled_error needs the error VECTOR: on the exp path it runs on
        the generic dense-split stepper (vmapped). With unit-sphere states
        the per-component scale ~ rtol*|x_i| makes the scaled measure
        STRICTER than the raw norm (mean |x_i| = 1/sqrt(d) < 1): more
        steps, and an accurate trajectory."""
        _, _, op_fn = _driven_setup()
        y0 = _ensemble_y0()
        st = vexp.Magnus4(vexp.DenseCplxSplit(), batched=False)
        ctl_s = vo.StepControl(rtol=1e-6, atol=1e-12, scaled_error=True,
                               min_dt=1e-5, max_dt=0.2, max_steps=500)
        sol_s = self._solve(st, y0, op_fn, ctl=ctl_s)
        sol_u = self._solve(st, y0, op_fn)
        assert (np.asarray(sol_s.status) == vo.DONE).all()
        assert (np.asarray(sol_s.n_accept)
                >= np.asarray(sol_u.n_accept)).all()
        np.testing.assert_allclose(np.asarray(sol_s.y_final.re),
                                   np.asarray(sol_u.y_final.re),
                                   rtol=1e-5, atol=1e-5)

    def test_scaled_error_norm_stepper_raises(self):
        """scaled_error with a norm-returning stepper must raise the
        dedicated error, not a tree-structure crash."""
        mod = _driven_setup(dtype=jnp.float32)[1]
        y0 = _ensemble_y0(dtype=jnp.float32)
        with pytest.raises(ValueError, match="per-trajectory norms"):
            ensemble_solve(
                None, y0, 0.0, 0.5, stepper=vexp.MagnusModulated4(mod),
                adaptive=True,
                ctl=vo.StepControl(rtol=1e-4, scaled_error=True,
                                   min_dt=1e-5, max_dt=0.2),
                h0=1e-2, time_dtype=jnp.float32,
            )

    def test_while_matches_scan(self):
        """The lax.while_loop driver and the bounded-scan driver share the
        iteration body — results must be bit-identical, counters
        included."""
        _, mod, _ = _driven_setup()
        y0 = _ensemble_y0()
        st = vexp.MagnusModulated4(mod)
        sol_w = self._solve(st, y0, method="while")
        sol_s = self._solve(st, y0, method="scan")
        for name in ("status", "n_accept", "n_reject", "t_final"):
            np.testing.assert_array_equal(
                np.asarray(getattr(sol_w, name)),
                np.asarray(getattr(sol_s, name)), err_msg=name)
        np.testing.assert_array_equal(np.asarray(sol_w.y_final.re),
                                      np.asarray(sol_s.y_final.re))
        np.testing.assert_array_equal(np.asarray(sol_w.y_final.im),
                                      np.asarray(sol_s.y_final.im))

    def test_max_steps_status(self):
        _, mod, _ = _driven_setup()
        y0 = _ensemble_y0()
        ctl = vo.StepControl(rtol=1e-6, min_dt=1e-5, max_dt=0.2, max_steps=5)
        sol = self._solve(vexp.MagnusModulated4(mod), y0, ctl=ctl)
        assert (np.asarray(sol.status) == vo.ERR_MAX_STEPS).all()
        assert (np.asarray(sol.n_iters) >= 5).all()
        # unfinished: ys[1] stays zero (the driver's unfilled save buffer)
        assert (np.asarray(sol.ys.re[:, 1]) == 0).all()

    def test_interior_save_grid_matches_generic(self):
        """save_at grids are hit exactly; the recorded states match the
        generic per-trajectory solves on the same grid."""
        _, mod, op_fn = _driven_setup()
        y0 = _ensemble_y0()
        save = np.asarray([0.17, 0.33])
        sol_b = self._solve(vexp.MagnusModulated4(mod), y0, save_at=save)
        sol_g = self._solve(vexp.Magnus4(vexp.DenseCplxSplit(),
                                         batched=False), y0, op_fn,
                            save_at=save)
        assert (np.asarray(sol_b.status) == vo.DONE).all()
        assert sol_b.ys.re.shape[1] == 4
        np.testing.assert_allclose(np.asarray(sol_b.ys.re),
                                   np.asarray(sol_g.ys.re), atol=1e-9)
        np.testing.assert_allclose(np.asarray(sol_b.ys.im),
                                   np.asarray(sol_g.ys.im), atol=1e-9)
        np.testing.assert_array_equal(np.asarray(sol_b.n_iters),
                                      np.asarray(sol_g.n_iters))

    def test_large_save_grid_hits_every_point(self):
        """A 1,060-point interior save grid: every save time is hit
        exactly (ts), and each recorded state agrees with a tight reference
        solve of the same trajectory sampled on the same grid."""
        _, mod, op_fn = _driven_setup()
        y0 = _ensemble_y0(B=2)
        save = np.linspace(0.04, 0.46, 1060)
        sol = self._solve(vexp.MagnusModulated4(mod), y0, save_at=save,
                          ctl=vo.StepControl(rtol=1e-6, min_dt=1e-6,
                                             max_dt=0.2, max_steps=4000))
        assert (np.asarray(sol.status) == vo.DONE).all()
        np.testing.assert_array_equal(np.asarray(sol.ts[0, 1:-1]), save)
        ref = self._solve(vexp.Magnus4(vexp.DenseCplxSplit(),
                                       batched=False), y0, op_fn,
                          save_at=save,
                          ctl=vo.StepControl(rtol=1e-10, min_dt=1e-6,
                                             max_dt=0.05, max_steps=8000))
        np.testing.assert_allclose(np.asarray(sol.ys.re),
                                   np.asarray(ref.ys.re), atol=2e-5)
        np.testing.assert_allclose(np.asarray(sol.ys.im),
                                   np.asarray(ref.ys.im), atol=2e-5)


def test_magnus_modulated6_fixed_step_order6():
    """Global error slope ~6 for fixed-step MagnusModulated6."""
    _, mod, op_fn = _driven_setup()
    psi0 = _psi0(8, seed=1)
    st = vexp.MagnusModulated6(mod, adaptive=False)

    ref = vo.solve_linear(None, 0.0, 1.0, psi0, stepper=st,
                          adaptive=False, h0=1.0 / 128,
                          ctl=vo.StepControl(max_steps=4000))
    errs = []
    hs = [1.0 / 4, 1.0 / 8, 1.0 / 16]
    for h in hs:
        s = vo.solve_linear(None, 0.0, 1.0, psi0, stepper=st,
                            adaptive=False, h0=h,
                            ctl=vo.StepControl(max_steps=4000))
        d = np.linalg.norm(
            np.asarray(s.y_final.re - ref.y_final.re)
            + 1j * np.asarray(s.y_final.im - ref.y_final.im)
        )
        errs.append(d)
    slopes = np.diff(np.log(errs)) / np.diff(np.log(hs))
    assert slopes.mean() > 5.4, (errs, slopes)


def test_magnus_modulated6_batched_step_matches_generic():
    """Batched Magnus-6 modulated step == generic Magnus-6 dense step."""
    _, mod, op_fn = _driven_setup()
    _batched_step_vs_generic(vexp.MagnusModulated6(mod),
                             vexp.Magnus6(vexp.DenseCplxSplit()), op_fn)


# ------------------------------------------------------------- Lindblad --
def test_lindblad_amplitude_damping_closed_form():
    """Open-system capability: single-qubit amplitude damping has the
    closed form rho_ee(t) = e^{-gt} rho_ee(0), rho_ge(t) = e^{-gt/2}
    rho_ge(0); the modulated superoperator solve must reproduce it."""
    from vec_ode_tpu.models.quantum import Lindblad

    g = 0.7
    L = np.array([[0.0, 1.0], [0.0, 0.0]], complex)   # |g><e|
    lb = Lindblad(H0=np.zeros((2, 2), complex),
                  Hc=np.zeros((2, 2), complex), jumps=((g, L),))
    mod = lb.modulated(lambda t: jnp.zeros_like(jnp.asarray(t)))

    rho0 = np.array([[0.4, 0.2 - 0.1j], [0.2 + 0.1j, 0.6]])
    v0 = Lindblad.vec_rho(rho0[None])
    T = 1.3
    sol = vo.solve_linear(None, 0.0, T, v0,
                          stepper=vexp.MagnusModulated4(mod), adaptive=True,
                          ctl=vo.StepControl(rtol=1e-10, atol=1e-12,
                                             min_dt=1e-8, max_dt=0.2))
    assert int(sol.status) == vo.DONE
    rho = Lindblad.unvec_rho(sol.y_final)[0]
    np.testing.assert_allclose(rho[1, 1], 0.6 * np.exp(-g * T), atol=1e-9)
    np.testing.assert_allclose(rho[0, 0], 1.0 - 0.6 * np.exp(-g * T),
                               atol=1e-9)
    np.testing.assert_allclose(rho[0, 1],
                               (0.2 - 0.1j) * np.exp(-g * T / 2),
                               atol=1e-9)
    np.testing.assert_allclose(np.trace(rho), 1.0, atol=1e-10)


def test_lindblad_driven_trace_preserving_and_matches_expm():
    """Driven dissipative qudit: trace stays 1 through the adaptive solve
    and the terminal state matches a fine-step dense-superoperator expm
    reference."""
    from vec_ode_tpu.models.quantum import Lindblad
    from vec_ode_tpu.ops.expm import expm as dense_expm

    d = 3
    lb = Lindblad.make(d=d, seed=9, gamma=0.25)
    u_fn = lambda t: 0.8 * jnp.sin(2.1 * jnp.asarray(t))
    mod = lb.modulated(u_fn)

    rho0 = np.zeros((d, d), complex)
    rho0[d - 1, d - 1] = 1.0                           # excited state
    v0 = Lindblad.vec_rho(rho0[None])
    T = 1.0
    sol = vo.solve_linear(None, 0.0, T, v0,
                          stepper=vexp.MagnusModulated4(mod), adaptive=True,
                          ctl=vo.StepControl(rtol=1e-9, atol=1e-11,
                                             min_dt=1e-8, max_dt=0.1))
    assert int(sol.status) == vo.DONE
    rho = Lindblad.unvec_rho(sol.y_final)[0]
    np.testing.assert_allclose(np.trace(rho).real, 1.0, atol=1e-8)
    np.testing.assert_allclose(np.trace(rho).imag, 0.0, atol=1e-10)
    # Hermiticity and positivity (physical state)
    np.testing.assert_allclose(rho, rho.conj().T, atol=1e-8)
    assert np.linalg.eigvalsh((rho + rho.conj().T) / 2).min() > -1e-8

    # fine-step piecewise-constant expm reference on the dense superop
    Sb = lb.superop_basis()
    S = np.asarray(Sb.re) + 1j * np.asarray(Sb.im)     # (2, d^2, d^2)
    n = 4000
    dt = T / n
    v = rho0.flatten(order="F")
    for i in range(n):
        tm = (i + 0.5) * dt
        A = S[0] + float(u_fn(tm)) * S[1]
        v = np.asarray(
            dense_expm(jnp.asarray(A * dt, jnp.complex128))) @ v
    rho_ref = v.reshape(d, d, order="F")
    np.testing.assert_allclose(rho, rho_ref, atol=5e-7)


def test_lindblad_control_gradient():
    """Dissipative optimal control: gradients through the Lindblad solve
    via the reversible adjoint (mild damping, short horizon — the
    documented reconstruction regime) match finite differences."""
    from vec_ode_tpu.diff import adjoint_solve
    from vec_ode_tpu.models.quantum import Lindblad

    d = 2
    lb = Lindblad.make(d=d, seed=3, gamma=0.15)
    basis = lb.superop_basis()

    def cfn(t, th):
        t = jnp.asarray(t)
        u = th[0] * jnp.sin(jnp.pi * t) + th[1] * jnp.sin(2 * jnp.pi * t)
        return jnp.stack([jnp.ones_like(u), u], axis=-1)

    rho0 = np.zeros((d, d), complex)
    rho0[1, 1] = 1.0
    v0 = Lindblad.vec_rho(rho0[None])
    theta = jnp.asarray([0.5, -0.3], jnp.float64)

    def loss(th):
        vf = adjoint_solve(basis, cfn, th, v0, 0.0, 1.0, 64)
        # population of the ground state at T (vec index 0 = rho[0,0])
        return vf.re[0, 0]

    v, g = jax.value_and_grad(loss)(theta)
    eps = 1e-6
    for i in range(2):
        e = jnp.zeros(2).at[i].set(eps)
        fd = (loss(theta + e) - loss(theta - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd),
                                   rtol=1e-6, atol=1e-10)


def test_lindblad_dissipative_control_optimization():
    """End-to-end dissipative optimal control: drive a decaying qubit
    (gamma = 0.4) into the excited state with Adam through the adjoint —
    excited population must rise from ~0.01 to >0.8 despite damping."""
    import optax

    from vec_ode_tpu.diff import adjoint_solve
    from vec_ode_tpu.models import Lindblad

    sz = np.diag([1.0, -1.0]).astype(complex)
    sx = np.array([[0, 1], [1, 0]], complex)
    L = np.array([[0, 1], [0, 0]], complex)         # |g><e| decay
    lb = Lindblad(H0=0.5 * sz, Hc=sx, jumps=((0.4, L),))
    basis = lb.superop_basis()

    def cfn(t, th):
        t = jnp.asarray(t)
        j = jnp.arange(1, 5, dtype=jnp.float64)
        u = jnp.sum(th * jnp.sin(j * jnp.pi * t[..., None] / 2.0), axis=-1)
        return jnp.stack([jnp.ones_like(u), u], axis=-1)

    rho0 = np.zeros((2, 2), complex)
    rho0[0, 0] = 1.0                                 # start in |g>
    v0 = Lindblad.vec_rho(rho0[None])
    theta = 0.1 * jnp.ones(4, jnp.float64)

    def loss(th):
        vf = adjoint_solve(basis, cfn, th, v0, 0.0, 2.0, 128)
        return 1.0 - vf.re[0, 3]                     # 1 - rho_ee

    vg = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(0.3)
    st = opt.init(theta)
    hist = []
    for _ in range(120):
        v, g = vg(theta)
        hist.append(float(v))
        up, st = opt.update(g, st)
        theta = optax.apply_updates(theta, up)
    assert hist[0] > 0.9
    assert min(hist) < 0.2, f"dissipative control stalled: {min(hist)}"


def test_many_interior_saves_match_generic():
    """20 interior save times on a batched f32 ensemble: the recorded ys
    match the generic dense-split stepper's grid-hitting saves (same step
    sequence; f32 rounding summed over the steps)."""
    _, mod, op_fn = _driven_setup(d=8, dtype=jnp.float32)
    y0 = _ensemble_y0(B=8, dtype=jnp.float32, seed=8)
    save_at = np.linspace(0.02, 0.28, 20, dtype=np.float32)
    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=500)

    def solve(stepper, fn=None):
        return ensemble_solve(
            fn, y0, 0.0, 0.3, stepper=stepper, adaptive=True, ctl=ctl,
            h0=1e-2, save_at=save_at, time_dtype=jnp.float32,
        )

    sol_b = solve(vexp.MagnusModulated4(mod))
    sol_g = solve(vexp.Magnus4(vexp.DenseCplxSplit(), batched=False), op_fn)
    assert (np.asarray(sol_b.status) == vo.DONE).all()
    assert sol_b.ys.re.shape == (8, 22, 8)
    np.testing.assert_allclose(np.asarray(sol_b.ys.re),
                               np.asarray(sol_g.ys.re), atol=2e-5)
    np.testing.assert_allclose(np.asarray(sol_b.ys.im),
                               np.asarray(sol_g.ys.im), atol=2e-5)


def test_magnus6_below_f32_error_floor_surfaces_max_steps():
    """The Magnus-6 6(4) embedded estimate has an
    f32 noise floor ~1e-7, so an rtol far below it rejects every step. The
    solve must terminate with ERR_MAX_STEPS and a FINITE state — never a
    silent livelock at min_dt (the reference's failure mode, ode.rs:324)."""
    from vec_ode_tpu.parallel import ensemble_solve

    _, mod, _ = _driven_setup(d=64, dtype=jnp.float32)
    B = 8
    rng = np.random.default_rng(11)
    psi = rng.standard_normal((B, 64)) + 1j * rng.standard_normal((B, 64))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float32)
    ctl = vo.StepControl(rtol=1e-12, min_dt=1e-6, max_dt=0.25, max_steps=64)

    for stepper in (vexp.MagnusModulated6(mod),):
        sol = ensemble_solve(None, y0, 0.0, 1.0, stepper=stepper,
                             adaptive=True, ctl=ctl, h0=1e-2,
                             time_dtype=jnp.float32)
        assert (np.asarray(sol.status) == vo.ERR_MAX_STEPS).all(), (
            stepper, np.asarray(sol.status))
        assert np.isfinite(np.asarray(sol.y_final.re)).all()
        assert np.isfinite(np.asarray(sol.y_final.im)).all()
        assert (np.asarray(sol.n_accept) == 0).all()
