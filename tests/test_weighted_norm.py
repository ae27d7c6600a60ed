"""Declared error norms (lc.WeightedNorm) executed natively on every tier.

The reference's ExpCFMSolver takes an arbitrary user NormFn
(/root/reference/src/exp/cfm.rs:131-155) that the driver applies to the
embedded error estimate. Here the same capability must not knock batched
steppers off their batched tier: a declared weighted l2/rms/max norm runs
inside the batched steps, with semantics pinned to the vmapped
custom-callable tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve

WeightedNorm = lc.WeightedNorm


# ---------------------------------------------------------------- unit --


def test_weighted_norm_reductions_match_numpy():
    rng = np.random.default_rng(0)
    e = {"a": jnp.asarray(rng.standard_normal((3, 5))),
         "b": jnp.asarray(rng.standard_normal((3, 2)))}
    flat = np.concatenate(
        [np.asarray(e["a"]).reshape(3, -1), np.asarray(e["b"])], axis=1)

    l2 = WeightedNorm("l2").batched(e)
    np.testing.assert_allclose(np.asarray(l2),
                               np.linalg.norm(flat, axis=1), rtol=1e-12)
    rms = WeightedNorm("rms").batched(e)
    np.testing.assert_allclose(np.asarray(rms),
                               np.linalg.norm(flat, axis=1) / np.sqrt(7),
                               rtol=1e-12)
    mx = WeightedNorm("max").batched(e)
    np.testing.assert_allclose(np.asarray(mx),
                               np.abs(flat).max(axis=1), rtol=1e-12)
    # per-trajectory callable form (drops into error_norm= slots)
    one = {"a": e["a"][0], "b": e["b"][0]}
    np.testing.assert_allclose(float(WeightedNorm("l2")(one)),
                               np.linalg.norm(flat[0]), rtol=1e-12)


def test_weighted_norm_weight_layouts():
    rng = np.random.default_rng(1)
    e = {"a": jnp.asarray(rng.standard_normal((4,))),
         "b": jnp.asarray(rng.standard_normal((4,)))}
    w_tree = {"a": np.arange(1.0, 5.0), "b": np.full(4, 0.5)}
    got = float(WeightedNorm("l2", weights=w_tree)(e))
    ref = np.sqrt((np.asarray(e["a"]) * w_tree["a"]) ** 2).sum()
    ref = np.sqrt(((np.asarray(e["a"]) * w_tree["a"]) ** 2).sum()
                  + ((np.asarray(e["b"]) * 0.5) ** 2).sum())
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    # one array broadcast to every leaf (the Cplx re/im sharing case)
    w = np.arange(1.0, 5.0)
    got_b = float(WeightedNorm("l2", weights=w)(e))
    ref_b = np.sqrt(((np.asarray(e["a"]) * w) ** 2).sum()
                    + ((np.asarray(e["b"]) * w) ** 2).sum())
    np.testing.assert_allclose(got_b, ref_b, rtol=1e-12)


def test_weighted_norm_kernel_parts():
    d = 4
    # no weights -> no row, rms carries the 1/sqrt(D) post factor
    row, post, kind = WeightedNorm("rms").kernel_parts(d, 2)
    assert row is None and kind == "l2"
    np.testing.assert_allclose(post, 1.0 / np.sqrt(8))
    # per-component weights tile across the re/im parts
    w = np.arange(1.0, 5.0)
    row, post, kind = WeightedNorm("max", weights=w).kernel_parts(d, 2)
    assert kind == "max" and post == 1.0 and row.shape == (1, 8)
    np.testing.assert_array_equal(row[0], np.concatenate([w, w]))
    # pytree / wrong-length weights cannot be laid out
    assert WeightedNorm("l2", weights={"a": w}).kernel_parts(d, 2) is None
    assert WeightedNorm("l2", weights=w[:2]).kernel_parts(d, 2) is None
    with pytest.raises(ValueError, match="l2|rms|max"):
        WeightedNorm("sup")


# --------------------------------------- reference NormFn semantics --


def _driven(d=8, dtype=jnp.float64):
    model = DrivenDense.make(d=d, seed=0)
    return model, model.modulated(dtype), lambda t: model.op_pair(t, dtype)


def _psi0(d, B=None, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    shape = (d,) if B is None else (B, d)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return cp.from_complex(z, dtype)


def test_declared_norm_matches_reference_normfn_semantics():
    """CFM4 with a declared WeightedNorm (modulated
    fast path) reproduces the generic dense-split CFM4 run with the SAME
    norm passed as a driver-applied error_norm callable — the reference's
    NormFn contract (cfm.rs:131-155) — step sequence and all (f64)."""
    _, mod, op_fn = _driven()
    psi0 = _psi0(8)
    w = np.linspace(0.25, 3.0, 8)
    wn = WeightedNorm("l2", weights=w)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)

    sol_m = vo.solve_linear(None, 0.0, 1.5, psi0,
                            stepper=vexp.CFM4Modulated(mod, norm=wn),
                            adaptive=True, ctl=ctl, h0=1e-2)
    sol_g = vo.solve_linear(op_fn, 0.0, 1.5, psi0,
                            stepper=vexp.CFM4(vexp.DenseCplxSplit()),
                            error_norm=wn, adaptive=True, ctl=ctl, h0=1e-2)
    assert int(sol_m.status) == vo.DONE and int(sol_g.status) == vo.DONE
    assert int(sol_m.n_accept) == int(sol_g.n_accept)
    assert int(sol_m.n_reject) == int(sol_g.n_reject)
    np.testing.assert_allclose(np.asarray(sol_m.y_final.re),
                               np.asarray(sol_g.y_final.re),
                               rtol=1e-9, atol=1e-9)
    # and the weights actually bite: the unweighted run steps differently
    sol_u = vo.solve_linear(None, 0.0, 1.5, psi0,
                            stepper=vexp.CFM4Modulated(mod),
                            adaptive=True, ctl=ctl, h0=1e-2)
    assert int(sol_u.n_accept) != int(sol_m.n_accept)


@pytest.mark.parametrize("kind", ["rms", "max"])
def test_declared_norm_kinds_match_normfn(kind):
    _, mod, op_fn = _driven()
    psi0 = _psi0(8, seed=3)
    wn = WeightedNorm(kind)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.3)
    sol_m = vo.solve_linear(None, 0.0, 1.0, psi0,
                            stepper=vexp.MagnusModulated4(mod, norm=wn),
                            adaptive=True, ctl=ctl, h0=1e-2)
    sol_g = vo.solve_linear(op_fn, 0.0, 1.0, psi0,
                            stepper=vexp.Magnus4(vexp.DenseCplxSplit()),
                            error_norm=wn, adaptive=True, ctl=ctl, h0=1e-2)
    assert int(sol_m.n_accept) == int(sol_g.n_accept)
    np.testing.assert_allclose(np.asarray(sol_m.y_final.re),
                               np.asarray(sol_g.y_final.re),
                               rtol=1e-8, atol=1e-8)


# ------------------------------------------------- batched ensembles --


def _batched_vs_generic(st_b, st_g, wn, y0, op_fn, t0, tf, ctl, dtype):
    kw = dict(adaptive=True, h0=1e-2, ctl=ctl, time_dtype=dtype)
    sol_b = ensemble_solve(None, y0, t0, tf, stepper=st_b, **kw)
    sol_g = ensemble_solve(op_fn, y0, t0, tf, stepper=st_g, error_norm=wn,
                           **kw)
    assert (np.asarray(sol_b.status) == vo.DONE).all()
    return sol_b, sol_g


def test_batched_weighted_norm_matches_generic():
    """CFM4 with a weighted norm on the batched driver matches the
    generic dense-split CFM4 solved per trajectory with the same norm as
    a driver-applied callable (f64): step sequences and states."""
    _, mod, op_fn = _driven()
    y0 = _psi0(8, B=6, seed=21)
    wn = WeightedNorm("l2", weights=np.linspace(0.5, 2.0, 8))
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-5, max_dt=0.2, max_steps=500)
    sol_b, sol_g = _batched_vs_generic(
        vexp.CFM4Modulated(mod, norm=wn),
        vexp.CFM4(vexp.DenseCplxSplit(), batched=False), wn, y0, op_fn,
        0.0, 0.5, ctl, jnp.float64)
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(sol_g.n_accept))
    np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                               np.asarray(sol_g.y_final.re), atol=1e-9)


def test_batched_max_norm_matches_generic():
    """max-kind declared norm on the batched Magnus-4 driver."""
    _, mod, op_fn = _driven()
    y0 = _psi0(8, B=6, seed=5)
    wn = WeightedNorm("max")
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-5, max_dt=0.2, max_steps=500)
    sol_b, sol_g = _batched_vs_generic(
        vexp.MagnusModulated4(mod, norm=wn),
        vexp.Magnus4(vexp.DenseCplxSplit(), batched=False), wn, y0, op_fn,
        0.0, 0.5, ctl, jnp.float64)
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(sol_g.n_accept))
    np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                               np.asarray(sol_g.y_final.re), atol=1e-9)


def _lz_ensemble(B):
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    return cp.from_complex(psi0, jnp.float32)


@pytest.mark.parametrize("wn", [
    WeightedNorm("l2", weights=np.asarray([2.0, 0.5], np.float32)),
    WeightedNorm("max"),
], ids=["l2-weighted", "max"])
def test_small_dim_declared_norm_matches_generic(wn):
    """d=2 Landau-Zener adaptive Magnus-4 over a 256-trajectory f32
    ensemble with a declared norm matches the generic stepper applying
    the same declaration (f32 rounding summed over the steps)."""
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(jnp.float32)
    ctl = vo.StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4,
                         max_dt=1.0)
    sol, oracle = _batched_vs_generic(
        vexp.MagnusModulated4(mod, norm=wn),
        vexp.Magnus4(vexp.DenseCplxSplit(), batched=False), wn,
        _lz_ensemble(256), lambda t: lz.op_pair(t, jnp.float32),
        -20.0, 20.0, ctl, jnp.float32)
    a_f, a_x = np.asarray(sol.n_accept), np.asarray(oracle.n_accept)
    assert (a_f == a_x).mean() > 0.8, (a_f, a_x)
    np.testing.assert_allclose(np.asarray(sol.y_final.re),
                               np.asarray(oracle.y_final.re),
                               rtol=2e-4, atol=2e-4)


# -------------------------------------------------- ensemble wiring --


def test_ensemble_installs_weighted_norm_into_batched_stepper():
    """ensemble_solve(error_norm=WeightedNorm) on a norm-declaring batched
    stepper installs the declaration (native execution on every tier)
    instead of raising the opaque-callable conflict."""
    _, mod, _ = _driven()
    y0 = _psi0(8, B=4, seed=7)
    w = np.linspace(0.25, 3.0, 8)
    wn = WeightedNorm("l2", weights=w)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)

    sol_e = ensemble_solve(
        mod, y0, 0.0, 1.0, stepper=vexp.CFM4Modulated(mod),
        error_norm=wn, adaptive=True, h0=1e-2, ctl=ctl,
    )
    sol_d = ensemble_solve(
        mod, y0, 0.0, 1.0, stepper=vexp.CFM4Modulated(mod, norm=wn),
        adaptive=True, h0=1e-2, ctl=ctl,
    )
    np.testing.assert_array_equal(np.asarray(sol_e.n_accept),
                                  np.asarray(sol_d.n_accept))
    np.testing.assert_array_equal(np.asarray(sol_e.y_final.re),
                                  np.asarray(sol_d.y_final.re))

    # conflicting double declaration raises
    wn2 = WeightedNorm("rms")
    with pytest.raises(ValueError, match="different norm"):
        ensemble_solve(
            mod, y0, 0.0, 1.0,
            stepper=vexp.CFM4Modulated(mod, norm=wn),
            error_norm=wn2, adaptive=True, h0=1e-2, ctl=ctl,
        )


def test_weighted_norm_conflicts_raise():
    _, mod, _ = _driven()
    y0 = _psi0(8, B=4, seed=9)
    wn = WeightedNorm("l2", weights=np.ones(8))
    # scaled_error and a declared norm both redefine the error measure
    with pytest.raises(ValueError, match="scaled_error"):
        ensemble_solve(
            mod, y0, 0.0, 1.0, stepper=vexp.CFM4Modulated(mod),
            error_norm=wn, adaptive=True, h0=1e-2,
            ctl=vo.StepControl(rtol=1e-6, atol=1e-10, scaled_error=True,
                               min_dt=1e-6, max_dt=0.3),
        )
    # pytree weights cannot be laid out for the batched tiers
    wn_tree = WeightedNorm("l2", weights={"re": np.ones(8),
                                          "im": np.ones(8)})
    with pytest.raises(ValueError, match="per-\\(complex-\\)component"):
        ensemble_solve(
            mod, y0, 0.0, 1.0,
            stepper=vexp.CFM4Modulated(mod, norm=wn_tree),
            adaptive=True, h0=1e-2,
            ctl=vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.3),
        )


def test_rk_stepper_weighted_norm():
    """FusedModulatedLinearRK executes a declared WeightedNorm inside its
    batched step: the solve matches the generic RungeKutta stepper per
    trajectory with the same norm applied by the driver (f64), and the
    weights change the step sequence."""
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=8, seed=0)
    y0 = _psi0(8, B=6, seed=51)
    wn = WeightedNorm("l2", weights=np.linspace(0.5, 4.0, 8))
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float64,
                                                  norm=wn)
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.25,
                         max_steps=500)
    kw = dict(adaptive=True, h0=1e-2, ctl=ctl, time_dtype=jnp.float64)
    sol_b = ensemble_solve(None, y0, 0.0, 0.6, stepper=st, **kw)
    sol_g = ensemble_solve(
        lambda t, y: model.rhs_pair(t, y, jnp.float64), y0, 0.0, 0.6,
        stepper=vo.RungeKutta(vo.RKF45), error_norm=wn, **kw)
    assert (np.asarray(sol_b.status) == vo.DONE).all()
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(sol_g.n_accept))
    np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                               np.asarray(sol_g.y_final.re), atol=1e-10)
    sol_u = ensemble_solve(
        None, y0, 0.0, 0.6,
        stepper=FusedModulatedLinearRK.from_driven_dense(model,
                                                         jnp.float64),
        **kw)
    assert (np.asarray(sol_u.n_accept) != np.asarray(sol_b.n_accept)).any()


def test_generic_batched_tier_weighted_norm():
    """The generic dense steppers (the reference's actual operator
    contract) keep their natively-BATCHED tier with a declared norm:
    ensemble_solve(error_norm=WeightedNorm) installs it and the stacked-
    expm executor applies it — matching the vmapped NormFn path exactly
    (f64)."""
    model = DrivenDense.make(d=8, seed=0)
    op_fn = lambda t: model.op_pair(t, jnp.float64)
    y0 = _psi0(8, B=8, seed=11)
    w = np.linspace(0.25, 3.0, 8)
    wn = WeightedNorm("l2", weights=w)
    ctl = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)

    for make in (lambda: vexp.Magnus4(vexp.DenseCplxSplit()),
                 lambda: vexp.Magnus4(vexp.DenseCplxSplit(),
                                      fast_error=True),
                 lambda: vexp.CFM4(vexp.DenseCplxSplit()),
                 lambda: vexp.Magnus6(vexp.DenseCplxSplit())):
        sol_b = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=make(),
                               error_norm=wn, adaptive=True, h0=1e-2,
                               ctl=ctl)
        # vmapped oracle: batched=False forces the scalar path where the
        # DRIVER applies the same callable (reference NormFn contract)
        st_v = dataclasses_replace_batched(make())
        sol_v = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st_v,
                               error_norm=wn, adaptive=True, h0=1e-2,
                               ctl=ctl)
        np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                      np.asarray(sol_v.n_accept))
        np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                                   np.asarray(sol_v.y_final.re),
                                   rtol=1e-10, atol=1e-10)


def dataclasses_replace_batched(st):
    import dataclasses as _dc

    return _dc.replace(st, batched=False)
