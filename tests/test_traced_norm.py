"""Trace, don't declare: opaque-but-traceable error_norm callables keep
the batched tier.

The reference's NormFn is an arbitrary closure
(/root/reference/src/exp/cfm.rs:131-155). A declared lc.WeightedNorm runs
natively on every tier (test_weighted_norm.py); these tests pin the rest
of the traceable space: a hand-written jnp norm passed as error_norm=
is probed with jax.eval_shape and, when it traces to a scalar, promoted
to lc.TracedNorm — norm-returning batched steppers apply it to the
batched error vector, vector-returning steppers get it vmapped into the
driver's reducer. Genuinely untraceable callables keep the legacy
drop-to-vmapped/raise behavior.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve

W = np.linspace(0.25, 3.0, 8)


def _my_norm(err):
    """A hand-written jnp norm: weighted l2 over the Cplx pair — pure
    traceable code, but NOT an lc.WeightedNorm declaration."""
    w = jnp.asarray(W, err.re.dtype)
    return jnp.sqrt(jnp.sum((w * err.re) ** 2) + jnp.sum((w * err.im) ** 2))


def _untraceable_norm(err):
    # float() forces concretization -> eval_shape (and tracing) fails
    return float(np.asarray(err.re).max())


def _psi0(d, B=None, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    shape = (d,) if B is None else (B, d)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return cp.from_complex(z, dtype)


def _driven(d=8, dtype=jnp.float64):
    model = DrivenDense.make(d=d, seed=0)
    return model, model.modulated(dtype), lambda t: model.op_pair(t, dtype)


CTL = vo.StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.3)


# ------------------------------------------------------------- unit --


def test_try_trace_norm_probe():
    probe = cp.Cplx(jax.ShapeDtypeStruct((8,), jnp.float64),
                    jax.ShapeDtypeStruct((8,), jnp.float64))
    tn = lc.try_trace_norm(_my_norm, probe)
    assert isinstance(tn, lc.TracedNorm)
    # vector-returning callables are not norms
    assert lc.try_trace_norm(lambda e: e.re, probe) is None
    # untraceable callables are rejected, not raised
    assert lc.try_trace_norm(_untraceable_norm, probe) is None


def test_traced_norm_batched_executor_matches_direct():
    y = _psi0(8, B=5, seed=3)
    tn = lc.TracedNorm(_my_norm)
    got = np.asarray(tn.batched(y))
    want = [float(_my_norm(cp.Cplx(y.re[i], y.im[i]))) for i in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_apply_weighted_norm_callable_hook():
    dv = jnp.asarray(np.random.default_rng(0).standard_normal((4, 6)))
    got = lc.apply_weighted_norm(dv, lambda d: jnp.max(jnp.abs(d), axis=-1))
    np.testing.assert_allclose(np.asarray(got),
                               np.abs(np.asarray(dv)).max(axis=1))


# ------------------------------------- generic dense batched steppers --


@pytest.mark.parametrize("make", [
    lambda: vexp.Magnus4(vexp.DenseCplxSplit(), batched=True),
    lambda: vexp.Magnus4(vexp.DenseCplxSplit(), batched=True,
                         fast_error=True),
    lambda: vexp.CFM4(vexp.DenseCplxSplit(), batched=True),
    lambda: vexp.Magnus6(vexp.DenseCplxSplit(), batched=True),
])
def test_traced_norm_keeps_batched_tier(make):
    """EXPLICIT batched=True + an opaque jnp callable used to raise the
    opaque-callable conflict; now it traces onto the batched tier and
    matches the vmapped path (driver-applied callable, the reference
    NormFn contract) exactly — step sequence and all (f64)."""
    _, _, op_fn = _driven()
    y0 = _psi0(8, B=8, seed=11)

    sol_b = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=make(),
                           error_norm=_my_norm, adaptive=True, h0=1e-2,
                           ctl=CTL)
    st_v = dataclasses.replace(make(), batched=False)
    sol_v = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st_v,
                           error_norm=_my_norm, adaptive=True, h0=1e-2,
                           ctl=CTL)
    np.testing.assert_array_equal(np.asarray(sol_b.n_accept),
                                  np.asarray(sol_v.n_accept))
    np.testing.assert_array_equal(np.asarray(sol_b.n_reject),
                                  np.asarray(sol_v.n_reject))
    np.testing.assert_allclose(np.asarray(sol_b.y_final.re),
                               np.asarray(sol_v.y_final.re),
                               rtol=1e-10, atol=1e-10)


def test_traced_norm_matches_weighted_norm_semantics():
    """_my_norm IS WeightedNorm("l2", W) written by hand: the traced path
    must reproduce the declared path bit-for-bit on the same executor."""
    _, _, op_fn = _driven()
    y0 = _psi0(8, B=8, seed=2)
    st = vexp.Magnus4(vexp.DenseCplxSplit())
    sol_t = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st,
                           error_norm=_my_norm, adaptive=True, h0=1e-2,
                           ctl=CTL)
    sol_d = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st,
                           error_norm=lc.WeightedNorm("l2", weights=W),
                           adaptive=True, h0=1e-2, ctl=CTL)
    np.testing.assert_array_equal(np.asarray(sol_t.n_accept),
                                  np.asarray(sol_d.n_accept))
    np.testing.assert_allclose(np.asarray(sol_t.y_final.re),
                               np.asarray(sol_d.y_final.re),
                               rtol=1e-12, atol=1e-12)
    # and the norm actually bites: unweighted solve steps differently
    sol_u = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st,
                           adaptive=True, h0=1e-2, ctl=CTL)
    assert (np.asarray(sol_t.n_accept) != np.asarray(sol_u.n_accept)).any()


def test_traced_norm_compensated_tier():
    """The traced norm composes with the compensated double-f32 tier
    (difference-of-increments error vector, same widened layout)."""
    _, _, op_fn = _driven()
    y0 = _psi0(8, B=4, seed=5)
    st = vexp.Magnus4(vexp.DenseCplxSplit(), compensated=True,
                      batched=True)
    sol = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st,
                         error_norm=_my_norm, adaptive=True, h0=1e-2,
                         ctl=CTL)
    assert (np.asarray(sol.status) == vo.DONE).all()
    st_v = vexp.Magnus4(vexp.DenseCplxSplit(), compensated=True,
                        batched=False)
    sol_v = ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st_v,
                           error_norm=_my_norm, adaptive=True, h0=1e-2,
                           ctl=CTL)
    np.testing.assert_array_equal(np.asarray(sol.n_accept),
                                  np.asarray(sol_v.n_accept))


# ---------------------------------------------- modulated steppers --


def test_traced_norm_modulated_stepper():
    """Modulated Magnus-4 (always batched) with an opaque jnp norm: the
    TracedNorm lands in the stepper's norm slot and the XLA step applies
    it — matching the generic stepper's vmapped NormFn path."""
    _, mod, op_fn = _driven()
    y0 = _psi0(8, B=4, seed=7)
    sol_m = ensemble_solve(
        mod, y0, 0.0, 1.0,
        stepper=vexp.MagnusModulated4(mod),
        error_norm=_my_norm, adaptive=True, h0=1e-2, ctl=CTL,
    )
    sol_g = ensemble_solve(
        op_fn, y0, 0.0, 1.0,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), batched=False),
        error_norm=_my_norm, adaptive=True, h0=1e-2, ctl=CTL,
    )
    np.testing.assert_array_equal(np.asarray(sol_m.n_accept),
                                  np.asarray(sol_g.n_accept))
    np.testing.assert_allclose(np.asarray(sol_m.y_final.re),
                               np.asarray(sol_g.y_final.re),
                               rtol=1e-8, atol=1e-8)


def test_traced_plain_l2_matches_default_norm():
    """A hand-written plain l2 norm, traced into the batched modulated
    stepper, reproduces the stepper's built-in l2 norm: same step
    sequences, same states (f32)."""
    model = DrivenDense.make(d=8, seed=0)
    mod = model.modulated(jnp.float32)
    y0 = _psi0(8, B=8, seed=13, dtype=jnp.float32)

    def norm_l2(err):
        return jnp.sqrt(jnp.sum(err.re ** 2) + jnp.sum(err.im ** 2)
                        + 0.0)  # plain l2, hand-written

    ctl = vo.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=500)
    kw = dict(adaptive=True, h0=1e-2, ctl=ctl, time_dtype=jnp.float32)
    sol_t = ensemble_solve(mod, y0, 0.0, 0.5,
                           stepper=vexp.MagnusModulated4(mod),
                           error_norm=norm_l2, **kw)
    sol_d = ensemble_solve(mod, y0, 0.0, 0.5,
                           stepper=vexp.MagnusModulated4(mod), **kw)
    np.testing.assert_array_equal(np.asarray(sol_t.n_accept),
                                  np.asarray(sol_d.n_accept))
    np.testing.assert_allclose(np.asarray(sol_t.y_final.re),
                               np.asarray(sol_d.y_final.re),
                               rtol=1e-6, atol=1e-6)


def test_fused_rk_stepper_rejects_traced_norm():
    """FusedModulatedLinearRK executes only DECLARED norms (its step
    lays the weights out over the widened batch): an opaque callable is
    installed as a TracedNorm and refused with a named error."""
    from vec_ode_tpu.ops.modulated_rk import FusedModulatedLinearRK

    model = DrivenDense.make(d=8, seed=0)
    st = FusedModulatedLinearRK.from_driven_dense(model, jnp.float64)
    y0 = _psi0(8, B=4, seed=21)
    with pytest.raises(TypeError, match="DECLARED"):
        ensemble_solve(
            None, y0, 0.0, 0.5, stepper=st, adaptive=True, h0=1e-2,
            error_norm=lambda e: jnp.sqrt(jnp.sum(e.re ** 2)
                                          + jnp.sum(e.im ** 2)),
            ctl=vo.StepControl(rtol=1e-4, max_dt=0.2))


# ----------------------------------------------- untraceable fallback --


def test_untraceable_callable_keeps_legacy_paths():
    _, _, op_fn = _driven()
    y0 = _psi0(8, B=4, seed=17)
    # auto-batched stepper: quietly drops to the vmapped tier... but the
    # callable concretizes traced values, so it cannot run under the jitted
    # driver either — the real pin is the EXPLICIT batched=True error below
    st = vexp.Magnus4(vexp.DenseCplxSplit(), batched=True)
    with pytest.raises(ValueError, match="OPAQUE"):
        ensemble_solve(op_fn, y0, 0.0, 1.0, stepper=st,
                       error_norm=_untraceable_norm, adaptive=True,
                       h0=1e-2, ctl=CTL)


def test_scaled_error_skips_tracing():
    """scaled_error redefines the error measure: traced norms do not
    engage; the auto-batched stepper keeps its legacy vmapped drop."""
    _, _, op_fn = _driven()
    y0 = _psi0(8, B=4, seed=19)
    st = vexp.Magnus4(vexp.DenseCplxSplit(), batched=True)
    with pytest.raises(ValueError, match="OPAQUE|scaled_error"):
        ensemble_solve(
            op_fn, y0, 0.0, 1.0, stepper=st, error_norm=_my_norm,
            adaptive=True, h0=1e-2,
            ctl=vo.StepControl(rtol=1e-6, atol=1e-10, scaled_error=True,
                               min_dt=1e-6, max_dt=0.3),
        )
