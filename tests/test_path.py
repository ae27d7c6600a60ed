"""Execution-path diagnostics: Solution.path names the driver that ran."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import ensemble_solve


def _y0(B=8, d=4, seed=0):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return cp.from_complex(psi, jnp.float64)


def test_default_path_is_xla_driver():
    sol = vo.solve_ivp(lambda t, y: -y, 0.0, 1.0, jnp.ones(3))
    assert sol.path == "xla-driver"


def test_path_survives_pytree_roundtrip_and_vmap():
    sol = vo.solve_ivp(lambda t, y: -y, 0.0, 1.0, jnp.ones(3))
    leaves, treedef = jax.tree_util.tree_flatten(sol)
    sol2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert sol2.path == sol.path


def test_modulated_batched_path_tag():
    # natively batched modulated stepper: the XLA driver over the batch
    model = DrivenDense.make(d=4, seed=0)
    mod = model.modulated(jnp.float64)
    stepper = vexp.MagnusModulated4(mod)
    sol = ensemble_solve(
        None, _y0(), 0.0, 0.2, stepper=stepper, adaptive=True,
        ctl=vo.StepControl(rtol=1e-6, max_dt=0.1), h0=1e-2,
        time_dtype=jnp.float64,
    )
    assert sol.path == "xla-driver"
    assert bool(jnp.all(sol.success))


def test_dense_output_path_tag():
    # free-running dense output on a batched stepper -> "-dense" suffix
    model = DrivenDense.make(d=4, seed=0)
    stepper = vexp.MagnusModulated4(model.modulated(jnp.float64))
    sol = ensemble_solve(
        None, _y0(), 0.0, 0.2, stepper=stepper, adaptive=True,
        ctl=vo.StepControl(rtol=1e-6, max_dt=0.1), h0=1e-2,
        save_at=np.linspace(0.05, 0.15, 3), dense=True,
        time_dtype=jnp.float64,
    )
    assert sol.path == "xla-driver-dense"
    assert bool(jnp.all(sol.success))


def test_generic_batched_path_tag():
    # the generic dense-split stepper's batched executor: same driver tag
    model = DrivenDense.make(d=4, seed=0)
    sol = ensemble_solve(
        lambda t: model.op_pair(t, jnp.float64), _y0(), 0.0, 0.2,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()), adaptive=True,
        ctl=vo.StepControl(rtol=1e-6, max_dt=0.1), h0=1e-2,
        time_dtype=jnp.float64,
    )
    assert sol.path == "xla-driver"
    assert bool(jnp.all(sol.success))


def test_batched_solve_emits_no_warnings():
    model = DrivenDense.make(d=4, seed=0)
    stepper = vexp.MagnusModulated4(model.modulated(jnp.float64))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ensemble_solve(
            None, _y0(), 0.0, 0.1, stepper=stepper, adaptive=True,
            ctl=vo.StepControl(rtol=1e-4, max_dt=0.05), h0=1e-2,
            save_at=np.linspace(0.01, 0.09, 40), time_dtype=jnp.float64,
        )
    assert not [w for w in rec if "vec_ode_tpu" in str(w.message)]


def test_traceable_and_untraceable_events():
    # a TRACEABLE opaque event callable runs on the batched driver; an
    # UNtraceable one (concretizes a tracer) raises at trace time
    model = DrivenDense.make(d=4, seed=0)
    stepper = vexp.MagnusModulated4(model.modulated(jnp.float64))
    kw = dict(stepper=stepper, adaptive=True,
              ctl=vo.StepControl(rtol=1e-4, max_dt=0.05), h0=1e-2,
              time_dtype=jnp.float64)
    sol = ensemble_solve(
        None, _y0(), 0.0, 0.1,
        events=vo.Event(lambda t, y: jnp.sum(y.re ** 2) - 2.0), **kw)
    assert sol.path == "xla-driver"
    assert bool(jnp.all(sol.success))
    with pytest.raises(Exception):
        ensemble_solve(
            None, _y0(), 0.0, 0.1,
            events=vo.Event(lambda t, y: float(np.asarray(y.re).max())),
            **kw)
