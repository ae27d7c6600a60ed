"""Hamiltonian learning: gradients w.r.t. the OPERATOR BASIS itself.

Recovers an unknown coupling matrix V from state observations of a driven
system H(t) = H0 + cos(w t) V, by gradient descent THROUGH the solver on
the basis matrices (``diff.adjoint_solve(..., basis_grad=True)`` — the
reversible adjoint's r3 extension). Also demonstrates
``exp.auto_modulated``: the "experiment" is only available as a black-box
op_fn, and the modulated structure is recovered automatically to generate
the training data on the fast path. Runs on CPU in ~60 s:

    python examples/hamiltonian_learning.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import optax

from vec_ode_tpu import diff
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp


def main():
    d, B, n_steps, T = 8, 32, 64, 2.0
    truth = DrivenDense.make(d=d, seed=0, w=1.3)

    # ------ generate observations from the BLACK-BOX experiment ---------
    # (auto_modulated recovers the K=2 structure from op_fn samples alone)
    op_fn = lambda t: truth.op_pair(t, jnp.float64)
    mod = vexp.auto_modulated(op_fn, 0.0, T)
    assert mod is not None and mod.n_terms == 2
    rng = np.random.default_rng(1)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cp.from_complex(psi, jnp.float64)

    theta = jnp.zeros(0)  # no pulse parameters: coefficients are fixed

    def coeff(t, th):
        del th
        return jnp.stack([jnp.ones_like(t),
                          jnp.cos(truth.w * jnp.asarray(t))])

    H0p, Vp = truth.pair_parts(jnp.float64)
    basis_true = cp.Cplx(
        jnp.stack([H0p.im, Vp.im]), jnp.stack([-H0p.re, -Vp.re]))
    y_obs = diff.adjoint_solve(
        basis_true, coeff, theta, y0, 0.0, T, n_steps, order=4)

    # ------ learn V (basis element 1) from the observations -------------
    def model_basis(V_re, V_im):
        return cp.Cplx(
            jnp.stack([basis_true.re[0], V_im]),      # -iH: re = im(H)
            jnp.stack([basis_true.im[0], -V_re]),     #      im = -re(H)
        )

    def loss(params):
        V_re, V_im = params
        yf = diff.adjoint_solve(
            model_basis(V_re, V_im), coeff, theta, y0, 0.0, T, n_steps,
            order=4, basis_grad=True)
        return jnp.sum((yf.re - y_obs.re) ** 2 + (yf.im - y_obs.im) ** 2)

    params = (jnp.zeros((d, d)), jnp.zeros((d, d)))
    vg = jax.jit(jax.value_and_grad(loss))
    opt = optax.adam(0.05)
    st = opt.init(params)
    for i in range(300):
        v, g = vg(params)
        up, st = opt.update(g, st)
        params = optax.apply_updates(params, up)
        if i % 50 == 0:
            print(f"iter {i:4d}  loss {float(v):.3e}")

    V_err = max(
        float(jnp.max(jnp.abs(params[0] - jnp.asarray(truth.V.real)))),
        float(jnp.max(jnp.abs(params[1] - jnp.asarray(truth.V.imag)))),
    )
    print(f"final loss {float(vg(params)[0]):.3e}, "
          f"max |V_learned - V_true| = {V_err:.3e}")
    assert V_err < 5e-2, "Hamiltonian learning failed to recover V"


if __name__ == "__main__":
    main()
