"""Chain-exponential action for modulated operators, in plain XLA.

Computes, for each trajectory b and chain c:

    y[b, c] = e^{A(rows[b,c,R-1])} ... e^{A(rows[b,c,1])} e^{A(rows[b,c,0])} x[b]
    A(row)  = sum_k row[k] * basis[k]

with each exponential a scaled Taylor series (m terms per pass, ``n_pass``
uniform passes). Semantics (C chains, R sequential exponentials per chain):

  * Magnus-4 adaptive: C=2 (order-4 Omega and order-2 Omega1 both acting on
    x), R=1; the error is ||chain1 - chain0|| per trajectory.
  * CFM: C=2 (main chain, embedded error chain), R=s rows; the shorter error
    chain is padded with ZERO rows (e^0 = I exactly, any pass count).
  * fixed-step/midpoint: C=1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.prec import HIGHEST


def row_matmul(x, M):
    """(..., D) x (D, D) -> rows y_i = M @ x_i (i.e. x @ M^T), full f32
    accumulation."""
    return jax.lax.dot_general(
        x, M,
        dimension_numbers=(((x.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=x.dtype,
        precision=HIGHEST,
    )


def chain_expmv_xla(cs, n_pass, xw, basis, *, m: int = 12, wnorm=None):
    """Chain action over a batch (or a scalar state). cs: (..., C, R, K)
    PRE-scaled rows; xw: (..., D); n_pass: the uniform pass count; returns
    (y0, err_norm or None). ``wnorm``: declared error norm
    (``lc.apply_weighted_norm``)."""
    C, R, K = cs.shape[-3:]
    batch = jnp.broadcast_shapes(cs.shape[:-3], xw.shape[:-1])
    vs = jnp.broadcast_to(xw[..., None, :], batch + (C, xw.shape[-1]))
    cs = jnp.broadcast_to(cs.astype(xw.dtype), batch + cs.shape[-3:])

    def apply_round(vs, csr):
        # csr: (..., C, K) — all C lanes advance one exponential together
        def taylor_pass(v):
            acc = v
            term = v
            for kk in range(1, m + 1):
                t1 = jnp.einsum("kij,...cj->...cki", basis, term,
                                precision=HIGHEST)
                term = jnp.einsum("...ck,...cki->...ci", csr, t1,
                                  precision=HIGHEST) / kk
                acc = acc + term
            return acc

        def body(carry):
            i, v = carry
            return i + 1, taylor_pass(v)

        _, out = jax.lax.while_loop(
            lambda c: c[0] < n_pass, body,
            (jnp.zeros((), jnp.int32), vs),
        )
        return out

    for r in range(R):
        vs = apply_round(vs, cs[..., :, r, :])
    y0 = vs[..., 0, :]
    if C < 2:
        return y0, None
    d = vs[..., 1, :] - y0
    from ..lc import apply_weighted_norm

    return y0, apply_weighted_norm(d, wnorm)

