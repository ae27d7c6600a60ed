"""Matmul precision policy.

At DEFAULT precision an f32 matmul may run with reduced-precision
multiplications (TF32 on a GPU's tensor cores, ~1e-3 relative error). That
noise floor poisons embedded error estimates — the controller sees
O(1e-3 * |K|) phantom error and rejects its way down to tiny steps. Every
matmul on the framework's numerical path therefore pins
``Precision.HIGHEST`` (full f32 products) unless the caller overrides.

User RHS functions should do the same for adaptive runs: use
``vec_ode_tpu.utils.prec.mm`` / pass ``precision=HIGHEST`` to einsum.
"""

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

# matmul with full-precision accumulation
mm = partial(jnp.matmul, precision=HIGHEST)


def einsum(*args, **kw):
    kw.setdefault("precision", HIGHEST)
    return jnp.einsum(*args, **kw)
