"""Real-pair complex arithmetic.

The framework carries complex states/operators as pairs of real arrays and
implements the complex algebra in real arithmetic, so every contraction is
a real GEMM and no backend needs complex dtypes. This is the answer to the
reference's generic scalar type S
(complex scalars via ``num_complex``, lib.rs:48-50): a :class:`Cplx` NamedTuple
is a transparent pytree, so the driver, controller, vmap/shard_map and the
``lc`` vector-space layer all work on it unchanged — ``lc.norm_l2`` over the
(re, im) leaves IS the complex L2 norm.

Matrix algebra uses the ring embedding  z = x + iy  <->  [[x, -y], [y, x]]:
  * ``cmatvec`` fuses the 4 real matvecs into ONE (..., 2d) @ (2d, 2d) real
    matmul (for d=64, a 128-wide real contraction).
  * ``cexpm`` embeds to a real (2d, 2d) matrix, runs the real Padé-13
    scaling-and-squaring, and extracts the blocks; exact because the
    embedding is a ring homomorphism. Diagonal Padé is unitary on
    anti-Hermitian input, so Schrödinger propagation stays norm-conserving
    to roundoff without an eigendecomposition.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.prec import HIGHEST, mm
from .expm import expm


def _as_complex_scalar(o):
    """(re, im) floats if o is a complex-KIND scalar (python complex or any
    np.complexfloating, incl. complex64), else None."""
    import numpy as np

    if isinstance(o, (complex, np.complexfloating)):
        zc = complex(o)
        return zc.real, zc.imag
    return None


class Cplx(NamedTuple):
    """Complex array as a (re, im) pair of real arrays. A pytree."""

    re: jax.Array
    im: jax.Array

    # numpy must NOT treat a Cplx as an array-like (a tuple!): a numpy
    # scalar on the LEFT of * would otherwise consume it into a stacked
    # ndarray instead of deferring to __rmul__
    __array_ufunc__ = None

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    # -- arithmetic (elementwise) ------------------------------------------
    def __add__(self, o):
        if isinstance(o, Cplx):
            return Cplx(self.re + o.re, self.im + o.im)
        z = _as_complex_scalar(o)
        if z is not None:
            return Cplx(self.re + z[0], self.im + z[1])
        return Cplx(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, Cplx):
            return Cplx(self.re - o.re, self.im - o.im)
        z = _as_complex_scalar(o)
        if z is not None:
            return Cplx(self.re - z[0], self.im - z[1])
        return Cplx(self.re - o, self.im)

    def __rsub__(self, o):
        return (-self).__add__(o)

    def __neg__(self):
        return Cplx(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Cplx):
            return Cplx(
                self.re * o.re - self.im * o.im,
                self.re * o.im + self.im * o.re,
            )
        z = _as_complex_scalar(o)
        if z is not None:
            return cscale(self, complex(z[0], z[1]))
        return Cplx(self.re * o, self.im * o)

    __rmul__ = __mul__
    __radd__ = __add__


def cplx(re, im=None) -> Cplx:
    re = jnp.asarray(re)
    if im is None:
        im = jnp.zeros_like(re)
    return Cplx(re, jnp.asarray(im))


def from_complex(z, dtype=None) -> Cplx:
    """Split a complex (numpy/jax) array into a real pair."""
    import numpy as np

    z = np.asarray(z) if not isinstance(z, jax.Array) else z
    re = jnp.asarray(z.real, dtype)
    im = jnp.asarray(z.imag, dtype)
    return Cplx(re, im)


def to_complex(c: Cplx):
    """Reassemble a complex array (host-side inspection and tests)."""
    w = jnp.complex64 if c.re.dtype == jnp.float32 else jnp.complex128
    return c.re.astype(w) + 1j * c.im.astype(w)


def cconj(c: Cplx) -> Cplx:
    return Cplx(c.re, -c.im)


def cabs2(c: Cplx) -> jax.Array:
    return c.re * c.re + c.im * c.im


def cscale(c: Cplx, z) -> Cplx:
    """Multiply by a python/np complex scalar (trace-time constant)."""
    zr, zi = float(z.real), float(z.imag)
    if zi == 0.0:
        return Cplx(c.re * zr, c.im * zr)
    return Cplx(c.re * zr - c.im * zi, c.re * zi + c.im * zr)


def embed(A: Cplx) -> jax.Array:
    """Ring embedding (..., d, d) Cplx -> (..., 2d, 2d) real:
    [[Ar, -Ai], [Ai, Ar]]."""
    top = jnp.concatenate([A.re, -A.im], axis=-1)
    bot = jnp.concatenate([A.im, A.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def extract(M: jax.Array) -> Cplx:
    """Inverse of :func:`embed` (reads the first block column)."""
    d = M.shape[-1] // 2
    return Cplx(M[..., :d, :d], M[..., d:, :d])


def apply_embedded(M: jax.Array, x: Cplx) -> Cplx:
    """Apply an EMBEDDED real (..., 2d, 2d) matrix to a Cplx vector with one
    widened real matvec (the single implementation shared by the complex
    split leaves and any embedded-propagator code)."""
    xw = jnp.concatenate([x.re, x.im], axis=-1)
    yw = jnp.einsum("...ij,...j->...i", M, xw, precision=HIGHEST)
    d = x.re.shape[-1]
    return Cplx(yw[..., :d], yw[..., d:])


def cmatmul(A: Cplx, B: Cplx) -> Cplx:
    """Complex matmul via 3 real matmuls (Karatsuba/Gauss trick)."""
    t1 = mm(A.re, B.re)
    t2 = mm(A.im, B.im)
    t3 = mm(A.re + A.im, B.re + B.im)
    return Cplx(t1 - t2, t3 - t1 - t2)


def cmatvec(A: Cplx, x: Cplx) -> Cplx:
    """(..., d, d) Cplx @ (..., d) Cplx -> (..., d) Cplx.

    Fused: one real matmul of (..., 2d) against the (2d, 2d) embedding,
    so a d=64 complex matvec is a single 128-wide real contraction.
    """
    xw = jnp.concatenate([x.re, x.im], axis=-1)          # (..., 2d)
    # y = M @ [xr; xi] with M = [[Ar, -Ai], [Ai, Ar]] => contract on last dim
    M = embed(A)                                          # (..., 2d, 2d)
    yw = jnp.einsum("...ij,...j->...i", M, xw, precision=HIGHEST)
    d = x.re.shape[-1]
    return Cplx(yw[..., :d], yw[..., d:])


def cexp(c: Cplx) -> Cplx:
    """Elementwise complex exp: e^{re} (cos im, sin im)."""
    m = jnp.exp(c.re)
    return Cplx(m * jnp.cos(c.im), m * jnp.sin(c.im))


def cexpm1(c: Cplx) -> Cplx:
    """Elementwise complex expm1: e^z - 1 with RELATIVE accuracy for small
    |z| (no catastrophic 1-subtraction):
        re = expm1(a) cos b - 2 sin^2(b/2),  im = e^a sin b."""
    half = jnp.sin(0.5 * c.im)
    return Cplx(
        jnp.expm1(c.re) * jnp.cos(c.im) - 2.0 * half * half,
        jnp.exp(c.re) * jnp.sin(c.im),
    )


def cscale_any(c: Cplx, z) -> Cplx:
    """Scale by: python/np scalar (real or complex), traced real scalar, or a
    scalar Cplx. The one entry point operator code should use."""
    import numpy as np

    if isinstance(z, Cplx):
        return c * z
    if isinstance(z, (complex,)) or (
        isinstance(z, np.generic) and np.iscomplexobj(z)
    ):
        return cscale(c, complex(z))
    # real python scalar or traced real array scalar
    if isinstance(z, (int, float)) or (
        isinstance(z, np.generic) and not np.iscomplexobj(z)
    ):
        z = float(z)
        return Cplx(c.re * z, c.im * z)
    zt = jnp.asarray(z)
    if jnp.issubdtype(zt.dtype, jnp.complexfloating):
        # complex ARRAY scalar (traced jax complex or 0-d ndarray): a
        # real cast would silently drop the imaginary part
        return c * Cplx(jnp.real(zt).astype(c.re.dtype),
                        jnp.imag(zt).astype(c.re.dtype))
    zt = zt.astype(c.re.dtype)
    return Cplx(c.re * zt, c.im * zt)


def cexpm(A: Cplx, *, max_squarings: int = 16) -> Cplx:
    """Complex matrix exponential via the real ring embedding."""
    return extract(expm(embed(A), max_squarings=max_squarings))
