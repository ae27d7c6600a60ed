"""Real-pair complex layer: golden parity vs native complex dtypes (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense, LandauZener
from vec_ode_tpu.ops import cplx as cp


def rand_c(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_roundtrip_and_arith():
    z = rand_c((3, 4), 1)
    c = cp.from_complex(z, jnp.float64)
    np.testing.assert_allclose(np.asarray(cp.to_complex(c)), z)
    w = rand_c((3, 4), 2)
    d = cp.from_complex(w, jnp.float64)
    np.testing.assert_allclose(np.asarray(cp.to_complex(c * d)), z * w)
    np.testing.assert_allclose(np.asarray(cp.to_complex(c + d)), z + w)
    np.testing.assert_allclose(np.asarray(cp.to_complex(c - d)), z - w)
    np.testing.assert_allclose(np.asarray(cp.cabs2(c)), np.abs(z) ** 2)
    np.testing.assert_allclose(
        np.asarray(cp.to_complex(cp.cscale(c, 2 - 3j))), (2 - 3j) * z
    )
    np.testing.assert_allclose(
        np.asarray(cp.to_complex(cp.cconj(c))), z.conj()
    )


def test_cscale_any_variants():
    z = rand_c((4,), 3)
    c = cp.from_complex(z, jnp.float64)
    # python float / complex / numpy scalar / traced real scalar
    for k in [2.5, 1 - 2j, np.float64(0.3), np.complex128(0.5 + 0.5j)]:
        np.testing.assert_allclose(
            np.asarray(cp.to_complex(cp.cscale_any(c, k))), complex(k) * z
        )
    kt = jnp.asarray(1.7, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(cp.to_complex(cp.cscale_any(c, kt))), 1.7 * z
    )


def test_cmatmul_cmatvec():
    A, B = rand_c((5, 5), 4), rand_c((5, 5), 5)
    x = rand_c((5,), 6)
    ca, cb = cp.from_complex(A, jnp.float64), cp.from_complex(B, jnp.float64)
    cx = cp.from_complex(x, jnp.float64)
    np.testing.assert_allclose(
        np.asarray(cp.to_complex(cp.cmatmul(ca, cb))), A @ B, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(cp.to_complex(cp.cmatvec(ca, cx))), A @ x, atol=1e-12
    )


def test_cmatvec_batched():
    A = rand_c((7, 7), 8)
    X = rand_c((16, 7), 9)
    ca = cp.from_complex(A, jnp.float64)
    cx = cp.from_complex(X, jnp.float64)
    got = np.asarray(cp.to_complex(cp.cmatvec(ca, cx)))
    np.testing.assert_allclose(got, X @ A.T, atol=1e-12)


def test_cexpm_matches_scipy():
    A = rand_c((6, 6), 10) * 0.6
    ca = cp.from_complex(A, jnp.float64)
    got = np.asarray(cp.to_complex(cp.cexpm(ca)))
    np.testing.assert_allclose(got, scipy.linalg.expm(A), rtol=1e-10,
                               atol=1e-12)


def test_cexpm_unitary_for_antihermitian():
    H = rand_c((8, 8), 11)
    H = (H + H.conj().T) / 2
    U = np.asarray(cp.to_complex(cp.cexpm(cp.from_complex(-1j * H, jnp.float64))))
    np.testing.assert_allclose(U @ U.conj().T, np.eye(8), atol=1e-12)


def test_cexp_elementwise():
    z = rand_c((5,), 12)
    got = np.asarray(cp.to_complex(cp.cexp(cp.from_complex(z, jnp.float64))))
    np.testing.assert_allclose(got, np.exp(z), rtol=1e-13)


def test_rkf45_on_cplx_state_matches_complex_dtype():
    # same Schrödinger problem: native complex dtype vs Cplx pair, RKF45
    model = DrivenDense.make(d=8, seed=2)
    psi0 = np.zeros(8, np.complex128); psi0[0] = 1.0

    sol_c = vo.solve_ivp(
        lambda t, y: model.op(t) @ y, 0.0, 1.0,
        jnp.asarray(psi0), ctl=vo.StepControl(rtol=1e-8), h0=1e-2,
    )
    sol_p = vo.solve_ivp(
        lambda t, y: model.rhs_pair(t, y, dtype=jnp.float64), 0.0, 1.0,
        cp.from_complex(psi0, jnp.float64),
        ctl=vo.StepControl(rtol=1e-8), h0=1e-2,
    )
    assert bool(sol_p.success)
    got = np.asarray(cp.to_complex(sol_p.y_final))
    np.testing.assert_allclose(got, np.asarray(sol_c.y_final), atol=1e-12)
    # identical step counts: the pair path is the same math in real arithmetic
    assert int(sol_p.n_accept) == int(sol_c.n_accept)
    assert int(sol_p.n_reject) == int(sol_c.n_reject)


def test_magnus4_pair_matches_complex():
    model = DrivenDense.make(d=6, seed=3)
    psi0 = np.zeros(6, np.complex128); psi0[0] = 1.0

    sol_c = vo.solve_linear(
        model.op, 0.0, 1.0, jnp.asarray(psi0),
        stepper=vexp.Magnus4(vexp.DenseSplit()), h0=0.02,
    )
    sol_p = vo.solve_linear(
        lambda t: model.op_pair(t, dtype=jnp.float64), 0.0, 1.0,
        cp.from_complex(psi0, jnp.float64),
        stepper=vexp.Magnus4(vexp.DenseCplxSplit()), h0=0.02,
    )
    got = np.asarray(cp.to_complex(sol_p.y_final))
    np.testing.assert_allclose(got, np.asarray(sol_c.y_final), atol=1e-11)


def test_cfm4_pair_matches_complex():
    model = DrivenDense.make(d=6, seed=4)
    psi0 = np.zeros(6, np.complex128); psi0[0] = 1.0
    sol_c = vo.solve_linear(
        model.op, 0.0, 1.0, jnp.asarray(psi0),
        stepper=vexp.CFM4(vexp.DenseSplit()), h0=0.02,
    )
    sol_p = vo.solve_linear(
        lambda t: model.op_pair(t, dtype=jnp.float64), 0.0, 1.0,
        cp.from_complex(psi0, jnp.float64),
        stepper=vexp.CFM4(vexp.DenseCplxSplit()), h0=0.02,
    )
    got = np.asarray(cp.to_complex(sol_p.y_final))
    np.testing.assert_allclose(got, np.asarray(sol_c.y_final), atol=1e-11)


def test_landau_zener_pair_unitarity():
    lz = LandauZener(v=2.0, delta=0.4)
    psi0 = cp.from_complex(np.asarray([1.0, 0.0], np.complex128), jnp.float64)
    sol = vo.solve_linear(
        lambda t: lz.op_pair(t, dtype=jnp.float64), -15.0, 15.0, psi0,
        stepper=vexp.ExpMidpoint(vexp.DenseCplxSplit()), h0=0.01,
    )
    psi = np.asarray(cp.to_complex(sol.y_final))
    np.testing.assert_allclose(np.linalg.norm(psi), 1.0, atol=1e-11)
    np.testing.assert_allclose(
        abs(psi[0]) ** 2, lz.p_transition, atol=0.03
    )


def test_triple_jump_on_pair_leaves():
    # complex-coefficient composition over real-pair leaves: the real-pair
    # path for TripleJump/SemiComplex splits
    A = np.asarray([[0.0, 1.0], [-1.0, 0.0]])
    B = np.asarray([[-0.2, 0.0], [0.0, -0.6]])
    exact = scipy.linalg.expm(A + B) @ np.asarray([1.0, 0.5])
    dense = vexp.DenseCplxSplit()
    comp = vexp.TripleJumpSplit(dense, dense)
    y0 = cp.from_complex(np.asarray([1.0, 0.5], np.complex128), jnp.float64)
    errs = []
    for h in [0.2, 0.1]:
        sol = vo.solve_linear(
            lambda t: (cp.cplx(jnp.asarray(A)), cp.cplx(jnp.asarray(B))),
            0.0, 1.0, y0, stepper=vexp.ExpMidpoint(comp), h0=h,
        )
        got = np.asarray(cp.to_complex(sol.y_final))
        errs.append(np.linalg.norm(got - exact))
    assert 3.3 < np.log2(errs[0] / errs[1]) < 4.8


def test_cplx_under_jit_vmap():
    model = DrivenDense.make(d=4, seed=5)
    psi0s = np.stack([np.eye(4, dtype=np.complex128)[i] for i in range(4)])

    @jax.jit
    @jax.vmap
    def run(p0):
        sol = vo.solve_ivp(
            lambda t, y: model.rhs_pair(t, y, dtype=jnp.float64),
            0.0, 0.5, p0, ctl=vo.StepControl(rtol=1e-8), h0=1e-2,
        )
        return sol.y_final, sol.status

    yf, status = run(cp.from_complex(psi0s, jnp.float64))
    assert all(int(s) == vo.DONE for s in status)
    # propagation is unitary: norms all 1
    norms = np.linalg.norm(np.asarray(cp.to_complex(yf)), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)


def test_antihermitian_pair_exact_unitarity():
    """AntiHermitianCplxSplit: exactly orthogonal embedded propagator."""
    from vec_ode_tpu.exp import AntiHermitianCplxSplit, DenseCplxSplit

    H = rand_c((6, 6), 30)
    H = (H + H.conj().T) / 2
    L = cp.from_complex(-1j * H, jnp.float64)  # anti-Hermitian
    sp = AntiHermitianCplxSplit()
    U = np.asarray(sp.exp(L))                   # embedded real (12, 12)
    # orthogonality of the embedding == unitarity of the complex propagator
    np.testing.assert_allclose(U @ U.T, np.eye(12), atol=1e-13)
    # matches the dense (Pade) propagator
    Ud = np.asarray(DenseCplxSplit().exp(L))
    np.testing.assert_allclose(U, Ud, atol=1e-12)


def test_antihermitian_pair_long_integration_norm_drift():
    """Norm conservation over many steps: exact-unitary leaf has ~eps drift."""
    from vec_ode_tpu import exp as vexp

    lz = LandauZener(v=1.0, delta=0.3)
    psi0 = cp.from_complex(np.asarray([1.0, 0.0], np.complex128), jnp.float64)
    sol = vo.solve_linear(
        lambda t: lz.op_pair(t, dtype=jnp.float64), -30.0, 30.0, psi0,
        stepper=vexp.ExpMidpoint(vexp.AntiHermitianCplxSplit()), h0=0.005,
    )
    assert bool(sol.success)
    norm = float(jnp.sqrt(jnp.sum(cp.cabs2(sol.y_final))))
    assert abs(norm - 1.0) < 1e-12  # 12000 steps, no drift


def test_antihermitian_pair_gradients_correct():
    """The eigh path has degenerate eigenvalues on every input (embedding
    doubles the spectrum) so it carries a custom Frechet-adjoint VJP; its
    gradients must match the Dense (Pade) leaf and finite differences."""
    from vec_ode_tpu.exp import AntiHermitianCplxSplit, DenseCplxSplit

    H = rand_c((4, 4), 33)
    H = (H + H.conj().T) / 2
    L = cp.from_complex(-1j * H, jnp.float64)
    x = cp.from_complex(rand_c((4,), 34), jnp.float64)

    def loss(s, sp):
        Ls = cp.Cplx(s * L.re, s * L.im)
        y = sp.map_exp(sp.exp(Ls), x)
        return y.re[0] + y.im[1]

    g_anti = jax.grad(loss)(0.8, AntiHermitianCplxSplit())
    g_dense = jax.grad(loss)(0.8, DenseCplxSplit())
    eps = 1e-6
    fd = (loss(0.8 + eps, DenseCplxSplit())
          - loss(0.8 - eps, DenseCplxSplit())) / (2 * eps)
    np.testing.assert_allclose(float(g_dense), float(fd), rtol=1e-7)
    np.testing.assert_allclose(float(g_anti), float(g_dense), rtol=1e-9)


def test_antihermitian_pair_rejects_complex_rescalings():
    from vec_ode_tpu.exp import AntiHermitianCplxSplit

    H = rand_c((3, 3), 35)
    H = (H + H.conj().T) / 2
    L = cp.from_complex(-1j * H, jnp.float64)
    sp = AntiHermitianCplxSplit()
    # real rescalings fine
    sp.multi_exp(L, np.asarray([0.5, 1.0]))
    try:
        sp.multi_exp(L, np.asarray([0.5 + 0.1j]))
        assert False, "expected ValueError"
    except ValueError as e:
        assert "anti-Hermiticity" in str(e)


def test_cplx_scalar_algebra_regressions():
    """Regressions for the scalar-operand hazards: numpy scalars on the
    LEFT of * must not consume the pair as an array-like; complex scalars
    (python AND numpy, incl. complex64) must rotate both halves without
    introducing complex-dtype leaves; cscale_any must not drop the
    imaginary part of complex ARRAY scalars."""
    c = cp.Cplx(jnp.asarray([1.0, 2.0]), jnp.asarray([3.0, 4.0]))

    r = np.float64(2.0) * c
    assert isinstance(r, cp.Cplx)
    np.testing.assert_allclose(np.asarray(r.re), [2, 4])

    r = c + 1j
    np.testing.assert_allclose(np.asarray(r.re), [1, 2])
    np.testing.assert_allclose(np.asarray(r.im), [4, 5])
    assert not jnp.issubdtype(r.re.dtype, jnp.complexfloating)

    r = c * np.complex64(1j)
    np.testing.assert_allclose(np.asarray(r.re), [-3, -4])
    np.testing.assert_allclose(np.asarray(r.im), [1, 2])
    assert not jnp.issubdtype(r.im.dtype, jnp.complexfloating)

    r = cp.cscale_any(c, jnp.asarray(1j))        # traced-style array scalar
    np.testing.assert_allclose(np.asarray(r.re), [-3, -4])
    np.testing.assert_allclose(np.asarray(r.im), [1, 2])

    r = cp.cscale_any(c, np.asarray(0.5 + 0.5j))  # 0-d ndarray
    np.testing.assert_allclose(np.asarray(r.re), [-1, -1])
    np.testing.assert_allclose(np.asarray(r.im), [2, 3])

    r = 1.0 - c                                   # __rsub__
    np.testing.assert_allclose(np.asarray(r.re), [0, -1])
    np.testing.assert_allclose(np.asarray(r.im), [-3, -4])
