import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense, LandauZener, LinearConstant


def convergence_rate(stepper_factory, op_fn, y0, tf, exact, hs,
                     adaptive=False):
    errs = []
    for h in hs:
        sol = vo.solve_linear(
            op_fn, 0.0, tf, y0, stepper=stepper_factory(), h0=h,
            adaptive=adaptive,
        )
        assert bool(sol.success)
        errs.append(float(jnp.linalg.norm(sol.y_final - exact)))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    return errs, rates


@pytest.fixture(scope="module")
def dense_problem():
    A = jnp.asarray(
        [[-0.3, 1.2, 0.1], [-1.2, -0.1, 0.4], [0.2, -0.4, -0.2]],
        jnp.float64,
    )
    y0 = jnp.asarray([1.0, -0.5, 0.25], jnp.float64)
    tf = 1.5
    exact = jnp.asarray(scipy.linalg.expm(np.asarray(A) * tf) @ np.asarray(y0))
    return A, y0, tf, exact


def test_exp_midpoint_exact_for_constant_A(dense_problem):
    # For constant A, exp midpoint IS exp(dt*A) each step: exact to roundoff
    A, y0, tf, exact = dense_problem
    sol = vo.solve_linear(
        lambda t: A, 0.0, tf, y0,
        stepper=vexp.ExpMidpoint(vexp.DenseSplit()), h0=0.1,
    )
    np.testing.assert_allclose(np.asarray(sol.y_final), exact, rtol=1e-12)


def test_magnus4_exact_for_constant_A(dense_problem):
    A, y0, tf, exact = dense_problem
    sol = vo.solve_linear(
        lambda t: A, 0.0, tf, y0,
        stepper=vexp.Magnus4(vexp.DenseSplit()), h0=0.1,
    )
    np.testing.assert_allclose(np.asarray(sol.y_final), exact, rtol=1e-12)


@pytest.fixture(scope="module")
def td_problem():
    # time-dependent A(t) = A0 + sin(t) B with [A0, B] != 0; reference
    # solution via tiny-step Magnus-4
    A0 = jnp.asarray([[0.0, 1.0], [-1.0, 0.0]], jnp.float64) * 0.8
    B = jnp.asarray([[0.3, 0.1], [0.1, -0.3]], jnp.float64)

    def op(t):
        return A0 + jnp.sin(t) * B

    y0 = jnp.asarray([1.0, 0.0], jnp.float64)
    tf = 2.0
    ref = vo.solve_linear(
        op, 0.0, tf, y0, stepper=vexp.Magnus4(vexp.DenseSplit()), h0=1e-4,
    )
    return op, y0, tf, ref.y_final


def test_midpoint_order2(td_problem):
    op, y0, tf, exact = td_problem
    errs, rates = convergence_rate(
        lambda: vexp.ExpMidpoint(vexp.DenseSplit()), op, y0, tf, exact,
        [0.2, 0.1, 0.05],
    )
    assert 1.8 < np.mean(rates) < 2.3, (errs, rates)


def test_magnus4_order4(td_problem):
    op, y0, tf, exact = td_problem
    errs, rates = convergence_rate(
        lambda: vexp.Magnus4(vexp.DenseSplit()), op, y0, tf, exact,
        [0.2, 0.1, 0.05],
    )
    assert 3.6 < np.mean(rates) < 4.6, (errs, rates)


def test_cfm4_order4(td_problem):
    op, y0, tf, exact = td_problem
    errs, rates = convergence_rate(
        lambda: vexp.CFM4(vexp.DenseSplit()), op, y0, tf, exact,
        [0.2, 0.1, 0.05],
    )
    assert 3.6 < np.mean(rates) < 4.6, (errs, rates)


def test_cfm4_blanes17_order4(td_problem):
    op, y0, tf, exact = td_problem
    errs, rates = convergence_rate(
        lambda: vexp.CFM4_BLANES17(vexp.DenseSplit()), op, y0, tf, exact,
        [0.2, 0.1, 0.05],
    )
    assert 3.6 < np.mean(rates) < 4.8, (errs, rates)


def test_magnus4_adaptive(td_problem):
    op, y0, tf, exact = td_problem
    sol = vo.solve_linear(
        op, 0.0, tf, y0, stepper=vexp.Magnus4(vexp.DenseSplit()),
        adaptive=True, ctl=vo.StepControl(rtol=1e-9), h0=1e-2,
    )
    assert bool(sol.success)
    np.testing.assert_allclose(np.asarray(sol.y_final), exact, atol=1e-7)
    # error estimate is the order-2/order-4 difference (~h^3), so rtol=1e-9
    # forces h ~ 1e-3 — hundreds of steps, not tens (reference semantics)
    assert int(sol.n_accept) < 1000


def test_cfm4_adaptive(td_problem):
    op, y0, tf, exact = td_problem
    sol = vo.solve_linear(
        op, 0.0, tf, y0, stepper=vexp.CFM4(vexp.DenseSplit()),
        adaptive=True, ctl=vo.StepControl(rtol=1e-9), h0=1e-2,
    )
    assert bool(sol.success)
    np.testing.assert_allclose(np.asarray(sol.y_final), exact, atol=1e-7)


# ---------------------------------------------------------------- quantum --
def test_landau_zener_unitarity_and_transition():
    lz = LandauZener(v=2.0, delta=0.4)
    T = 20.0
    psi0 = jnp.asarray([1.0, 0.0], jnp.complex128)  # diabatic ground state
    sol = vo.solve_linear(
        lz.op, -T, T, psi0,
        stepper=vexp.ExpMidpoint(vexp.AntiHermitianSplit()), h0=0.01,
        time_dtype=jnp.float64,
    )
    psi = np.asarray(sol.y_final)
    # unitarity: AntiHermitianSplit propagates exactly unitarily
    np.testing.assert_allclose(np.linalg.norm(psi), 1.0, atol=1e-10)
    # asymptotic LZ formula (finite-T corrections ~ 1/(v T^2))
    p_stay = abs(psi[0]) ** 2
    np.testing.assert_allclose(p_stay, lz.p_transition, atol=0.02)


def test_driven_dense_64dim_magnus_vs_cfm():
    # BASELINE config 4 shape: 64-dim driven Hamiltonian; two independent
    # order-4 integrators must agree
    model = DrivenDense.make(d=16, seed=1)  # 16-dim for test speed
    psi0 = jnp.zeros(16, jnp.complex128).at[0].set(1.0)
    sol_m = vo.solve_linear(
        model.op, 0.0, 1.0, psi0,
        stepper=vexp.Magnus4(vexp.DenseSplit()), h0=0.01,
    )
    sol_c = vo.solve_linear(
        model.op, 0.0, 1.0, psi0,
        stepper=vexp.CFM4(vexp.DenseSplit()), h0=0.01,
    )
    np.testing.assert_allclose(
        np.asarray(sol_m.y_final), np.asarray(sol_c.y_final), atol=1e-8
    )
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(sol_m.y_final)), 1.0, atol=1e-9
    )


# ----------------------------------------------------------------- splits --
@pytest.fixture(scope="module")
def split_problem():
    # dx/dt = (A + B) x with noncommuting constant A, B
    A = jnp.asarray([[0.0, 1.0], [-1.0, 0.0]], jnp.float64)
    B = jnp.asarray([[-0.2, 0.0], [0.0, -0.6]], jnp.float64)
    y0 = jnp.asarray([1.0, 0.5], jnp.float64)
    tf = 1.0
    exact = jnp.asarray(
        scipy.linalg.expm(np.asarray(A + B) * tf) @ np.asarray(y0)
    )
    return A, B, y0, tf, exact


def split_convergence(split_cls, A, B, y0, tf, exact, hs, order_hint):
    dense = vexp.DenseSplit()
    comp = split_cls(dense, dense)
    errs = []
    for h in hs:
        sol = vo.solve_linear(
            lambda t: (A, B), 0.0, tf, y0,
            stepper=vexp.ExpMidpoint(comp), h0=h,
        )
        errs.append(float(jnp.linalg.norm(sol.y_final - exact)))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    return errs, rates


def test_strang_split_order2(split_problem):
    A, B, y0, tf, exact = split_problem
    errs, rates = split_convergence(
        vexp.StrangSplit, A, B, y0, tf, exact, [0.2, 0.1, 0.05], 2
    )
    assert 1.8 < np.mean(rates) < 2.3, (errs, rates)


def test_rknr4_split_order4(split_problem):
    A, B, y0, tf, exact = split_problem
    errs, rates = split_convergence(
        vexp.RKNR4Split, A, B, y0, tf, exact, [0.4, 0.2, 0.1], 4
    )
    assert 3.5 < np.mean(rates) < 4.8, (errs, rates)


def test_triple_jump_split_order4(split_problem):
    A, B, y0, tf, exact = split_problem
    # complex coefficients: state must be complex
    y0c = jnp.asarray(split_problem[2], jnp.complex128)
    errs = []
    dense = vexp.DenseSplit()
    comp = vexp.TripleJumpSplit(dense, dense)
    for h in [0.4, 0.2, 0.1]:
        sol = vo.solve_linear(
            lambda t: (A.astype(jnp.complex128), B.astype(jnp.complex128)),
            0.0, tf, y0c, stepper=vexp.ExpMidpoint(comp), h0=h,
        )
        errs.append(float(jnp.linalg.norm(sol.y_final - exact)))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert 3.5 < np.mean(rates) < 4.8, (errs, rates)


def test_semi_complex_split_order4(split_problem):
    A, B, y0, tf, exact = split_problem
    y0c = jnp.asarray(y0, jnp.complex128)
    dense = vexp.DenseSplit()
    comp = vexp.SemiComplexO4Split(dense, dense)
    errs = []
    for h in [0.4, 0.2, 0.1]:
        sol = vo.solve_linear(
            lambda t: (A.astype(jnp.complex128), B.astype(jnp.complex128)),
            0.0, tf, y0c, stepper=vexp.ExpMidpoint(comp), h0=h,
        )
        errs.append(float(jnp.linalg.norm(sol.y_final - exact)))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert 3.5 < np.mean(rates) < 4.8, (errs, rates)


def test_commutative_split_exact_for_commuting(split_problem):
    # diag + diag commute: CommutativeSplit is exact
    D1 = jnp.asarray([-0.5, -1.0], jnp.float64)
    D2 = jnp.asarray([-0.1, -0.2], jnp.float64)
    y0 = jnp.asarray([1.0, 2.0], jnp.float64)
    comp = vexp.CommutativeSplit(vexp.DiagonalSplit(), vexp.DiagonalSplit())
    sol = vo.solve_linear(
        lambda t: (D1, D2), 0.0, 1.0, y0,
        stepper=vexp.ExpMidpoint(comp), h0=0.25,
    )
    np.testing.assert_allclose(
        np.asarray(sol.y_final), np.asarray(y0 * jnp.exp(D1 + D2)),
        rtol=1e-13,
    )


def test_split_midpoint_corrected_vs_reference_compat(split_problem):
    A, B, y0, tf, exact = split_problem
    dense = vexp.DenseSplit()

    def run(strict, h):
        sol = vo.solve_linear(
            lambda t: (A, B), 0.0, tf, y0,
            stepper=vexp.SplitMidpoint(dense, dense,
                                       strict_reference_compat=strict),
            h0=h,
        )
        return float(jnp.linalg.norm(sol.y_final - exact))

    # corrected Strang converges at order 2
    e1, e2 = run(False, 0.2), run(False, 0.1)
    assert 1.7 < np.log2(e1 / e2) < 2.4
    # reference-compat mode (B at half weight) does NOT converge to the true
    # solution — it solves dx/dt=(A+B/2)x instead (documented bug, SURVEY §2.3(7))
    wrong = run(True, 0.01)
    assert wrong > 0.01


def test_split_cfm_strang_coefficients(split_problem):
    # rho=[[1]], sigma=[[1/2],[1/2]], c=[1/2]: e^{B/2} e^{A} e^{B/2} midpoint
    A, B, y0, tf, exact = split_problem
    dense = vexp.DenseSplit()
    stepper = vexp.SplitCFM(
        dense, dense, rho=((1.0,),), sigma=((0.5,), (0.5,)), c=(0.5,)
    )
    errs = []
    for h in [0.2, 0.1]:
        sol = vo.solve_linear(
            lambda t: (A, B), 0.0, tf, y0, stepper=stepper, h0=h,
        )
        errs.append(float(jnp.linalg.norm(sol.y_final - exact)))
    assert 1.7 < np.log2(errs[0] / errs[1]) < 2.4


def test_multi_exp_matches_loop():
    A = jnp.asarray([[0.1, 0.5], [-0.5, 0.2]], jnp.float64)
    ks = jnp.asarray([0.3, -0.7, 1.1], jnp.float64)
    dense = vexp.DenseSplit()
    stacked = dense.multi_exp(A, ks)
    for i, k in enumerate(np.asarray(ks)):
        np.testing.assert_allclose(
            np.asarray(stacked[i]),
            scipy.linalg.expm(np.asarray(A) * k),
            rtol=1e-11, atol=1e-13,
        )


def test_magnus4_grad():
    # differentiate terminal state w.r.t. a Hamiltonian parameter through
    # the adaptive driver + expm VJP
    def loss(theta):
        def op(t):
            return jnp.asarray(
                [[0.0, theta], [-theta, 0.0]], jnp.float64
            ) + jnp.sin(t) * jnp.asarray([[0.1, 0.0], [0.0, -0.1]])

        sol = vo.solve_linear(
            op, 0.0, 1.0, jnp.asarray([1.0, 0.0], jnp.float64),
            stepper=vexp.Magnus4(vexp.DenseSplit()), h0=0.05,
            method="scan", ctl=vo.StepControl(max_steps=32),
        )
        return sol.y_final[0]

    g = jax.grad(loss)(0.8)
    # finite-difference check
    eps = 1e-6
    fd = (loss(0.8 + eps) - loss(0.8 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-5)


def test_split_cfm_rkn_o4_coefficients(split_problem):
    # the RKNR4 composition expressed through the completed split_cfm path:
    # constant operators, c=[1/2], rho rows = A palindrome a0 a1 a2 a2 a1 a0,
    # sigma rows = B palindrome b0 b1 b2 b3 b2 b1 b0 -> order 4
    import numpy as np

    from vec_ode_tpu import tableaus as tb

    A, B, y0, tf, exact = split_problem
    a = tb.RKN_O4_A
    b = tb.RKN_O4_B
    rho = tuple((float(x),) for x in [a[0], a[1], a[2], a[2], a[1], a[0]])
    sigma = tuple(
        (float(x),) for x in [b[0], b[1], b[2], b[3], b[2], b[1], b[0]]
    )
    dense = vexp.DenseSplit()
    stepper = vexp.SplitCFM(dense, dense, rho=rho, sigma=sigma, c=(0.5,))
    errs = []
    for h in [0.4, 0.2, 0.1]:
        sol = vo.solve_linear(
            lambda t: (A, B), 0.0, tf, y0, stepper=stepper, h0=h,
        )
        errs.append(float(jnp.linalg.norm(sol.y_final - exact)))
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert 3.5 < np.mean(rates) < 4.8, (errs, rates)


def test_pair_multi_exp_contract_under_nesting(split_problem):
    # multi_exp(L, ks)[k] must equal exp(ks[k] * L) even when the split is
    # itself nested inside another composition (per-scaling loop, not the
    # stacked default that interleaves axes)
    import numpy as np

    from vec_ode_tpu.exp.protocol import index_u

    A, B, y0, tf, exact = split_problem
    dense = vexp.DenseSplit()
    inner = vexp.RKNR4Split(dense, dense)
    outer = vexp.StrangSplit(inner, dense)
    L = ((A, B), A * 0.3)
    ks = np.asarray([0.5, 1.25])
    stacked = outer.multi_exp(L, ks)
    for k in range(2):
        direct = outer.exp(outer.scale_l(L, float(ks[k])))
        got = jax.tree_util.tree_leaves(index_u(stacked, k))
        want = jax.tree_util.tree_leaves(direct)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       atol=1e-13)


def test_split_leaf_rejects_operator_argument():
    """DenseSplit(Ht) / DenseCplxSplit(Ht) must raise, not silently bind the
    operator function to max_squarings (the operator goes to solve_linear)."""
    import pytest

    for cls in (vexp.DenseSplit, vexp.DenseCplxSplit):
        with pytest.raises(TypeError, match="solve_linear"):
            cls(lambda t: t)


def test_magnus6_order6(td_problem):
    op, y0, tf, exact = td_problem
    errs, rates = convergence_rate(
        lambda: vexp.Magnus6(vexp.DenseSplit()), op, y0, tf, exact,
        [0.4, 0.2, 0.1],
    )
    assert 5.4 < np.mean(rates) < 6.8, (errs, rates)
    # and strictly more accurate than Magnus-4 at the same h
    errs4, _ = convergence_rate(
        lambda: vexp.Magnus4(vexp.DenseSplit()), op, y0, tf, exact, [0.1],
    )
    assert errs[-1] < errs4[-1] / 30, (errs[-1], errs4[-1])


def test_magnus6_adaptive(td_problem):
    op, y0, tf, exact = td_problem
    sol = vo.solve_linear(
        op, 0.0, tf, y0, stepper=vexp.Magnus6(vexp.DenseSplit()),
        adaptive=True, ctl=vo.StepControl(rtol=1e-9), h0=1e-2,
    )
    assert bool(sol.success)
    np.testing.assert_allclose(np.asarray(sol.y_final), exact, atol=1e-7)
    # err est is the full M4-vs-M6 difference (~h^5): far fewer steps than
    # Magnus-4 needs at the same rtol
    sol4 = vo.solve_linear(
        op, 0.0, tf, y0, stepper=vexp.Magnus4(vexp.DenseSplit()),
        adaptive=True, ctl=vo.StepControl(rtol=1e-9), h0=1e-2,
    )
    assert int(sol.n_accept) < int(sol4.n_accept) / 2, (
        int(sol.n_accept), int(sol4.n_accept))


def test_magnus6_unitary_schrodinger():
    rng = np.random.default_rng(5)
    d = 4
    H0 = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    H0 = (H0 + H0.conj().T) / 2
    V = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    V = (V + V.conj().T) / 2

    def op(t):
        return -1j * (jnp.asarray(H0) + jnp.cos(2.3 * t) * jnp.asarray(V))

    psi0 = np.zeros(d, complex)
    psi0[0] = 1.0
    sol = vo.solve_linear(
        op, 0.0, 3.0, jnp.asarray(psi0),
        stepper=vexp.Magnus6(vexp.DenseSplit()), adaptive=True,
        ctl=vo.StepControl(rtol=1e-10, atol=1e-12), h0=1e-2,
        time_dtype=jnp.float64,
    )
    assert bool(sol.success)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(sol.y_final)), 1.0, atol=1e-8)


def test_composite_exp_many_row_selection():
    """Regression: exp_many on nested composites (whose exp internally
    calls multi_exp, adding ITS axis in front) must still select rows
    correctly with index_u — the stacked protocol default interleaved the
    axes and returned silently wrong propagators."""
    import numpy as np

    from vec_ode_tpu.ops import cplx as cp

    rng = np.random.default_rng(3)
    d = 4
    da = cp.Cplx(jnp.asarray(rng.standard_normal(d) * 0.1),
                 jnp.asarray(rng.standard_normal(d)))
    db = cp.Cplx(jnp.asarray(rng.standard_normal(d) * 0.1),
                 jnp.asarray(rng.standard_normal(d)))
    leaf = vexp.DiagonalCplxSplit()
    for comp in (vexp.TripleJumpSplit(leaf, leaf),
                 vexp.SemiComplexO4Split(leaf, leaf),
                 vexp.RKNR4Split(leaf, leaf),
                 vexp.StrangSplit(leaf, leaf)):
        rows = [(cp.cscale_any(da, 0.5), cp.cscale_any(db, 0.5)),
                (da, db)]
        stacked = comp.exp_many(rows)
        x = cp.Cplx(jnp.asarray(rng.standard_normal(d)),
                    jnp.asarray(rng.standard_normal(d)))
        for r in range(2):
            want = comp.map_exp(comp.exp(rows[r]), x)
            got = comp.map_exp(vexp.index_u(stacked, r), x)
            np.testing.assert_allclose(np.asarray(got.re),
                                       np.asarray(want.re), atol=1e-12,
                                       err_msg=str(type(comp)))
            np.testing.assert_allclose(np.asarray(got.im),
                                       np.asarray(want.im), atol=1e-12)


# -------------------------------------------------------------- fast_error --
def test_magnus4_fast_error_adaptive_accuracy(td_problem):
    # the w2*xf estimate drives the controller to comparable accuracy and
    # step counts as the reference pair (same order, different constant)
    op, y0, tf, exact = td_problem
    sol = vo.solve_linear(
        op, 0.0, tf, y0,
        stepper=vexp.Magnus4(vexp.DenseSplit(), fast_error=True),
        adaptive=True, ctl=vo.StepControl(rtol=1e-9), h0=1e-2,
    )
    assert bool(sol.success)
    np.testing.assert_allclose(np.asarray(sol.y_final), exact, atol=1e-7)
    ref = vo.solve_linear(
        op, 0.0, tf, y0, stepper=vexp.Magnus4(vexp.DenseSplit()),
        adaptive=True, ctl=vo.StepControl(rtol=1e-9), h0=1e-2,
    )
    assert int(sol.n_accept) < 3 * int(ref.n_accept)


def test_magnus4_fast_error_batched_matches_scalar():
    # natively-batched fast_error (halved expm stack) == vmapped scalar path
    from vec_ode_tpu.parallel import ensemble_solve

    A0 = jnp.asarray([[0.0, 1.0], [-1.0, 0.0]], jnp.float64) * 0.8
    B = jnp.asarray([[0.3, 0.1], [0.1, -0.3]], jnp.float64)

    def op(t):
        return A0 + jnp.sin(t) * B

    y0b = jnp.asarray([[1.0, 0.0], [0.0, 1.0], [0.5, -0.5], [2.0, 0.3]],
                      jnp.float64)
    ctl = vo.StepControl(rtol=1e-8)
    sol_b = ensemble_solve(
        op, y0b, 0.0, 2.0,
        stepper=vexp.Magnus4(vexp.DenseSplit(), fast_error=True),
        adaptive=True, ctl=ctl, h0=1e-2,
    )
    sol_s = ensemble_solve(
        op, y0b, 0.0, 2.0,
        stepper=vexp.Magnus4(vexp.DenseSplit(), fast_error=True,
                             batched=False),
        adaptive=True, ctl=ctl, h0=1e-2,
    )
    assert np.all(np.asarray(sol_b.status) == vo.DONE)
    np.testing.assert_allclose(
        np.asarray(sol_b.y_final), np.asarray(sol_s.y_final),
        rtol=1e-12, atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(sol_b.n_accept), np.asarray(sol_s.n_accept)
    )


def test_magnus4_fast_error_batched_complex_matches_vmapped():
    # natively-batched fast_error on the complex-pair dense split (stacked
    # expm + w2*xf estimate) agrees with the vmapped scalar path in f32
    from vec_ode_tpu.parallel import ensemble_solve
    from vec_ode_tpu.models import DrivenDense
    from vec_ode_tpu.ops import cplx as cp

    model = DrivenDense.make(d=16, seed=3)
    rng = np.random.default_rng(5)
    psi = rng.standard_normal((8, 16)) + 1j * rng.standard_normal((8, 16))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    y0 = cp.from_complex(jnp.asarray(psi), dtype=jnp.float32)
    ctl = vo.StepControl(rtol=1e-4, max_dt=0.05)
    kw = dict(adaptive=True, ctl=ctl, h0=1e-2, time_dtype=jnp.float32)
    op_fn = lambda t: model.op_pair(t)  # noqa: E731
    sol_b = ensemble_solve(
        op_fn, y0, 0.0, 0.1,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True), **kw)
    sol_v = ensemble_solve(
        op_fn, y0, 0.0, 0.1,
        stepper=vexp.Magnus4(vexp.DenseCplxSplit(), fast_error=True,
                             batched=False),
        **kw,
    )
    assert np.all(np.asarray(sol_b.status) == vo.DONE)
    np.testing.assert_allclose(
        np.asarray(sol_b.y_final.re), np.asarray(sol_v.y_final.re),
        atol=2e-6,
    )
    np.testing.assert_allclose(
        np.asarray(sol_b.n_accept), np.asarray(sol_v.n_accept)
    )
