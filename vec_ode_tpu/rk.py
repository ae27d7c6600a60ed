"""Explicit Runge-Kutta steppers over pytree states.

Counterpart of the reference's ``rk_step`` + ``RK45Solver``
(``/root/reference/src/base/rk.rs:90-155, 158-320``). The reference's hot loop
is 6 RHS evaluations + ~15 vector-length linear-combination passes per step
over abstract storage; here the stage loop is statically unrolled at trace
time, stage combinations are ``lc.lincomb`` expressions XLA fuses into a few
elementwise passes, and the RHS is an arbitrary JAX function (so for batched
linear ODEs the stage evaluations become MXU matmuls).

Reference semantics preserved exactly (SURVEY.md §2.3(2)):
  * With an embedded pair in adaptive mode, the step *advances the b_err
    (lower-order) solution* and the error estimate is err = x_b - x_berr
    (rk.rs:136-151) — classic Fehlberg without local extrapolation.
  * ``no_adaptive()`` (rk.rs:233-238) advances the b (higher-order) solution
    with no error estimate: pass ``RungeKutta(embedded=False)`` (the driver's
    ``adaptive=False`` alone still advances the b_err solution — the
    advance choice belongs to the STEPPER, not the driver flag).
  * Zero entries of the tableau are skipped at trace time, mirroring nothing
    in the reference (it multiplies by zero) but producing identical math.

``advance_lower=False`` opts into local extrapolation (advance the b weights,
same error estimate) — an extension, not reference behavior.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax.numpy as jnp

from . import lc
from .tableaus import RKF45, ButcherTableau

Pytree = Any


def rk_step(
    f: Callable,
    t,
    x0: Pytree,
    dt,
    tab: ButcherTableau,
    *,
    embedded: bool = True,
    advance_lower: bool = True,
) -> Tuple[Pytree, Optional[Pytree]]:
    """One explicit RK step. Returns (x_next, err) with err=None when the
    tableau has no embedded pair or ``embedded=False``.

    Mirrors ``rk_step`` (rk.rs:90-155): stages K_i = f(t + c_i dt,
    x0 + dt sum_j a_ij K_j), then x_b = x0 + dt sum b_i K_i and (embedded)
    x_berr = x0 + dt sum berr_i K_i, err = x_b - x_berr.
    """
    # (err = dt * sum (b_i - berr_i) K_i, computed DIRECTLY from the weight
    # difference rather than as x_b - x_berr — the reference's formulation,
    # rk.rs:136-151 — mathematically identical but free of the catastrophic
    # cancellation that floors the estimate at eps*|x|; see rk_step_stages,
    # the single implementation of the stage loop.)
    x_next, err, _, _ = rk_step_stages(
        f, t, x0, dt, tab, embedded=embedded, advance_lower=advance_lower,
    )
    return x_next, err


def rk_step_stages(
    f: Callable,
    t,
    x0: Pytree,
    dt,
    tab: ButcherTableau,
    *,
    embedded: bool = True,
    advance_lower: bool = True,
    k0: Optional[Pytree] = None,
) -> Tuple[Pytree, Optional[Pytree], list, Pytree]:
    """Like :func:`rk_step` / :func:`rk_step_fsal` but also returns the
    stage slopes K (for dense-output interpolants) and the ADVANCED
    INCREMENT x_next - x0 (computed directly from the weighted stage sum,
    never by subtraction — the compensated tier, comp.py, folds it into the
    state pair with O(eps*|dy|) rounding). ``k0`` supplies the FSAL first
    stage; when given, ``advance_lower`` must be False."""
    if k0 is not None and advance_lower:
        raise ValueError("FSAL stage reuse requires advance_lower=False")
    s = tab.stages
    K = [None] * s
    K[0] = f(t, x0) if k0 is None else k0
    for i in range(1, s):
        ti = t + float(tab.c[i]) * dt
        idx = [j for j in range(i) if tab.a[i, j] != 0.0]
        if idx:
            incr = lc.lincomb([K[j] for j in idx],
                              [float(tab.a[i, j]) for j in idx])
            xi = lc.axpy(dt, incr, x0)
        else:
            xi = x0
        K[i] = f(ti, xi)

    bidx = [j for j in range(s) if tab.b[j] != 0.0]
    incr_b = lc.scale(
        lc.lincomb([K[j] for j in bidx], [float(tab.b[j]) for j in bidx]),
        dt,
    )
    x_b = lc.add(x0, incr_b)
    if not embedded or tab.b_err is None:
        return x_b, None, K, incr_b
    db = tab.b - tab.b_err
    eidx = [j for j in range(s) if db[j] != 0.0]
    err = lc.scale(
        lc.lincomb([K[j] for j in eidx], [float(db[j]) for j in eidx]), dt
    )
    if advance_lower:
        return lc.sub(x_b, err), err, K, lc.sub(incr_b, err)
    return x_b, err, K, incr_b


def rk_step_fsal(
    f: Callable,
    t,
    x0: Pytree,
    dt,
    tab: ButcherTableau,
    k0: Pytree,
    *,
    embedded: bool = True,
) -> Tuple[Pytree, Optional[Pytree], Pytree]:
    """FSAL variant of :func:`rk_step`: the first stage slope K[0] = f(t, x0)
    is taken from the carry (the previous accepted step's last stage), and
    the last stage K[s-1] = f(t+dt, x_b) is returned as the next carry —
    s-1 RHS evaluations per attempt instead of s.

    Requires an FSAL tableau (``tab.is_fsal``) and advancing the b solution
    (``advance_lower=False``): the last stage is evaluated at x_b, so
    reusing it as the next first stage is only exact when x_b is what the
    step advances. The reference never exploits this (its rk_step always
    evaluates stage 1, rk.rs:111).
    """
    # FSAL: stage s's state IS x_b (a[s-1] == b), so K[s-1] = f(t+dt, x_b)
    x_b, err, K, _ = rk_step_stages(
        f, t, x0, dt, tab, embedded=embedded, advance_lower=False, k0=k0,
    )
    return x_b, err, K[-1]


@dataclasses.dataclass(frozen=True)
class RungeKutta:
    """Stepper factory for the driver. ``RungeKutta(RKF45)`` is the analog of
    ``RK45Solver`` (rk.rs:158-320); any :class:`ButcherTableau` works, as the
    reference's generic ``ButcherTableu::from_vecs`` (rk.rs:44-51) intended."""

    tableau: ButcherTableau = RKF45
    advance_lower: bool = True   # reference-compat: advance 4th-order solution
    embedded: bool = True
    # FSAL slope reuse (None = auto: on for FSAL tableaus advancing the b
    # solution). Threads the last stage through the driver carry so DOPRI5
    # costs 6 RHS evals/attempt instead of 7 (BOSH32: 3 instead of 4).
    fsal: Optional[bool] = None
    # compensated (double-f32) state accumulation: carry the state as a
    # TwoSum-renormalized (hi, lo) pair and fold in the directly-computed
    # step increment, so n-step f32 accumulation drift (~n*eps*|y|)
    # vanishes — the reference's f64 regime on f32 hardware (comp.py).
    # The lo word rides the stepper carry.
    compensated: bool = False

    # RHS signature is f(t, y) (vs op_fn(t) for exp steppers) — used by
    # ensemble_solve to thread per-trajectory params correctly
    takes_state = True

    @property
    def use_fsal(self) -> bool:
        auto = self.tableau.is_fsal and not self.advance_lower
        if self.fsal is None:
            return auto
        if self.fsal and not auto:
            raise ValueError(
                "fsal=True requires an FSAL tableau (c[-1]=1, a[-1]=b) and "
                "advance_lower=False (the reused stage sits at x_b)"
            )
        return self.fsal

    # driver-carry protocol (driver.step_once): step_fn takes and returns
    # the carry; make_init_carry seeds it at (t0, x0)
    @property
    def has_carry(self) -> bool:
        return self.use_fsal or self.compensated

    @property
    def nfev_per_step(self) -> int:
        return self.tableau.stages - (1 if self.use_fsal else 0)

    @property
    def nfev_init(self) -> int:
        return 1 if self.use_fsal else 0

    def make_init_carry(self, f: Callable) -> Callable:
        from . import comp

        if self.use_fsal and self.compensated:
            return lambda t, x: (f(t, x), comp.zero_lo(x))
        if self.compensated:
            return lambda t, x: comp.zero_lo(x)
        return lambda t, x: f(t, x)

    def make_step_fn(self, f: Callable) -> Callable:
        from . import comp

        if self.use_fsal and self.compensated:
            def step_fn_fsal_comp(t, x, dt, carry):
                k0, lo = carry
                _, err, K, incr = rk_step_stages(
                    f, t, x, dt, self.tableau, k0=k0,
                    embedded=self.embedded, advance_lower=False,
                )
                hi, lo2 = comp.update(x, lo, incr)
                return hi, err, (K[-1], lo2)

            return step_fn_fsal_comp

        if self.use_fsal:
            def step_fn_fsal(t, x, dt, k0):
                return rk_step_fsal(
                    f, t, x, dt, self.tableau, k0, embedded=self.embedded,
                )

            return step_fn_fsal

        if self.compensated:
            def step_fn_comp(t, x, dt, lo):
                _, err, _, incr = rk_step_stages(
                    f, t, x, dt, self.tableau,
                    embedded=self.embedded,
                    advance_lower=self.advance_lower,
                )
                hi, lo2 = comp.update(x, lo, incr)
                return hi, err, lo2

            return step_fn_comp

        def step_fn(t, x, dt):
            return rk_step(
                f, t, x, dt, self.tableau,
                embedded=self.embedded,
                advance_lower=self.advance_lower,
            )

        return step_fn
