"""Adaptive step-size controller with reference-exact semantics.

Reimplements the accept/reject + step-size logic of the reference's
``AdaptiveODESolver::handle_step_adaptive`` (``/root/reference/src/base/ode.rs:311-334``)
as a pure, branchless function suitable for ``lax.while_loop`` bodies and
``vmap`` batching:

    f       = rtol / ||err||                       (ode.rs:320)
    fp_lim  = clip(alpha * f**(1/order), 0.3, 2.0) (ode.rs:321-323, 133-136)
    new_h   = clip(fp_lim * h, min_dt, max_dt)     (ode.rs:324)
    accept  = f > 1                                (ode.rs:328-330)

Reference quirks preserved (SURVEY.md §2.3):
  * ``atol`` is stored but **ignored** by the accept test (ode.rs:320) — the
    decision is purely rtol vs the unscaled error norm. An opt-in
    ``scaled_error=True`` mode adds the standard err/(atol+rtol*|x|) norm as an
    extension.
  * every reference solver constructs the controller with order=3.0, i.e.
    exponent 1/3 — including RK45 (rk.rs:258-260, magnus.rs:183-184,
    cfm.rs:150-151). ``StepControl.order`` defaults to 3.0 accordingly.
  * ``new_h`` is computed from the *unclipped* current h on every attempted
    step, accepted or rejected, and ``prev_h`` tracking/checkpoint restoration
    is handled by the driver (ode.rs:192-205).

Defaults mirror ``ODEAdaptiveData::new_with_defaults`` (ode.rs:114-128):
atol=1e-6, rtol=1e-4, alpha=0.9, min_dt=1e-6, max_dt=1.0.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class StepControl:
    """Static controller configuration (a jit-static argument).

    Mirrors the reference builder methods: ``with_tolerance`` -> rtol/atol,
    ``with_step_range`` -> min_dt/max_dt (ode.rs:267-306), ``with_alpha``
    (ode.rs:129-131).
    """

    rtol: float = 1.0e-4
    atol: float = 1.0e-6
    alpha: float = 0.9
    order: float = 3.0
    min_factor: float = 0.3
    max_factor: float = 2.0
    min_dt: float = 1.0e-6
    max_dt: float = 1.0
    scaled_error: bool = False   # extension: use err/(atol + rtol*|x|) norm
    max_steps: int = 1_000_000
    # surface reject livelocks (h pinned at min_dt, f <= 1 forever) as
    # ERR_STALLED after this many consecutive rejects; 0 = reference
    # behavior (silent livelock until max_steps)
    max_reject_streak: int = 0
    # reference-exact end/grid-hit test: |rem| <= machine eps, UNSCALED
    # (approx::relative_eq(rem, 0) with default epsilon, ode.rs:389-393).
    # The default False uses 4*eps*max(1, |t|) as a defensive margin; in
    # practice the two are behaviorally identical (test-verified to 1e12):
    # dt is truncated to rem = chk - t, which is EXACT near the grid time
    # (Sterbenz), so t + dt lands exactly and rem becomes 0 under either
    # tolerance. The flag exists for bit-level reference compatibility.
    strict_end_test: bool = False
    # opt-in PI (Gustafsson) step control: h *= alpha * f^kI * (f/f_prev)^kP
    # with kI = 0.7/pi_order, kP = 0.4/pi_order, falling back to the I-term
    # right after rejections. pi_order must be the ERROR-decay order
    # (estimator order + 1; 5 for the RKF45/DOPRI5 4th-order estimates) —
    # NOT the reference's order=3 controller quirk, whose large exponents
    # make the PI closed loop linearly unstable (|z| > 1 -> reject cycles).
    pi: bool = False
    pi_order: float = 5.0
    # compensated (double-word / TwoSum) time accumulation: t is carried as
    # a (hi, lo) pair so a 1e4-step f32 solve's time grid matches f64 plain
    # accumulation to ~eps_f32 instead of drifting by ~n*eps_f32. The
    # reference accumulates t PLAINLY in f64 (t += dt, ode.rs:184-188);
    # False reproduces that bit-for-bit (the C++ oracle parity tests use
    # it). Default True: on the f32 path this closes the last fidelity
    # gap with the reference's native f64 regime.
    time_compensated: bool = True

    def __post_init__(self):
        if self.rtol <= 0 or self.atol <= 0:
            raise ValueError(
                f"Invalid tolerances: atol={self.atol}, rtol={self.rtol}"
            )
        if self.min_dt <= 0 or self.max_dt <= 0 or self.max_dt <= self.min_dt:
            raise ValueError(
                f"Invalid step range: ({self.min_dt}, {self.max_dt})"
            )

    def init_h(self) -> float:
        """Default initial step: sqrt(min_dt*max_dt), as the reference's
        ``with_step_range`` (ode.rs:273)."""
        import math

        return math.sqrt(self.min_dt * self.max_dt)


def check_h0(h0, ctl: StepControl, adaptive: bool):
    """``with_init_step`` validation (ode.rs:287-296): in adaptive mode a
    CONCRETE h0 — python/numpy scalar, un-traced jax scalar, or a
    per-trajectory (B,) array of warm starts — must lie inside
    [min_dt, max_dt]; traced values are the caller's contract. Returns the
    (defaulted) h0. Shared by the scalar api and the ensemble path."""
    import numpy as np

    if h0 is None:
        return ctl.init_h()
    if not adaptive:
        return h0
    try:
        arr = np.asarray(h0)
    except Exception:
        return h0  # traced: cannot inspect
    if arr.dtype.kind in "fi" and arr.size and (
        # NaN compares False everywhere: reject non-finite h0 explicitly
        (~np.isfinite(arr.astype(np.float64))).any()
        or (arr < ctl.min_dt).any() or (arr > ctl.max_dt).any()
    ):
        raise ValueError(
            f"Step {h0} is not inside the range "
            f"({ctl.min_dt}, {ctl.max_dt})"
        )
    return h0


def controller_update(h, err_norm, ctl: StepControl, prev_err_norm=None,
                      prev_rejected=None):
    """One controller decision. Returns (new_h, accept).

    Pure elementwise math in the dtype of ``h`` — works per-trajectory under
    vmap. NaN error norms reject the step and shrink by min_factor (the
    reference would propagate NaN; we make divergence recoverable).

    With ``ctl.pi`` and a previous error norm, applies the Gustafsson PI
    factor f^kI (f/f_prev)^kP instead of the reference's pure f^(1/order);
    the accept test (f > 1) is unchanged.
    """
    dtype = jnp.asarray(h).dtype
    rtol = jnp.asarray(ctl.rtol, dtype)
    f = rtol / err_norm  # err_norm == 0 -> inf -> accept, factor clipped to max
    if ctl.pi and prev_err_norm is not None:
        kI = jnp.asarray(0.7 / ctl.pi_order, dtype)
        kP = jnp.asarray(0.4 / ctl.pi_order, dtype)
        f_prev = rtol / prev_err_norm
        # first step / zero history: neutral proportional term
        f_prev = jnp.where(
            jnp.isfinite(f_prev) & (f_prev > 0), f_prev, f
        )
        ratio = jnp.clip(f / f_prev, 1e-8, 1e8)
        # exact-zero error estimates give f = inf -> inf/inf = NaN; treat a
        # perfect step as a neutral proportional term (growth still capped)
        ratio = jnp.where(jnp.isnan(ratio), 1.0, ratio)
        fp_pi = (
            jnp.asarray(ctl.alpha, dtype)
            * jnp.power(f, kI)
            * jnp.power(ratio, kP)
        )
        # after a rejection the history is a rejected attempt: the P-term
        # would see a large f/f_prev and re-grow into another rejection
        # (limit cycle). Standard practice: pure I-term right after rejects,
        # with the METHOD's exponent (1/pi_order — the reference's order=3
        # quirk would re-grow h aggressively, re-entering the cycle).
        fp_i = jnp.asarray(ctl.alpha, dtype) * jnp.power(
            f, jnp.asarray(1.0 / ctl.pi_order, dtype)
        )
        if prev_rejected is not None:
            fp = jnp.where(prev_rejected, fp_i, fp_pi)
        else:
            fp = fp_pi
    else:
        pw = jnp.asarray(1.0 / ctl.order, dtype)
        fp = jnp.asarray(ctl.alpha, dtype) * jnp.power(f, pw)
    fp_lim = jnp.clip(fp, ctl.min_factor, ctl.max_factor)
    bad = jnp.isnan(f)
    fp_lim = jnp.where(bad, jnp.asarray(ctl.min_factor, dtype), fp_lim)
    new_h = jnp.clip(fp_lim * h, ctl.min_dt, ctl.max_dt)
    accept = jnp.logical_and(jnp.logical_not(bad), f > 1.0)
    return new_h, accept


def error_measure(err_norm_fn, x, x_next, err, ctl: StepControl):
    """The scalar the controller compares against rtol.

    Reference mode (default): plain ``||err||`` (rk.rs:312-315).
    ``scaled_error`` mode: ``||err / (atol + rtol*max(|x|,|x_next|))||`` times
    rtol, so the same f = rtol/measure accept test realizes the standard
    mixed-tolerance criterion.
    """
    import jax

    if not ctl.scaled_error:
        return err_norm_fn(err)
    def scale(e, a, b):
        s = ctl.atol + ctl.rtol * jnp.maximum(jnp.abs(a), jnp.abs(b))
        return e / s
    scaled = jax.tree_util.tree_map(scale, err, x, x_next)
    return err_norm_fn(scaled) * ctl.rtol


def end_tolerance(t_ref, strict: bool = False):
    """Absolute tolerance for 'remaining time is zero' tests.

    The reference uses approx::relative_eq(rem, 0) with machine epsilon
    (ode.rs:389-393): against zero the relative clause is vacuous, so it is
    an UNSCALED absolute eps test. The default scales by max(1, |t_ref|)
    as a defensive margin for |t| >> 1; ``strict=True``
    (StepControl.strict_end_test) reproduces the reference bit-for-bit.
    Measured (and explained by Sterbenz exactness of rem = chk - t near the
    grid time) the two behave identically up to |t| ~ 1e12 — see
    tests/test_oracle_parity.py."""
    t_ref = jnp.asarray(t_ref)
    eps = jnp.finfo(t_ref.dtype).eps
    if strict:
        return jnp.full(jnp.shape(t_ref), eps, t_ref.dtype)
    return 4.0 * eps * jnp.maximum(1.0, jnp.abs(t_ref))
