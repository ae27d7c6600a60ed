// vecode_oracle: C++ implementation of the reference's adaptive RKF45
// integration semantics, used as an independent cross-language parity oracle
// for the JAX framework's controller/driver (tests/test_oracle_parity.py).
//
// Semantics reproduced from /root/reference (Rust), re-implemented here:
//   * Fehlberg RKF45 tableau (dat/mod.rs:9-27), both the reference's literal
//     a[5][2] = -3544/2526 and the corrected -3544/2565 (flag).
//   * rk_step stage loop (base/rk.rs:90-155): adaptive advances the
//     LOWER-order (b_err) solution, err = x5 - x4.
//   * step controller (base/ode.rs:311-334): f = rtol/||err||,
//     fp = clamp(alpha * f^(1/3), 0.3, 2.0), h = clamp(fp*h, min_dt, max_dt),
//     reject iff f <= 1; atol ignored (reference quirk).
//   * t_list = [t0, tf] grid hitting with dt truncation and prev_h
//     restoration (base/ode.rs:165-205).
//
// Exposed as a C ABI for ctypes. Linear RHS y' = A y (row-major A) keeps the
// oracle callback-free; an event trace (1=step, 2=chkpt, 3=reject, 4=end)
// is returned for exact controller-sequence comparison.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// approx::relative_eq(a, b, epsilon, max_relative) for f64 defaults —
// transcribed INDEPENDENTLY from the approx crate's documented semantics
// (the reference calls it with b = 0 in check_step, base/ode.rs:389-393):
//   |a - b| <= epsilon                       (absolute clause)
//   || |a - b| <= max_relative * max(|a|,|b|) (relative clause)
// Against b = 0 the relative clause only holds for a == 0, so the test is
// effectively |rem| <= DBL_EPSILON.
bool relative_eq_zero(double a) {
  const double abs_diff = std::fabs(a);
  if (abs_diff <= DBL_EPSILON) return true;
  return abs_diff <= DBL_EPSILON * std::fabs(a);
}

struct Tableau {
  double a[6][6];
  double b[6];
  double berr[6];
  double c[6];
};

Tableau make_rkf45(bool reference_typo) {
  Tableau t{};
  const double a52 = reference_typo ? -3544.0 / 2526.0 : -3544.0 / 2565.0;
  const double araw[6][6] = {
      {0, 0, 0, 0, 0, 0},
      {1.0 / 4, 0, 0, 0, 0, 0},
      {3.0 / 32, 9.0 / 32, 0, 0, 0, 0},
      {1932.0 / 2197, -7200.0 / 2197, 7296.0 / 2197, 0, 0, 0},
      {439.0 / 216, -8.0, 3680.0 / 513, -845.0 / 4104, 0, 0},
      {-8.0 / 27, 2.0, a52, 1859.0 / 4104, -11.0 / 40, 0},
  };
  std::memcpy(t.a, araw, sizeof(araw));
  const double b[6] = {16.0 / 135, 0.0, 6656.0 / 12825, 28561.0 / 56430,
                       -9.0 / 50, 2.0 / 55};
  const double berr[6] = {25.0 / 216, 0.0, 1408.0 / 2565, 2197.0 / 4104,
                          -1.0 / 5, 0.0};
  const double c[6] = {0.0, 1.0 / 4, 3.0 / 8, 12.0 / 13, 1.0, 1.0 / 2};
  std::memcpy(t.b, b, sizeof(b));
  std::memcpy(t.berr, berr, sizeof(berr));
  std::memcpy(t.c, c, sizeof(c));
  return t;
}

// y' = A y, row-major A.
void matvec(int d, const double* A, const double* y, double* out) {
  for (int i = 0; i < d; ++i) {
    double acc = 0.0;
    const double* row = A + static_cast<size_t>(i) * d;
    for (int j = 0; j < d; ++j) acc += row[j] * y[j];
    out[i] = acc;
  }
}

// The reference's user NormFn contract (ExpCFMSolver, cfm.rs:131-155):
// an arbitrary error measure applied by the solver to the embedded error
// vector. This oracle implements the practical family the rebuild's
// lc.WeightedNorm declares: weighted l2 (kind 0), rms (1), max (2);
// weights == nullptr means all-ones.
double user_norm(int d, const double* v, const double* wts, int kind) {
  if (kind == 2) {
    double mx = 0.0;
    for (int k = 0; k < d; ++k) {
      const double e = std::fabs(wts ? wts[k] * v[k] : v[k]);
      if (e > mx) mx = e;
    }
    return mx;
  }
  double acc = 0.0;
  for (int k = 0; k < d; ++k) {
    const double e = wts ? wts[k] * v[k] : v[k];
    acc += e * e;
  }
  double n = std::sqrt(acc);
  if (kind == 1) n /= std::sqrt(static_cast<double>(d));
  return n;
}

double norm2(int d, const double* v) {
  double acc = 0.0;
  for (int i = 0; i < d; ++i) acc += v[i] * v[i];
  return std::sqrt(acc);
}

}  // namespace

void matmul(int d, const double* A, const double* B, double* out) {
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j < d; ++j) {
      double acc = 0.0;
      for (int k = 0; k < d; ++k) {
        acc += A[static_cast<size_t>(i) * d + k] *
               B[static_cast<size_t>(k) * d + j];
      }
      out[static_cast<size_t>(i) * d + j] = acc;
    }
  }
}

// y <- e^M y via scaling + degree-20 Taylor ACTION (||M_s||_1 <= 0.25 puts
// the truncation at ~1e-32, far below f64 eps). Independent of the JAX
// implementation (Pade-13 in f64, Taylor-12 in f32).
void expmv(int d, const double* M, double* y) {
  double nrm = 0.0;
  for (int j = 0; j < d; ++j) {
    double col = 0.0;
    for (int i = 0; i < d; ++i)
      col += std::fabs(M[static_cast<size_t>(i) * d + j]);
    nrm = std::max(nrm, col);
  }
  int s = 0;
  while (nrm > 0.25 && s < 60) {
    nrm *= 0.5;
    ++s;
  }
  const double scale = std::ldexp(1.0, -s);
  std::vector<double> Ms(static_cast<size_t>(d) * d);
  for (size_t i = 0; i < Ms.size(); ++i) Ms[i] = M[i] * scale;
  std::vector<double> acc(d), term(d), tmp(d);
  const int n_pass = 1 << s;
  for (int p = 0; p < n_pass; ++p) {
    for (int k = 0; k < d; ++k) acc[k] = term[k] = y[k];
    for (int j = 1; j <= 20; ++j) {
      matvec(d, Ms.data(), term.data(), tmp.data());
      for (int k = 0; k < d; ++k) {
        term[k] = tmp[k] / j;
        acc[k] += term[k];
      }
    }
    for (int k = 0; k < d; ++k) y[k] = acc[k];
  }
}

extern "C" {

// Returns final status: 1 = done, 2 = max_steps exhausted.
// events (optional, len >= max_steps): per-iteration event codes.
int vecode_solve_linear_rkf45(
    int dim, const double* A, const double* y0, double t0, double tf,
    double h0, double rtol, double min_dt, double max_dt, double alpha,
    double order, int adaptive, int reference_typo, int advance_lower,
    int strict_end, int max_steps,
    // outputs
    double* y_final, double* t_final, double* h_final, int* n_accept,
    int* n_reject, int* n_events, int8_t* events) {
  const Tableau tab = make_rkf45(reference_typo != 0);
  std::vector<double> x(y0, y0 + dim), xs(dim), xf(dim), err(dim);
  std::vector<std::vector<double>> K(6, std::vector<double>(dim));

  double t = t0, h = h0, prev_h = h0;
  int tgt = 0;  // t_list = [t0, tf]; cursor starts at t0 (reference ode.rs:144)
  const double t_list[2] = {t0, tf};
  int acc_n = 0, rej_n = 0, ev_n = 0;
  const double pw = 1.0 / order;

  for (int it = 0; it < max_steps; ++it) {
    // step_size_of (ode.rs:165-176)
    if (tgt > 1) break;  // End already consumed
    const double chk = t_list[tgt];
    const double rem = chk - t;
    bool at_grid;
    if (strict_end) {
      // reference-exact: approx::relative_eq(rem, 0) (ode.rs:391)
      at_grid = relative_eq_zero(rem);
    } else {
      const double end_eps =
          4.0 * 2.220446049250313e-16 * std::max(1.0, std::fabs(chk));
      at_grid = std::fabs(rem) <= end_eps;
    }
    if (at_grid) {
      // Chkpt or End (checkpoint_update: tgt+=1, h = prev_h, ode.rs:192-195)
      tgt += 1;
      h = prev_h;
      if (events) events[ev_n] = (tgt > 1) ? 4 : 2;
      ev_n++;
      if (tgt > 1) break;  // End -> Done
      continue;
    }
    double dt = std::min(h, rem);

    // rk_step (rk.rs:90-155)
    matvec(dim, A, x.data(), K[0].data());
    for (int i = 1; i < 6; ++i) {
      for (int k = 0; k < dim; ++k) {
        double acc = 0.0;
        for (int j = 0; j < i; ++j) acc += tab.a[i][j] * K[j][k];
        xs[k] = x[k] + dt * acc;
      }
      matvec(dim, A, xs.data(), K[i].data());
    }
    for (int k = 0; k < dim; ++k) {
      double accb = 0.0, acce = 0.0;
      for (int j = 0; j < 6; ++j) {
        accb += tab.b[j] * K[j][k];
        acce += (tab.b[j] - tab.berr[j]) * K[j][k];
      }
      const double xb = x[k] + dt * accb;
      err[k] = dt * acce;
      xf[k] = advance_lower ? (xb - err[k]) : xb;
    }

    bool do_accept = true;
    if (adaptive) {
      // handle_step_adaptive (ode.rs:311-334)
      const double dx_norm = norm2(dim, err.data());
      const double f = rtol / dx_norm;  // inf if dx_norm == 0
      double fp = alpha * std::pow(f, pw);
      fp = std::min(std::max(fp, 0.3), 2.0);
      const double new_h = std::min(std::max(fp * h, min_dt), max_dt);
      prev_h = h;
      h = new_h;
      do_accept = f > 1.0;
    }
    if (do_accept) {
      x = xf;
      t += dt;
      ++acc_n;
      if (events) events[ev_n] = 1;
    } else {
      ++rej_n;
      if (events) events[ev_n] = 3;
    }
    ev_n++;
  }

  std::memcpy(y_final, x.data(), sizeof(double) * dim);
  *t_final = t;
  *h_final = h;
  *n_accept = acc_n;
  *n_reject = rej_n;
  *n_events = ev_n;
  return (tgt > 1) ? 1 : 2;
}

// Adaptive Magnus-4 on the driven linear system y' = (A0 + cos(w t) A1) y
// — semantics of the reference's magnus_42 kernel (exp/magnus.rs:28-83)
// with the INTENDED error wiring (the real err vector reaches the
// controller; the reference's stale-norm bug is documented in
// exp/magnus.py), inside the same t_list driver loop as the RK oracle:
//   t1,2 = t + dt/2 -/+ dt/(2 sqrt 3)   (GL2 nodes, magnus.rs:42)
//   Om   = (A(t1)+A(t2)) dt/2 - (sqrt(3)/12) dt^2 [A(t1), A(t2)]
//   x_hi = e^{Om} x ; err = e^{w1} x - x_hi  (w1 = order-2 part)
int vecode_solve_linear_magnus4(
    int dim, const double* A0, const double* A1, double w,
    const double* y0, double t0, double tf,
    double h0, double rtol, double min_dt, double max_dt, double alpha,
    double order, int adaptive, int strict_end, int max_steps,
    // user NormFn (cfm.rs:131-155 contract): nullptr weights = plain l2
    const double* norm_weights, int norm_kind,
    // outputs
    double* y_final, double* t_final, double* h_final, int* n_accept,
    int* n_reject, int* n_events, int8_t* events) {
  const size_t dd = static_cast<size_t>(dim) * dim;
  const double c_mid = 0.5 / std::sqrt(3.0);
  const double b2 = -std::sqrt(3.0) / 12.0;
  std::vector<double> x(y0, y0 + dim), x_hi(dim), x_lo(dim), err(dim);
  std::vector<double> L1(dd), L2(dd), C1(dd), C2(dd), Om(dd), W1(dd);

  auto assemble = [&](double t, double* out) {
    const double c = std::cos(w * t);
    for (size_t i = 0; i < dd; ++i) out[i] = A0[i] + c * A1[i];
  };

  double t = t0, h = h0, prev_h = h0;
  int tgt = 0;
  const double t_list[2] = {t0, tf};
  int acc_n = 0, rej_n = 0, ev_n = 0;
  const double pw = 1.0 / order;

  for (int it = 0; it < max_steps; ++it) {
    if (tgt > 1) break;
    const double chk = t_list[tgt];
    const double rem = chk - t;
    bool at_grid;
    if (strict_end) {
      at_grid = relative_eq_zero(rem);
    } else {
      const double end_eps =
          4.0 * 2.220446049250313e-16 * std::max(1.0, std::fabs(chk));
      at_grid = std::fabs(rem) <= end_eps;
    }
    if (at_grid) {
      tgt += 1;
      h = prev_h;
      if (events) events[ev_n] = (tgt > 1) ? 4 : 2;
      ev_n++;
      if (tgt > 1) break;
      continue;
    }
    const double dt = std::min(h, rem);

    // magnus_42 (exp/magnus.rs:28-83)
    const double tm = t + 0.5 * dt;
    assemble(tm - c_mid * dt, L1.data());
    assemble(tm + c_mid * dt, L2.data());
    matmul(dim, L1.data(), L2.data(), C1.data());
    matmul(dim, L2.data(), L1.data(), C2.data());
    for (size_t i = 0; i < dd; ++i) {
      W1[i] = 0.5 * dt * (L1[i] + L2[i]);
      Om[i] = W1[i] + b2 * dt * dt * (C1[i] - C2[i]);
    }
    x_hi = x;
    expmv(dim, Om.data(), x_hi.data());

    bool do_accept = true;
    if (adaptive) {
      x_lo = x;
      expmv(dim, W1.data(), x_lo.data());
      for (int k = 0; k < dim; ++k) err[k] = x_lo[k] - x_hi[k];
      const double dx_norm =
          user_norm(dim, err.data(), norm_weights, norm_kind);
      const double f = rtol / dx_norm;
      double fp = alpha * std::pow(f, pw);
      fp = std::min(std::max(fp, 0.3), 2.0);
      const double new_h = std::min(std::max(fp * h, min_dt), max_dt);
      prev_h = h;
      h = new_h;
      do_accept = f > 1.0;
    }
    if (do_accept) {
      x = x_hi;
      t += dt;
      ++acc_n;
      if (events) events[ev_n] = 1;
    } else {
      ++rej_n;
      if (events) events[ev_n] = 3;
    }
    ev_n++;
  }

  std::memcpy(y_final, x.data(), sizeof(double) * dim);
  *t_final = t;
  *h_final = h;
  *n_accept = acc_n;
  *n_reject = rej_n;
  *n_events = ev_n;
  return (tgt > 1) ? 1 : 2;
}

// Adaptive commutator-free Magnus-4 on the driven linear system
// y' = (A0 + cos(w t) A1) y — semantics of the reference's cfm_general
// with the ExpCFMSolver configuration (exp/cfm.rs:43-100, 131-155):
//   t1,2 = t + c_j dt, c = GL2 nodes on [0, 1]        (dat/mod.rs:4)
//   rho_i = dt (alpha[i][1] A(t1) + alpha[i][2] A(t2)),
//     alpha = CFM_R4_J2_GL = [[1/4 + r3/6, 1/4 - r3/6],
//                             [1/4 - r3/6, 1/4 + r3/6]] (dat/mod.rs:70-74)
//   x_hi = e^{rho_1} e^{rho_0} x
//   err  = e^{dt (A(t1)+A(t2))/2} x - x_hi   (CFM_R2_J1_GL error pass,
//     cfm.rs:83-97; the reference wires this solver's norm correctly)
int vecode_solve_linear_cfm4(
    int dim, const double* A0, const double* A1, double w,
    const double* y0, double t0, double tf,
    double h0, double rtol, double min_dt, double max_dt, double alpha_c,
    double order, int adaptive, int strict_end, int max_steps,
    // user NormFn (cfm.rs:131-155 contract): nullptr weights = plain l2
    const double* norm_weights, int norm_kind,
    // outputs
    double* y_final, double* t_final, double* h_final, int* n_accept,
    int* n_reject, int* n_events, int8_t* events) {
  const size_t dd = static_cast<size_t>(dim) * dim;
  const double r3_6 = std::sqrt(3.0) / 6.0;
  const double al[2][2] = {{0.25 + r3_6, 0.25 - r3_6},
                           {0.25 - r3_6, 0.25 + r3_6}};
  const double c1 = 0.5 - 0.5 / std::sqrt(3.0);
  const double c2 = 0.5 + 0.5 / std::sqrt(3.0);
  std::vector<double> x(y0, y0 + dim), x_hi(dim), x_lo(dim), err(dim);
  std::vector<double> L1(dd), L2(dd), R(dd);

  auto assemble = [&](double t, double* out) {
    const double c = std::cos(w * t);
    for (size_t i = 0; i < dd; ++i) out[i] = A0[i] + c * A1[i];
  };

  double t = t0, h = h0, prev_h = h0;
  int tgt = 0;
  const double t_list[2] = {t0, tf};
  int acc_n = 0, rej_n = 0, ev_n = 0;
  const double pw = 1.0 / order;

  for (int it = 0; it < max_steps; ++it) {
    if (tgt > 1) break;
    const double chk = t_list[tgt];
    const double rem = chk - t;
    bool at_grid;
    if (strict_end) {
      at_grid = relative_eq_zero(rem);
    } else {
      const double end_eps =
          4.0 * 2.220446049250313e-16 * std::max(1.0, std::fabs(chk));
      at_grid = std::fabs(rem) <= end_eps;
    }
    if (at_grid) {
      tgt += 1;
      h = prev_h;
      if (events) events[ev_n] = (tgt > 1) ? 4 : 2;
      ev_n++;
      if (tgt > 1) break;
      continue;
    }
    const double dt = std::min(h, rem);

    assemble(t + c1 * dt, L1.data());
    assemble(t + c2 * dt, L2.data());
    x_hi = x;
    for (int i = 0; i < 2; ++i) {
      for (size_t k = 0; k < dd; ++k)
        R[k] = dt * (al[i][0] * L1[k] + al[i][1] * L2[k]);
      expmv(dim, R.data(), x_hi.data());
    }

    bool do_accept = true;
    if (adaptive) {
      for (size_t k = 0; k < dd; ++k) R[k] = dt * 0.5 * (L1[k] + L2[k]);
      x_lo = x;
      expmv(dim, R.data(), x_lo.data());
      for (int k = 0; k < dim; ++k) err[k] = x_lo[k] - x_hi[k];
      const double dx_norm =
          user_norm(dim, err.data(), norm_weights, norm_kind);
      const double f = rtol / dx_norm;
      double fp = alpha_c * std::pow(f, pw);
      fp = std::min(std::max(fp, 0.3), 2.0);
      const double new_h = std::min(std::max(fp * h, min_dt), max_dt);
      prev_h = h;
      h = new_h;
      do_accept = f > 1.0;
    }
    if (do_accept) {
      x = x_hi;
      t += dt;
      ++acc_n;
      if (events) events[ev_n] = 1;
    } else {
      ++rej_n;
      if (events) events[ev_n] = 3;
    }
    ev_n++;
  }

  std::memcpy(y_final, x.data(), sizeof(double) * dim);
  *t_final = t;
  *h_final = h;
  *n_accept = acc_n;
  *n_reject = rej_n;
  *n_events = ev_n;
  return (tgt > 1) ? 1 : 2;
}

// Standalone controller decision for table-driven parity tests
// (ode.rs:311-334). Returns 1=accept, 0=reject; writes new_h.
int vecode_controller_update(double h, double dx_norm, double rtol,
                             double alpha, double order, double min_dt,
                             double max_dt, double* new_h) {
  const double f = rtol / dx_norm;
  double fp = alpha * std::pow(f, 1.0 / order);
  fp = std::min(std::max(fp, 0.3), 2.0);
  *new_h = std::min(std::max(fp * h, min_dt), max_dt);
  return f > 1.0 ? 1 : 0;
}

}  // extern "C"
