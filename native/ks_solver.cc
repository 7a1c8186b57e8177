// Native host-side Kuramoto–Sivashinsky integrator.
//
// Implements exactly the reference scheme
// (/root/reference/pdegym/kuramoto/kuramoto.py:78-129): 2nd-order one-sided
// upwind differences on u^2 selected by sign(u), 6th-order central u_xx and
// u_xxxx, classic RK4, per-sub-step reward averaged over the control period
// (both objectives, including the truthy-string selection quirk handled by
// the caller).  Double precision, periodic domain.
//
// Exposed through a C ABI (ctypes); see pdecontrol_tpu/utils/native.py.
// Used as (a) an independent golden oracle for the JAX solver and (b) the
// single-core host baseline in bench.py's secondary report.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Effective cross-correlation taps (the reference stores pre-flipped tables
// for scipy.ndimage.convolve1d; these are the post-flip taps).
constexpr double FWD[5] = {-25.0 / 12.0, 4.0, -3.0, 4.0 / 3.0, -1.0 / 4.0};
constexpr double BWD[5] = {25.0 / 12.0, -4.0, 3.0, -4.0 / 3.0, 1.0 / 4.0};
constexpr double D2[7] = {1.0 / 90.0, -3.0 / 20.0, 1.5, -49.0 / 18.0,
                          1.5,        -3.0 / 20.0, 1.0 / 90.0};
constexpr double D4[9] = {7.0 / 240.0,   -2.0 / 5.0, 169.0 / 60.0,
                          -122.0 / 15.0, 91.0 / 8.0, -122.0 / 15.0,
                          169.0 / 60.0,  -2.0 / 5.0, 7.0 / 240.0};

inline int wrap(int i, int n) { return ((i % n) + n) % n; }

struct Workspace {
  std::vector<double> s, ux, uxx, uxxxx, k1, k2, k3, k4, tmp;
  explicit Workspace(int n)
      : s(n), ux(n), uxx(n), uxxxx(n), k1(n), k2(n), k3(n), k4(n), tmp(n) {}
};

void rhs(const double* u, const double* phi, int n, double dx, double* out,
         Workspace& w) {
  const double inv_dx = 1.0 / dx;
  const double inv_dx2 = 1.0 / (dx * dx);
  const double inv_dx4 = inv_dx2 * inv_dx2;

  for (int i = 0; i < n; ++i) w.s[i] = u[i] * u[i];

  for (int i = 0; i < n; ++i) {
    double fwd = 0.0, bwd = 0.0;
    for (int d = 0; d < 5; ++d) {
      fwd += FWD[d] * w.s[wrap(i + d, n)];
      bwd += BWD[d] * w.s[wrap(i - d, n)];
    }
    w.ux[i] = (u[i] < 0.0 ? fwd : bwd) * inv_dx;

    double uxx = 0.0;
    for (int d = -3; d <= 3; ++d) uxx += D2[d + 3] * u[wrap(i + d, n)];
    w.uxx[i] = uxx * inv_dx2;

    double uxxxx = 0.0;
    for (int d = -4; d <= 4; ++d) uxxxx += D4[d + 4] * u[wrap(i + d, n)];
    w.uxxxx[i] = uxxxx * inv_dx4;
  }

  for (int i = 0; i < n; ++i)
    out[i] = -w.uxxxx[i] - w.uxx[i] - 0.5 * w.ux[i] + phi[i];
}

double reward(const double* u, const double* phi, int n, double dx,
              int objective, Workspace& w) {
  if (objective == 0) {  // l2control
    double acc = 0.0;
    for (int i = 0; i < n; ++i) acc += u[i] * u[i];
    return -acc / n;
  }
  // dissipation: derivatives of the *current* state.
  rhs(u, phi, n, dx, w.tmp.data(), w);
  double mxx = 0.0, mx = 0.0, mup = 0.0;
  for (int i = 0; i < n; ++i) {
    mxx += w.uxx[i] * w.uxx[i];
    mx += w.ux[i] * w.ux[i];
    mup += u[i] * phi[i];
  }
  return -(mxx + mx + mup) / n;
}

}  // namespace

extern "C" {

// Advance `batch` independent fields one control period (cfg_steps RK4
// sub-steps) in place; writes the period-mean reward per field.
// objective: 0 = l2control, 1 = dissipation.
void ks_control_period(double* u, const double* phi, double* rewards,
                       int batch, int n, double dx, double dt, int cfg_steps,
                       int objective) {
  Workspace w(n);
  std::vector<double> stage(n);
  for (int b = 0; b < batch; ++b) {
    double* ub = u + static_cast<int64_t>(b) * n;
    const double* pb = phi + static_cast<int64_t>(b) * n;
    double acc = 0.0;
    for (int s = 0; s < cfg_steps; ++s) {
      acc += reward(ub, pb, n, dx, objective, w);
      rhs(ub, pb, n, dx, w.k1.data(), w);
      for (int i = 0; i < n; ++i) stage[i] = ub[i] + dt * w.k1[i] / 2.0;
      rhs(stage.data(), pb, n, dx, w.k2.data(), w);
      for (int i = 0; i < n; ++i) stage[i] = ub[i] + dt * w.k2[i] / 2.0;
      rhs(stage.data(), pb, n, dx, w.k3.data(), w);
      for (int i = 0; i < n; ++i) stage[i] = ub[i] + dt * w.k3[i];
      rhs(stage.data(), pb, n, dx, w.k4.data(), w);
      for (int i = 0; i < n; ++i)
        ub[i] += dt * (w.k1[i] + 2.0 * w.k2[i] + 2.0 * w.k3[i] + w.k4[i]) / 6.0;
    }
    rewards[b] = acc / cfg_steps;
  }
}

// Single RHS evaluation (diagnostics / tests).
void ks_rhs(const double* u, const double* phi, double* out, int n,
            double dx) {
  Workspace w(n);
  rhs(u, phi, n, dx, out, w);
}

}  // extern "C"
