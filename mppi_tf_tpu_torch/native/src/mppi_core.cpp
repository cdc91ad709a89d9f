// Native MPPI core: the information-theoretic update law in portable C++.
//
// TPU-native counterpart of the reference's C++ implementation
// (src/controller_base.cpp:166-308, src/model_base.cpp:53-84,
// src/cost_base.cpp:37-68), which built an explicit TensorFlow graph and ran
// it through a ClientSession per control step. Here the same math is a
// dependency-free double-precision library that serves three roles in the
// framework:
//   1. golden model — the JAX/Pallas paths are parity-tested against it
//      (tests/test_native_core.py), the role the reference's decomposed
//      C++ ops played for its gtest suite (test/test_controller.cpp);
//   2. host fallback — a TPU-less deployment can still run the point-mass
//      controller at full speed (OpenMP over the K samples);
//   3. native runtime — callable from C/C++ embedders without Python.
//
// Deliberately NOT a translation: no graph construction, no sessions; plain
// row-major buffers over a C ABI (ctypes-friendly, no pybind11), the full
// Python-side gamma/upsilon action-cost algebra (cost_base.py:114-170) rather
// than the C++ reference's reduced lam*u^T*Sig^-1*eps form, and the corrected
// receding-horizon carry (the sequence update is returned to the caller;
// SURVEY.md §2.1 defect note).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// y += M (s x n) * x (n), row-major.
inline void matvec_acc(const double* M, const double* x, int64_t rows,
                       int64_t cols, double* y) {
  for (int64_t i = 0; i < rows; ++i) {
    double acc = 0.0;
    const double* row = M + i * cols;
    for (int64_t j = 0; j < cols; ++j) acc += row[j] * x[j];
    y[i] += acc;
  }
}

}  // namespace

extern "C" {

// Softmax update law over precomputed rollout costs.
//   costs:  [k]
//   eps:    [k, tau, adim]  noise realisations
//   wnoise: [tau, adim]     out: sum_k w_k * eps_k
//   stats:  [4]             out: beta, nabla, cost_mean, cost_max
// normalize != 0 applies the (cost-beta)/max(cost-beta) normalisation
// (reference controller_base.py:468-474).
void mppi_update(const double* costs, const double* eps, int64_t k,
                 int64_t tau, int64_t adim, double lam, int normalize,
                 double* wnoise, double* stats) {
  if (k < 1) {  // empty sample set: defined no-op instead of reading
    for (int64_t i = 0; i < tau * adim; ++i) wnoise[i] = 0.0;  // costs[0]
    stats[0] = stats[1] = stats[2] = stats[3] = 0.0;
    return;
  }
  double beta = costs[0], cmax = costs[0], csum = 0.0;
  for (int64_t i = 0; i < k; ++i) {
    beta = std::min(beta, costs[i]);
    cmax = std::max(cmax, costs[i]);
    csum += costs[i];
  }
  double denom = 1.0;
  if (normalize) {
    double m = 0.0;
    for (int64_t i = 0; i < k; ++i) m = std::max(m, costs[i] - beta);
    denom = (m > 0.0) ? m : 1.0;
  }
  double nabla = 0.0;
  std::vector<double> w(static_cast<size_t>(k));
  for (int64_t i = 0; i < k; ++i) {
    w[i] = std::exp(-(costs[i] - beta) / (denom * lam));
    nabla += w[i];
  }
  const int64_t n = tau * adim;
  std::fill(wnoise, wnoise + n, 0.0);
  for (int64_t i = 0; i < k; ++i) {
    const double wi = w[i] / nabla;
    const double* e = eps + i * n;
    for (int64_t j = 0; j < n; ++j) wnoise[j] += wi * e[j];
  }
  stats[0] = beta;
  stats[1] = nabla;
  stats[2] = csum / static_cast<double>(k);
  stats[3] = cmax;
}

// Rollout costs for LTI (point-mass) dynamics + quadratic state cost with
// the full information-theoretic action cost.
//   A:    [sdim, sdim]   Bm: [sdim, adim] (already divided by mass)
//   x0:   [sdim]         useq: [tau, adim]
//   eps:  [k, tau, adim]
//   Q:    [sdim, sdim]   goal: [sdim]     inv_sigma: [adim, adim]
//   costs:[k] out
// Per-step cost: (x'-g)^T Q (x'-g) of the *next* state + action cost
// 0.5*(gamma*(u^T S^-1 u + 2 u^T S^-1 eps) + lam*(1-1/ups)*eps^T S^-1 eps);
// terminal cost = state cost of the final state (cost_base.py:43-170,
// controller_base.py:400-430).
void mppi_pm_rollout(const double* A, const double* Bm, const double* x0,
                     const double* useq, const double* eps, const double* Q,
                     const double* goal, const double* inv_sigma, int64_t k,
                     int64_t tau, int64_t sdim, int64_t adim, double lam,
                     double gamma, double upsilon, double* costs) {
  const double nc = 0.5 * lam * (1.0 - 1.0 / upsilon);

  // per-step action-only terms are sample-independent: precompute
  // 0.5*gamma*u^T S^-1 u and gamma*S^-1 u for each t.
  std::vector<double> su(static_cast<size_t>(tau * adim));
  std::vector<double> u_half(static_cast<size_t>(tau));
  for (int64_t t = 0; t < tau; ++t) {
    const double* u = useq + t * adim;
    double* sut = su.data() + t * adim;
    std::fill(sut, sut + adim, 0.0);
    matvec_acc(inv_sigma, u, adim, adim, sut);
    double q = 0.0;
    for (int64_t j = 0; j < adim; ++j) q += u[j] * sut[j];
    u_half[t] = 0.5 * gamma * q;
  }

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < k; ++i) {
    std::vector<double> x(x0, x0 + sdim), xn(static_cast<size_t>(sdim));
    std::vector<double> v(static_cast<size_t>(adim));
    std::vector<double> qd(static_cast<size_t>(sdim));
    std::vector<double> se(static_cast<size_t>(adim));
    double c = 0.0;
    for (int64_t t = 0; t < tau; ++t) {
      const double* e = eps + (i * tau + t) * adim;
      const double* u = useq + t * adim;
      for (int64_t j = 0; j < adim; ++j) v[j] = u[j] + e[j];
      std::fill(xn.begin(), xn.end(), 0.0);
      matvec_acc(A, x.data(), sdim, sdim, xn.data());
      matvec_acc(Bm, v.data(), sdim, adim, xn.data());
      x.swap(xn);
      // state cost of the next state
      for (int64_t j = 0; j < sdim; ++j) qd[j] = x[j] - goal[j];
      std::fill(xn.begin(), xn.end(), 0.0);
      matvec_acc(Q, qd.data(), sdim, sdim, xn.data());
      for (int64_t j = 0; j < sdim; ++j) c += qd[j] * xn[j];
      // action cost
      c += u_half[t];
      const double* sut = su.data() + t * adim;
      for (int64_t j = 0; j < adim; ++j) c += gamma * sut[j] * e[j];
      if (nc != 0.0) {
        std::fill(se.begin(), se.end(), 0.0);
        matvec_acc(inv_sigma, e, adim, adim, se.data());
        for (int64_t j = 0; j < adim; ++j) c += nc * e[j] * se[j];
      }
    }
    // terminal cost
    for (int64_t j = 0; j < sdim; ++j) qd[j] = x[j] - goal[j];
    std::fill(xn.begin(), xn.end(), 0.0);
    matvec_acc(Q, qd.data(), sdim, sdim, xn.data());
    double phi = 0.0;
    for (int64_t j = 0; j < sdim; ++j) phi += qd[j] * xn[j];
    costs[i] = c + phi;
  }
}

// Full point-mass control step: rollout + update + emit U[0] + shift.
//   action:    [adim] out — the first updated action
//   next_useq: [tau, adim] out — updated sequence shifted left, zero-filled
//   stats:     [4] out (see mppi_update)
// The caller carries next_useq into the next call — the corrected
// receding-horizon semantics (controller_base.cpp:144).
void mppi_pm_solve(const double* A, const double* Bm, const double* x0,
                   const double* useq, const double* eps, const double* Q,
                   const double* goal, const double* inv_sigma, int64_t k,
                   int64_t tau, int64_t sdim, int64_t adim, double lam,
                   double gamma, double upsilon, int normalize, double* action,
                   double* next_useq, double* stats) {
  std::vector<double> costs(static_cast<size_t>(k));
  mppi_pm_rollout(A, Bm, x0, useq, eps, Q, goal, inv_sigma, k, tau, sdim,
                  adim, lam, gamma, upsilon, costs.data());
  std::vector<double> wnoise(static_cast<size_t>(tau * adim));
  mppi_update(costs.data(), eps, k, tau, adim, lam, normalize, wnoise.data(),
              stats);
  for (int64_t j = 0; j < adim; ++j)
    action[j] = useq[j] + wnoise[j];
  // shift: next[t] = updated[t+1], zero-fill the tail
  for (int64_t t = 0; t + 1 < tau; ++t)
    for (int64_t j = 0; j < adim; ++j)
      next_useq[t * adim + j] =
          useq[(t + 1) * adim + j] + wnoise[(t + 1) * adim + j];
  std::memset(next_useq + (tau - 1) * adim, 0, sizeof(double) * adim);
}

}  // extern "C"
