// The host-native direct sum: a multithreaded float32/float64 row sum on
// the CPU, with a plain C interface bound by ctypes
// (gravity_tpu_torch/ops/host_kernel.py, built with g++ by
// gravity_tpu_torch/ops/host_build.py).
//
// Counterpart of the JAX package's XLA-FFI custom call
// runtime/ffi_forces.cpp (AccelRows, AccelThreaded): the same loop under
// the same decomposition, without the XLA headers. It replaces no TPU
// kernel; it is the CPU's fast fp64 oracle and its mid-N direct sum
// (force_backend="cpp").
//
// Contract (that of gravity_tpu_torch/ops/forces.py::accelerations_vs):
//   a_i = sum_j G m_j (x_j - x_i) / (r^2 + eps^2)^(3/2),
//   and a pair with r^2 + eps^2 <= cutoff^2 contributes nothing (the
//   cutoff is on the SOFTENED r^2, which also covers the r == 0 self-pair).
//
// Kept exactly as the JAX kernel has it, so that both give the same bits:
// - one thread a slice of rows, at least 64 rows a thread, at most
//   hardware_concurrency() threads; each thread owns its rows' full sums
//   over every source, in source order, so no accumulator is shared;
// - cutoff, eps and G come in as doubles and are rounded to the element
//   type before they are squared;
// - the weight is ((G m_j) inv_r) inv_r inv_r: G m_j is folded in before
//   1/r is cubed, so that an fp32 weight of a light, distant pair never
//   passes through a subnormal inv_r^3 (at r ~ 1e16 m, inv_r^3 = 1e-48
//   rounds to zero in fp32).
// Built without -ffast-math and with -ffp-contract=off: no reassociation
// and no fused multiply-add, on any host.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

enum Status : int {
  kOk = 0,
  kBadShape = 1,
  kThreadFailed = 2,
};

template <typename T>
void AccelRows(const T* pi, const T* pj, const T* mj, T* out, int64_t k,
               double g, double cutoff, double eps, int64_t row0,
               int64_t row1) {
  const T c2 = static_cast<T>(cutoff) * static_cast<T>(cutoff);
  const T e2 = static_cast<T>(eps) * static_cast<T>(eps);
  const T gt = static_cast<T>(g);
  for (int64_t i = row0; i < row1; ++i) {
    const T xi = pi[3 * i], yi = pi[3 * i + 1], zi = pi[3 * i + 2];
    T ax = 0, ay = 0, az = 0;
    for (int64_t j = 0; j < k; ++j) {
      const T dx = pj[3 * j] - xi;
      const T dy = pj[3 * j + 1] - yi;
      const T dz = pj[3 * j + 2] - zi;
      const T r2 = dx * dx + dy * dy + dz * dz + e2;
      if (r2 <= c2) continue;  // the cutoff (covers the r == 0 self-pair)
      const T inv_r = T(1) / std::sqrt(r2);
      const T w = ((gt * mj[j]) * inv_r) * inv_r * inv_r;
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
    out[3 * i] = ax;
    out[3 * i + 1] = ay;
    out[3 * i + 2] = az;
  }
}

// The threads a call of m rows runs on: one a slice of at least 64 rows,
// at most hardware_concurrency().
int64_t Threads(int64_t m) {
  const int64_t min_rows_per_thread = 64;
  const int64_t want = (m + min_rows_per_thread - 1) / min_rows_per_thread;
  const int64_t hw =
      static_cast<int64_t>(std::thread::hardware_concurrency());
  return std::max<int64_t>(1, std::min(want, std::max<int64_t>(1, hw)));
}

template <typename T>
int AccelThreaded(const T* pi, const T* pj, const T* mj, T* out, int64_t m,
                  int64_t k, double g, double cutoff, double eps) {
  if (m < 0 || k < 0) return kBadShape;
  const int64_t nthreads = Threads(m);
  if (nthreads == 1) {
    AccelRows(pi, pj, mj, out, k, g, cutoff, eps, 0, m);
    return kOk;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  const int64_t rows = (m + nthreads - 1) / nthreads;
  int status = kOk;
  try {
    for (int64_t t = 0; t < nthreads; ++t) {
      const int64_t r0 = t * rows;
      const int64_t r1 = std::min(m, r0 + rows);
      if (r0 >= r1) break;
      threads.emplace_back(AccelRows<T>, pi, pj, mj, out, k, g, cutoff, eps,
                           r0, r1);
    }
  } catch (...) {
    // A thread that could not start: the rows it owned are not written.
    status = kThreadFailed;
  }
  for (auto& th : threads) th.join();
  return status;
}

}  // namespace

// acc (m, 3) = the accelerations on pos_i (m, 3) from pos_j (k, 3) and
// masses_j (k,), all contiguous, row-major, of one element type. Returns 0,
// or a code that host_forces_error_string names.
extern "C" int host_forces_f32(const float* pos_i, const float* pos_j,
                               const float* masses_j, float* acc, int64_t m,
                               int64_t k, double g, double cutoff,
                               double eps) {
  return AccelThreaded(pos_i, pos_j, masses_j, acc, m, k, g, cutoff, eps);
}

extern "C" int host_forces_f64(const double* pos_i, const double* pos_j,
                               const double* masses_j, double* acc,
                               int64_t m, int64_t k, double g, double cutoff,
                               double eps) {
  return AccelThreaded(pos_i, pos_j, masses_j, acc, m, k, g, cutoff, eps);
}

// The threads a call of m rows runs on.
extern "C" int64_t host_forces_threads(int64_t m) { return Threads(m); }

extern "C" const char* host_forces_error_string(int code) {
  switch (code) {
    case kOk:
      return "no error";
    case kBadShape:
      return "negative row or source count";
    case kThreadFailed:
      return "a worker thread could not be started";
    default:
      return "unknown error";
  }
}
