// Cell-list pair tiles of the cutoff-radius force, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gravity_tpu/ops/pallas_nlist.py::_nlist_kernel
// (reached through _pallas_pair_cells), both of its pair kinds. Same
// contract as the plain PyTorch version gravity_tpu_torch/ops/nlist.py::
// pair_cells_plain: for every target slot of every cell of a side^3 grid,
//
//   a_i = sum over the 27 neighbor cells (row-major offsets, the order of
//         ops/cells.py::_near_offsets) of sum_j w_ij (x_j - x_i),
//
// and 0 for target slots past the cell's count, with w_ij by kind:
//
//   newton (kind 0): w = G m_j / (r^2 + eps^2)^{3/2} where cutoff^2 <
//     r^2 + eps^2, r^2 > 0 and (USE_RCUT) r^2 <= params[0] = rcut_eff^2.
//     USE_RCUT false is the tree near field's form (no truncation).
//   ewald (kind 1), the P3M erfc remainder (_ewald_w with p3m.py's
//     _short_range_w): w = G m_j (newt + alpha^3 h(u)/u^2) where r^2 <
//     params[0] = rcut^2 (strict), cutoff^2 < r^2 + eps^2 and r^2 > 0;
//     alpha = params[1], u = alpha sqrt(max(r^2, 1e-30)), newt =
//     rsqrt(max(r^2 + eps^2, 1e-30))^3 and h/u^2 = ((2/sqrt(pi))
//     exp(-u^2) - erf(su)/su) / su^2 with su = max(u, 1e-20), or its
//     series (2/sqrt(pi)) (-2/3 + (2/5) u^2) below u = 0.05.
//
// The params are read from a device pointer: they follow the bounding
// cube every evaluation, and reading them on the host would stall the
// host each step.
//
// What bounds it: FP32-pipe and SFU operations. A newton pair costs ~21
// flops (the JAX cost model, pallas_nlist.py:381) and one rsqrt; an
// ewald pair inside rcut adds a sqrt, erff, expf and two divisions (a
// few tens of FP32 operations and four more SFU operations, counted in
// chip_smoke.py). A cell's sources are read once per neighbor, so device
// memory traffic is O(27 N) bytes against O(27 N * occupancy) pair work;
// at low occupancy (the P3M grids) the dense (side^3, t_cap, 3) output
// and the per-cell fixed cost weigh more.
//
// What held the first version back (one 256-thread block per cell and
// 256 target slots): every thread of a block ran the pair loop past the
// cell's count (248 of 256 at the uniform P3M state, warps 5-7 at the
// README nlist run's ~152 a cell), with two block barriers a neighbor.
// Design: the warp is the unit of work. A work item is (cell, 16 target
// slots), one a warp, 8 warps a block; a warp whose first slot lies at
// or past min(count, t_cap) writes its zeros and leaves, so pair work
// is what the counts need rounded up to 16 slots. Each target takes two
// lanes, which split a neighbor's sources (even and odd slots) and add
// their two partial sums by a shuffle, so a dense cell's chain of pairs
// is half as long. Each warp walks the 27 neighbor offsets itself, so
// the accumulator lives in registers across them (the TPU grid's
// sequential offset axis) and no reduction across warps or blocks is
// needed. A neighbor's sources are staged 64 at a time in the warp's own
// slice of shared memory behind __syncwarp only (no block barrier, so an
// early exit never leaves one waiting) and read as broadcasts by a pair
// loop unrolled by 4. Out-of-grid neighbors are skipped, and so are
// slots past a cell's count (zero-mass padding, an exact no-op). Each
// target sums one neighbor's tile row apart (over its two lanes) and
// then adds it to its accumulator, as the TPU kernel does per grid step;
// this bounds the rounding at ~(cap + 27) ulp of the row's sum of
// |terms|. Tried on the H100 and slower at the README nlist run's and
// the P3M disk's tiles: 8 or 32 slots a warp, several items a warp,
// items numbered slot-group-major, and an ewald loop that gathers each
// warp's in-rcut pairs before taking their weight. Where many pairs lie
// inside rcut (the P3M disk) a warp pays the ewald weight's divisions,
// sqrt, erff and expf on nearly every step of its loop: that issue
// cost, not memory, bounds the kernel there.
//
// r^2 and r^2 + eps^2 are formed with __f*_rn / __d*_rn intrinsics, which
// the compiler never contracts into FMAs, so they round exactly as the
// plain version's separate tensor ops do and the masks (above all
// r^2 <= rcut_eff^2) select the same pairs. The ewald weight keeps the
// plain version's roundings too (sqrt and division are correctly
// rounded without fast math), so u and with it the series switch match;
// erff and expf differ from the plain version's erf and exp by an ulp or
// two. Near rcut the two terms of the ewald weight almost cancel, so its
// error is measured against |newt| + |alpha^3 h/u^2|, not |w|.
// rsqrt takes rsqrt.approx.ftz.f32 (rsqrtf's bits on a normal input,
// without its rescaling of subnormal ones) where its input is provably
// normal: ewald's max(r^2 + eps^2, 1e-30) always, newton's r^2 + eps^2 >
// cutoff^2 (or 1) when cutoff^2 >= FLT_MIN.
//
// Build WITHOUT --use_fast_math: the weight is ((G m inv_r) inv_r) inv_r
// in that order, because inv_r^3 alone underflows in fp32 and a distant
// light pair's weight is subnormal; flushing subnormals would drop it.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 16;             // target slots a warp (a work item)
constexpr int kQ = 32 / kGroup;        // source lanes a target
constexpr int kStage = 64;             // sources a warp stages at once

template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, gm;
};

constexpr int kNewton = 0;
constexpr int kEwald = 1;

// rsqrt on an input known to be normal: rsqrt.approx.ftz.f32 gives the
// same bits as rsqrtf there without its rescaling of subnormal inputs.
template <bool FTZ>
__device__ __forceinline__ float rsqrt_t(float v) {
  if (FTZ) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
  }
  return rsqrtf(v);
}
template <bool FTZ>
__device__ __forceinline__ double rsqrt_t(double v) {
  return rsqrt(v);
}
__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }
__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float erf_t(float v) { return erff(v); }
__device__ __forceinline__ double erf_t(double v) { return erf(v); }
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// newt + alpha^3 h(u)/u^2 of the ewald kind, in the plain version's
// order of operations (ops/nlist.py::_short_range_terms), each step
// rounded on its own.
template <typename T>
__device__ __forceinline__ T ewald_factor(T r2, T r2s, T alpha, T alpha3) {
  const T tiny = T(1e-30);
  const T two_over_sqrt_pi = T(1.1283791670955126);
  const T u = mul_rn(alpha, sqrt_t(r2 > tiny ? r2 : tiny));
  // Its input is at least 1e-30, a normal float.
  T newt = rsqrt_t<true>(r2s > tiny ? r2s : tiny);
  newt = mul_rn(mul_rn(newt, newt), newt);
  T h;
  if (u < T(0.05)) {
    h = mul_rn(two_over_sqrt_pi,
               add_rn(T(-2.0 / 3.0), mul_rn(mul_rn(T(2.0 / 5.0), u), u)));
  } else {
    const T su = u > T(1e-20) ? u : T(1e-20);
    h = div_rn(sub_rn(mul_rn(two_over_sqrt_pi, exp_t(mul_rn(-u, u))),
                      div_rn(erf_t(su), su)),
               mul_rn(su, su));
  }
  return add_rn(newt, mul_rn(alpha3, h));
}

template <typename T, int KIND, bool USE_RCUT, bool FTZ>
__device__ __forceinline__ void pair(const Body<T>& s, T xi, T yi, T zi,
                                     T rcut2, T alpha, T alpha3, T eps2,
                                     T cutoff2, T& tx, T& ty, T& tz) {
  const T dx = s.x - xi;
  const T dy = s.y - yi;
  const T dz = s.z - zi;
  const T r2 =
      add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
  const T r2s = add_rn(r2, eps2);
  bool ok = r2s > cutoff2 && r2 > T(0);
  T w = T(0);
  if (KIND == kNewton) {
    if (USE_RCUT) ok = ok && r2 <= rcut2;
    const T inv_r = rsqrt_t<FTZ>(ok ? r2s : T(1));
    w = ok ? ((s.gm * inv_r) * inv_r) * inv_r : T(0);
  } else if (ok && r2 < rcut2) {
    w = mul_rn(s.gm, ewald_factor(r2, r2s, alpha, alpha3));
  }
  tx += w * dx;
  ty += w * dy;
  tz += w * dz;
}

// Warp v of the grid serves work item v = cell * ceil(t_cap / kGroup) +
// slot group. Lane l serves target slot l / kQ of its item and the
// sources j = l % kQ (mod kQ) of each staged tile.
template <typename T, int KIND, bool USE_RCUT, bool FTZ>
__global__ void __launch_bounds__(kThreads)
    nlist_pair_kernel(const T* __restrict__ tpos,
                      const int64_t* __restrict__ t_count,
                      const T* __restrict__ spos, const T* __restrict__ sgm,
                      const int64_t* __restrict__ s_count, int side,
                      int t_cap, int cap, const T* __restrict__ params,
                      T eps2, T cutoff2, T* __restrict__ out) {
  __shared__ Body<T> stage[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int q = lane % kQ;
  Body<T>* buf = stage[threadIdx.x >> 5];
  const int groups = (t_cap + kGroup - 1) / kGroup;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  if (item >= static_cast<int64_t>(side) * side * side * groups) return;
  const int c = static_cast<int>(item / groups);
  const int first = static_cast<int>(item % groups) * kGroup;
  const int slot = first + lane / kQ;
  const int64_t nt = t_count[c] < t_cap ? t_count[c] : t_cap;
  const int64_t trow = static_cast<int64_t>(c) * t_cap + slot;
  const bool active = slot < nt;
  T ax = T(0), ay = T(0), az = T(0);
  // Warp-uniform: an item whose slots all lie past the count only writes
  // zeros.
  if (first < nt) {
    const T rcut2 = USE_RCUT ? params[0] : T(0);
    const T alpha = KIND == kEwald ? params[1] : T(0);
    const T alpha3 = mul_rn(mul_rn(alpha, alpha), alpha);
    T xi = T(0), yi = T(0), zi = T(0);
    if (active) {
      xi = tpos[3 * trow];
      yi = tpos[3 * trow + 1];
      zi = tpos[3 * trow + 2];
    }
    const int cx = c / (side * side);
    const int cy = (c / side) % side;
    const int cz = c % side;
    for (int o = 0; o < 27; ++o) {
      const int nx = cx + o / 9 - 1;
      const int ny = cy + (o / 3) % 3 - 1;
      const int nz = cz + o % 3 - 1;
      if (nx < 0 || nx >= side || ny < 0 || ny >= side || nz < 0 ||
          nz >= side) {
        continue;
      }
      const int n = (nx * side + ny) * side + nz;
      const int ns = static_cast<int>(s_count[n] < cap ? s_count[n] : cap);
      const int64_t sbase = static_cast<int64_t>(n) * cap;
      T tx = T(0), ty = T(0), tz = T(0);
      for (int base = 0; base < ns; base += kStage) {
        const int jn = min(kStage, ns - base);
        for (int jj = lane; jj < jn; jj += 32) {
          const int64_t j = sbase + base + jj;
          Body<T> b;
          b.x = spos[3 * j];
          b.y = spos[3 * j + 1];
          b.z = spos[3 * j + 2];
          b.gm = sgm[j];
          buf[jj] = b;
        }
        __syncwarp();
#pragma unroll 4
        for (int jj = q; jj < jn; jj += kQ) {
          pair<T, KIND, USE_RCUT, FTZ>(buf[jj], xi, yi, zi, rcut2, alpha,
                                       alpha3, eps2, cutoff2, tx, ty, tz);
        }
        __syncwarp();
      }
      // The kQ source lanes of a target hold this neighbor's partial
      // sums; a butterfly adds them in the same order on every lane.
#pragma unroll
      for (int off = 1; off < kQ; off <<= 1) {
        tx += __shfl_xor_sync(0xffffffffu, tx, off);
        ty += __shfl_xor_sync(0xffffffffu, ty, off);
        tz += __shfl_xor_sync(0xffffffffu, tz, off);
      }
      ax += tx;
      ay += ty;
      az += tz;
    }
  }
  if (q == 0 && slot < t_cap) {
    out[3 * trow] = active ? ax : T(0);
    out[3 * trow + 1] = active ? ay : T(0);
    out[3 * trow + 2] = active ? az : T(0);
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const int64_t*, const T*, const T*,
                          const int64_t*, int, int, int, const T*, T, T, T*);

// The instantiation a launch takes. The newton kind's rsqrt input is
// r^2 + eps^2 > cutoff^2, or 1, so normal when cutoff^2 >= FLT_MIN.
template <typename T>
KernelFn<T> pick_kernel(int kind, int use_rcut, double cutoff2) {
  if (kind == kEwald) {
    // The ewald kind always truncates at rcut.
    return nlist_pair_kernel<T, kEwald, true, false>;
  }
  if constexpr (sizeof(T) == 4) {
    if (cutoff2 >= FLT_MIN) {
      return use_rcut ? nlist_pair_kernel<T, kNewton, true, true>
                      : nlist_pair_kernel<T, kNewton, false, true>;
    }
  }
  return use_rcut ? nlist_pair_kernel<T, kNewton, true, false>
                  : nlist_pair_kernel<T, kNewton, false, false>;
}

template <typename T>
int launch(const void* tpos, const void* t_count, const void* spos,
           const void* sgm, const void* s_count, int side, int t_cap, int cap,
           const void* params, double eps2, double cutoff2, int use_rcut,
           int kind, void* out, void* stream) {
  if (kind != kNewton && kind != kEwald) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (side <= 0 || t_cap <= 0) return 0;
  const int64_t n_items = static_cast<int64_t>(side) * side * side *
                          ((t_cap + kGroup - 1) / kGroup);
  const unsigned grid = static_cast<unsigned>((n_items + kWarps - 1) /
                                              kWarps);
  pick_kernel<T>(kind, use_rcut, cutoff2)<<<
      grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(tpos), static_cast<const int64_t*>(t_count),
      static_cast<const T*>(spos), static_cast<const T*>(sgm),
      static_cast<const int64_t*>(s_count), side, t_cap, cap,
      static_cast<const T*>(params), static_cast<T>(eps2),
      static_cast<T>(cutoff2), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/nlist.py). Device pointers of
// contiguous arrays: tpos (side^3, t_cap, 3), t_count (side^3,) int64,
// spos (side^3, cap, 3), sgm (side^3, cap) holding G * m, s_count
// (side^3,) int64, params holding rcut_eff^2 (kind 0, newton) or
// [rcut^2, alpha] (kind 1, ewald), out (side^3, t_cap, 3). eps2 and
// cutoff2 arrive already rounded to the element type. Returns the
// launch's cudaGetLastError() as an int (cudaErrorInvalidValue for an
// unknown kind).
extern "C" int nlist_pair_f32(const void* tpos, const void* t_count,
                              const void* spos, const void* sgm,
                              const void* s_count, int side, int t_cap,
                              int cap, const void* params, double eps2,
                              double cutoff2, int use_rcut, int kind,
                              void* out, void* stream) {
  return launch<float>(tpos, t_count, spos, sgm, s_count, side, t_cap, cap,
                       params, eps2, cutoff2, use_rcut, kind, out, stream);
}

extern "C" int nlist_pair_f64(const void* tpos, const void* t_count,
                              const void* spos, const void* sgm,
                              const void* s_count, int side, int t_cap,
                              int cap, const void* params, double eps2,
                              double cutoff2, int use_rcut, int kind,
                              void* out, void* stream) {
  return launch<double>(tpos, t_count, spos, sgm, s_count, side, t_cap, cap,
                        params, eps2, cutoff2, use_rcut, kind, out, stream);
}

extern "C" const char* nlist_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
