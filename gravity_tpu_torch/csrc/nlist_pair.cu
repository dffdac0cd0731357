// Cell-list pair tiles of the cutoff-radius force, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gravity_tpu/ops/pallas_nlist.py::_nlist_kernel
// (reached through _pallas_pair_cells), kind "newton". Same contract as
// the plain PyTorch version gravity_tpu_torch/ops/nlist.py::
// pair_cells_plain: for every target slot of every cell of a side^3 grid,
//
//   a_i = sum over the 27 neighbor cells (row-major offsets, the order of
//         ops/cells.py::_near_offsets) of sum_j w_ij (x_j - x_i),
//   w_ij = G m_j / (r^2 + eps^2)^{3/2}  where cutoff^2 < r^2 + eps^2,
//          r^2 > 0 and (USE_RCUT) r^2 <= params[0] = rcut_eff^2,
//
// and 0 for target slots past the cell's count. USE_RCUT false is the
// tree near field's form (no truncation). rcut_eff^2 is read from a
// device pointer: it follows the bounding cube every evaluation, and
// reading it on the host would stall the host each step.
//
// What bounds it: FP32-pipe and SFU operations. Each pair costs ~21
// flops (the JAX cost model, pallas_nlist.py:381) and one rsqrt; a
// cell's sources are read once per neighbor, so device memory traffic is
// O(27 N) bytes against O(27 N * occupancy) pair work.
// Design: one block per (target cell, 256 target slots), one thread per
// target slot. The block walks the 27 neighbor offsets itself, so the
// accumulator lives in registers across them (the TPU grid's sequential
// offset axis) and no reduction across blocks is needed. Each neighbor's
// sources are staged in shared memory, 256 at a time, and read by every
// thread as a broadcast. Out-of-grid neighbors are skipped, and so are
// slots past a cell's count (zero-mass padding, an exact no-op), so the
// work is what the occupancy needs, not side^3 * 27 * t_cap * cap. Each
// thread sums one neighbor's tile row apart and then adds it to its
// accumulator, as the TPU kernel does per grid step; this bounds the
// rounding at ~(cap + 27) ulp of the row's sum of |terms|.
//
// r^2 and r^2 + eps^2 are formed with __f*_rn / __d*_rn intrinsics, which
// the compiler never contracts into FMAs, so they round exactly as the
// plain version's separate tensor ops do and the masks (above all
// r^2 <= rcut_eff^2) select the same pairs.
//
// Build WITHOUT --use_fast_math: the weight is ((G m inv_r) inv_r) inv_r
// in that order, because inv_r^3 alone underflows in fp32 and a distant
// light pair's weight is subnormal; flushing subnormals would drop it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, gm;
};

__device__ __forceinline__ float rsqrt_t(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_t(double v) { return rsqrt(v); }
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

template <typename T, bool USE_RCUT>
__global__ void __launch_bounds__(kBlock)
    nlist_pair_kernel(const T* __restrict__ tpos,
                      const int64_t* __restrict__ t_count,
                      const T* __restrict__ spos, const T* __restrict__ sgm,
                      const int64_t* __restrict__ s_count, int side,
                      int t_cap, int cap, const T* __restrict__ params,
                      T eps2, T cutoff2, T* __restrict__ out) {
  __shared__ Body<T> tile[kBlock];
  const int c = blockIdx.x;
  const int slot = blockIdx.y * kBlock + threadIdx.x;
  const int64_t nt = t_count[c] < t_cap ? t_count[c] : t_cap;
  const bool active = slot < nt;
  const int64_t trow = static_cast<int64_t>(c) * t_cap + slot;
  T xi = T(0), yi = T(0), zi = T(0);
  if (active) {
    xi = tpos[3 * trow];
    yi = tpos[3 * trow + 1];
    zi = tpos[3 * trow + 2];
  }
  const T rcut2 = USE_RCUT ? params[0] : T(0);
  const int cx = c / (side * side);
  const int cy = (c / side) % side;
  const int cz = c % side;
  T ax = T(0), ay = T(0), az = T(0);
  // Block-uniform: a block whose slots all lie past the count only
  // writes zeros.
  if (static_cast<int64_t>(blockIdx.y) * kBlock < nt) {
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
      for (int base = 0; base < ns; base += kBlock) {
        const int j = base + threadIdx.x;
        if (j < ns) {
          Body<T> b;
          b.x = spos[3 * (sbase + j)];
          b.y = spos[3 * (sbase + j) + 1];
          b.z = spos[3 * (sbase + j) + 2];
          b.gm = sgm[sbase + j];
          tile[threadIdx.x] = b;
        }
        __syncthreads();
        const int jn = min(kBlock, ns - base);
        for (int jj = 0; jj < jn; ++jj) {
          const Body<T> s = tile[jj];
          const T dx = s.x - xi;
          const T dy = s.y - yi;
          const T dz = s.z - zi;
          const T r2 =
              add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
          const T r2s = add_rn(r2, eps2);
          bool ok = r2s > cutoff2 && r2 > T(0);
          if (USE_RCUT) ok = ok && r2 <= rcut2;
          const T inv_r = rsqrt_t(ok ? r2s : T(1));
          const T w = ok ? ((s.gm * inv_r) * inv_r) * inv_r : T(0);
          tx += w * dx;
          ty += w * dy;
          tz += w * dz;
        }
        __syncthreads();
      }
      ax += tx;
      ay += ty;
      az += tz;
    }
  }
  if (slot < t_cap) {
    out[3 * trow] = active ? ax : T(0);
    out[3 * trow + 1] = active ? ay : T(0);
    out[3 * trow + 2] = active ? az : T(0);
  }
}

template <typename T>
int launch(const void* tpos, const void* t_count, const void* spos,
           const void* sgm, const void* s_count, int side, int t_cap, int cap,
           const void* params, double eps2, double cutoff2, int use_rcut,
           void* out, void* stream) {
  if (side <= 0 || t_cap <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(side * side * side),
                  static_cast<unsigned>((t_cap + kBlock - 1) / kBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* tp = static_cast<const T*>(tpos);
  const int64_t* tc = static_cast<const int64_t*>(t_count);
  const T* sp = static_cast<const T*>(spos);
  const T* gm = static_cast<const T*>(sgm);
  const int64_t* sc = static_cast<const int64_t*>(s_count);
  const T* pr = static_cast<const T*>(params);
  T* o = static_cast<T*>(out);
  if (use_rcut) {
    nlist_pair_kernel<T, true><<<grid, kBlock, 0, s>>>(
        tp, tc, sp, gm, sc, side, t_cap, cap, pr, static_cast<T>(eps2),
        static_cast<T>(cutoff2), o);
  } else {
    nlist_pair_kernel<T, false><<<grid, kBlock, 0, s>>>(
        tp, tc, sp, gm, sc, side, t_cap, cap, pr, static_cast<T>(eps2),
        static_cast<T>(cutoff2), o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/nlist.py). Device pointers of
// contiguous arrays: tpos (side^3, t_cap, 3), t_count (side^3,) int64,
// spos (side^3, cap, 3), sgm (side^3, cap) holding G * m, s_count
// (side^3,) int64, params (>= 1,) holding rcut_eff^2, out (side^3,
// t_cap, 3). eps2 and cutoff2 arrive already rounded to the element
// type. Returns the launch's cudaGetLastError() as an int.
extern "C" int nlist_pair_f32(const void* tpos, const void* t_count,
                              const void* spos, const void* sgm,
                              const void* s_count, int side, int t_cap,
                              int cap, const void* params, double eps2,
                              double cutoff2, int use_rcut, void* out,
                              void* stream) {
  return launch<float>(tpos, t_count, spos, sgm, s_count, side, t_cap, cap,
                       params, eps2, cutoff2, use_rcut, out, stream);
}

extern "C" int nlist_pair_f64(const void* tpos, const void* t_count,
                              const void* spos, const void* sgm,
                              const void* s_count, int side, int t_cap,
                              int cap, const void* params, double eps2,
                              double cutoff2, int use_rcut, void* out,
                              void* stream) {
  return launch<double>(tpos, t_count, spos, sgm, s_count, side, t_cap, cap,
                        params, eps2, cutoff2, use_rcut, out, stream);
}

extern "C" const char* nlist_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
