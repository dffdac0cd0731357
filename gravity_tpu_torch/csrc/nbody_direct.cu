// Direct-sum pairwise gravity, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel gravity_tpu/ops/pallas_forces.py::_nbody_kernel
// (reached through pallas_accelerations_vs). Same contract as the plain
// PyTorch version gravity_tpu_torch/ops/forces.py::accelerations_vs:
//
//   a_i = sum_j G m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}
//
// where a pair with r^2 + eps^2 <= cutoff^2 (the self-pair among them)
// has weight exactly 0 and never forms a NaN. The MASKED template flag
// picks that compare-and-select form; the wrapper clears it exactly when
// eps^2 > cutoff^2, where the cutoff can never fire and the self-pair
// contributes 0 through dx = dy = dz = 0 (pallas_forces.py:139-142).
//
// What bounds it: it is FP32-pipe bound. Each pair costs ~20 flops (the
// JAX cost model, pallas_forces.py:143) and one rsqrt on the special
// function unit, while the inputs are O(N) bytes for O(N^2) work.
// Design: one thread per target i, 256 threads a block. Each block walks
// the sources in tiles of 256 bodies, staged once into shared memory as
// (x, y, z, G*m_j) and then read by every thread as a broadcast, so
// device memory traffic is O(N^2 / 256) reads. The sum lives in
// registers; the loop over tiles replaces the TPU's sequential j grid
// axis, so no reduction across blocks is needed. Each tile is summed
// apart and then added to the running total, as the TPU kernel adds one
// j-tile's partial sums to its accumulator; this bounds the rounding of
// a row at ~(256 + K/256) ulp of its sum of |terms| instead of K ulp.
// Padding sources past K carry G*m = 0 and are exact no-ops.
//
// Build WITHOUT --use_fast_math: the weight is ((G m_j inv_r) inv_r)
// inv_r, in that order, because inv_r^3 alone underflows in fp32 for
// r > ~2e12 m, and a distant light pair's weight is subnormal; flushing
// subnormals to zero would drop it (ops/forces.py in the JAX package).
// Nyland, Harris & Prins, GPU Gems 3 ch. 31, is the model for the tiling.

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

template <typename T, bool MASKED>
__global__ void __launch_bounds__(kBlock)
    nbody_direct_kernel(const T* __restrict__ pos_i, int64_t m,
                        const T* __restrict__ pos_j,
                        const T* __restrict__ gm_j, int64_t k, T eps2,
                        T cutoff2, T* __restrict__ acc) {
  __shared__ Body<T> tile[kBlock];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool active = i < m;
  T xi = T(0), yi = T(0), zi = T(0);
  if (active) {
    xi = pos_i[3 * i];
    yi = pos_i[3 * i + 1];
    zi = pos_i[3 * i + 2];
  }
  T ax = T(0), ay = T(0), az = T(0);
  for (int64_t base = 0; base < k; base += kBlock) {
    const int64_t j = base + threadIdx.x;
    Body<T> b;
    if (j < k) {
      b.x = pos_j[3 * j];
      b.y = pos_j[3 * j + 1];
      b.z = pos_j[3 * j + 2];
      b.gm = gm_j[j];
    } else {
      b.x = T(0);
      b.y = T(0);
      b.z = T(0);
      b.gm = T(0);
    }
    tile[threadIdx.x] = b;
    __syncthreads();
    T tx = T(0), ty = T(0), tz = T(0);
#pragma unroll 8
    for (int jj = 0; jj < kBlock; ++jj) {
      const Body<T> s = tile[jj];
      const T dx = s.x - xi;
      const T dy = s.y - yi;
      const T dz = s.z - zi;
      const T r2 = dx * dx + dy * dy + dz * dz + eps2;
      T w;
      if (MASKED) {
        const bool ok = r2 > cutoff2;
        const T inv_r = rsqrt_t(ok ? r2 : T(1));
        w = ok ? ((s.gm * inv_r) * inv_r) * inv_r : T(0);
      } else {
        const T inv_r = rsqrt_t(r2);
        w = ((s.gm * inv_r) * inv_r) * inv_r;
      }
      tx += w * dx;
      ty += w * dy;
      tz += w * dz;
    }
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (active) {
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
  }
}

template <typename T>
int launch(const void* pos_i, int64_t m, const void* pos_j, const void* gm_j,
           int64_t k, double eps2, double cutoff2, int masked, void* acc,
           void* stream) {
  if (m <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((m + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pi = static_cast<const T*>(pos_i);
  const T* pj = static_cast<const T*>(pos_j);
  const T* gm = static_cast<const T*>(gm_j);
  T* out = static_cast<T*>(acc);
  if (masked) {
    nbody_direct_kernel<T, true><<<grid, kBlock, 0, s>>>(
        pi, m, pj, gm, k, static_cast<T>(eps2), static_cast<T>(cutoff2), out);
  } else {
    nbody_direct_kernel<T, false><<<grid, kBlock, 0, s>>>(
        pi, m, pj, gm, k, static_cast<T>(eps2), static_cast<T>(cutoff2), out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/direct_kernel.py). Pointers
// are device pointers of contiguous (M, 3), (K, 3), (K,) and (M, 3)
// arrays; gm_j holds G * m_j. eps2 and cutoff2 arrive already rounded to
// the element type. Returns the launch's cudaGetLastError() as an int.
extern "C" int nbody_direct_f32(const void* pos_i, int64_t m,
                                const void* pos_j, const void* gm_j,
                                int64_t k, double eps2, double cutoff2,
                                int masked, void* acc, void* stream) {
  return launch<float>(pos_i, m, pos_j, gm_j, k, eps2, cutoff2, masked, acc,
                       stream);
}

extern "C" int nbody_direct_f64(const void* pos_i, int64_t m,
                                const void* pos_j, const void* gm_j,
                                int64_t k, double eps2, double cutoff2,
                                int masked, void* acc, void* stream) {
  return launch<double>(pos_i, m, pos_j, gm_j, k, eps2, cutoff2, masked, acc,
                        stream);
}

extern "C" const char* nbody_direct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
