// Direct-sum pairwise gravity, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel gravity_tpu/ops/pallas_forces.py::_nbody_kernel
// (reached through pallas_accelerations_vs). Same contract as the plain
// PyTorch version gravity_tpu_torch/ops/forces.py::accelerations_vs:
//
//   a_i = sum_j G m_j (x_j - x_i) / (r^2 + eps^2)^{3/2}
//
// where a pair with r^2 + eps^2 <= cutoff^2 (the self-pair among them)
// has weight exactly 0 and never forms a NaN. The masked modes take that
// compare-and-select form; the wrapper picks the mask-free mode exactly
// when eps^2 > cutoff^2, where the cutoff can never fire and the
// self-pair contributes 0 through dx = dy = dz = 0
// (pallas_forces.py:139-142). Masked with eps = 0 (the reference runs)
// skips the "+ eps^2", which adds an exact 0 to a non-negative r^2.
//
// What bounds it: instruction issue on the FP32 pipe. A pair costs ~16
// issued instructions (3 FADD for d, FMUL + 2 FFMA for r^2, FSETP, MUFU
// rsqrt, FSEL, 3 FMUL for the weight, 3 FFMA into the sums), and an SM
// issues 4 warp instructions a clock, so N^2 pairs take at least
// N^2 * 16 / (132 * 128 * f_clock); the inputs are O(N) bytes.
//
// What held the first version back, and what this design does about it:
// - Wave quantisation: one 256-target block a tile left 196 equal blocks
//   at N = 50,000 on 132 SMs. The source axis is now split into `chunks`
//   contiguous runs of whole tiles (blockIdx.y), chosen by the wrapper
//   from M, K, the SM count and the blocks an SM holds, so that the
//   grid fills whole waves. Chunk c covers tiles [c n / S, (c + 1) n / S).
//   With S > 1 each block writes its partial sums to a (S, M, 3) scratch,
//   and a second small kernel of this file adds them in the fixed order
//   c = 0..S-1: no atomics, the same bits on every run.
// - One target per thread: each thread now keeps kR targets, so one
//   16-byte shared-memory read of a source feeds kR pairs.
// - A barrier pair per tile with the load on the critical path: sources
//   are packed once per call as (x, y, z, G m) into a (K_pad, 4) scratch
//   (a pack kernel of this file; padding carries G m = 0, an exact no-op),
//   and each tile is staged with 16-byte cp.async copies into a double
//   buffer while the tile before it is summed: one barrier a tile.
// - rsqrtf built without -ftz wraps MUFU.RSQ in a rescaling of subnormal
//   inputs. Its inputs here are normal: r^2 > cutoff^2 >= FLT_MIN in the
//   masked modes, r^2 + eps^2 >= eps^2 >= FLT_MIN mask-free, so the
//   launch takes rsqrt.approx.ftz.f32 (the same bits on normal inputs)
//   whenever cutoff^2 (masked) or eps^2 (mask-free) is at least FLT_MIN.
//   The weight's products stay non-ftz (see below).
//
// Rounding: each thread sums one tile's pairs apart and adds the tile sum
// to its chunk total, and the chunk totals are added in order, so a row
// rounds at ~(kTile + K / (kTile S) + S) ulp of its sum of |terms|, at
// most 64 ulp above the single-chunk bound since S <= 64 (the wrapper's
// cap).
//
// Build WITHOUT --use_fast_math: the weight is ((G m_j inv_r) inv_r)
// inv_r, in that order, because inv_r^3 alone underflows in fp32 for
// r > ~2e12 m, and a distant light pair's weight is subnormal; flushing
// subnormals to zero would drop it (ops/forces.py in the JAX package).
// Nyland, Harris & Prins, GPU Gems 3 ch. 31, is the model for the tiling.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 128;         // threads a block
constexpr int kR = 2;                 // targets a thread
constexpr int kBlockM = kThreads * kR;  // targets a block
constexpr int kTile = 256;            // sources a staged tile

constexpr int kMaskedNoEps = 0;  // masked, eps = 0
constexpr int kMasked = 1;       // masked, eps > 0
constexpr int kMaskFree = 2;     // eps^2 > cutoff^2

template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, gm;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One tile of packed sources into shared memory, 16 bytes a copy.
template <typename T>
__device__ __forceinline__ void stage(Body<T>* dst, const Body<T>* src) {
  constexpr int kCopies = kTile * sizeof(Body<T>) / 16;
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int c = threadIdx.x; c < kCopies; c += kThreads) {
    cp_async16(d + 16 * c, s + 16 * c);
  }
  cp_async_commit();
}

template <typename T, int MODE, bool FTZ>
__device__ __forceinline__ void pair(const Body<T>& s, T xi, T yi, T zi,
                                     T eps2, T cutoff2, T& tx, T& ty, T& tz) {
  const T dx = s.x - xi;
  const T dy = s.y - yi;
  const T dz = s.z - zi;
  T r2 = dx * dx + dy * dy + dz * dz;
  if (MODE != kMaskedNoEps) r2 = r2 + eps2;
  T inv_r;
  if (MODE == kMaskFree) {
    inv_r = rsqrt_t<FTZ>(r2);
  } else {
    // A pair at or below the cutoff takes inv_r = 0, so its weight is an
    // exact 0 and the rsqrt of its (maybe zero) r^2 is never used.
    inv_r = r2 > cutoff2 ? rsqrt_t<FTZ>(r2) : T(0);
  }
  const T w = ((s.gm * inv_r) * inv_r) * inv_r;
  tx += w * dx;
  ty += w * dy;
  tz += w * dz;
}

template <typename T>
__global__ void nbody_pack_kernel(const T* __restrict__ pos_j,
                                  const T* __restrict__ gm_j, int64_t k,
                                  int64_t k_pad, Body<T>* __restrict__ out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= k_pad) return;
  Body<T> b{T(0), T(0), T(0), T(0)};
  if (j < k) {
    b.x = pos_j[3 * j];
    b.y = pos_j[3 * j + 1];
    b.z = pos_j[3 * j + 2];
    b.gm = gm_j[j];
  }
  out[j] = b;
}

// Block (x, c): targets [x kBlockM, (x + 1) kBlockM) against the tiles of
// chunk c. Writes out[c][i][:] (out is acc itself when chunks == 1).
template <typename T, int MODE, bool FTZ>
__global__ void __launch_bounds__(kThreads)
    nbody_direct_kernel(const T* __restrict__ pos_i, int64_t m,
                        const Body<T>* __restrict__ packed, int n_tiles,
                        int chunks, T eps2, T cutoff2, T* __restrict__ out) {
  __shared__ Body<T> tile[2][kTile];
  const int c = blockIdx.y;
  const int t_lo = static_cast<int>(static_cast<int64_t>(c) * n_tiles /
                                    chunks);
  const int t_hi = static_cast<int>(static_cast<int64_t>(c + 1) * n_tiles /
                                    chunks);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBlockM + threadIdx.x;
  T xi[kR], yi[kR], zi[kR], ax[kR], ay[kR], az[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int64_t i = i0 + r * kThreads;
    xi[r] = yi[r] = zi[r] = T(0);
    if (i < m) {
      xi[r] = pos_i[3 * i];
      yi[r] = pos_i[3 * i + 1];
      zi[r] = pos_i[3 * i + 2];
    }
    ax[r] = ay[r] = az[r] = T(0);
  }
  if (t_lo < t_hi) {
    stage(tile[0], packed + static_cast<int64_t>(t_lo) * kTile);
  }
  for (int t = t_lo; t < t_hi; ++t) {
    // Tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose buffer the next copy refills.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < t_hi) {
      stage(tile[(t + 1 - t_lo) & 1],
            packed + static_cast<int64_t>(t + 1) * kTile);
    }
    const Body<T>* buf = tile[(t - t_lo) & 1];
    T tx[kR], ty[kR], tz[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) tx[r] = ty[r] = tz[r] = T(0);
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      const Body<T> s = buf[jj];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        pair<T, MODE, FTZ>(s, xi[r], yi[r], zi[r], eps2, cutoff2, tx[r],
                           ty[r], tz[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ax[r] += tx[r];
      ay[r] += ty[r];
      az[r] += tz[r];
    }
  }
  T* o = out + static_cast<int64_t>(c) * m * 3;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int64_t i = i0 + r * kThreads;
    if (i < m) {
      o[3 * i] = ax[r];
      o[3 * i + 1] = ay[r];
      o[3 * i + 2] = az[r];
    }
  }
}

// acc[e] = partial[0][e] + partial[1][e] + ... in that order.
template <typename T>
__global__ void nbody_reduce_kernel(const T* __restrict__ partial, int64_t n,
                                    int chunks, T* __restrict__ acc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  T s = partial[e];
  for (int c = 1; c < chunks; ++c) s += partial[static_cast<int64_t>(c) * n + e];
  acc[e] = s;
}

template <typename T>
using KernelFn = void (*)(const T*, int64_t, const Body<T>*, int, int, T, T,
                          T*);

// The instantiation a launch with these arguments takes.
template <typename T>
KernelFn<T> pick_kernel(int masked, double eps2, double cutoff2) {
  const int mode = !masked ? kMaskFree : (eps2 == 0.0 ? kMaskedNoEps
                                                      : kMasked);
  const bool ftz = sizeof(T) == 4 &&
                   (mode == kMaskFree ? eps2 : cutoff2) >= FLT_MIN;
  if (mode == kMaskFree) {
    return ftz ? nbody_direct_kernel<T, kMaskFree, true>
               : nbody_direct_kernel<T, kMaskFree, false>;
  }
  if (mode == kMasked) {
    return ftz ? nbody_direct_kernel<T, kMasked, true>
               : nbody_direct_kernel<T, kMasked, false>;
  }
  return ftz ? nbody_direct_kernel<T, kMaskedNoEps, true>
             : nbody_direct_kernel<T, kMaskedNoEps, false>;
}

template <typename T>
int launch(const void* pos_i, int64_t m, const void* pos_j, const void* gm_j,
           int64_t k, double eps2, double cutoff2, int masked, int chunks,
           void* packed, void* partial, void* acc, void* stream) {
  if (m <= 0) return 0;
  const int n_tiles = static_cast<int>((k + kTile - 1) / kTile);
  if (chunks < 1 || (n_tiles > 0 && chunks > n_tiles) ||
      (n_tiles == 0 && chunks != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Body<T>* pk = static_cast<Body<T>*>(packed);
  const int64_t k_pad = static_cast<int64_t>(n_tiles) * kTile;
  if (k_pad > 0) {
    nbody_pack_kernel<T><<<static_cast<unsigned>((k_pad + 255) / 256), 256,
                           0, s>>>(static_cast<const T*>(pos_j),
                                   static_cast<const T*>(gm_j), k, k_pad, pk);
  }
  T* out = static_cast<T*>(chunks > 1 ? partial : acc);
  const dim3 grid(static_cast<unsigned>((m + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(chunks));
  pick_kernel<T>(masked, eps2, cutoff2)<<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(pos_i), m, pk, n_tiles, chunks,
      static_cast<T>(eps2), static_cast<T>(cutoff2), out);
  if (chunks > 1) {
    const int64_t n = 3 * m;
    nbody_reduce_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             s>>>(static_cast<const T*>(partial), n, chunks,
                                  static_cast<T*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int masked, double eps2, double cutoff2) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pick_kernel<T>(masked, eps2, cutoff2), kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/direct_kernel.py). Pointers
// are device pointers of contiguous (M, 3), (K, 3), (K,) and (M, 3)
// arrays; gm_j holds G * m_j. eps2 and cutoff2 arrive already rounded to
// the element type. `chunks` (S) splits the source axis; `packed` is
// scratch of (ceil(K / tile) * tile, 4) elements and `partial` of
// (S, M, 3) elements (unused when S = 1). Returns the launches'
// cudaGetLastError() as an int.
extern "C" int nbody_direct_f32(const void* pos_i, int64_t m,
                                const void* pos_j, const void* gm_j,
                                int64_t k, double eps2, double cutoff2,
                                int masked, int chunks, void* packed,
                                void* partial, void* acc, void* stream) {
  return launch<float>(pos_i, m, pos_j, gm_j, k, eps2, cutoff2, masked,
                       chunks, packed, partial, acc, stream);
}

extern "C" int nbody_direct_f64(const void* pos_i, int64_t m,
                                const void* pos_j, const void* gm_j,
                                int64_t k, double eps2, double cutoff2,
                                int masked, int chunks, void* packed,
                                void* partial, void* acc, void* stream) {
  return launch<double>(pos_i, m, pos_j, gm_j, k, eps2, cutoff2, masked,
                        chunks, packed, partial, acc, stream);
}

// The block shape the wrapper plans with: 0 -> targets a block,
// 1 -> sources a tile.
extern "C" int nbody_direct_shape(int which) {
  return which == 0 ? kBlockM : kTile;
}

// Blocks of the instantiation a launch with these arguments takes that
// one SM holds at once (a negative cudaError_t on failure).
extern "C" int nbody_direct_blocks_per_sm(int f64, int masked, double eps2,
                                          double cutoff2) {
  return f64 ? blocks_per_sm<double>(masked, eps2, cutoff2)
             : blocks_per_sm<float>(masked, eps2, cutoff2);
}

extern "C" const char* nbody_direct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
