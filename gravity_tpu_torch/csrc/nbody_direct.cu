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
// The bf16 form (nbody_direct_bf16) replaces the same TPU kernel on a bf16
// state, where _nbody_kernel computes in the operands' dtype
// (pallas_forces.py:122-139). It reads bf16 positions and G m_j already
// rounded to bf16 (the wrapper forms bf16(G) m_j rounded, as `gmj` is at
// pallas_forces.py:132-134), computes each op of the pair term in fp32
// registers and rounds it to bf16 where the plain version
// (ops/forces.py::accelerations_vs at bf16) holds a bf16 tensor: d, each
// d^2, r^2 (the three squares added in fp32, rounded once, as torch's
// sum), r^2 + eps^2, rsqrt, each of the three products of the weight, and
// each w d. The terms are summed in fp32 (tile sums, chunk totals, the
// ordered reduce) and rounded to bf16 once per target: the rounding of
// the dense JAX form and of the TPU's fp32-accumulating reductions, not
// that of the Pallas kernel's bf16 accumulator, which adds each
// 2,048-source tile's partial in bf16. The sources are packed as fp32
// (x, y, z, G m), exact, so the tile loop is the fp32 one; the partial
// sums are always fp32 scratch, and the reduce kernel rounds once.
// What bounds the bf16 form: its 15 roundings a pair. An fp32-to-bf16
// conversion issues at 16 a clock an SM (the CUDA guide's "all other type
// conversions"), 1/8 of the FP32 pipe's rate; one cvt.rn.bf16x2.f32
// rounds a thread's two targets' values at once, 7.5 conversions a pair,
// so N^2 pairs take at least N^2 * 7.5 / (132 * 16 * f_clock).
//
// Build WITHOUT --use_fast_math: the weight is ((G m_j inv_r) inv_r)
// inv_r, in that order, because inv_r^3 alone underflows in fp32 for
// r > ~2e12 m, and a distant light pair's weight is subnormal; flushing
// subnormals to zero would drop it (ops/forces.py in the JAX package).
// Nyland, Harris & Prins, GPU Gems 3 ch. 31, is the model for the tiling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;         // threads a block
constexpr int kR = 2;                 // targets a thread
constexpr int kBlockM = kThreads * kR;  // targets a block
static_assert(kR == 2, "pair_bf16 packs a thread's two targets");
constexpr int kTile = 256;            // sources a staged tile

constexpr int kMaskedNoEps = 0;  // masked, eps = 0
constexpr int kMasked = 1;       // masked, eps > 0
constexpr int kMaskFree = 2;     // eps^2 > cutoff^2

using bf16 = __nv_bfloat16;

template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, gm;
};

// The element type IO (float, double or bf16) and the type the kernel
// computes and sums in: fp32 for bf16.
template <typename IO>
using Compute = std::conditional_t<std::is_same_v<IO, bf16>, float, IO>;

template <typename IO>
__device__ __forceinline__ Compute<IO> load(const IO* p) {
  if constexpr (std::is_same_v<IO, bf16>) {
    return __bfloat162float(*p);
  } else {
    return *p;
  }
}

template <typename IO, typename T>
__device__ __forceinline__ IO store_as(T v) {
  if constexpr (std::is_same_v<IO, bf16>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

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

// a and b rounded to bf16 (to nearest, even) by one cvt.rn.bf16x2.f32,
// and back to fp32: two bf16 roundings for one conversion instruction.
__device__ __forceinline__ void rnd2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

// The bf16 form's pair, for a thread's two targets (kR = 2) at once: each
// op in fp32, rounded to bf16 where the plain version holds a bf16 value
// (d, each d^2, r^2 with its three squares added in fp32 as torch's sum,
// r^2 + eps^2, rsqrt, the weight's three products, each w d), the two
// targets' roundings packed into one conversion; the terms summed in
// fp32.
template <int MODE, bool FTZ>
__device__ __forceinline__ void pair_bf16(const Body<float>& s,
                                          const float* xi, const float* yi,
                                          const float* zi, float eps2,
                                          float cutoff2, float* tx, float* ty,
                                          float* tz) {
  float dx[2], dy[2], dz[2], r2[2], inv_r[2], w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dx[r] = s.x - xi[r];
    dy[r] = s.y - yi[r];
    dz[r] = s.z - zi[r];
  }
  rnd2(dx[0], dx[1]);
  rnd2(dy[0], dy[1]);
  rnd2(dz[0], dz[1]);
  float sx[2], sy[2], sz[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sx[r] = dx[r] * dx[r];
    sy[r] = dy[r] * dy[r];
    sz[r] = dz[r] * dz[r];
  }
  rnd2(sx[0], sx[1]);
  rnd2(sy[0], sy[1]);
  rnd2(sz[0], sz[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) r2[r] = sx[r] + sy[r] + sz[r];
  rnd2(r2[0], r2[1]);
  if (MODE != kMaskedNoEps) {
    r2[0] += eps2;
    r2[1] += eps2;
    rnd2(r2[0], r2[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (MODE == kMaskFree) {
      inv_r[r] = rsqrt_t<FTZ>(r2[r]);
    } else {
      // As in pair: 0 at or below the cutoff (0 rounds to 0).
      inv_r[r] = r2[r] > cutoff2 ? rsqrt_t<FTZ>(r2[r]) : 0.0f;
    }
  }
  rnd2(inv_r[0], inv_r[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) w[r] = s.gm * inv_r[r];
  rnd2(w[0], w[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) w[r] = w[r] * inv_r[r];
  rnd2(w[0], w[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) w[r] = w[r] * inv_r[r];
  rnd2(w[0], w[1]);
  float px[2], py[2], pz[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    px[r] = w[r] * dx[r];
    py[r] = w[r] * dy[r];
    pz[r] = w[r] * dz[r];
  }
  rnd2(px[0], px[1]);
  rnd2(py[0], py[1]);
  rnd2(pz[0], pz[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tx[r] += px[r];
    ty[r] += py[r];
    tz[r] += pz[r];
  }
}

template <typename IO>
__global__ void nbody_pack_kernel(const IO* __restrict__ pos_j,
                                  const IO* __restrict__ gm_j, int64_t k,
                                  int64_t k_pad,
                                  Body<Compute<IO>>* __restrict__ out) {
  using T = Compute<IO>;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= k_pad) return;
  Body<T> b{T(0), T(0), T(0), T(0)};
  if (j < k) {
    b.x = load(pos_j + 3 * j);
    b.y = load(pos_j + 3 * j + 1);
    b.z = load(pos_j + 3 * j + 2);
    b.gm = load(gm_j + j);
  }
  out[j] = b;
}

// Block (x, c): targets [x kBlockM, (x + 1) kBlockM) against the tiles of
// chunk c. Writes out[c][i][:] in the compute type T (out is acc itself
// when chunks == 1 and IO is T).
template <typename IO, int MODE, bool FTZ>
__global__ void __launch_bounds__(kThreads)
    nbody_direct_kernel(const IO* __restrict__ pos_i, int64_t m,
                        const Body<Compute<IO>>* __restrict__ packed,
                        int n_tiles, int chunks, Compute<IO> eps2,
                        Compute<IO> cutoff2, Compute<IO>* __restrict__ out) {
  using T = Compute<IO>;
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
      xi[r] = load(pos_i + 3 * i);
      yi[r] = load(pos_i + 3 * i + 1);
      zi[r] = load(pos_i + 3 * i + 2);
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
      if constexpr (std::is_same_v<IO, bf16>) {
        pair_bf16<MODE, FTZ>(s, xi, yi, zi, eps2, cutoff2, tx, ty, tz);
      } else {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          pair<T, MODE, FTZ>(s, xi[r], yi[r], zi[r], eps2, cutoff2, tx[r],
                             ty[r], tz[r]);
        }
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

// acc[e] = partial[0][e] + partial[1][e] + ... in that order, in the
// compute type T, rounded to IO once.
template <typename IO>
__global__ void nbody_reduce_kernel(const Compute<IO>* __restrict__ partial,
                                    int64_t n, int chunks,
                                    IO* __restrict__ acc) {
  using T = Compute<IO>;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  T s = partial[e];
  for (int c = 1; c < chunks; ++c) s += partial[static_cast<int64_t>(c) * n + e];
  acc[e] = store_as<IO>(s);
}

template <typename IO>
using KernelFn = void (*)(const IO*, int64_t, const Body<Compute<IO>>*, int,
                          int, Compute<IO>, Compute<IO>, Compute<IO>*);

// The instantiation a launch with these arguments takes.
template <typename IO>
KernelFn<IO> pick_kernel(int masked, double eps2, double cutoff2) {
  const int mode = !masked ? kMaskFree : (eps2 == 0.0 ? kMaskedNoEps
                                                      : kMasked);
  const bool ftz = sizeof(Compute<IO>) == 4 &&
                   (mode == kMaskFree ? eps2 : cutoff2) >= FLT_MIN;
  if (mode == kMaskFree) {
    return ftz ? nbody_direct_kernel<IO, kMaskFree, true>
               : nbody_direct_kernel<IO, kMaskFree, false>;
  }
  if (mode == kMasked) {
    return ftz ? nbody_direct_kernel<IO, kMasked, true>
               : nbody_direct_kernel<IO, kMasked, false>;
  }
  return ftz ? nbody_direct_kernel<IO, kMaskedNoEps, true>
             : nbody_direct_kernel<IO, kMaskedNoEps, false>;
}

// `packed` holds (K_pad, 4) and `partial` (S, M, 3) elements of the
// compute type. fp32 and fp64 with S = 1 write acc directly; bf16 always
// writes fp32 partials and rounds them once in the reduce kernel.
template <typename IO>
int launch(const void* pos_i, int64_t m, const void* pos_j, const void* gm_j,
           int64_t k, double eps2, double cutoff2, int masked, int chunks,
           void* packed, void* partial, void* acc, void* stream) {
  using T = Compute<IO>;
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
    nbody_pack_kernel<IO><<<static_cast<unsigned>((k_pad + 255) / 256), 256,
                            0, s>>>(static_cast<const IO*>(pos_j),
                                    static_cast<const IO*>(gm_j), k, k_pad,
                                    pk);
  }
  const bool direct = chunks == 1 && std::is_same_v<IO, T>;
  T* out = static_cast<T*>(direct ? acc : partial);
  const dim3 grid(static_cast<unsigned>((m + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(chunks));
  pick_kernel<IO>(masked, eps2, cutoff2)<<<grid, kThreads, 0, s>>>(
      static_cast<const IO*>(pos_i), m, pk, n_tiles, chunks,
      static_cast<T>(eps2), static_cast<T>(cutoff2), out);
  if (!direct) {
    const int64_t n = 3 * m;
    nbody_reduce_kernel<IO><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                              s>>>(static_cast<const T*>(partial), n, chunks,
                                   static_cast<IO*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int blocks_per_sm(int masked, double eps2, double cutoff2) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pick_kernel<IO>(masked, eps2, cutoff2), kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/direct_kernel.py). Pointers
// are device pointers of contiguous (M, 3), (K, 3), (K,) and (M, 3)
// arrays of the element type; gm_j holds G * m_j. eps2 and cutoff2 arrive
// already rounded to the element type. `chunks` (S) splits the source
// axis; `packed` is scratch of (ceil(K / tile) * tile, 4) and `partial`
// of (S, M, 3) elements of the compute type (fp32 for bf16), `partial`
// unused for fp32 and fp64 when S = 1. Returns the launches'
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

extern "C" int nbody_direct_bf16(const void* pos_i, int64_t m,
                                 const void* pos_j, const void* gm_j,
                                 int64_t k, double eps2, double cutoff2,
                                 int masked, int chunks, void* packed,
                                 void* partial, void* acc, void* stream) {
  return launch<bf16>(pos_i, m, pos_j, gm_j, k, eps2, cutoff2, masked,
                      chunks, packed, partial, acc, stream);
}

// The block shape the wrapper plans with: 0 -> targets a block,
// 1 -> sources a tile.
extern "C" int nbody_direct_shape(int which) {
  return which == 0 ? kBlockM : kTile;
}

// Blocks of the instantiation a launch with these arguments takes that
// one SM holds at once (a negative cudaError_t on failure). `dtype`: 0
// float, 1 double, 2 bf16.
extern "C" int nbody_direct_blocks_per_sm(int dtype, int masked, double eps2,
                                          double cutoff2) {
  if (dtype == 1) return blocks_per_sm<double>(masked, eps2, cutoff2);
  if (dtype == 2) return blocks_per_sm<bf16>(masked, eps2, cutoff2);
  return blocks_per_sm<float>(masked, eps2, cutoff2);
}

extern "C" const char* nbody_direct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
