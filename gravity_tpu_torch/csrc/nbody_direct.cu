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
// Batched launches (the serve engine, gravity_tpu_torch/serve/engine.py):
// the counterpart of pallas_call's batching rule under the JAX engine's
// vmap, which gives the TPU kernel an extra grid axis. Here the pack, main
// and reduce kernels each take the slot as one more grid axis (blockIdx.y
// for pack and reduce, blockIdx.z for the main kernel) and offset every
// pointer by the slot's stride, so B systems are one launch of each. A
// slot's blocks do exactly a solo launch's work on that slot's arrays with
// the same chunking, so slot b's result has the bits of a solo launch.
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
// pallas_forces.py:132-134). Its contract is the plain version's
// (ops/forces.py::accelerations_vs at bf16): each op of the pair term
// computed in fp32 and rounded to bf16 where the plain version holds a
// bf16 tensor: d, each d^2, r^2 (the three squares added in fp32, rounded
// once, as torch's sum), r^2 + eps^2, rsqrt, each of the three products of
// the weight, and each w d. The terms are summed in fp32 (tile sums, chunk
// totals, the ordered reduce) and rounded to bf16 once per target: the
// rounding of the dense JAX form and of the TPU's fp32-accumulating
// reductions, not that of the Pallas kernel's bf16 accumulator, which adds
// each 2,048-source tile's partial in bf16.
// Design: packed bf16x2 arithmetic. A thread's two targets sit in the two
// halves of one 32-bit register an axis (x0|x1, y0|y1, z0|z1), and each
// source is packed once per call with each value in both halves (x|x,
// y|y, z|z, G m|G m: 16 bytes, as the fp32 Body). Then d, the squares,
// r^2 + eps^2, the weight's three products and the w d are one
// sub.rn.bf16x2, mul.rn.bf16x2 or add.rn.bf16x2 for both targets, rounded
// once to nearest even. For +, - and x of two bf16 operands that is the
// same bits as the fp32 op rounded to bf16: fp32's 24 bits are at least 2
// x 8 + 2, so the double rounding is innocuous (Figueroa, "When is double
// rounding innocuous?", 1995; tests/test_torch_bf16_rounding.py checks
// it), and bf16 shares fp32's exponent range. Three steps stay in fp32 as
// the contract says: r^2's three squares are unpacked with integer ops
// (low half << 16, high half & 0xffff0000, exact), added, and packed by
// one cvt.rn.bf16x2.f32; the rsqrt is fp32 MUFU on the unpacked r^2 + eps^2
// (rsqrt.approx is not correctly rounded, so a bf16 rsqrt would not give
// the plain version's bits), packed by a second cvt; and the sums of the
// terms. So the kernel's outputs are the bits of the op-by-op fp32 design
// it replaces, with 2 conversions a source (1 a pair) where that design
// had 15 roundings a pair in 7.5 conversions, which issue at 16 a clock
// an SM, 1/8 of the FP32 pipe's rate. What bounds it now: issue, ~21
// instructions a pair, and the SFU's rsqrt.
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

// A source of the bf16 form: the bits of bf16 x, y, z and G m, each in
// both halves of its word, so one 16-byte read feeds a thread's two
// targets.
struct alignas(16) Body2 {
  uint32_t x, y, z, gm;
};

// The element type IO (float, double or bf16) and the type the kernel
// computes and sums in: fp32 for bf16.
template <typename IO>
using Compute = std::conditional_t<std::is_same_v<IO, bf16>, float, IO>;

// What a tile stages a source as: Body2 for bf16, else Body of the compute
// type.
template <typename IO>
using Staged = std::conditional_t<std::is_same_v<IO, bf16>, Body2,
                                  Body<Compute<IO>>>;

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
template <typename S>
__device__ __forceinline__ void stage(S* dst, const S* src) {
  constexpr int kCopies = kTile * sizeof(S) / 16;
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

// bf16x2 arithmetic on raw bits, two bf16 values to a 32-bit word: each
// op rounds once to nearest even and keeps subnormals. The explicit .rn
// keeps ptxas from contracting a product and a sum into one fma.
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// The low and high halves as fp32, exactly, by integer ops.
__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
// a (low half) and b (high half) rounded to bf16 by one
// cvt.rn.bf16x2.f32, which takes its high half first.
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
  return d;
}
// A bf16 value's bits in both halves.
__device__ __forceinline__ uint32_t splat(bf16 v) {
  return 0x10001u * __bfloat16_as_ushort(v);
}

// The bf16 form's pair, for a thread's two targets (kR = 2: target r in
// half r of xi, yi, zi) and one source: the packed ops round as the
// plain version rounds each op; r^2's squares add in fp32 (x + y) + z,
// as torch's sum, and r^2 and the rsqrt are rounded by one conversion for
// both targets. The terms are summed in fp32. eps2 holds bf16 eps^2 in
// both halves.
template <int MODE, bool FTZ>
__device__ __forceinline__ void pair_bf16(const Body2& s, uint32_t xi,
                                          uint32_t yi, uint32_t zi,
                                          uint32_t eps2, float cutoff2,
                                          float* tx, float* ty, float* tz) {
  const uint32_t dx = sub2(s.x, xi);
  const uint32_t dy = sub2(s.y, yi);
  const uint32_t dz = sub2(s.z, zi);
  const uint32_t sx = mul2(dx, dx);
  const uint32_t sy = mul2(dy, dy);
  const uint32_t sz = mul2(dz, dz);
  uint32_t r2 = pack2((lo(sx) + lo(sy)) + lo(sz), (hi(sx) + hi(sy)) + hi(sz));
  if (MODE != kMaskedNoEps) r2 = add2(r2, eps2);
  const float r0 = lo(r2), r1 = hi(r2);
  float inv0, inv1;
  if (MODE == kMaskFree) {
    inv0 = rsqrt_t<FTZ>(r0);
    inv1 = rsqrt_t<FTZ>(r1);
  } else {
    // As in pair: 0 at or below the cutoff, so the weight is an exact 0.
    inv0 = r0 > cutoff2 ? rsqrt_t<FTZ>(r0) : 0.0f;
    inv1 = r1 > cutoff2 ? rsqrt_t<FTZ>(r1) : 0.0f;
  }
  const uint32_t inv_r = pack2(inv0, inv1);
  const uint32_t w = mul2(mul2(mul2(s.gm, inv_r), inv_r), inv_r);
  const uint32_t px = mul2(w, dx);
  const uint32_t py = mul2(w, dy);
  const uint32_t pz = mul2(w, dz);
  tx[0] += lo(px);
  tx[1] += hi(px);
  ty[0] += lo(py);
  ty[1] += hi(py);
  tz[0] += lo(pz);
  tz[1] += hi(pz);
}

// Slot blockIdx.y of a batched launch: its sources start at slot * k,
// its packed tiles at slot * k_pad.
template <typename IO>
__global__ void nbody_pack_kernel(const IO* __restrict__ pos_j,
                                  const IO* __restrict__ gm_j, int64_t k,
                                  int64_t k_pad,
                                  Staged<IO>* __restrict__ out) {
  using T = Compute<IO>;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= k_pad) return;
  pos_j += static_cast<int64_t>(blockIdx.y) * k * 3;
  gm_j += static_cast<int64_t>(blockIdx.y) * k;
  out += static_cast<int64_t>(blockIdx.y) * k_pad;
  if constexpr (std::is_same_v<IO, bf16>) {
    Body2 b{0u, 0u, 0u, 0u};
    if (j < k) {
      b.x = splat(pos_j[3 * j]);
      b.y = splat(pos_j[3 * j + 1]);
      b.z = splat(pos_j[3 * j + 2]);
      b.gm = splat(gm_j[j]);
    }
    out[j] = b;
  } else {
    Body<T> b{T(0), T(0), T(0), T(0)};
    if (j < k) {
      b.x = load(pos_j + 3 * j);
      b.y = load(pos_j + 3 * j + 1);
      b.z = load(pos_j + 3 * j + 2);
      b.gm = load(gm_j + j);
    }
    out[j] = b;
  }
}

// Block (x, c, b): slot b's targets [x kBlockM, (x + 1) kBlockM) against
// the tiles of its chunk c. Writes out[b][c][i][:] in the compute type T
// (out is acc itself when chunks == 1 and IO is T). A slot's blocks do
// the work of a solo launch's on that slot's arrays, so its bits are a
// solo launch's.
template <typename IO, int MODE, bool FTZ>
__global__ void __launch_bounds__(kThreads)
    nbody_direct_kernel(const IO* __restrict__ pos_i, int64_t m,
                        const Staged<IO>* __restrict__ packed,
                        int n_tiles, int chunks, Compute<IO> eps2,
                        Compute<IO> cutoff2, Compute<IO>* __restrict__ out) {
  using T = Compute<IO>;
  constexpr bool kBf16 = std::is_same_v<IO, bf16>;
  __shared__ Staged<IO> tile[2][kTile];
  const int c = blockIdx.y;
  const int64_t slot = blockIdx.z;
  pos_i += slot * m * 3;
  packed += slot * n_tiles * kTile;
  out += slot * chunks * m * 3;
  const int t_lo = static_cast<int>(static_cast<int64_t>(c) * n_tiles /
                                    chunks);
  const int t_hi = static_cast<int>(static_cast<int64_t>(c + 1) * n_tiles /
                                    chunks);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBlockM + threadIdx.x;
  T xi[kR], yi[kR], zi[kR], ax[kR], ay[kR], az[kR];
  // The bf16 form's targets, target r in half r; eps^2 in both halves.
  uint32_t xi2 = 0u, yi2 = 0u, zi2 = 0u, eps2x2 = 0u;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int64_t i = i0 + r * kThreads;
    xi[r] = yi[r] = zi[r] = T(0);
    if (i < m) {
      if constexpr (kBf16) {
        xi2 |= static_cast<uint32_t>(__bfloat16_as_ushort(pos_i[3 * i]))
               << (16 * r);
        yi2 |= static_cast<uint32_t>(__bfloat16_as_ushort(pos_i[3 * i + 1]))
               << (16 * r);
        zi2 |= static_cast<uint32_t>(__bfloat16_as_ushort(pos_i[3 * i + 2]))
               << (16 * r);
      } else {
        xi[r] = load(pos_i + 3 * i);
        yi[r] = load(pos_i + 3 * i + 1);
        zi[r] = load(pos_i + 3 * i + 2);
      }
    }
    ax[r] = ay[r] = az[r] = T(0);
  }
  if constexpr (kBf16) {
    // eps2 is a bf16 value, so its low 16 bits are zero.
    eps2x2 = 0x10001u * (__float_as_uint(eps2) >> 16);
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
    const Staged<IO>* buf = tile[(t - t_lo) & 1];
    T tx[kR], ty[kR], tz[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) tx[r] = ty[r] = tz[r] = T(0);
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      const Staged<IO> s = buf[jj];
      if constexpr (kBf16) {
        pair_bf16<MODE, FTZ>(s, xi2, yi2, zi2, eps2x2, cutoff2, tx, ty, tz);
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
// Slot blockIdx.y of a batched launch: partial (B, S, n), acc (B, n).
template <typename IO>
__global__ void nbody_reduce_kernel(const Compute<IO>* __restrict__ partial,
                                    int64_t n, int chunks,
                                    IO* __restrict__ acc) {
  using T = Compute<IO>;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  partial += static_cast<int64_t>(blockIdx.y) * chunks * n;
  acc += static_cast<int64_t>(blockIdx.y) * n;
  T s = partial[e];
  for (int c = 1; c < chunks; ++c) s += partial[static_cast<int64_t>(c) * n + e];
  acc[e] = store_as<IO>(s);
}

template <typename IO>
using KernelFn = void (*)(const IO*, int64_t, const Staged<IO>*, int, int,
                          Compute<IO>, Compute<IO>, Compute<IO>*);

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

// `packed` holds (B, K_pad, 4) and `partial` (B, S, M, 3) elements of the
// compute type (for bf16, `packed` holds its Body2 words in the same 16
// bytes a source). fp32 and fp64 with S = 1 write acc directly; bf16
// always writes fp32 partials and rounds them once in the reduce kernel.
// `batch` slots of (M, 3), (K, 3), (K,) and (M, 3) arrays lie back to
// back; each of the three kernels takes the slot as a grid axis, so a
// batch is one launch of each (B = 1 is the solo launch).
template <typename IO>
int launch(const void* pos_i, int64_t m, const void* pos_j, const void* gm_j,
           int64_t k, double eps2, double cutoff2, int masked, int chunks,
           void* packed, void* partial, void* acc, void* stream,
           int batch = 1) {
  using T = Compute<IO>;
  if (m <= 0 || batch == 0) return 0;
  const int n_tiles = static_cast<int>((k + kTile - 1) / kTile);
  if (chunks < 1 || (n_tiles > 0 && chunks > n_tiles) ||
      (n_tiles == 0 && chunks != 1) || batch < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Staged<IO>* pk = static_cast<Staged<IO>*>(packed);
  const int64_t k_pad = static_cast<int64_t>(n_tiles) * kTile;
  const unsigned slots = static_cast<unsigned>(batch);
  if (k_pad > 0) {
    nbody_pack_kernel<IO>
        <<<dim3(static_cast<unsigned>((k_pad + 255) / 256), slots), 256, 0,
           s>>>(static_cast<const IO*>(pos_j), static_cast<const IO*>(gm_j),
                k, k_pad, pk);
  }
  const bool direct = chunks == 1 && std::is_same_v<IO, T>;
  T* out = static_cast<T*>(direct ? acc : partial);
  const dim3 grid(static_cast<unsigned>((m + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(chunks), slots);
  pick_kernel<IO>(masked, eps2, cutoff2)<<<grid, kThreads, 0, s>>>(
      static_cast<const IO*>(pos_i), m, pk, n_tiles, chunks,
      static_cast<T>(eps2), static_cast<T>(cutoff2), out);
  if (!direct) {
    const int64_t n = 3 * m;
    nbody_reduce_kernel<IO>
        <<<dim3(static_cast<unsigned>((n + 255) / 256), slots), 256, 0,
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

// The batched launch: `batch` slots (at most 65,535) of the arrays above,
// each slot's arrays contiguous after the one before; `packed` and
// `partial` hold a slot's scratch for each slot. One launch of each
// kernel for the whole batch; slot b's result has the bits of a solo
// launch on slot b's arrays with the same `chunks`.
#define NBODY_DIRECT_BATCHED(NAME, IO)                                      \
  extern "C" int NAME(const void* pos_i, int64_t m, const void* pos_j,     \
                      const void* gm_j, int64_t k, double eps2,            \
                      double cutoff2, int masked, int chunks, void* packed, \
                      void* partial, void* acc, void* stream, int batch) {  \
    return launch<IO>(pos_i, m, pos_j, gm_j, k, eps2, cutoff2, masked,     \
                      chunks, packed, partial, acc, stream, batch);        \
  }
NBODY_DIRECT_BATCHED(nbody_direct_batched_f32, float)
NBODY_DIRECT_BATCHED(nbody_direct_batched_f64, double)
NBODY_DIRECT_BATCHED(nbody_direct_batched_bf16, bf16)
#undef NBODY_DIRECT_BATCHED

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
