// Gram-form direct sum, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel gravity_tpu/ops/pallas_forces_mxu.py::
// _nbody_mxu_kernel (reached through pallas_accelerations_vs_mxu). Same
// contract as the plain PyTorch version gravity_tpu_torch/ops/
// mxu_kernel.py::gram_acc4_plain: for centred targets x_i and sources x_j,
//
//   r^2  = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)        (the Gram trick)
//   w_ij = G m_j / (r^2 + eps^2)^{3/2}  where r^2 > tau (|x_i|^2 + |x_j|^2)
//          (the raw r^2: the noise floor) and r^2 + eps^2 > cutoff^2
//   out_i = [sum_j w_ij x_j | sum_j w_ij]                  (fp32)
//
// The wrapper subtracts (sum_j w_ij) x_i afterwards. The bf16 variant
// takes bf16 operands, rounds w to bf16 (nearest even) and sums in fp32.
//
// Where the work runs. A pair's mask and weight stay on the CUDA cores
// with the plain version's roundings: the norms, the cross term, r^2,
// r^2 + eps^2 and tau s are formed with __f*_rn intrinsics, which are
// never contracted into FMAs, so the kernel selects exactly the plain
// version's pairs. That matters: at eps = 1e9 m and |x| ~ 1e11 m a pair at
// the noise floor (r ~ 1e8 m) weighs ~1e6 times a typical term, so one
// rounding of r^2 that flips it across the mask moves the row by orders of
// magnitude more than the tolerance; the cross term therefore stays off
// the tensor cores (TF32's 10-bit mantissa would put its error far above
// tau = 2^-20). Only the accumulation [S | W] = sum_j w_ij [x_j | 1] runs
// on the tensor cores, as an m16n8 matrix product per warp:
// - fp32 operands: mma.m16n8k8 in TF32 with a hi/lo split. B's eight
//   columns are [x_hi, y_hi, z_hi, 1, x_lo, y_lo, z_lo, 0] (x = x_hi +
//   x_lo, each rounded to TF32 to nearest, ties away, by the pack
//   kernel), and A is w split in registers: w_hi rounded so, w_lo = w -
//   w_hi left for the tensor core to cut to TF32 (it reads an operand's
//   top 19 bits, as CUTLASS's 3xTF32 relies on), an error below 2^-21 |w|
//   of either sign. D += W_hi B and D += W_lo B give all four cross
//   products, and S = D[:, 0:3] + D[:, 4:7], W = D[:, 3]. Plain TF32 would
//   leave the all-positive W ~5e-4 low, above the tolerance.
// - bf16 operands: mma.m16n8k16 in bf16, B = [x, y, z, 1, 0, 0, 0, 0];
//   a bf16 x bf16 product is exact in fp32.
// Each lane computes its weights directly in the A-fragment layout (PTX
// ISA, "Matrix Fragments for mma.m16n8k8 / m16n8k16"), and the same
// sources give it its B fragment, so no shuffle sits between the weight
// pipeline and the MMA.
//
// What bounds it: the pair's ~20 issued instructions on the CUDA cores
// (cross term, r^2, masks, weight, split; ~17 in bf16) and one rsqrt on
// the special function units; the tensor cores take the 8 flops a pair of
// the accumulation, and the inputs are O(N) bytes. The design:
// - a warp holds kR m-tiles (16 kR targets, 2 kR a lane in registers), so
//   each source a lane loads from shared memory serves 2 kR pairs;
// - sources are packed once a call (a pack kernel of this file) in the
//   fragment order, (-2 x, -2 y, -2 z, |x|^2), G m and the B operand, and
//   each 256-source tile is staged with 16-byte cp.async copies into a
//   double buffer: one barrier a tile. Staging -2 x_j is exact (a power of
//   two) and saves the product by 2; padding carries G m = 0 and B = 0;
// - the source axis is split into `chunks` runs of whole tiles
//   (blockIdx.y), chosen by the wrapper from M, K, the SM count and the
//   occupancy (ops/direct_kernel.py::source_chunks), and a second kernel
//   adds the chunk partials in the order 0..S-1: no atomics, the same bits
//   every run;
// - where eps^2 > cutoff^2 (the softened runs) the cutoff test is left
//   out: every pair past the noise floor passes it;
// - rsqrt takes rsqrt.approx.ftz.f32 whenever the least r^2 + eps^2 of a
//   selected pair (above cutoff^2, or at least eps^2) is a normal number,
//   where ftz gives the same bits. A pair that is not selected may take
//   any rsqrt, since its weight is replaced by 0 in a select.
//
// Batched launches (the serve engine): each of the three kernels takes the
// slot as one more grid axis and offsets its pointers by the slot's
// stride; a slot's blocks do a solo launch's work with the same chunking,
// so each slot has a solo launch's bits (nbody_direct.cu says more).
//
// Rounding: the hardware does not promise that the adds inside mma.sync
// round like FADD, so each 256-source tile is summed in a fresh fragment
// and its total added to the chunk total with __fadd_rn, and the chunk
// totals are added in order: ~(256/8 + K/(256 S) + S) ulp of a row's
// sum of |terms|, S <= 64.
//
// Build WITHOUT --use_fast_math: the weight ((G m inv_r) inv_r) inv_r keeps
// its subnormal values (see nbody_direct.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarps = 4;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 2;                      // m-tiles of 16 targets a warp
constexpr int kBlockM = kWarps * 16 * kR;  // targets a block
constexpr int kTile = 256;                 // sources a staged tile

// Packed sources, per tile of kTile, three arrays in fragment order:
//   pos[kTile]   float4 (-2 x, -2 y, -2 z, |x|^2), source order;
//   gm           fp32: float2 (gm[8s + t], gm[8s + t + 4]) for k-step s
//                and lane column t; bf16: float4 (gm[16s + 2t],
//                gm[16s + 2t + 1], gm[16s + 2t + 8], gm[16s + 2t + 9]);
//   b            the B fragment of lane (g, t) at k-step s, 8 bytes:
//                fp32 (B[8s + t][g], B[8s + t + 4][g]) as TF32 in fp32
//                words; bf16 the pairs (B[16s + 2t][g], B[16s + 2t + 1][g])
//                and (B[16s + 2t + 8][g], B[16s + 2t + 9][g]).
template <bool BF16>
struct Layout {
  static constexpr int kPos = kTile * 16;
  static constexpr int kGm = kTile * 4;
  static constexpr int kB = kTile * (BF16 ? 16 : 32);
  static constexpr int kBytes = kPos + kGm + kB;  // a tile
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
// zero, as cvt.rna.tf32.f32 on finite values: the result's low 13 bits
// are 0, so the tensor core reads it whole.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
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

// The pair's weight, with the plain version's roundings. p holds the
// source's (-2 x, -2 y, -2 z, |x|^2), so c = -2 x_i . x_j exactly and
// r2 = s + c is the plain version's s - 2 cross. r2 is not clamped at 0:
// a negative r2 fails the noise floor, as the clamped 0 does, and a
// selected pair has r2 > 0 either way. Without CUTOFF (the launch takes
// it when eps^2 > cutoff^2) the cutoff test is left out: a pair past the
// noise floor has r2 > 0, so r2 + eps^2 >= eps^2 > cutoff^2 already.
template <bool CUTOFF, bool FTZ>
__device__ __forceinline__ float weight(float xi, float yi, float zi,
                                        float ni, float4 p, float gm,
                                        float eps2, float cutoff2,
                                        float tau) {
  const float c = __fadd_rn(__fadd_rn(__fmul_rn(xi, p.x), __fmul_rn(yi, p.y)),
                            __fmul_rn(zi, p.z));
  const float s = __fadd_rn(ni, p.w);
  const float r2 = __fadd_rn(s, c);
  const float r2s = __fadd_rn(r2, eps2);
  const bool ok = r2 > __fmul_rn(tau, s) && (!CUTOFF || r2s > cutoff2);
  const float inv_r = rsqrt_t<FTZ>(r2s);
  return ok ? ((gm * inv_r) * inv_r) * inv_r : 0.f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two weights as the bf16x2 word of an A fragment: `lo` (the lower
// column) in the low half, both rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// One packed tile into shared memory, 16 bytes a copy.
template <bool BF16>
__device__ __forceinline__ void stage(char* dst, const char* src) {
  for (int c = threadIdx.x; c < Layout<BF16>::kBytes / 16; c += kThreads) {
    cp_async16(dst + 16 * c, src + 16 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Column g of source j's B row: fp32 [x_hi, y_hi, z_hi, 1, x_lo, y_lo,
// z_lo, 0], bf16 [x, y, z, 1, 0, 0, 0, 0]; zero for padding.
template <bool BF16>
__device__ __forceinline__ float b_entry(const float (&x)[3], int g) {
  if (g == 3) return 1.f;
  if (g == 7 || (BF16 && g > 3)) return 0.f;
  const float v = x[g & 3];
  if (BF16) return v;
  const float hi = tf32_rna(v);
  return g < 3 ? hi : tf32_rna(__fsub_rn(v, hi));
}

// One thread a source slot j < k_pad; slots past k are zero.
template <typename In>
__global__ void nbody_mxu_pack_kernel(const In* __restrict__ xj_in,
                                      const float* __restrict__ gm_j,
                                      int64_t k, int64_t k_pad,
                                      char* __restrict__ packed) {
  constexpr bool BF16 = sizeof(In) == 2;
  using L = Layout<BF16>;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= k_pad) return;
  // Slot blockIdx.y of a batched launch.
  xj_in += static_cast<int64_t>(blockIdx.y) * k * 3;
  gm_j += static_cast<int64_t>(blockIdx.y) * k;
  packed += static_cast<int64_t>(blockIdx.y) * (k_pad / kTile) * L::kBytes;
  float x[3] = {0.f, 0.f, 0.f};
  float gm = 0.f;
  const bool real = j < k;
  if (real) {
    for (int c = 0; c < 3; ++c) x[c] = to_f32(xj_in[3 * j + c]);
    gm = gm_j[j];
  }
  char* tile = packed + (j / kTile) * L::kBytes;
  const int q = static_cast<int>(j % kTile);
  reinterpret_cast<float4*>(tile)[q] =
      real ? make_float4(-2.f * x[0], -2.f * x[1], -2.f * x[2],
                         norm2(x[0], x[1], x[2]))
           : make_float4(0.f, 0.f, 0.f, 0.f);
  float* gms = reinterpret_cast<float*>(tile + L::kPos);
  if (BF16) {
    // k-step s = q / 16; within it, q % 16 = 2t + e + 8 h.
    const int s = q / 16, r = q % 16, h = r / 8, t = (r % 8) / 2, e = r % 2;
    const int slot = (s * 4 + t) * 4 + 2 * h + e;  // in gm words, b halves
    gms[slot] = gm;
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(tile + L::kPos +
                                                        L::kGm);
    for (int g = 0; g < 8; ++g) {
      b[((s * 4 + t) * 8 + g) * 4 + 2 * h + e] =
          __float2bfloat16_rn(real ? b_entry<true>(x, g) : 0.f);
    }
  } else {
    // k-step s = q / 8; within it, q % 8 = t + 4 h.
    const int s = q / 8, t = q % 4, h = (q % 8) / 4;
    gms[(s * 4 + t) * 2 + h] = gm;
    float* b = reinterpret_cast<float*>(tile + L::kPos + L::kGm);
    for (int g = 0; g < 8; ++g) {
      b[((s * 4 + t) * 8 + g) * 2 + h] = real ? b_entry<false>(x, g) : 0.f;
    }
  }
}

// Block (x, c, b): slot b's targets [x kBlockM, (x + 1) kBlockM) against
// the tiles of its chunk c, tiles [c n / S, (c + 1) n / S). Writes
// out[b][c][i][:] (out is the result itself when chunks == 1); a slot's
// blocks do a solo launch's work on that slot's arrays, with its bits. Warp w holds m-tiles of rows
// x kBlockM + 16 (kR w + r) + [0, 16); lane 4 g + t holds rows g and g + 8
// of each (PTX fragment layout: groupID g, threadID_in_group t).
template <typename In, bool CUTOFF, bool FTZ>
__global__ void __launch_bounds__(kThreads)
    nbody_mxu_kernel(const In* __restrict__ xi_in, int64_t m,
                     const char* __restrict__ packed, int n_tiles, int chunks,
                     float eps2, float cutoff2, float tau,
                     float* __restrict__ out) {
  constexpr bool BF16 = sizeof(In) == 2;
  using L = Layout<BF16>;
  __shared__ __align__(16) char smem[2][L::kBytes];
  const int c = blockIdx.y;
  const int64_t slot = blockIdx.z;
  xi_in += slot * m * 3;
  packed += slot * n_tiles * L::kBytes;
  out += slot * chunks * m * 4;
  const int t_lo = static_cast<int>(static_cast<int64_t>(c) * n_tiles /
                                    chunks);
  const int t_hi = static_cast<int>(static_cast<int64_t>(c + 1) * n_tiles /
                                    chunks);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBlockM +
                       (threadIdx.x / 32) * 16 * kR + g;
  // Targets [r][h]: row row0 + 16 r + 8 h.
  float xi[kR][2], yi[kR][2], zi[kR][2], ni[kR][2], acc[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t i = row0 + 16 * r + 8 * h;
      xi[r][h] = yi[r][h] = zi[r][h] = 0.f;
      if (i < m) {
        xi[r][h] = to_f32(xi_in[3 * i]);
        yi[r][h] = to_f32(xi_in[3 * i + 1]);
        zi[r][h] = to_f32(xi_in[3 * i + 2]);
      }
      ni[r][h] = norm2(xi[r][h], yi[r][h], zi[r][h]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
  if (t_lo < t_hi) {
    stage<BF16>(smem[0], packed + static_cast<int64_t>(t_lo) * L::kBytes);
  }
  for (int tile = t_lo; tile < t_hi; ++tile) {
    // This tile has landed for every thread, and every thread is done
    // with the one before it, whose buffer the next copy refills.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (tile + 1 < t_hi) {
      stage<BF16>(smem[(tile + 1 - t_lo) & 1],
                  packed + static_cast<int64_t>(tile + 1) * L::kBytes);
    }
    const char* buf = smem[(tile - t_lo) & 1];
    const float4* pos = reinterpret_cast<const float4*>(buf);
    float d[kR][4];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[r][e] = 0.f;
    }
    if (BF16) {
      const float4* gms = reinterpret_cast<const float4*>(buf + L::kPos);
      const uint2* bs = reinterpret_cast<const uint2*>(buf + L::kPos + L::kGm);
#pragma unroll 2
      for (int s = 0; s < kTile / 16; ++s) {
        // Sources 16 s + {2t, 2t + 1, 2t + 8, 2t + 9}: A columns 2t, 2t + 1
        // (a0, a1) and 2t + 8, 2t + 9 (a2, a3).
        const float4 p[4] = {pos[16 * s + 2 * t], pos[16 * s + 2 * t + 1],
                             pos[16 * s + 2 * t + 8],
                             pos[16 * s + 2 * t + 9]};
        const float4 gm = gms[s * 4 + t];
        const float gmv[4] = {gm.x, gm.y, gm.z, gm.w};
        const uint2 b = bs[(s * 4 + t) * 8 + g];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float w[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              w[h][q] = weight<CUTOFF, FTZ>(xi[r][h], yi[r][h], zi[r][h], ni[r][h],
                                    p[q], gmv[q], eps2, cutoff2, tau);
            }
          }
          const uint32_t a[4] = {pack_bf16(w[0][0], w[0][1]),
                                 pack_bf16(w[1][0], w[1][1]),
                                 pack_bf16(w[0][2], w[0][3]),
                                 pack_bf16(w[1][2], w[1][3])};
          mma_bf16(d[r], a, b.x, b.y);
        }
      }
    } else {
      const float2* gms = reinterpret_cast<const float2*>(buf + L::kPos);
      const uint2* bs = reinterpret_cast<const uint2*>(buf + L::kPos + L::kGm);
#pragma unroll 2
      for (int s = 0; s < kTile / 8; ++s) {
        // Sources 8 s + t (A column t: a0, a1) and 8 s + t + 4 (a2, a3).
        const float4 p0 = pos[8 * s + t], p1 = pos[8 * s + t + 4];
        const float2 gm = gms[s * 4 + t];
        const uint2 b = bs[(s * 4 + t) * 8 + g];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float w[4] = {
              weight<CUTOFF, FTZ>(xi[r][0], yi[r][0], zi[r][0], ni[r][0], p0, gm.x,
                          eps2, cutoff2, tau),
              weight<CUTOFF, FTZ>(xi[r][1], yi[r][1], zi[r][1], ni[r][1], p0, gm.x,
                          eps2, cutoff2, tau),
              weight<CUTOFF, FTZ>(xi[r][0], yi[r][0], zi[r][0], ni[r][0], p1, gm.y,
                          eps2, cutoff2, tau),
              weight<CUTOFF, FTZ>(xi[r][1], yi[r][1], zi[r][1], ni[r][1], p1, gm.y,
                          eps2, cutoff2, tau)};
          // w = hi + lo; lo goes unrounded: the tensor core reads the top
          // 19 bits of a TF32 operand, as CUTLASS's 3xTF32 relies on, so
          // its error is below 2^-21 |w|, of either sign.
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = tf32_rna(w[e]);
            hi[e] = __float_as_uint(v);
            lo[e] = __float_as_uint(__fsub_rn(w[e], v));
          }
          mma_tf32(d[r], hi, b.x, b.y);
          mma_tf32(d[r], lo, b.x, b.y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = __fadd_rn(acc[r][e], d[r][e]);
    }
  }
  // Lane t holds columns 2t and 2t + 1 of rows g (e = 0, 1) and g + 8
  // (e = 2, 3); adding lane t ^ 2's gives lane 0 of the group (S_x, S_y)
  // = columns 0 + 4, 1 + 5 and lane 1 (S_z, W) = columns 2 + 6, 3 + 7
  // (column 7 is 0).
  float* o = out + static_cast<int64_t>(c) * m * 4;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __fadd_rn(acc[r][e], __shfl_xor_sync(0xffffffffu, acc[r][e], 2));
    }
    if (t < 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t i = row0 + 16 * r + 8 * h;
        if (i < m) {
          reinterpret_cast<float2*>(o + 4 * i)[t] =
              make_float2(v[2 * h], v[2 * h + 1]);
        }
      }
    }
  }
}

// acc[e] = partial[0][e] + partial[1][e] + ... in that order.
__global__ void nbody_mxu_reduce_kernel(const float* __restrict__ partial,
                                        int64_t n, int chunks,
                                        float* __restrict__ acc) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  // Slot blockIdx.y of a batched launch: partial (B, S, n), acc (B, n).
  partial += static_cast<int64_t>(blockIdx.y) * chunks * n;
  acc += static_cast<int64_t>(blockIdx.y) * n;
  float s = partial[e];
  for (int c = 1; c < chunks; ++c) {
    s = __fadd_rn(s, partial[static_cast<int64_t>(c) * n + e]);
  }
  acc[e] = s;
}

template <typename In>
using KernelFn = void (*)(const In*, int64_t, const char*, int, int, float,
                          float, float, float*);

// The instantiation a launch with these arguments takes: the cutoff test
// where eps^2 <= cutoff^2, and the ftz rsqrt where every selected pair's
// r^2 + eps^2 (> cutoff^2, or >= eps^2) is a normal number.
template <typename In>
KernelFn<In> pick_kernel(double eps2, double cutoff2) {
  const bool cutoff = eps2 <= cutoff2;
  const bool ftz = static_cast<float>(cutoff ? cutoff2 : eps2) >= FLT_MIN;
  if (cutoff) {
    return ftz ? nbody_mxu_kernel<In, true, true>
               : nbody_mxu_kernel<In, true, false>;
  }
  return ftz ? nbody_mxu_kernel<In, false, true>
             : nbody_mxu_kernel<In, false, false>;
}

// `batch` slots (B = 1 is the solo launch) of the arrays, back to back;
// `packed` and `partial` hold a slot's scratch for each slot. Each of the
// three kernels takes the slot as a grid axis: one launch of each a batch.
template <typename In>
int launch(const void* xi, int64_t m, const void* xj, const void* gm_j,
           int64_t k, double eps2, double cutoff2, double tau, int chunks,
           void* packed, void* partial, void* out4, void* stream,
           int batch = 1) {
  if (m <= 0 || batch == 0) return 0;
  const int n_tiles = static_cast<int>((k + kTile - 1) / kTile);
  if (chunks < 1 || (n_tiles > 0 && chunks > n_tiles) ||
      (n_tiles == 0 && chunks != 1) || batch < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* pk = static_cast<char*>(packed);
  const int64_t k_pad = static_cast<int64_t>(n_tiles) * kTile;
  const unsigned slots = static_cast<unsigned>(batch);
  if (k_pad > 0) {
    nbody_mxu_pack_kernel<In>
        <<<dim3(static_cast<unsigned>((k_pad + 255) / 256), slots), 256, 0,
           s>>>(static_cast<const In*>(xj), static_cast<const float*>(gm_j),
                k, k_pad, pk);
  }
  float* out = static_cast<float*>(chunks > 1 ? partial : out4);
  const dim3 grid(static_cast<unsigned>((m + kBlockM - 1) / kBlockM),
                  static_cast<unsigned>(chunks), slots);
  pick_kernel<In>(eps2, cutoff2)<<<grid, kThreads, 0, s>>>(
      static_cast<const In*>(xi), m, pk, n_tiles, chunks,
      static_cast<float>(eps2), static_cast<float>(cutoff2),
      static_cast<float>(tau), out);
  if (chunks > 1) {
    const int64_t n = 4 * m;
    nbody_mxu_reduce_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256),
                                   slots),
                              256, 0, s>>>(static_cast<const float*>(partial),
                                           n, chunks,
                                           static_cast<float*>(out4));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int blocks_per_sm(double eps2, double cutoff2) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pick_kernel<In>(eps2, cutoff2), kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/mxu_kernel.py). Device
// pointers of contiguous arrays: xi (M, 3) and xj (K, 3) centred
// operands (fp32, or bf16 for the _bf16 entry), gm_j (K,) fp32 G * m_j,
// out4 (M, 4) fp32. eps2 and cutoff2 arrive already rounded to fp32.
// `chunks` (S) splits the source axis; `packed` is scratch of
// ceil(K / tile) * nbody_mxu_shape(2 + bf16) bytes and `partial` of
// (S, M, 4) fp32 (unused when S = 1). Returns the launches'
// cudaGetLastError() as an int.
extern "C" int nbody_mxu_f32(const void* xi, int64_t m, const void* xj,
                             const void* gm_j, int64_t k, double eps2,
                             double cutoff2, double tau, int chunks,
                             void* packed, void* partial, void* out4,
                             void* stream) {
  return launch<float>(xi, m, xj, gm_j, k, eps2, cutoff2, tau, chunks,
                       packed, partial, out4, stream);
}

extern "C" int nbody_mxu_bf16(const void* xi, int64_t m, const void* xj,
                              const void* gm_j, int64_t k, double eps2,
                              double cutoff2, double tau, int chunks,
                              void* packed, void* partial, void* out4,
                              void* stream) {
  return launch<__nv_bfloat16>(xi, m, xj, gm_j, k, eps2, cutoff2, tau,
                               chunks, packed, partial, out4, stream);
}

// The batched launch: `batch` slots (at most 65,535) of the arrays above,
// each slot's arrays contiguous after the one before, and a slot's
// scratch for each slot. Slot b's out4 has the bits of a solo launch on
// slot b's arrays with the same `chunks`.
extern "C" int nbody_mxu_batched_f32(const void* xi, int64_t m,
                                     const void* xj, const void* gm_j,
                                     int64_t k, double eps2, double cutoff2,
                                     double tau, int chunks, void* packed,
                                     void* partial, void* out4, void* stream,
                                     int batch) {
  return launch<float>(xi, m, xj, gm_j, k, eps2, cutoff2, tau, chunks,
                       packed, partial, out4, stream, batch);
}

extern "C" int nbody_mxu_batched_bf16(const void* xi, int64_t m,
                                      const void* xj, const void* gm_j,
                                      int64_t k, double eps2, double cutoff2,
                                      double tau, int chunks, void* packed,
                                      void* partial, void* out4,
                                      void* stream, int batch) {
  return launch<__nv_bfloat16>(xi, m, xj, gm_j, k, eps2, cutoff2, tau,
                               chunks, packed, partial, out4, stream, batch);
}

// The launch shape the wrapper plans with: 0 -> targets a block, 1 ->
// sources a tile, 2 -> packed bytes a tile (fp32), 3 -> (bf16).
extern "C" int nbody_mxu_shape(int which) {
  switch (which) {
    case 0: return kBlockM;
    case 1: return kTile;
    case 2: return Layout<false>::kBytes;
    default: return Layout<true>::kBytes;
  }
}

// Blocks of the instantiation a launch with these arguments takes that
// one SM holds at once (a negative cudaError_t on failure).
extern "C" int nbody_mxu_blocks_per_sm(int bf16, double eps2,
                                       double cutoff2) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(eps2, cutoff2)
              : blocks_per_sm<float>(eps2, cutoff2);
}

extern "C" const char* nbody_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
