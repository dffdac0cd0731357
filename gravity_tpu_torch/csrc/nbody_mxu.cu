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
// The wrapper subtracts (sum_j w_ij) x_i afterwards. Norms, the cross
// term and the sums are fp32. The bf16 variant takes bf16 operands
// (rounded to nearest even by the wrapper), rounds w to bf16 before
// summing, and sums in fp32; a bf16 x bf16 product is exact in fp32, so
// this is the TPU matrix unit's arithmetic up to the order of the sums.
// The cross term and the [x_j | 1] sums are fp32 FFMA, not tensor cores:
// with TF32's 10-bit mantissa the Gram cancellation error would sit far
// above tau = 16 * 2^-24, and self-pair residue would pass the mask.
//
// What bounds it: FP32-pipe and SFU operations, ~22 flops a pair (the JAX
// cost model, pallas_forces_mxu.py:238) and one rsqrt, against O(N)
// bytes. Design: as csrc/nbody_direct.cu, one thread per target, 256
// threads a block, sources staged 256 at a time in shared memory as
// (x, y, z, |x|^2) and G*m, each tile summed apart and then added to the
// running total. The norms, the cross term, r^2 and the noise floor are
// formed with __f*_rn intrinsics, which are never contracted into FMAs,
// so they round as the plain version's separate tensor ops do and the
// masks select the same pairs.
//
// Build WITHOUT --use_fast_math (keeps subnormal weights; see
// nbody_direct.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

template <typename In, bool BF16>
__global__ void __launch_bounds__(kBlock)
    nbody_mxu_kernel(const In* __restrict__ xi_in, int64_t m,
                     const In* __restrict__ xj_in,
                     const float* __restrict__ gm_j, int64_t k, float eps2,
                     float cutoff2, float tau, float* __restrict__ out4) {
  __shared__ float4 tile[kBlock];  // x, y, z, |x|^2
  __shared__ float tile_gm[kBlock];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool active = i < m;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (active) {
    xi = to_f32(xi_in[3 * i]);
    yi = to_f32(xi_in[3 * i + 1]);
    zi = to_f32(xi_in[3 * i + 2]);
  }
  const float ni = norm2(xi, yi, zi);
  float ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;
  for (int64_t base = 0; base < k; base += kBlock) {
    const int64_t j = base + threadIdx.x;
    if (j < k) {
      const float x = to_f32(xj_in[3 * j]);
      const float y = to_f32(xj_in[3 * j + 1]);
      const float z = to_f32(xj_in[3 * j + 2]);
      tile[threadIdx.x] = make_float4(x, y, z, norm2(x, y, z));
      tile_gm[threadIdx.x] = gm_j[j];
    }
    __syncthreads();
    const int jn = static_cast<int>(k - base < kBlock ? k - base : kBlock);
    float tx = 0.f, ty = 0.f, tz = 0.f, tw = 0.f;
    for (int jj = 0; jj < jn; ++jj) {
      const float4 s = tile[jj];
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(xi, s.x), __fmul_rn(yi, s.y)),
          __fmul_rn(zi, s.z));
      const float sum_n = __fadd_rn(ni, s.w);
      const float r2 = fmaxf(__fsub_rn(sum_n, __fmul_rn(2.f, cross)), 0.f);
      const float r2s = __fadd_rn(r2, eps2);
      const bool ok = r2 > __fmul_rn(tau, sum_n) && r2s > cutoff2;
      const float inv_r = rsqrtf(ok ? r2s : 1.f);
      float w = ok ? ((tile_gm[jj] * inv_r) * inv_r) * inv_r : 0.f;
      if (BF16) w = __bfloat162float(__float2bfloat16_rn(w));
      tx += w * s.x;
      ty += w * s.y;
      tz += w * s.z;
      tw += w;
    }
    ax += tx;
    ay += ty;
    az += tz;
    aw += tw;
    __syncthreads();
  }
  if (active) {
    out4[4 * i] = ax;
    out4[4 * i + 1] = ay;
    out4[4 * i + 2] = az;
    out4[4 * i + 3] = aw;
  }
}

template <typename In, bool BF16>
int launch(const void* xi, int64_t m, const void* xj, const void* gm_j,
           int64_t k, double eps2, double cutoff2, double tau, void* out4,
           void* stream) {
  if (m <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((m + kBlock - 1) / kBlock);
  nbody_mxu_kernel<In, BF16>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const In*>(xi), m, static_cast<const In*>(xj),
          static_cast<const float*>(gm_j), k, static_cast<float>(eps2),
          static_cast<float>(cutoff2), static_cast<float>(tau),
          static_cast<float*>(out4));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/mxu_kernel.py). Device
// pointers of contiguous arrays: xi (M, 3) and xj (K, 3) centred
// operands (fp32, or bf16 for the _bf16 entry), gm_j (K,) fp32 G * m_j,
// out4 (M, 4) fp32. eps2 and cutoff2 arrive already rounded to fp32.
// Returns the launch's cudaGetLastError() as an int.
extern "C" int nbody_mxu_f32(const void* xi, int64_t m, const void* xj,
                             const void* gm_j, int64_t k, double eps2,
                             double cutoff2, double tau, void* out4,
                             void* stream) {
  return launch<float, false>(xi, m, xj, gm_j, k, eps2, cutoff2, tau, out4,
                              stream);
}

extern "C" int nbody_mxu_bf16(const void* xi, int64_t m, const void* xj,
                              const void* gm_j, int64_t k, double eps2,
                              double cutoff2, double tau, void* out4,
                              void* stream) {
  return launch<__nv_bfloat16, true>(xi, m, xj, gm_j, k, eps2, cutoff2, tau,
                                     out4, stream);
}

extern "C" const char* nbody_mxu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
