// Segment sums of bf16 rows, rounded to bf16 after every add, written by
// hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package sums cell totals with
// jax.ops.segment_sum, an XLA scatter-add (gravity_tpu/ops/tree.py:137,
// :138 and :160; gravity_tpu/ops/pallas_nlist.py:1009-1010), which at
// bf16 rounds to bf16 after every add, in element order on the CPU. Same
// contract as the plain PyTorch version gravity_tpu_torch/ops/cells.py::
// segment_sum_bf16_plain (the CPU's index_add_ column by column): for
// every segment s and column c,
//
//   out[s, c] = ((0 + v[i0, c]) + v[i1, c]) + ..., each add rounded,
//
// over the rows i0 < i1 < ... whose id is s, in element order. So a
// segment of ones stalls at 256, as in the JAX package. The wrapper hands
// the rows already gathered in segment order (a stable argsort of the ids,
// which keeps element order inside a segment) and each segment's start.
//
// Why not index_add_: on the card it adds with bf16 atomics, whose order,
// and so whose stalled totals, change from run to run, and which serialise
// where many rows share a segment: a bf16 octree build at 1,048,576 bodies
// (a few coarse cells hold all of them, 80 sums of one to six columns)
// took 37.7 s of index_add_ on an H100 80GB HBM3 at 700 W, against 0.4 s
// for the fp32 build (PERF.md).
//
// Design: one warp a segment. The warp loads 32 rows at a time, one a lane
// (C columns, coalesced), and then adds them into C accumulators in row
// order, each lane broadcasting its row by a shuffle in turn; every lane
// keeps the same accumulators, and lane c writes column c. The adds are a
// dependent chain (fp32 add, then round: exact for two bf16 values whose
// exponents differ by at most 16, and where they differ more the fp32
// rounding cannot move the bf16 result), so a segment of m rows takes ~m
// chain steps: what bounds it is the latency of that chain in the largest
// segment, not bytes (which are C * 2 bytes a row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (segments) a block
constexpr int kMaxCols = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int C>
__global__ void __launch_bounds__(32 * kWarps)
    segment_sum_bf16_kernel(const bf16* __restrict__ rows,
                            const int64_t* __restrict__ starts, int64_t n,
                            bf16* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t seg =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (seg >= n) return;
  const int64_t lo = starts[seg];
  const int64_t hi = starts[seg + 1];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int64_t base = lo; base < hi; base += 32) {
    const int m = static_cast<int>(hi - base < 32 ? hi - base : 32);
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = lane < m ? __bfloat162float(rows[(base + lane) * C + c]) : 0.0f;
    }
    for (int i = 0; i < m; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] = rnd(acc[c] + __shfl_sync(0xffffffffu, v[c], i));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (lane == c) out[seg * C + c] = __float2bfloat16_rn(acc[c]);
  }
}

template <int C>
int launch(const void* rows, const void* starts, int64_t n, void* out,
           cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  segment_sum_bf16_kernel<C><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const bf16*>(rows), static_cast<const int64_t*>(starts), n,
      static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/cells.py). Device pointers of
// contiguous arrays: rows (N, cols) bf16 in segment order, starts (n + 1,)
// int64 with starts[n] = N, out (n, cols) bf16; 1 <= cols <= 8. Returns
// the launch's cudaGetLastError() as an int (cudaErrorInvalidValue for
// cols out of range).
extern "C" int segment_sum_bf16(const void* rows, const void* starts,
                                int64_t n, int cols, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 1: return launch<1>(rows, starts, n, out, s);
    case 2: return launch<2>(rows, starts, n, out, s);
    case 3: return launch<3>(rows, starts, n, out, s);
    case 4: return launch<4>(rows, starts, n, out, s);
    case 5: return launch<5>(rows, starts, n, out, s);
    case 6: return launch<6>(rows, starts, n, out, s);
    case 7: return launch<7>(rows, starts, n, out, s);
    case kMaxCols: return launch<kMaxCols>(rows, starts, n, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
