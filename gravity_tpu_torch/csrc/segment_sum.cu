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
//   out[s, c] = ((+0 + v[i0, c]) + v[i1, c]) + ..., each add rounded,
//
// over the rows i0 < i1 < ... whose id is s, in element order. So a
// segment of ones stalls at 256, as in the JAX package. A NaN total is
// written as 0x7fc0, the bits the CPU's bf16 rounding gives every NaN.
// The wrapper hands the rows already gathered in segment order and
// column-major, (cols, stride) with each column contiguous (a stable sort
// of the ids, which keeps element order inside a segment), and each
// segment's start.
//
// Why not index_add_: on the card it adds with bf16 atomics, whose order,
// and so whose stalled totals, change from run to run, and which serialise
// where many rows share a segment (37.7 s for a bf16 octree build at
// 1,048,576 bodies on an H100 80GB HBM3 at 700 W, PERF.md).
//
// What bounds it: the contract makes a segment's column one chain of
// dependent adds, and it may not be split. So a sum takes at least its
// longest segment's rows times the latency of one add; bytes (2 a row and
// column) come far below that wherever a segment is long, as at an
// octree's coarse levels (all 1,048,576 rows of the 1M disk in one
// segment at level 0).
//
// Design:
// - One add.rn.bf16 a row: the accumulator is a bf16 register and each
//   step rounds the exact sum once, which gives the bits of the fp32 add
//   rounded to bf16 (fp32's 24 bits are at least 2 x 8 + 2;
//   tests/test_torch_bf16_rounding.py). Nothing else sits in the chain:
//   no conversion, no widening, no shuffle.
// - One thread a (segment, column): the columns of a segment run side by
//   side in neighbouring lanes, and an empty segment costs a read of its
//   start and one write.
// - Loads outside the chain: a thread reads its column in aligned 16-byte
//   chunks of 8 rows into a ring of registers filled ahead of the adds.
//   The chunks at the segment's two ends are read whole and their rows
//   outside the segment replaced by -0.0, which adds nothing (x + -0 = x
//   for every x, +0 + -0 = +0), so every add is unconditional.
// - Two grids, one launch call: segments of fewer than kLongRows rows take
//   a thread each with a ring of kShortRing chunks, few registers and a
//   full card of threads (the leaf level of an octree: 2,097,152 cells,
//   most of them empty); a segment of at least kLongRows rows is taken by
//   the long grid, one thread a column with a ring of kLongRing chunks
//   (256 rows, ~1,250 cycles of the chain: a trip to HBM). The long grid
//   has a thread for every kLongRows-th row; the one whose row is the
//   first such row of its segment (found by binary search in the starts)
//   sums it, so each long segment is summed once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // threads a block, both grids
constexpr int kMaxCols = 8;
constexpr int kLongRows = 256;  // a segment this long goes to the long grid
constexpr int kShortRing = 4;   // 16-byte chunks in flight, short segments
constexpr int kLongRing = 32;   // and long ones
constexpr uint32_t kNegZero = 0x8000u;
constexpr uint16_t kNaN = 0x7fc0u;

__device__ __forceinline__ uint16_t add_bf16(uint16_t a, uint16_t b) {
  uint16_t d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// The two rows of a 32-bit word, the lower address first.
__device__ __forceinline__ uint16_t add_word(uint16_t acc, uint32_t w) {
  uint16_t lo, hi;
  asm("mov.b32 {%0, %1}, %2;" : "=h"(lo), "=h"(hi) : "r"(w));
  return add_bf16(add_bf16(acc, lo), hi);
}

__device__ __forceinline__ uint16_t add_chunk(uint16_t acc, uint4 v) {
  acc = add_word(acc, v.x);
  acc = add_word(acc, v.y);
  acc = add_word(acc, v.z);
  return add_word(acc, v.w);
}

// The chunk's rows e outside [first, end) replaced by -0.0.
__device__ __forceinline__ uint4 keep(uint4 v, int first, int end) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (e < first || e >= end) {
      const int shift = 16 * (e & 1);
      w[e >> 1] = (w[e >> 1] & ~(0xffffu << shift)) | (kNegZero << shift);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One column's chain over rows [lo, hi): chunks k0 = lo / 8 up to
// ceil(hi / 8), the first and the last masked, the rest through a ring of
// RING chunks loaded RING chunks ahead of their adds.
template <int RING>
__device__ __forceinline__ uint16_t chain(const uint4* __restrict__ col,
                                          int64_t lo, int64_t hi) {
  uint16_t acc = 0;  // +0
  if (lo >= hi) return acc;
  const int64_t k0 = lo >> 3;
  const int64_t k1 = (hi + 7) >> 3;
  const uint4 head = __ldg(col + k0);
  const uint4 tail = __ldg(col + k1 - 1);
  const uint4* body = col + k0 + 1;
  const int64_t nb = k1 - k0 - 2;  // whole chunks between head and tail
  uint4 ring[RING];
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    if (j < nb) ring[j] = __ldg(body + j);
  }
  const int head_end = static_cast<int>(hi - 8 * k0 < 8 ? hi - 8 * k0 : 8);
  acc = add_chunk(acc, keep(head, static_cast<int>(lo - 8 * k0), head_end));
  int64_t k = 0;
  for (; k + RING <= nb; k += RING) {
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      const uint4 v = ring[j];
      if (k + RING + j < nb) ring[j] = __ldg(body + k + RING + j);
      acc = add_chunk(acc, v);
    }
  }
#pragma unroll
  for (int j = 0; j < RING; ++j) {
    if (k + j < nb) acc = add_chunk(acc, ring[j]);
  }
  if (k1 - k0 > 1) {
    acc = add_chunk(acc, keep(tail, 0, static_cast<int>(hi - 8 * (k1 - 1))));
  }
  return acc;
}

__device__ __forceinline__ uint16_t finish(uint16_t acc) {
  return (acc & 0x7fffu) > 0x7f80u ? kNaN : acc;
}

__device__ __forceinline__ const uint4* column(const uint16_t* rows,
                                               int64_t stride, int c) {
  return reinterpret_cast<const uint4*>(rows + c * stride);
}

// Thread t: segment t / cols, column t % cols, for a segment of fewer than
// kLongRows rows.
__global__ void __launch_bounds__(kThreads)
    segment_sum_short_kernel(const uint16_t* __restrict__ rows,
                             int64_t stride,
                             const int64_t* __restrict__ starts, int64_t n,
                             int cols, uint16_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * cols) return;
  const int64_t s = t / cols;
  const int c = static_cast<int>(t - s * cols);
  const int64_t lo = starts[s];
  const int64_t hi = starts[s + 1];
  if (hi - lo >= kLongRows) return;  // the long grid's
  out[t] = finish(chain<kShortRing>(column(rows, stride, c), lo, hi));
}

// Thread t: row r = b * kLongRows for b = t / cols, column t % cols. It
// sums the segment holding r if that segment has at least kLongRows rows
// and r is its first multiple of kLongRows.
__global__ void __launch_bounds__(kThreads)
    segment_sum_long_kernel(const uint16_t* __restrict__ rows,
                            int64_t stride,
                            const int64_t* __restrict__ starts, int64_t n,
                            int64_t blocks, int cols,
                            uint16_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= blocks * cols) return;
  const int64_t b = t / cols;
  const int c = static_cast<int>(t - b * cols);
  const int64_t r = b * kLongRows;
  int64_t first = 0, last = n;  // the last s in [0, n) with starts[s] <= r
  while (last - first > 1) {
    const int64_t mid = (first + last) >> 1;
    if (starts[mid] <= r) {
      first = mid;
    } else {
      last = mid;
    }
  }
  const int64_t lo = starts[first];
  const int64_t hi = starts[first + 1];
  if (r < lo || r >= hi || hi - lo < kLongRows || r - lo >= kLongRows) return;
  out[first * cols + c] =
      finish(chain<kLongRing>(column(rows, stride, c), lo, hi));
}

}  // namespace

// Plain C interface, bound with ctypes (ops/cells.py). Device pointers of
// contiguous arrays: rows (cols, stride) bf16, column-major in segment
// order, 16-byte aligned, stride a multiple of 8 and at least n_rows (rows
// past n_rows are read at a segment's last chunk but never added); starts
// (n + 1,) int64, non-decreasing, starts[n] <= n_rows; out (n, cols) bf16;
// 1 <= cols <= 8. Launches the short grid, then the long one, on
// ``stream``. Returns the first nonzero cudaGetLastError() of the two
// launches as an int (cudaErrorInvalidValue for arguments out of range).
extern "C" int segment_sum_bf16(const void* rows, int64_t stride,
                                int64_t n_rows, const void* starts,
                                int64_t n, int cols, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  if (cols < 1 || cols > kMaxCols || stride % 8 != 0 || stride < n_rows ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint16_t*>(rows);
  const auto* st = static_cast<const int64_t*>(starts);
  auto* o = static_cast<uint16_t*>(out);
  segment_sum_short_kernel<<<
      static_cast<unsigned>((n * cols + kThreads - 1) / kThreads),
      kThreads, 0, s>>>(r, stride, st, n, cols, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_rows < kLongRows) return static_cast<int>(err);
  const int64_t blocks = (n_rows + kLongRows - 1) / kLongRows;
  segment_sum_long_kernel<<<
      static_cast<unsigned>((blocks * cols + kThreads - 1) / kThreads),
      kThreads, 0, s>>>(r, stride, st, n, blocks, cols, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
