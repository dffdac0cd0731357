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
// The batched entries (nlist_pair_batched_*) are the same TPU kernel
// under the JAX serve engine's vmap (pallas_call's batching rule, an
// extra grid axis; gravity_tpu/serve/engine.py:418): B independent cell
// lists, one a slot, in one launch, the slot on grid.y (pair_cells).
// Each slot has its own bounding cube, so its own rcut_eff^2.
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
// The bf16 form (nlist_pair_bf16, newton kind with and without rcut)
// replaces the same TPU kernel on a bf16 state, where _nlist_kernel
// computes, accumulates and writes in the operands' dtype
// (pallas_nlist.py:322, :399). Its contract is that of the JAX tile
// engines, written out in pair_cells_plain's docstring: each op of a pair
// term is computed in fp32 and rounded to bf16 where the plain version
// holds a bf16 value (d, each d^2, r^2 with its three squares added in
// fp32 and rounded once, r^2 + eps^2, rsqrt, the weight's three
// products); each (cell, offset) row sum w d is formed in fp32 from the
// exact products and rounded to bf16 once, as jnp.einsum does
// (pallas_nlist.py:487); and the accumulator is bf16, rounded after each
// of the 27 offsets (:490-491): 27 + 27 roundings a target, not one a
// pair. The masks compare the rounded r^2 and r^2 + eps^2 with the bf16
// params (rcut_eff^2), eps^2 and cutoff^2, so a pair within 2^-9 of rcut
// is taken or left as the plain version takes it.
// Design: packed bf16x2 arithmetic on two sources of a target at once.
// A warp stages 128 sources at a time as pairs (s, s + 2) of x, y, z and
// G m, the first in the low half of each 32-bit word (Pair2, 16 bytes),
// so that lane q of a target reads the pair of sources q + 4k and q + 4k
// + 2 in one shared-memory load: the sources, and the order of each
// lane's sums, of the fp32 form. The target is held in both halves.
// Then d, the squares, r^2 + eps^2 and the weight's three products are
// one sub.rn.bf16x2, mul.rn.bf16x2 or add.rn.bf16x2 for both pairs,
// rounded once to nearest even: for +, - and x of bf16 operands the same
// bits as the fp32 op rounded to bf16 (fp32's 24 bits are at least 2 x 8
// + 2, so the double rounding is innocuous: Figueroa, 1995;
// tests/test_torch_bf16_rounding.py), bf16 sharing fp32's exponent
// range. r^2's squares are unpacked by integer ops (exact), added in fp32
// and packed by one cvt.rn.bf16x2.f32; the masks and the fp32 MUFU rsqrt
// (not a bf16 one: rsqrt.approx is not correctly rounded) read the
// unpacked values, and a second cvt packs the two rsqrts. So the kernel
// gives the bits of the op-by-op fp32 design it replaces, with 1
// conversion a pair where that design had 6 (at 16 a clock an SM, 1/8 of
// the FP32 pipe's rate). What bounds it now: issue (~26 instructions a
// pair) and the SFU's rsqrt. A pair cut by a mask takes inv_r = 0, so its
// weight is an exact 0 (G m is finite). FTZ as the fp32 form: bf16 has
// fp32's exponent range, and cutoff = 1e-10 gives a normal 1e-20.
//
// Build WITHOUT --use_fast_math: the weight is ((G m inv_r) inv_r) inv_r
// in that order, because inv_r^3 alone underflows in fp32 and a distant
// light pair's weight is subnormal; flushing subnormals would drop it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 16;             // target slots a warp (a work item)
constexpr int kQ = 32 / kGroup;        // source lanes a target
constexpr int kStage = 64;             // sources (bf16: pairs) a warp stages

template <typename T>
struct alignas(4 * sizeof(T)) Body {
  T x, y, z, gm;
};

// Two sources of the bf16 form, the bits of the first in the low half of
// each word and of the second in the high half.
struct alignas(16) Pair2 {
  uint32_t x, y, z, gm;
};

constexpr int kNewton = 0;
constexpr int kEwald = 1;

using bf16 = __nv_bfloat16;

// The element type IO (float, double or bf16) and the type the kernel
// computes, stages and sums in: fp32 for bf16.
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

// v rounded to bf16 (to nearest, even), back in fp32.
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
__device__ __forceinline__ uint32_t bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}

// The bf16 form's rsqrt of one pair: masked by the rounded r^2 and r^2 +
// eps^2 (fp32 values of bf16 ones) as pair_cells_plain masks them, 0
// where a mask cuts the pair.
template <bool USE_RCUT, bool FTZ>
__device__ __forceinline__ float inv_r_bf16(float r2, float r2s, float rcut2,
                                            float cutoff2) {
  bool ok = r2s > cutoff2 && r2 > 0.0f;
  if (USE_RCUT) ok = ok && r2 <= rcut2;
  return ok ? rsqrt_t<FTZ>(r2s) : 0.0f;
}

// The bf16 form's newton pair term for the two sources of s (low and high
// halves) and one target (xi, yi, zi: its bits in both halves): the
// packed ops round as pair_cells_plain rounds each op; r^2's three
// squares add in fp32 as (x + y) + z; r^2 and the two rsqrts are rounded
// by one conversion each. The products w d are exact in fp32 and summed
// there, the low source first. eps2 holds bf16 eps^2 in both halves.
template <bool USE_RCUT, bool FTZ>
__device__ __forceinline__ void pair_bf16(const Pair2& s, uint32_t xi,
                                          uint32_t yi, uint32_t zi,
                                          float rcut2, uint32_t eps2,
                                          float cutoff2, float& tx,
                                          float& ty, float& tz) {
  const uint32_t dx = sub2(s.x, xi);
  const uint32_t dy = sub2(s.y, yi);
  const uint32_t dz = sub2(s.z, zi);
  const uint32_t sx = mul2(dx, dx);
  const uint32_t sy = mul2(dy, dy);
  const uint32_t sz = mul2(dz, dz);
  const uint32_t r2 =
      pack2((lo(sx) + lo(sy)) + lo(sz), (hi(sx) + hi(sy)) + hi(sz));
  const uint32_t r2s = add2(r2, eps2);
  const uint32_t inv_r = pack2(
      inv_r_bf16<USE_RCUT, FTZ>(lo(r2), lo(r2s), rcut2, cutoff2),
      inv_r_bf16<USE_RCUT, FTZ>(hi(r2), hi(r2s), rcut2, cutoff2));
  const uint32_t w = mul2(mul2(mul2(s.gm, inv_r), inv_r), inv_r);
  const float w0 = lo(w), w1 = hi(w);
  tx = fmaf(w0, lo(dx), tx);
  ty = fmaf(w0, lo(dy), ty);
  tz = fmaf(w0, lo(dz), tz);
  tx = fmaf(w1, hi(dx), tx);
  ty = fmaf(w1, hi(dy), ty);
  tz = fmaf(w1, hi(dz), tz);
}

// Warp v of the grid serves work item v = cell * ceil(t_cap / kGroup) +
// slot group. Lane l serves target slot l / kQ of its item and the
// sources j = l % kQ (mod kQ) of each staged tile (two a step in the
// bf16 form).
//
// Slot blockIdx.y of a batched launch (the serve engine's batch of B
// independent cell lists): each array starts at the slot's stride, its
// params at slot * (the kind's params). A solo launch has one slot, so
// its offsets are 0; a slot's blocks do exactly a solo launch's work on
// the slot's arrays, in the same compiled code, and give its bits.
template <typename IO, int KIND, bool USE_RCUT, bool FTZ>
__device__ __forceinline__ void pair_cells(
    const IO* __restrict__ tpos, const int64_t* __restrict__ t_count,
    const IO* __restrict__ spos, const IO* __restrict__ sgm,
    const int64_t* __restrict__ s_count, int side, int t_cap, int cap,
    const IO* __restrict__ params, Compute<IO> eps2, Compute<IO> cutoff2,
    IO* __restrict__ out) {
  using T = Compute<IO>;
  constexpr bool kBf16 = std::is_same_v<IO, bf16>;
  static_assert(!kBf16 || KIND == kNewton,
                "the bf16 form has the newton kind only");
  {
    const int64_t b = blockIdx.y;
    const int64_t cells = static_cast<int64_t>(side) * side * side;
    tpos += b * cells * t_cap * 3;
    out += b * cells * t_cap * 3;
    t_count += b * cells;
    s_count += b * cells;
    spos += b * cells * cap * 3;
    sgm += b * cells * cap;
    params += b * (KIND == kEwald ? 2 : 1);
  }
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
    const T rcut2 = USE_RCUT ? load(params) : T(0);
    const T alpha = KIND == kEwald ? load(params + 1) : T(0);
    const T alpha3 = mul_rn(mul_rn(alpha, alpha), alpha);
    T xi = T(0), yi = T(0), zi = T(0);
    // The bf16 form's target, its bits in both halves; eps^2 likewise
    // (eps2 is a bf16 value: its low 16 bits are zero).
    uint32_t xi2 = 0u, yi2 = 0u, zi2 = 0u, eps2x2 = 0u;
    if constexpr (kBf16) {
      eps2x2 = 0x10001u * (__float_as_uint(eps2) >> 16);
    }
    if (active) {
      if constexpr (kBf16) {
        xi2 = 0x10001u * bits(tpos[3 * trow]);
        yi2 = 0x10001u * bits(tpos[3 * trow + 1]);
        zi2 = 0x10001u * bits(tpos[3 * trow + 2]);
      } else {
        xi = load(tpos + 3 * trow);
        yi = load(tpos + 3 * trow + 1);
        zi = load(tpos + 3 * trow + 2);
      }
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
      if constexpr (kBf16) {
        // 2 kStage sources a tile, in the warp's slice as kStage pairs:
        // pair p holds sources 4 (p / 2) + p % 2 and that + 2, so lane q
        // takes sources q, q + 2, q + 4, ... in order, two a step, as the
        // fp32 form takes them one a step. Past the tile's end the high
        // source is the low one with G m = 0, an exact no-op.
        static_assert(kQ == 2, "the bf16 pairs interleave two lanes");
        Pair2* pairs = reinterpret_cast<Pair2*>(buf);
        for (int base = 0; base < ns; base += 2 * kStage) {
          const int jn = min(2 * kStage, ns - base);
          for (int p = lane; p < kStage; p += 32) {
            const int j0 = 4 * (p >> 1) + (p & 1);
            if (j0 >= jn) continue;
            const int64_t j = sbase + base + j0;
            Pair2 b{bits(spos[3 * j]), bits(spos[3 * j + 1]),
                    bits(spos[3 * j + 2]), bits(sgm[j])};
            if (j0 + 2 < jn) {
              b.x |= bits(spos[3 * j + 6]) << 16;
              b.y |= bits(spos[3 * j + 7]) << 16;
              b.z |= bits(spos[3 * j + 8]) << 16;
              b.gm |= bits(sgm[j + 2]) << 16;
            } else {
              b.x *= 0x10001u;
              b.y *= 0x10001u;
              b.z *= 0x10001u;
            }
            pairs[p] = b;
          }
          __syncwarp();
#pragma unroll 2
          for (int p = q; 2 * p - q < jn; p += kQ) {
            pair_bf16<USE_RCUT, FTZ>(pairs[p], xi2, yi2, zi2, rcut2, eps2x2,
                                     cutoff2, tx, ty, tz);
          }
          __syncwarp();
        }
      } else {
        for (int base = 0; base < ns; base += kStage) {
          const int jn = min(kStage, ns - base);
          for (int jj = lane; jj < jn; jj += 32) {
            const int64_t j = sbase + base + jj;
            Body<T> b;
            b.x = load(spos + 3 * j);
            b.y = load(spos + 3 * j + 1);
            b.z = load(spos + 3 * j + 2);
            b.gm = load(sgm + j);
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
      }
      // The kQ source lanes of a target hold this neighbor's partial
      // sums; a butterfly adds them in the same order on every lane.
#pragma unroll
      for (int off = 1; off < kQ; off <<= 1) {
        tx += __shfl_xor_sync(0xffffffffu, tx, off);
        ty += __shfl_xor_sync(0xffffffffu, ty, off);
        tz += __shfl_xor_sync(0xffffffffu, tz, off);
      }
      if constexpr (kBf16) {
        // The row rounded once, then the bf16 accumulator.
        ax = rnd(ax + rnd(tx));
        ay = rnd(ay + rnd(ty));
        az = rnd(az + rnd(tz));
      } else {
        ax += tx;
        ay += ty;
        az += tz;
      }
    }
  }
  if (q == 0 && slot < t_cap) {
    out[3 * trow] = store_as<IO>(active ? ax : T(0));
    out[3 * trow + 1] = store_as<IO>(active ? ay : T(0));
    out[3 * trow + 2] = store_as<IO>(active ? az : T(0));
  }
}

template <typename IO, int KIND, bool USE_RCUT, bool FTZ>
__global__ void __launch_bounds__(kThreads)
    nlist_pair_kernel(const IO* __restrict__ tpos,
                      const int64_t* __restrict__ t_count,
                      const IO* __restrict__ spos, const IO* __restrict__ sgm,
                      const int64_t* __restrict__ s_count, int side,
                      int t_cap, int cap, const IO* __restrict__ params,
                      Compute<IO> eps2, Compute<IO> cutoff2,
                      IO* __restrict__ out) {
  pair_cells<IO, KIND, USE_RCUT, FTZ>(tpos, t_count, spos, sgm, s_count, side,
                                      t_cap, cap, params, eps2, cutoff2, out);
}

// The bf16 form's untruncated newton kind (the octree's near field) held
// to 48 registers, 5 blocks an SM. Most of its warp items are empty
// leaves that only write zeros, so the launch goes as fast as the SMs
// take blocks: at the baseline-1m leaf blocks 0.877 ms at 48 registers
// against 0.978 at the 56 ptxas picks (NVIDIA H100 80GB HBM3, 700.00 W).
// The rcut form stays at its own count: held to 48 it took 1.227 ms
// against 1.151 at the README nlist state (scripts/kernel_ab.py).
template <typename IO, bool FTZ>
__global__ void __launch_bounds__(kThreads, 5)
    nlist_near_kernel(const IO* __restrict__ tpos,
                      const int64_t* __restrict__ t_count,
                      const IO* __restrict__ spos, const IO* __restrict__ sgm,
                      const int64_t* __restrict__ s_count, int side,
                      int t_cap, int cap, const IO* __restrict__ params,
                      Compute<IO> eps2, Compute<IO> cutoff2,
                      IO* __restrict__ out) {
  static_assert(std::is_same_v<IO, bf16>, "the bf16 form's near field");
  pair_cells<IO, kNewton, false, FTZ>(tpos, t_count, spos, sgm, s_count, side,
                                      t_cap, cap, params, eps2, cutoff2, out);
}

template <typename IO>
using KernelFn = void (*)(const IO*, const int64_t*, const IO*, const IO*,
                          const int64_t*, int, int, int, const IO*,
                          Compute<IO>, Compute<IO>, IO*);

// The instantiation a launch takes, or null (the bf16 form has no ewald
// kind). The newton kind's rsqrt input is r^2 + eps^2 > cutoff^2, or 1,
// so normal when cutoff^2 >= FLT_MIN.
template <typename IO>
KernelFn<IO> pick_kernel(int kind, int use_rcut, double cutoff2) {
  if (kind == kEwald) {
    if constexpr (std::is_same_v<IO, bf16>) {
      return nullptr;
    } else {
      // The ewald kind always truncates at rcut.
      return nlist_pair_kernel<IO, kEwald, true, false>;
    }
  }
  if constexpr (std::is_same_v<IO, bf16>) {
    // The untruncated form has its own entry point.
    const bool ftz = cutoff2 >= FLT_MIN;
    if (!use_rcut) {
      return ftz ? nlist_near_kernel<IO, true> : nlist_near_kernel<IO, false>;
    }
    return ftz ? nlist_pair_kernel<IO, kNewton, true, true>
               : nlist_pair_kernel<IO, kNewton, true, false>;
  } else {
    if constexpr (sizeof(Compute<IO>) == 4) {
      if (cutoff2 >= FLT_MIN) {
        return use_rcut ? nlist_pair_kernel<IO, kNewton, true, true>
                        : nlist_pair_kernel<IO, kNewton, false, true>;
      }
    }
    return use_rcut ? nlist_pair_kernel<IO, kNewton, true, false>
                    : nlist_pair_kernel<IO, kNewton, false, false>;
  }
}

// `batch` slots (grid.y; 1 for a solo launch), each slot's arrays
// contiguous after the one before.
template <typename IO>
int launch(const void* tpos, const void* t_count, const void* spos,
           const void* sgm, const void* s_count, int side, int t_cap, int cap,
           const void* params, double eps2, double cutoff2, int use_rcut,
           int kind, void* out, void* stream, int batch = 1) {
  if (kind != kNewton && kind != kEwald) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KernelFn<IO> kernel = pick_kernel<IO>(kind, use_rcut, cutoff2);
  if (kernel == nullptr || batch < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (side <= 0 || t_cap <= 0 || batch == 0) return 0;
  const int64_t n_items = static_cast<int64_t>(side) * side * side *
                          ((t_cap + kGroup - 1) / kGroup);
  const dim3 grid(static_cast<unsigned>((n_items + kWarps - 1) / kWarps),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const IO*>(tpos), static_cast<const int64_t*>(t_count),
      static_cast<const IO*>(spos), static_cast<const IO*>(sgm),
      static_cast<const int64_t*>(s_count), side, t_cap, cap,
      static_cast<const IO*>(params), static_cast<Compute<IO>>(eps2),
      static_cast<Compute<IO>>(cutoff2), static_cast<IO*>(out));
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

// The bf16 form: bf16 arrays throughout (params too), newton kind only
// (kind 1 returns cudaErrorInvalidValue).
extern "C" int nlist_pair_bf16(const void* tpos, const void* t_count,
                               const void* spos, const void* sgm,
                               const void* s_count, int side, int t_cap,
                               int cap, const void* params, double eps2,
                               double cutoff2, int use_rcut, int kind,
                               void* out, void* stream) {
  return launch<bf16>(tpos, t_count, spos, sgm, s_count, side, t_cap, cap,
                      params, eps2, cutoff2, use_rcut, kind, out, stream);
}

// The batched launch (the serve engine's batched force evaluation):
// `batch` slots (at most 65,535) of the arrays above, each slot's arrays
// contiguous after the one before, params holding one rcut_eff^2 a slot.
// The newton kind with the rcut mask only (the one the engine serves;
// anything else returns cudaErrorInvalidValue). One launch for the whole
// batch; slot b's result has the bits of a solo launch on slot b's
// arrays.
#define NLIST_PAIR_BATCHED(NAME, IO)                                         \
  extern "C" int NAME(const void* tpos, const void* t_count,                \
                      const void* spos, const void* sgm,                    \
                      const void* s_count, int side, int t_cap, int cap,    \
                      const void* params, double eps2, double cutoff2,      \
                      int use_rcut, int kind, void* out, void* stream,      \
                      int batch) {                                          \
    if (kind != kNewton || !use_rcut) {                                     \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    }                                                                       \
    return launch<IO>(tpos, t_count, spos, sgm, s_count, side, t_cap, cap,  \
                      params, eps2, cutoff2, use_rcut, kind, out, stream,   \
                      batch);                                               \
  }
NLIST_PAIR_BATCHED(nlist_pair_batched_f32, float)
NLIST_PAIR_BATCHED(nlist_pair_batched_f64, double)
NLIST_PAIR_BATCHED(nlist_pair_batched_bf16, bf16)
#undef NLIST_PAIR_BATCHED

extern "C" const char* nlist_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
