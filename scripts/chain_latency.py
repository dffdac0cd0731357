"""Latency of one step of a dependent chain of bf16 adds on the card: the
floor of ``csrc/segment_sum.cu`` under its bit contract.

    python3 scripts/chain_latency.py

The segment sums round to bf16 after every add, in element order (the
JAX package's bits), so a segment of m rows is a chain of m dependent
add-and-round steps, whatever the bytes. One thread runs such a chain
over values held in registers and reads ``clock64`` around it, in three
forms:

- ``bf16_add``: one ``add.rn.bf16`` a step, which rounds the exact sum
  once: the same bits as an fp32 add rounded to bf16 (fp32's 24 bits are
  at least 2 x 8 + 2; ``tests/test_torch_bf16_rounding.py``). The least
  a step can take under the contract.
- ``fp32_add_cvt``: an fp32 add, ``cvt.rn.bf16.f32`` and the widening
  back, as ``segment_sum.cu`` steps today;
- ``kernel_step``: that step with the ``__shfl_sync`` that hands each
  row to the warp, as in ``segment_sum.cu``'s loop.

Prints one JSON line: cycles a step for each form, the SM clock
``nvidia-smi`` reports at its top, the card's name and power limit, and
the bound the chain sets for the level-0 sums of ``baseline-1m`` (all
1,048,576 rows in one segment): rows x cycles / clock. The library is
built by nvcc into ``gravity_tpu_torch/build/``. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = 1 << 16
LEVEL0_ROWS = 1 << 20

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// form 0: add.rn.bf16; 1: fp32 add, round, widen; 2: 1 with a shuffle.
__global__ void chain(const uint16_t* in, uint16_t* out, long long* cycles,
                      int steps, int form) {
  uint16_t v[8];
  for (int k = 0; k < 8; ++k) v[k] = in[k];
  float vf[8];
  for (int k = 0; k < 8; ++k) vf[k] = __uint_as_float(uint32_t(v[k]) << 16);
  uint16_t acc = 0;
  float accf = 0.0f;
  __syncwarp();
  const long long t0 = clock64();
  if (form == 0) {
#pragma unroll 8
    for (int i = 0; i < steps; ++i) {
      asm volatile("add.rn.bf16 %0, %0, %1;" : "+h"(acc) : "h"(v[i & 7]));
    }
  } else if (form == 1) {
#pragma unroll 8
    for (int i = 0; i < steps; ++i) accf = rnd(accf + vf[i & 7]);
  } else {
    for (int i = 0; i < steps; ++i) {
      accf = rnd(accf + __shfl_sync(0xffffffffu, vf[i & 7], i & 31));
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = form == 0 ? acc : uint16_t(__float_as_uint(accf) >> 16);
    cycles[0] = t1 - t0;
  }
}

extern "C" int chain_cycles(int form, int steps, long long* result) {
  uint16_t host_in[8] = {0x3f80, 0x3c00, 0x3e80, 0x3b80,
                         0x3d00, 0x3c80, 0x3f00, 0x3a00};
  uint16_t *in = nullptr, *out = nullptr;
  long long* cycles = nullptr;
  cudaMalloc(&in, sizeof(host_in));
  cudaMalloc(&out, 2);
  cudaMalloc(&cycles, sizeof(long long));
  cudaMemcpy(in, host_in, sizeof(host_in), cudaMemcpyHostToDevice);
  const int threads = form == 2 ? 32 : 1;
  chain<<<1, threads>>>(in, out, cycles, steps, form);  // warm-up
  chain<<<1, threads>>>(in, out, cycles, steps, form);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(result, cycles, sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(in);
  cudaFree(out);
  cudaFree(cycles);
  return err == cudaSuccess ? static_cast<int>(cudaGetLastError())
                            : static_cast<int>(err);
}
"""

FORMS = ("bf16_add", "fp32_add_cvt", "kernel_step")


def build() -> str:
    from gravity_tpu_torch.ops import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "chain_latency.cu")
    lib = os.path.join(cuda_build.BUILD_DIR, "libchain_latency.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                    src], check=True, capture_output=True, text=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chain_latency: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    lib = ctypes.CDLL(build())
    lib.chain_cycles.argtypes = [ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_longlong)]
    lib.chain_cycles.restype = ctypes.c_int
    clock_mhz = float(cs.nvidia_smi("clocks.max.sm",
                                    "--format=csv,noheader,nounits"))
    record = {"steps": STEPS, "max_sm_clock_mhz": clock_mhz,
              "nvidia_smi": cs.nvidia_smi("name,power.limit")}
    for form, name in enumerate(FORMS):
        cycles = ctypes.c_longlong(0)
        status = lib.chain_cycles(form, STEPS, ctypes.byref(cycles))
        if status != 0:
            raise RuntimeError(f"chain_latency {name}: CUDA error {status}")
        per_step = cycles.value / STEPS
        record[name] = {
            "cycles_per_step": per_step,
            "level0_bound_ms": 1e3 * LEVEL0_ROWS * per_step
                               / (clock_mhz * 1e6)}
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
