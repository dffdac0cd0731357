"""The body counts of chip_smoke.py's sharded_grad_path, on the card.

    python3 scripts/sharded_grad_sizes.py [fmm_dense fmm_sparse halo_periodic]

For each named part (all three by default) runs
``chip_smoke.sharded_grad_part`` (the VJP of sum((a / A)^2) through the
sharded engine on the NCCL world of one and through the unsharded
Simulator, on the same state) at the part's full size and then at each
smaller power of two until one fits the card. Prints one JSON line a
try: the part's record where it fits (ms, peak bytes, gaps), or the
out-of-memory message and ``torch.cuda.max_memory_allocated`` at the size
that did not; then the refusals' line. The largest count that fits is
what ``chip_smoke.SHARDED_GRAD_N`` holds. Needs one card.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SIZES = {"fmm_dense": [1 << 20, 1 << 19, 1 << 18, 1 << 17],
         "fmm_sparse": [1 << 20, 1 << 19, 1 << 18, 1 << 17],
         "halo_periodic": [262_144, 131_072, 65_536, 32_768]}


def main(names) -> int:
    from gravity_tpu_torch.parallel import make_particle_mesh

    cs.phase_device()
    for name in names:
        for n in SIZES[name]:
            config = cs.sharded_grad_configs({name: n})[name]
            t = time.perf_counter()
            try:
                part = cs.sharded_grad_part(name, config)
            except torch.cuda.OutOfMemoryError as e:
                print(json.dumps({
                    "name": name, "n": n, "oom": str(e)[:400],
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "wall_s": time.perf_counter() - t}), flush=True)
                del e
                gc.collect()
                torch.cuda.empty_cache()
                continue
            print(json.dumps({"name": name, **part,
                              "wall_s": time.perf_counter() - t}),
                  flush=True)
            break
    print(json.dumps(cs.sharded_grad_refusals(make_particle_mesh())),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(SIZES)))
