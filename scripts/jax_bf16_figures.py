"""The JAX package's own bf16-against-fp32 errors on the port's card
states: the figures ``chip_smoke.py`` holds its bf16 paths to (at most
1.5x them), measured on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_bf16_figures.py [tree|nlist]

Each case makes its state with the port (its CPU generator, float32 and
then bf16: the same bits the card gets), hands it to the JAX package as
numpy and prints one JSON line: the median, p90 and max of the
per-target relative error of the JAX package's bf16 forces against its
own float32 forces on the same bf16 state, and of the port's bf16 forces
(its plain versions, on the CPU) against the JAX package's bf16 and
float32 ones.

- ``tree``: ``baseline-1m``'s initial disk, at the 4,096 targets
  ``chip_smoke.py`` samples (seed 17), over all 1,048,576 sources, at the
  depth the port fits (7), the gather near field and the direct far
  field; also both against the float32 direct sum there. A few minutes
  and ~3 GB of host memory.
- ``nlist``: the README cell-list state (N = 262,144, rcut 5e10 m, eps
  1e9 m) at the side and cap both packages fit to it, every target. A
  few minutes and ~2 GB.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gravity_tpu.ops import pallas_nlist as jax_nlist  # noqa: E402
from gravity_tpu.ops import tree as jax_tree  # noqa: E402
from gravity_tpu_torch.config import PRESETS, SimulationConfig  # noqa: E402
from gravity_tpu_torch.interop import to_numpy  # noqa: E402
from gravity_tpu_torch.ops import nlist, tree  # noqa: E402
from gravity_tpu_torch.ops.forces import accelerations_vs  # noqa: E402
from gravity_tpu_torch.simulation import make_initial_state  # noqa: E402

SAMPLE = 4096
SEED = 17
# README.md's cell-list command.
NLIST_RUN = dict(model="random", n=262_144, nlist_rcut=5e10, eps=1e9)


def _stats(acc, ref) -> dict:
    rel = (np.linalg.norm(acc - ref, axis=1) / np.linalg.norm(ref, axis=1))
    return {"median": float(np.median(rel)),
            "p90": float(np.percentile(rel, 90)),
            "max": float(rel.max())}


def _bf16_state(config):
    """The config's initial positions and masses rounded to bf16, as
    float32 numpy arrays (exact)."""
    state = make_initial_state(config, "cpu")
    return (to_numpy(state.positions.to(torch.bfloat16)),
            to_numpy(state.masses.to(torch.bfloat16)))


def _jax(fn, pos, masses, dtype, **kw):
    out = fn(jnp.asarray(pos, dtype), jnp.asarray(masses, dtype), **kw)
    return np.asarray(out.astype(jnp.float32), np.float64)


def tree_case() -> dict:
    config = dataclasses.replace(PRESETS["baseline-1m"])
    pos, masses = _bf16_state(config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        depth = tree.recommended_depth_data(pos, config.tree_leaf_cap)
    gen = torch.Generator().manual_seed(SEED)
    idx = torch.randperm(config.n, generator=gen)[:SAMPLE].numpy()
    kw = dict(depth=depth, leaf_cap=config.tree_leaf_cap, g=config.g,
              eps=config.eps, far=config.tree_far, near_mode="gather")
    acc = {}
    for name, dtype in (("bfloat16", jnp.bfloat16),
                        ("float32", jnp.float32)):
        acc[name] = _jax(
            lambda p, m, **k: jax_tree.tree_accelerations_vs(p[idx], p, m,
                                                             **k),
            pos, masses, dtype, **kw)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(masses)
    port = tree.tree_accelerations_vs(
        tp[idx].to(torch.bfloat16), tp.to(torch.bfloat16),
        tm.to(torch.bfloat16), **kw).double().numpy()
    direct = torch.cat([
        accelerations_vs(t, tp, tm, g=config.g, eps=config.eps)
        for t in torch.split(tp[idx], 16)]).double().numpy()
    return {
        "case": "tree",
        "state": "baseline-1m initial disk (port generator, seed 0), "
                 "rounded to bf16",
        "n": config.n, "depth": depth, "targets": SAMPLE,
        "target_seed": SEED, "near_mode": "gather", "far": config.tree_far,
        "bf16_vs_fp32_tree": _stats(acc["bfloat16"], acc["float32"]),
        "bf16_vs_fp32_direct": _stats(acc["bfloat16"], direct),
        "fp32_tree_vs_fp32_direct": _stats(acc["float32"], direct),
        "port_bf16_vs_jax_bf16": _stats(port, acc["bfloat16"]),
        "port_bf16_vs_fp32_tree": _stats(port, acc["float32"]),
    }


def nlist_case() -> dict:
    config = SimulationConfig(**NLIST_RUN)
    pos, masses = _bf16_state(config)
    side, cap = jax_nlist.resolve_nlist_sizing(jnp.asarray(pos,
                                                           jnp.bfloat16),
                                               config.nlist_rcut)
    kw = dict(rcut=config.nlist_rcut, side=side, cap=cap, g=config.g,
              cutoff=config.cutoff, eps=config.eps)
    acc = {name: _jax(jax_nlist.nlist_accelerations, pos, masses, dtype,
                      impl="jnp", **kw)
           for name, dtype in (("bfloat16", jnp.bfloat16),
                               ("float32", jnp.float32))}
    port = nlist.nlist_accelerations(
        torch.from_numpy(pos).to(torch.bfloat16),
        torch.from_numpy(masses).to(torch.bfloat16), **kw).double().numpy()
    return {
        "case": "nlist",
        "state": "README cell-list initial state (port generator, seed "
                 "0), rounded to bf16",
        "n": config.n, "side": side, "cap": cap, "targets": config.n,
        "engine": "jnp",
        "bf16_vs_fp32": _stats(acc["bfloat16"], acc["float32"]),
        "port_bf16_vs_jax_bf16": _stats(port, acc["bfloat16"]),
        "port_bf16_vs_jax_fp32": _stats(port, acc["float32"]),
    }


def main() -> None:
    cases = sys.argv[1:] or ["tree", "nlist"]
    for name in cases:
        t0 = time.perf_counter()
        record = {"tree": tree_case, "nlist": nlist_case}[name]()
        record.update(jax=jax.__version__, platform=jax.default_backend(),
                      seconds=time.perf_counter() - t0)
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
