"""The JAX package's own figures for ``validate --gpu``'s accuracy
records on the port's states: what ``chip_smoke.py``'s ``validate_path``
holds a record that misses its JAX bar to (at most 1.5x the figure),
measured on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_validate_figures.py [card|cpu]

Each state is the port's own draw (``validate.default_draw``: the
model's factory on a CPU generator, float32, the same bits the card
gets), handed to the JAX package as numpy. The JAX package's octree,
dense FMM, its potential and the sparse FMM then run on it at the depth
and sizing the JAX package fits, against its chunked direct sum, as its
``_validate_tpu_battery`` computes them; the port's plain versions run
beside it on the same state. One JSON line a record: the JAX figure, the
port's CPU figure and the JAX battery's bar. ``card`` (default) is the
battery's on-chip sizes (a 16,384-body disk and cold collapse; a few
minutes), ``cpu`` its off-chip ones (2,048).
"""

from __future__ import annotations

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gravity_tpu.ops import fmm as jfmm  # noqa: E402
from gravity_tpu.ops import forces as jforces  # noqa: E402
from gravity_tpu.ops import sfmm as jsfmm  # noqa: E402
from gravity_tpu.ops import tree as jtree  # noqa: E402
from gravity_tpu_torch import validate  # noqa: E402
from gravity_tpu_torch.ops import fmm, forces, sfmm, tree  # noqa: E402

BARS = {"gpu_tree_parity": 0.05, "gpu_fmm_parity": 0.01,
        "gpu_fmm_potential": 0.02, "gpu_fmm_parity_cold": 0.01,
        "gpu_sfmm_parity_disk": 0.01}


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na = np.linalg.norm(a - b, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    return float(np.median(na / np.maximum(nb, 1e-30)))


def main(which: str = "card") -> None:
    n = 16_384 if which == "card" else 2048
    draw = validate.default_draw(torch.device("cpu"))
    disk, cold = draw("disk", n, 2), draw("cold_collapse", n, 3)
    dp, dm = disk.positions, disk.masses
    jp, jm = jnp.asarray(dp.numpy()), jnp.asarray(dm.numpy())
    cp, cm = cold.positions, cold.masses
    jcp, jcm = jnp.asarray(cp.numpy()), jnp.asarray(cm.numpy())
    chunk = min(2048, n)
    kw = dict(g=1.0, eps=0.05)
    depth = jtree.recommended_depth_data(jp)
    ref_j = jforces.pairwise_accelerations_chunked(jp, jm, chunk=chunk, **kw)
    ref_p = forces.pairwise_accelerations_chunked(dp, dm, chunk=chunk, **kw)
    cdepth = jtree.recommended_depth_data(jcp)
    cref_j = jforces.pairwise_accelerations_chunked(jcp, jcm, chunk=chunk,
                                                    eps=1.0e9)
    cref_p = forces.pairwise_accelerations_chunked(cp, cm, chunk=chunk,
                                                   eps=1.0e9)
    e_j = float(jforces.potential_energy(jp, jm, **kw))
    e_p = float(forces.potential_energy(dp, dm, **kw))
    s_depth, s_cap, s_k = jsfmm.resolve_sfmm_sizing(jp, 0, 32)
    p_sizing = sfmm.resolve_sfmm_sizing(dp, 0, 32)
    rows = {
        "gpu_tree_parity": (
            rel_err(jtree.tree_accelerations(jp, jm, depth=depth, **kw),
                    ref_j),
            rel_err(tree.tree_accelerations(dp, dm, depth=depth, **kw),
                    ref_p)),
        "gpu_fmm_parity": (
            rel_err(jfmm.fmm_accelerations(jp, jm, depth=depth, **kw),
                    ref_j),
            rel_err(fmm.fmm_accelerations(dp, dm, depth=depth, **kw),
                    ref_p)),
        "gpu_fmm_potential": (
            abs(float(jfmm.fmm_potential_energy(jp, jm, depth=depth, **kw))
                - e_j) / abs(e_j),
            abs(float(fmm.fmm_potential_energy(dp, dm, depth=depth, **kw))
                - e_p) / abs(e_p)),
        "gpu_fmm_parity_cold": (
            rel_err(jfmm.fmm_accelerations(jcp, jcm, depth=cdepth,
                                           eps=1.0e9), cref_j),
            rel_err(fmm.fmm_accelerations(cp, cm, depth=cdepth, eps=1.0e9),
                    cref_p)),
        "gpu_sfmm_parity_disk": (
            rel_err(jsfmm.sfmm_accelerations(jp, jm, depth=s_depth,
                                             leaf_cap=s_cap, k_cells=s_k,
                                             **kw), ref_j),
            rel_err(sfmm.sfmm_accelerations(dp, dm, depth=p_sizing[0],
                                            leaf_cap=p_sizing[1],
                                            k_cells=p_sizing[2], **kw),
                    ref_p)),
    }
    for name, (jax_fig, port_fig) in rows.items():
        print(json.dumps({
            "record": name, "n": n, "depth": depth, "cold_depth": cdepth,
            "sfmm_sizing": [s_depth, s_cap, s_k],
            "port_sfmm_sizing": list(p_sizing), "jax": jax_fig,
            "port_cpu": port_fig, "bar": BARS[name],
            "jax_meets_bar": jax_fig < BARS[name]}), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
