"""The bf16 sparse FMM's error against its fp32 form, in the port and in
the JAX package, on the CPU, at a size where it has grown.

Both forms take the same bf16 state, so they differ in their arithmetic
alone. The witness is the ``baseline-1m-fmm`` disk cut to 4,096 bodies at
the sparse sizing a run resolves there
(``chip_smoke.py::fmm_bf16_growth_inputs``). Bar: the port's median
relative error of bf16 against fp32 lies within 1.5x of the JAX
package's, either way, and the JAX figure equals ``chip_smoke.py``'s
``FMM_BF16_GROWTH_JAX_CPU``, which holds the card to the same band.

Run as a script, it prints these figures at the sizes given, and beside
them the port's bf16 run with its segment sums taken in fp32 and rounded
once (a few minutes at 65,536 bodies):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fmm_bf16_growth.py 4096 16384
"""

from __future__ import annotations

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import sfmm as jax_sfmm
from gravity_tpu_torch.ops import cells, sfmm

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATIO = 1.5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_rows(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return (np.linalg.norm(got - want, axis=1)
            / np.linalg.norm(want, axis=1))


def _fp32_sums(fn):
    """``fn`` with bf16 values summed in fp32 and rounded once."""
    def summed(values, ids, n):
        if values.dtype != torch.bfloat16:
            return fn(values, ids, n)
        return fn(values.float(), ids, n).to(torch.bfloat16)
    return summed


def _figures(n: int, sums_in_fp32: bool = True) -> dict:
    """{who: per-row relative error of bf16 against fp32}, for "jax",
    "port" and (``sums_in_fp32``) "port, fp32 sums"."""
    pos, m, kw = _chip_smoke().fmm_bf16_growth_inputs(n)
    # Both forms see the same bf16 state, as on the card: they differ in
    # their arithmetic alone.
    pos, m = (torch.tensor(a).to(torch.bfloat16).double().numpy()
              for a in (pos, m))
    out = {}
    for dt, jdt, tdt in (("bf16", jnp.bfloat16, torch.bfloat16),
                         ("fp32", jnp.float32, torch.float32)):
        out["jax", dt] = np.asarray(jax_sfmm.sfmm_accelerations(
            jnp.asarray(pos, jdt), jnp.asarray(m, jdt), **kw).astype(
                jnp.float32))
        out["port", dt] = sfmm.sfmm_accelerations(
            torch.tensor(pos, dtype=tdt), torch.tensor(m, dtype=tdt),
            **kw).float().numpy()
    rel = {who: _rel_rows(out[who, "bf16"], out[who, "fp32"])
           for who in ("jax", "port")}
    if sums_in_fp32:
        saved = sfmm.sorted_segment_sum, sfmm.segment_sum
        sfmm.sorted_segment_sum = _fp32_sums(cells.sorted_segment_sum)
        sfmm.segment_sum = _fp32_sums(cells.segment_sum)
        try:
            wide = sfmm.sfmm_accelerations(
                torch.tensor(pos, dtype=torch.bfloat16),
                torch.tensor(m, dtype=torch.bfloat16), **kw).float().numpy()
        finally:
            sfmm.sorted_segment_sum, sfmm.segment_sum = saved
        rel["port, fp32 sums"] = _rel_rows(wide, out["port", "fp32"])
    return rel


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_bf16_sparse_fmm_error_is_the_jax_packages_at_4096():
    smoke = _chip_smoke()
    rel = _figures(smoke.FMM_BF16_GROWTH_N, sums_in_fp32=False)
    med = {who: float(np.median(r)) for who, r in rel.items()}
    assert med["jax"] / RATIO <= med["port"] <= RATIO * med["jax"], med
    assert smoke.FMM_BF16_GROWTH_JAX_CPU == pytest.approx(med["jax"],
                                                          rel=1e-6)


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for size in (int(a) for a in sys.argv[1:] or ["4096"]):
        for who, r in _figures(size).items():
            print(f"n={size} {who}: bf16 vs fp32 median {np.median(r)!r} "
                  f"p99 {np.quantile(r, 0.99)!r} max {r.max()!r}",
                  flush=True)
