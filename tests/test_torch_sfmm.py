"""The port's sparse cell-list FMM (ops/sfmm.py) against the JAX
package's, on the CPU: the forces in both far modes with slot overflow
and with rank overflow (more occupied leaves than ``k_cells``), and the
host sizing helpers, which must return the JAX package's integers.

Inputs are drawn with numpy from a seed and given to both packages. Bars
(the port sums each cell's terms in another order, as ops/fmm.py):

- fp64: every row within 1e-9 of its |a|;
- fp32: median relative < 1e-5 and max < 1e-3 (``tests/test_fmm.py:
  69-87``, the JAX suite's bars for two orderings of one decomposition);
- sparse against the port's own dense FMM on an overflow-free state at a
  forced depth, fp32: the JAX suite's sfmm-vs-fmm bars, median < 1e-5 and
  max < 1e-3 (``tests/test_sfmm.py:69-87``).

JAX outputs are computed once a module (``_jax``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import sfmm as jax_sfmm
from gravity_tpu_torch.ops import fmm, sfmm

F64_ROW_TOL = 1e-9
F32_MEDIAN_TOL = 1e-5
F32_MAX_TOL = 1e-3
DTYPES = {"float32": np.float32, "float64": np.float64}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _disk(n, seed, dtype=np.float64):
    """A thin exponential disk of mass 5 around a unit point mass."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    m = np.full(n, 5.0 / (n - 1))
    pos[0], m[0] = 0.0, 1.0
    return pos.astype(dtype), m.astype(dtype)


def _plummer(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((r[:, None] * v).astype(dtype),
            (rng.uniform(0.5, 1.5, n) / n).astype(dtype))


# Depth 5, cap 8: the disk's dense leaves overflow their slots. k_cells
# 1024 in chunks of 256 holds every occupied leaf; 64 leaves the rest as
# rank overflow.
KW = dict(depth=5, leaf_cap=8, g=1.0, eps=0.05)
CASES = {"slots": dict(k_cells=1024, k_chunk=256),
         "ranks": dict(k_cells=64, k_chunk=64)}


def _state(dtype: str):
    return _disk(1024, 4, DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _jax(case: str, far_mode: str, dtype: str):
    pos, m = _state(dtype)
    return np.asarray(jax_sfmm.sfmm_accelerations(
        jnp.asarray(pos), jnp.asarray(m), far_mode=far_mode, **KW,
        **CASES[case]))


def _port(case: str, far_mode: str, dtype: str):
    pos, m = _state(dtype)
    tp = torch.from_numpy(pos)
    out = sfmm.sfmm_accelerations(tp, torch.from_numpy(m),
                                  far_mode=far_mode, **KW, **CASES[case])
    assert out.dtype == tp.dtype and bool(torch.isfinite(out).all())
    return out.numpy()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want, axis=1)
            / np.linalg.norm(want, axis=1))


@pytest.mark.parametrize("case,far_mode,dtype", [
    ("slots", "gather", "float64"), ("slots", "window", "float64"),
    ("slots", "gather", "float32"), ("ranks", "gather", "float64"),
    ("ranks", "window", "float32"),
])
def test_sfmm_accelerations_match_jax(case, far_mode, dtype, x64):
    rel = _rel(_port(case, far_mode, dtype), _jax(case, far_mode, dtype))
    if dtype == "float64":
        assert rel.max() < F64_ROW_TOL, rel.max()
    else:
        assert np.median(rel) < F32_MEDIAN_TOL, np.median(rel)
        assert rel.max() < F32_MAX_TOL, rel.max()


def test_the_cases_overflow():
    """Both cases take the fallback: slot overflow (a leaf past cap 8) and
    rank overflow (more occupied leaves than k_cells = 64)."""
    pos, _ = _state("float64")
    _, counts = np.unique(sfmm._host_cell_ids(pos, KW["depth"]),
                          return_counts=True)
    assert counts.max() > KW["leaf_cap"]
    assert CASES["ranks"]["k_cells"] < len(counts) \
        <= CASES["slots"]["k_cells"]


def test_far_modes_read_the_same_values():
    pos, m = _state("float64")
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    a, b = (sfmm.sfmm_accelerations(tp, tm, far_mode=mode, **KW,
                                    **CASES["slots"]).numpy()
            for mode in ("gather", "window"))
    np.testing.assert_array_equal(a, b)
    assert sfmm.resolve_far_mode("auto") == "gather"
    with pytest.raises(ValueError, match="far_mode"):
        sfmm.resolve_far_mode("scan")


def test_sparse_matches_dense_without_overflow():
    """On an overflow-free state at a forced depth the sparse and dense
    layouts compute the same interaction sets: agreement to summation
    order (the JAX suite's sfmm-vs-fmm bars)."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, 1e12, (2048, 3)).astype(np.float32)
    m = rng.uniform(1e25, 1e26, 2048).astype(np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    _, counts = np.unique(sfmm._host_cell_ids(pos, 4), return_counts=True)
    assert counts.max() <= 8  # no leaf overflows its slots
    dense = fmm.fmm_accelerations(tp, tm, depth=4, leaf_cap=8,
                                  eps=1e9).numpy()
    sparse = sfmm.sfmm_accelerations(tp, tm, depth=4, leaf_cap=8,
                                     k_cells=4096, k_chunk=4096,
                                     eps=1e9).numpy()
    rel = _rel(sparse, dense)
    assert np.median(rel) < 1e-5 and rel.max() < 1e-3, (np.median(rel),
                                                        rel.max())


# --- the host sizing --------------------------------------------------------


def _sizing_states():
    return {
        "disk-f32": _disk(8192, 6, np.float32)[0],
        "disk-f64": _disk(4096, 7)[0],
        "plummer-f32": _plummer(8192, 8, np.float32)[0],
        "uniform-f64": np.random.default_rng(9).random((4096, 3)),
    }


@pytest.mark.parametrize("kw", [
    {}, {"cap_max": 32}, {"cap_max": 48}, {"min_depth": 3, "max_depth": 3},
    {"max_depth": 6, "table_budget_bytes": 1 << 12},
])
def test_recommended_sparse_params_match_jax(kw):
    for name, pos in _sizing_states().items():
        want = jax_sfmm.recommended_sparse_params(pos, **kw)
        assert sfmm.recommended_sparse_params(pos, **kw) == want, name
        assert sfmm.recommended_sparse_params(
            torch.from_numpy(pos), **kw) == want, name


def test_auto_decision_and_sizing_match_jax():
    for name, pos in _sizing_states().items():
        for cap in (4, 32, 64):
            assert sfmm.sfmm_auto_decision(pos, cap) \
                == jax_sfmm.sfmm_auto_decision(pos, cap), (name, cap)
        for depth, cap in ((0, 32), (5, 16), (3, 8)):
            assert sfmm.resolve_sfmm_sizing(pos, depth, cap) \
                == jax_sfmm.resolve_sfmm_sizing(pos, depth, cap), name
    # a clustered state goes sparse, the uniform cube dense
    states = _sizing_states()
    assert sfmm.sfmm_auto_decision(states["disk-f32"], 32)[0]
    assert not sfmm.sfmm_auto_decision(states["uniform-f64"], 32)[0]


def test_effective_k_and_final_occupancy_match_jax():
    for k, chunk in ((1, 8192), (8192, 8192), (8193, 8192), (368092, 8192),
                     (100, 64)):
        assert sfmm.effective_k_cells(k, chunk) \
            == jax_sfmm.effective_k_cells(k, chunk)
    assert sfmm.DEFAULT_K_CHUNK == jax_sfmm.DEFAULT_K_CHUNK
    pos = _sizing_states()["disk-f32"]
    for sizing in ((5, 8, 1024, 256), (7, 16, 2048), (7, 16, 8192, 8192)):
        want = jax_sfmm.final_occupancy_check(pos, sizing)
        assert sfmm.final_occupancy_check(pos, sizing) == want
        assert sfmm.final_occupancy_check(torch.from_numpy(pos),
                                          sizing) == want
    assert sfmm.final_occupancy_check(pos, (7, 16, 2048))["overflow"]
