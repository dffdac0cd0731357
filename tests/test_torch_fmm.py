"""The port's dense-grid FMM (ops/fmm.py) against the JAX package's, on the
CPU.

Inputs are drawn with numpy from a seed and given to both packages: a
uniform cloud and a cold sphere at astronomical scales (SI units, where
the Taylor factors the flush-safe moments avoid are fp32 subnormals) and
a thin disk in galactic units, at 512-1,024 bodies and depth 3-4, with
leaf caps small enough that dense leaves overflow (the source remainder
and the slot-overflow fallback run). The port sums each cell's terms in
another order than the JAX package's scans (a gather of all list offsets
at once), so the bars are summation-order ones:

- fp64: every row within 1e-9 of its |a| (measured ~1e-14); the
  potential within 1e-10 relative (measured ~2e-16);
- fp32: median relative < 1e-5 and max < 1e-3 (the JAX suite's bars for
  two orderings of one decomposition, ``tests/test_fmm.py:69-87``;
  measured ~1e-7 and ~1e-5); the potential within 1e-5 relative.

JAX outputs are computed once a module (``_jax``), so each compiles once.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import fmm as jax_fmm
from gravity_tpu_torch.constants import G
from gravity_tpu_torch.ops import fmm

F64_ROW_TOL = 1e-9
F64_PE_TOL = 1e-10
F32_MEDIAN_TOL = 1e-5
F32_MAX_TOL = 1e-3
F32_PE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _uniform(n, seed, dtype):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1e12, (n, 3))
    m = rng.uniform(1e25, 1e26, n)
    return pos.astype(dtype), m.astype(dtype)


def _cold(n, seed, dtype):
    """A uniform sphere of radius 1e12 m at rest: the cold collapse."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = 1e12 * rng.uniform(0.0, 1.0, n)[:, None] ** (1.0 / 3.0) * v
    m = np.full(n, 2e30 / n)
    return pos.astype(dtype), m.astype(dtype)


def _disk(n, seed, dtype):
    """A thin exponential disk of mass 5 around a unit point mass."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    m = np.full(n, 5.0 / (n - 1))
    pos[0], m[0] = 0.0, 1.0
    return pos.astype(dtype), m.astype(dtype)


# (state, solver keywords): each overflows some leaf at its cap.
CASES = {
    "uniform": (functools.partial(_uniform, 1024, 1),
                dict(depth=3, leaf_cap=4, g=G, eps=1e9)),
    "cold": (functools.partial(_cold, 512, 2),
             dict(depth=4, leaf_cap=2, g=G, eps=2e11)),
    "disk": (functools.partial(_disk, 1024, 3),
             dict(depth=4, leaf_cap=16, g=1.0, eps=0.05)),
}
DTYPES = {"float32": np.float32, "float64": np.float64}


def _vs_targets(pos):
    """300 of the sources (at t_cap 4 the dense leaves' targets overflow)
    and 3 probes outside the source cube."""
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    span = (hi - lo).max()
    center = 0.5 * (hi + lo)
    probes = np.stack([center + np.array([10.0, 0.0, 0.0]) * span,
                       center + np.array([0.0, -3.0, 0.0]) * span,
                       hi + 0.02 * span])
    return np.concatenate([pos[::7][:300], probes]).astype(pos.dtype)


@functools.lru_cache(maxsize=None)
def _jax(kind: str, case: str, dtype: str):
    """The JAX package's result for one case (computed once a module)."""
    state, kw = CASES[case]
    pos, m = state(DTYPES[dtype])
    jp, jm = jnp.asarray(pos), jnp.asarray(m)
    assert jp.dtype == DTYPES[dtype]
    if kind == "self":
        return np.asarray(jax_fmm.fmm_accelerations(jp, jm, **kw))
    if kind == "vs":
        return np.asarray(jax_fmm.fmm_accelerations_vs(
            jnp.asarray(_vs_targets(pos)), jp, jm, t_cap=4, **kw))
    return float(jax_fmm.fmm_potential_energy(jp, jm, **kw))


def _port(kind: str, case: str, dtype: str):
    state, kw = CASES[case]
    pos, m = state(DTYPES[dtype])
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    if kind == "self":
        out = fmm.fmm_accelerations(tp, tm, **kw)
    elif kind == "vs":
        out = fmm.fmm_accelerations_vs(
            torch.from_numpy(_vs_targets(pos)), tp, tm, t_cap=4, **kw)
    else:
        return fmm.fmm_potential_energy(tp, tm, **kw)
    assert out.dtype == tp.dtype and bool(torch.isfinite(out).all())
    return out.numpy()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want, axis=1)
            / np.linalg.norm(want, axis=1))


def _assert_close(got, want, dtype: str):
    rel = _rel(got, want)
    if dtype == "float64":
        assert rel.max() < F64_ROW_TOL, rel.max()
    else:
        assert np.median(rel) < F32_MEDIAN_TOL, np.median(rel)
        assert rel.max() < F32_MAX_TOL, rel.max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fmm_accelerations_match_jax(case, dtype, x64):
    _assert_close(_port("self", case, dtype), _jax("self", case, dtype),
                  dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fmm_accelerations_vs_match_jax(dtype, x64):
    """A subset of the disk's bodies as targets, binned at t_cap 4 (the
    dense leaves' targets overflow into the monopole hierarchy), and three
    probes outside the cube (the hierarchy at real distances)."""
    _assert_close(_port("vs", "disk", dtype), _jax("vs", "disk", dtype),
                  dtype)


@pytest.mark.parametrize("dtype,tol", [("float64", F64_PE_TOL),
                                       ("float32", F32_PE_TOL)])
def test_fmm_potential_energy_matches_jax(dtype, tol, x64):
    got, want = _port("pe", "disk", dtype), _jax("pe", "disk", dtype)
    assert isinstance(got, np.float64)
    assert abs(got - want) <= tol * abs(want)


def test_the_cases_overflow():
    """Every case has leaves past its cap (the remainder monopole and the
    slot-overflow fallback run), and the probes lie outside the cube."""
    for case, (state, kw) in CASES.items():
        pos, _ = state(np.float64)
        side = 1 << kw["depth"]
        lo, hi = pos.min(axis=0), pos.max(axis=0)
        span = (hi - lo).max() * 1.0001 + 1e-30
        origin = 0.5 * (hi + lo) - 0.5 * span
        c = np.clip(((pos - origin) / span * side).astype(np.int64), 0,
                    side - 1)
        counts = np.bincount((c[:, 0] * side + c[:, 1]) * side + c[:, 2])
        assert counts.max() > kw["leaf_cap"], case
    pos, _ = CASES["disk"][0](np.float64)
    probes = _vs_targets(pos)[-3:]
    outside = (probes < pos.min(axis=0)) | (probes > pos.max(axis=0))
    assert outside.any(axis=1).all()


def test_chunked_passes_match_one_pass(monkeypatch):
    """A small pass budget splits the leaves into many chunks, the list
    into many groups and the fallback into many point chunks: the same
    forces to summation-order roundoff (fp64)."""
    state, kw = CASES["disk"]
    pos, m = state(np.float64)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    one = fmm.fmm_accelerations(tp, tm, **kw).numpy()
    monkeypatch.setattr(fmm, "PASS_BUDGET", 1 << 14)
    assert fmm._cell_chunk(16, 16) < 64 and fmm._fallback_chunk(16) < 16
    many = fmm.fmm_accelerations(tp, tm, **kw).numpy()
    assert _rel(many, one).max() < 1e-13


def test_cell_chunk_is_the_slab_budget():
    """The pass chunk bounds the (cells, t_cap, cap, 3) temporary by the
    JAX package's slab budget, 2^28 elements: powers of two, at least 1."""
    assert fmm._cell_chunk(32, 32) == 65536
    assert fmm._cell_chunk(16, 64) == 65536
    assert fmm._cell_chunk(4096, 4096) == 4
    assert fmm._cell_chunk(1 << 20, 1 << 20) == 1
