"""The port's octree (ops/tree.py) and its cell-list near field
(ops/nlist.py::nlist_near_field) against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and given to both packages: the
port's plain versions (what CPU tensors run; the near field's tiles go
through ``pair_cells_plain``) against ``gravity_tpu.ops.tree`` and, for
the near field alone, ``gravity_tpu.ops.pallas_nlist.nlist_near_field``
through its jnp engine and its Pallas kernel in interpret mode. A small
``leaf_cap`` overflows the dense leaves, so the source remainder and the
target fallback run. Tolerances, each 10x or more above the port-vs-JAX
spread measured on these inputs (the same arithmetic in the same order,
up to the summation order of segment sums and contractions):

- accelerations, max |delta a| over the mean |a|: fp32 1e-5 (measured up
  to 5.3e-7), fp64 1e-10 (measured up to 2.3e-15);
- octree build, per level and array, max |delta| over the largest
  |value|: fp32 1e-6, fp64 1e-12;
- potential energy, relative: fp64 1e-10, fp32 1e-5.

The Simulator, multirate, energy, config and CLI paths of the tree are in
tests/test_torch_tree_run.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu.ops import tree as jax_tree
from gravity_tpu_torch.ops import cells, nlist, tree

TOL = {np.float32: 1e-5, np.float64: 1e-10}
G1 = dict(g=1.0, eps=0.01)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _plummer(n, seed=0, dtype=np.float32, scale=1.0, mass=1.0):
    """A Plummer sphere (a = ``scale``, total mass ~``mass``): a dense core
    whose leaves overflow a small leaf_cap."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.01, 0.99, n)
    r = 1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = scale * r[:, None] * v
    m = mass * rng.uniform(0.5, 1.5, n) / n
    return pos.astype(dtype), m.astype(dtype)


def _disk(n, seed=0, dtype=np.float32):
    """A thin exponential disk (scale length 3, height 0.3) of mass 5
    around a unit point mass at the origin, with circular velocities."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    v = np.sqrt(6.0 / np.maximum(r, 0.1))
    vel = np.stack([-v * np.sin(phi), v * np.cos(phi),
                    0.01 * rng.normal(size=n)], axis=1)
    masses = np.full(n, 5.0 / (n - 1))
    pos[0], vel[0], masses[0] = 0.0, 0.0, 1.0
    return pos.astype(dtype), vel.astype(dtype), masses.astype(dtype)


def _max_over_mean(got, want):
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want, axis=1).mean()
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


def _both(pos, m, targets=None, **kw):
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    if targets is None:
        got = tree.tree_accelerations(tp, tm, **kw)
        want = jax_tree.tree_accelerations(jnp.asarray(pos), jnp.asarray(m),
                                           **kw)
    else:
        got = tree.tree_accelerations_vs(torch.from_numpy(targets), tp, tm,
                                         **kw)
        want = jax_tree.tree_accelerations_vs(
            jnp.asarray(targets), jnp.asarray(pos), jnp.asarray(m), **kw)
    assert got.dtype == tp.dtype
    assert bool(torch.isfinite(got).all())
    return got.numpy(), np.asarray(want)


# --- the build ------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_build_octree_matches_jax(dtype, tol, x64):
    pos, m = _plummer(2048, seed=1, dtype=dtype)
    got = tree.build_octree(torch.from_numpy(pos), torch.from_numpy(m), 4,
                            quad=True)
    want = jax_tree.build_octree(jnp.asarray(pos), jnp.asarray(m), 4,
                                 quad=True)
    levels, origin, span, coords = got
    np.testing.assert_array_equal(coords.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(origin.numpy(), np.asarray(want[1]))
    assert float(span) == float(want[2])
    assert len(levels) == len(want[0]) == 5
    for d, (ours, theirs) in enumerate(zip(levels, want[0])):
        assert len(ours) == 3
        for a, b in zip(ours, theirs):
            b = np.asarray(b, np.float64)
            assert a.dtype == torch.from_numpy(pos).dtype
            err = np.abs(a.numpy().astype(np.float64) - b).max()
            assert err <= tol * np.abs(b).max(), d
    # Mass is conserved level by level; the monopole-only build carries no
    # quadrupole.
    for cmass, *_ in levels:
        assert abs(float(cmass.double().sum()) - m.astype(np.float64).sum()) \
            <= 1e-5 * m.sum()
    assert all(len(lv) == 2 for lv in tree.build_octree(
        torch.from_numpy(pos), torch.from_numpy(m), 3)[0])


def test_small_leaf_cap_runs_every_overflow_channel():
    """The matrix's inputs overflow: sources past leaf_cap (the remainder
    monopole) and, for the tile engine, targets past t_cap (the whole-cell
    fallback)."""
    pos, m = _plummer(1024, seed=0)
    tp = torch.from_numpy(pos)
    _, origin, span, coords = tree.build_octree(tp, torch.from_numpy(m), 4)
    count = torch.bincount(cells.cell_ids(coords, 16), minlength=16**3)
    assert int(count.max()) > 8 and int((count > 8).sum()) >= 10


# --- the evaluation ------------------------------------------------------


@pytest.mark.parametrize("far,near,quad,ws", [
    (far, near, quad, ws)
    for far in ("direct", "expansion") for near in ("gather", "nlist")
    for quad in (True, False) for ws in (1, 2)
    if not (near == "nlist" and ws != 1)
])
def test_tree_matches_jax(far, near, quad, ws):
    """Plummer, N = 1024, depth 4, leaf_cap 8, fp32: every far mode, near
    mode, quadrupole setting and opening criterion the JAX package takes."""
    pos, m = _plummer(1024, seed=0)
    got, want = _both(pos, m, depth=4, leaf_cap=8, ws=ws, far=far,
                      quad=quad, near_mode=near, chunk=512, **G1)
    assert _max_over_mean(got, want) < TOL[np.float32]


@pytest.mark.parametrize("near", ["gather", "nlist"])
def test_tree_fp64_disk_and_targets_matches_jax(near, x64):
    """The disk (the baseline-1m geometry) in fp64, self and against
    targets other than the sources, depth 4, leaf_cap 8."""
    pos, _, m = _disk(2048, seed=2, dtype=np.float64)
    kw = dict(depth=4, leaf_cap=8, near_mode=near, chunk=700, g=1.0,
              eps=0.05)
    got, want = _both(pos, m, **kw)
    assert _max_over_mean(got, want) < TOL[np.float64]
    targets = pos[:300] * 1.01 + 0.01
    got, want = _both(pos, m, targets, **kw)
    assert _max_over_mean(got, want) < TOL[np.float64]


def test_si_units_stay_finite_in_fp32():
    """A 1e30 kg cluster at 1e12 m scales in fp32: m x and G Q / r^5 are
    out of fp32 range, the normalized build and the factor order keep
    every step finite and on JAX's numbers."""
    pos, m = _plummer(2048, seed=3, scale=1e12, mass=2e33)
    for near in ("gather", "nlist"):
        got, want = _both(pos, m, depth=4, leaf_cap=8, near_mode=near,
                          g=6.6743e-11, eps=1e10)
        assert np.isfinite(got).all() and (got != 0).any()
        assert _max_over_mean(got, want) < TOL[np.float32]
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    pe = tree.tree_potential_energy(tp, tm, depth=4, leaf_cap=8,
                                    g=6.6743e-11, eps=1e10)
    want = jax_tree.tree_potential_energy(jnp.asarray(pos), jnp.asarray(m),
                                          depth=4, leaf_cap=8, g=6.6743e-11,
                                          eps=1e10)
    assert isinstance(pe, np.float64) and np.isfinite(pe) and pe < -1e40
    assert abs(pe - want) <= 1e-5 * abs(want)


def test_mode_errors_match_jax():
    pos = torch.zeros(8, 3)
    m = torch.ones(8)
    for kw, match in ((dict(far="multipole"), "far-field mode"),
                      (dict(near_mode="bogus"), "near-field mode"),
                      (dict(ws=2, near_mode="nlist"), "ws=1")):
        with pytest.raises(ValueError, match=match):
            tree.tree_accelerations(pos, m, depth=2, **kw)
        with pytest.raises(ValueError, match=match):
            jax_tree.tree_accelerations(jnp.zeros((8, 3)), jnp.ones(8),
                                        depth=2, **kw)


# --- the near field through the tile engine ------------------------------


def _near_field_inputs(pos, m, depth, cap):
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    levels, origin, span, coords = tree.build_octree(tp, tm, depth)
    side = 1 << depth
    cells_pos, cells_mass, count, *_ = cells.bin_to_cells(tp, tm, coords,
                                                          side, cap)
    return (tp, coords, cells_pos, cells_mass, count, levels[depth][0],
            levels[depth][1], tm.max(), span, side, cap, 1.0, 1e-10, 0.05)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_nlist_near_field_matches_jax(impl):
    """The port's nlist_near_field (plain tiles, remainder, target
    fallback) against the JAX package's, through its jnp engine and its
    Pallas kernel in interpret mode: N = 400, side 4, cap 8, where both
    overflow channels run. On the CPU the tiles take the plain version and
    launch nothing."""
    pos, m = _plummer(400, seed=4)
    args = _near_field_inputs(pos, m, 2, 8)
    count = args[4]
    assert int(count.max()) > 8
    before = dict(nlist.LAUNCHES)
    got = nlist.nlist_near_field(*args).numpy()
    assert nlist.LAUNCHES == before
    jargs = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
             for a in args]
    want = jax_nlist.nlist_near_field(*jargs, jnp.float32, impl=impl)
    assert _max_over_mean(got, want) < TOL[np.float32]
    # t_cap below cap: more targets take the fallback.
    got = nlist.nlist_near_field(*args, t_cap=2).numpy()
    want = jax_nlist.nlist_near_field(*jargs, jnp.float32, impl="jnp",
                                      t_cap=2)
    assert _max_over_mean(got, want) < TOL[np.float32]


def test_untruncated_launches_count_apart():
    assert nlist.launch_key("newton", False) == "near"
    assert nlist.launch_key("newton", True) == "newton"
    assert nlist.launch_key("ewald", True) == "ewald"
    # The bf16 form counts apart as well (tests/test_torch_nlist_bf16.py),
    # and so do the serve engine's batched launches
    # (tests/test_torch_serve_nlist.py) and the halo engine's slab
    # launches (tests/test_torch_halo.py).
    assert set(nlist.LAUNCHES) == {"newton", "ewald", "near", "newton_bf16",
                                   "near_bf16", "newton/batched",
                                   "newton_bf16/batched", "newton/slab",
                                   "ewald/slab", "newton_bf16/slab"}


# --- sizing helpers and the potential ------------------------------------


def test_depth_and_memory_helpers_match_jax():
    for n in (1, 100, 4096, 65_536, 1 << 20, 1 << 24):
        for cap in (8, 32, 128):
            assert tree.recommended_depth(n, cap) == \
                jax_tree.recommended_depth(n, cap)
            for quad in (True, False):
                for b in (2, 4, 8):
                    assert tree.estimate_cell_memory_bytes(
                        n, 5, cap, quad=quad, dtype_bytes=b
                    ) == jax_tree.estimate_cell_memory_bytes(
                        n, 5, cap, quad=quad, dtype_bytes=b)
    disk, _, _ = _disk(8192, seed=5)
    plummer, _ = _plummer(4096, seed=5)
    cube = np.random.default_rng(6).uniform(-1, 1, (4096, 3))
    for positions in (disk, plummer, cube, cube[:10], np.zeros((64, 3))):
        for cap in (8, 32):
            with warnings.catch_warnings(record=True) as ours:
                warnings.simplefilter("always")
                got = tree.recommended_depth_data(
                    torch.from_numpy(np.ascontiguousarray(positions)), cap,
                    max_depth=4)
            with warnings.catch_warnings(record=True) as theirs:
                warnings.simplefilter("always")
                want = jax_tree.recommended_depth_data(positions, cap,
                                                       max_depth=4)
            assert got == want
            assert [str(w.message) for w in ours] == \
                [str(w.message) for w in theirs]
            for depth in (2, 4):
                assert tree.recommended_leaf_cap(positions, depth) == \
                    jax_tree.recommended_leaf_cap(positions, depth)
    for args in ((1 << 20, 7, 32), (1 << 20, 8, 32), (4096, 3, 8)):
        with warnings.catch_warnings(record=True) as ours:
            warnings.simplefilter("always")
            got = tree.warn_if_cell_memory_heavy(*args, "tree backend")
        with warnings.catch_warnings(record=True) as theirs:
            warnings.simplefilter("always")
            want = jax_tree.warn_if_cell_memory_heavy(*args, "tree backend")
        # Same threshold; the port's text names no TPU memory size.
        assert got == want and len(ours) == len(theirs)
        assert all("octree cell structures" in str(w.message)
                   for w in ours)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tree_potential_energy_matches_jax(dtype, x64):
    pos, _, m = _disk(2048, seed=7, dtype=dtype)
    kw = dict(depth=5, leaf_cap=8, g=1.0, eps=0.05, chunk=512)
    got = tree.tree_potential_energy(torch.from_numpy(pos),
                                     torch.from_numpy(m), **kw)
    want = jax_tree.tree_potential_energy(jnp.asarray(pos), jnp.asarray(m),
                                          **kw)
    assert isinstance(got, np.float64)
    assert abs(got - want) <= {np.float32: 1e-5,
                               np.float64: 1e-10}[dtype] * abs(want)
