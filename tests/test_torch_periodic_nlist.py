"""The port's periodic cell list (ops/nlist.py with ``box`` > 0), its
minimum-image encounters and pair potential, against the JAX package on
the CPU.

One seeded numpy state, spilling past the box's faces, goes through both
packages. The periodic cell list is plain PyTorch on every device, as the
JAX package's periodic engine is jnp on every platform. Tolerances: the
cell list within 1e-5 (fp32) and 1e-12 (fp64) of the mean |a| against the
JAX package, as tests/test_torch_nlist.py; against the minimum-image
rcut-masked oracle in float64, with every cell under its cap, 1e-4
(fp32) and 1e-12 (fp64) of each row's sum of |terms|;
distances 1e-5 (fp32) and 1e-12 (fp64) relative, potentials ten times
that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import diagnostics as jax_diag
from gravity_tpu.ops import encounters as jax_enc
from gravity_tpu.ops import forces as jax_forces
from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu_torch.ops import diagnostics, encounters, nlist
from gravity_tpu_torch.ops.forces import accelerations_vs

BOX = 100.0
G1 = dict(g=1.0, eps=0.5)
TOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cloud(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.2 * BOX, 1.2 * BOX, (n, 3)).astype(dtype)
    m = (rng.uniform(0.0, 1.0, n) + 0.5).astype(dtype)
    return pos, m


def _over_mean(got, want):
    want = np.asarray(want, np.float64)
    scale = np.linalg.norm(want, axis=1).mean()
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


def _both(pos, m, targets=None, **kw):
    """(port, JAX) accelerations of the periodic cell list."""
    self_form = targets is None
    t = pos if self_form else targets
    want = jax_nlist.nlist_accelerations_vs(
        jnp.asarray(t), jnp.asarray(pos), jnp.asarray(m), box=BOX,
        _self=self_form, **kw)
    got = nlist.nlist_accelerations_vs(
        torch.from_numpy(t), torch.from_numpy(pos), torch.from_numpy(m),
        box=BOX, _self=self_form, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("side,cap", [(3, 64), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_periodic_cell_list_matches_jax(dtype, side, cap, x64):
    """Side 3 with a cap that holds every cell, side 4 with one (2) small
    enough to reach the remainder monopoles; the rectangular form with a
    target cap of 1 reaches the overflow targets."""
    pos, m = _cloud(256, np.dtype(dtype).type)
    kw = dict(rcut=0.9 * BOX / side, side=side, cap=cap, **G1)
    before = dict(nlist.LAUNCHES)
    got, want = _both(pos, m, **kw)
    assert _over_mean(got, want) < TOL[dtype]
    targets = pos[::5] * np.asarray(0.97, pos.dtype)
    got, want = _both(pos, m, targets=targets, t_cap=1, **kw)
    assert _over_mean(got, want) < TOL[dtype]
    assert nlist.LAUNCHES == before  # plain PyTorch, no kernel
    sizing = dict(rcut=kw["rcut"], box=BOX)
    assert nlist.resolve_nlist_sizing(pos, **sizing) == \
        jax_nlist.resolve_nlist_sizing(pos, **sizing)


def _oracle_f64(pos, m, rcut):
    """The minimum-image rcut-masked direct sum in float64 (numpy), and
    each component's sum of |terms|."""
    p = np.asarray(pos, np.float64)
    d = p[None, :, :] - p[:, None, :]
    d -= BOX * np.round(d / BOX)
    r2 = (d * d).sum(-1)
    w = np.asarray(m, np.float64)[None, :] / (r2 + 0.25) ** 1.5
    w[(r2 > rcut * rcut) | (r2 == 0)] = 0.0
    return (w[..., None] * d).sum(1), (w[..., None] * np.abs(d)).sum(1)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_periodic_cell_list_matches_the_min_image_oracle(dtype, x64):
    """With every cell under its cap, both packages' periodic cell lists,
    and the port's and the JAX package's minimum-image ``accelerations_vs``,
    are the minimum-image rcut-masked direct sum in float64: each
    component within 1e-4 (fp32) or 1e-12 (fp64) of its row's sum of
    |terms| (the chip check's bar)."""
    pos, m = _cloud(300, np.dtype(dtype).type, seed=3)
    rcut = 0.3 * BOX
    kw = dict(rcut=rcut, side=3, cap=128, **G1)
    got, want = _both(pos, m, **kw)
    oracle, scale = _oracle_f64(pos, m, rcut)
    torch_min_image = accelerations_vs(
        *(torch.from_numpy(a) for a in (pos, pos, m)), rcut=rcut, box=BOX,
        **G1).numpy()
    jax_min_image = np.asarray(jax_forces.accelerations_vs(
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(m), rcut=rcut,
        box=BOX, **G1))
    bar = {"float32": 1e-4, "float64": 1e-12}[dtype]
    for a in (got, want, torch_min_image, jax_min_image):
        err = np.abs(np.asarray(a, np.float64) - oracle) / np.maximum(
            scale, 1e-300)
        assert err.max() < bar


def test_resolve_sizing_floors_a_box_at_side_3():
    pos, _ = _cloud(500, np.float64)
    for rcut in (0.5 * BOX, 0.05 * BOX):
        got = nlist.resolve_nlist_sizing(pos, rcut, box=BOX)
        assert got == jax_nlist.resolve_nlist_sizing(pos, rcut, box=BOX)
        assert got[0] >= 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_min_image_encounters_and_pe_match_jax(dtype, x64):
    """closest_pairs with ``box`` (a pair across a face the closest), and
    the ledger's pair potential (untruncated and rcut-shifted) with
    minimum image."""
    pos, m = _cloud(96, np.dtype(dtype).type, seed=7)
    pos[1] = pos[0] + np.asarray([BOX - 0.3, 0.0, 0.0], pos.dtype)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    jd, ji, jj = jax_enc.closest_pairs(jnp.asarray(pos), jnp.asarray(m), k=6,
                                       chunk=32, box=BOX)
    d, i, j = encounters.closest_pairs(tp, tm, k=6, chunk=32, box=BOX)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=TOL[dtype])
    assert {(int(a), int(b)) for a, b in zip(i, j)} == \
        {(int(a), int(b)) for a, b in zip(ji, jj)}
    assert float(d[0]) < 1.0  # the pair across the face
    for rcut in (0.0, 0.3 * BOX):
        want = float(jax_diag.pe_hat_dense(jnp.asarray(pos), jnp.asarray(m),
                                           rcut=rcut, box=BOX, eps=0.5,
                                           chunk=32))
        got = float(diagnostics.pe_hat_dense(tp, tm, rcut=rcut, box=BOX,
                                             eps=0.5, chunk=32))
        assert abs(got - want) <= 10 * TOL[dtype] * abs(want)
