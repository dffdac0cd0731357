"""The port's particle-mesh mass assignment against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages:
``gravity_tpu_torch.ops.pm`` against ``gravity_tpu.ops.pm`` (isolated
boundaries). Tolerance: exact. On the CPU both deposits add the same
products in the same order (the eight stencil corners in (dx, dy, dz)
order, each scatter in element order), and the gather is elementwise;
the measured spread is 0 in fp32 and fp64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import cells as jax_cells
from gravity_tpu.ops import pm as jax_pm
from gravity_tpu_torch.ops import cells, pm


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _points(n, seed, dtype):
    """A thin disk-like cloud: dense in the middle, some points on the
    cube's faces (the clamped stencil corners)."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1).astype(dtype)
    masses = rng.uniform(0.5, 1.5, n).astype(dtype)
    return pos, masses


def _both_cubes(pos):
    origin, span = pm.bounding_cube(torch.from_numpy(pos))
    j_origin, j_span = jax_pm.bounding_cube(jnp.asarray(pos))
    np.testing.assert_array_equal(origin.numpy(), np.asarray(j_origin))
    assert float(span) == float(j_span)
    return (origin, span), (j_origin, j_span)


@pytest.mark.parametrize("grid", [8, 32])
def test_cic_deposit_matches_jax(grid):
    pos, masses = _points(3000, seed=grid, dtype=np.float32)
    (origin, span), (j_origin, j_span) = _both_cubes(pos)
    got = pm.cic_deposit(torch.from_numpy(pos), torch.from_numpy(masses),
                         grid, origin, span / (grid - 1))
    want = jax_pm.cic_deposit(jnp.asarray(pos), jnp.asarray(masses), grid,
                              j_origin, j_span / (grid - 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Mass is conserved up to the fp32 sum's rounding.
    np.testing.assert_allclose(float(got.double().sum()),
                               float(masses.astype(np.float64).sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("grid", [8, 32])
def test_cic_gather_matches_jax(grid):
    pos, _ = _points(2000, seed=100 + grid, dtype=np.float32)
    (origin, span), (j_origin, j_span) = _both_cubes(pos)
    rng = np.random.default_rng(grid)
    field = rng.normal(size=(grid, grid, grid, 3)).astype(np.float32)
    got = pm.cic_gather(torch.from_numpy(field), torch.from_numpy(pos),
                        origin, span / (grid - 1))
    want = jax_pm.cic_gather(jnp.asarray(field), jnp.asarray(pos), j_origin,
                             j_span / (grid - 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cic_fp64_matches_jax(x64):
    pos, masses = _points(1000, seed=5, dtype=np.float64)
    (origin, span), (j_origin, j_span) = _both_cubes(pos)
    h, j_h = span / 15, j_span / 15
    got = pm.cic_deposit(torch.from_numpy(pos), torch.from_numpy(masses), 16,
                         origin, h)
    want = jax_pm.cic_deposit(jnp.asarray(pos), jnp.asarray(masses), 16,
                              j_origin, j_h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    field = got[..., None].expand(16, 16, 16, 2).contiguous()
    np.testing.assert_array_equal(
        pm.cic_gather(field, torch.from_numpy(pos), origin, h).numpy(),
        np.asarray(jax_pm.cic_gather(jnp.asarray(field.numpy()),
                                     jnp.asarray(pos), j_origin, j_h)))


def test_cells_re_exports_the_bounding_cube():
    assert cells.bounding_cube is pm.bounding_cube


@pytest.mark.parametrize("n,chunk", [(10, 4), (8, 4), (3, 16), (1, 1)])
def test_map_target_chunks_pads_the_tail(n, chunk):
    """Every call sees a (chunk, 3) block (the tail padded with zero rows,
    never one whole-N block above the chunk), and the result is the
    unchunked one, as the JAX package's map_target_chunks."""
    rng = np.random.default_rng(n)
    targets = rng.normal(size=(n, 3)).astype(np.float32)
    coords = rng.integers(0, 5, (n, 3))
    shapes = []

    def fn(pos_c, coords_c):
        shapes.append(tuple(pos_c.shape))
        return pos_c * 2.0 + coords_c.to(pos_c.dtype)

    got = cells.map_target_chunks(fn, torch.from_numpy(targets),
                                  torch.from_numpy(coords), chunk)
    assert set(shapes) == {(min(chunk, n), 3)}
    assert len(shapes) == -(-n // chunk)
    want = jax_cells.map_target_chunks(
        lambda a: a[0] * 2.0 + a[1].astype(a[0].dtype), jnp.asarray(targets),
        jnp.asarray(coords), chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
