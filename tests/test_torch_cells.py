"""The port's cell binning against the JAX package, bit for bit.

The same numpy positions go through ``gravity_tpu.ops.cells`` (and
``gravity_tpu.ops.pm.bounding_cube``) and ``gravity_tpu_torch.ops.cells``.
Both sides do the same float32 operations in the same order, so the
bounding cube and the cell coordinates agree exactly, and the integer
outputs agree exactly (the port's are int64, the JAX package's int32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.ops import cells as jax_cells
from gravity_tpu.ops.pm import bounding_cube as jax_bounding_cube
from gravity_tpu_torch.ops import cells


def _points(n, seed, span=100.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5 * span, 0.5 * span, (n, 3)).astype(np.float32)


def _jax_binning(pos, w, side, cap):
    origin, span = jax_bounding_cube(jnp.asarray(pos))
    coords = jax_cells.grid_coords(jnp.asarray(pos), origin, span, side)
    out = jax_cells.bin_to_cells(jnp.asarray(pos), jnp.asarray(w), coords,
                                 side, cap)
    return origin, span, coords, out


def _torch_binning(pos, w, side, cap):
    tp = torch.from_numpy(pos)
    origin, span = cells.bounding_cube(tp)
    coords = cells.grid_coords(tp, origin, span, side)
    out = cells.bin_to_cells(tp, torch.from_numpy(w), coords, side, cap)
    return origin, span, coords, out


def test_near_offsets_order_is_the_contract():
    got = cells._near_offsets(1)
    np.testing.assert_array_equal(got, jax_cells._near_offsets(1))
    # The decode the kernel uses: o -> (o // 9 - 1, (o // 3) % 3 - 1,
    # o % 3 - 1).
    o = np.arange(27)
    np.testing.assert_array_equal(
        got, np.stack([o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1], axis=1))


@pytest.mark.parametrize("n,side,seed", [(1000, 6, 0), (257, 3, 1)])
def test_bounding_cube_and_grid_coords_are_bitwise(n, side, seed):
    pos = _points(n, seed)
    j_origin, j_span, j_coords, _ = _jax_binning(
        pos, np.ones(n, np.float32), side, 8)
    origin, span, coords, _ = _torch_binning(
        pos, np.ones(n, np.float32), side, 8)
    np.testing.assert_array_equal(origin.numpy(), np.asarray(j_origin))
    np.testing.assert_array_equal(span.numpy(), np.asarray(j_span))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(j_coords))


@pytest.mark.parametrize("cap", [4, 16, 64])
def test_bin_to_cells_is_bitwise_with_an_overfull_cell(cap):
    """80 of 300 bodies share one corner cell, past every cap here, so
    the stable order within the cell decides which take its slots."""
    pos = _points(300, 2)
    rng = np.random.default_rng(3)
    pos[:80] = (40.0 + rng.uniform(0, 5, (80, 3))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    side = 4
    *_, j_out = _jax_binning(pos, w, side, cap)
    *_, out = _torch_binning(pos, w, side, cap)
    names = ("cells_pos", "cells_w", "count", "start", "sort_order",
             "sorted_ids")
    for name, got, want in zip(names, out, j_out):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    assert int(out[2].max()) > cap


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 10, 200)
    vals = rng.uniform(0, 1, (200, 3)).astype(np.float64)
    import jax

    want = jax.ops.segment_sum(jnp.asarray(vals, jnp.float32),
                               jnp.asarray(ids), num_segments=12)
    got = cells.segment_sum(torch.from_numpy(vals).float(),
                            torch.from_numpy(ids), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
