"""The pure-Python launch plan of the direct-sum CUDA kernel.

``direct_kernel.source_chunks`` splits the source axis into S chunks of
whole tiles. It runs on the host before each launch, so it is held here
on the CPU, with the chunks cut as the kernel cuts them: every
source tile has exactly one chunk, no chunk is empty, and a grid that
already fills the card is not split. The shapes are those of the kernel
(256 targets a block, tiles of 256 sources) on a 132-SM card holding 8
blocks an SM.
"""

import pytest

from gravity_tpu_torch.ops import direct_kernel

BLOCK_M, TILE, SMS = 256, 256, 132
SLOTS = SMS * 8


@pytest.mark.parametrize("m,k", [
    (50_000, 50_000), (65_536, 65_536), (7, 20_000), (1, 1_000_000),
    (5_000, 3), (4_096, 1_048_576), (257, 256), (1_000, 1_000), (0, 10),
    (10, 0),
])
def test_source_chunks_cover_every_tile_once(m, k):
    s = direct_kernel.source_chunks(m, k, block_m=BLOCK_M, tile=TILE,
                                    slots=SLOTS)
    n_tiles = -(-k // TILE)
    assert 1 <= s <= max(1, min(direct_kernel.MAX_CHUNKS, n_tiles))
    # Chunk c takes tiles [c n / S, (c + 1) n / S), as the kernel cuts them.
    bounds = [(c * n_tiles // s, (c + 1) * n_tiles // s) for c in range(s)]
    owned = [t for lo, hi in bounds for t in range(lo, hi)]
    assert owned == list(range(n_tiles))
    if n_tiles:
        assert all(hi > lo for lo, hi in bounds)


@pytest.mark.parametrize("waves", [1, 2, 5])
def test_source_chunks_keep_one_chunk_where_the_grid_fills_the_card(waves):
    m = waves * SLOTS * BLOCK_M
    assert direct_kernel.source_chunks(m, 100_000, block_m=BLOCK_M,
                                       tile=TILE, slots=SLOTS) == 1


@pytest.mark.parametrize("m,k", [(50_000, 50_000), (65_536, 65_536)])
def test_source_chunks_fill_the_card_at_the_main_path_shapes(m, k):
    """The reference-cuda and flagship shapes: one block of targets for
    every 256, so 196 or 256 blocks alone leave most of the 1,056 slots
    idle; the split takes the grid to within one wave of full."""
    s = direct_kernel.source_chunks(m, k, block_m=BLOCK_M, tile=TILE,
                                    slots=SLOTS)
    blocks = -(-m // BLOCK_M) * s
    assert s > 1
    assert 0.9 * SLOTS <= blocks <= SLOTS


def test_source_chunks_stay_within_the_rounding_cap():
    assert direct_kernel.source_chunks(1, 10**7, block_m=BLOCK_M, tile=TILE,
                                       slots=SLOTS) == direct_kernel.MAX_CHUNKS


# The Gram kernel (csrc/nbody_mxu.cu) plans with the same function at its
# own block shape: 128 targets a block (4 warps of two 16-row m-tiles),
# 256-source tiles, 7 blocks an SM.
MXU_BLOCK_M, MXU_SLOTS = 128, SMS * 7


@pytest.mark.parametrize("m,k", [
    (65_536, 65_536), (65_535, 65_537), (1, 4_099), (129, 20_011),
    (4_097, 20_003), (1_000, 3), (777, 1_000), (1, 257), (16_384, 1_000_000),
])
def test_source_chunks_at_the_mxu_block_shape_cover_every_tile_once(m, k):
    s = direct_kernel.source_chunks(m, k, block_m=MXU_BLOCK_M, tile=TILE,
                                    slots=MXU_SLOTS)
    n_tiles = -(-k // TILE)
    assert 1 <= s <= max(1, min(direct_kernel.MAX_CHUNKS, n_tiles))
    owned = [t for c in range(s)
             for t in range(c * n_tiles // s, (c + 1) * n_tiles // s)]
    assert owned == list(range(n_tiles))


def test_source_chunks_fill_the_card_at_the_mxu_path_shape():
    """README's flagship N = 65,536: 512 blocks of 128 targets fill 0.55
    of the 924 slots; the split takes the grid past one wave."""
    s = direct_kernel.source_chunks(65_536, 65_536, block_m=MXU_BLOCK_M,
                                    tile=TILE, slots=MXU_SLOTS)
    assert s > 1
    assert 512 * s >= MXU_SLOTS
