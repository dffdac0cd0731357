"""The fp32/fp64 segment sums as one sequential chain a segment
(``ops/cells.py``: ``segment_sum``, ``Segments.sum``,
``sorted_segment_sum``), against ``index_add_`` on the CPU.

``index_add_`` on the card is float atomics, whose order (and last bits)
change from run to run; the chain sums take a stable sort and
``torch.segment_reduce`` instead, the same bits every run. On the CPU
both add in element order, so the bar below (1 ulp of each segment's sum
of |terms|) holds with room; the FMM and tree CPU parity tests hold the
solvers to the JAX package unchanged. The card's two-pass form
(``piecewise_sum``: pieces of 1,024 rows, then the pieces, arrays sized
by the rows) runs here on CPU tensors at small piece sizes: no further
from the float64 sum than the element-order chain plus 4 ulp of the sum
of |terms|.
"""

import numpy as np
import pytest
import torch

from gravity_tpu_torch.ops import sfmm
from gravity_tpu_torch.ops.cells import (
    Segments,
    piecewise_sum,
    segment_sum,
    sorted_segment_sum,
)


def _case(n_rows, n, width, dtype, seed=0):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, n, n_rows))
    shape = (n_rows,) if width == 0 else (n_rows, width)
    values = torch.from_numpy(rng.normal(size=shape) * 10.0 **
                              rng.integers(-3, 4, shape)).to(dtype)
    return values, ids


def _index_add(values, ids, n):
    return torch.zeros((n, *values.shape[1:]), dtype=values.dtype) \
        .index_add_(0, ids, values)


def _ulp_bar(values, ids, n):
    scale = _index_add(values.abs(), ids, n)
    return torch.finfo(values.dtype).eps * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rows,n,width", [(5000, 37, 0), (5000, 37, 3),
                                            (300, 1000, 6), (1, 1, 0),
                                            (0, 4, 3)])
def test_chain_sums_agree_with_index_add(dtype, n_rows, n, width):
    values, ids = _case(n_rows, n, width, dtype)
    want = _index_add(values, ids, n)
    bar = _ulp_bar(values, ids, n)
    for got in (segment_sum(values, ids, n), Segments(ids, n).sum(values)[0]):
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(((got - want).abs() <= bar).all())
    order = torch.argsort(ids, stable=True)
    got = sorted_segment_sum(values[order], ids[order], n)
    assert bool(((got - want).abs() <= bar).all())


def test_integer_counts_stay_exact():
    ids = torch.tensor([2, 0, 2, 2])
    assert segment_sum(torch.ones_like(ids), ids, 4).tolist() == [1, 0, 3, 0]


def test_chain_sums_repeat_their_bits():
    values, ids = _case(20_000, 64, 3, torch.float32, seed=1)
    first = segment_sum(values, ids, 64)
    assert torch.equal(first, segment_sum(values, ids, 64))


def test_sfmm_sums_agree_with_index_add():
    """The sparse FMM's compaction sums (per rank over the leaf-sorted
    bodies) against ``index_add_`` of the same terms."""
    rng = np.random.default_rng(2)
    pos = torch.from_numpy(rng.normal(size=(4000, 3))).float()
    m = torch.from_numpy(rng.uniform(0.5, 1.5, 4000)).float()
    lay = sfmm._build_sparse(pos, m, depth=4, k_cells=64, leaf_cap=8,
                             quad=True)
    m_hat = m[lay["sort_order"]] / lay["m_scale"]
    rank = lay["occ_rank"]
    n = pos.shape[0]
    want_m = _index_add(m_hat, rank, n)
    assert bool(((lay["all_mhat"] - want_m).abs()
                 <= torch.finfo(torch.float32).eps * want_m).all())
    k = lay["k_cells"]
    assert bool(((lay["occ_mhat"] - want_m[:k]).abs()
                 <= torch.finfo(torch.float32).eps * want_m[:k]).all())


@pytest.mark.parametrize("piece", [1, 7, 64, 1024])
@pytest.mark.parametrize("n_rows,n", [(5000, 3), (20_000, 1), (3000, 1000),
                                      (9, 4), (50, 1 << 16)])
def test_piecewise_sum_is_no_worse_than_the_chain(piece, n_rows, n):
    values, ids = _case(n_rows, n, 4, torch.float32, seed=3)
    order = torch.argsort(ids, stable=True)
    values, ids = values[order], ids[order]
    exact = _index_add(values.double(), ids, n)
    chain = segment_sum(values, ids, n).double()
    got = piecewise_sum(values, ids, n, piece).double()
    bar = (chain - exact).abs() + 4 * _ulp_bar(values, ids, n).double()
    assert bool(((got - exact).abs() <= bar).all())
    # The same bits on a second call.
    assert torch.equal(piecewise_sum(values, ids, n, piece),
                       piecewise_sum(values, ids, n, piece))
