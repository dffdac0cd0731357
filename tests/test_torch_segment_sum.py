"""The bf16 segment sums of the port (``cells.Segments``, the plan and
wrapper of ``csrc/segment_sum.cu``) on the CPU, against the JAX package's
``jax.ops.segment_sum`` at bf16 and an element-order reference in numpy.

The contract is bit for bit: every add rounds to bf16, in element order
inside a segment, from +0, with XLA's CPU flush: a subnormal input, and a
float32 sum below 2^-126 before it is rounded, read as zero of the same
sign. The reference below adds in float32 and rounds to bf16 (round to
nearest even), which gives the bits of one rounding of the exact sum
(``tests/test_torch_bf16_rounding.py``); a NaN total is 0x7fc0, as
torch's bf16 rounding writes every NaN. One place where the JAX package's
CPU sums give other bits, pinned here: XLA keeps the sign of x86's default
NaN (0xffc0 for inf + -inf); only NaN-ness is compared with it.

Only a segment with a tiny row (nonzero, below 2^-119) can come out
otherwise with the flush than without (``csrc/segment_sum.cu``): the
unflushed sum of any other segment is the flushed one, which a seeded test
holds here on sums that cancel down to 2^-126.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu_torch.ops import cells, tree

BF16 = torch.bfloat16
NAN_BITS = 0x7FC0
TINY = np.float32(2.0**-126)  # bf16's and fp32's least normal


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits (uint16), round to nearest even."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    out = rounded.astype(np.uint16)
    out[np.isnan(x)] = NAN_BITS
    return out


def _float(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _flush(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < TINY, np.copysign(np.float32(0), x), x)


def _reference(bits: np.ndarray, ids: np.ndarray, n: int,
               flush: bool = False) -> np.ndarray:
    """(n, cols) bf16 bits of the element-order sum of (N, cols) bf16
    bits; with ``flush``, subnormal inputs and results read as zero."""
    acc = np.zeros((n, bits.shape[1]), np.uint16)
    with np.errstate(all="ignore"):  # inf - inf, overflow: as IEEE says
        for row, s in zip(_float(bits), ids):
            x = _float(acc[s]) + (_flush(row) if flush else row)
            acc[s] = _round_bf16(_flush(x) if flush else x)
    return acc


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _cancelling(rng, shape) -> np.ndarray:
    """Pairs +m 2^-126, -(m +- 1) 2^-126 with m in [129, 254]: no tiny
    row (the least exponent that is not tiny, 2^-119), partial sums that
    step by 2^-126 about zero and land on the least normal."""
    m = rng.integers(129, 255, shape).astype(np.float32)
    m[1::2] = -(m[0::2] + rng.choice(np.float32([-1.0, 1.0]), m[1::2].shape))
    return m * np.float32(2.0**-126)


def _case(name: str):
    """(bf16 bits (N, 4), ids (N,), n) of one edge case, made with numpy
    from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ones_stall_at_256":
        ids = np.repeat(np.arange(4), [5000, 300, 256, 1])
        vals = np.ones((ids.size, 4), np.float32)
        vals[:, 1] = 0.5
    elif name == "signed_zeros":
        ids = rng.integers(0, 6, 400)
        vals = rng.choice(np.float32([0.0, -0.0]), (400, 4))
        vals[ids == 5, 2] = 1.0
    elif name == "subnormals":
        ids = rng.integers(0, 5, 600)
        vals = rng.choice(np.float32([2.0**-130, -(2.0**-131), 2.0**-133,
                                      2.0**-126, -1.5 * 2.0**-126, 0.0]),
                          (600, 4))
    elif name == "inf_and_nan":
        ids = rng.integers(0, 7, 300)
        vals = rng.uniform(-2, 2, (300, 4)).astype(np.float32)
        vals[ids == 1, 0] = np.inf
        vals[ids == 2, 1] = np.inf
        vals[(ids == 2) & (np.arange(300) % 2 == 0), 1] = -np.inf
        vals[ids == 3, 2] = 3e38  # overflows to inf
        vals[(ids == 4) & (np.arange(300) % 5 == 0), 3] = np.nan
    elif name == "tiny_early_in_long_segment":
        # One segment: a subnormal early in column 0 of normal values;
        # 2^-119 and the subnormal -2^-127 opening column 1 of signed
        # zeros, whose total the flush leaves at 2^-119; column 2 without
        # a tiny row; a tiny normal early in column 3.
        ids = np.zeros(4096, np.int64)
        vals = rng.normal(size=(4096, 4)).astype(np.float32)
        vals[3, 0] = 2.0**-130
        vals[:, 1] = rng.choice(np.float32([0.0, -0.0]), 4096)
        vals[:2, 1] = [2.0**-119, -(2.0**-127)]
        vals[5, 3] = -1.5 * 2.0**-126
    elif name == "cancel_to_least_normal":
        ids = np.repeat(np.arange(8), 512)
        vals = _cancelling(rng, (4096, 4))
    elif name == "empty_segments":
        ids = rng.choice(np.int64([3, 17, 18, 40]), 500)
        vals = rng.normal(size=(500, 4)).astype(np.float32)
    elif name == "one_segment":
        ids = np.zeros(3000, np.int64)
        vals = rng.uniform(0.5, 1.5, (3000, 4)).astype(np.float32)
    else:  # mixed: lengths about the kernel's chunk and long-segment edges
        lengths = np.array([0, 1, 7, 8, 9, 15, 16, 17, 255, 256, 257, 513, 3])
        ids = rng.permutation(np.repeat(np.arange(lengths.size), lengths))
        vals = rng.normal(size=(ids.size, 4)).astype(np.float32)
    n = {"empty_segments": 50, "one_segment": 1}.get(name, int(ids.max()) + 1)
    return _round_bf16(vals), ids.astype(np.int64), n


CASES = ["ones_stall_at_256", "signed_zeros", "subnormals", "inf_and_nan",
         "empty_segments", "one_segment", "mixed_lengths",
         "tiny_early_in_long_segment", "cancel_to_least_normal"]


def _torch(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(BF16)


@pytest.mark.parametrize("name", CASES)
def test_merged_columns_match_per_column_plain_and_reference(name):
    """One ``Segments.sum`` of a mass (N,) and a weighted position (N, 3)
    on one id vector gives, bit for bit, each value's own plain sum and
    the element-order reference; the plan and gather the card's launch
    takes, summed by the kernel wrapper's CPU form, give them too."""
    bits, ids, n = _case(name)
    want = _reference(bits, ids, n, flush=True)
    values = _torch(bits)
    mass, pos = values[:, 0].contiguous(), values[:, 1:].contiguous()
    t_ids = torch.from_numpy(ids)
    segments = cells.Segments(t_ids, n)
    before = cells.LAUNCHES
    got_mass, got_pos = segments.sum(mass, pos)
    assert cells.LAUNCHES == before  # the CPU launches nothing
    assert got_mass.shape == (n,) and got_pos.shape == (n, 3)
    np.testing.assert_array_equal(_bits(got_mass), want[:, 0])
    np.testing.assert_array_equal(_bits(got_pos), want[:, 1:])
    np.testing.assert_array_equal(
        _bits(cells.segment_sum_bf16_plain(pos, t_ids, n)), want[:, 1:])
    _, starts = segments.plan()
    rows = segments.gather(mass, pos)
    np.testing.assert_array_equal(
        _bits(cells.segment_sum_rows(rows, starts, ids.size)), want)


@pytest.mark.parametrize("name", CASES)
def test_segment_sum_matches_jax_at_bf16(name):
    """``cells.segment_sum`` at bf16 against ``jax.ops.segment_sum`` at
    bf16 on the same numpy inputs: the same bits, flushed subnormals
    included, bar NaN's sign (module docstring), which is pinned exactly.
    Where a tiny row makes the flush matter, the bits differ from the
    unflushed reference's."""
    bits, ids, n = _case(name)
    got = _bits(cells.segment_sum(_torch(bits), torch.from_numpy(ids), n))
    jx = jax.ops.segment_sum(
        jnp.asarray(bits.view(np.int16)).view(jnp.bfloat16),
        jnp.asarray(ids), num_segments=n)
    want = np.asarray(jx).view(np.uint16)
    np.testing.assert_array_equal(got, _reference(bits, ids, n, flush=True))
    if name in ("subnormals", "tiny_early_in_long_segment"):
        np.testing.assert_array_equal(got, want)
        assert (got != _reference(bits, ids, n)).any()  # the flush fired
        return
    nan = np.isnan(_float(got))
    np.testing.assert_array_equal(nan, np.isnan(_float(want)))
    assert (nan.any() and (got[nan] == NAN_BITS).all()) \
        == (name == "inf_and_nan")
    np.testing.assert_array_equal(got[~nan], want[~nan])


@pytest.mark.parametrize("seed", range(4))
def test_segments_without_a_tiny_row_have_the_same_bits_flushed_or_not(
        seed):
    """The argument the kernel's flag rests on: with no tiny row, every
    partial sum is a multiple of 2^-126 and none lies below it, so
    flushing changes no bit. Sums that cancel down to 2^-126, mixed with
    values of every other exponent, give the same bits with and without
    the flush, and the port (``index_add_`` alone here) gives them."""
    rng = np.random.default_rng(seed)
    vals = _cancelling(rng, (3000, 3))
    # column 2 also takes values of every exponent that is not tiny
    wide = np.float32(2.0) ** rng.integers(-119, 127, 3000)
    vals[:, 2] = np.where(rng.random(3000) < 0.2, wide * rng.choice(
        np.float32([-1.0, 1.0]), 3000), vals[:, 2])
    vals[rng.random(3000) < 0.05, 2] = 0.0
    ids = np.sort(rng.integers(0, 7, 1500)).repeat(2)  # whole pairs
    bits = _round_bf16(vals)
    assert not cells.is_tiny(_torch(bits)).any()
    flushed = _reference(bits, ids, 7, flush=True)
    np.testing.assert_array_equal(flushed, _reference(bits, ids, 7))
    # totals of the cancelling columns a few times 2^-126
    assert (np.abs(_float(flushed[:, :2])) < 2.0**-118).all()
    assert (flushed[:, :2] & 0x7FFF != 0).any()
    got = cells.segment_sum(_torch(bits), torch.from_numpy(ids), 7)
    np.testing.assert_array_equal(_bits(got), flushed)


def test_tiny_marks_nonzero_bf16_below_two_to_the_minus_119():
    """``cells.is_tiny`` over all 65,536 bf16 patterns."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = _float(bits)
    want = (np.abs(x) < 2.0**-119) & (x != 0)
    got = cells.is_tiny(_torch(bits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plan_is_a_stable_sort_with_searched_starts():
    """The plan: a stable sort of the ids, padded with row 0 to a multiple
    of 8 rows; starts from a binary search, so rows of ids past n fall
    after starts[n]; the gather is column-major, one row a value's
    column."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 9, 1001))
    segments = cells.Segments(ids, 7)
    order, starts = segments.plan()
    assert order.shape == (1008,) and bool((order[1001:] == 0).all())
    assert torch.equal(order[:1001], torch.argsort(ids, stable=True))
    counts = torch.bincount(ids, minlength=9)
    assert torch.equal(starts, torch.cat([torch.zeros(1, dtype=torch.int64),
                                          counts.cumsum(0)[:7]]))
    assert segments.plan() is segments.plan()
    a = torch.arange(1001, dtype=torch.float32).to(BF16)
    b = torch.stack([a, -a], dim=1)
    rows = segments.gather(a, b)
    assert rows.shape == (3, 1008) and rows.is_contiguous()
    assert torch.equal(rows[0], a[order]) and torch.equal(rows[2], -a[order])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ids = torch.zeros(16, dtype=torch.int64)
    v = torch.ones(16, 5, dtype=BF16)
    with pytest.raises(ValueError, match="at most 8 values a row"):
        cells.Segments(ids, 2).sum(v, v)
    with pytest.raises(ValueError, match="one id a row"):
        cells.Segments(ids[:-1], 2).sum(v)
    with pytest.raises(TypeError, match="bfloat16"):
        cells.segment_sum_bf16(v.float(), ids, 2)
    rows = torch.zeros(2, 12, dtype=BF16)
    with pytest.raises(ValueError, match="multiple of 8"):
        cells.segment_sum_rows(rows, torch.zeros(3, dtype=torch.int64), 12)
    with pytest.raises(TypeError, match="int64 starts"):
        cells.segment_sum_rows(rows[:, :8], torch.zeros(3, dtype=torch.int32),
                               8)


def test_float_sums_stay_index_add():
    """fp32 and fp64 values take ``index_add_`` one by one, as before."""
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, 4, 300))
    for dtype in (torch.float32, torch.float64):
        a = torch.from_numpy(rng.normal(size=300)).to(dtype)
        b = torch.from_numpy(rng.normal(size=(300, 3))).to(dtype)
        got = cells.Segments(ids, 4).sum(a, b)
        assert torch.equal(got[0], cells.segment_sum(a, ids, 4))
        assert torch.equal(got[1], cells.segment_sum(b, ids, 4))


class _Counting(cells.Segments):
    made = 0
    sums = []

    def __init__(self, ids, n):
        super().__init__(ids, n)
        _Counting.made += 1

    def sum(self, *values):
        _Counting.sums.append(sum(v[0].numel() for v in values))
        return super().sum(*values)


@pytest.mark.parametrize("quad,depth", [(True, 3), (False, 2)])
def test_octree_build_takes_one_plan_and_two_sums_a_level(monkeypatch, quad,
                                                          depth):
    """A build makes one plan a level and sums its masses and weighted
    positions together (4 columns), then its quadrupoles (6): on the card,
    2 launches a level with ``quad``, 1 without."""
    monkeypatch.setattr(tree, "Segments", _Counting)
    _Counting.made, _Counting.sums = 0, []
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.normal(size=(500, 3))).to(BF16)
    m = torch.from_numpy(rng.uniform(1, 2, 500)).to(BF16)
    tree.build_octree(pos, m, depth, quad=quad)
    assert _Counting.made == depth + 1
    assert _Counting.sums == [4, 6] * (depth + 1) if quad \
        else _Counting.sums == [4] * (depth + 1)
