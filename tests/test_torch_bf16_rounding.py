"""The premise of the bf16 kernels' packed bf16x2 arithmetic.

``csrc/nbody_direct.cu`` and ``csrc/nlist_pair.cu`` compute d, the
squares, r^2 + eps^2, the weight's products (and in ``nbody_direct`` each
w d) with one ``sub``/``add``/``mul.rn.bf16x2``, which rounds the exact
result once to bf16. Their contract, and their plain versions
(``ops/forces.py``, ``nlist.pair_cells_plain``: torch's CPU bf16 ops),
compute each op in fp32 and round that to bf16. The two agree bit for bit
when fp32's 24 bits are at least 2 x 8 + 2 (Figueroa, "When is double
rounding innocuous?", 1995) and the formats share an exponent range, as
fp32 and bf16 do. This checks it exhaustively in ``a``: every finite bf16
value (65,280 of the 65,536 patterns; the rest are infinities and NaNs)
against 256 values of ``b`` drawn from a seed plus the edge values, for
each of +, - and x. The exact rounding is computed in integers, never
through fp32; the cases are checked to include signed zeros, subnormal
results, exact ties, exponent gaps past 24 and overflow to inf.
"""

import numpy as np
import pytest
import torch

from gravity_tpu_torch.ops import forces, nlist

# Edge operands as bf16 bit patterns: +-0, the smallest and largest
# subnormals, the smallest normal, 1, 1 + ulp, 1.5, the largest finite.
EDGES = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x8080, 0x3F80,
         0x3F81, 0xBFC0, 0x7F7F, 0xFF7F, 0x0100, 0x4B00, 0x3380]
N_B = 256
CHUNK = 8


def finite_patterns() -> np.ndarray:
    bits = np.arange(65536, dtype=np.int64)
    return bits[((bits >> 7) & 0xFF) != 0xFF]


def b_patterns() -> np.ndarray:
    rng = np.random.default_rng(2024)
    drawn = rng.choice(finite_patterns(), N_B - len(EDGES), replace=False)
    return np.concatenate([np.array(EDGES, np.int64), drawn])


def decode(bits):
    """(sign, M, E): a finite bf16 is (-1)^sign M 2^E, M < 256 an integer."""
    e = (bits >> 7) & 0xFF
    m = bits & 0x7F
    sign = bits >> 15
    return sign, np.where(e == 0, m, m + 128), np.where(e == 0, -133, e - 134)


def round_exact(sign, n, e):
    """The bits of (-1)^sign n 2^e rounded once to bf16, to nearest even,
    for integers 0 <= n < 2^61; and flags (tie, subnormal, overflow)."""
    safe = np.maximum(n, 1)
    length = np.frexp(safe.astype(np.float64))[1].astype(np.int64)
    q = np.maximum(e + length - 1 - 7, -133)
    shift = q - e
    left = np.clip(-shift, 0, 62)
    right = np.clip(shift, 0, 62)
    r = np.where(shift <= 0, n << left, n >> right)
    rem = np.where(shift <= 0, 0, n & ((np.int64(1) << right) - 1))
    half = np.where(shift <= 0, 1, np.int64(1) << np.maximum(right - 1, 0))
    tie = (shift > 0) & (rem == half)
    up = (shift > 0) & ((rem > half) | (tie & (r & 1 == 1)))
    r = r + up
    carry = r == 256
    r = np.where(carry, 128, r)
    q = q + carry
    exp_field = np.where(r >= 128, q + 134, 0)
    overflow = exp_field >= 255
    mag = np.where(r >= 128, (exp_field << 7) | (r - 128), r)
    mag = np.where(overflow, 0x7F80, mag)
    mag = np.where(n == 0, 0, mag)
    return (sign << 15) | mag, tie, (r < 128) & (r > 0), overflow


def exact_op(op, a, b):
    """The once-rounded bits of a op b, and the coverage flags."""
    sa, ma, ea = decode(a)
    sb, mb, eb = decode(b)
    if op == "mul":
        bits, tie, sub, ovf = round_exact(sa ^ sb, ma * mb, ea + eb)
        gap = np.zeros_like(tie)
        return bits, tie, sub, ovf, gap
    if op == "sub":
        sb = sb ^ 1
    va = np.where(sa == 1, -ma, ma)
    vb = np.where(sb == 1, -mb, mb)
    # Past a gap of 40 exponents the smaller addend (|v| < 2^8 units of
    # its 2^e) only decides the rounding by its sign: it stays below
    # 2^-32 of the larger one's unit, far under half its quantum.
    big_a = ea >= eb
    v1, e1 = np.where(big_a, va, vb), np.where(big_a, ea, eb)
    v2, e2 = np.where(big_a, vb, va), np.where(big_a, eb, ea)
    gap = e1 - e2
    far = gap > 40
    v2 = np.where(far, np.sign(v2), v2)
    e2 = np.where(far, e1 - 40, e2)
    total = (v1 << (e1 - e2)) + v2
    zero_sign = (ma == 0) & (mb == 0) & (sa == 1) & (sb == 1)
    sign = np.where(total == 0, zero_sign, total < 0).astype(np.int64)
    bits, tie, sub, ovf = round_exact(sign, np.abs(total), e2)
    return bits, tie, sub, ovf, (gap > 24) & (ma != 0) & (mb != 0)


def via_fp32(op, a, b):
    """fp32 op of the two bf16 values (exact widenings), rounded to bf16
    to nearest even from the fp32 bits."""
    fa = (a.astype(np.uint32) << 16).view(np.float32)
    fb = (b.astype(np.uint32) << 16).view(np.float32)
    with np.errstate(over="ignore"):
        f = {"add": np.add, "sub": np.subtract, "mul": np.multiply}[op](fa, fb)
    u = f.view(np.uint32).astype(np.int64)
    return (u + 0x7FFF + ((u >> 16) & 1)) >> 16


def torch_bf16(op, a, b):
    """torch's CPU bf16 op, as the plain versions run it."""
    ta = torch.from_numpy(a.astype(np.int16)).view(torch.bfloat16)
    tb = torch.from_numpy(b.astype(np.int16)).view(torch.bfloat16)
    out = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op](ta, tb)
    return out.view(torch.int16).numpy().astype(np.int64) & 0xFFFF


@pytest.fixture(scope="module")
def operands():
    return finite_patterns(), b_patterns()


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_fp32_then_bf16_is_the_once_rounded_result(operands, op):
    a_all, b_all = operands
    seen = np.zeros(5, np.int64)
    for lo in range(0, len(b_all), CHUNK):
        b = np.repeat(b_all[lo:lo + CHUNK], len(a_all))
        a = np.tile(a_all, len(b_all[lo:lo + CHUNK]))
        exact, tie, sub, ovf, gap = exact_op(op, a, b)
        twice = via_fp32(op, a, b)
        bad = np.nonzero(exact != twice)[0]
        assert bad.size == 0, (
            f"{op}: {bad.size} cases, first a={a[bad[0]]:#06x} "
            f"b={b[bad[0]]:#06x}: exact {exact[bad[0]]:#06x}, via fp32 "
            f"{twice[bad[0]]:#06x}")
        seen += [tie.sum(), sub.sum(), ovf.sum(), gap.sum(),
                 ((exact & 0x7FFF) == 0).sum()]
    ties, subnormals, overflows, gaps, zeros = seen
    assert subnormals > 0 and zeros > 0
    if op == "mul":
        assert ties > 0 and overflows > 0
    else:
        assert ties > 0 and overflows > 0 and gaps > 0


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_torch_cpu_bf16_ops_give_those_bits(operands, op):
    """The plain versions' torch CPU bf16 ops round each op once: the
    kernels' packed ops and their plain versions share one definition of
    the pair term."""
    a_all, b_all = operands
    for lo in range(0, len(b_all), 4 * CHUNK):
        b = np.repeat(b_all[lo:lo + 4 * CHUNK], len(a_all))
        a = np.tile(a_all, len(b_all[lo:lo + 4 * CHUNK]))
        exact = exact_op(op, a, b)[0]
        assert np.array_equal(torch_bf16(op, a, b), exact)


def _bits(t):
    return t.contiguous().view(torch.int16).numpy().astype(np.int64) & 0xFFFF


def _to_bf16_bits(f):
    """fp32 values rounded to bf16 to nearest even, from their bits."""
    u = np.asarray(f, np.float32).view(np.uint32).astype(np.int64)
    return (u + 0x7FFF + ((u >> 16) & 1)) >> 16


def _widen(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("eps", [0.0, 1e9])
def test_the_plain_pair_terms_are_that_chain_of_ops(eps):
    """4,096 targets around one source: each output of the plain direct
    sum (one term) and of the plain cell-list tile (one term, its row and
    the accumulator rounded) is the chain d, d^2, r^2 (fp32 (x + y) + z,
    rounded), r^2 + eps^2, rsqrt, the weight's three products and w d,
    with every +, - and x the once-rounded bf16 op (exact, in integers)
    and only the rsqrt taken from torch."""
    bf = torch.bfloat16
    rng = np.random.default_rng(7)
    targets = torch.from_numpy(rng.uniform(-3e11, 3e11, (4096, 3))).to(bf)
    source = torch.from_numpy(rng.uniform(-3e11, 3e11, (1, 3))).to(bf)
    mass = torch.tensor([3.7e24], dtype=bf)
    gm = exact_op("mul", _bits(torch.tensor([forces.rounded(forces.G, bf)],
                                            dtype=bf)), _bits(mass))[0]
    t, s = _bits(targets), _bits(source)
    d = [exact_op("sub", np.broadcast_to(s[:, k], t[:, k].shape), t[:, k])[0]
         for k in range(3)]
    sq = [_widen(exact_op("mul", dk, dk)[0]) for dk in d]
    r2 = _to_bf16_bits((sq[0] + sq[1]) + sq[2])
    eps2 = _bits(torch.tensor([eps], dtype=bf) * torch.tensor([eps], dtype=bf))
    r2s = exact_op("add", r2, np.broadcast_to(eps2, r2.shape))[0] if eps \
        else r2
    inv_r = _bits(torch.rsqrt(torch.from_numpy(
        r2s.astype(np.int16)).view(bf)))
    w = exact_op("mul", np.broadcast_to(gm, inv_r.shape), inv_r)[0]
    w = exact_op("mul", w, inv_r)[0]
    w = exact_op("mul", w, inv_r)[0]
    want = np.stack([exact_op("mul", w, dk)[0] for dk in d], axis=1)
    direct = forces.accelerations_vs(targets, source, mass, eps=eps)
    assert np.array_equal(_bits(direct), want)
    # One cell holding the source, every target in it; rcut far out.
    cells_gm = (mass * forces.rounded(forces.G, bf)).reshape(1, 1)
    tiles = nlist.pair_cells_plain(
        targets[None], torch.tensor([4096]), source[None], cells_gm,
        torch.tensor([1]), 1, torch.tensor([1e30], dtype=bf),
        cutoff=1e-10, eps=eps)
    assert np.array_equal(_bits(tiles[0]), want)
