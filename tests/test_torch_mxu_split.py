"""The TF32 hi/lo split of the Gram kernel's tensor-core accumulation.

``csrc/nbody_mxu.cu`` sums [S | W] = sum_j w_ij [x_j | 1] on the tensor
cores. With fp32 operands it runs TF32 products (10 mantissa bits) on a
split: x_j = x_hi + x_lo and w = w_hi + w_lo, where the hi parts are
rounded to TF32 to nearest, ties away (``cvt.rna.tf32.f32``), x_lo is
rounded so too, and w_lo reaches the tensor core unrounded, which reads
its top 19 bits (:func:`tf32_truncate`). These tests hold the split on
the CPU with ``ops/mxu_kernel.py``'s plain tensor helpers, inputs seeded
with numpy:

- hi + lo reproduces fp32 within 2^-22 relative, both parts TF32;
- the kernel's products, each exact in fp32 and summed here in float64,
  match ``gram_acc4_plain`` within 1e-6 of each row's sum of |terms|;
- the unsplit sum, w and x cut to TF32, misses the all-positive W column
  by more than 1e-4 of that scale: the reason for the split;
- bf16 operands need no split: the bf16 weights times bf16 coordinates
  are exact, and match the plain version within 1e-6 too.

The products are summed in float64 so that only the operands' rounding
is measured; the kernel's own sums are held on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from gravity_tpu_torch.ops import mxu_kernel

G = 6.6743e-11


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _operands(seed, m=64, k=65_536):
    """Centred targets and sources in a 6e11 m cube, masses over two
    decades, eps = 1e9 m: weights spread over ~8 decades."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (k, 3)).astype(np.float32)
    masses = rng.uniform(1e23, 1e25, k).astype(np.float32)
    xj = torch.from_numpy(pos - pos.mean(axis=0, dtype=np.float32))
    gm = torch.from_numpy(masses * np.float32(G))
    return xj[:m].contiguous(), xj, gm


def _weights(xi, xj, gm, eps=1e9):
    return mxu_kernel._gram_weights(
        xi, mxu_kernel._norm2(xi), xj, mxu_kernel._norm2(xj), gm,
        cutoff=1e-10, eps=eps)


def _scaled_err(got, want, scale):
    return ((got.double() - want.double()).abs() / scale).max(dim=0).values


def _term_scale(w, xj):
    xj4 = torch.cat([xj.abs(), torch.ones_like(xj[:, :1])], 1).double()
    return w.double() @ xj4


@pytest.mark.parametrize("value,want", [
    (1.0, 1.0),
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),                 # a tie: away from 0
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),                 # below the tie
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),              # a tie, odd: away
    (2.0 - 2.0**-23, 2.0),                            # carries the exponent
    (0.0, 0.0),
])
def test_tf32_round_is_nearest_ties_away(value, want):
    got = mxu_kernel.tf32_round(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reproduces_fp32(seed):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(-1.0, 1.0, 100_000)
         * 10.0 ** rng.uniform(-30.0, 30.0, 100_000)).astype(np.float32)
    t = torch.from_numpy(x)
    hi, lo = mxu_kernel.tf32_split(t)
    assert bool((_bits(hi) & 0x1FFF == 0).all())
    assert bool((_bits(lo) & 0x1FFF == 0).all())
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0**-22 * t.double().abs()).all())
    # Truncation keeps the high bits and never rounds up.
    cut = mxu_kernel.tf32_truncate(t)
    assert bool((_bits(cut) & 0x1FFF == 0).all())
    assert bool((cut.abs() <= t.abs()).all())
    assert bool(((t - cut).abs() < 2.0**-10 * t.abs() + 1e-45).all())


@pytest.mark.parametrize("seed", [3, 4])
def test_split_sum_matches_plain(seed):
    """The kernel's fp32 accumulation: W_hi B + W_lo B with B = [x_hi,
    y_hi, z_hi, 1, x_lo, y_lo, z_lo, 0]; S = columns 0-2 + 4-6."""
    xi, xj, gm = _operands(seed)
    w = _weights(xi, xj, gm)
    assert float(w[w > 0].max() / w[w > 0].min()) > 1e6
    w_hi = mxu_kernel.tf32_round(w)
    w_lo = mxu_kernel.tf32_truncate(w - w_hi)
    x_hi, x_lo = mxu_kernel.tf32_split(xj)
    one, zero = torch.ones_like(xj[:, :1]), torch.zeros_like(xj[:, :1])
    b = torch.cat([x_hi, one, x_lo, zero], 1).double()
    d = w_hi.double() @ b + w_lo.double() @ b
    got = torch.cat([d[:, 0:3] + d[:, 4:7], d[:, 3:4]], 1)
    want = mxu_kernel.gram_acc4_plain(xi, xj, gm, cutoff=1e-10, eps=1e9,
                                      bf16=False)
    err = _scaled_err(got, want, _term_scale(w, xj))
    assert bool((err < 1e-6).all()), err


@pytest.mark.parametrize("seed", [3, 4])
def test_unsplit_tf32_misses_the_weight_sum(seed):
    """w and x cut to TF32 as a tensor core reads unrounded operands:
    every weight loses up to 2^-10 of itself, all in one direction."""
    xi, xj, gm = _operands(seed)
    w = _weights(xi, xj, gm)
    w_t = mxu_kernel.tf32_truncate(w).double()
    xj4 = torch.cat([mxu_kernel.tf32_truncate(xj),
                     torch.ones_like(xj[:, :1])], 1).double()
    got = w_t @ xj4
    want = mxu_kernel.gram_acc4_plain(xi, xj, gm, cutoff=1e-10, eps=1e9,
                                      bf16=False)
    err = _scaled_err(got, want, _term_scale(w, xj))
    assert float(err[3]) > 1e-4, err


@pytest.mark.parametrize("seed", [5, 6])
def test_bf16_products_are_exact(seed):
    xi, xj, gm = _operands(seed, k=16_384)
    xi_b, xj_b = xi.to(torch.bfloat16), xj.to(torch.bfloat16)
    w = _weights(xi_b.float(), xj_b.float(), gm)
    w_b = w.to(torch.bfloat16).double()
    xj4 = torch.cat([xj_b.float(), torch.ones_like(xj[:, :1])], 1).double()
    got = w_b @ xj4
    want = mxu_kernel.gram_acc4_plain(xi_b, xj_b, gm, cutoff=1e-10, eps=1e9,
                                      bf16=True)
    err = _scaled_err(got, want, _term_scale(w_b, xj_b.float()))
    assert bool((err < 1e-6).all()), err
