"""Direct-sum pairwise gravity in plain PyTorch.

Counterpart of ``gravity_tpu/ops/forces.py``, on the same contract:
``a_i = G * sum_j m_j * (x_j - x_i) / (r^2 + eps^2)^{3/2}``, where pairs
with ``r^2 + eps^2 <= cutoff^2`` (the self-pair among them) contribute
exactly zero and never form a NaN.

These are the plain versions of the hand-written CUDA kernel in
``ops/direct_kernel.py``: the CPU runs them, the tests hold them against
the JAX package, and ``chip_smoke.py`` holds the kernel against them on
the card. The pair sum is an elementwise product and a reduction, never a
matrix product, so TF32 settings cannot touch it.

``rcut`` > 0 truncates at r > rcut: the declared short-range physics of
the cell-list backend (``ops/nlist.py``), whose exact reference this
masked sum is. ``box`` > 0 takes each pair separation to its minimum
image: the rcut-masked periodic oracle of the cell list's periodic form.
"""

from __future__ import annotations

import functools

import torch

from ..constants import CUTOFF_RADIUS, G


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as ``jnp.asarray(value, dtype)``."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=64)
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times it
    rounds as times :func:`_scalar`, with no host-to-device copy."""
    return torch.tensor(value, dtype=dtype).item()


def tiny(dtype: torch.dtype) -> float:
    """The smallest safe divisor floor of a dtype, as a Python float: in
    the normal range, so that a flushed subnormal never turns 0 / floor
    into NaN (``gravity_tpu/ops/numerics.py``)."""
    return rounded(1e-290 if dtype == torch.float64 else 1e-37, dtype)


def _pair_weights(r2, masses_j, g, cutoff, eps, rcut=0.0):
    """w_j = G * m_j / r^3 with cutoff/softening semantics, given r^2;
    ``rcut`` > 0 also zeroes pairs with r > rcut."""
    eps_t = _scalar(eps, r2)
    r2_soft = r2 + eps_t * eps_t
    cutoff_t = _scalar(cutoff, r2)
    ok = r2_soft > cutoff_t * cutoff_t
    if rcut > 0.0:
        rcut_t = _scalar(rcut, r2)
        ok = ok & (r2 <= rcut_t * rcut_t)
    # rsqrt of 1 where the pair is cut keeps the self-pair free of NaN.
    safe_r2 = torch.where(ok, r2_soft, torch.ones_like(r2_soft))
    inv_r = torch.rsqrt(safe_r2)
    # CRITICAL fp32 ordering: inv_r**3 alone underflows to zero for
    # r > ~2e12 m (1e-39 < fp32 min normal 1.2e-38, flushed), silently
    # zeroing every distant pair's force. Folding G*m_j in before the
    # second/third reciprocal factors keeps all intermediates in range.
    w = ((_scalar(g, r2) * masses_j) * inv_r) * inv_r * inv_r
    return torch.where(ok, w, torch.zeros_like(w))


def accelerations_vs(
    pos_i: torch.Tensor,
    pos_j: torch.Tensor,
    masses_j: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    rcut: float = 0.0,
    box: float = 0.0,
) -> torch.Tensor:
    """Accelerations on ``pos_i`` (M, 3) sourced by ``pos_j`` (K, 3) and
    ``masses_j`` (K,). Self-pairs are excluded because r == 0 falls below
    the cutoff; ``rcut`` > 0 truncates at r > rcut. Leading batch axes
    (``(B, M, 3)``, ``(B, K, 3)``, ``(B, K)``: the serve engine's batched
    ``dense`` form, the JAX form under ``vmap``) sum each system apart.
    ``box`` > 0 applies the minimum-image convention to each separation:
    the rcut-masked periodic oracle of the cell list (meaningful with
    rcut < box/2; it is not an Ewald sum of full periodic gravity)."""
    diff = pos_j[..., None, :, :] - pos_i[..., :, None, :]  # (M, K, 3)
    if box > 0.0:
        b = _scalar(box, diff)
        # torch.round rounds half to even, as jnp.round does.
        diff = diff - b * torch.round(diff / b)
    r2 = (diff * diff).sum(dim=-1)  # (M, K)
    w = _pair_weights(r2, masses_j[..., None, :], g, cutoff, eps,
                      rcut)  # (M, K)
    return (w[..., None] * diff).sum(dim=-2)  # (M, 3)


def pairwise_accelerations_dense(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    rcut: float = 0.0,
) -> torch.Tensor:
    """All-pairs accelerations, materializing the (N, N) tensors."""
    return accelerations_vs(positions, positions, masses, g=g,
                            cutoff=cutoff, eps=eps, rcut=rcut)


def pairwise_accelerations_chunked(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    rcut: float = 0.0,
    chunk: int = 1024,
) -> torch.Tensor:
    """All-pairs accelerations with O(N * chunk) peak memory: a loop over
    i-chunks, each summed against all N sources. Unlike the JAX form, N
    need not divide by ``chunk``: the last chunk is ragged."""
    return torch.cat([
        accelerations_vs(pos_i, positions, masses, g=g, cutoff=cutoff,
                         eps=eps, rcut=rcut)
        for pos_i in torch.split(positions, chunk)
    ])


def _potential_rows(pos_i, positions, masses, cutoff, eps):
    """Per-target-row potential sums for targets ``pos_i`` against all
    sources."""
    diff = positions[None, :, :] - pos_i[:, None, :]
    r2 = (diff * diff).sum(dim=-1) + _scalar(eps, positions) ** 2
    cutoff2 = _scalar(cutoff, positions) ** 2
    ok = r2 > cutoff2
    safe_r2 = torch.where(ok, r2, torch.ones_like(r2))
    inv_r = torch.where(ok, torch.rsqrt(safe_r2), torch.zeros_like(r2))
    # (g * m_i) * (m_j * inv_r) stays finite where m_i * m_j alone can
    # overflow fp32 (1e30-mass systems) into inf * 0 = NaN on the diagonal.
    return (masses[None, :] * inv_r).sum(dim=1)


def potential_energy(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    chunk: int = 4096,
) -> torch.Tensor:
    """Total gravitational potential energy: -G * sum_{i<j} m_i m_j / r_ij,
    streamed over i-chunks (O(N * chunk) memory)."""
    gm = _scalar(g, positions) * masses
    rows = torch.cat([
        _potential_rows(pos_i, positions, masses, cutoff, eps)
        for pos_i in torch.split(positions, chunk)
    ])
    # Each unordered pair is counted twice in the full matrix.
    return -0.5 * (gm * rows).sum()
