"""Cutoff-radius cell-list forces: O(N) truncated short-range pairs.

Counterpart of ``gravity_tpu/ops/pallas_nlist.py`` for its three
consumers, with isolated boundaries: the standalone ``--force-backend
nlist`` (truncated-at-``rcut`` softened Newtonian forces, declared
short-range physics, not an approximation of full gravity; pair kind
``newton``), the P3M near field (:func:`nlist_short_range_cells`, the
erfc remainder of the Ewald split; pair kind ``ewald``) and the octree's
near field (:func:`nlist_near_field`, ``--tree-near nlist``: pair kind
``newton`` with no truncation radius over the tree's leaf blocks):

- **Sort by cell** (``ops/cells.py``): bodies land in a dense
  ``(side^3, cap)`` slot layout over the bounding cube, with the cell
  edge >= rcut so the 27-neighborhood covers every interacting pair.
- **Pair tiles**: each cell's ``(t_cap, cap)`` tile against each of its 27
  neighbors. :func:`pair_cells_kernel` launches the hand-written CUDA
  kernel ``csrc/nlist_pair.cu`` (which replaces the TPU kernel
  ``_nlist_kernel``) for CUDA tensors and takes the plain PyTorch
  version, :func:`pair_cells_plain`, for CPU tensors only.
- **Degradation contracts**, plain PyTorch on every device as in the JAX
  package: a cell's sources beyond ``cap`` act as a cell-size-softened
  monopole at their centre of mass (:func:`_remainder_cells`); targets
  beyond ``t_cap`` take whole neighbor cells as monopoles
  (:func:`_overflow_targets`); the effective radius is
  ``min(rcut, span / side)``, so a shrinking bounding cube degrades the
  radius instead of dropping rim pairs.

No step of a force evaluation waits for the device: the radius is a
device scalar that the kernel reads through a pointer, and the overflow
fallback is computed for every target and selected with ``torch.where``
(the JAX package gates it with ``lax.cond``).

A bf16 state runs bf16 through every step, as the JAX package's does: the
binning, the segment sums (``cells.Segments``, rounded add by add),
rcut_eff^2 rounded to bf16, the overflow channels in bf16 torch ops, and
the pair tiles under the bf16 contract of :func:`pair_cells_plain`,
which the kernel's bf16 form keeps. The ``newton`` kind only: ``ewald``
serves P3M, which takes no bf16 state in either package.

The periodic form (``box`` > 0, the minimum-image cell list of a
periodic run) is plain PyTorch on every device, as the JAX package's is
(its Pallas engine is isolated-BCs only, ``pallas_nlist.py:955-961``):
positions and targets wrap mod box onto a grid over the box, each
neighbour read wraps mod side and shifts the wrapped cell's positions by
+-box, so differences are minimum-image by construction
(:func:`pair_cells_periodic`), and it never launches ``nlist_pair.cu``.
It needs side >= 3.

The slab engines are the domain-decomposed form (``parallel/halo.py``,
the JAX package's ``_*_slab`` engines, ``pallas_nlist.py:623-808``): the
targets are one slab of x-planes, (sx side^2, t_cap) cells, and the sources
its ((sx + 2) side^2, cap) extension, whose planes 0 and sx + 1 are the halo
received from the slab neighbours. An x neighbour is plain plane indexing;
y and z are out of the grid (isolated) or wrapped with a +-box image shift
(periodic). They share ``_tile_rows``' pair weights, ``_monopole_w``,
``_offsets`` and ``_eps_o2`` with the cubic engines, so the two cannot
drift apart. :func:`pair_cells_slab_kernel` launches ``nlist_pair.cu``'s
slab entry for the isolated pair tiles of CUDA tensors; a periodic slab,
like the cubic periodic cell list, stays plain PyTorch on every device
(:func:`pair_cells_slab_plain`).

Gradients: the kernel closures (:func:`make_nlist_local_kernel`,
:func:`make_nlist_batched_kernel`) carry the JAX package's rcut-masked
dense backward (``ops/forces.py::DenseVJP``; JAX wraps its Pallas engine
with ``wrap_with_dense_vjp(..., rcut=rcut)``) on every device. The pair
tile launches themselves have none: on the card each raises where
autograd would need a gradient through it (the ``ewald`` kind and the
untruncated near field, whose ``pallas_call`` has no autodiff rule in JAX
either, and the slab tiles), and never returns a tensor cut from the
graph. The periodic form is plain PyTorch and differentiable.
"""

from __future__ import annotations

import ctypes
import math
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import CUTOFF_RADIUS, G
from ..interop import to_numpy
from ..telemetry.perf import count_launch
from . import cuda_build
from .cells import (
    Segments,
    bin_to_cells,
    bin_to_cells_batched,
    bounding_cube,
    cell_ids,
    grid_coords,
)
from .forces import require_no_grad, rounded, wrap_with_dense_vjp

# Default static per-cell source cap when no occupancy data is available.
DEFAULT_CAP = 64
# Joint (side^3 * cap) slot budget for resolve_nlist_sizing: the padded
# cell arrays are (side^3, cap, 3) floats, 2^23 slots = 96 MiB at fp32.
SLOT_BUDGET = 1 << 23
SIDE_MAX = 96


def resolve_nlist_sizing(
    positions,
    rcut: float,
    cap: int = 0,
    *,
    side: int = 0,
    box: float = 0.0,
    side_max: int = SIDE_MAX,
    slot_budget: int = SLOT_BUDGET,
):
    """Host-side static (side, cap) sizing for a cutoff-radius cell list,
    from concrete positions: over their bounding cube, or with ``box`` > 0
    over the periodic box (positions wrapped into it, side >= 3).

    side = floor(span / rcut) (cell edge >= rcut), capped by a mean
    occupancy of about 2 and clipped to [2, side_max]; cap is the next
    power of two >= the p95 occupied-cell load. When side^3 * cap
    exceeds ``slot_budget`` the grid is halved and the cap re-fit. An
    explicit ``side``/``cap`` pins that knob and fits only the other."""
    if rcut <= 0.0:
        raise ValueError(f"nlist rcut must be > 0, got {rcut}")
    if isinstance(positions, torch.Tensor):
        # A bf16 tensor through float32, which holds it exactly.
        positions = to_numpy(positions)
    pos = np.asarray(positions, np.float64)
    if box > 0.0:
        pos = np.mod(pos, box)
        origin = np.zeros(3)
        span = float(box)
    else:
        lo, hi = pos.min(axis=0), pos.max(axis=0)
        span = float((hi - lo).max()) * 1.02 + 1e-30
        origin = 0.5 * (hi + lo) - 0.5 * span
    side_forced = bool(side)
    # The periodic evaluator needs side >= 3 (at side 2 the +-1 offsets
    # wrap onto the same neighbour twice).
    side_min = 3 if box > 0.0 else 2
    if not side:
        # A grid much finer than the particle count pays pure volume:
        # every cell is 27 tiles of work whether or not anything lives
        # in it. Coarser-than-rcut cells are always correct.
        occ_side = max(side_min, int(np.cbrt(2.0 * max(pos.shape[0], 1))))
        side = int(np.clip(
            min(int(span / rcut), occ_side), side_min, side_max
        ))
    while True:
        u = np.clip(
            ((pos - origin[None, :]) / span * side).astype(np.int64),
            0, side - 1,
        )
        ids = (u[:, 0] * side + u[:, 1]) * side + u[:, 2]
        _, counts = np.unique(ids, return_counts=True)
        p95 = float(np.percentile(counts, 95))
        c = cap
        if not c:
            c = 8
            while c < min(1024, max(8, int(np.ceil(p95)))):
                c *= 2
        if side**3 * c <= slot_budget or side <= side_min or side_forced:
            if span / side < rcut:
                warnings.warn(
                    f"nlist rcut={rcut:g} exceeds the cell edge "
                    f"{span / side:g} at side={side}: the effective "
                    "truncation radius degrades to the cell edge "
                    "(min(rcut, span/side)). Shrink rcut below "
                    "span/2 or raise the side for full-radius "
                    "coverage.",
                    stacklevel=2,
                )
            return side, c
        side = max(side_min, side // 2)


def evaluated_pairs_per_eval(side: int, cap: int, t_cap: int = 0) -> int:
    """Pair-tile slots of a force evaluation, padding included: side^3
    cells x 27 neighbors x (t_cap, cap) tiles. The kernel skips padded
    slots, so the pairs it evaluates are fewer (:func:`real_pairs`)."""
    return side**3 * 27 * (t_cap or cap) * cap


def check_nlist_sizing(n: int, side: int, cap: int) -> str | None:
    """Warning string when the static cell list looks mis-sized for the
    data: a cap below twice the mean cell occupancy."""
    mean_occ = n / side**3
    if cap < 2.0 * mean_occ:
        return (
            f"nlist cap={cap} is below 2x the mean cell occupancy "
            f"({mean_occ:.1f} at side {side}): dense cells will "
            "overflow to the monopole remainder on near pairs. Raise "
            "--nlist-cap (or let resolve_nlist_sizing pick from the "
            "data)."
        )
    return None


# ---------------------------------------------------------------------------
# Pair weights: the plain tile engine's math. The CUDA kernel repeats it
# with the same roundings (csrc/nlist_pair.cu).
# ---------------------------------------------------------------------------


def _newton_w(r2, gm, params, *, cutoff, eps, use_rcut):
    """Truncated softened-Newtonian diff-multiplier: w = G m / (r^2 +
    eps^2)^(3/2) for cutoff^2 < r^2 + eps^2, r^2 <= params[0] =
    rcut_eff^2 (a device scalar) and r > 0. gm is G*m, zero on padded
    slots. eps^2 and cutoff^2 are squared in double and then rounded to
    the dtype, as the JAX package rounds them: a Python scalar in a bf16
    tensor op would enter at fp32."""
    r2s = r2 + rounded(eps * eps, r2.dtype)
    valid = (r2s > rounded(cutoff * cutoff, r2.dtype)) & (r2 > 0)
    if use_rcut:
        valid = valid & (r2 <= params[0])
    inv_r = torch.rsqrt(torch.where(valid, r2s, 1.0))
    return torch.where(valid, ((gm * inv_r) * inv_r) * inv_r, 0.0)


_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def _short_range_terms(r2, alpha, eps2, alpha3):
    """The two terms of the P3M short-range diff-multiplier (``p3m.py``'s
    ``_short_range_w`` in the JAX package): the softened Newtonian
    (r^2 + eps^2)^(-3/2) and the erf correction alpha^3 hfun(u) / u^2
    with u = alpha r and hfun(u) = (2/sqrt(pi)) exp(-u^2) - erf(u)/u
    (<= 0: it takes out the mesh's smooth part). hfun/u^2 is taken from
    its series below u = 0.05, where the exact form is 0/0 at u = 0.
    Near rcut the two terms almost cancel, so the rounding of their sum
    is measured against |newt| + |corr|. ``eps2`` may be a tensor (the
    overflow channels widen it per cell)."""
    u = alpha * torch.sqrt(torch.clamp_min(r2, 1e-30))
    newt = torch.rsqrt(torch.clamp_min(r2 + eps2, 1e-30))
    newt = newt * newt * newt
    safe_u = torch.clamp_min(u, 1e-20)
    exact = (
        _TWO_OVER_SQRT_PI * torch.exp(-u * u)
        - torch.special.erf(safe_u) / safe_u
    ) / (safe_u * safe_u)
    series = _TWO_OVER_SQRT_PI * (-2.0 / 3.0 + (2.0 / 5.0) * u * u)
    return newt, alpha3 * torch.where(u < 0.05, series, exact)


def _short_range_w(r2, alpha, eps2, alpha3):
    """diff-multiplier of the P3M short-range pair force:
    (r^2 + eps^2)^(-3/2) + alpha^3 hfun(u) / u^2 (:func:`_short_range_terms`)."""
    newt, corr = _short_range_terms(r2, alpha, eps2, alpha3)
    return newt + corr


def _ewald_w(r2, gm, params, *, cutoff, eps, absolute=False):
    """P3M short-range (erfc-remainder) diff-multiplier through the cell
    list: params = [rcut^2, alpha] (device scalars: both follow the mesh
    spacing). Masks as the P3M gather pass: r^2 < rcut^2 (strict),
    cutoff^2 < r^2 + eps^2 and r > 0. ``absolute`` weighs each pair by
    gm (|newt| + |corr|), the scale its rounding is measured in."""
    alpha = params[1]
    eps2 = eps * eps
    valid = (r2 < params[0]) & (r2 + eps2 > cutoff * cutoff) & (r2 > 0)
    newt, corr = _short_range_terms(r2, alpha, eps2, alpha * alpha * alpha)
    w = newt.abs() + corr.abs() if absolute else newt + corr
    return torch.where(valid, gm * w, 0.0)


KINDS = ("newton", "ewald")


def _pair_w(kind: str, r2, gm, params, *, cutoff, eps, use_rcut,
            absolute=False):
    """The pair weight of ``kind``; ``absolute`` takes the ewald weight's
    terms before they cancel (the newton weight is >= 0 already)."""
    if kind == "newton":
        return _newton_w(r2, gm, params, cutoff=cutoff, eps=eps,
                         use_rcut=use_rcut)
    if kind == "ewald":
        return _ewald_w(r2, gm, params, cutoff=cutoff, eps=eps,
                        absolute=absolute)
    raise ValueError(f"unknown nlist pair kind {kind!r}; choose from {KINDS}")


def _monopole_w(kind: str, r2, w_mass, params, eps_o2):
    """Overflow-channel monopole diff-multiplier: the pair kernel at a
    cell-size-widened softening, masked only through ``w_mass`` (zero off
    the overflow set); no rcut or cutoff mask, mass is never dropped."""
    if kind == "newton":
        inv_r = torch.rsqrt(torch.clamp_min(r2 + eps_o2, 1e-30))
        return ((w_mass * inv_r) * inv_r) * inv_r
    alpha = params[1]
    return w_mass * _short_range_w(r2, alpha, eps_o2, alpha * alpha * alpha)


def cell_totals(positions, masses, sort_order, sorted_ids, count,
                m_scale=None):
    """Per-cell totals for the overflow channels, in normalized mass
    (``pallas_nlist.py:1005-1012``): (m_scale, cell mass / m_scale, cell
    centre of mass), from the binning's stable sort
    (:func:`cells.bin_to_cells`' sort_order, sorted_ids and count). The
    masses and weighted positions are summed in one pass over the bodies
    in that order (element order inside a cell), each cell's sum one
    sequential chain, so the totals are the same bits on every run and on
    the CPU and the card (an ``index_add_`` of floats on the card is
    atomics, whose order, and last bits, change from run to run):
    ``torch.segment_reduce`` at fp32 and fp64, and at bf16 the JAX
    package's rounded adds through ``Segments`` (on the card one launch of
    ``csrc/segment_sum.cu``).

    A batch, positions (B, n, 3) and masses (B, n), takes each slot's own
    m_scale and :func:`cells.bin_to_cells_batched`' sort over the
    flattened ids: (m_scale (B,), (B, side^3), (B, side^3, 3)), each
    slot's segments its solo segments in the same order. ``m_scale`` given
    (a mesh's global scale) replaces the masses' own."""
    if m_scale is None:
        m_scale = torch.clamp_min(masses.max(dim=-1).values, 1e-37)
    m_hat = masses / m_scale[..., None]
    mw = (m_hat[..., None] * positions).reshape(-1, 3)
    m_hat = m_hat.reshape(-1)
    if masses.dtype == torch.bfloat16:
        cmass_hat, cmw = Segments(sorted_ids, count.numel()).sum(
            m_hat[sort_order], mw[sort_order])
    else:
        sums = torch.segment_reduce(
            torch.cat([m_hat[:, None], mw], dim=1)[sort_order], "sum",
            lengths=count.reshape(-1), unsafe=True)
        cmass_hat, cmw = sums[:, 0], sums[:, 1:]
    ccom = cmw / torch.clamp_min(cmass_hat, 1e-37)[:, None]
    lead = masses.shape[:-1]
    return (m_scale, cmass_hat.reshape(*lead, -1),
            ccom.reshape(*lead, -1, 3))


def _source_overflow_channels(cells_pos, cells_mass, cell_count, cmass_hat,
                              ccom, m_scale, g, cap: int):
    """(rem_w, rem_com, over): each cell's beyond-cap remainder weight
    (G * remainder mass), centre of mass and overflow flag, accumulated
    in normalized mass (m * x overflows fp32 at astronomical scales). A
    batch has a leading slot axis on every array and m_scale (B,).

    A cell whose remainder is empty (rem_mhat = 0: only zero-mass
    padding past the cap, as a padded serve job parks in its first
    body's cell) takes its centre of mass as 0: the rounding residue of
    its weighted positions over the 1e-37 floor can overflow to inf (at
    bf16 every few padded states), and 0 times inf would put NaN into
    every neighbour's remainder term where the monopole weighs 0."""
    ms = m_scale[..., None]  # a slot's scale over its cells
    pref_mhat = cells_mass.sum(dim=-1) / ms
    over = cell_count > cap
    rem_mhat = torch.clamp_min(
        torch.where(over, cmass_hat - pref_mhat, 0.0), 0.0
    )
    tot_mw = ccom * cmass_hat[..., None]
    pref_mw = ((cells_mass / ms[..., None])[..., None] * cells_pos).sum(
        dim=-2)
    rem_com = torch.where(
        (rem_mhat > 0)[..., None],
        (tot_mw - pref_mw) / torch.clamp_min(rem_mhat, 1e-37)[..., None],
        0.0)
    rem_w = g * rem_mhat * ms
    return rem_w, rem_com, over


def _offsets(device) -> torch.Tensor:
    """The 27 stencil offsets in ``cells._near_offsets(1)`` order, made on
    the device (no host-to-device copy)."""
    o = torch.arange(27, device=device)
    return torch.stack([o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1], dim=-1)


def _neighbors(coords: torch.Tensor, side: int, offsets=None):
    """(ids, inside): the flat ids (clipped into the grid) of the
    neighbors of each cell coordinate (M, 3) at ``offsets`` (K, 3), all 27
    by default, and which lie in the grid; (M, K) each."""
    if offsets is None:
        offsets = _offsets(coords.device)
    cell = coords[:, None, :] + offsets[None]
    inside = ((cell >= 0) & (cell < side)).all(dim=-1)
    ids = cell_ids(cell.clamp(0, side - 1).reshape(-1, 3), side)
    return ids.reshape(cell.shape[:2]), inside


def _periodic_neighbors(coords: torch.Tensor, side: int, offsets, box: float,
                        dtype):
    """(ids, shift): the flat ids of the neighbours of each cell
    coordinate (M, 3) at ``offsets`` (K, 3), wrapped mod side, and the
    image shift (M, K, 3) = box * floor((coord + offset) / side) that
    brings a wrapped neighbour's positions next to the cell (a value of
    -box, 0 or +box, rounded to ``dtype``)."""
    cell = coords[:, None, :] + offsets[None]
    ids = cell_ids(torch.remainder(cell, side).reshape(-1, 3), side)
    shift = rounded(box, dtype) * torch.div(
        cell, side, rounding_mode="floor").to(dtype)
    return ids.reshape(cell.shape[:2]), shift


def _all_coords(side: int, device, planes: int = 0) -> torch.Tensor:
    """(planes side^2, 3) coordinates of every cell of ``planes`` x-planes
    (0: all ``side``), in flat-id order."""
    c = torch.arange((planes or side) * side * side, device=device)
    return torch.stack([c // (side * side), (c // side) % side, c % side],
                       dim=-1)


def _slab_neighbors(coords: torch.Tensor, side: int, offsets, box: float,
                    dtype):
    """(ids, inside, shift) of slab cell coordinates (M, 3), x in [0, sx),
    at ``offsets`` (K, 3) on the x-extended ((sx + 2), side, side) grid:
    neighbour plane x + 1 + dx is always in it. Isolated (``box`` 0): y and
    z clipped into the grid, ``inside`` (M, K) where they lie in it, shift
    None. Periodic: y and z wrapped mod side, ``inside`` None and ``shift``
    (M, K, 3) the image shift box * floor((coord + offset) / side) of y and
    z (x's image arrives already shifted with the halo planes)."""
    cell = coords[:, None, :] + offsets[None]
    cx, cyz = cell[..., 0] + 1, cell[..., 1:]
    inside = shift = None
    if box > 0.0:
        yz = rounded(box, dtype) * torch.div(
            cyz, side, rounding_mode="floor").to(dtype)
        shift = torch.cat([torch.zeros_like(yz[..., :1]), yz], dim=-1)
        cyz = torch.remainder(cyz, side)
    else:
        inside = ((cyz >= 0) & (cyz < side)).all(dim=-1)
        cyz = cyz.clamp(0, side - 1)
    return (cx * side + cyz[..., 0]) * side + cyz[..., 1], inside, shift


# Bytes of one batch of per-offset terms in the overflow channels. The 27
# offsets are taken in consecutive groups (in _near_offsets order) whose
# terms fit in it, and each group's terms are summed at once into the
# accumulator. P3M's (side^3, t_cap, 3) blocks at side 51 (102 MB in fp32)
# go two offsets at a time instead of a 2.75 GB (side^3, 27, t_cap, 3)
# temporary; the README nlist run's (143 MB for all 27) and smaller grids
# take all 27 in one group, since each launch costs the host more than
# the device there.
OFFSET_BATCH_BYTES = 1 << 28


def _offset_groups(per_offset_bytes: int):
    k = int(max(1, min(27, OFFSET_BATCH_BYTES // max(per_offset_bytes, 1))))
    return [slice(lo, min(lo + k, 27)) for lo in range(0, 27, k)]


def _eps_o2(eps: float, cell_h):
    """The overflow channels' softening^2: max(eps, cell/2)^2."""
    half = 0.5 * cell_h
    return torch.clamp_min(half * half, eps * eps)


def _remainder_cells(tcells_pos, rem_w, rem_com, over, side: int, params,
                     *, kind: str, eps: float, cell_h, box: float = 0.0):
    """Source-cap-overflow remainder: each neighbor cell's beyond-cap mass
    as a cell-size-softened monopole through the pair kernel,
    (side^3, t_cap, 3), added to the tile engine's output. ``eps`` is
    widened to max(eps, cell/2): an overflowing cell's centre of mass can
    sit arbitrarily close to a target. Offset groups per
    :data:`OFFSET_BATCH_BYTES` of one system's terms. A batch (the
    ``newton`` kind) has a leading slot axis on the arrays and ``cell_h``
    (B,); each slot's terms are its solo terms, grouped alike. ``box`` > 0
    (solo only) wraps the neighbour reads and shifts a wrapped cell's
    centre of mass by its image."""
    eps_o2 = _eps_o2(eps, cell_h)
    eps_o2 = eps_o2.reshape(*eps_o2.shape, 1, 1, 1)
    coords = _all_coords(side, tcells_pos.device)
    offsets = _offsets(tcells_pos.device)
    acc = torch.zeros_like(tcells_pos)
    per_offset = math.prod(tcells_pos.shape[-3:]) * tcells_pos.element_size()
    for group in _offset_groups(per_offset):
        if box > 0.0:
            ids, shift = _periodic_neighbors(coords, side, offsets[group],
                                             box, tcells_pos.dtype)
            w_n, ov_n = rem_w[ids], over[ids]
            com_n = rem_com[ids] + shift
        else:
            ids, inside = _neighbors(coords, side, offsets[group])  # (S^3, K)
            w_n = torch.where(inside, rem_w[..., ids], 0.0)
            ov_n = inside & over[..., ids]
            com_n = rem_com[..., ids, :]
        diff = torch.where(
            ov_n[..., None, None],
            com_n[..., None, :] - tcells_pos[..., :, None, :, :],
            0.0,
        )  # (S^3, K, t_cap, 3)
        r2 = (diff * diff).sum(dim=-1)
        w = _monopole_w(kind, r2, w_n[..., None], params, eps_o2)
        acc.add_((w[..., None] * diff).sum(dim=-3))
    return acc


def _overflow_targets(t_pos, t_coords, cell_w, ccom, side: int, params, *,
                      kind: str, eps: float, cell_h, slot=None,
                      per_offset_bytes=None, box: float = 0.0):
    """Fallback for targets beyond t_cap: the 27 neighbor cells as
    whole-cell monopoles (cell-size softened) through the pair kernel,
    (M, 3), in offset groups as :func:`_remainder_cells`. A batch's
    targets (the ``newton`` kind), flattened to (M, 3), name their slot
    (``slot`` (M,)) in flat cell_w (B side^3,) and ccom (B side^3, 3), with
    ``cell_h`` (B,) and the group size of one system's ``per_offset_bytes``
    (its targets' bytes). ``box`` > 0 (solo only) wraps the neighbour ids
    and shifts a wrapped cell's centre of mass by its image."""
    eps_o2 = _eps_o2(eps, cell_h)
    base = None
    if slot is not None:
        eps_o2 = eps_o2[slot][:, None]
        base = (slot * side**3)[:, None]
    offsets = _offsets(t_pos.device)
    acc = torch.zeros_like(t_pos)
    if per_offset_bytes is None:
        per_offset_bytes = t_pos.numel() * t_pos.element_size()
    for group in _offset_groups(per_offset_bytes):
        if box > 0.0:
            ids, shift = _periodic_neighbors(t_coords, side, offsets[group],
                                             box, t_pos.dtype)
            sw = cell_w[ids]
            diff = ccom[ids] + shift - t_pos[:, None, :]
        else:
            ids, inside = _neighbors(t_coords, side, offsets[group])  # (M, K)
            if base is not None:
                ids = ids + base
            sw = torch.where(inside, cell_w[ids], 0.0)
            diff = torch.where(inside[..., None],
                               ccom[ids] - t_pos[:, None, :], 0.0)
        r2 = (diff * diff).sum(dim=-1)
        w = _monopole_w(kind, r2, sw, params, eps_o2)
        acc.add_((w[..., None] * diff).sum(dim=1))
    return acc


def _remainder_cells_slab(tcells_pos, rem_w, rem_com, over, sx: int,
                          side: int, params, *, kind: str, eps: float,
                          cell_h, box: float = 0.0):
    """:func:`_remainder_cells` over a slab (``_remainder_cells_slab``,
    ``pallas_nlist.py:700``): targets the slab's (sx side^2, t_cap, 3), the
    remainder channels over the extended ((sx + 2) side^2,) grid. An
    isolated edge's missing halo arrives zero (over False): an exact no-op."""
    eps_o2 = _eps_o2(eps, cell_h)
    coords = _all_coords(side, tcells_pos.device, sx)
    offsets = _offsets(tcells_pos.device)
    acc = torch.zeros_like(tcells_pos)
    per_offset = math.prod(tcells_pos.shape[-3:]) * tcells_pos.element_size()
    for group in _offset_groups(per_offset):
        ids, inside, shift = _slab_neighbors(coords, side, offsets[group],
                                             box, tcells_pos.dtype)
        w_n, ov_n, com_n = rem_w[ids], over[ids], rem_com[ids]
        if box > 0.0:
            com_n = com_n + shift
        else:
            w_n = torch.where(inside, w_n, 0.0)
            ov_n = inside & ov_n
        diff = torch.where(ov_n[..., None, None],
                           com_n[..., None, :] - tcells_pos[:, None], 0.0)
        r2 = (diff * diff).sum(dim=-1)
        w = _monopole_w(kind, r2, w_n[..., None], params, eps_o2)
        acc.add_((w[..., None] * diff).sum(dim=-3))
    return acc


def _overflow_targets_slab(t_pos, t_coords, cell_w, ccom, side: int, params,
                           *, kind: str, eps: float, cell_h,
                           box: float = 0.0):
    """:func:`_overflow_targets` over a slab (``_overflow_targets_slab``,
    ``pallas_nlist.py:760``): ``t_coords`` are the targets' slab
    coordinates (x in [0, sx)), ``cell_w``/``ccom`` span the extended
    ((sx + 2) side^2,) grid; a missing isolated halo weighs zero."""
    eps_o2 = _eps_o2(eps, cell_h)
    offsets = _offsets(t_pos.device)
    acc = torch.zeros_like(t_pos)
    for group in _offset_groups(t_pos.numel() * t_pos.element_size()):
        ids, inside, shift = _slab_neighbors(t_coords, side, offsets[group],
                                             box, t_pos.dtype)
        sw, com = cell_w[ids], ccom[ids]
        if box > 0.0:
            diff = com + shift - t_pos[:, None, :]
        else:
            sw = torch.where(inside, sw, 0.0)
            diff = torch.where(inside[..., None], com - t_pos[:, None, :],
                               0.0)
        r2 = (diff * diff).sum(dim=-1)
        w = _monopole_w(kind, r2, sw, params, eps_o2)
        acc.add_((w[..., None] * diff).sum(dim=1))
    return acc


# ---------------------------------------------------------------------------
# The pair-tile engine: plain version and CUDA kernel
# ---------------------------------------------------------------------------


# Pair slots a batch of target cells of the plain version: bounds its
# temporaries at a few tens of MB whatever the tile.
PLAIN_BATCH_SLOTS = 1 << 22


def pair_cells_plain(tcells_pos, t_count, cells_pos, cells_gm, s_count,
                     side: int, params, *, cutoff: float, eps: float,
                     use_rcut: bool = True, kind: str = "newton",
                     absolute: bool = False):
    """The 27-neighborhood pair-tile sum, (side^3, t_cap, 3), in plain
    PyTorch: the plain version of :func:`pair_cells_kernel`.

    tcells_pos (side^3, t_cap, 3) targets and cells_pos (side^3, cap, 3)
    sources in cell-slot layout; cells_gm (side^3, cap) is G*m, zero on
    padded slots; t_count (side^3,) the targets of each cell. ``kind``
    "newton" takes params[0] = rcut_eff^2 (``use_rcut``); "ewald" takes
    params = [rcut^2, alpha] and always truncates. Each tile row is
    summed apart and then added to the accumulator, offset by offset in
    ``_near_offsets`` order, as the kernel does. Only cells that hold
    targets are evaluated (read on the host), in batches; every other
    slot, and target slots past a cell's count, are zero. ``s_count`` is
    unused: padded sources are exact no-ops here, as are out-of-grid
    neighbors (their G*m is taken as zero). ``absolute`` sums each pair's
    terms in absolute value before any cancellation (for ``ewald`` gm
    (|newt| + |corr|) |d|): the scale a row's rounding is measured in.

    At bf16 (``newton`` only) the contract of the JAX tile engines, which
    the kernel's bf16 form keeps: each op of a pair term is rounded to
    bf16 (d, each d^2, r^2 with its three squares added in fp32 in the
    order (x + y) + z and rounded once, r^2 + eps^2, rsqrt, the weight's
    three products); each (cell, offset) row sum_s w d is formed in fp32
    from the exact products and rounded to bf16 once, as
    ``jnp.einsum`` does (``pallas_nlist.py:487``); and the accumulator
    is bf16, rounded after each of the 27 offsets (``:490-491``)."""
    del s_count
    t_cap, cap = tcells_pos.shape[1], cells_pos.shape[1]
    out = torch.zeros_like(tcells_pos)
    occupied = torch.nonzero(t_count > 0).flatten()
    coords = torch.stack([occupied // (side * side),
                          (occupied // side) % side, occupied % side],
                         dim=-1)
    batch = max(1, PLAIN_BATCH_SLOTS // (t_cap * cap))
    for lo in range(0, occupied.numel(), batch):
        cb = occupied[lo:lo + batch]
        ids, inside = _neighbors(coords[lo:lo + batch], side)  # (B, 27)
        tpos = tcells_pos[cb][:, :, None, :]  # (B, t_cap, 1, 3)
        acc = tcells_pos.new_zeros((cb.numel(), t_cap, 3))
        for o in range(27):
            spos = cells_pos[ids[:, o]][:, None]  # (B, 1, cap, 3)
            sgm = torch.where(inside[:, o, None], cells_gm[ids[:, o]],
                              0.0)[:, None]  # (B, 1, cap)
            acc = acc + _tile_rows(tpos, spos, sgm, params, kind=kind,
                                   cutoff=cutoff, eps=eps, use_rcut=use_rcut,
                                   absolute=absolute)
        out[cb] = acc
    real = torch.arange(t_cap, device=out.device)[None, :] < t_count[:, None]
    return torch.where(real[..., None], out, 0.0)


def _tile_rows(tpos, spos, sgm, params, *, kind, cutoff, eps, use_rcut,
               absolute=False):
    """One neighbour offset's row sums sum_s w d of a batch of cell
    tiles, (B, t_cap, 3) in the targets' dtype: tpos (B, t_cap, 1, 3),
    spos (B, 1, cap, 3), sgm (B, 1, cap). The bf16 contract of
    :func:`pair_cells_plain`."""
    low = tpos.dtype == torch.bfloat16
    dx = spos[..., 0] - tpos[..., 0]  # (B, t_cap, cap)
    dy = spos[..., 1] - tpos[..., 1]
    dz = spos[..., 2] - tpos[..., 2]
    if low:
        sq = [(d * d).float() for d in (dx, dy, dz)]
        r2 = ((sq[0] + sq[1]) + sq[2]).to(torch.bfloat16)
        dx, dy, dz = (d.float() for d in (dx, dy, dz))
    else:
        r2 = dx * dx + dy * dy + dz * dz
    w = _pair_w(kind, r2, sgm, params, cutoff=cutoff, eps=eps,
                use_rcut=use_rcut, absolute=absolute)
    if low:
        w = w.float()  # the products w d are exact in fp32
    terms = torch.stack([w * dx, w * dy, w * dz], dim=-1)
    if absolute:
        terms = terms.abs()
    return terms.sum(dim=2).to(tpos.dtype)


def pair_cells_periodic(tcells_pos, cells_pos, cells_gm, side: int, params,
                        *, box: float, cutoff: float, eps: float):
    """The periodic 27-neighbourhood pair-tile sum of the ``newton`` kind
    with the rcut mask, (side^3, t_cap, 3), in plain PyTorch on every
    device: the JAX package's periodic engine (``_jnp_pair_cells(box=)``,
    jnp on the TPU too), which the CUDA kernel does not take. Neighbour
    (c + offset) mod side is read with its positions shifted by the
    image, +-box on each wrapped axis, so every difference is the minimum
    image (side >= 3 and cell edge >= rcut put each in-range pair in one
    offset). Whole x-planes of target cells go at once, as many as keep
    the live (cells, t_cap, cap) transient within
    :data:`PLAIN_BATCH_SLOTS` pair slots (at least one plane), with no
    host read. Padded target slots are not masked: the caller reads the
    real slots only."""
    t_cap, cap = tcells_pos.shape[1], cells_pos.shape[1]
    device, dtype = tcells_pos.device, tcells_pos.dtype
    plane = side * side
    coords = _all_coords(side, device)
    offsets = _offsets(device)
    planes = max(1, PLAIN_BATCH_SLOTS // (plane * t_cap * cap))
    out = []
    for x0 in range(0, side, planes):
        cb = slice(x0 * plane, min(side, x0 + planes) * plane)
        ids, shift = _periodic_neighbors(coords[cb], side, offsets, box,
                                         dtype)  # (C, 27), (C, 27, 3)
        tpos = tcells_pos[cb][:, :, None, :]  # (C, t_cap, 1, 3)
        acc = tcells_pos.new_zeros((tpos.shape[0], t_cap, 3))
        for o in range(27):
            spos = (cells_pos[ids[:, o]] + shift[:, o, None, :])[:, None]
            sgm = cells_gm[ids[:, o]][:, None]  # (C, 1, cap)
            acc = acc + _tile_rows(tpos, spos, sgm, params, kind="newton",
                                   cutoff=cutoff, eps=eps, use_rcut=True)
        out.append(acc)
    return torch.cat(out)


def pair_cells_slab_plain(tcells_pos, t_count, ext_pos, ext_gm, sx: int,
                          side: int, params, *, cutoff: float, eps: float,
                          kind: str = "newton", box: float = 0.0,
                          absolute: bool = False):
    """The 27-neighbourhood pair-tile sum over one slab, (sx side^2, t_cap,
    3), in plain PyTorch: the JAX package's ``_jnp_pair_cells_slab``
    (``pallas_nlist.py:623``) and the plain version of
    :func:`pair_cells_slab_kernel`, with the truncation mask of ``kind``.
    Targets tcells_pos (sx side^2, t_cap, 3) with t_count (sx side^2,);
    sources ext_pos ((sx + 2) side^2, cap, 3) and ext_gm, G*m zero on
    padded slots, over the extended grid whose planes 0 and sx + 1 are the
    neighbours' halo. Target cell x reads source plane x + 1 + dx; y and z
    out of the grid weigh zero (isolated) or wrap with the +-box image
    shift (``box`` > 0; the x image arrives in the halo). Whole x-planes go
    at once as :func:`pair_cells_periodic`'s, with no host read, each tile
    row summed apart and added offset by offset as :func:`pair_cells_plain`
    does; target slots past a cell's count are zero. ``absolute`` as
    :func:`pair_cells_plain`'s: the row's sum of |terms|."""
    t_cap, cap = tcells_pos.shape[1], ext_pos.shape[1]
    device, dtype = tcells_pos.device, tcells_pos.dtype
    plane = side * side
    coords = _all_coords(side, device, sx)
    offsets = _offsets(device)
    planes = max(1, PLAIN_BATCH_SLOTS // (plane * t_cap * cap))
    out = []
    for x0 in range(0, sx, planes):
        cb = slice(x0 * plane, min(sx, x0 + planes) * plane)
        ids, inside, shift = _slab_neighbors(coords[cb], side, offsets, box,
                                             dtype)  # (C, 27)
        tpos = tcells_pos[cb][:, :, None, :]  # (C, t_cap, 1, 3)
        acc = tcells_pos.new_zeros((tpos.shape[0], t_cap, 3))
        for o in range(27):
            spos, sgm = ext_pos[ids[:, o]], ext_gm[ids[:, o]]
            if box > 0.0:
                spos = spos + shift[:, o, None, :]
            else:
                sgm = torch.where(inside[:, o, None], sgm, 0.0)
            acc = acc + _tile_rows(tpos, spos[:, None], sgm[:, None], params,
                                   kind=kind, cutoff=cutoff, eps=eps,
                                   use_rcut=True, absolute=absolute)
        out.append(acc)
    out = torch.cat(out) if out else torch.zeros_like(tcells_pos)
    real = torch.arange(t_cap, device=device)[None, :] < t_count[:, None]
    return torch.where(real[..., None], out, 0.0)


def pair_cells_plain_batched(tcells_pos, t_count, cells_pos, cells_gm,
                             s_count, side: int, params, *, cutoff: float,
                             eps: float):
    """The plain version of :func:`pair_cells_kernel_batched`:
    :func:`pair_cells_plain` slot by slot (``newton`` with the rcut mask),
    slot b with its own rcut_eff^2 ``params[b]``."""
    return torch.stack([
        pair_cells_plain(tcells_pos[b], t_count[b], cells_pos[b],
                         cells_gm[b], s_count[b], side, params[b:b + 1],
                         cutoff=cutoff, eps=eps)
        for b in range(tcells_pos.shape[0])
    ]) if tcells_pos.shape[0] else torch.empty_like(tcells_pos)


_ENTRY = {torch.float32: "nlist_pair_f32", torch.float64: "nlist_pair_f64",
          torch.bfloat16: "nlist_pair_bf16"}
# The batched entries: a slot count after the solo entry's arguments.
_BATCHED = {dtype: name.replace("nlist_pair_", "nlist_pair_batched_")
            for dtype, name in _ENTRY.items()}
# The slab entries: the slab's x-plane count after the solo arguments.
_SLAB = {dtype: name.replace("nlist_pair_", "nlist_pair_slab_")
         for dtype, name in _ENTRY.items()}
# The most slots a batched launch takes (the grid's slot axis).
MAX_SLOTS = 65_535
# The kernel's pair-kind codes (csrc/nlist_pair.cu) and the params each
# kind reads.
_KIND_CODE = {"newton": 0, "ewald": 1}
_N_PARAMS = {"newton": 1, "ewald": 2}
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P, ctypes.c_double, ctypes.c_double, ctypes.c_int,
             ctypes.c_int, _P, _P]
LIBRARY = cuda_build.CudaLibrary("nlist_pair", {
    **{name: (_ARGTYPES, ctypes.c_int) for name in _ENTRY.values()},
    **{name: (_ARGTYPES + [ctypes.c_int], ctypes.c_int)
       for name in (*_BATCHED.values(), *_SLAB.values())},
})

# Kernel launches so far, per pair kind, and apart for the untruncated
# newton form (``near``, the octree's near field), for the bf16 form
# (``newton_bf16``, ``near_bf16``) and for the batched launches of the
# serve engine (``newton/batched``, ``newton_bf16/batched``: one a batched
# evaluation, whatever its slot count) and for the slab launches of the
# halo engine (``newton/slab``, ``ewald/slab``, ``newton_bf16/slab``); a
# run reads its form's count to show its path went through the kernel.
# Incremented only where the kernel is launched.
LAUNCHES = {kind: 0 for kind in (*KINDS, "near", "newton_bf16",
                                 "near_bf16", "newton/batched",
                                 "newton_bf16/batched", "newton/slab",
                                 "ewald/slab", "newton_bf16/slab")}


def launch_key(kind: str, use_rcut: bool,
               dtype: torch.dtype = torch.float32) -> str:
    """The :data:`LAUNCHES` key of a launch of ``kind`` on ``dtype``."""
    key = "near" if kind == "newton" and not use_rcut else kind
    return f"{key}_bf16" if dtype == torch.bfloat16 else key


def _check(tcells_pos, t_count, cells_pos, cells_gm, s_count, side, params,
           kind, batch=(), slab: int = 0):
    """The launch's checks; ``batch`` is ``(B,)`` for a batched launch,
    whose params hold one value a slot; ``slab`` > 0 the x-planes of a
    slab launch's targets (its sources span slab + 2)."""
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown nlist pair kind {kind!r}; choose from "
                         f"{KINDS}")
    device, dtype = tcells_pos.device, tcells_pos.dtype
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    if dtype not in _ENTRY:
        raise TypeError("the CUDA kernel takes float32, float64 or bfloat16, "
                        f"not {dtype}")
    t_cells = (slab or side) * side * side
    s_cells = (slab + 2) * side * side if slab else t_cells
    if tcells_pos.dim() != len(batch) + 3 or cells_pos.dim() != len(batch) + 3:
        raise ValueError(
            f"tcells_pos {tuple(tcells_pos.shape)} and cells_pos "
            f"{tuple(cells_pos.shape)} must be {batch} + (cells, slots, 3)")
    t_cap, cap = tcells_pos.shape[-2], cells_pos.shape[-2]
    shapes = (
        ("tcells_pos", tcells_pos, (*batch, t_cells, t_cap, 3), dtype),
        ("t_count", t_count, (*batch, t_cells), torch.int64),
        ("cells_pos", cells_pos, (*batch, s_cells, cap, 3), dtype),
        ("cells_gm", cells_gm, (*batch, s_cells, cap), dtype),
        ("s_count", s_count, (*batch, s_cells), torch.int64),
    )
    for name, t, shape, want in shapes:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, tcells_pos on {device}")
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, not {want}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_params = _N_PARAMS[kind] * (batch[0] if batch else 1)
    if (params.device != device or params.dtype != dtype
            or params.numel() < n_params
            or not params.is_contiguous()):
        raise ValueError(
            "params must hold rcut_eff^2 (newton; one a slot in a batched "
            "launch) or [rcut^2, alpha] (ewald) as a contiguous tensor of "
            "the positions' dtype on their device")


def pair_cost_estimate(n_cells: int, t_cap: int, cap: int,
                       batch: int = 1) -> tuple:
    """(flops, bytes_accessed, transcendentals) of one pair-tile launch:
    the TPU kernel's ``pl.CostEstimate`` (``gravity_tpu/ops/
    pallas_nlist.py:400-405``: 21 flops and one rsqrt a slot pair of the
    (n_cells, 27) grid of (t_cap, cap) tiles, padding included) times the
    ``batch`` slots."""
    pairs = n_cells * 27 * t_cap * cap
    return (batch * 21 * pairs,
            batch * (n_cells * t_cap * 3 * 2 + n_cells * 27 * cap * 4) * 4,
            batch * pairs)


def _launch(entry: str, tcells_pos, t_count, cells_pos, cells_gm, s_count,
            side: int, params, *, cutoff: float, eps: float, use_rcut: bool,
            kind: str, extra: tuple = ()):
    """One launch of ``csrc/nlist_pair.cu``'s C function ``entry`` on the
    current stream, without synchronising, after the caller's checks;
    ``extra`` are the entry's arguments after the stream (a batched
    launch's slot count, a slab launch's x-planes). eps^2 and cutoff^2 are
    squared in double and then rounded to the element type (_newton_w)."""
    dtype, device = tcells_pos.dtype, tcells_pos.device
    out = torch.empty_like(tcells_pos)
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        status = getattr(lib, entry)(
            tcells_pos.data_ptr(), t_count.data_ptr(), cells_pos.data_ptr(),
            cells_gm.data_ptr(), s_count.data_ptr(), side,
            tcells_pos.shape[-2], cells_pos.shape[-2], params.data_ptr(),
            rounded(eps * eps, dtype), rounded(cutoff * cutoff, dtype),
            int(use_rcut), _KIND_CODE[kind], out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream, *extra,
        )
    LIBRARY.check(status)
    return out


def pair_cells_kernel(tcells_pos, t_count, cells_pos, cells_gm, s_count,
                      side: int, params, *, cutoff: float, eps: float,
                      use_rcut: bool = True, kind: str = "newton"):
    """The 27-neighborhood pair-tile sum: :func:`pair_cells_plain`'s
    contract (``s_count``, the sources of each cell, bounds the slots the
    kernel reads). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/nlist_pair.cu`` on the current stream, without
    synchronising, or raise. A bf16 launch takes the kernel's bf16 form.
    ``ewald`` at bf16 is refused on every device: it serves only P3M,
    which refuses a bf16 state as the JAX package's does (its mesh FFT
    takes float32 or float64 only, ``gravity_tpu/ops/pm.py:286``)."""
    if kind == "ewald" and tcells_pos.dtype == torch.bfloat16:
        raise ValueError(
            "the ewald pair kind takes float32 or float64: it serves only "
            "P3M, which refuses a bf16 state as the JAX package's does "
            "(jnp.fft.rfftn at gravity_tpu/ops/pm.py:286)")
    args = (tcells_pos, t_count, cells_pos, cells_gm, s_count, side, params)
    if all(t.device.type == "cpu" for t in args if isinstance(t, torch.Tensor)):
        return pair_cells_plain(*args, cutoff=cutoff, eps=eps,
                                use_rcut=use_rcut, kind=kind)
    require_no_grad(
        f"nlist_pair/{launch_key(kind, use_rcut, tcells_pos.dtype)}",
        tcells_pos, cells_pos, cells_gm, params)
    _check(*args, kind)
    dtype = tcells_pos.dtype
    out = _launch(_ENTRY[dtype], *args, cutoff=cutoff, eps=eps,
                  use_rcut=use_rcut, kind=kind)
    LAUNCHES[launch_key(kind, use_rcut, dtype)] += 1
    count_launch(*pair_cost_estimate(side**3, tcells_pos.shape[1],
                                     cells_pos.shape[1]))
    return out


def pair_cells_kernel_batched(tcells_pos, t_count, cells_pos, cells_gm,
                              s_count, side: int, params, *, cutoff: float,
                              eps: float):
    """B independent 27-neighborhood pair-tile sums, the ``newton`` kind
    with the rcut mask (the serve engine's batched cell list):
    tcells_pos (B, side^3, t_cap, 3), t_count and s_count (B, side^3),
    cells_pos (B, side^3, cap, 3), cells_gm (B, side^3, cap) and params
    (B,), one rcut_eff^2 a slot (each slot has its own bounding cube) ->
    (B, side^3, t_cap, 3). Slot b's result has the bits of
    :func:`pair_cells_kernel` on slot b's arrays.

    CPU tensors take the plain version (:func:`pair_cells_plain_batched`);
    CUDA tensors launch ``csrc/nlist_pair.cu``'s batched entry once (the
    slot a grid axis) on the current stream, without synchronising, or
    raise. Counted under ``LAUNCHES["newton/batched"]`` (bf16:
    ``"newton_bf16/batched"``), one a batched evaluation."""
    args = (tcells_pos, t_count, cells_pos, cells_gm, s_count, side, params)
    if all(t.device.type == "cpu" for t in args if isinstance(t, torch.Tensor)):
        return pair_cells_plain_batched(*args, cutoff=cutoff, eps=eps)
    require_no_grad("nlist_pair/batched", tcells_pos, cells_pos, cells_gm,
                    params)
    batch = tcells_pos.shape[0] if tcells_pos.dim() else 0
    _check(*args, "newton", (batch,))
    if batch > MAX_SLOTS:
        raise ValueError(f"a batched launch takes at most {MAX_SLOTS} "
                         f"slots, got {batch}")
    dtype = tcells_pos.dtype
    if batch == 0:
        return torch.empty_like(tcells_pos)
    out = _launch(_BATCHED[dtype], *args, cutoff=cutoff, eps=eps,
                  use_rcut=True, kind="newton", extra=(batch,))
    LAUNCHES[launch_key("newton", True, dtype) + "/batched"] += 1
    count_launch(*pair_cost_estimate(side**3, tcells_pos.shape[-2],
                                     cells_pos.shape[-2], batch))
    return out


def pair_cells_slab_kernel(tcells_pos, t_count, ext_pos, ext_gm, ext_count,
                           sx: int, side: int, params, *, cutoff: float,
                           eps: float, kind: str = "newton"):
    """The isolated slab pair tiles: :func:`pair_cells_slab_plain`'s
    contract (``box`` 0), with ``ext_count`` ((sx + 2) side^2,) the sources
    of each extended cell. CPU tensors take the plain version; CUDA tensors
    launch ``csrc/nlist_pair.cu``'s slab entry (the cubic kernel's code
    with target plane x reading source plane x + 1 + dx) on the current
    stream, without synchronising, or raise. Counted under
    ``LAUNCHES["newton/slab"]``, ``["ewald/slab"]`` and
    ``["newton_bf16/slab"]``. ``ewald`` at bf16 is refused on every device,
    as :func:`pair_cells_kernel` refuses it."""
    if kind == "ewald" and tcells_pos.dtype == torch.bfloat16:
        raise ValueError(
            "the ewald pair kind takes float32 or float64: it serves only "
            "P3M, which refuses a bf16 state as the JAX package's does "
            "(jnp.fft.rfftn at gravity_tpu/ops/pm.py:286)")
    args = (tcells_pos, t_count, ext_pos, ext_gm, ext_count)
    if all(t.device.type == "cpu" for t in (*args, params)):
        return pair_cells_slab_plain(tcells_pos, t_count, ext_pos, ext_gm,
                                     sx, side, params, cutoff=cutoff,
                                     eps=eps, kind=kind)
    require_no_grad(
        f"nlist_pair/{launch_key(kind, True, tcells_pos.dtype)}/slab",
        tcells_pos, ext_pos, ext_gm, params)
    if sx < 1:
        raise ValueError(f"a slab launch needs sx >= 1 planes, got {sx}")
    _check(*args, side, params, kind, slab=sx)
    dtype = tcells_pos.dtype
    out = _launch(_SLAB[dtype], *args, side, params, cutoff=cutoff, eps=eps,
                  use_rcut=True, kind=kind, extra=(sx,))
    LAUNCHES[launch_key(kind, True, dtype) + "/slab"] += 1
    count_launch(*pair_cost_estimate(sx * side * side, tcells_pos.shape[1],
                                     ext_pos.shape[1]))
    return out


def real_pairs(t_count, s_count, side: int, t_cap: int, cap: int) -> int:
    """Pairs the kernel evaluates for these cell counts: over every cell
    and each of its in-grid neighbors, min(targets, t_cap) x min(sources,
    cap). Reads the counts on the host."""
    ids, inside = _neighbors(_all_coords(side, t_count.device), side)
    src = torch.where(inside, s_count.clamp_max(cap)[ids], 0).sum(dim=1)
    return int((t_count.clamp_max(t_cap) * src).sum())


# ---------------------------------------------------------------------------
# The P3M near field
# ---------------------------------------------------------------------------


def nlist_short_range_cells(tcells_pos, t_cap, cells_pos, cells_mass,
                            cell_count, cmass_hat, ccom, m_scale, span,
                            side: int, cap: int, g: float, cutoff: float,
                            eps: float, alpha, rcut, dtype=None, *,
                            t_count):
    """The P3M short-range pass through the cell list (``ops/p3m.py``,
    ``short_mode="nlist"``): the erfc pair tiles through
    :func:`pair_cells_kernel`'s ``ewald`` kind plus the beyond-cap source
    remainder as cell-size-softened monopoles, (side^3, t_cap, 3) in
    (cell, slot) layout. The JAX function's arguments, plus ``t_count``
    (side^3,), the targets of each cell, which the kernel needs to skip
    padded target slots (they come out zero). ``alpha`` and ``rcut`` are
    device scalars that follow the bounding cube; ``t_cap`` and ``dtype``
    ride the tensors' shapes and dtype."""
    del t_cap, dtype
    gm = g * cells_mass
    params = torch.stack([rcut * rcut, alpha])
    with record_function("p3m.near_tiles"):
        acc = pair_cells_kernel(
            tcells_pos, t_count, cells_pos, gm, cell_count, side, params,
            cutoff=cutoff, eps=eps, use_rcut=True, kind="ewald",
        )
    with record_function("p3m.remainder"):
        rem_w, rem_com, over = _source_overflow_channels(
            cells_pos, cells_mass, cell_count, cmass_hat, ccom, m_scale, g,
            cap,
        )
        acc = acc + _remainder_cells(
            tcells_pos, rem_w, rem_com, over, side, params, kind="ewald",
            eps=eps, cell_h=span / side,
        )
    return acc


# ---------------------------------------------------------------------------
# The octree's near field
# ---------------------------------------------------------------------------


def nlist_near_field(targets, t_coords, cells_pos, cells_mass, cell_count,
                     cmass, ccom, m_scale, span, side: int, cap: int,
                     g: float, cutoff: float, eps: float, *, t_cap: int = 0):
    """The octree's near field (``--tree-near nlist``): the exact
    27-neighbourhood pair sum over the tree's (side^3, cap) leaf blocks as
    cell tiles, through :func:`pair_cells_kernel`'s ``newton`` kind with no
    truncation radius (the far field covers everything beyond the
    neighbourhood). The gather near field's overflow contracts: a leaf's
    sources beyond ``cap`` as a leaf-softened monopole, targets beyond
    ``t_cap`` (0: ``cap``) through the whole-cell fallback.
    ``cmass``/``ccom`` are the leaf level's totals (raw mass). Returns
    per-target accelerations (M, 3) in the caller's target order."""
    kt = targets.shape[0]
    t_cap = t_cap or cap
    cell_h = span / side
    params = targets.new_zeros(1)  # the untruncated form reads none
    with record_function("tree.bin_targets"):
        tcells_pos, _, t_count, t_start, t_sort, t_sorted_ids = bin_to_cells(
            targets, torch.ones_like(targets[:, 0]), t_coords, side, t_cap)
    with record_function("tree.near_tiles"):
        acc_cell = pair_cells_kernel(
            tcells_pos, t_count, cells_pos, g * cells_mass, cell_count, side,
            params, cutoff=cutoff, eps=eps, use_rcut=False, kind="newton",
        )
    with record_function("tree.remainder"):
        rem_w, rem_com, over = _source_overflow_channels(
            cells_pos, cells_mass, cell_count, cmass / m_scale, ccom,
            m_scale, g, cap,
        )
        acc_cell = acc_cell + _remainder_cells(
            tcells_pos, rem_w, rem_com, over, side, params, kind="newton",
            eps=eps, cell_h=cell_h,
        )
    # Targets past t_cap take the whole-cell monopole fallback, computed
    # for all and selected.
    with record_function("tree.overflow_targets"):
        slot = torch.arange(kt, device=targets.device) - t_start[t_sorted_ids]
        over_t = slot >= t_cap
        acc_sorted = acc_cell[t_sorted_ids, slot.clamp_max(t_cap - 1)]
        fallback = _overflow_targets(
            targets[t_sort], t_coords[t_sort], g * cmass, ccom, side, params,
            kind="newton", eps=eps, cell_h=cell_h,
        )
        acc_sorted = torch.where(over_t[:, None], fallback, acc_sorted)
        acc = torch.empty_like(acc_sorted)
        acc[t_sort] = acc_sorted
    return acc


# ---------------------------------------------------------------------------
# The standalone cutoff-dynamics backend
# ---------------------------------------------------------------------------


def source_cells(positions, masses, *, rcut: float, side: int, cap: int,
                 box: float = 0.0):
    """The sources' cell list for one force evaluation: (origin, span,
    params, coords, binned), where params[0] = rcut_eff^2 with the
    effective radius min(rcut, cell edge) (the 27-neighborhood covers
    one cell edge only), a device scalar, and ``binned`` is
    :func:`cells.bin_to_cells`'s tuple. The grid spans the bounding cube,
    or with ``box`` > 0 the box from the origin (the caller wraps the
    positions into it)."""
    if box > 0.0:
        origin = positions.new_zeros(3)
        span = positions.new_full((), box)
    else:
        origin, span = bounding_cube(positions)
    rcut_eff = torch.clamp_max(span / side, rcut)
    params = (rcut_eff * rcut_eff).reshape(1)
    coords = grid_coords(positions, origin, span, side)
    binned = bin_to_cells(positions, masses, coords, side, cap)
    return origin, span, params, coords, binned


def nlist_accelerations_vs(
    targets: torch.Tensor,
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    rcut: float,
    side: int,
    cap: int = DEFAULT_CAP,
    t_cap: int = 0,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    box: float = 0.0,
    _self: bool = False,
) -> torch.Tensor:
    """Truncated softened-Newtonian accelerations at ``targets`` from
    sources (positions, masses): the exact pair sum over all pairs with
    r <= min(rcut, cell edge), zero beyond. ``side``/``cap`` are the
    static cell-list sizing (:func:`resolve_nlist_sizing`), ``t_cap``
    the target slots per cell (0: ``cap``). ``box`` > 0 evaluates on the
    periodic unit cell with minimum-image wrapping, in plain PyTorch on
    every device (:func:`pair_cells_periodic`); it needs side >= 3.
    Overflow degradations per the module docstring."""
    if box > 0.0:
        if side < 3:
            raise ValueError(
                f"periodic nlist needs side >= 3 (box/rcut >= 3); got "
                f"side={side}"
            )
        # jnp.mod is torch.remainder (never fmod): results in [0, box).
        span_b = rounded(box, positions.dtype)
        positions = torch.remainder(positions, span_b)
        targets = torch.remainder(targets, span_b)
    t_cap = t_cap or cap
    kt = targets.shape[0]
    # Profiler ranges name the stages (chip_smoke.py reads them); they
    # cost nothing measurable when no profiler runs.
    with record_function("nlist.bin"):
        origin, span, params, coords, binned = source_cells(
            positions, masses, rcut=rcut, side=side, cap=cap, box=box)
        cell_h = span / side
        (cells_pos, cells_mass, cell_count, cell_start, src_sort,
         src_sorted_ids) = binned
        cells_gm = cells_mass * g

        m_scale, cmass_hat, ccom = cell_totals(
            positions, masses, src_sort, src_sorted_ids, cell_count)

        t_coords = grid_coords(targets, origin, span, side)
        if _self and t_cap == cap:
            # Self form: the target binning is the source binning.
            tcells_pos, t_count, t_start, t_sort, t_sorted_ids = (
                cells_pos, cell_count, cell_start, src_sort, src_sorted_ids
            )
        else:
            tcells_pos, _, t_count, t_start, t_sort, t_sorted_ids = (
                bin_to_cells(targets, torch.ones_like(targets[:, 0]),
                             t_coords, side, t_cap)
            )

    with record_function("nlist.pair_tiles"):
        if box > 0.0:
            acc_cell = pair_cells_periodic(
                tcells_pos, cells_pos, cells_gm, side, params, box=box,
                cutoff=cutoff, eps=eps)
        else:
            acc_cell = pair_cells_kernel(
                tcells_pos, t_count, cells_pos, cells_gm, cell_count, side,
                params, cutoff=cutoff, eps=eps, use_rcut=True, kind="newton",
            )
    with record_function("nlist.remainder"):
        rem_w, rem_com, over = _source_overflow_channels(
            cells_pos, cells_mass, cell_count, cmass_hat, ccom, m_scale, g,
            cap,
        )
        acc_cell = acc_cell + _remainder_cells(
            tcells_pos, rem_w, rem_com, over, side, params, kind="newton",
            eps=eps, cell_h=cell_h, box=box,
        )

    # Un-bin to per-target order; targets past t_cap take the whole-cell
    # monopole fallback, computed for all and selected.
    with record_function("nlist.unbin_and_overflow_targets"):
        slot = (torch.arange(kt, device=targets.device)
                - t_start[t_sorted_ids])
        over_t = slot >= t_cap
        acc_sorted = acc_cell[t_sorted_ids, slot.clamp_max(t_cap - 1)]
        fallback = _overflow_targets(
            targets[t_sort], t_coords[t_sort], g * cmass_hat * m_scale,
            ccom, side, params, kind="newton", eps=eps, cell_h=cell_h,
            box=box,
        )
        acc_sorted = torch.where(over_t[:, None], fallback, acc_sorted)
        acc = torch.empty_like(acc_sorted)
        acc[t_sort] = acc_sorted
    return acc


def nlist_accelerations(positions, masses, **kwargs) -> torch.Tensor:
    """Cutoff-truncated accelerations for all particles (targets =
    sources)."""
    return nlist_accelerations_vs(positions, positions, masses, _self=True,
                                  **kwargs)


def make_nlist_local_kernel(*, rcut: float, side: int, cap: int = DEFAULT_CAP,
                            t_cap: int = 0, g: float = G,
                            cutoff: float = CUTOFF_RADIUS, eps: float = 0.0,
                            box: float = 0.0):
    """A (targets, sources, masses) -> accelerations closure; its
    ``sizing`` attribute is the as-run (side, cap, t_cap). ``t_cap`` below
    ``cap`` bins the targets (a multirate fast rung) into fewer slots a
    cell than the sources. Differentiable: isolated (``box`` 0), through
    the rcut-masked dense backward (:class:`~.forces.DenseVJP` with
    ``rcut``, as the JAX package wraps its Pallas engine; the forward
    launches ``nlist_pair.cu`` on the card); periodic, by PyTorch's own
    differentiation of the plain form."""

    def forward(pos_i, pos_j, masses_j):
        return nlist_accelerations_vs(
            pos_i, pos_j, masses_j, rcut=rcut, side=side, cap=cap,
            t_cap=t_cap, g=g, cutoff=cutoff, eps=eps, box=box,
        )

    kernel = forward if box > 0.0 else wrap_with_dense_vjp(
        forward, g=g, cutoff=cutoff, eps=eps, rcut=rcut)
    kernel.sizing = (side, cap, t_cap or cap)
    return kernel


# ---------------------------------------------------------------------------
# The serve engine's batched cell list
# ---------------------------------------------------------------------------


def source_cells_batched(positions, masses, *, rcut: float, side: int,
                         cap: int):
    """:func:`source_cells` over a batch, positions (B, n, 3) and masses
    (B, n): (origin (B, 3), span (B,), params (B,), coords (B, n, 3),
    binned), each slot over its own bounding cube with its own rcut_eff^2,
    ``binned`` :func:`cells.bin_to_cells_batched`'s tuple. Slot b's
    values are its solo call's bits."""
    origin, span = bounding_cube(positions)
    rcut_eff = torch.clamp_max(span / side, rcut)
    params = rcut_eff * rcut_eff
    coords = grid_coords(positions, origin, span, side)
    binned = bin_to_cells_batched(positions, masses, coords, side, cap)
    return origin, span, params, coords, binned


def nlist_accelerations_vs_batched(
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    rcut: float,
    side: int,
    cap: int = DEFAULT_CAP,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
) -> torch.Tensor:
    """:func:`nlist_accelerations` over a batch of B independent systems
    (the serve engine's slots, the counterpart of the JAX engine's ``vmap``
    of ``nlist_accelerations_vs``): positions (B, n, 3), masses (B, n) ->
    (B, n, 3), slot b's result the bits of the solo call on slot b's
    arrays.

    Each slot takes its own bounding cube, effective radius (params (B,))
    and mass scale; one sort bins the whole batch
    (:func:`cells.bin_to_cells_batched`), the cell totals are one sum over
    the flattened ids, the pair tiles ONE launch of
    :func:`pair_cells_kernel_batched`, and the overflow channels and the
    un-binning run over the batch at once. The overflow-target fallback is
    computed for every target and selected: nothing reads the device on
    the host. An empty slot (all zeros) spans the 1e-30 floor, holds every
    body in one cell and stays finite."""
    b, n = positions.shape[:2]
    n_cells = side**3
    with record_function("nlist.bin"):
        _, span, params, coords, binned = source_cells_batched(
            positions, masses, rcut=rcut, side=side, cap=cap)
        cell_h = span / side
        cells_pos, cells_mass, count, start, sort, sorted_ids = binned
        cells_gm = cells_mass * g
        m_scale, cmass_hat, ccom = cell_totals(
            positions, masses, sort, sorted_ids, count)
    with record_function("nlist.pair_tiles"):
        acc_cell = pair_cells_kernel_batched(
            cells_pos, count, cells_pos, cells_gm, count, side, params,
            cutoff=cutoff, eps=eps)
    with record_function("nlist.remainder"):
        rem_w, rem_com, over = _source_overflow_channels(
            cells_pos, cells_mass, count, cmass_hat, ccom, m_scale, g, cap)
        acc_cell = acc_cell + _remainder_cells(
            cells_pos, rem_w, rem_com, over, side, params, kind="newton",
            eps=eps, cell_h=cell_h)
    with record_function("nlist.unbin_and_overflow_targets"):
        flat_pos = positions.reshape(b * n, 3)
        rank = (torch.arange(b * n, device=positions.device)
                - start[sorted_ids])
        over_t = rank >= cap
        acc_sorted = acc_cell.reshape(b * n_cells, cap, 3)[
            sorted_ids, rank.clamp_max(cap - 1)]
        fallback = _overflow_targets(
            flat_pos[sort], coords.reshape(b * n, 3)[sort],
            (g * cmass_hat * m_scale[:, None]).reshape(-1),
            ccom.reshape(-1, 3), side, params, kind="newton", eps=eps,
            cell_h=cell_h, slot=sorted_ids // n_cells,
            per_offset_bytes=n * 3 * positions.element_size())
        acc_sorted = torch.where(over_t[:, None], fallback, acc_sorted)
        acc = torch.empty_like(acc_sorted)
        acc[sort] = acc_sorted
    return acc.reshape(b, n, 3)


def make_nlist_batched_kernel(*, rcut: float, side: int,
                              cap: int = DEFAULT_CAP, g: float = G,
                              cutoff: float = CUTOFF_RADIUS,
                              eps: float = 0.0):
    """The serve engine's batched force of an ``nlist`` key: a
    ``(pos_i, pos_j, masses_j) -> acc`` closure over (B, n, 3) and (B, n)
    for the self form the engine evaluates (``pos_i is pos_j``), through
    :func:`nlist_accelerations_vs_batched`; ``sizing`` is (side, cap,
    cap). Differentiable through the rcut-masked dense backward, slot by
    slot (a served ``fit`` of an nlist key)."""

    def forward(pos_i, pos_j, masses_j):
        if pos_i is not pos_j:
            raise ValueError("the batched cell list evaluates the self form "
                             "(targets = sources) only")
        return nlist_accelerations_vs_batched(
            pos_j, masses_j, rcut=rcut, side=side, cap=cap, g=g,
            cutoff=cutoff, eps=eps)

    kernel = wrap_with_dense_vjp(forward, g=g, cutoff=cutoff, eps=eps,
                                 rcut=rcut)
    kernel.sizing = (side, cap, cap)
    return kernel
