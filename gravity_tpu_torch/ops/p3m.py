"""P3M (particle-particle particle-mesh) gravity, isolated boundaries.

Counterpart of ``gravity_tpu/ops/p3m.py``. The pair potential is split
with the Ewald kernel, -1/r = -erf(r/(sqrt(2) sigma))/r - erfc(r/(sqrt(2)
sigma))/r:

- **Mesh (long-range)**: CIC deposit of the sources on a grid over their
  bounding cube (``ops/pm.py``), three convolutions with the smoothed
  vector force kernel by FFT on the zero-padded (2M)^3 grid (``torch.fft``,
  as the JAX package leaves its FFTs to XLA), CIC gather at the targets.
- **Pair (short-range)**: the erfc remainder, an exact pair sum inside
  r_cut ~ 4 sigma over a static cell list whose cells are at least r_cut
  wide. ``short_mode="nlist"`` takes the cell-list tile engine
  (``ops/nlist.py::nlist_short_range_cells``: the ``ewald`` kind of the
  hand-written CUDA kernel ``csrc/nlist_pair.cu`` on the card, its plain
  version on the CPU); ``"gather"`` takes per-target gathers of the 27
  neighbor cells' slot blocks in plain PyTorch. Sources beyond a cell's
  ``cap`` and targets beyond ``t_cap`` degrade to cell-size-softened
  monopoles; no mass is dropped.

The eps softening lives entirely in the short-range term. Typical accuracy
at the defaults (sigma = 1.25 cells, r_cut = 4 sigma): ~1e-3..1e-2 median
relative force error on quasi-uniform states (the JAX package's figure);
thin geometries need a finer mesh (:func:`check_p3m_sizing`).

No step of a force evaluation waits for the device: r_cut, alpha and the
cell edge follow the bounding cube as device scalars (the kernel reads
them through a pointer), and the overflow fallbacks that the JAX package
gates with ``lax.cond`` are computed for every row and selected.

Not ported yet (ROADMAP Queue 1 item 7): ``short_mode="slice"`` (the
TPU's gather-free shifted-slice pass) and the chip A/B file
``P3M_SHORT_TPU.json`` that the JAX ``auto`` mode reads (a TPU
measurement). P3M is isolated-BC in both packages: a periodic run takes
``pm`` or ``nlist`` (``gravity_tpu/simulation.py:911-919``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from ..config import P3M_SHORT_MODES, NotPortedError
from ..constants import CUTOFF_RADIUS, G
from .cells import (
    bin_to_cells,
    bounding_cube,
    cell_ids,
    grid_coords,
    map_target_chunks,
    segment_sum,
)
from .nlist import (
    _eps_o2,
    _neighbors,
    _overflow_targets,
    _short_range_w,
    nlist_short_range_cells,
)
from .pm import cic_deposit, cic_gather

# Thin-geometry error model of the JAX package (its
# benchmarks/p3m_grid_sweep.py, a 1M disk on the CPU): the scaled-median
# error of a thin mass distribution is mesh-side and fits
#     THIN_ERR_COEFF * (aspect * grid) ** -THIN_ERR_POWER
# with aspect = thin-axis span / max-axis span over the 1-99 percentile
# box. An accuracy figure, independent of the device.
THIN_ERR_COEFF = 0.106
THIN_ERR_POWER = 0.607
# Only geometries thinner than this consult the fitted model.
THIN_ASPECT_MAX = 0.5
THIN_ERR_TARGET = 0.01
# From this n the thin-geometry remedy names the cell-list near field.
NLIST_NEAR_MIN_N = 32_768


def resolve_short_mode(short_mode: str, device) -> str:
    """Resolve ``"auto"`` to a concrete short-range mode for ``device``.

    The CPU takes ``"gather"``, as in the JAX package (its measured CPU
    winner). A CUDA device takes ``"nlist"``: the JAX rule gives an
    accelerator its gather-free pass, and here the gather-free pass is the
    hand-written cell-list kernel (``"slice"`` is not ported). Explicit
    modes are returned as given."""
    if short_mode not in P3M_SHORT_MODES:
        raise ValueError(f"unknown p3m short_mode {short_mode!r}; choose "
                         f"from {P3M_SHORT_MODES}")
    if short_mode != "auto":
        return short_mode
    return "nlist" if torch.device(device).type == "cuda" else "gather"


def nlist_near_eligible(n: int) -> bool:
    """Whether the cell-list near field (``--p3m-short nlist``) is the
    right remedy to name for this run size (see NLIST_NEAR_MIN_N)."""
    return n >= NLIST_NEAR_MIN_N


def thin_aspect(positions) -> float:
    """Thin-axis / max-axis span ratio of a particle distribution, over
    the per-axis 1-99 percentile box (a single escaper must not turn a
    disk into a cube). 1.0, never thin, when positions are missing,
    non-finite, fewer than 16, or not (N, 3)-shaped."""
    if positions is None:
        return 1.0
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().numpy()
    pos = np.asarray(positions, np.float64)
    if (pos.ndim != 2 or pos.shape[0] < 16
            or not np.all(np.isfinite(pos))):
        return 1.0
    spans = np.percentile(pos, 99, axis=0) - np.percentile(pos, 1, axis=0)
    hi = float(spans.max())
    if hi <= 0.0:
        return 1.0
    return float(max(spans.min() / hi, 1e-6))


def suggest_thin_grid(aspect: float) -> int:
    """The smallest multiple-of-32 grid whose fitted thin-geometry error
    is below :data:`THIN_ERR_TARGET` at ``aspect``."""
    cells = (THIN_ERR_COEFF / THIN_ERR_TARGET) ** (1.0 / THIN_ERR_POWER)
    return int(32 * math.ceil(cells / max(aspect, 1e-6) / 32.0))


def check_p3m_sizing(
    n: int, grid: int, sigma_cells: float, rcut_sigmas: float, cap: int,
    positions=None,
) -> str | None:
    """A warning string when the P3M configuration looks mis-sized: a cap
    below twice the mean cell occupancy (near pairs then take the
    overflow monopoles), or, given ``positions``, a grid too coarse for a
    thin geometry by the fitted error model. The JAX package's texts."""
    notes = []
    side = binning_side(grid, sigma_cells, rcut_sigmas)
    mean_occ = n / side**3
    if cap < 2.0 * mean_occ:
        notes.append(
            f"p3m cap={cap} is below 2x the mean cell occupancy "
            f"({mean_occ:.1f} at binning side {side}): dense cells will "
            "overflow to the monopole fallback on near pairs. Raise "
            "--p3m-cap or --pm-grid (finer mesh -> more, smaller cells)."
        )
    aspect = thin_aspect(positions)
    if aspect < THIN_ASPECT_MAX:
        est = THIN_ERR_COEFF * (aspect * grid) ** -THIN_ERR_POWER
        if est > THIN_ERR_TARGET:
            note = (
                f"p3m grid={grid} under-resolves this thin geometry "
                f"(aspect {aspect:.3f}: only {aspect * grid:.0f} cells "
                f"across the thin axis); the measured disk-sweep fit "
                f"predicts ~{est:.1%} scaled-median force error. Raise "
                f"--pm-grid to ~{suggest_thin_grid(aspect)} for <1% "
                "(raising --p3m-cap does not move this error — it is "
                "mesh-side; benchmarks/p3m_grid_sweep.py)."
            )
            if nlist_near_eligible(n):
                note += (
                    " At this n, pair it with the cell-list near "
                    "field (--p3m-short nlist, ops/pallas_nlist.py): "
                    "the near pass stays O(N) fixed-degree tiles at "
                    "the finer grid instead of inflating the chunked "
                    "gather pass."
                )
            notes.append(note)
    return " ".join(notes) if notes else None


def binning_side(grid: int, sigma_cells: float, rcut_sigmas: float) -> int:
    """Cell-list grid side so the cell edge is >= r_cut (both scale with
    the bounding cube, so this is static): (grid - 1) / (sigma_cells *
    rcut_sigmas), at least 2 (at side <= 2 every cell neighbors every
    other, so no short-range pair is dropped)."""
    return max(2, int((grid - 1) / (sigma_cells * rcut_sigmas)))


# ---------------------------------------------------------------------------
# The mesh part
# ---------------------------------------------------------------------------


def _kernel_body(m2: int, sigma_cells: float, device):
    """The Ewald force kernel and CIC deconvolution window on the padded
    (2M)^3 separation grid, in grid units (h = 1), float64: (k, w,
    (sx, sy, sz)). K_i(x) = -k(r) x_i with k(r) = erf(a r)/r^3 - (2a/
    sqrt(pi)) e^{-a^2 r^2}/r^2, a = 1/(sqrt(2) sigma), k(0) = 4 a^3 /
    (3 sqrt(pi)); w is the CIC window (sinc^2 per axis) applied twice,
    deposit and gather. The JAX package's ``_kernel_body``, step for
    step."""
    f64 = torch.float64
    idx = torch.arange(m2, device=device)
    sep = torch.where(idx < m2 // 2, idx, idx - m2).to(f64)
    sx = sep[:, None, None]
    sy = sep[None, :, None]
    sz = sep[None, None, :]
    r = torch.sqrt(sx * sx + sy * sy + sz * sz)
    a = 1.0 / (math.sqrt(2.0) * sigma_cells)
    u = a * r
    safe_r = torch.clamp_min(r, 1e-20)
    del r
    k = (
        torch.special.erf(u) / (safe_r * safe_r * safe_r)
        - (2.0 * a / math.sqrt(math.pi)) * torch.exp(-u * u)
        / (safe_r * safe_r)
    )
    k[0, 0, 0] = 4.0 * a**3 / (3.0 * math.sqrt(math.pi))
    fx = torch.fft.fftfreq(m2, dtype=f64, device=device)
    fz = torch.fft.rfftfreq(m2, dtype=f64, device=device)
    wx = torch.sinc(fx) ** 2
    wz = torch.sinc(fz) ** 2
    w = (wx[:, None, None] * wx[None, :, None] * wz[None, None, :]) ** 2
    return k, w, (sx, sy, sz)


def force_kernel_hat(m2: int, sigma_cells: float, dtype: torch.dtype,
                     device) -> tuple:
    """rfftn of the smoothed vector force kernel over the window, one
    complex tensor per axis, (m2, m2, m2 // 2 + 1) each. Built in float64
    on ``device`` and then rounded to complex64 (float32 states) or
    complex128, as the JAX package's numpy constants are. At grid 256 the
    three take 1.6 GB and the build peaks at several GB of float64
    temporaries, so a step loop builds it once and passes it as ``khat``
    (``Simulator``)."""
    k, w, seps = _kernel_body(m2, sigma_cells, device)
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    return tuple((torch.fft.rfftn(-k * s) / w).to(cdtype) for s in seps)


def _mesh_accelerations(targets, positions, masses, origin, span, *,
                        grid: int, g: float, sigma_cells: float,
                        khat=None):
    """Long-range accelerations at ``targets``: CIC deposit of the
    sources, three kernel convolutions (isolated boundaries by zero
    padding to (2 grid)^3: ``rfftn`` with ``s`` pads), CIC gather.
    ``khat`` is the kernel transform a step loop built once; None builds
    it for this call."""
    dtype, m = positions.dtype, grid
    m2 = 2 * m
    h = span / (m - 1)
    with record_function("p3m.deposit"):
        rho = cic_deposit(positions, masses, m, origin, h)
    with record_function("p3m.fft"):
        rho_hat = torch.fft.rfftn(rho, s=(m2, m2, m2))
        if khat is None:
            khat = force_kernel_hat(m2, sigma_cells, dtype, positions.device)
        scale = torch.tensor(g, dtype=dtype, device=positions.device) / (h * h)
        acc_field = torch.stack(
            [torch.fft.irfftn(rho_hat * kh, s=(m2, m2, m2))[:m, :m, :m]
             for kh in khat],
            dim=-1,
        ) * scale
    with record_function("p3m.mesh_gather"):
        return cic_gather(acc_field, targets, origin, h)


# ---------------------------------------------------------------------------
# The short-range part
# ---------------------------------------------------------------------------


def _gather_pass(targets, t_coords, cells_pos, cells_mass, cell_count,
                 cmass_hat, ccom, m_scale, span, *, side: int, cap: int,
                 chunk: int, g: float, cutoff: float, eps: float, alpha,
                 rcut):
    """``short_mode="gather"``: per-target gathers of the 27 neighbor
    cells' (cap, 3) slot blocks, in target chunks of ``chunk``. A cell
    over its cap adds its remainder as a cell-size-softened monopole; that
    channel is computed for every chunk (its terms are exact zeros off
    the overflow set), where the JAX package gates it with ``lax.cond``."""
    alpha3 = alpha * alpha * alpha
    rcut2 = rcut * rcut
    eps_o2 = _eps_o2(eps, span / side)
    slots = torch.arange(cap, device=targets.device)

    def chunk_short(pos_c, coords_c):
        c = pos_c.shape[0]
        nids, inside = _neighbors(coords_c, side)  # (C, 27)
        counts = torch.where(inside, cell_count[nids], 0)
        src_pos = cells_pos[nids]  # (C, 27, cap, 3)
        src_m = cells_mass[nids]  # (C, 27, cap)
        valid = slots < counts[..., None]
        diff = src_pos.reshape(c, -1, 3) - pos_c[:, None, :]
        r2 = (diff * diff).sum(dim=-1)
        ok = (valid.reshape(c, -1) & (r2 < rcut2)
              & (r2 + eps * eps > cutoff * cutoff) & (r2 > 0))
        w = _short_range_w(r2, alpha, eps * eps, alpha3)
        w = torch.where(ok, g * src_m.reshape(c, -1) * w, 0.0)
        acc_c = (w[..., None] * diff).sum(dim=1)

        over = counts > cap
        src_mhat = src_m / m_scale
        pref_mhat = torch.where(valid, src_mhat, 0.0).sum(dim=-1)
        pref_mw = torch.where(valid[..., None],
                              src_mhat[..., None] * src_pos, 0.0).sum(dim=-2)
        rem_mhat = torch.clamp_min(
            torch.where(over, cmass_hat[nids] - pref_mhat, 0.0), 0.0)
        tot_mw = ccom[nids] * cmass_hat[nids][..., None]
        rem_com = (tot_mw - pref_mw) / torch.clamp_min(rem_mhat,
                                                       1e-37)[..., None]
        diff_o = rem_com - pos_c[:, None, :]
        r2o = (diff_o * diff_o).sum(dim=-1)
        w_o = _short_range_w(r2o, alpha, eps_o2, alpha3)
        w_o = torch.where(over, g * rem_mhat * m_scale * w_o, 0.0)
        diff_o = torch.where(over[..., None], diff_o, 0.0)
        return acc_c + (w_o[..., None] * diff_o).sum(dim=1)

    return map_target_chunks(chunk_short, targets, t_coords, chunk)


def p3m_accelerations_vs(
    targets: torch.Tensor,
    positions: torch.Tensor,
    masses: torch.Tensor,
    *,
    grid: int = 128,
    sigma_cells: float = 1.25,
    rcut_sigmas: float = 4.0,
    cap: int = 128,
    chunk: int = 4096,
    g: float = G,
    cutoff: float = CUTOFF_RADIUS,
    eps: float = 0.0,
    khat=None,
    short_mode: str = "auto",
    t_cap: int = 0,
    _self: bool = False,
) -> torch.Tensor:
    """P3M accelerations at ``targets`` from sources (positions, masses),
    isolated boundaries. ``grid`` is the mesh per axis, ``sigma_cells``
    the Ewald split scale in mesh cells, ``rcut_sigmas`` the short-range
    truncation, ``cap`` the cell list's source slots per cell, ``t_cap``
    its target slots (0: ``cap``; ``nlist`` mode), ``chunk`` the target
    chunk of the ``gather`` mode, ``khat`` a prebuilt
    :func:`force_kernel_hat`. ``short_mode`` per :func:`resolve_short_mode`."""
    mode = resolve_short_mode(short_mode, positions.device)
    if mode == "slice":
        raise NotPortedError(
            "p3m short_mode='slice' (the TPU's gather-free shifted-slice "
            "pass) is not ported to gravity_tpu_torch yet (ROADMAP.md "
            "Queue 1 item 7); use 'nlist' (the cell-list kernel) or "
            "'gather'"
        )
    origin, span = bounding_cube(positions)
    h = span / (grid - 1)
    sigma = sigma_cells * h
    alpha = 1.0 / (math.sqrt(2.0) * sigma)
    rcut = rcut_sigmas * sigma

    acc = _mesh_accelerations(targets, positions, masses, origin, span,
                              grid=grid, g=g, sigma_cells=sigma_cells,
                              khat=khat)

    side = binning_side(grid, sigma_cells, rcut_sigmas)
    n_cells = side**3
    with record_function("p3m.bin"):
        coords = grid_coords(positions, origin, span, side)
        ids = cell_ids(coords, side)
        t_coords = grid_coords(targets, origin, span, side)
        (cells_pos, cells_mass, cell_count, cell_start, src_sort,
         src_sorted_ids) = bin_to_cells(positions, masses, coords, side, cap)
        # Per-cell mass and centre of mass for the overflow channels, in
        # normalized mass (m * x overflows fp32 at astronomical scales).
        m_scale = torch.clamp_min(masses.max(), 1e-37)
        m_hat = masses / m_scale
        cmass_hat = segment_sum(m_hat, ids, n_cells)
        cmw = segment_sum(m_hat[:, None] * positions, ids, n_cells)
        ccom = cmw / torch.clamp_min(cmass_hat, 1e-37)[:, None]

    if mode == "gather":
        with record_function("p3m.gather_pass"):
            short = _gather_pass(
                targets, t_coords, cells_pos, cells_mass, cell_count,
                cmass_hat, ccom, m_scale, span, side=side, cap=cap,
                chunk=chunk, g=g, cutoff=cutoff, eps=eps, alpha=alpha,
                rcut=rcut,
            )
        return acc + short

    t_cap = t_cap or cap
    kt = targets.shape[0]
    with record_function("p3m.bin"):
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
    near_cell = nlist_short_range_cells(
        tcells_pos, t_cap, cells_pos, cells_mass, cell_count, cmass_hat,
        ccom, m_scale, span, side, cap, g, cutoff, eps, alpha, rcut,
        t_count=t_count,
    )
    # Un-bin to target order; targets past t_cap take the whole-cell
    # monopole fallback, computed for all and selected.
    with record_function("p3m.overflow_targets"):
        slot = torch.arange(kt, device=targets.device) - t_start[t_sorted_ids]
        over_t = slot >= t_cap
        short_sorted = near_cell[t_sorted_ids, slot.clamp_max(t_cap - 1)]
        fallback = _overflow_targets(
            targets[t_sort], t_coords[t_sort], g * cmass_hat * m_scale, ccom,
            side, torch.stack([rcut * rcut, alpha]), kind="ewald", eps=eps,
            cell_h=span / side,
        )
        short_sorted = torch.where(over_t[:, None], fallback, short_sorted)
        short = torch.empty_like(short_sorted)
        short[t_sort] = short_sorted
    return acc + short


def p3m_accelerations(positions: torch.Tensor, masses: torch.Tensor,
                      **kwargs) -> torch.Tensor:
    """P3M accelerations for all particles (targets = sources)."""
    return p3m_accelerations_vs(positions, positions, masses, _self=True,
                                **kwargs)
