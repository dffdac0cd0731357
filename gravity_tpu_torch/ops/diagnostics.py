"""Conserved-quantity diagnostics of a state: energy, momentum, angular
momentum, centre of mass, and the structural checks of the equilibrium
models.

Counterpart of ``gravity_tpu/ops/diagnostics.py``: the state diagnostics
and the in-program conservation ledger (:func:`ledger_vec`,
:func:`pe_hat_dense`, :func:`ledger_host`, :func:`ledger_drift`). The
potential is the plain ``ops/forces.py::potential_energy``, streamed over
target chunks. Every
function computes in the state's dtype on the state's device, with the
same normalized-mass forms that keep fp32 intermediates in range; those
documented to return host float64 values do so. For energies of a bf16
or fp32 state at fp64 accuracy, pass ``state.astype(torch.float64)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import CUTOFF_RADIUS, G
from ..state import ParticleState
from .forces import potential_energy, rounded


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    v2 = (state.velocities * state.velocities).sum(dim=-1)
    return 0.5 * (state.masses * v2).sum()


def kinetic_energy_f64(state: ParticleState) -> float:
    """Kinetic energy as a host float64. The raw fp32 sum overflows at
    astronomical scales (m ~ 1e30 kg, v ~ 3e4 m/s, N ~ 1e6: KE ~ 1e45);
    normalized masses keep each term ~1e9, and m_scale is applied in
    float64 on the host."""
    m_scale = torch.clamp_min(state.masses.max(),
                              torch.finfo(state.masses.dtype).tiny)
    v2 = (state.velocities * state.velocities).sum(dim=-1)
    s = ((state.masses / m_scale) * v2).sum()
    return 0.5 * float(m_scale) * float(s)


def total_energy(state: ParticleState, *, g: float = G,
                 cutoff: float = CUTOFF_RADIUS, eps: float = 0.0,
                 external_phi=None) -> torch.Tensor:
    """Kinetic plus self-gravity potential energy; with ``external_phi``
    (``ops/external.py::parse_external(spec, kind="potential")``) also
    the external field's sum(m phi(x)), so that an ``--external`` run
    conserves what is reported."""
    e = kinetic_energy(state) + potential_energy(
        state.positions, state.masses, g=g, cutoff=cutoff, eps=eps)
    if external_phi is not None:
        e = e + (state.masses * external_phi(state.positions)).sum()
    return e


def total_momentum(state: ParticleState) -> torch.Tensor:
    return (state.masses[:, None] * state.velocities).sum(dim=0)


def total_angular_momentum(state: ParticleState) -> np.ndarray:
    """Total L = sum m (x cross v) as a host float64 (3,) array, from
    normalized mass weights (m |x| |v| reaches ~1e46 at astronomical
    scales, past fp32) rescaled by the mass sum in float64."""
    m_sum = state.masses.sum()
    w = state.masses / torch.clamp_min(m_sum,
                                       torch.finfo(state.masses.dtype).tiny)
    l_hat = (w[:, None] * torch.linalg.cross(state.positions,
                                             state.velocities)).sum(dim=0)
    return float(m_sum) * l_hat.double().cpu().numpy()


def center_of_mass(state: ParticleState) -> torch.Tensor:
    # Normalized weights: m x overflows fp32 at planetary masses and
    # astronomical coordinates; w <= 1 never does.
    w = state.masses / state.masses.sum()
    return (w[:, None] * state.positions).sum(dim=0)


def virial_ratio(state: ParticleState, *, g: float = G,
                 cutoff: float = CUTOFF_RADIUS,
                 eps: float = 0.0) -> torch.Tensor:
    """2T/|W|: 1 in virial equilibrium. With m_hat = m / m_scale,
    T = m_scale T_hat and W = m_scale^2 W_hat, so every intermediate
    fits fp32 even where the raw energies do not."""
    m_scale = state.masses.max()
    m_hat = state.masses / m_scale
    v2 = (state.velocities * state.velocities).sum(dim=-1)
    t_hat = 0.5 * (m_hat * v2).sum()
    w_hat = potential_energy(state.positions, m_hat, g=g, cutoff=cutoff,
                             eps=eps)
    return 2.0 * t_hat / (m_scale * w_hat.abs())


def lagrangian_radii(state: ParticleState,
                     fractions=(0.1, 0.5, 0.9)) -> torch.Tensor:
    """Radii about the centre of mass that enclose the given fractions
    of the mass (the 0.5 entry is the half-mass radius)."""
    com = center_of_mass(state)
    r = torch.linalg.norm(state.positions - com[None, :], dim=1)
    order = torch.argsort(r)
    cum = torch.cumsum(state.masses[order], dim=0)
    fracs = torch.tensor(fractions, dtype=r.dtype, device=r.device)
    idx = torch.searchsorted(cum, fracs * cum[-1])
    return r[order][idx.clamp(0, r.shape[0] - 1)]


def half_mass_radius(state: ParticleState) -> torch.Tensor:
    return lagrangian_radii(state, (0.5,))[0]


def velocity_dispersion(state: ParticleState) -> torch.Tensor:
    """Mass-weighted 1D velocity dispersion about the mean streaming
    velocity (normalized weights, as :func:`center_of_mass`)."""
    w = state.masses / state.masses.sum()
    vbar = (w[:, None] * state.velocities).sum(dim=0)
    dv = state.velocities - vbar[None, :]
    return torch.sqrt((w * (dv * dv).sum(dim=1)).sum() / 3.0)


def energy_drift(initial_energy, current_energy):
    """|dE / E0|: the standard symplectic-integrator quality metric."""
    return abs((current_energy - initial_energy) / initial_energy)


def radial_density_profile(state: ParticleState, bins: int = 32):
    """(r_mid, rho) mass-density profile in centre-of-mass-centric
    log-spaced shells spanning [r_min, r_max] of the state."""
    com = center_of_mass(state)
    r = torch.linalg.norm(state.positions - com[None, :], dim=1)
    r_pos = torch.clamp_min(r, 1e-300)
    lo = torch.log(r_pos.min() + 1e-300)
    hi = torch.log(r_pos.max() * 1.0001)
    edges = torch.exp(torch.linspace(0.0, 1.0, bins + 1, dtype=r.dtype,
                                     device=r.device) * (hi - lo) + lo)
    idx = torch.clamp(torch.searchsorted(edges, r_pos) - 1, 0, bins - 1)
    m_in = torch.zeros(bins, dtype=state.masses.dtype,
                       device=state.masses.device).index_add_(
        0, idx, state.masses)
    # Shell volumes in normalized radius (edges^3 overflows fp32 beyond
    # ~7e12 m); r_ref^3 is divided out one factor at a time.
    r_ref = edges[-1]
    e_hat = edges / r_ref
    vol_hat = (4.0 / 3.0) * math.pi * (e_hat[1:] ** 3 - e_hat[:-1] ** 3)
    rho = ((m_in / r_ref) / r_ref) / r_ref / vol_hat
    r_mid = torch.sqrt(edges[1:] * edges[:-1])
    return r_mid, rho


# --- the in-program conservation ledger ---
#
# What the run loop watches a block (energy, momentum, angular momentum,
# centre of mass) as device scalars in normalized-mass form, so that every
# intermediate stays in fp32 range, rescaled to float64 on the host when
# the block is consumed. The device half is a pure function of the state,
# so the run loop queues it right behind each block and reads it through
# that block's own completion fence.

# Largest N whose ledger energy term is the exact dense pair scan
# (pe_hat_dense); above it the Simulator takes the octree's scaled
# potential. Truncated (rcut) runs always take the pair scan: their
# shifted pair sum is the only honest energy.
LEDGER_DENSE_MAX = 16_384

LEDGER_VEC_FIELDS = (
    "m_scale", "m_sum_hat", "ke_hat",
    "px_hat", "py_hat", "pz_hat",
    "lx_hat", "ly_hat", "lz_hat",
    "comx", "comy", "comz",
    "r2_hat",
)


def mass_scale(masses: torch.Tensor) -> torch.Tensor:
    """max(masses), at least the dtype's tiny: the normalized-mass scale."""
    return torch.clamp_min(masses.max(), torch.finfo(masses.dtype).tiny)


def ledger_vec(positions: torch.Tensor, velocities: torch.Tensor,
               masses: torch.Tensor) -> torch.Tensor:
    """The O(N) conserved-quantity components of one state as a (13,)
    device vector (:data:`LEDGER_VEC_FIELDS`).

    Normalized masses (host rescale in :func:`ledger_host`): ``m_sum =
    m_scale m_sum_hat``, ``KE = m_scale ke_hat``, ``P = m_scale p_hat``,
    ``L = m_scale l_hat`` (about the origin); ``com`` is absolute and
    ``r2_hat`` is the mass-weighted mean squared radius about it.
    Zero-mass padding contributes nothing to any term."""
    tiny = torch.finfo(positions.dtype).tiny
    m_scale = mass_scale(masses)
    m_hat = masses / m_scale
    m_sum_hat = m_hat.sum()
    v2 = (velocities * velocities).sum(dim=-1)
    ke_hat = 0.5 * (m_hat * v2).sum()
    p_hat = (m_hat[:, None] * velocities).sum(dim=0)
    l_hat = (m_hat[:, None]
             * torch.linalg.cross(positions, velocities, dim=-1)).sum(dim=0)
    w = m_hat / torch.clamp_min(m_sum_hat, tiny)
    com = (w[:, None] * positions).sum(dim=0)
    d = positions - com[None, :]
    r2_hat = (w * (d * d).sum(dim=-1)).sum()
    return torch.stack([
        m_scale, m_sum_hat, ke_hat,
        p_hat[0], p_hat[1], p_hat[2],
        l_hat[0], l_hat[1], l_hat[2],
        com[0], com[1], com[2],
        r2_hat,
    ])


def _pe_rows_hat(pos_i, positions, m_hat, cutoff, eps, rcut, box=0.0):
    """Each target's dimensionless potential row sum_j m_hat_j k(r): k =
    1/r_soft, or with ``rcut`` > 0 the truncated family's shifted kernel
    1/r_soft - 1/rcut_soft for r <= rcut and 0 beyond (the potential whose
    negative gradient is the rcut-masked force). ``box`` > 0 takes
    minimum-image separations (the truncated family's periodic pair
    potential, valid for rcut < box/2)."""
    diff = positions[None, :, :] - pos_i[:, None, :]
    if box > 0.0:
        b = rounded(box, diff.dtype)
        diff = diff - b * torch.round(diff / b)
    r2 = (diff * diff).sum(dim=-1)
    r2_soft = r2 + eps * eps
    ok = r2_soft > cutoff * cutoff
    if rcut > 0.0:
        ok = ok & (r2 <= rcut * rcut)
    k = torch.rsqrt(torch.where(ok, r2_soft, torch.ones_like(r2_soft)))
    if rcut > 0.0:
        # A device fill, not a copy from the host (which would stall it).
        k = k - torch.rsqrt(k.new_full((), rcut * rcut + eps * eps))
    k = torch.where(ok, k, torch.zeros_like(k))
    return (m_hat[None, :] * k).sum(dim=1)


def pe_hat_dense(positions: torch.Tensor, masses: torch.Tensor, *,
                 cutoff: float = CUTOFF_RADIUS, eps: float = 0.0,
                 rcut: float = 0.0, box: float = 0.0,
                 chunk: int = 4096) -> torch.Tensor:
    """The dimensionless pair-potential double sum ``s_hat`` (a device
    scalar, O(N chunk) memory): ``PE = -0.5 g m_scale^2 s_hat`` with
    ``m_scale = max(masses)``, the ledger's dense energy term. The same
    conventions as ``ops/forces.py::potential_energy`` for rcut = 0;
    ``box`` > 0 takes minimum-image separations."""
    m_hat = masses / mass_scale(masses)
    rows = torch.cat([
        _pe_rows_hat(positions[lo:lo + chunk], positions, m_hat, cutoff,
                     eps, rcut, box)
        for lo in range(0, positions.shape[0], chunk)
    ])
    return (m_hat * rows).sum()


def _f64(x) -> np.float64:
    if isinstance(x, torch.Tensor):
        return np.float64(x.detach().double().cpu().item())
    return np.float64(np.asarray(x))


def ledger_host(vec, pe=None, pe_scale=None, *, g: float = G,
                pe_kind: str = "dense", ext=None) -> dict:
    """The float64 host ledger from its device components: ``vec`` from
    :func:`ledger_vec`, ``pe``/``pe_scale`` from the potential path.
    ``pe_kind``: ``dense``/``tree`` (PE = -0.5 g pe_scale^2 pe, pe_scale
    defaulting to the vec's m_scale), ``fmm`` (PE = -0.5 pe_scale pe: g
    and one mass power folded in, ``ops/fmm._fmm_pe_scaled``'s contract),
    ``pm`` (PE = pe_scale^2 pe: the periodic mesh core's mean-mass
    normalization, ``ops/periodic._potential_core``, 0.5 and g folded in),
    ``absolute`` (pe is the float64 potential energy) or ``none`` (no
    energy term: ``energy`` is None). ``ext`` is the
    normalized external-field energy sum(m_hat phi_ext), rescaled by the
    vec's m_scale: an ``--external`` run conserves KE + PE_self +
    PE_ext."""
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().double().cpu().numpy()
    v = {k: np.float64(x)
         for k, x in zip(LEDGER_VEC_FIELDS, np.asarray(vec, np.float64))}
    m_scale = v["m_scale"]
    out = {
        "m_sum": m_scale * v["m_sum_hat"],
        "kinetic": m_scale * v["ke_hat"],
        "momentum": m_scale * np.array(
            [v["px_hat"], v["py_hat"], v["pz_hat"]], np.float64),
        "ang_mom": m_scale * np.array(
            [v["lx_hat"], v["ly_hat"], v["lz_hat"]], np.float64),
        "com": np.array([v["comx"], v["comy"], v["comz"]], np.float64),
        "r_rms": np.sqrt(max(v["r2_hat"], 0.0)),
    }
    if pe is None or pe_kind == "none":
        out["potential"] = None
        out["energy"] = None
        return out
    pe64 = _f64(pe)
    scale = _f64(pe_scale) if pe_scale is not None else m_scale
    if pe_kind in ("dense", "tree"):
        potential = np.float64(-0.5 * g) * scale * scale * pe64
    elif pe_kind == "fmm":
        potential = np.float64(-0.5) * scale * pe64
    elif pe_kind == "pm":
        potential = scale * scale * pe64
    elif pe_kind == "absolute":
        potential = pe64
    else:
        raise ValueError(f"unknown pe_kind {pe_kind!r}")
    if ext is not None:
        potential = potential + m_scale * _f64(ext)
    out["potential"] = potential
    out["energy"] = out["kinetic"] + potential
    return out


def ledger_drift(l0: dict, l: dict, *, com_frame: bool = True) -> dict:
    """Relative drift of the conserved quantities between two host
    ledgers:

    - ``energy_drift``   = |E - E0| / |E0| (None when either E is None)
    - ``momentum_drift`` = |P - P0| / p_ref, p_ref = sqrt(2 KE0 m_sum) (or
      sqrt(2 |PE0| m_sum) for a cold start with KE0 = 0)
    - ``angmom_drift``   = |L - L0| / max(|L0|, p_ref r_rms0)
    - ``com_drift``      = |com - com0| / r_rms0 (None with
      ``com_frame=False``)
    """
    tiny = np.float64(1e-300)
    out: dict = {}
    if l0.get("energy") is not None and l.get("energy") is not None:
        out["energy_drift"] = float(
            abs(l["energy"] - l0["energy"]) / max(abs(l0["energy"]), tiny))
    else:
        out["energy_drift"] = None
    p_ref = np.sqrt(
        max(2.0 * max(l0["kinetic"], 0.0) * max(l0["m_sum"], 0.0), 0.0))
    if p_ref <= 0.0 and l0.get("potential") is not None:
        p_ref = np.sqrt(2.0 * abs(l0["potential"]) * max(l0["m_sum"], 0.0))
    out["momentum_drift"] = float(
        np.linalg.norm(l["momentum"] - l0["momentum"]) / max(p_ref, tiny))
    l_ref = max(float(np.linalg.norm(l0["ang_mom"])), p_ref * l0["r_rms"],
                tiny)
    out["angmom_drift"] = float(
        np.linalg.norm(l["ang_mom"] - l0["ang_mom"]) / l_ref)
    if com_frame:
        out["com_drift"] = float(
            np.linalg.norm(l["com"] - l0["com"]) / max(l0["r_rms"], tiny))
    else:
        out["com_drift"] = None
    return out
