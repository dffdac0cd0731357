"""Conserved-quantity diagnostics of a state: energy, momentum, angular
momentum, centre of mass, and the structural checks of the equilibrium
models.

Counterpart of the state diagnostics of ``gravity_tpu/ops/diagnostics.py``
(the functions above its in-program conservation ledger, which is not
ported yet: ROADMAP Queue 1 item 3). The potential is the plain
``ops/forces.py::potential_energy``, streamed over target chunks. Every
function computes in the state's dtype on the state's device, with the
same normalized-mass forms that keep fp32 intermediates in range; those
documented to return host float64 values do so. For energies of a bf16
or fp32 state at fp64 accuracy, pass ``state.astype(torch.float64)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import CUTOFF_RADIUS, G
from ..state import ParticleState
from .forces import potential_energy


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
