"""Particle state: structure-of-arrays torch tensors.

Counterpart of ``gravity_tpu/state.py``. ``positions (N, 3)``,
``velocities (N, 3)`` and ``masses (N,)`` live in one frozen dataclass;
every method returns a new state and never writes into the old one.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state. All tensors share the leading particle axis N."""

    positions: torch.Tensor  # (N, 3)
    velocities: torch.Tensor  # (N, 3)
    masses: torch.Tensor  # (N,)

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.positions.dtype

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def astype(self, dtype: torch.dtype) -> "ParticleState":
        return ParticleState(
            positions=self.positions.to(dtype),
            velocities=self.velocities.to(dtype),
            masses=self.masses.to(dtype),
        )

    def to(self, device) -> "ParticleState":
        return ParticleState(
            positions=self.positions.to(device),
            velocities=self.velocities.to(device),
            masses=self.masses.to(device),
        )

    def replace(self, **kwargs) -> "ParticleState":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def create(positions, velocities, masses, dtype=None,
               device=None) -> "ParticleState":
        positions = torch.as_tensor(positions, dtype=dtype, device=device)
        velocities = torch.as_tensor(velocities, dtype=dtype, device=device)
        masses = torch.as_tensor(masses, dtype=dtype, device=device)
        if positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError(
                f"positions must be (N, 3), got {tuple(positions.shape)}"
            )
        if velocities.shape != positions.shape:
            raise ValueError(
                f"velocities {tuple(velocities.shape)} must match positions "
                f"{tuple(positions.shape)}"
            )
        if masses.shape != (positions.shape[0],):
            raise ValueError(f"masses must be (N,), got {tuple(masses.shape)}")
        return ParticleState(positions, velocities, masses)

    @staticmethod
    def concatenate(states: list["ParticleState"]) -> "ParticleState":
        return ParticleState(
            positions=torch.cat([s.positions for s in states], dim=0),
            velocities=torch.cat([s.velocities for s in states], dim=0),
            masses=torch.cat([s.masses for s in states], dim=0),
        )

    def pad_to(self, n_target: int) -> tuple["ParticleState", torch.Tensor]:
        """Pad with zero-mass particles at rest; returns (state, valid mask).

        Zero-mass padding exerts no force on real particles. Padded
        particles are parked AT particle 0's position, not far away, so
        that any geometry derived from source positions (bounding cube,
        cell list) is not inflated by the padding. Coincident zero-mass
        padding is safe for the direct sum: r = 0 falls below the
        close-approach cutoff, softened pairs are finite at r = 0, and
        zero mass nullifies the source side.
        """
        n = self.n
        if n_target < n:
            raise ValueError(f"cannot pad {n} particles down to {n_target}")
        if n_target == n:
            return self, torch.ones(n, dtype=torch.bool, device=self.device)
        pad = n_target - n
        pad_pos = self.positions[0].expand(pad, 3)
        zeros3 = torch.zeros(pad, 3, dtype=self.dtype, device=self.device)
        padded = ParticleState(
            positions=torch.cat([self.positions, pad_pos], dim=0),
            velocities=torch.cat([self.velocities, zeros3], dim=0),
            masses=torch.cat(
                [self.masses,
                 torch.zeros(pad, dtype=self.dtype, device=self.device)],
                dim=0,
            ),
        )
        mask = torch.cat([
            torch.ones(n, dtype=torch.bool, device=self.device),
            torch.zeros(pad, dtype=torch.bool, device=self.device),
        ])
        return padded, mask
