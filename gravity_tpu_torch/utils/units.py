"""Unit systems: the galactic natural units and their SI converters.

Counterpart of ``gravity_tpu/utils/units.py``, the same constants bit for
bit. The reference works exclusively in SI (meters, kilograms, seconds, G =
6.674e-11) — fine for solar-system scales in float64, but galaxy-scale SI
numbers (masses ~1e41 kg) overflow float32 outright, and the card computes
in fp32/bf16. Galaxy model families therefore generate in **galactic natural
units** (the standard N-body practice the reference never needed):

    [L] = 1 kpc,  [M] = 1e10 Msun,  G = 1
    => [V] = sqrt(G_SI * M_unit / L_unit) ~ 207.4 km/s
    => [T] = L_unit / V_unit ~ 4.7 Myr

All quantities are then O(1)-O(100), ideal for fp32/bf16 arithmetic.
This module holds the conversion constants and helpers; a model's unit
system is part of its config preset (``g=1.0`` for galactic models).
"""

from __future__ import annotations

import math

# SI fundamental values.
G_SI = 6.67430e-11  # m^3 kg^-1 s^-2
KPC_M = 3.0856775814913673e19  # meters per kiloparsec
MSUN_KG = 1.98892e30  # kg per solar mass

# Galactic unit definitions.
LENGTH_UNIT_M = KPC_M  # 1 kpc
MASS_UNIT_KG = 1.0e10 * MSUN_KG  # 1e10 Msun
VELOCITY_UNIT_MS = math.sqrt(G_SI * MASS_UNIT_KG / LENGTH_UNIT_M)  # ~2.07e5
TIME_UNIT_S = LENGTH_UNIT_M / VELOCITY_UNIT_MS  # ~1.49e14 s ~ 4.7 Myr


def si_to_galactic_length(x_m):
    return x_m / LENGTH_UNIT_M


def si_to_galactic_mass(m_kg):
    return m_kg / MASS_UNIT_KG


def si_to_galactic_velocity(v_ms):
    return v_ms / VELOCITY_UNIT_MS


def si_to_galactic_time(t_s):
    return t_s / TIME_UNIT_S


def galactic_to_si_length(x):
    return x * LENGTH_UNIT_M


def galactic_to_si_mass(m):
    return m * MASS_UNIT_KG


def galactic_to_si_velocity(v):
    return v * VELOCITY_UNIT_MS


def galactic_to_si_time(t):
    return t * TIME_UNIT_S
