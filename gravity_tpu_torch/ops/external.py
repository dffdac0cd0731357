"""Analytic external (background) fields.

Counterpart of ``gravity_tpu/ops/external.py``. Each field is a pure
``positions (N, 3) -> accelerations (N, 3)`` function, added to
self-gravity after the force backend (O(N), any backend), and each has
a potential twin ``positions -> phi (N,)`` with a = -grad(phi) for the
energy of ``--external`` runs.

Spec strings (``--external``; terms joined by ``" + "``, commas between
one term's parameters):

    pointmass:gm=1.3e20              central point mass (optionally x/y/z)
    plummer:gm=...,a=...             Plummer sphere background
    nfw:gm=...,rs=...                NFW halo (gm = 4*pi*G*rho0*rs^3)
    hernquist:gm=...,a=...           Hernquist bulge
    logarithmic:v0=...,rc=...        flat-rotation-curve halo
    uniform:gx=...,gy=...,gz=...     constant field

Every field computes in the positions' dtype, its constants rounded to
that dtype first (``ops/forces.py::rounded``), as JAX rounds a
weak-typed Python float.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import torch

from .forces import rounded, tiny

ExternalAccel = Callable[[torch.Tensor], torch.Tensor]


def _vector(values):
    """``like -> values`` as a 3-vector of ``like``'s dtype on its device,
    each value rounded to the dtype. Made once for each (device, dtype):
    a host-to-device copy at every step would wait for the stream."""
    cache = {}

    def get(like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in cache:
            cache[key] = like.new_tensor(
                [rounded(v, like.dtype) for v in values])
        return cache[key]

    return get


def _r(pos: torch.Tensor, center):
    d = pos - center(pos)
    return d, (d * d).sum(dim=-1, keepdim=True)


def point_mass(gm: float, center=(0.0, 0.0, 0.0),
               eps: float = 0.0) -> ExternalAccel:
    """a = -GM * r_vec / (r^2 + eps^2)^(3/2)."""
    center_of = _vector(center)

    def accel(pos):
        dtype = pos.dtype
        d, r2 = _r(pos, center_of)
        r2 = r2 + rounded(eps * eps, dtype)
        inv_r = torch.rsqrt(torch.clamp_min(r2, tiny(dtype)))
        return -rounded(gm, dtype) * d * inv_r * inv_r * inv_r

    return accel


def plummer(gm: float, a: float, center=(0.0, 0.0, 0.0)) -> ExternalAccel:
    """Plummer sphere: a = -GM * r_vec / (r^2 + a^2)^(3/2)."""
    return point_mass(gm, center, eps=a)


def hernquist(gm: float, a: float, center=(0.0, 0.0, 0.0)) -> ExternalAccel:
    """Hernquist (1990) bulge: a = -GM * r_vec / (r * (r + a)^2)."""
    center_of = _vector(center)

    def accel(pos):
        dtype = pos.dtype
        d, r2 = _r(pos, center_of)
        r = torch.sqrt(torch.clamp_min(r2, tiny(dtype)))
        denom = r * (r + rounded(a, dtype)) ** 2
        return -rounded(gm, dtype) * d / torch.clamp_min(denom, tiny(dtype))

    return accel


def _nfw_r(r2, rs: float, dtype):
    """The radius of the NFW forms, floored once at 1e-8 rs for both the
    enclosed-mass fraction and the 1/r^2 divisor, so a -> 0 linearly at
    the centre, as the profile does."""
    return torch.clamp_min(torch.sqrt(torch.clamp_min(r2, tiny(dtype))),
                           rounded(1e-8 * rs, dtype))


def nfw(gm: float, rs: float, center=(0.0, 0.0, 0.0)) -> ExternalAccel:
    """NFW halo with gm = 4*pi*G*rho0*rs^3:
    a = -gm * [ln(1+x) - x/(1+x)] * r_hat / r^2,  x = r/rs."""
    center_of = _vector(center)

    def accel(pos):
        dtype = pos.dtype
        d, r2 = _r(pos, center_of)
        r = _nfw_r(r2, rs, dtype)
        x = r / rounded(rs, dtype)
        m_frac = torch.log1p(x) - x / (1.0 + x)
        a_mag = rounded(gm, dtype) * m_frac / (r * r)
        return -a_mag * d / r

    return accel


def logarithmic(v0: float, rc: float,
                center=(0.0, 0.0, 0.0)) -> ExternalAccel:
    """Logarithmic halo (flat rotation curve v0 at r >> rc):
    a = -v0^2 * r_vec / (r^2 + rc^2)."""
    center_of = _vector(center)

    def accel(pos):
        dtype = pos.dtype
        d, r2 = _r(pos, center_of)
        return (-rounded(v0 * v0, dtype) * d
                / (r2 + rounded(rc * rc, dtype)))

    return accel


def uniform(gx: float = 0.0, gy: float = 0.0,
            gz: float = 0.0) -> ExternalAccel:
    """Constant acceleration field."""
    field = _vector((gx, gy, gz))

    def accel(pos):
        return field(pos).expand(pos.shape)

    return accel


def combine(fields: Sequence[ExternalAccel]) -> ExternalAccel:
    """Sum of external fields (accelerations or potentials alike)."""

    def accel(pos):
        total = fields[0](pos)
        for f in fields[1:]:
            total = total + f(pos)
        return total

    return accel


# Per-particle potentials phi(x): E_ext = sum_i m_i phi(x_i), a = -grad phi.


def point_mass_phi(gm, center=(0.0, 0.0, 0.0), eps: float = 0.0):
    center_of = _vector(center)

    def phi(pos):
        dtype = pos.dtype
        _, r2 = _r(pos, center_of)
        r2 = r2 + rounded(eps * eps, dtype)
        return (-rounded(gm, dtype)
                * torch.rsqrt(torch.clamp_min(r2, tiny(dtype))))[..., 0]

    return phi


def plummer_phi(gm, a, center=(0.0, 0.0, 0.0)):
    return point_mass_phi(gm, center, eps=a)


def hernquist_phi(gm, a, center=(0.0, 0.0, 0.0)):
    center_of = _vector(center)

    def phi(pos):
        dtype = pos.dtype
        _, r2 = _r(pos, center_of)
        r = torch.sqrt(torch.clamp_min(r2, tiny(dtype)))
        return (-rounded(gm, dtype) / (r + rounded(a, dtype)))[..., 0]

    return phi


def nfw_phi(gm, rs, center=(0.0, 0.0, 0.0)):
    center_of = _vector(center)

    def phi(pos):
        dtype = pos.dtype
        _, r2 = _r(pos, center_of)
        r = _nfw_r(r2, rs, dtype)
        x = r / rounded(rs, dtype)
        return (-rounded(gm, dtype) * torch.log1p(x) / r)[..., 0]

    return phi


def logarithmic_phi(v0, rc, center=(0.0, 0.0, 0.0)):
    center_of = _vector(center)

    def phi(pos):
        dtype = pos.dtype
        _, r2 = _r(pos, center_of)
        return (0.5 * rounded(v0 * v0, dtype)
                * torch.log(r2 + rounded(rc * rc, dtype)))[..., 0]

    return phi


def uniform_phi(gx: float = 0.0, gy: float = 0.0, gz: float = 0.0):
    field = _vector((gx, gy, gz))

    def phi(pos):
        return -(pos * field(pos)).sum(dim=-1)

    return phi


_FACTORIES = {
    "pointmass": (point_mass, point_mass_phi, {"gm"}, {"x", "y", "z", "eps"}),
    "plummer": (plummer, plummer_phi, {"gm", "a"}, {"x", "y", "z"}),
    "hernquist": (hernquist, hernquist_phi, {"gm", "a"}, {"x", "y", "z"}),
    "nfw": (nfw, nfw_phi, {"gm", "rs"}, {"x", "y", "z"}),
    "logarithmic": (logarithmic, logarithmic_phi, {"v0", "rc"},
                    {"x", "y", "z"}),
    "uniform": (uniform, uniform_phi, set(), {"gx", "gy", "gz"}),
}


def parse_external(spec: str, kind: str = "accel") -> ExternalAccel:
    """A field from a spec string: ``"nfw:gm=1e13,rs=2e20"``, or a sum of
    terms joined by ``" + "`` (whitespace around the plus, so that
    exponents such as ``1e+20`` pass through):
    ``"pointmass:gm=1.3e20 + uniform:gz=-9.8"``.

    ``kind="accel"`` gives positions -> accelerations (N, 3);
    ``kind="potential"`` gives positions -> phi (N,)."""
    if kind not in ("accel", "potential"):
        raise ValueError(f"unknown kind {kind!r}")
    fields = []
    for term in re.split(r"\s\+\s", spec):
        term = term.strip()
        if not term:
            continue
        name, _, argstr = term.partition(":")
        name = name.strip().lower()
        if name not in _FACTORIES:
            raise ValueError(
                f"unknown external potential {name!r}; "
                f"choose from {sorted(_FACTORIES)}"
            )
        accel_fac, phi_fac, required, optional = _FACTORIES[name]
        factory = accel_fac if kind == "accel" else phi_fac
        kwargs = {}
        for kv in filter(None, (s.strip() for s in argstr.split(","))):
            key, _, val = kv.partition("=")
            key = key.strip().lower()
            if key not in required | optional:
                raise ValueError(
                    f"unknown parameter {key!r} for {name!r} "
                    f"(accepts {sorted(required | optional)})"
                )
            kwargs[key] = float(val)
        missing = required - kwargs.keys()
        if missing:
            raise ValueError(
                f"external potential {name!r} needs {sorted(missing)}"
            )
        center = (
            kwargs.pop("x", 0.0), kwargs.pop("y", 0.0), kwargs.pop("z", 0.0)
        )
        if name == "uniform":
            fields.append(factory(**kwargs))
        else:
            fields.append(factory(center=center, **kwargs))
    if not fields:
        raise ValueError(f"empty external-potential spec {spec!r}")
    return fields[0] if len(fields) == 1 else combine(fields)
