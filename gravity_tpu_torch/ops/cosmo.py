"""Comoving cosmological integration: grf initial conditions, the periodic
solver, this module, then P(k) growth.

Counterpart of ``gravity_tpu/ops/cosmo.py``. The standard comoving
formulation (Peebles; the KDK split of Quinn et al. 1997): positions x
are comoving and the canonical momentum p = a^2 dx/dt rides in the
state's ``velocities``:

    dx/dt = p / a^2
    dp/dt = -grad(phi),   del^2 phi = 4 pi G rho_0 delta / a

with rho_0 the comoving mean density, so the periodic solver's
acceleration, with the 1/a folded into the kick factor, gives each kick.
For EdS (Omega_m = 1) the KDK factors over [a1, a2] are analytic

    kick  = int dt / a   = (2/H0) (sqrt(a2) - sqrt(a1))
    drift = int dt / a^2 = (2/H0) (1/sqrt(a1) - 1/sqrt(a2))

and the linear growth factor is D(a) = a. Other cosmologies (curvature,
CPL dark energy) take float64 host quadratures of E(a) and a float64
RK4 solve of the growth ODE. Every factor, quadrature and growth number
is computed on the host in float64 (numpy) and cast to the state's dtype
at the end; the scan itself runs on the state's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..state import ParticleState


def eds_kick_factor(a1, a2, h0):
    """int dt / a over [a1, a2] for EdS; the dtype follows the inputs
    (``** 0.5``), so float64 edges cancel sqrt(a2) - sqrt(a1) in
    float64."""
    return (2.0 / h0) * (a2**0.5 - a1**0.5)


def eds_drift_factor(a1, a2, h0):
    """int dt / a^2 over [a1, a2] for EdS (dtype as
    :func:`eds_kick_factor`)."""
    return (2.0 / h0) * (1.0 / a1**0.5 - 1.0 / a2**0.5)


def _is_eds(omega_m, omega_k, w0, wa) -> bool:
    """True for exactly the EdS parameters: the one gate of every
    analytic-EdS shortcut here."""
    return omega_m == 1.0 and omega_k == 0.0 and w0 == -1.0 and wa == 0.0


def _e2_terms(a, omega_m, omega_k, w0, wa):
    """(E^2, dE^2/dlna), analytic for matter + curvature + CPL."""
    omega_de = 1.0 - omega_m - omega_k
    q = -3.0 * (1.0 + w0 + wa)
    de = omega_de * a**q * np.exp(-3.0 * wa * (1.0 - a))
    mat = omega_m / a**3
    cur = omega_k / a**2
    e2 = mat + cur + de
    # dln(de)/dlna = q + 3 wa a.
    de2 = -3.0 * mat - 2.0 * cur + de * (q + 3.0 * wa * a)
    return e2, de2


def e_of_a(a, omega_m, omega_k=0.0, w0=-1.0, wa=0.0):
    """E(a) = H(a)/H0 for matter + curvature + CPL dark energy (w(a) = w0
    + wa (1 - a)); the defaults are flat LambdaCDM, omega_m = 1 is EdS.
    numpy in, numpy out (host float64). Raises ValueError where E^2 <= 0:
    a closed universe that recollapses inside the requested range."""
    e2, _ = _e2_terms(np.asarray(a, np.float64), omega_m, omega_k, w0, wa)
    if np.any(e2 <= 0.0):
        raise ValueError(
            f"E^2(a) <= 0 for omega_m={omega_m}, omega_k={omega_k}, "
            f"w0={w0}, wa={wa} at some requested a — this closed "
            "universe recollapses inside the range; no expansion "
            "history exists there"
        )
    return np.sqrt(e2)


def _trapezoid(y, x):
    trap = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    return trap(y, x)


def lcdm_factors(a1, a2, h0, omega_m, *, omega_k=0.0, w0=-1.0, wa=0.0,
                 n_quad: int = 512):
    """(kick, drift) = (int dt/a, int dt/a^2) over [a1, a2] for matter +
    curvature + CPL dark energy, H = H0 E(a), dt = da / (a H): a host
    float64 trapezoid quadrature (the EdS closed forms at omega_m = 1)."""
    a = np.linspace(float(a1), float(a2), n_quad + 1)
    h = h0 * e_of_a(a, omega_m, omega_k, w0, wa)
    dt_da = 1.0 / (a * h)
    return _trapezoid(dt_da / a, a), _trapezoid(dt_da / a**2, a)


def _growth_solve(a_targets, omega_m, omega_k=0.0, w0=-1.0, wa=0.0, *,
                  a_init: float = 1e-4, n_steps: int = 4096):
    """[(D(a), f(a) = dlnD/dlna) for a in a_targets] by one pass of the
    linear growth ODE in u = ln a (host float64 RK4):

        D'' + (2 + dlnE/dlna) D' = (3/2) Omega_m(a) D,
        Omega_m(a) = omega_m a^-3 / E^2,

    seeded deep in matter domination with the growing mode D = a, f = 1.
    ``a_targets`` ascending."""

    def rhs(u, y):
        d, dp = y
        a = np.exp(u)
        e2, de2 = _e2_terms(a, omega_m, omega_k, w0, wa)
        om_a = omega_m / a**3 / e2
        dln_e = 0.5 * de2 / e2
        return np.array([dp, 1.5 * om_a * d - (2.0 + dln_e) * dp])

    def rk4_to(u, y, u_end, steps):
        du = (u_end - u) / steps
        for _ in range(steps):
            k1 = rhs(u, y)
            k2 = rhs(u + du / 2, y + du / 2 * k1)
            k3 = rhs(u + du / 2, y + du / 2 * k2)
            k4 = rhs(u + du, y + du * k3)
            y = y + du / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            u += du
        return u, y

    y = np.array([a_init, a_init])
    u = np.log(a_init)
    u_span = np.log(float(a_targets[-1])) - u
    out = []
    for a_t in a_targets:
        u_t = np.log(float(a_t))
        seg = max(1, int(round(n_steps * (u_t - u) / u_span)))
        u, y = rk4_to(u, y, u_t, seg)
        out.append((float(y[0]), float(y[1] / y[0])))
    return out


def linear_growth_ratio(a1: float, a2: float, omega_m: float = 1.0, *,
                        omega_k: float = 0.0, w0: float = -1.0,
                        wa: float = 0.0, n_quad: int = 4096) -> float:
    """D(a2)/D(a1) (the growth-ODE solve; exactly a2/a1 at EdS)."""
    if _is_eds(omega_m, omega_k, w0, wa):
        return float(a2) / float(a1)
    (d1, _), (d2, _) = _growth_solve(
        sorted((float(a1), float(a2))), omega_m, omega_k, w0, wa,
        n_steps=n_quad,
    )
    if a2 < a1:
        d1, d2 = d2, d1
    return d2 / d1


def growth_rate(a: float, omega_m: float = 1.0, *, omega_k: float = 0.0,
                w0: float = -1.0, wa: float = 0.0) -> float:
    """f = dlnD/dlna (exactly 1 at EdS), from the growth-ODE solve."""
    if _is_eds(omega_m, omega_k, w0, wa):
        return 1.0
    [(_, f)] = _growth_solve([a], omega_m, omega_k, w0, wa)
    return f


def _scaled(scale: float, field: torch.Tensor, dtype):
    dtype = dtype or field.dtype
    return torch.tensor(scale, dtype=dtype, device=field.device) * field


def zeldovich_momenta(displacements: torch.Tensor, a, h0, dtype=None):
    """Growing-mode momenta of x = q + D(a) psi with D = a (EdS):
    p = a^2 dD/dt psi = H0 a^(3/2) psi, ``displacements`` the D = 1
    field. For other cosmologies use :func:`growing_mode_momenta`."""
    dtype = dtype or displacements.dtype
    dev = displacements.device
    h0_t = torch.tensor(h0, dtype=dtype, device=dev)
    a_t = torch.tensor(a, dtype=dtype, device=dev)
    return h0_t * a_t**1.5 * displacements


def growing_mode_momenta(disp_now: torch.Tensor, a, h0,
                         omega_m: float = 1.0, dtype=None, *,
                         omega_k: float = 0.0, w0: float = -1.0,
                         wa: float = 0.0):
    """Momenta from the current displacement field: the growing mode has
    dx/dt = f(a) H(a) disp, so p = a^2 f(a) H(a) disp_now, for any matter
    + curvature + CPL cosmology (the scale in host float64)."""
    h = h0 * e_of_a(a, omega_m, omega_k, w0, wa)
    scale = a * a * growth_rate(a, omega_m, omega_k=omega_k, w0=w0,
                                wa=wa) * h
    return _scaled(float(scale), disp_now, dtype)


def comoving_kdk_factors(a_edges, h0, omega_m=1.0, *, omega_k=0.0,
                         w0=-1.0, wa=0.0, dtype=torch.float32,
                         device="cpu"):
    """(k1s, drs, k2s) KDK factor tensors for explicit step edges: the
    half-kick over [a1, a_mid], the drift over [a1, a2] and the half-kick
    over [a_mid, a2] of each step (a_mid the log midpoint), in host
    float64 and cast to ``dtype`` at the end. Explicit edges make
    blockwise (checkpointed, streamed) runs exact: a resume computes the
    factors of the same global grid."""
    a_edges_np = np.asarray(a_edges, np.float64)
    a_mids_np = np.sqrt(a_edges_np[:-1] * a_edges_np[1:])
    if _is_eds(omega_m, omega_k, w0, wa):
        k1s = eds_kick_factor(a_edges_np[:-1], a_mids_np, h0)
        drs = eds_drift_factor(a_edges_np[:-1], a_edges_np[1:], h0)
        k2s = eds_kick_factor(a_mids_np, a_edges_np[1:], h0)
    else:
        cosmo = dict(omega_k=omega_k, w0=w0, wa=wa)
        pairs1 = [lcdm_factors(a1, am, h0, omega_m, **cosmo)
                  for a1, am in zip(a_edges_np[:-1], a_mids_np)]
        pairs2 = [lcdm_factors(am, a2, h0, omega_m, **cosmo)
                  for am, a2 in zip(a_mids_np, a_edges_np[1:])]
        k1s = np.asarray([p[0] for p in pairs1])
        k2s = np.asarray([p[0] for p in pairs2])
        drs = np.asarray([p1[1] + p2[1] for p1, p2 in zip(pairs1, pairs2)])
    return tuple(torch.as_tensor(np.asarray(x, np.float64)).to(
        dtype=dtype, device=device) for x in (k1s, drs, k2s))


def comoving_kdk_scan(state: ParticleState, k1s, drs, k2s, *,
                      accel_fn: Callable) -> ParticleState:
    """The comoving KDK steps over factor tensors (one step a factor
    triple). The closing force at the drifted positions is the next
    step's opening force, so a step costs one force evaluation. The
    factors are read on the device (a step's factor is a tensor element,
    never a host number)."""
    x, p = state.positions, state.velocities
    acc = accel_fn(x)
    for t in range(k1s.shape[0]):
        p = p + acc * k1s[t]
        x = x + p * drs[t]
        acc = accel_fn(x)
        p = p + acc * k2s[t]
    return state.replace(positions=x, velocities=p)


def comoving_kdk_run(state: ParticleState, accel_fn: Callable, *,
                     a_start: float, a_end: float, n_steps: int, h0: float,
                     omega_m: float = 1.0, omega_k: float = 0.0,
                     w0: float = -1.0, wa: float = 0.0) -> ParticleState:
    """Integrate from a_start to a_end in n_steps comoving KDK steps,
    uniform in log(a). ``accel_fn(positions)`` is the comoving-grid
    Newtonian acceleration (the periodic solver with the comoving
    masses); ``state.velocities`` carries p = a^2 dx/dt in and out.
    omega_m = 1 (flat, w = -1) is EdS (analytic factors); anything else
    takes float64 quadratures of E(a). Curvature and dark energy enter
    through H(a) only (unclustered dark energy)."""
    edges = np.exp(np.linspace(np.log(a_start), np.log(a_end), n_steps + 1))
    k1s, drs, k2s = comoving_kdk_factors(
        edges, h0, omega_m, omega_k=omega_k, w0=w0, wa=wa,
        dtype=state.positions.dtype, device=state.positions.device)
    return comoving_kdk_scan(state, k1s, drs, k2s, accel_fn=accel_fn)


def layzer_irvine_residual(records) -> float:
    """The normalized Layzer-Irvine residual of (a, T, W) samples: the
    cosmic energy equation d(T + W)/da = -(2T + W)/a, with W the proper
    potential energy (the comoving solve's W_comoving / a), leaves

        [T + W](a2) - [T + W](a1) + int_a1^a2 (2T + W)/a da

    near zero; the trapezoid sum over the records, over max |W|.
    ``records`` is an iterable of (a, T, W) with ascending a."""
    rec = np.asarray(list(records), np.float64)
    if rec.shape[0] < 2:
        raise ValueError("need >= 2 (a, T, W) records")
    a, t, w = rec[:, 0], rec[:, 1], rec[:, 2]
    e = t + w
    residual = (e[-1] - e[0]) + _trapezoid((2.0 * t + w) / a, a)
    scale = np.max(np.abs(w))
    return float(residual / scale) if scale > 0 else float(residual)
