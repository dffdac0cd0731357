"""Cosmology demo: measure the linear growth curve D(a) against theory.
Counterpart of ``examples/cosmology.py``.

Zel'dovich initial conditions in a periodic box, evolved with the
comoving KDK integrator and the periodic FFT solver, the displacement
amplitude measured at several scale factors — the Python-API version of
``python -m gravity_tpu_torch cosmo``, the pieces composed by hand.

    python -m gravity_tpu_torch.examples.cosmology [--omega-m 0.3] \
        [--side 16]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--omega-m", dest="omega_m", type=float, default=1.0)
    ap.add_argument("--side", type=int, default=16,
                    help="lattice side (n = side^3)")
    ap.add_argument("--steps", type=int, default=25,
                    help="KDK steps per checkpoint interval")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import math

    import torch

    from gravity_tpu_torch.models import create_grf, grf_lattice
    from gravity_tpu_torch.ops.cosmo import (
        comoving_kdk_run,
        growing_mode_momenta,
        linear_growth_ratio,
    )
    from gravity_tpu_torch.ops.periodic import pm_periodic_accelerations_vs
    from gravity_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    box, h0 = 1.0e13, 0.05
    side = args.side
    n = side**3
    checkpoints = [0.02, 0.04, 0.08, 0.16]

    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    st = create_grf(gen, n, box=box, spectral_index=-2.0, sigma_psi=0.002,
                    total_mass=1.0e36, dtype=torch.float64, device=device)
    lat = grf_lattice(side, box, dtype=st.positions.dtype, device=device)

    def displacement(x):
        return torch.remainder(x - lat + box / 2, box) - box / 2

    disp0 = displacement(st.positions)
    st = st.replace(velocities=growing_mode_momenta(
        disp0, checkpoints[0], h0, args.omega_m))
    m_tot = float(st.masses.sum())
    g_eff = 3.0 * args.omega_m * h0**2 * box**3 / (8.0 * math.pi * m_tot)
    masses = st.masses

    def accel(x):
        return pm_periodic_accelerations_vs(
            x, x, masses, box=box, grid=side, g=g_eff, eps=0.0)

    print(f"omega_m={args.omega_m}  n={n}  box={box:g}")
    print(f"{'a':>6} {'D measured':>12} {'D linear':>10} {'rel err':>9}")
    print(f"{checkpoints[0]:6.3f} {1.0:12.4f} {1.0:10.4f} {'—':>9}")
    worst = 0.0
    for a1, a2 in zip(checkpoints[:-1], checkpoints[1:]):
        st = comoving_kdk_run(
            st, accel, a_start=a1, a_end=a2, n_steps=args.steps, h0=h0,
            omega_m=args.omega_m,
        )
        disp = displacement(st.positions)
        measured = float((disp * disp0).sum() / (disp0 * disp0).sum())
        linear = linear_growth_ratio(checkpoints[0], a2, args.omega_m)
        rel = abs(measured - linear) / linear
        worst = max(worst, rel)
        print(f"{a2:6.3f} {measured:12.4f} {linear:10.4f} {rel:9.2%}")

    ok = worst < 0.10  # quasi-linear corrections grow with D
    print("GROWTH OK" if ok else "GROWTH DEVIATES FROM LINEAR THEORY")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
