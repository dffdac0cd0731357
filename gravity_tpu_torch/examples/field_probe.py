"""Field-probe demo: evaluate a galaxy's gravitational field on an
arbitrary probe grid with the rectangular FMM. Counterpart of
``examples/field_probe.py``.

``fmm_accelerations_vs(targets, sources, masses)`` evaluates the fast
solver at ANY set of points: inside the source cloud (slot-binned
passes) or outside it (the monopole-hierarchy fallback at real
distances). The probes are first-class targets at O(probes + sources)
cost, not massless tracers in an O(N^2) pair set.

Prints the acceleration magnitude of an exponential disk on a vertical
slice through its plane, and the rotation curve v_c(R) = sqrt(R |a_R|)
along a ray, checked against the dense direct sum on a subsample.

    python -m gravity_tpu_torch.examples.field_probe [--n 16384] \
        [--grid 24]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384,
                    help="disk particle count")
    ap.add_argument("--grid", type=int, default=24,
                    help="probe grid resolution per axis")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.n < 64 or args.grid < 4:
        ap.error("--n must be >= 64 and --grid >= 4")

    import numpy as np
    import torch

    from gravity_tpu_torch.models import create_disk
    from gravity_tpu_torch.ops.fmm import fmm_accelerations_vs
    from gravity_tpu_torch.ops.forces import accelerations_vs
    from gravity_tpu_torch.ops.tree import recommended_depth_data
    from gravity_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    state = create_disk(gen, args.n, device=device)
    pos, masses = state.positions, state.masses
    depth = recommended_depth_data(pos)

    def host(t):
        return t.double().cpu().numpy()

    # Probe plane: an x-z slice through the disk (y = 0), past the
    # stellar edge: the outer probes lie OUTSIDE the source cube and take
    # the monopole-hierarchy fallback.
    r_max = 1.25 * float(pos[:, :2].abs().max())
    z_max = 0.5 * r_max
    xs = torch.linspace(-r_max, r_max, args.grid, device=device)
    zs = torch.linspace(-z_max, z_max, args.grid, device=device)
    gx, gz = torch.meshgrid(xs, zs, indexing="ij")
    probes = torch.stack(
        [gx.ravel(), torch.zeros_like(gx).ravel(), gz.ravel()], dim=1)

    acc = fmm_accelerations_vs(probes, pos, masses, depth=depth, g=1.0,
                               eps=0.05)
    mag = np.linalg.norm(host(acc), axis=1).reshape(args.grid, args.grid)
    print(f"n={args.n} probes={probes.shape[0]} depth={depth}")
    print(
        "field |a| over the x-z slice: "
        f"min={mag.min():.3e} median={np.median(mag):.3e} "
        f"max={mag.max():.3e}"
    )

    # The rotation curve along +x, v_c = sqrt(R |a_R|).
    radii = torch.linspace(0.05 * r_max, r_max, 16, device=device)
    ray = torch.stack(
        [radii, torch.zeros_like(radii), torch.zeros_like(radii)], dim=1)
    a_ray = fmm_accelerations_vs(ray, pos, masses, depth=depth, g=1.0,
                                 eps=0.05)
    v_c = torch.sqrt(radii * a_ray[:, 0].abs())
    print("rotation curve (R [kpc], v_c [natural units]):")
    for r, v in zip(host(radii), host(v_c)):
        print(f"  R={r:7.2f}  v_c={v:8.4f}")

    # A probe subsample against the exact dense rectangular sum: the FMM
    # field is an approximation with a documented envelope.
    check = probes[:: max(1, probes.shape[0] // 64)]
    exact = host(accelerations_vs(check, pos, masses, g=1.0, eps=0.05))
    approx = host(fmm_accelerations_vs(check, pos, masses, depth=depth,
                                       g=1.0, eps=0.05))
    rel = np.linalg.norm(approx - exact, axis=1) / (
        np.linalg.norm(exact, axis=1) + 1e-300)
    print(
        f"fmm-vs-dense on {check.shape[0]} probes: "
        f"median rel err {np.median(rel):.2e}, "
        f"p95 {np.percentile(rel, 95):.2e}"
    )
    ok = float(np.median(rel)) < 0.02
    print("OK" if ok else "DEGRADED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
