"""Galaxy-merger demo: two disk galaxies on a collision course, evolved
with the P3M solver, structure diagnostics printed as the merger
proceeds. Counterpart of ``examples/galaxy_merger.py``.

    python -m gravity_tpu_torch.examples.galaxy_merger [--n 8192] \
        [--steps 200]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--backend", default="p3m",
                    choices=["p3m", "tree", "pm", "pallas", "chunked"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.ops import diagnostics as diag
    from gravity_tpu_torch.simulation import Simulator

    config = SimulationConfig(
        model="merger", n=args.n, steps=args.steps, dt=2.0e-3,
        g=1.0, eps=0.05, integrator="leapfrog",
        force_backend=args.backend, pm_grid=64, p3m_cap=256,
        progress_every=max(1, args.steps // 4),
    )
    sim = Simulator(config, device=args.device)
    state0 = sim.state
    e0 = float(diag.total_energy(state0, g=1.0, eps=0.05))
    r0 = float(diag.lagrangian_radii(state0, (0.5,))[0])
    print(f"n={args.n} backend={config.force_backend} steps={args.steps}")
    print(f"initial: E={e0:.4e}  r_half={r0:.3f} kpc  "
          f"virial={float(diag.virial_ratio(state0, g=1.0, eps=0.05)):.3f}")

    stats = sim.run()
    final = stats["final_state"]
    e1 = float(diag.total_energy(final, g=1.0, eps=0.05))
    r1 = float(diag.lagrangian_radii(final, (0.5,))[0])
    print(f"final:   E={e1:.4e}  r_half={r1:.3f} kpc  "
          f"virial={float(diag.virial_ratio(final, g=1.0, eps=0.05)):.3f}")
    print(f"energy drift: {abs((e1 - e0) / e0) * 100:.3f}%")
    print(f"throughput: {stats['pairs_per_sec']:.3e} (equivalent) pairs/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
