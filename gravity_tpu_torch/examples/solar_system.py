"""Solar-system demo: integrate Sun/Earth/Mars for one Earth year and
report orbital closure — the reference's seed system turned into a
quantitative validation. Counterpart of ``examples/solar_system.py``.

    python -m gravity_tpu_torch.examples.solar_system [--steps-per-day 24]
"""

from __future__ import annotations

import argparse
import math


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-per-day", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.simulation import Simulator

    dt = 86400.0 / args.steps_per_day
    steps = int(365.25 * args.steps_per_day)
    config = SimulationConfig(
        model="solar", n=3, steps=steps, dt=dt,
        integrator="leapfrog", force_backend="dense",
    )
    sim = Simulator(config, device=args.device)
    start = sim.state.positions.double().cpu().numpy()
    stats = sim.run()
    final = stats["final_state"].positions.double().cpu().numpy()

    r0 = math.hypot(*start[1])
    r1 = math.hypot(*final[1])
    # The angle Earth sweeps over one year ~ 2 pi.
    a0 = math.atan2(start[1][1], start[1][0])
    a1 = math.atan2(final[1][1], final[1][0])
    sweep = (a1 - a0) % (2 * math.pi)
    print(f"Earth radius start/end: {r0:.4e} / {r1:.4e} m "
          f"({abs(r1 - r0) / r0 * 100:.3f}% change)")
    print(f"Earth phase after 365.25 d: {sweep:.4f} rad from start "
          f"(closure error {min(sweep, 2 * math.pi - sweep):.4f} rad)")
    print(f"throughput: {stats['pairs_per_sec']:.3e} pairs/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
