"""Star-cluster demo: a hard binary inside a Plummer cluster, resolved
by the block-timestep rung ladder at a fraction of global-substepping
cost. Counterpart of ``examples/star_cluster.py``.

A tight equal-mass binary is planted at the centre of a Plummer sphere.
Its orbital period is ~100x shorter than the cluster's dynamical time,
so a single global dt either under-resolves the binary or wastes
~2^(R-1) full force evaluations per outer step on the quiescent bulk.
The rung ladder (``--integrator multirate --multirate-rungs 3``)
sub-cycles only the static top-|a| sets, keeping ONE full (N, N)
evaluation per outer step.

    python -m gravity_tpu_torch.examples.star_cluster [--n 2048] \
        [--steps 30] [--rungs 3]

Prints one JSON line of each scheme's energy drift: single-rate leapfrog
> two-rung > three-rung ladder.
"""

from __future__ import annotations

import argparse
import json
import math


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024,
                    help="cluster size (binary adds 2)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rungs", type=int, default=3,
                    help="ladder rungs (minimum 3: below that the "
                         "ladder IS the two-rung scheme)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.rungs < 3:
        ap.error("--rungs must be >= 3")

    import torch

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.constants import G
    from gravity_tpu_torch.models import create_plummer
    from gravity_tpu_torch.ops.diagnostics import total_energy
    from gravity_tpu_torch.simulation import Simulator
    from gravity_tpu_torch.state import ParticleState
    from gravity_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cluster = create_plummer(gen, args.n, dtype=torch.float64,
                             device=device)
    m_b = 5.0e28
    a_bin = 2.0e9  # tight: ~1e-3 of the cluster scale radius
    # Circular orbit at separation a_bin: v_rel = sqrt(G (2m) / a_bin).
    v_bin = math.sqrt(2 * G * m_b / a_bin)
    period = 2 * math.pi * math.sqrt(a_bin**3 / (G * 2 * m_b))

    def f64(rows):
        return torch.tensor(rows, dtype=torch.float64, device=device)

    state = ParticleState(
        torch.cat([f64([[-a_bin / 2, 0, 0], [a_bin / 2, 0, 0]]),
                   cluster.positions]),
        torch.cat([f64([[0, -v_bin / 2, 0], [0, v_bin / 2, 0]]),
                   cluster.velocities]),
        torch.cat([f64([m_b, m_b]), cluster.masses]),
    )
    dt = period / 5.0  # deliberately too coarse for the binary
    # Softening well below the binary separation: cluster encounters are
    # regularized, the binary stays Newtonian, and the drift isolates
    # the timestep error.
    eps = a_bin / 10.0
    e0 = float(total_energy(state, eps=eps))

    def drift(config):
        sim = Simulator(config, state=state, device=device)
        final = sim.run()["final_state"]
        return abs((float(total_energy(final, eps=eps)) - e0) / e0)

    base = dict(
        n=state.n, steps=args.steps, dt=dt, force_backend="dense",
        dtype="float64", eps=eps,
    )
    n = state.n
    rungs = args.rungs
    sub = 1 << (rungs - 1)  # two-rung matches the ladder's finest dt
    k_ladder = 2 * 8 ** (rungs - 2)  # fastest capacity lands on 2 = binary
    report = {
        "n": n,
        "binary_period_s": period,
        "dt_s": dt,
        "steps": args.steps,
        # Every scheme pays ONE full (N, N) evaluation an outer step; the
        # block-timestep schemes add rectangular fast kicks, reported as
        # extra pair evaluations an outer step.
        "drift_single_rate": drift(SimulationConfig(
            integrator="leapfrog", **base
        )),
        "drift_two_rung": drift(SimulationConfig(
            integrator="multirate", multirate_k=2, multirate_sub=sub,
            **base
        )),
        "two_rung_extra_pairs": sub * 2 * n,
        f"drift_ladder_r{rungs}": drift(SimulationConfig(
            integrator="multirate", multirate_k=k_ladder,
            multirate_rungs=rungs, **base
        )),
        "ladder_extra_pairs": sum(
            (1 << r) * max(1, k_ladder // 8 ** (r - 1)) * n
            for r in range(1, rungs)
        ),
        "full_eval_pairs": n * n,
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
