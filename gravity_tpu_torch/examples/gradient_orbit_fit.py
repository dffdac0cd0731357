"""Differentiable-simulator demo: fit a transfer-orbit launch velocity by
gradient descent *through the integrator*, as a thin client of the
served ``fit`` job class (``gravity_tpu_torch/serve/jobs/fit.py``).
Counterpart of ``examples/gradient_orbit_fit.py``.

Find the launch velocity that carries a probe from Earth's orbit radius
to a target point in a fixed flight time, by differentiating the
endpoint miss through the N-body integration. By default this starts a
serving daemon on a temporary spool, submits the fit as a real job, and
checks the served result against :func:`~gravity_tpu_torch.serve.jobs.
fit.fit_solo` within 1e-5, the serving tests' parity. ``--solo`` skips
the daemon and runs the solo reference.

    python -m gravity_tpu_torch.examples.gradient_orbit_fit \
        [--iters 300] [--steps 60] [--solo]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--steps", type=int, default=60,
                    help="integration steps over the flight")
    ap.add_argument("--solo", action="store_true",
                    help="run the library solver directly (no daemon)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.iters < 1 or args.steps < 1:
        ap.error("--iters and --steps must be >= 1")

    import numpy as np

    from gravity_tpu_torch.config import SimulationConfig
    from gravity_tpu_torch.serve.jobs.fit import fit_solo

    m_sun = 1.989e30
    r0 = 1.496e11  # launch radius = Earth's orbit
    flight_time = 8.0e6  # ~93 days
    dt = flight_time / args.steps
    # Target: 40 degrees ahead, half-way out toward Mars' orbit radius.
    theta = np.deg2rad(40.0)
    r_t = 1.85e11
    target = [r_t * np.cos(theta), r_t * np.sin(theta), 0.0]

    config = SimulationConfig(
        model="random", n=2, steps=args.steps, dt=dt,
        integrator="leapfrog", force_backend="dense", dtype="float64",
    )
    params = {
        # The Sun at rest and the probe at the launch radius; the
        # circular-speed guess the optimizer refines.
        "state": {
            "positions": [[0.0, 0.0, 0.0], [r0, 0.0, 0.0]],
            "velocities": [[0.0, 0.0, 0.0], [0.0, 2.98e4, 0.0]],
            "masses": [m_sun, 1.0],
        },
        # One observation: the target point at the final step, for the
        # probe only: the endpoint-miss loss.
        "observations": {
            "steps": [args.steps],
            "positions": [[target]],
        },
        "particles": [1],
        "optimizer": "gd",
        # Endpoint ~linear in v0 -> ~quadratic loss; lr ~ 0.7 / Hessian.
        "lr": 0.35 / (flight_time / r0) ** 2,
        "scale": r0,
        "iters": args.iters,
    }

    solo = fit_solo(config, dict(params), device=args.device)
    v_solo = np.asarray(solo["velocities"])[1]

    if args.solo:
        v, loss = v_solo, solo["loss"]
        served_note = "solo"
    else:
        # The served path: a real daemon on a throwaway spool, the fit
        # submitted over HTTP like any job.
        import json
        import tempfile

        from gravity_tpu_torch.serve import GravityDaemon, request, wait_for

        with tempfile.TemporaryDirectory() as spool:
            # slice_steps sized to ~8 optimizer iterations a round (fit
            # converts through slice_units).
            daemon = GravityDaemon(
                spool, slots=2, slice_steps=max(args.steps, 1) * 8,
                idle_sleep_s=0.01, device=args.device,
            )
            daemon.start()
            try:
                resp = request(spool, "POST", "/submit", {
                    "config": json.loads(config.to_json()),
                    "job_type": "fit",
                    "params": params,
                })
                assert "job" in resp, resp
                status = wait_for(spool, [resp["job"]], timeout=600)
                st = status[resp["job"]]
                if st["status"] != "completed":
                    print(f"served fit {st['status']}: {st.get('error')}")
                    return 1
                result = request(
                    spool, "GET", f"/result?job={resp['job']}"
                )
                v = np.asarray(result["velocities"])[1]
                loss = float(np.asarray(result["loss"]).ravel()[0])
            finally:
                daemon.stop()
        rel = np.max(
            np.abs(v - v_solo) / np.maximum(np.abs(v_solo), 1e-30)
        )
        served_note = f"served (vs solo max rel {rel:.2e})"
        if rel > 1e-5:
            print(f"SERVED/SOLO MISMATCH: {rel:.3e}")
            return 1

    miss_km = float(np.sqrt(loss)) * r0 / 1e3
    speed = float(np.linalg.norm(v))
    print(f"fitted launch velocity: {[round(float(x), 1) for x in v]} "
          f"m/s (|v| = {speed:.1f} m/s) [{served_note}]")
    print(f"endpoint miss: {miss_km:.3e} km over a "
          f"{flight_time / 86400:.0f}-day flight")
    ok = miss_km < 1.0e4  # within 10,000 km of the target
    print("FIT OK" if ok else "FIT DID NOT CONVERGE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
