"""Render a recorded trajectory (an npy shard directory or a native
``.gtrj`` file) as a PNG: first, middle and last frame scatter panels and
a handful of particle tracks. Counterpart of
``examples/plot_trajectory.py``; needs matplotlib, and no device.

    python -m gravity_tpu_torch.examples.plot_trajectory PATH \
        [--out plot.png] [--tracks 8]

PATH is a ``trajectories_*`` directory (npy shards) or a ``.gtrj`` file.
"""

from __future__ import annotations

import argparse
import os


def load(path):
    from gravity_tpu_torch.utils.trajectory import (
        NativeTrajectoryReader,
        TrajectoryReader,
    )

    reader = (NativeTrajectoryReader(path) if path.endswith(".gtrj")
              else TrajectoryReader(path))
    return reader.load(), list(reader.steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tracks", type=int, default=8)
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    traj, steps = load(args.path)
    t_frames = [0, traj.shape[0] // 2, traj.shape[0] - 1]
    fig, axes = plt.subplots(1, 4, figsize=(18, 4.6))
    lim = np.percentile(np.abs(traj), 99.5)
    for ax, t in zip(axes[:3], t_frames):
        ax.scatter(traj[t, :, 0], traj[t, :, 1], s=1.0, alpha=0.5,
                   linewidths=0)
        ax.set_title(f"step {steps[t]}")
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_aspect("equal")
    ax = axes[3]
    n = traj.shape[1]
    idx = np.linspace(0, n - 1, min(args.tracks, n)).astype(int)
    for i in idx:
        ax.plot(traj[:, i, 0], traj[:, i, 1], lw=0.8)
    ax.set_title(f"{len(idx)} particle tracks")
    ax.set_aspect("equal")
    fig.tight_layout()
    out = args.out or (
        os.path.splitext(args.path.rstrip("/"))[0] + ".png"
    )
    fig.savefig(out, dpi=130)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
