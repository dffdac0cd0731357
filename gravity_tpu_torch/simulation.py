"""The simulation loop.

Counterpart of ``gravity_tpu/simulation.py`` for the fixed-dt runs of the
direct sum, its Gram form, the cutoff-radius cell list and the P3M solver:
build the initial state, resolve the force backend, then run blocks
of steps, logging and recording between them. The JAX package jits a
``lax.scan`` per block; here a block is a Python loop over steps that
carries the ``(state, acc)`` pair the same way (``_block_fn``), and
PyTorch's asynchronous launches keep the card busy between the block
boundaries, where the host waits once.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import torch

from .config import SimulationConfig
from .models import create_model
from .ops import direct_kernel, mxu_kernel, nlist, p3m
from .ops.direct_kernel import accelerations_vs_kernel
from .ops.forces import accelerations_vs, pairwise_accelerations_chunked
from .ops.mxu_kernel import accelerations_vs_mxu_kernel
from .ops.integrators import FORCE_EVALS_PER_STEP, init_carry, make_step_fn
from .state import ParticleState
from .utils.logging import RunLogger
from .utils.platform import (
    DeviceLike,
    device_name,
    resolve_device,
    sync,
)
from .utils.trajectory import TrajectoryWriter

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# The resolved names of the hand-written CUDA direct-sum kernels.
KERNEL_BACKEND = "nbody_direct"
MXU_BACKEND = "nbody_mxu"
# Largest N the CPU runs as one dense (N, N) block.
DENSE_MAX_N = 4096
# The launch count of each resolved backend's kernel (p3m's is the
# cell-list kernel's ewald kind, which its gather pass does not launch).
_LAUNCH_COUNTS = {
    KERNEL_BACKEND: lambda: direct_kernel.LAUNCHES,
    MXU_BACKEND: lambda: mxu_kernel.LAUNCHES,
    "nlist": lambda: nlist.LAUNCHES["newton"],
    "p3m": lambda: nlist.LAUNCHES["ewald"],
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; choose from {sorted(_DTYPES)}")
    return _DTYPES[name]


def _resolve_backend(config: SimulationConfig, device: torch.device) -> str:
    """Resolve ``force_backend`` to the function that computes forces.

    ``nlist_rcut`` > 0 declares truncated physics: ``auto`` and ``direct``
    then take the rcut-masked plain direct sum (dense up to
    ``DENSE_MAX_N``, chunked above) on any device, never a full-gravity
    kernel; an explicit full-gravity backend warns, and ``nlist`` is the
    cell list. Otherwise ``auto``, ``direct`` and ``pallas`` take the
    CUDA direct-sum kernel on the card, at every N (the JAX package's
    n >= 1024 threshold is a TPU measurement and is not adopted). On the
    CPU, ``auto`` and ``direct`` take the plain version, dense or chunked;
    an explicit ``pallas`` or ``pallas-mxu`` keeps the kernel's wrapper,
    which runs the plain version for CPU tensors. ``pallas-mxu`` and
    ``p3m`` are explicit opt-ins only. ``dense`` and ``chunked`` are the
    plain version on any device. ``auto`` does not route to the fast
    solvers: that is the autotuned router (ROADMAP Queue 1 item 8).
    """
    backend = config.force_backend
    plain = "dense" if config.n <= DENSE_MAX_N else "chunked"
    if config.nlist_rcut > 0.0:
        if backend in ("auto", "direct"):
            return plain
        if backend not in ("nlist", "dense", "chunked"):
            warnings.warn(
                f"nlist_rcut={config.nlist_rcut:g} declares truncated "
                f"short-range physics, but force_backend={backend!r} "
                "computes FULL gravity and ignores it (only nlist/"
                "dense/chunked honor the rcut mask)",
                stacklevel=3,
            )
    if backend in ("dense", "chunked", "nlist", "p3m"):
        return backend
    if backend == "pallas-mxu":
        return MXU_BACKEND
    if backend == "pallas" or device.type == "cuda":
        return KERNEL_BACKEND
    return plain


def _resolve_nlist_config(config: SimulationConfig, positions):
    """The (side, cap) of the nlist backend: explicit config knobs win;
    otherwise they are fit to the initial positions
    (``ops/nlist.py::resolve_nlist_sizing``)."""
    if config.nlist_rcut <= 0.0:
        raise ValueError(
            "force_backend='nlist' needs nlist_rcut > 0 (--nlist-rcut): "
            "the cell-list kernel computes forces TRUNCATED at rcut — "
            "declared short-range physics, not an approximation of "
            "full gravity"
        )
    side, cap = config.nlist_side, config.nlist_cap
    if side and cap:
        return side, cap
    return nlist.resolve_nlist_sizing(positions, config.nlist_rcut, cap=cap,
                                      side=side)


def make_initial_state(config: SimulationConfig,
                       device: DeviceLike = None) -> ParticleState:
    """The run's initial state from its config: drawn from a CPU generator
    seeded with ``config.seed``, then moved to ``device``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(config.seed)
    return create_model(config.model, gen, config.n,
                        resolve_dtype(config.dtype),
                        device=resolve_device(device))


class SimulationDiverged(RuntimeError):
    """The state went NaN/Inf mid-run. Carries the last finite step."""

    def __init__(self, step: int):
        super().__init__(
            f"non-finite particle state detected after step {step} "
            "(divergence watchdog; rerun with a smaller dt or softer eps, "
            "or disable with nan_check=False)"
        )
        self.step = step


class Simulator:
    """Orchestrates a fixed-dt run for a :class:`SimulationConfig`."""

    def __init__(self, config: SimulationConfig,
                 state: Optional[ParticleState] = None, *,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(config.dtype)
        if state is None:
            state = make_initial_state(config, self.device)
        else:
            state = state.astype(self.dtype).to(self.device)
        self.state = state
        self.n_real = state.n
        self.backend = _resolve_backend(config, self.device)
        # As-run cell-list sizing (side, cap, pair-tile slots per force
        # evaluation), for nlist runs.
        self.nlist_sizing = None
        if self.backend == "nlist":
            side, cap = _resolve_nlist_config(config, state.positions)
            note = nlist.check_nlist_sizing(state.n, side, cap)
            if note:
                warnings.warn(note, stacklevel=2)
            self.nlist_sizing = (side, cap,
                                 nlist.evaluated_pairs_per_eval(side, cap))
        # As-run P3M sizing (binning side, cap, t_cap) and short-range
        # mode, and the kernel transform a run builds once (run()).
        self.p3m_sizing = None
        self._p3m_khat = None
        if self.backend == "p3m":
            note = p3m.check_p3m_sizing(
                state.n, config.pm_grid, config.p3m_sigma_cells,
                config.p3m_rcut_sigmas, config.p3m_cap,
                positions=state.positions,
            )
            if note:
                warnings.warn(note, stacklevel=2)
            side = p3m.binning_side(config.pm_grid, config.p3m_sigma_cells,
                                    config.p3m_rcut_sigmas)
            self.p3m_sizing = (side, config.p3m_cap, config.p3m_cap,
                               p3m.resolve_short_mode(config.p3m_short,
                                                      self.device))

    def accel(self, positions: torch.Tensor,
              masses: torch.Tensor) -> torch.Tensor:
        """All-pairs accelerations through the resolved backend."""
        c = self.config
        common = dict(g=c.g, cutoff=c.cutoff, eps=c.eps)
        if self.backend == KERNEL_BACKEND:
            return accelerations_vs_kernel(positions, positions, masses,
                                           **common)
        if self.backend == MXU_BACKEND:
            return accelerations_vs_mxu_kernel(positions, positions, masses,
                                               **common)
        if self.backend == "nlist":
            side, cap, _ = self.nlist_sizing
            return nlist.nlist_accelerations(
                positions, masses, rcut=c.nlist_rcut, side=side, cap=cap,
                **common,
            )
        if self.backend == "p3m":
            return p3m.p3m_accelerations(
                positions, masses, grid=c.pm_grid,
                sigma_cells=c.p3m_sigma_cells, rcut_sigmas=c.p3m_rcut_sigmas,
                cap=c.p3m_cap, chunk=c.fast_chunk, khat=self._p3m_khat,
                short_mode=c.p3m_short, **common,
            )
        if c.nlist_rcut > 0.0:
            # Declared truncated physics: the rcut-masked direct sum.
            common["rcut"] = c.nlist_rcut
        if self.backend == "dense":
            return accelerations_vs(positions, positions, masses, **common)
        return pairwise_accelerations_chunked(positions, masses,
                                              chunk=c.chunk, **common)

    def _block_fn(self, state: ParticleState, acc: torch.Tensor, step_fn, *,
                  n_steps: int, record_every: int = 0):
        """``n_steps`` steps from ``(state, acc)``; with ``record_every`` a
        (device) frame of positions every ``record_every`` steps."""
        frames = []
        for k in range(1, n_steps + 1):
            state, acc = step_fn(state, acc)
            if record_every and k % record_every == 0:
                frames.append(state.positions)
        return state, acc, frames

    def run(
        self,
        logger: Optional[RunLogger] = None,
        *,
        steps: Optional[int] = None,
        trajectory_writer: Optional[TrajectoryWriter] = None,
    ) -> dict:
        """Run the configured number of steps; returns a results dict."""
        config = self.config
        total_steps = config.steps if steps is None else steps
        # Frames are kept only when there is somewhere to put them.
        record = trajectory_writer is not None
        every = max(1, config.trajectory_every) if record else 1
        block = max(1, min(config.progress_every, total_steps))
        if record:
            # Block size must be a multiple of the recording stride.
            block = max(1, block // every) * every

        self._banner(logger, total_steps)
        state = self.state
        masses = state.masses

        def accel_fn(positions):
            return self.accel(positions, masses)

        step_fn = make_step_fn(config.integrator, accel_fn, config.dt)
        count = _LAUNCH_COUNTS.get(self.backend, lambda: 0)
        launches0 = count()
        if self.backend == "p3m":
            # Step-invariant: the kernel transform, built once per run
            # (the JAX Simulator's accel-setup hook).
            self._p3m_khat = p3m.force_kernel_hat(
                2 * config.pm_grid, config.p3m_sigma_cells, self.dtype,
                self.device)
        # The first force evaluation loads (and, once per source, builds)
        # the kernel; it stays outside the timed loop.
        acc = init_carry(accel_fn, state)
        sync(self.device)
        t0 = time.perf_counter()
        step = 0
        while step < total_steps:
            remaining = total_steps - step
            if record and remaining >= every:
                # Whole strides only; any sub-stride tail runs unrecorded.
                n_steps = min(block, (remaining // every) * every)
                record_every = every
            else:
                n_steps = min(block, remaining)
                record_every = 0
            state, acc, frames = self._block_fn(
                state, acc, step_fn, n_steps=n_steps,
                record_every=record_every,
            )
            prev_step, step = step, step + n_steps
            # One fence per block: the finite check reads a device value.
            if config.nan_check and not self._state_finite(state):
                if logger is not None:
                    logger.log_print(
                        f"DIVERGED within steps {prev_step + 1}..{step}; "
                        f"last finite state is at step {prev_step}"
                    )
                raise SimulationDiverged(prev_step)
            sync(self.device)
            self.state = state
            if logger is not None:
                logger.progress(step, total_steps)
            if frames:
                host = torch.stack(frames).cpu().numpy()
                for k in range(host.shape[0]):
                    trajectory_writer.record(
                        prev_step + (k + 1) * every, host[k]
                    )
        sync(self.device)
        total_time = time.perf_counter() - t0
        if trajectory_writer is not None:
            trajectory_writer.close()

        n = self.n_real
        evals = total_steps * FORCE_EVALS_PER_STEP[config.integrator]
        pairs = n * (n - 1) * evals
        stats = {
            "n": n,
            "steps": total_steps,
            "total_time_s": total_time,
            "avg_step_s": total_time / max(total_steps, 1),
            "pair_interactions": pairs,
            "pairs_per_sec": pairs / total_time if total_time > 0 else None,
            "backend": self.backend,
            "device": device_name(self.device),
            "dtype": config.dtype,
            "kernel_launches": count() - launches0,
        }
        if self.nlist_sizing is not None:
            # The N(N-1) rate is what a dense sum would have needed;
            # evaluated_pairs_per_sec counts the pair-tile slots.
            side, cap, slots = self.nlist_sizing
            stats.update({
                "dense_equiv_pairs_per_sec": stats["pairs_per_sec"],
                "nlist_side": side,
                "nlist_cap": cap,
                "evaluated_pairs_per_sec": (slots * evals / total_time
                                            if total_time > 0 else None),
            })
        if self.p3m_sizing is not None:
            side, cap, t_cap, mode = self.p3m_sizing
            stats.update({"p3m_side": side, "p3m_cap": cap,
                          "p3m_t_cap": t_cap, "p3m_short": mode,
                          "pm_grid": config.pm_grid})
        return self._finish(logger, total_time, total_steps, stats)

    def _banner(self, logger: Optional[RunLogger], steps: int) -> None:
        if logger is not None:
            logger.start_banner(
                platform="GPU" if self.device.type == "cuda" else "CPU",
                device=device_name(self.device),
                num_devices=1,
                num_particles=self.n_real,
                steps=steps,
                dt=self.config.dt,
                model=self.config.model,
                integrator=self.config.integrator,
                backend=self.backend,
                dtype=self.config.dtype,
            )

    @staticmethod
    def _state_finite(state: ParticleState) -> bool:
        return bool(
            torch.isfinite(state.positions).all()
            & torch.isfinite(state.velocities).all()
        )

    def _finish(self, logger: Optional[RunLogger], total_time: float,
                steps: int, stats: dict) -> dict:
        """Shared run epilogue: perf log, final positions, results dict."""
        if logger is not None:
            logger.performance(
                total_time, steps, pairs_per_sec=stats["pairs_per_sec"]
            )
            logger.final_positions(self.state.positions.cpu().numpy())
            logger.completed()
        stats["final_state"] = self.final_state()
        return stats

    def final_state(self) -> ParticleState:
        """The state of the real particles, on the run's device."""
        return self.state
