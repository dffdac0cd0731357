"""The simulation loop.

Counterpart of ``gravity_tpu/simulation.py`` for single-card runs of the
direct sum, its Gram form, the cutoff-radius cell list, the P3M solver and
the octree:
build the initial state, resolve the force backend, then run blocks
of steps, logging and recording between them. The JAX package jits a
``lax.scan`` per block; here a block is a Python loop over steps that
carries the ``(state, acc)`` pair the same way (``_block_fn``), and
PyTorch's asynchronous launches keep the card busy between the block
boundaries, where the host waits once.

The integration modes ride the same loop: multirate block timesteps
(their fast kicks through :func:`make_local_kernel`'s rectangular
kernels), an external field added after self-gravity, collision merging
at block boundaries every ``merge_every`` steps, and adaptive dt
(:meth:`Simulator.run_adaptive`, blocks of ``ops/adaptive.py``'s device
steps with one host read a block).
"""

from __future__ import annotations

import functools
import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .config import NotPortedError, SimulationConfig
from .interop import to_numpy
from .models import create_model
from .ops import diagnostics, direct_kernel, mxu_kernel, nlist, p3m, tree
from .ops.adaptive import adaptive_run
from .ops.direct_kernel import accelerations_vs_kernel
from .ops.encounters import (
    merge_close_pairs,
    merge_close_pairs_grid,
    merge_scan_chunk,
)
from .ops.external import parse_external
from .ops.forces import (
    accelerations_vs,
    pairwise_accelerations_chunked,
    rounded,
)
from .ops.mxu_kernel import accelerations_vs_mxu_kernel
from .ops.integrators import FORCE_EVALS_PER_STEP, make_step_fn
from .ops.multirate import (
    make_multirate_step_fn,
    make_rung_ladder_step_fn,
    rung_ladder_step,
    two_rung_step,
)
from .state import ParticleState
from .utils.logging import RunLogger
from .utils.platform import (
    DeviceLike,
    device_name,
    resolve_device,
    sync,
)
from .utils.trajectory import TrajectoryWriter

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}

# The resolved names of the hand-written CUDA direct-sum kernels.
KERNEL_BACKEND = "nbody_direct"
MXU_BACKEND = "nbody_mxu"
# Largest N the CPU runs as one dense (N, N) block.
DENSE_MAX_N = 4096
# From this N the collision-merge pass finds its candidates on the O(N)
# cell grid instead of the exact O(N^2) scan (ops/encounters.py), as in
# the JAX package.
MERGE_GRID_THRESHOLD = 32_768
# Above this N a tree or p3m run prices its energy with the octree's
# O(N log N) potential instead of the dense O(N^2) pair scan, as in the JAX
# package.
ENERGY_TREE_THRESHOLD = 16_384
# The launch count of each resolved backend's kernel on a state's dtype
# (p3m's is the cell-list kernel's ewald kind, which its gather pass does
# not launch; the tree's its untruncated newton form, which its gather near
# field does not launch; the cell list's bf16 form counts apart).
_LAUNCH_COUNTS = {
    KERNEL_BACKEND: lambda dtype: direct_kernel.LAUNCHES,
    MXU_BACKEND: lambda dtype: mxu_kernel.LAUNCHES,
    "nlist": lambda dtype: nlist.LAUNCHES[
        nlist.launch_key("newton", True, dtype)],
    "p3m": lambda dtype: nlist.LAUNCHES["ewald"],
    "tree": lambda dtype: nlist.LAUNCHES[
        nlist.launch_key("newton", False, dtype)],
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
    which runs the plain version for CPU tensors. ``pallas-mxu``, ``p3m``
    and ``tree`` are explicit opt-ins only. ``dense`` and ``chunked`` are the
    plain version on any device. ``auto`` does not route to the fast
    solvers: that is the autotuned router (ROADMAP Queue 1 item 8).
    A bf16 state takes the same route: the kernels' bf16 forms, the cell
    list's and the octree's near field through ``nlist_pair``'s (the
    config refuses bf16 with ``p3m``, as the JAX package's mesh FFT does).
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
    if backend in ("dense", "chunked", "nlist", "p3m", "tree"):
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


def _resolve_depth_and_warn(config: SimulationConfig, positions, where: str,
                            n=None) -> int:
    """The octree's depth (``tree_depth``, else fit to ``positions``, else
    to the count) and the cell-memory warning, in one place for every path
    that builds a tree."""
    depth = config.tree_depth or (
        tree.recommended_depth_data(positions, config.tree_leaf_cap)
        if positions is not None
        else tree.recommended_depth(config.n, config.tree_leaf_cap)
    )
    tree.warn_if_cell_memory_heavy(
        n if n is not None else config.n, depth, config.tree_leaf_cap,
        where,
        dtype_bytes={"float64": 8, "bfloat16": 2}.get(config.dtype, 4),
    )
    return depth


def _tree_kwargs(config: SimulationConfig, depth: int) -> dict:
    return dict(depth=depth, leaf_cap=config.tree_leaf_cap,
                ws=config.tree_ws, far=config.tree_far,
                chunk=config.fast_chunk, near_mode=config.tree_near,
                g=config.g, cutoff=config.cutoff, eps=config.eps)


def _occupancy_t_cap(cap: int, k_targets: int, n: int, positions,
                     side: int, where: str) -> int:
    """Target slots per cell for a ~K-target rectangular kick on a side^3
    grid: the mean occupancy with 4x headroom, or, from the concrete
    positions, the K fastest bodies landing in proportion to each cell's
    occupancy, so that the densest cell needs ~K * max_count / N slots
    (2x headroom). Warns when even the full cap cannot hold that load
    (the overflowing targets take the whole-cell monopole fallback)."""
    mean_based = max(4, -(-4 * cap * k_targets // max(1, n)))
    if positions is None:
        return min(cap, mean_based)
    pos = to_numpy(positions).astype(np.float64)
    lo = pos.min(axis=0)
    span = float(np.max(pos.max(axis=0) - lo)) or 1.0
    u = np.clip(
        ((pos - lo[None, :]) / span * side).astype(np.int64), 0, side - 1
    )
    ids = (u[:, 0] * side + u[:, 1]) * side + u[:, 2]
    max_count = int(np.bincount(ids, minlength=side**3).max())
    density_based = -(-2 * k_targets * max_count // max(1, n))
    if density_based > cap:
        warnings.warn(
            f"{where}: the densest cell holds {max_count} of {n} bodies; "
            f"~{density_based} fast-rung target slots would be needed "
            f"but the static cap is {cap} — a fraction of fast kicks "
            "will take the softened monopole fallback. Raise the cell "
            "cap or deepen the grid.",
            stacklevel=3,
        )
    return min(cap, max(mean_based, density_based))


def _make_nlist_kernel(config: SimulationConfig, positions=None,
                       k_targets=None):
    """The cell list's rectangular kernel; the K-target hint sizes its
    target slots per cell to the expected fast-rung occupancy
    (:func:`_occupancy_t_cap`), below the source cap."""
    side, cap = _resolve_nlist_config(config, positions)
    note = nlist.check_nlist_sizing(config.n, side, cap)
    if note:
        warnings.warn(note, stacklevel=3)
    t_cap = 0
    if k_targets is not None:
        t_cap = _occupancy_t_cap(cap, k_targets, config.n, positions, side,
                                 "nlist kernel")
    return nlist.make_nlist_local_kernel(
        rcut=config.nlist_rcut, side=side, cap=cap, t_cap=t_cap, g=config.g,
        cutoff=config.cutoff, eps=config.eps,
    )


def make_local_kernel(config: SimulationConfig, backend: str,
                      positions=None, k_targets=None):
    """The rectangular kernel ``(pos_targets (M, 3), pos_sources (K, 3),
    m_sources (K,)) -> (M, 3)`` of a resolved backend: the multirate fast
    kicks' (K, N) force. ``positions`` (the initial state) and
    ``k_targets`` (the targets a call) size the cell list's target
    slots. Forward only: backward passes are ROADMAP Queue 1 item 9."""
    common = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
    if backend in ("dense", "chunked"):
        # The rcut-masked sum where truncated physics is declared.
        if config.nlist_rcut > 0.0:
            common["rcut"] = config.nlist_rcut
        return functools.partial(accelerations_vs, **common)
    if backend == KERNEL_BACKEND:
        return direct_kernel.make_direct_local_kernel(**common)
    if backend == MXU_BACKEND:
        return mxu_kernel.make_mxu_local_kernel(**common)
    if backend == "nlist":
        return _make_nlist_kernel(config, positions, k_targets)
    if backend == "tree":
        depth = _resolve_depth_and_warn(config, positions, "tree kernel")
        return functools.partial(tree.tree_accelerations_vs,
                                 **_tree_kwargs(config, depth))
    if backend == "p3m":
        raise NotPortedError(
            "the rectangular kernel of force_backend='p3m' (multirate "
            "kicks through a fast solver) is not ported to "
            "gravity_tpu_torch yet (ROADMAP.md Queue 1 item 7, fast "
            "full-gravity solvers)"
        )
    raise ValueError(f"unknown force backend {backend!r}")


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
    """Orchestrates a run for a :class:`SimulationConfig`: fixed-dt
    (:meth:`run`) or adaptive (:meth:`run_adaptive`)."""

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
        # As-run octree depth, fit once to the initial state.
        self.tree_depth = None
        if self.backend == "tree":
            self.tree_depth = _resolve_depth_and_warn(
                config, state.positions, "tree backend", n=state.n)
        # The energy diagnostic's tree depth: the run's own, else resolved
        # at its first use.
        self._energy_tree_depth = self.tree_depth
        # The external field and its potential, parsed once; added after
        # the self-gravity of every evaluation.
        self._ext = self._ext_phi = None
        if config.external:
            self._ext = parse_external(config.external)
            self._ext_phi = parse_external(config.external, kind="potential")
        # The multirate fast kick: the backend's rectangular kernel, sized
        # for the fast rung's K targets, plus the external field.
        self._kick = None
        self.kick_sizing = None
        if config.integrator == "multirate":
            if config.multirate_k < 0 or config.multirate_sub < 1:
                raise ValueError(
                    "multirate_k must be >= 0 (0 = auto) and "
                    "multirate_sub >= 1; got "
                    f"k={config.multirate_k}, sub={config.multirate_sub}"
                )
            if not (2 <= config.multirate_rungs <= 6):
                # 6 rungs = 32 unrolled micro-steps.
                raise ValueError(
                    "multirate_rungs must be in [2, 6]; got "
                    f"{config.multirate_rungs}"
                )
            k, _ = self._multirate_plan()
            kick = make_local_kernel(config, self.backend,
                                     positions=state.positions, k_targets=k)
            self.kick_sizing = getattr(kick, "sizing", None)
            if self._ext is not None:
                ext = self._ext
                self._kick = lambda ti, sj, m: kick(ti, sj, m) + ext(ti)
            else:
                self._kick = kick

    def _self_accel(self, positions: torch.Tensor,
                    masses: torch.Tensor) -> torch.Tensor:
        """All-pairs self-gravity through the resolved backend."""
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
        if self.backend == "tree":
            return tree.tree_accelerations(
                positions, masses, **_tree_kwargs(c, self.tree_depth))
        if c.nlist_rcut > 0.0:
            # Declared truncated physics: the rcut-masked direct sum.
            common["rcut"] = c.nlist_rcut
        if self.backend == "dense":
            return accelerations_vs(positions, positions, masses, **common)
        return pairwise_accelerations_chunked(positions, masses,
                                              chunk=c.chunk, **common)

    def accel(self, positions: torch.Tensor,
              masses: torch.Tensor) -> torch.Tensor:
        """All-pairs accelerations through the resolved backend, plus the
        external field when one is configured."""
        acc = self._self_accel(positions, masses)
        if self._ext is not None:
            acc = acc + self._ext(positions)
        return acc

    def _multirate_plan(self):
        """(k, capacities | None): the fast-rung capacity (auto n // 8) and,
        for more than two rungs, the ladder k // 8^(r-1), guarded against
        exceeding n."""
        config = self.config
        n = self.state.n
        k = min(config.multirate_k or max(1, n // 8), n)
        rungs = config.multirate_rungs
        if rungs > 2:
            capacities = tuple(
                max(1, k // (8 ** (r - 1))) for r in range(1, rungs)
            )
            if sum(capacities) > n:
                raise ValueError(
                    f"rung capacities {capacities} (from "
                    f"multirate_k={k}, rungs={rungs}) exceed "
                    f"n={n}; lower multirate_k"
                )
            return k, capacities
        return k, None

    def _step_fn(self, masses: torch.Tensor):
        """``(state, acc) -> (state, acc)`` of the configured integrator.
        A multirate step reads the masses from the state it is given;
        the others bind ``masses``, so the run rebuilds them after a
        merge."""
        config = self.config
        if config.integrator == "multirate":
            k, capacities = self._multirate_plan()
            if capacities is not None:
                return make_rung_ladder_step_fn(
                    self._kick, config.dt, capacities=capacities,
                    accel_full=self.accel,
                )
            return make_multirate_step_fn(
                self._kick, config.dt, k=k, n_sub=config.multirate_sub,
                accel_full=self.accel,
            )
        return make_step_fn(config.integrator,
                            lambda pos: self.accel(pos, masses), config.dt)

    def merge_pass(self, state: ParticleState):
        """One collision check of ``state`` at ``merge_radius``: the grid
        form from :data:`MERGE_GRID_THRESHOLD` bodies, the exact chunked
        scan below it. Returns an ``ops.encounters.MergeResult``."""
        c = self.config
        if state.n >= MERGE_GRID_THRESHOLD:
            return merge_close_pairs_grid(state, c.merge_radius, k=c.merge_k)
        return merge_close_pairs(state, c.merge_radius, k=c.merge_k,
                                 chunk=merge_scan_chunk(state.n))

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

    def _launch_count(self):
        count = _LAUNCH_COUNTS.get(self.backend, lambda dtype: 0)
        return lambda: count(self.dtype)

    def _setup_accel(self) -> None:
        if self.backend == "p3m":
            # Step-invariant: the kernel transform, built once per run
            # (the JAX Simulator's accel-setup hook).
            self._p3m_khat = p3m.force_kernel_hat(
                2 * self.config.pm_grid, self.config.p3m_sigma_cells,
                self.dtype, self.device)

    def run(
        self,
        logger: Optional[RunLogger] = None,
        *,
        steps: Optional[int] = None,
        trajectory_writer: Optional[TrajectoryWriter] = None,
    ) -> dict:
        """Run the configured number of steps; returns a results dict.
        An adaptive config runs :meth:`run_adaptive` instead."""
        config = self.config
        if config.adaptive:
            return self.run_adaptive(logger,
                                     trajectory_writer=trajectory_writer)
        total_steps = config.steps if steps is None else steps
        # Frames are kept only when there is somewhere to put them.
        record = trajectory_writer is not None
        every = max(1, config.trajectory_every) if record else 1
        block = max(1, min(config.progress_every, total_steps))
        merging = config.merge_radius > 0.0
        if merging:
            # Collision checks happen at block boundaries; their cadence
            # is a physics knob (merge_every), not the logging cadence.
            block = max(1, min(block, config.merge_every))
        if record:
            # Block size must be a multiple of the recording stride.
            block = max(1, block // every) * every

        self._banner(logger, total_steps, config.integrator)
        state = self.state
        step_fn = self._step_fn(state.masses)
        count = self._launch_count()
        launches0 = count()
        self._setup_accel()
        # The first force evaluation loads (and, once per source, builds)
        # the kernel; it stays outside the timed loop.
        acc = self.accel(state.positions, state.masses)
        sync(self.device)
        t0 = time.perf_counter()
        step = 0
        steps_since_merge_check = 0
        merged_total = 0
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
                host = to_numpy(torch.stack(frames))
                for k in range(host.shape[0]):
                    trajectory_writer.record(
                        prev_step + (k + 1) * every, host[k]
                    )
            steps_since_merge_check += n_steps
            # The final block always checks, so that the returned state
            # holds no never-examined colliding pair.
            if merging and (steps_since_merge_check >= config.merge_every
                            or step >= total_steps):
                steps_since_merge_check = 0
                res = self.merge_pass(state)
                n_merged = int(res.n_merged)
                if n_merged > 0:
                    state = self.state = res.state
                    merged_total += n_merged
                    if logger is not None:
                        logger.log_print(
                            f"merged {n_merged} pair(s) at step {step} "
                            f"({merged_total} total)"
                        )
                    # The force reads the new masses from here on.
                    step_fn = self._step_fn(state.masses)
                    acc = self.accel(state.positions, state.masses)
        sync(self.device)
        total_time = time.perf_counter() - t0
        if trajectory_writer is not None:
            trajectory_writer.close()

        stats = self._stats(total_steps, total_time, count() - launches0)
        if self.nlist_sizing is not None:
            # The N(N-1) rate is what a dense sum would have needed;
            # evaluated_pairs_per_sec counts the pair-tile slots.
            side, cap, slots = self.nlist_sizing
            evals = total_steps * FORCE_EVALS_PER_STEP[config.integrator]
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
        if self.tree_depth is not None:
            stats.update({"tree_depth": self.tree_depth,
                          "tree_leaf_cap": config.tree_leaf_cap,
                          "tree_near": config.tree_near})
        if merging:
            stats["merged_pairs"] = merged_total
        return self._finish(logger, total_time, total_steps, stats)

    def _stats(self, steps: int, total_time: float, launches: int) -> dict:
        """The throughput keys shared by fixed-dt and adaptive runs."""
        n = self.n_real
        evals = steps * FORCE_EVALS_PER_STEP[self.config.integrator]
        pairs = n * (n - 1) * evals
        stats = {
            "n": n,
            "steps": steps,
            "total_time_s": total_time,
            "avg_step_s": total_time / max(steps, 1),
            "pair_interactions": pairs,
            "pairs_per_sec": pairs / total_time if total_time > 0 else None,
            "backend": self.backend,
            "device": device_name(self.device),
            "dtype": self.config.dtype,
            "kernel_launches": launches,
        }
        if self.config.integrator == "multirate":
            k, capacities = self._multirate_plan()
            stats["multirate_k"] = k
            if capacities is not None:
                stats["multirate_capacities"] = list(capacities)
            if self.kick_sizing is not None:
                stats["kick_t_cap"] = self.kick_sizing[2]
        return stats

    def run_adaptive(
        self,
        logger: Optional[RunLogger] = None,
        *,
        trajectory_writer: Optional[TrajectoryWriter] = None,
    ) -> dict:
        """Adaptive-dt run to t_end = steps * dt (``ops/adaptive.py``).

        The host drives blocks of ``adaptive_run`` steps (at most
        ``progress_every`` each) and reads ``(t, steps, dt range)`` once
        a block, as the JAX Simulator reads each ``while_loop`` block.
        Steps a block takes past t_end are exact no-ops that still cost a
        force evaluation (``adaptive_tail_steps`` in the stats), so a
        block's budget is also capped at the steps the remaining time
        needs at dt_max (the first block) or at the previous block's
        largest dt.
        Trajectory frames land at block boundaries. Checkpoints, the
        supervisor and the host writer pipeline are ROADMAP Queue 1 items
        2 and 3."""
        config = self.config
        if config.merge_radius > 0.0:
            raise ValueError(
                "adaptive mode does not support collision merging "
                "(merge_radius > 0); use fixed-dt runs for merging"
            )
        t_end = config.steps * config.dt
        criterion = config.timestep_criterion
        if criterion == "auto":
            criterion = "accel" if config.eps > 0.0 else "velocity"
        if config.integrator not in ("euler", "leapfrog", "multirate"):
            # "euler" is only the config default, not a request for
            # adaptive Euler.
            raise ValueError(
                f"adaptive mode integrates with KDK leapfrog (or the "
                f"multirate rung ladder); integrator="
                f"{config.integrator!r} is not supported "
                "(use fixed-dt runs for verlet/yoshida4)"
            )
        # Adaptive x multirate: the criterion sizes the outer dt from the
        # slow remainder (the k fastest excluded), the rungs subdivide it.
        step_fn = None
        exclude_fastest = 0
        mode = "adaptive-kdk"
        if config.integrator == "multirate":
            k, capacities = self._multirate_plan()
            exclude_fastest = k
            if capacities is not None:
                step_fn = functools.partial(
                    rung_ladder_step, accel_vs=self._kick,
                    capacities=capacities, accel_full=self.accel,
                )
                mode = (f"adaptive-multirate (rungs="
                        f"{config.multirate_rungs}, k={k})")
            else:
                step_fn = functools.partial(
                    two_rung_step, accel_vs=self._kick, k=k,
                    n_sub=config.multirate_sub, accel_full=self.accel,
                )
                mode = (f"adaptive-multirate (k={k}, "
                        f"sub={config.multirate_sub})")
        self._banner(logger, config.steps,
                     f"{mode} ({criterion}, eta={config.eta})")

        block_cap = max(1, min(config.progress_every,
                               config.adaptive_max_steps))
        t_end_cast = rounded(t_end, self.dtype)
        state = self.state
        masses = state.masses

        def accel_fn(positions):
            return self.accel(positions, masses)

        count = self._launch_count()
        launches0 = count()
        self._setup_accel()
        acc = accel_fn(state.positions)
        sync(self.device)
        t0_wall = time.perf_counter()
        t, comp = 0.0, 0.0
        steps_taken = tail_steps = 0
        dt_min, dt_max_used = math.inf, 0.0
        # The dt a block's budget is sized by: the ceiling at first (no
        # step can be longer, so the first block takes no tail step),
        # then the previous block's largest dt.
        dt_est = config.dt
        while t < t_end_cast and steps_taken < config.adaptive_max_steps:
            budget = min(block_cap, config.adaptive_max_steps - steps_taken,
                         max(1, math.ceil((t_end_cast - t) / dt_est)))
            res = adaptive_run(
                state, accel_fn, t_end=t_end, dt_max=config.dt,
                eta=config.eta, eps=config.eps, criterion=criterion,
                max_steps=budget, t0=t, comp0=comp, acc0=acc,
                step_fn=step_fn, exclude_fastest=exclude_fastest,
            )
            # The block's one host read.
            t, comp, b_min, b_max, block_steps = torch.stack([
                res.t.double(), res.comp.double(), res.dt_min.double(),
                res.dt_max_used.double(), res.steps.double(),
            ]).tolist()
            block_steps = int(block_steps)
            state, acc = res.state, res.acc
            tail_steps += budget - block_steps
            if block_steps > 0:
                dt_min = min(dt_min, b_min)
                dt_max_used = max(dt_max_used, b_max)
                dt_est = b_max
            if config.nan_check and not self._state_finite(state):
                if logger is not None:
                    logger.log_print(
                        f"DIVERGED during adaptive run (after "
                        f"{steps_taken} steps)"
                    )
                raise SimulationDiverged(steps_taken)
            steps_taken += block_steps
            self.state = state
            if logger is not None:
                logger.log_print(
                    f"t={t:.6g}/{t_end:.6g} ({steps_taken} adaptive "
                    f"steps, dt in [{b_min:.3g}, {b_max:.3g}])"
                )
            if trajectory_writer is not None and block_steps > 0:
                trajectory_writer.record(steps_taken,
                                         to_numpy(state.positions))
            if block_steps == 0:
                break  # t >= t_end in the state's dtype
        sync(self.device)
        total_time = time.perf_counter() - t0_wall
        if trajectory_writer is not None:
            trajectory_writer.close()

        stats = self._stats(steps_taken, total_time, count() - launches0)
        stats.update(
            t_end=t_end,
            t_reached=t,
            adaptive_steps=steps_taken,
            adaptive_tail_steps=tail_steps,
            dt_min=dt_min if dt_min != math.inf else None,
            dt_max_used=dt_max_used,
            criterion=criterion,
        )
        if steps_taken >= config.adaptive_max_steps and logger is not None:
            logger.log_print(
                f"WARNING: max_steps={config.adaptive_max_steps} hit at "
                f"t={t:.6g} of {t_end:.6g}"
            )
        return self._finish(logger, total_time, steps_taken, stats)

    def _banner(self, logger: Optional[RunLogger], steps: int,
                integrator_label: str) -> None:
        if logger is not None:
            logger.start_banner(
                platform="GPU" if self.device.type == "cuda" else "CPU",
                device=device_name(self.device),
                num_devices=1,
                num_particles=self.n_real,
                steps=steps,
                dt=self.config.dt,
                model=self.config.model,
                integrator=integrator_label,
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
            logger.final_positions(to_numpy(self.state.positions))
            logger.completed()
        stats["final_state"] = self.final_state()
        return stats

    def final_state(self) -> ParticleState:
        """The state of the real particles, on the run's device."""
        return self.state

    def energy(self):
        """Total conserved energy of the current state: kinetic plus the
        self-gravity potential plus, under ``external``, the field's
        potential energy.

        A tree or p3m run above :data:`ENERGY_TREE_THRESHOLD` bodies prices
        the potential with the octree (``ops/tree.py::
        tree_potential_energy``, at a depth resolved once a run) and
        returns a host ``np.float64`` (kinetic energy and the potential
        each in float64, since |PE| can pass fp32's range); the dense pair
        scan would cost ~5.5e11 pair evaluations at 1M bodies. This is the
        JAX package's CPU branch: on a TPU it takes the FMM's potential
        instead, which is not ported (ROADMAP Queue 1 item 7). Otherwise
        the plain O(N^2) sum, a device scalar in the state's dtype."""
        c = self.config
        state = self.final_state()
        if (self.backend not in ("tree", "p3m")
                or self.n_real <= ENERGY_TREE_THRESHOLD):
            return diagnostics.total_energy(
                state, g=c.g, cutoff=c.cutoff, eps=c.eps,
                external_phi=self._ext_phi,
            )
        if self._energy_tree_depth is None:
            self._energy_tree_depth = _resolve_depth_and_warn(
                c, state.positions, "energy diagnostic", n=self.n_real)
        e = diagnostics.kinetic_energy_f64(state) + tree.tree_potential_energy(
            state.positions, state.masses, depth=self._energy_tree_depth,
            leaf_cap=c.tree_leaf_cap, ws=c.tree_ws, chunk=c.fast_chunk,
            g=c.g, cutoff=c.cutoff, eps=c.eps,
        )
        if self._ext_phi is not None:
            e = e + np.float64(float(
                (state.masses * self._ext_phi(state.positions)).sum()))
        return e
