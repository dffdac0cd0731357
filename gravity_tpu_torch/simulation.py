"""The simulation loop.

Counterpart of ``gravity_tpu/simulation.py`` for runs of the
direct sum, its Gram form, the cutoff-radius cell list, the P3M solver,
the octree, the fast multipole solver in its dense and sparse layouts and
the particle-mesh solver, isolated or in a periodic box (with the
minimum-image cell list the box's other solver):
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

With ``config.sharding`` the run is one rank of a ``torch.distributed``
world (``parallel/``): its rows of the padded state, the force the
sharded direct sum over the backend's rectangular kernel, or for the cell
list and P3M's near field on a single-axis mesh the halo slab engine
(``parallel/halo.py``, ``nlist_mesh``), what is global gathered
(:class:`Simulator`). Multirate and adaptive runs step a rank's rows
(``ops/multirate.py``'s sharded forms, the adaptive criterion over the
gathered state); the FMM splits its cell passes over the world
(``parallel/sharded_fmm.py``). A mesh run's checkpoint is the solo
payload: the real bodies of the gathered state, written by rank 0 while
every rank waits at a barrier, so that ``resume`` reads it onto a world of
any size, one included.

The run loop's host side is the JAX package's ``_run_impl`` contract: the
depth-1 block pipeline (``io_pipeline``: block k+1 is queued before block
k is consumed, and block k is consumed by waiting on its own CUDA event),
with ``host_gap_frac``; integrity-checked checkpoints, emergency saves on
divergence and on SIGTERM (:class:`SimulationPreempted`) and resume from
``start_step``; the in-program conservation ledger and the accuracy
sentinel (:class:`AccuracyBreach`), both queued right behind their block
and read through its fence.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import signal
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import autotune, parallel
from .config import SimulationConfig
from .interop import to_numpy
from .models import create_model
from .ops import (
    diagnostics,
    direct_kernel,
    fmm,
    host_kernel,
    mxu_kernel,
    nlist,
    p3m,
    periodic,
    pm,
    sfmm,
    tree,
)
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
    accelerations_vs_chunked,
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
from .telemetry import perf as _perf
from .utils import faults
from .utils.checkpoint import crossed_cadence, save_checkpoint
from .utils.logging import RunLogger
from .utils.platform import (
    DeviceLike,
    device_name,
    resolve_device,
    sync,
)
from .utils.profiling import (
    full_set_probe_kernel,
    make_force_error_probe,
    sentinel_indices,
    sentinel_summary,
)
from .utils.timing import HostGapTimer, pairs_metric_name, pairs_per_step
from .utils.trajectory import (
    AsyncTrajectoryWriter,
    TrajectoryWriter,
    record_frames,
)

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
# The large-N potential of the energy diagnostic and the ledger, by device
# type: the octree's on the CPU (the JAX package's branch off the TPU,
# measured faster there); on the card the faster of the octree's and the
# FMM's at the 1M disk (chip_smoke.py phase ledger_tree_path times both;
# PERF.md section 5).
LARGE_N_POTENTIAL = {"cpu": "tree", "cuda": "fmm"}
# The FMM's multirate kicks below this K x N take the exact plain (K, N)
# sum, cheaper than any grid pass at that size (the JAX package's bound).
DENSE_KICK_BUDGET = 1 << 25
# The JAX package's names of the resolved kernel backends (fault specs and
# the supervisor's degrade ladder use them).
JAX_NAMES = {KERNEL_BACKEND: "pallas", MXU_BACKEND: "pallas-mxu"}
# The launch count of each resolved backend's kernel on a state's dtype
# (cpp's the calls of the host-native C++ row sum; p3m's is the cell-list
# kernel's ewald kind, which its gather pass does not launch; the tree's
# its untruncated newton form, which its gather near field does not
# launch; the cell list's bf16 form counts apart; the halo
# slab engine's launches, cubic for a multirate kick, slab for the full
# force, count together).
_LAUNCH_COUNTS = {
    KERNEL_BACKEND: lambda dtype: direct_kernel.LAUNCHES,
    MXU_BACKEND: lambda dtype: mxu_kernel.LAUNCHES,
    "cpp": lambda dtype: host_kernel.LAUNCHES,
    "nlist": lambda dtype: sum(nlist.LAUNCHES[k + form] for k in (
        nlist.launch_key("newton", True, dtype),) for form in ("", "/slab")),
    "p3m": lambda dtype: nlist.LAUNCHES["ewald"] + nlist.LAUNCHES[
        "ewald/slab"],
    "tree": lambda dtype: nlist.LAUNCHES[
        nlist.launch_key("newton", False, dtype)],
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; choose from {sorted(_DTYPES)}")
    return _DTYPES[name]


def _resolve_direct(config: SimulationConfig, on_card: bool) -> str:
    """The exact direct sum of the static route, by its force_backend
    name: with ``nlist_rcut`` > 0 (declared truncated physics) the
    rcut-masked plain sum on any device, dense up to ``DENSE_MAX_N`` and
    chunked above (``pallas`` and ``cpp`` compute full gravity and would
    change the physics); otherwise ``pallas``, the CUDA kernel, on the
    card at every N (the JAX package's n >= 1024 threshold is a TPU
    measurement and is not adopted). On the CPU, as in the JAX package:
    dense up to ``DENSE_MAX_N``, then ``cpp``, the host-native C++ row
    sum, for a float32 or float64 state wherever its library builds
    (``ops/host_kernel.host_forces_available``: a g++ build of a second
    or so at its first use, cached), else chunked."""
    plain = "dense" if config.n <= DENSE_MAX_N else "chunked"
    if config.nlist_rcut > 0.0:
        return plain
    if on_card:
        return "pallas"
    if (plain == "chunked" and config.dtype in ("float32", "float64")
            and host_kernel.host_forces_available()):
        return "cpp"
    return plain


def _resolve_backend(config: SimulationConfig, device: torch.device) -> str:
    """Resolve ``force_backend`` statically to the function that computes
    forces.

    ``auto`` and ``direct`` take :func:`_resolve_direct`'s exact direct
    sum; with ``nlist_rcut`` > 0 an explicit full-gravity backend warns,
    and ``nlist`` is the cell list. ``pallas`` and ``pallas-mxu`` name the
    CUDA kernels, whose wrappers run the plain version for CPU tensors;
    ``dense`` and ``chunked`` are the plain version on any device;
    ``cpp`` is the host-native C++ direct sum (the CPU only);
    ``nlist``, ``p3m``, ``tree``, ``fmm`` and ``sfmm`` are themselves (the
    FMM's layout is the Simulator's to resolve). A Simulator's plain
    ``auto`` asks the autotuner first (:func:`_resolve_backend_for_run`),
    which may route to the Gram form, the cell list or the octree.
    A bf16 state takes the same route: the kernels' bf16 forms, the cell
    list's and the octree's near field through ``nlist_pair``'s (the
    config refuses bf16 with ``p3m``, as the JAX package's mesh FFT does).
    A periodic ``auto`` is ``nlist`` with ``nlist_rcut`` > 0 (the periodic
    member of the truncated family), else ``pm``.
    """
    backend = config.force_backend
    if backend == "auto" and config.periodic_box > 0.0:
        return "nlist" if config.nlist_rcut > 0.0 else "pm"
    if config.nlist_rcut > 0.0 and backend not in (
            "auto", "direct", "nlist", "dense", "chunked"):
        warnings.warn(
            f"nlist_rcut={config.nlist_rcut:g} declares truncated "
            f"short-range physics, but force_backend={backend!r} "
            "computes FULL gravity and ignores it (only nlist/"
            "dense/chunked honor the rcut mask)",
            stacklevel=4,
        )
    if backend in ("auto", "direct"):
        backend = _resolve_direct(config, device.type == "cuda")
    if backend == "pallas-mxu":
        return MXU_BACKEND
    if backend == "pallas":
        return KERNEL_BACKEND
    return backend


def _resolve_backend_for_run(config: SimulationConfig, state,
                             device: torch.device) -> tuple:
    """(resolved backend, autotune decision) for a Simulator about to run.

    Plain ``auto`` with ``autotune`` on consults the measured tuning cache
    (``autotune.py``): at once on a hit, by a probe of the eligible
    candidates on a miss. Everything else keeps the static route with an
    ``off`` decision. A candidate's error once it runs propagates: routing
    does not go on by another route that would hide a kernel (the JAX
    package falls back to the static route on any error). A periodic run
    keeps the static route: pm and nlist are its only solvers. On a mesh
    every rank probes and takes rank 0's verdict, whose composite cell-list
    candidate (``nlist@halo``, ``nlist@allgather``) carries the mesh
    strategy the Simulator pins (``autotune._candidate_config``)."""
    if (config.force_backend != "auto" or not config.autotune
            or config.periodic_box > 0.0):
        return _resolve_backend(config, device), \
            autotune.off(config.force_backend)
    decision = autotune.resolve_backend_measured(config, state,
                                                 device=device)
    chosen = autotune._candidate_config(config, decision.backend)
    backend = _resolve_backend(chosen, device)
    if backend == "sfmm" and config.sharding != "none":
        # Auto on a mesh takes the dense layout's name (the JAX package's
        # simulation.py:284-291); its fmm_mode="auto" occupancy decision
        # still routes a clustered state to the chunk-sharded sparse form.
        backend = "fmm"
    return backend, decision


def _resolve_nlist_config(config: SimulationConfig, positions):
    """The (side, cap) of the nlist backend: explicit config knobs win;
    otherwise they are fit to the initial positions
    (``ops/nlist.py::resolve_nlist_sizing``). With no positions (a serve
    key's kernels, sized blind at admission) the side must be given and
    the cap defaults to ``nlist.DEFAULT_CAP``, as in the JAX package."""
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
    if positions is None:
        if not side:
            raise ValueError(
                "nlist sizing needs concrete initial positions or an "
                "explicit --nlist-side (serve jobs must set it: no state "
                "exists at admission)"
            )
        return side, cap or nlist.DEFAULT_CAP
    return nlist.resolve_nlist_sizing(positions, config.nlist_rcut, cap=cap,
                                      side=side, box=config.periodic_box)


def _resolve_halo_nlist_config(config: SimulationConfig, positions,
                               devices: int):
    """:func:`_resolve_nlist_config` for the slab decomposition: the side
    splits into whole cell planes a rank, fit by
    ``parallel.halo.resolve_halo_sizing``; an explicit ``nlist_side`` is
    checked, never rounded (the solo and halo forms agree on what ran)."""
    if config.nlist_rcut <= 0.0:
        raise ValueError(
            "force_backend='nlist' needs nlist_rcut > 0 (--nlist-rcut): "
            "the cell-list kernel computes forces TRUNCATED at rcut — "
            "declared short-range physics, not an approximation of "
            "full gravity"
        )
    side, cap = config.nlist_side, config.nlist_cap
    if side and side % devices:
        raise ValueError(
            f"halo nlist needs --nlist-side divisible by the mesh axis "
            f"size; got side={side}, devices={devices} (round it, or "
            "set nlist_mesh='allgather')"
        )
    if side and cap:
        return side, cap
    return parallel.resolve_halo_sizing(
        positions, config.nlist_rcut, cap=cap, devices=devices, side=side,
        box=config.periodic_box)


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
        cutoff=config.cutoff, eps=config.eps, box=config.periodic_box,
    )


def _make_host_kernel(config: SimulationConfig, device: DeviceLike):
    """The ``cpp`` backend's rectangular kernel (the JAX package's
    ``make_local_kernel`` cpp branch): a ``ValueError`` off the CPU or for
    a dtype other than float32/float64, before anything is built, and
    :class:`~.utils.faults.BackendUnavailable` where the library does not
    build (the supervisor degrades it to ``chunked``). Never a quiet move
    of the run to another device or backend."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cpu":
        raise ValueError(
            "force_backend='cpp' (the host-native C++ direct sum) runs on "
            f"the CPU, not on {device}; on the card use 'pallas', or pass "
            "--device cpu")
    if config.dtype not in ("float32", "float64"):
        raise ValueError(
            f"force_backend='cpp' supports float32/float64, not "
            f"{config.dtype!r}")
    if not host_kernel.host_forces_available():
        raise faults.BackendUnavailable(
            "cpp", f"g++ build failed: {host_kernel.unavailable_reason()}")
    return host_kernel.make_host_local_kernel(
        g=config.g, cutoff=config.cutoff, eps=config.eps)


def make_local_kernel(config: SimulationConfig, backend: str,
                      positions=None, k_targets=None, *,
                      device: DeviceLike = None):
    """The rectangular kernel ``(pos_targets (M, 3), pos_sources (K, 3),
    m_sources (K,)) -> (M, 3)`` of a resolved backend: the multirate fast
    kicks' (K, N) force, and a rank's (n_local, N) block on a mesh.
    ``positions`` (the initial state) and ``k_targets`` (the targets a
    call) size the target slots of the cell list and of P3M's near field
    (P3M's on its own binning grid). Differentiable where the JAX
    package's is: the plain sums and the octree, FMM and PM by PyTorch's
    own differentiation, the ``pallas``, ``pallas-mxu`` and isolated
    ``nlist`` kernels and ``cpp`` through the dense backward
    (``ops/forces.py::DenseVJP``); P3M's cell-list near field and the
    octree's ``nlist`` near field raise on the card where a gradient is
    asked of them, as their ``pallas_call`` has no autodiff rule in JAX.
    On a mesh the sharded FMM forms differentiate through their gathers,
    and the halo engine with a box with respect to its positions; an
    isolated halo engine and the masses through any halo engine raise, as
    the JAX form's ``pmin``/``pmax`` have no rule.
    ``device`` is the device of the arrays the kernel will take, read by
    ``cpp`` alone (the CPU's; ``None`` is the default device, the
    card's)."""
    common = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
    if backend in ("dense", "chunked"):
        # The rcut-masked sum where truncated physics is declared.
        if config.nlist_rcut > 0.0:
            common["rcut"] = config.nlist_rcut
        if backend == "chunked":
            # A rank's (n_local, N) block or a (K, N) kick, config.chunk
            # targets at a time, as the unsharded chunked sum runs.
            return functools.partial(accelerations_vs_chunked,
                                     chunk=config.chunk, **common)
        return functools.partial(accelerations_vs, **common)
    if backend == KERNEL_BACKEND:
        return direct_kernel.make_direct_local_kernel(**common)
    if backend == MXU_BACKEND:
        return mxu_kernel.make_mxu_local_kernel(**common)
    if backend == "cpp":
        return _make_host_kernel(config, device)
    if backend == "nlist":
        return _make_nlist_kernel(config, positions, k_targets)
    if backend == "tree":
        depth = _resolve_depth_and_warn(config, positions, "tree kernel")
        return functools.partial(tree.tree_accelerations_vs,
                                 **_tree_kwargs(config, depth))
    if backend in ("fmm", "sfmm"):
        # Both layouts kick through the dense grid's rectangular form: the
        # fast targets are few and binned anew each call, where the sparse
        # compaction would cost more than it saves (the JAX package's
        # choice).
        if k_targets is not None and k_targets * config.n <= DENSE_KICK_BUDGET:
            return functools.partial(accelerations_vs, **common)
        depth = _resolve_depth_and_warn(config, positions, "fmm kernel")
        t_cap = 0
        if k_targets is not None:
            t_cap = _occupancy_t_cap(config.tree_leaf_cap, k_targets,
                                     config.n, positions, 1 << depth,
                                     "fmm kernel")
        return functools.partial(fmm.fmm_accelerations_vs, depth=depth,
                                 leaf_cap=config.tree_leaf_cap,
                                 ws=config.tree_ws, t_cap=t_cap, **common)
    if backend == "pm":
        kw = dict(grid=config.pm_grid, g=config.g, eps=config.eps,
                  assignment=config.pm_assignment)
        if config.periodic_box > 0.0:
            return functools.partial(periodic.pm_periodic_accelerations_vs,
                                     box=config.periodic_box, **kw)
        return functools.partial(pm.pm_accelerations_vs, **kw)
    if backend == "p3m":
        note = p3m.check_p3m_sizing(
            config.n, config.pm_grid, config.p3m_sigma_cells,
            config.p3m_rcut_sigmas, config.p3m_cap, positions=positions)
        if note:
            warnings.warn(note, stacklevel=2)
        side = p3m.binning_side(config.pm_grid, config.p3m_sigma_cells,
                                config.p3m_rcut_sigmas)
        t_cap = 0
        if k_targets is not None:
            # The cell-list and slice passes cost their target slots, not
            # K: size them to the K-target occupancy of the binning grid
            # the kernel itself runs on.
            t_cap = _occupancy_t_cap(config.p3m_cap, k_targets, config.n,
                                     positions, side, "p3m kernel")
        kernel = functools.partial(
            p3m.p3m_accelerations_vs, grid=config.pm_grid,
            sigma_cells=config.p3m_sigma_cells,
            rcut_sigmas=config.p3m_rcut_sigmas, cap=config.p3m_cap,
            chunk=config.fast_chunk, short_mode=config.p3m_short,
            t_cap=t_cap, **common)
        kernel.sizing = (side, config.p3m_cap, t_cap or config.p3m_cap)
        return kernel
    raise ValueError(f"unknown force backend {backend!r}")


def make_initial_state(config: SimulationConfig,
                       device: DeviceLike = None) -> ParticleState:
    """The run's initial state from its config: drawn from a CPU generator
    seeded with ``config.seed``, then moved to ``device`` (the grf lattice
    over the run's periodic box)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(config.seed)
    return create_model(config.model, gen, config.n,
                        resolve_dtype(config.dtype),
                        device=resolve_device(device),
                        periodic_box=config.periodic_box)


class SimulationDiverged(RuntimeError):
    """The state went NaN/Inf mid-run. Carries the last finite step."""

    def __init__(self, step: int):
        super().__init__(
            f"non-finite particle state detected after step {step} "
            "(divergence watchdog; rerun with a smaller dt or softer eps, "
            "or disable with nan_check=False)"
        )
        self.step = step


class AccuracyBreach(RuntimeError):
    """The accuracy sentinel measured a force error past the declared
    ``error_budget``. The state is finite: nothing rolls back; the
    supervisor heals by re-sizing the tree's leaf cap or rerouting to an
    exact direct sum, and continues from the last consumed block. A run
    without the supervisor exits 2."""

    def __init__(self, step: int, backend: str, p90_rel_err: float,
                 budget: float):
        super().__init__(
            f"accuracy breach at step {step}: backend {backend!r} "
            f"sentinel p90 relative force error {p90_rel_err:.3e} "
            f"exceeds the error budget {budget:.3e} (raise the budget, "
            "re-size the solver, or run with --auto-recover to heal)"
        )
        self.step = step
        self.backend = backend
        self.p90_rel_err = p90_rel_err
        self.budget = budget


class SimulationPreempted(KeyboardInterrupt):
    """SIGTERM (a scheduler's preemption) as an exception. A
    ``KeyboardInterrupt``, so that it takes the run loops' checkpoint-and-
    re-raise path of Ctrl-C; the CLI exits with the resumable code 75."""


@contextlib.contextmanager
def preemption_guard():
    """SIGTERM raises :class:`SimulationPreempted` inside the block, and
    the previous handler is restored after it. The handler only raises:
    the checkpoint is written on the run loop's ``except`` path, from the
    last consumed block. A no-op outside the main thread, where Python
    delivers no signals."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _handler(signum, frame):
        raise SimulationPreempted("SIGTERM received (preemption)")

    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        yield
        return
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory. On the card it is queued on the
    current stream into pinned memory (``non_blocking``), so that it runs
    behind the work before it and completes by the next event recorded
    there; on the CPU a plain copy."""
    if t.device.type == "cuda":
        out = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                          pin_memory=True)
        out.copy_(t.detach(), non_blocking=True)
        return out
    return t.detach().clone()


def _host_state(state: ParticleState) -> ParticleState:
    return ParticleState(_to_host(state.positions),
                         _to_host(state.velocities), _to_host(state.masses))


@dataclasses.dataclass
class _Block:
    """A dispatched block and its companions: host copies queued behind
    it (the watchdog's verdict, trajectory frames, a checkpoint snapshot
    where the block crosses the cadence, the ledger's components, the
    sentinel's errors) and the CUDA event recorded after them."""

    prev_step: int
    n_steps: int
    state: ParticleState
    finite: Optional[torch.Tensor] = None
    frames: Optional[torch.Tensor] = None
    snapshot: Optional[ParticleState] = None
    save_due: bool = False
    ledger: Optional[dict] = None
    sentinel: Optional[torch.Tensor] = None
    event: Optional["torch.cuda.Event"] = None

    @property
    def end_step(self) -> int:
        return self.prev_step + self.n_steps

    def wait(self) -> None:
        """Wait for this block (and its companions) alone: its own event,
        never the whole device, so the block queued after it keeps
        running."""
        if self.event is not None:
            self.event.synchronize()



def _p3m_halo_side(config: SimulationConfig, mesh) -> int:
    """The near-field cell side the JAX package's halo-sharded P3M would
    run on this mesh (``binning_side`` rounded down to a multiple of the
    devices), or 0 where the slab form does not fit (a two-axis mesh, or
    fewer whole cell planes than devices)."""
    if len(mesh.shape) != 1:
        return 0
    devices = mesh.shape[0]
    side = p3m.binning_side(config.pm_grid, config.p3m_sigma_cells,
                            config.p3m_rcut_sigmas)
    side = (side // devices) * devices
    return side if side >= max(devices, 2) else 0


def _check_mesh_backend(config: SimulationConfig, backend: str) -> None:
    """The JAX Simulator's refusal on a mesh: the ring cannot build a
    global tree, grid or cell list."""
    if config.sharding == "ring" and backend in (
            "tree", "fmm", "sfmm", "pm", "p3m", "nlist"):
        raise ValueError(
            f"force backend {backend!r} needs the full source set per "
            "chip to build its tree/mesh; use sharding='allgather'")


def _nlist_mesh_strategy(config: SimulationConfig, mesh) -> str:
    """The mesh strategy of the cell-list family (nlist, P3M's near
    field): ``halo`` (the slab decomposition) or ``allgather``. ``auto``
    takes halo wherever the slab form applies, a single-axis mesh of two
    or more ranks; ``halo`` insists (an error elsewhere); ``allgather``
    pins the gather of the world."""
    applicable = (mesh is not None and len(mesh.shape) == 1
                  and mesh.shape[0] >= 2)
    if config.nlist_mesh == "halo":
        if not applicable:
            raise ValueError(
                "nlist_mesh='halo' needs a single-axis mesh with >= 2 "
                "devices (the slab decomposition runs over one mesh axis)")
        return "halo"
    if config.nlist_mesh == "allgather" or not applicable:
        return "allgather"
    return "halo"


class Simulator:
    """Orchestrates a run for a :class:`SimulationConfig`: fixed-dt
    (:meth:`run`) or adaptive (:meth:`run_adaptive`).

    With ``config.sharding`` set the run is one rank of a
    ``torch.distributed`` world (``parallel/``; a world of one when no
    launcher made one): every rank draws the same initial state, pads it
    to a multiple of the mesh size with zero-mass bodies and keeps its own
    rows in ``self.state``; the force is the sharded direct sum over the
    backend's rectangular kernel, or the halo slab engine of the cell list
    and of P3M's near field (:func:`_nlist_mesh_strategy`). The
    watchdog's verdict is an
    ``all_reduce``, and what is global (the final state, trajectory
    frames, the ledger, the sentinel, the merge pass, :meth:`energy`) is
    gathered to every rank; the caller lets rank 0 alone write."""

    def __init__(self, config: SimulationConfig,
                 state: Optional[ParticleState] = None, *,
                 device: DeviceLike = None):
        self.config = config
        self.mesh = None
        if config.sharding != "none":
            self.mesh = parallel.make_particle_mesh(config.mesh_shape,
                                                    device=device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.dtype = resolve_dtype(config.dtype)
        if state is None:
            state = make_initial_state(config, self.device)
        else:
            state = state.astype(self.dtype).to(self.device)
        self.n_real = state.n
        # Plain auto routes through the autotuner, which probes its
        # candidates on this initial state; its verdict (cache, probe time,
        # timings, errors, skips) is an "off" decision for other backends.
        self.backend, self.autotune_decision = \
            _resolve_backend_for_run(config, state, self.device)
        if "@" in self.autotune_decision.backend:
            # A composite mesh candidate's winner pins its strategy, so the
            # build below takes the program the probe measured.
            self.config = config = dataclasses.replace(
                config, nlist_mesh=self.autotune_decision.backend.split(
                    "@", 1)[1])
        # The slab decomposition's ranks (0 off it) and P3M's near-field
        # side on it.
        self._halo_devices = self._p3m_halo_side = 0
        if self.mesh is not None:
            _check_mesh_backend(config, self.backend)
            # Sizing reads the padded global state, as the JAX package's
            # reads its sharded global array: every rank builds the same
            # grid and buckets.
            state, _ = state.pad_to(
                math.ceil(state.n / self.mesh.size) * self.mesh.size)
            if self.backend in ("nlist", "p3m") and _nlist_mesh_strategy(
                    config, self.mesh) == "halo":
                if self.backend == "nlist":
                    self._halo_devices = self.mesh.size
                else:
                    self._p3m_halo_side = _p3m_halo_side(config, self.mesh)
                    if self._p3m_halo_side:
                        self._halo_devices = self.mesh.size
                    elif config.nlist_mesh == "halo":
                        raise ValueError(
                            "nlist_mesh='halo' on sharded p3m needs the "
                            "near-field cell grid to fit >= 1 whole cell "
                            "plane per device; this mesh cannot host the "
                            "slab form — set nlist_mesh='allgather' (or "
                            "shrink the mesh)")
        self.state = state
        # The padded count: the multirate plan's n, as the JAX package's
        # reads its sharded global array.
        self.n_padded = state.n
        if config.periodic_box > 0.0 and self.backend not in ("pm", "nlist"):
            raise ValueError(
                "periodic_box > 0 needs a periodic-capable solver — "
                "'pm' (full gravity, FFT) or 'nlist' (truncated "
                f"short-range, minimum-image cell list); got "
                f"{JAX_NAMES.get(self.backend, self.backend)!r} — "
                "tree/p3m/direct backends are isolated-BC"
            )
        # Injected unbuildable backends (utils/faults.py) fail here, where
        # the JAX package builds its kernels; the host-native C++ direct
        # sum builds here too, and raises BackendUnavailable where it
        # cannot (its refusals off the CPU and for bf16 come first).
        faults.check_backend(config.force_backend, self.backend,
                             JAX_NAMES.get(self.backend, self.backend))
        self._host_kernel = None
        if self.backend == "cpp":
            self._host_kernel = _make_host_kernel(config, self.device)
        # As-run cell-list sizing (side, cap, pair-tile slots per force
        # evaluation), for nlist runs: on the slab decomposition its
        # D-divisible side, and the migration buckets' capacity.
        self.nlist_sizing = self.nlist_mig_cap = None
        if self.backend == "nlist":
            if self._halo_devices:
                side, cap = _resolve_halo_nlist_config(
                    config, state.positions, self._halo_devices)
                self.nlist_mig_cap = config.nlist_mig_cap or \
                    parallel.resolve_mig_cap(state.positions, side,
                                             self._halo_devices,
                                             box=config.periodic_box)
            else:
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
            mode = p3m.resolve_short_mode(config.p3m_short, self.device)
            if self._halo_devices:
                side, mode = self._p3m_halo_side, "halo"
            self.p3m_sizing = (side, config.p3m_cap, config.p3m_cap, mode)
        # As-run octree depth, fit once to the initial state.
        self.tree_depth = None
        if self.backend == "tree":
            self.tree_depth = _resolve_depth_and_warn(
                config, state.positions, "tree backend", n=state.n)
        # As-run FMM layout (fmm_sparse), the dense grid's depth and the
        # sparse sizing (depth, cap, effective k_cells, k_chunk), resolved
        # once from the initial state on the host.
        self.fmm_sparse = self.fmm_depth = self.sfmm_sizing = None
        self.fmm_setup_s = None
        if self.backend in ("fmm", "sfmm"):
            t0 = time.perf_counter()
            self._resolve_fmm(state.positions)
            self.fmm_setup_s = time.perf_counter() - t0
        # The energy diagnostic's tree depth: the run's own, else resolved
        # at its first use.
        self._energy_tree_depth = self.tree_depth or self.fmm_depth
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
                                     positions=state.positions, k_targets=k,
                                     device=self.device)
            self.kick_sizing = getattr(kick, "sizing", None)
            if self.backend == "p3m":
                kick = self._with_run_khat(kick)
            if self.mesh is not None:
                # The sharded fast rung: the K replicated targets against
                # each rank's rows, summed over the ranks.
                kick = parallel.make_sharded_rect_accel(self.mesh, kick)
            if self._ext is not None:
                ext = self._ext
                self._kick = lambda ti, sj, m: kick(ti, sj, m) + ext(ti)
            else:
                self._kick = kick
        # The sharded force (the halo slab engine, or the sharded direct
        # sum over the backend's rectangular kernel: the JAX package's
        # generic mesh branch), then this rank's rows of the padded state.
        self._sharded = None
        if self.mesh is not None:
            self._sharded = self._mesh_accel(state)
            self.state = parallel.shard_state(state, self.mesh)
        self._build_observatory()
        # The performance observatory: the block the run loop, run_block
        # (bench, the autotuner's probe) and the perf gate go through.
        # Each (n_steps, record_every, n, dtype, device) signature's first
        # call counts one step's flops, bytes and transcendentals and
        # measures its peak device bytes into the perf ledger, beside the
        # pair model's one-step flops (JAX simulation.py:1208-1262); a
        # rank's row counts its own (n_local, N) block.
        _perf.warm(self.device)
        # Rows name the backend as the JAX package does (pallas, not
        # nbody_direct), so that the two packages' keys agree.
        n, name = state.n, JAX_NAMES.get(self.backend, self.backend)
        self._run_block = _perf.InstrumentedBlock(
            self._block_fn, site="solo_block",
            key=_perf.logical_key(
                "solo", backend=name, n=n, dtype=config.dtype,
                integrator=config.integrator,
                sharding=config.sharding if self.mesh is not None else None),
            backend=name, n=n,
            analytic=_perf.analytic_flops(
                self.backend, n,
                force_evals=FORCE_EVALS_PER_STEP.get(config.integrator, 1),
                evaluated_pairs=(self.nlist_sizing[2]
                                 if self.nlist_sizing is not None
                                 else None),
                targets=self.state.n),
        )

    def _mesh_accel(self, state: ParticleState):
        """``accel2(pos_l, m_l)`` of this mesh run: the cell list's halo
        slab engine; P3M's far field by the allgather of its mesh pass (a
        global FFT has no slab locality) plus its erfc near field on the
        halo engine (``kind="ewald"``, alpha and rcut following the global
        cube); the FMM's sharded forms at the as-run layout and sizing;
        else the sharded direct sum over the backend's rectangular
        kernel."""
        config = self.config
        common = dict(g=config.g, cutoff=config.cutoff, eps=config.eps)
        if self._halo_devices and self.backend == "nlist":
            side, cap, _ = self.nlist_sizing
            return parallel.make_halo_nlist_accel(
                self.mesh, side=side, cap=cap, rcut=config.nlist_rcut,
                box=config.periodic_box, mig_cap=self.nlist_mig_cap,
                **common)
        if self._halo_devices:  # p3m
            grid, sc = config.pm_grid, config.p3m_sigma_cells

            def far_local(targets, sources, m_src):
                origin, span = pm.bounding_cube(sources)
                return p3m._mesh_accelerations(
                    targets, sources, m_src, origin, span, grid=grid,
                    g=config.g, sigma_cells=sc, khat=self._p3m_khat)

            far = parallel.make_sharded_accel2(
                self.mesh, strategy="allgather", local_kernel=far_local)
            near = parallel.make_halo_nlist_accel(
                self.mesh, side=self._p3m_halo_side, cap=config.p3m_cap,
                kind="ewald", ewald_scales=(
                    (grid - 1) / (math.sqrt(2.0) * sc),
                    config.p3m_rcut_sigmas * sc / (grid - 1)),
                **common)
            return lambda p, m: far(p, m) + near(p, m)
        if self.backend in ("fmm", "sfmm"):
            # The replicated build with the cell passes split over the
            # world (parallel/sharded_fmm.py).
            fmm_kw = dict(ws=config.tree_ws, **common)
            if self.fmm_sparse:
                depth, cap, k_eff, k_chunk = self.sfmm_sizing
                return parallel.make_sharded_sfmm_accel(
                    self.mesh, depth=depth, leaf_cap=cap, k_cells=k_eff,
                    k_chunk=k_chunk, **fmm_kw)
            return parallel.make_sharded_fmm_accel(
                self.mesh, depth=self.fmm_depth,
                leaf_cap=config.tree_leaf_cap, **fmm_kw)
        local = make_local_kernel(config, self.backend,
                                  positions=state.positions,
                                  device=self.device)
        if self.backend == "p3m":
            local = self._with_run_khat(local)
        return parallel.make_sharded_accel2(
            self.mesh, strategy=config.sharding, local_kernel=local)

    def _with_run_khat(self, kernel):
        """P3M's rectangular ``kernel`` with the run's kernel transform
        (built once, :meth:`_setup_accel`) instead of one built every
        call."""
        def with_khat(targets, positions, masses):
            return kernel(targets, positions, masses, khat=self._p3m_khat)
        return with_khat

    def _resolve_fmm(self, positions) -> None:
        """The FMM's layout and sizing: sparse for ``sfmm`` or
        ``fmm_mode="sparse"``; with ``auto`` the occupancy decision
        (``sfmm.sfmm_auto_decision``, on a mesh of the gathered state),
        whose sizing the build reuses when no depth is forced."""
        config = self.config
        sizing = None
        sparse = self.backend == "sfmm" or config.fmm_mode == "sparse"
        if self.backend == "fmm" and config.fmm_mode == "auto":
            sparse, sizing = sfmm.sfmm_auto_decision(positions,
                                                     config.tree_leaf_cap)
        self.fmm_sparse = bool(sparse)
        if not sparse:
            self.fmm_depth = _resolve_depth_and_warn(
                config, positions, "fmm backend", n=self.n_real)
            return
        if sizing is not None and not config.tree_depth:
            depth, cap, k_cells, _ = sizing
        else:
            depth, cap, k_cells = sfmm.resolve_sfmm_sizing(
                positions, config.tree_depth, config.tree_leaf_cap)
        # The EFFECTIVE k and chunk width the solver runs with, what the
        # audits replay: on a mesh the chunk count divides the world
        # (sfmm.sharded_k_sizing), off it k is rounded to whole chunks.
        if self.mesh is not None:
            k_eff, k_chunk, _ = sfmm.sharded_k_sizing(k_cells,
                                                      self.mesh.size)
        else:
            k_eff = sfmm.effective_k_cells(k_cells)
            k_chunk = sfmm.DEFAULT_K_CHUNK
        self.sfmm_sizing = (depth, cap, k_eff, k_chunk)

    def _fmm_stats(self) -> dict:
        if self.fmm_sparse:
            depth, cap, k_cells, k_chunk = self.sfmm_sizing
            return {"fmm_mode": "sparse", "fmm_depth": depth,
                    "fmm_leaf_cap": cap, "sfmm_k_cells": k_cells,
                    "sfmm_k_chunk": k_chunk,
                    "fmm_setup_s": self.fmm_setup_s}
        return {"fmm_mode": "dense", "fmm_depth": self.fmm_depth,
                "fmm_leaf_cap": self.config.tree_leaf_cap,
                "fmm_setup_s": self.fmm_setup_s}

    def _large_n_potential(self):
        """(pe_kind, pe_dev) of the energy's and the ledger's large-N
        potential on this device (:data:`LARGE_N_POTENTIAL`): ``pe_dev(pos,
        m)`` queues the scaled sum and its mass scale, at the depth resolved
        once a Simulator."""
        c = self.config
        depth = self._ledger_tree_depth()
        if LARGE_N_POTENTIAL[self.device.type] == "fmm":
            def pe_dev(pos, m):
                return fmm._fmm_pe_scaled(
                    pos, m, depth=depth, leaf_cap=c.tree_leaf_cap,
                    ws=c.tree_ws, g=c.g, cutoff=c.cutoff, eps=c.eps)
            return "fmm", pe_dev

        def pe_dev(pos, m):
            return tree._tree_pe_scaled(
                pos, m, depth=depth, leaf_cap=c.tree_leaf_cap,
                chunk=c.fast_chunk, ws=c.tree_ws, cutoff=c.cutoff,
                eps=c.eps, quad=True)
        return "tree", pe_dev

    def _ledger_tree_depth(self) -> int:
        """The depth of the ledger's large-N tree potential: the energy
        diagnostic's, resolved once a Simulator."""
        if self._energy_tree_depth is None:
            self._energy_tree_depth = _resolve_depth_and_warn(
                self.config, self.state.positions, "energy ledger",
                n=self.n_real)
        return self._energy_tree_depth

    def make_ledger(self, chunk: int = 4096):
        """(device_fn, convert, pe_kind) of the conservation ledger:
        ``device_fn(state)`` queues the ledger's components on the state's
        device (a dict of device scalars), ``convert(components)`` gives
        the float64 host ledger (``ops/diagnostics.ledger_host``).

        The potential term is the JAX package's: the exact pair scan
        (``pe_hat_dense``, a pair scan of ``chunk`` targets at a time) up
        to ``LEDGER_DENSE_MAX`` bodies and for every truncated (rcut) run,
        its shifted kernel there; above it the large-N potential of this
        device (:meth:`_large_n_potential`: the octree's on the CPU, as the
        JAX package off the TPU; the FMM's on the card, as the JAX package
        on its accelerator). Full periodic gravity takes the mesh potential
        the solver integrates (``pm``: ``periodic._potential_core`` over
        mean-mass weights), and a truncated run in a box the minimum-image
        pair scan. With an external field the ledger adds its potential
        energy."""
        config = self.config
        truncated = config.nlist_rcut > 0.0 and self.backend in (
            "nlist", "dense", "chunked")
        rcut = config.nlist_rcut if truncated else 0.0
        if config.periodic_box > 0.0 and not truncated:
            def pe_dev(pos, m):
                mw, m_mean = periodic.mean_mass_weights(m)
                return periodic._potential_core(
                    pos, mw, config.periodic_box, grid=config.pm_grid,
                    g=config.g, eps=config.eps,
                    assignment=config.pm_assignment), m_mean
            pe_kind = "pm"
        elif truncated or self.n_real <= diagnostics.LEDGER_DENSE_MAX:
            def pe_dev(pos, m):
                return diagnostics.pe_hat_dense(
                    pos, m, cutoff=config.cutoff, eps=config.eps,
                    rcut=rcut, box=config.periodic_box,
                    chunk=chunk), diagnostics.mass_scale(m)
            pe_kind = "dense"
        else:
            pe_kind, pe_dev = self._large_n_potential()
        ext_phi = self._ext_phi

        def device_fn(st: ParticleState) -> dict:
            pe, scale = pe_dev(st.positions, st.masses)
            out = {"vec": diagnostics.ledger_vec(
                       st.positions, st.velocities, st.masses),
                   "pe": pe, "pe_scale": scale}
            if ext_phi is not None:
                m_hat = st.masses / diagnostics.mass_scale(st.masses)
                out["ext"] = (m_hat * ext_phi(st.positions)).sum()
            return out

        def convert(dev: dict) -> dict:
            return diagnostics.ledger_host(
                dev["vec"], dev.get("pe"), dev.get("pe_scale"), g=config.g,
                pe_kind=pe_kind, ext=dev.get("ext"))

        return device_fn, convert, pe_kind

    def ledger_of(self, state: Optional[ParticleState] = None,
                  chunk: int = 4096) -> dict:
        """The host ledger of ``state`` (the current one by default), with
        its ``pe_kind``: a fenced, one-off evaluation."""
        device_fn, convert, pe_kind = self.make_ledger(chunk)
        out = convert(device_fn(self.global_state(self.state)
                                if state is None else state))
        out["pe_kind"] = pe_kind
        return out

    def _build_observatory(self) -> None:
        """The conservation ledger and the accuracy sentinel of this run,
        each a function of a block's final state that the run loop queues
        right behind the block (``config.ledger``; ``metrics_energy`` is
        its deprecated alias; ``sentinel_every``, forced to 1 by an
        ``error_budget`` with no cadence)."""
        config = self.config
        self._ledger_on = bool(config.ledger or config.metrics_energy)
        if config.metrics_energy and not config.ledger:
            warnings.warn(
                "--metrics-energy is a deprecated alias for the in-program "
                "conservation ledger (--ledger)", DeprecationWarning,
                stacklevel=3)
        sent_every = int(config.sentinel_every or 0)
        if config.error_budget > 0.0 and sent_every <= 0:
            # A declared budget with no cadence watches every block.
            sent_every = 1
        self._sentinel_every = sent_every
        self._ledger_fn = self._ledger_convert = self._sentinel_fn = None
        self.ledger_pe_kind = None
        if self._ledger_on:
            self._ledger_fn, self._ledger_convert, self.ledger_pe_kind = \
                self.make_ledger()
        truncated = config.nlist_rcut > 0.0 and self.backend in (
            "nlist", "dense", "chunked")
        if sent_every > 0 and config.periodic_box > 0.0 and not truncated:
            warnings.warn(
                "accuracy sentinel disabled: full periodic gravity has no "
                "exact direct-sum oracle (the minimum-image reference only "
                "covers the rcut-truncated nlist family)",
                stacklevel=3,
            )
            self._sentinel_every = sent_every = 0
        if sent_every > 0:
            idx = sentinel_indices(self.n_real, config.sentinel_k,
                                   config.seed)
            # The run's own self-gravity on the whole state, its K sampled
            # rows against the exact oracle: one extra force evaluation a
            # probe.
            self._sentinel_fn = make_force_error_probe(
                full_set_probe_kernel(self.global_self_accel, idx), idx=idx,
                g=config.g, cutoff=config.cutoff, eps=config.eps,
                rcut=config.nlist_rcut if truncated else 0.0,
                box=config.periodic_box if truncated else 0.0)

    @property
    def autotune(self) -> dict:
        """The routing facts of the run stats: ``{"cache", "probe_ms"}``."""
        d = self.autotune_decision
        return {"cache": d.cache, "probe_ms": round(d.probe_ms, 3)}

    def _self_accel(self, positions: torch.Tensor,
                    masses: torch.Tensor) -> torch.Tensor:
        """All-pairs self-gravity through the resolved backend; on a mesh,
        of this rank's rows (a collective)."""
        if self._sharded is not None:
            return self._sharded(positions, masses)
        c = self.config
        common = dict(g=c.g, cutoff=c.cutoff, eps=c.eps)
        if self.backend == KERNEL_BACKEND:
            return accelerations_vs_kernel(positions, positions, masses,
                                           **common)
        if self.backend == MXU_BACKEND:
            return accelerations_vs_mxu_kernel(positions, positions, masses,
                                               **common)
        if self._host_kernel is not None:
            return self._host_kernel(positions, positions, masses)
        if self.backend == "nlist":
            side, cap, _ = self.nlist_sizing
            return nlist.nlist_accelerations(
                positions, masses, rcut=c.nlist_rcut, side=side, cap=cap,
                box=c.periodic_box, **common,
            )
        if self.backend == "pm":
            kw = dict(grid=c.pm_grid, assignment=c.pm_assignment, g=c.g,
                      eps=c.eps)
            if c.periodic_box > 0.0:
                return periodic.pm_periodic_accelerations(
                    positions, masses, box=c.periodic_box, **kw)
            return pm.pm_accelerations(positions, masses, **kw)
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
        if self.fmm_sparse:
            depth, cap, k_cells, k_chunk = self.sfmm_sizing
            return sfmm.sfmm_accelerations(
                positions, masses, depth=depth, leaf_cap=cap,
                k_cells=k_cells, k_chunk=k_chunk, ws=c.tree_ws, **common)
        if self.fmm_sparse is not None:
            return fmm.fmm_accelerations(
                positions, masses, depth=self.fmm_depth,
                leaf_cap=c.tree_leaf_cap, ws=c.tree_ws, **common)
        if c.nlist_rcut > 0.0:
            # Declared truncated physics: the rcut-masked direct sum.
            common["rcut"] = c.nlist_rcut
        if self.backend == "dense":
            return accelerations_vs(positions, positions, masses, **common)
        return pairwise_accelerations_chunked(positions, masses,
                                              chunk=c.chunk, **common)

    def global_self_accel(self, positions: torch.Tensor,
                          masses: torch.Tensor) -> torch.Tensor:
        """:meth:`_self_accel` of a whole (padded) state, on every rank: on
        a mesh each rank evaluates its rows and the results are gathered
        (a collective), so that audits and the sentinel see the run's own
        sharded force."""
        if self.mesh is None:
            return self._self_accel(positions, masses)
        mine = parallel.shard_state(ParticleState(
            positions, torch.zeros_like(positions), masses), self.mesh)
        return parallel.mesh.all_gather_rows(self._self_accel(
            mine.positions, mine.masses))[:positions.shape[0]]

    def global_state(self, state: ParticleState) -> ParticleState:
        """The whole (padded) state of a rank's rows, on every rank; the
        state itself off a mesh."""
        if self.mesh is None:
            return state
        return parallel.replicate_state(state, self.mesh)

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
        n = self.n_padded
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
                    accel_full=self.accel, mesh=self.mesh,
                )
            return make_multirate_step_fn(
                self._kick, config.dt, k=k, n_sub=config.multirate_sub,
                accel_full=self.accel, mesh=self.mesh,
            )
        return make_step_fn(config.integrator,
                            lambda pos: self.accel(pos, masses), config.dt)

    def merge_pass(self, state: ParticleState):
        """One collision check of ``state`` at ``merge_radius``: the grid
        form from :data:`MERGE_GRID_THRESHOLD` bodies, the exact chunked
        scan below it. Returns an ``ops.encounters.MergeResult``."""
        c = self.config
        if state.n >= MERGE_GRID_THRESHOLD:
            return merge_close_pairs_grid(state, c.merge_radius, k=c.merge_k,
                                          box=c.periodic_box)
        return merge_close_pairs(state, c.merge_radius, k=c.merge_k,
                                 chunk=merge_scan_chunk(state.n),
                                 box=c.periodic_box)

    def _block_fn(self, state: ParticleState, acc: torch.Tensor, step_fn, *,
                  n_steps: int, record_every: int = 0):
        """``n_steps`` steps from ``(state, acc)``; with ``record_every`` a
        (device) frame of positions every ``record_every`` steps. A
        periodic run re-wraps its positions once a block (the forces are
        wrap-invariant: this guards precision over long drifts)."""
        frames = []
        for k in range(1, n_steps + 1):
            state, acc = step_fn(state, acc)
            if record_every and k % record_every == 0:
                frames.append(state.positions)
        return self._wrap(state), acc, frames

    def _wrap(self, state: ParticleState) -> ParticleState:
        """Positions mod the periodic box (``jnp.mod`` is
        ``torch.remainder``); the state itself when isolated."""
        box = self.config.periodic_box
        if box <= 0.0:
            return state
        return state.replace(positions=torch.remainder(
            state.positions, rounded(box, state.positions.dtype)))

    def initial_carry(self, state: Optional[ParticleState] = None):
        """The first force evaluation of ``state`` (the run's by default):
        the ``acc`` of the ``(state, acc)`` carry, after the step-invariant
        set-up (P3M's kernel transform)."""
        state = self.state if state is None else state
        self._setup_accel()
        return self.accel(state.positions, state.masses)

    def run_block(self, state: ParticleState, acc: torch.Tensor, *,
                  n_steps: int):
        """``n_steps`` steps from ``(state, acc)`` with no logger, frames,
        divergence check or fence: the block ``bench`` and the autotuner's
        probe time (the JAX package's ``_run_block(..., record=False)``).
        Returns the new ``(state, acc)``; the caller synchronises."""
        state, acc, _ = self._run_block(state, acc,
                                        self._step_fn(state.masses),
                                        n_steps=n_steps)
        return state, acc

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

    def _resolve_io_pipeline(self) -> bool:
        """True when this run drives the depth-1 host pipeline: queue block
        k+1, then consume block k while k+1 runs. ``auto`` means on, except
        with collision merging, whose pass edits the live state at block
        boundaries (the block in flight would integrate the state from
        before the merge); ``on`` with merging raises."""
        mode = self.config.io_pipeline
        if mode == "off":
            return False
        if self.config.merge_radius > 0.0:
            if mode == "on":
                raise ValueError(
                    "io_pipeline='on' does not compose with collision "
                    "merging (merge_radius > 0): the merge pass edits "
                    "the live state at block boundaries, which the "
                    "in-flight block would ignore; use io_pipeline="
                    "'auto' (degrades to the serial loop) or 'off'"
                )
            return False
        return True

    @staticmethod
    def _make_host_pipeline(trajectory_writer, checkpoint_manager,
                            enabled: bool, tracer=None,
                            trace_id: Optional[str] = None):
        """(host_writer, trajectory_writer, submit_save): with ``enabled``
        and any I/O consumer, trajectory records and checkpoint saves go
        through one bounded-queue :class:`~gravity_tpu_torch.utils.hostio.
        HostWriter` (the checksum and the write off the critical path);
        otherwise ``host_writer`` is None and saves run inline. With a
        ``tracer``, every save emits a ``checkpoint`` span, timed where
        it runs (the writer's thread under the pipeline)."""
        host_writer = None
        if enabled and (trajectory_writer is not None
                        or checkpoint_manager is not None):
            from .utils.hostio import HostWriter

            host_writer = HostWriter()
            if trajectory_writer is not None:
                trajectory_writer = AsyncTrajectoryWriter(trajectory_writer,
                                                          host_writer)

        def _save(at_step, at_state, extra=None):
            t0 = time.time()
            save_checkpoint(checkpoint_manager, at_step, at_state,
                            extra=extra)
            if tracer is not None:
                tracer.emit("checkpoint", trace_id, t0, time.time() - t0,
                            step=at_step)

        def submit_save(at_step, at_state, extra=None):
            if host_writer is not None:
                host_writer.submit(_save, at_step, at_state, extra=extra)
            else:
                _save(at_step, at_state, extra=extra)

        return host_writer, trajectory_writer, submit_save

    def _dispatch_companions(self, state: ParticleState, frames: list, *,
                             prev_step: int, n_steps: int, save_due: bool,
                             ledger_due: bool, sentinel_due: bool,
                             finite_due: bool) -> _Block:
        """Queue a block's companions behind it, then its event. Nothing
        here waits for the card."""
        blk = _Block(prev_step, n_steps, state)
        if finite_due:
            finite = (torch.isfinite(state.positions).all()
                      & torch.isfinite(state.velocities).all())
            if self.mesh is not None:
                # One verdict for every rank, so that all stop together.
                finite = parallel.mesh.all_ranks_true(finite)
            blk.finite = _to_host(finite)
        if frames:
            stacked = torch.stack(frames)
            if self.mesh is not None:
                # The frames' particle axis gathered, padding dropped.
                stacked = parallel.mesh.all_gather_rows(
                    stacked.transpose(0, 1)).transpose(0, 1)[:, :self.n_real]
            blk.frames = _to_host(stacked)
        if save_due:
            blk.save_due = True
            blk.snapshot = self._checkpoint_state(state, queued=True)
        whole = (self.global_state(state) if ledger_due or sentinel_due
                 else None)
        if ledger_due:
            blk.ledger = {k: _to_host(v)
                          for k, v in self._ledger_fn(whole).items()}
        if sentinel_due:
            blk.sentinel = _to_host(self._sentinel_fn(whole.positions,
                                                      whole.masses))
        if state.positions.device.type == "cuda":
            # Recorded even with nothing queued: waiting on it is how the
            # loop observes the block's completion.
            blk.event = torch.cuda.Event()
            blk.event.record()
        return blk

    def run(
        self,
        logger: Optional[RunLogger] = None,
        *,
        steps: Optional[int] = None,
        trajectory_writer: Optional[TrajectoryWriter] = None,
        checkpoint_manager=None,
        metrics_logger=None,
        start_step: int = 0,
        telemetry=None,
    ) -> dict:
        """Run the configured number of steps (from ``start_step`` on a
        resume); returns a results dict. An adaptive config runs
        :meth:`run_adaptive` instead. SIGTERM raises
        :class:`SimulationPreempted` through the same checkpoint-and-exit
        path as Ctrl-C, so that a preempted run can be resumed.

        ``telemetry`` (a :class:`~gravity_tpu_torch.telemetry.Telemetry`
        bundle; CLI ``--trace`` or ``--error-budget``) gives the run a
        trace id (``stats["trace_id"]``) and the serving stack's span
        structure: a ``block`` span for each consumed block, timed on the
        host when the loop has waited for the block's own event (no sync
        is added), ``checkpoint`` spans from the host writer and
        ``sentinel`` spans; and flight-recorder records with dumps on
        divergence, an accuracy breach and SIGTERM. Adaptive runs take
        none of it."""
        with preemption_guard():
            return self._run_impl(
                logger, steps=steps, trajectory_writer=trajectory_writer,
                checkpoint_manager=checkpoint_manager,
                metrics_logger=metrics_logger, start_step=start_step,
                telemetry=telemetry,
            )

    def _checkpoint_state(self, state: ParticleState, *,
                          queued: bool = False) -> Optional[ParticleState]:
        """The payload of a checkpoint of ``state``: the real bodies of the
        global state, the payload a solo run writes. On a mesh it is
        gathered from every rank (a collective) and kept by rank 0 alone
        (None elsewhere). ``queued``: a host copy queued behind the block
        (written once the block's event has passed) where the write itself
        may go to the host writer, a solo run or a world of one; else the
        state on its device, which the write copies."""
        if self.mesh is not None:
            whole = self.global_state(state)
            if self.mesh.rank != 0:
                return None
            state = ParticleState(*(t[:self.n_real] for t in (
                whole.positions, whole.velocities, whole.masses)))
        if queued and (self.mesh is None or self.mesh.size == 1):
            return _host_state(state)
        return state

    def _save_checkpoint(self, manager, step: int,
                         snapshot: Optional[ParticleState],
                         extra: Optional[dict] = None, *,
                         submit=None) -> None:
        """Write a :meth:`_checkpoint_state` snapshot at ``step``. A solo
        run or a world of one writes through ``submit`` (the host writer)
        when given. On a world of more than one rank 0 writes in place and
        every rank then waits at a barrier that also carries the write's
        outcome (one ``all_reduce``), so that no rank goes on before the
        snapshot is whole and a failed write fails every rank."""
        world = self.mesh.size if self.mesh is not None else 1
        if world == 1 and submit is not None:
            submit(step, snapshot, extra)
            return
        ok, err = True, None
        if snapshot is not None:
            try:
                save_checkpoint(manager, step, snapshot, extra=extra)
            except Exception as e:  # noqa: BLE001 — every rank learns of it
                ok, err = False, e
        if world > 1:
            ok = bool(parallel.mesh.all_ranks_true(
                torch.tensor(ok, device=self.device)))
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError(
                f"checkpoint at step {step} failed on rank 0 of the world")

    def _run_impl(self, logger, *, steps, trajectory_writer,
                  checkpoint_manager, metrics_logger, start_step,
                  telemetry=None) -> dict:
        config = self.config
        if config.adaptive:
            if steps is not None or start_step:
                raise ValueError(
                    "adaptive runs take their span from config.steps "
                    "(t_end = steps * dt); use run_adaptive(start_t=...) "
                    "to resume"
                )
            return self._run_adaptive_impl(
                logger, trajectory_writer=trajectory_writer,
                checkpoint_manager=checkpoint_manager,
                metrics_logger=metrics_logger)
        total_steps = config.steps if steps is None else steps
        # Frames are kept only when there is somewhere to put them (on a
        # mesh, rank 0's writer: every rank gathers them).
        record = trajectory_writer is not None
        if self.mesh is not None:
            record = not bool(parallel.mesh.all_ranks_true(
                torch.tensor(not record, device=self.device)))
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

        pipelined = self._resolve_io_pipeline()
        tracer = telemetry.tracer if telemetry is not None else None
        trace_id = None
        if telemetry is not None:
            from .telemetry import new_trace_id

            trace_id = new_trace_id()
        host_writer, trajectory_writer, save_cadence = \
            self._make_host_pipeline(trajectory_writer, checkpoint_manager,
                                     pipelined, tracer, trace_id)
        self._banner(logger, total_steps, config.integrator)
        state = self.state
        step_fn = self._step_fn(state.masses)
        count = self._launch_count()
        launches0 = count()
        # The first force evaluation loads (and, once per source, builds)
        # the kernel; it stays outside the timed loop.
        acc = self.initial_carry(state)
        ledger_on = self._ledger_fn is not None
        sent_every = self._sentinel_every if self._sentinel_fn else 0
        ledger0 = ledger_last = drift_last = max_energy_drift = None
        if ledger_on:
            # Global, as every later reading is (a collective on a mesh).
            ledger0 = self._ledger_convert(
                self._ledger_fn(self.global_state(state)))
        ledger_blocks = 0
        sent_stats = {"probes": 0, "max_rel_err": None, "last": None}
        blocks_dispatched = 0
        # self.state and self._last_step follow the CONSUMED blocks, so the
        # interrupt path can checkpoint mid-run (a pipelined run drops its
        # block in flight; resume integrates it again).
        step = start_step
        self._last_step = step
        last_good = state
        # The first dispatch works on a private copy of the caller's
        # initial state, as the JAX package's does.
        state = ParticleState(state.positions.clone(),
                              state.velocities.clone(), state.masses.clone())
        sync(self.device)
        t0 = block_prev = time.perf_counter()
        gap = HostGapTimer()
        steps_since_merge_check = 0
        merged_total = 0
        pending = None
        try:
            while step < total_steps or pending is not None:
                if step < total_steps:
                    # Injected transient errors surface at block start.
                    faults.maybe_raise_transient(step)
                    remaining = total_steps - step
                    if record and remaining >= every:
                        # Whole strides only; a sub-stride tail runs
                        # unrecorded.
                        n_steps = min(block, (remaining // every) * every)
                        record_every = every
                    else:
                        n_steps = min(block, remaining)
                        record_every = 0
                    companions = dict(
                        prev_step=step, n_steps=n_steps,
                        save_due=checkpoint_manager is not None
                        and crossed_cadence(step, step + n_steps,
                                            config.checkpoint_every),
                        ledger_due=ledger_on,
                        sentinel_due=bool(sent_every) and
                        blocks_dispatched % sent_every == 0,
                    )
                    blocks_dispatched += 1
                    gap.dispatched()
                    state, acc, frames = self._run_block(
                        state, acc, step_fn, n_steps=n_steps,
                        record_every=record_every)
                    step += n_steps
                    blk = self._dispatch_companions(
                        state, frames, finite_due=config.nan_check,
                        **companions)
                    if pipelined:
                        # Depth 1: consume the block before this one while
                        # this one runs. The serial loop is depth 0.
                        blk, pending = pending, blk
                        if blk is None:
                            continue  # priming: nothing to consume yet
                else:
                    # Dispatching is done; drain the block in flight.
                    blk, pending = pending, None

                # --- consume one finished block (k, while k+1 runs) ---
                blk.wait()
                gap.completed()
                prev_step, end_step, bstate = (blk.prev_step, blk.end_step,
                                               blk.state)
                finite_ok = blk.finite is None or bool(blk.finite)
                # Injected divergence: the watchdog's verdict on the
                # consumed block reads non-finite.
                if faults.divergence_due(prev_step, end_step):
                    finite_ok = False
                if config.nan_check and not finite_ok:
                    # The watchdog (a block late under the pipeline):
                    # abort with the last verified state saved. Queued
                    # cadence saves land first; the emergency save must
                    # not mask the divergence.
                    if checkpoint_manager is not None:
                        try:
                            if host_writer is not None:
                                host_writer.barrier()
                            self._save_checkpoint(
                                checkpoint_manager, prev_step,
                                self._checkpoint_state(last_good))
                        except Exception as ce:  # noqa: BLE001
                            if logger is not None:
                                logger.log_print(
                                    "WARNING: emergency checkpoint at step "
                                    f"{prev_step} failed: {ce}")
                    if logger is not None:
                        logger.log_print(
                            f"DIVERGED within steps {prev_step + 1}.."
                            f"{end_step}; last finite state is at step "
                            f"{prev_step}"
                            + (" (checkpoint saved)"
                               if checkpoint_manager is not None else ""))
                    if telemetry is not None:
                        telemetry.recorder.record(
                            "event", event="diverged", step=prev_step,
                            end_step=end_step)
                        telemetry.recorder.dump("divergence")
                    raise SimulationDiverged(prev_step)
                now = time.perf_counter()
                block_elapsed, block_prev = now - block_prev, now
                if tracer is not None:
                    # The solo twin of the serving `round` span: one a
                    # consumed block (the first carries the kernels'
                    # loading), on the host clock after the block's event.
                    tracer.emit("block", trace_id, time.time() - block_elapsed,
                                block_elapsed, steps_from=prev_step + 1,
                                steps_to=end_step,
                                compiled=(prev_step == start_step))
                self.state, self._last_step = bstate, end_step
                last_good = bstate
                drift = None
                if blk.ledger is not None:
                    ledger_last = self._ledger_convert(blk.ledger)
                    ledger_blocks += 1
                    drift = drift_last = diagnostics.ledger_drift(
                        ledger0, ledger_last,
                        com_frame=config.periodic_box <= 0.0)
                    if drift["energy_drift"] is not None:
                        max_energy_drift = max(max_energy_drift or 0.0,
                                               drift["energy_drift"])
                sent_summary = None
                if blk.sentinel is not None:
                    sent_summary = sentinel_summary(blk.sentinel)
                    if faults.accuracy_breach_due(end_step):
                        # Injected solver overload: the breach runs
                        # through its real path.
                        sent_summary = dict(sent_summary, p90_rel_err=1.0,
                                            max_rel_err=1.0, injected=True)
                    sent_stats["probes"] += 1
                    sent_stats["last"] = sent_summary
                    sent_stats["max_rel_err"] = max(
                        sent_stats["max_rel_err"] or 0.0,
                        sent_summary["max_rel_err"])
                    if tracer is not None:
                        # Provenance only: the probe ran inside the block's
                        # window, so the values are reportable, not an
                        # extent.
                        tracer.emit(
                            "sentinel", trace_id, time.time(), 0.0,
                            step=end_step, backend=self.backend,
                            median_rel_err=sent_summary["median_rel_err"],
                            p90_rel_err=sent_summary["p90_rel_err"],
                            max_rel_err=sent_summary["max_rel_err"])
                # Injected preemption: a real SIGTERM to this process.
                faults.maybe_preempt(prev_step, end_step)
                if logger is not None:
                    logger.progress(end_step, total_steps)
                steps_since_merge_check += blk.n_steps
                # The final block always checks, so that the returned state
                # holds no never-examined colliding pair. (Merging runs
                # serially: ``state`` is the consumed state.)
                if merging and (steps_since_merge_check >= config.merge_every
                                or end_step >= total_steps):
                    steps_since_merge_check = 0
                    # On a mesh the pair scan sees the gathered state, and
                    # a merge is sharded again.
                    res = self.merge_pass(self.global_state(state))
                    n_merged = int(res.n_merged)
                    if n_merged > 0:
                        state = res.state
                        if self.mesh is not None:
                            state = parallel.shard_state(state, self.mesh)
                        self.state = last_good = state
                        merged_total += n_merged
                        if logger is not None:
                            logger.log_print(
                                f"merged {n_merged} pair(s) at step "
                                f"{end_step} ({merged_total} total)")
                        # The force reads the new masses from here on; a
                        # merger dissipates energy, so the ledger takes a
                        # new baseline.
                        step_fn = self._step_fn(state.masses)
                        acc = self.accel(state.positions, state.masses)
                        if ledger_on:
                            ledger0 = self._ledger_convert(
                                self._ledger_fn(self.global_state(state)))
                if metrics_logger is not None:
                    extra = {}
                    if drift is not None:
                        if ledger_last["energy"] is not None:
                            extra["total_energy"] = float(
                                ledger_last["energy"])
                        for key in ("energy_drift", "momentum_drift",
                                    "angmom_drift", "com_drift"):
                            extra[key] = drift[key]
                    if sent_summary is not None:
                        extra["force_err_median"] = \
                            sent_summary["median_rel_err"]
                        extra["force_err_p90"] = sent_summary["p90_rel_err"]
                    extra[pairs_metric_name(self.backend)] = (
                        pairs_per_step(self.n_real) * blk.n_steps
                        / block_elapsed if block_elapsed > 0 else None)
                    metrics_logger.log(step=end_step,
                                       block_steps=blk.n_steps,
                                       block_s=block_elapsed, **extra)
                if trajectory_writer is not None and blk.frames is not None:
                    # The frames were copied behind the block and fenced by
                    # its event: the writer thread gets numpy arrays only.
                    host = to_numpy(blk.frames)
                    record_frames(trajectory_writer,
                                  range(prev_step + every, blk.end_step + 1,
                                        every), host)
                if blk.save_due:
                    self._save_checkpoint(checkpoint_manager, end_step,
                                          blk.snapshot, submit=save_cadence)
                if (sent_summary is not None and config.error_budget > 0.0
                        and sent_summary["p90_rel_err"] > config.error_budget):
                    # Raised after this block's trajectory and checkpoint
                    # writes, so that a supervised heal continues a
                    # gap-free run from self._last_step.
                    if logger is not None:
                        logger.log_print(
                            f"ACCURACY BREACH at step {end_step}: "
                            f"{self.backend} sentinel p90 rel err "
                            f"{sent_summary['p90_rel_err']:.3e} > budget "
                            f"{config.error_budget:.3e}")
                    if telemetry is not None:
                        telemetry.recorder.record(
                            "event", event="accuracy_breach", step=end_step,
                            backend=self.backend,
                            p90_rel_err=sent_summary["p90_rel_err"],
                            budget=config.error_budget)
                        telemetry.recorder.dump("accuracy_breach")
                    raise AccuracyBreach(end_step, self.backend,
                                         sent_summary["p90_rel_err"],
                                         config.error_budget)
            # Drain the writer inside the try, so that a failed write fails
            # the run.
            if host_writer is not None:
                host_writer.barrier()
        except KeyboardInterrupt as e:
            # Ctrl-C or SIGTERM: save the last consumed block so that
            # `resume` works; queued cadence saves land first.
            preempted = isinstance(e, SimulationPreempted)
            if telemetry is not None:
                telemetry.recorder.record(
                    "event", event="preempted" if preempted
                    else "interrupted", step=self._last_step)
                if preempted:
                    telemetry.recorder.dump("sigterm")
            if checkpoint_manager is not None \
                    and self._last_step > start_step:
                word = "Preempted (SIGTERM)" if preempted else "Interrupted"
                try:
                    if host_writer is not None:
                        host_writer.barrier()
                    self._save_checkpoint(
                        checkpoint_manager, self._last_step,
                        self._checkpoint_state(self.state))
                except Exception as ce:  # noqa: BLE001 — must not mask
                    if logger is not None:  # the interrupt itself
                        logger.log_print(
                            f"WARNING: {word} at step {self._last_step} "
                            f"but the checkpoint save failed: {ce}")
                else:
                    if logger is not None:
                        logger.log_print(f"{word} at step "
                                         f"{self._last_step}; checkpoint "
                                         "saved")
            raise
        finally:
            if host_writer is not None:
                host_writer.close(raise_errors=False)
        sync(self.device)
        total_time = time.perf_counter() - t0
        self.state = state
        if trajectory_writer is not None:
            trajectory_writer.close()
        # Host work after the last block's completion (its writes, the
        # writer's drain) is device-idle time too.
        gap.finish()

        run_steps = total_steps - start_step
        stats = self._stats(run_steps, total_time, count() - launches0)
        stats["io_pipeline"] = "on" if pipelined else "off"
        stats["host_gap_frac"] = gap.host_gap_frac
        if self.nlist_sizing is not None:
            # The N(N-1) rate is what a dense sum would have needed;
            # evaluated_pairs_per_sec counts the pair-tile slots.
            side, cap, slots = self.nlist_sizing
            evals = run_steps * FORCE_EVALS_PER_STEP[config.integrator]
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
        if self.fmm_sparse is not None:
            stats.update(self._fmm_stats())
        if ledger_on:
            stats["ledger"] = {"blocks": ledger_blocks,
                               "pe_kind": self.ledger_pe_kind,
                               "max_energy_drift": max_energy_drift,
                               **(drift_last or {})}
            if ledger_last is not None and ledger_last["energy"] is not None:
                stats["total_energy"] = float(ledger_last["energy"])
        if sent_every:
            stats["sentinel"] = {
                "backend": self.backend,
                "every": sent_every,
                "k": int(config.sentinel_k),
                "probes": sent_stats["probes"],
                "max_rel_err": sent_stats["max_rel_err"],
                **{k: sent_stats["last"][k]
                   for k in ("median_rel_err", "p90_rel_err")
                   if sent_stats["last"] is not None},
            }
        if telemetry is not None:
            # The run's perf facts in its registry, under the gauge names
            # a serving worker publishes.
            from .telemetry import declare_worker_metrics

            reg = declare_worker_metrics(telemetry.registry)
            if gap.host_gap_frac is not None:
                reg.gauge("gravity_host_gap_frac").set(gap.host_gap_frac)
            if total_time > 0:
                reg.gauge("gravity_steps_per_sec").set(run_steps / total_time)
            if self.autotune["probe_ms"]:
                reg.histogram("gravity_autotune_probe_ms").observe(
                    self.autotune["probe_ms"])
            stats["trace_id"] = trace_id
        if merging:
            stats["merged_pairs"] = merged_total
        return self._finish(logger, total_time, run_steps, stats)


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
            **{f"autotune_{k}": v for k, v in self.autotune.items()},
        }
        if self.mesh is not None:
            # This rank's launches; the rate is the world's, and a chip's
            # share of it.
            stats.update({
                "sharding": self.config.sharding,
                "mesh_shape": list(self.mesh.shape),
                "num_devices": self.mesh.size,
                "pairs_per_sec_per_chip": (
                    pairs / total_time / self.mesh.size
                    if total_time > 0 else None),
            })
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
        checkpoint_manager=None,
        metrics_logger=None,
        start_t: float = 0.0,
        start_comp: float = 0.0,
        start_steps: int = 0,
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
        The block read decides the next block, so the compute stays
        serial; trajectory frames (at block boundaries) and checkpoint
        saves still go through the host writer when ``io_pipeline`` is on.
        A checkpoint carries ``t`` and the Kahan ``comp`` as extras, which
        ``start_t``/``start_comp``/``start_steps`` take back on a resume.
        SIGTERM raises :class:`SimulationPreempted` through the
        checkpoint-and-exit path."""
        with preemption_guard():
            return self._run_adaptive_impl(
                logger, trajectory_writer=trajectory_writer,
                checkpoint_manager=checkpoint_manager,
                metrics_logger=metrics_logger, start_t=start_t,
                start_comp=start_comp, start_steps=start_steps)

    def _run_adaptive_impl(self, logger, *, trajectory_writer,
                           checkpoint_manager, metrics_logger,
                           start_t: float = 0.0, start_comp: float = 0.0,
                           start_steps: int = 0) -> dict:
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
        if (config.integrator == "multirate" and self.mesh is not None
                and config.multirate_rungs > 2):
            raise ValueError(
                "adaptive + multirate composition supports the two-rung "
                "scheme on a mesh (multirate_rungs=2); the sharded rung "
                "ladder stays fixed-dt for now"
            )
        # Adaptive x multirate: the criterion sizes the outer dt from the
        # slow remainder (the k fastest excluded), the rungs subdivide it.
        step_fn = None
        exclude_fastest = 0
        mode = "adaptive-kdk"
        # On a mesh the criterion reads every rank's rows.
        gather = (parallel.mesh.all_gather_rows if self.mesh is not None
                  else None)
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
                    mesh=self.mesh,
                )
                mode = (f"adaptive-multirate (k={k}, "
                        f"sub={config.multirate_sub})")
        self._banner(logger, config.steps,
                     f"{mode} ({criterion}, eta={config.eta})")
        host_writer, trajectory_writer, submit_save = \
            self._make_host_pipeline(trajectory_writer, checkpoint_manager,
                                     self._resolve_io_pipeline())

        block_cap = max(1, min(config.progress_every,
                               config.adaptive_max_steps))
        t_end_cast = rounded(t_end, self.dtype)
        state = self.state
        masses = state.masses

        def accel_fn(positions):
            return self.accel(positions, masses)

        count = self._launch_count()
        launches0 = count()
        acc = self.initial_carry(state)
        sync(self.device)
        t0_wall = block_prev = time.perf_counter()
        t, comp = start_t, start_comp
        steps_taken = start_steps
        tail_steps = 0
        dt_min, dt_max_used = math.inf, 0.0
        # The dt a block's budget is sized by: the ceiling at first (no
        # step can be longer, so the first block takes no tail step),
        # then the previous block's largest dt.
        dt_est = config.dt
        # One consistent (state, steps, t, comp) snapshot, replaced in one
        # assignment once a block is known finite: the only source of
        # checkpoints, so that no save pairs a state with another t.
        snap = (state, steps_taken, t, comp)
        self._snap = snap
        self._last_step = steps_taken
        try:
            while (t < t_end_cast
                   and steps_taken < config.adaptive_max_steps):
                faults.maybe_raise_transient(steps_taken)
                prev_steps = steps_taken
                budget = min(block_cap,
                             config.adaptive_max_steps - steps_taken,
                             max(1, math.ceil((t_end_cast - t) / dt_est)))
                res = adaptive_run(
                    state, accel_fn, t_end=t_end, dt_max=config.dt,
                    eta=config.eta, eps=config.eps, criterion=criterion,
                    max_steps=budget, t0=t, comp0=comp, acc0=acc,
                    step_fn=step_fn, exclude_fastest=exclude_fastest,
                    gather=gather, block=budget,
                )
                # The block's one host read.
                t, comp, b_min, b_max, block_steps = torch.stack([
                    res.t.double(), res.comp.double(), res.dt_min.double(),
                    res.dt_max_used.double(), res.steps.double(),
                ]).tolist()
                block_steps = int(block_steps)
                state, acc = res.state, res.acc
                state = faults.maybe_corrupt_state(
                    state, prev_steps, prev_steps + block_steps)
                tail_steps += budget - block_steps
                if block_steps > 0:
                    dt_min = min(dt_min, b_min)
                    dt_max_used = max(dt_max_used, b_max)
                    dt_est = b_max
                if config.nan_check and not self._state_finite(state):
                    if checkpoint_manager is not None and snap[1] > 0:
                        try:
                            if host_writer is not None:
                                host_writer.barrier()
                            self._save_checkpoint(
                                checkpoint_manager, snap[1],
                                self._checkpoint_state(snap[0]),
                                extra={"t": snap[2], "comp": snap[3]})
                        except Exception as ce:  # noqa: BLE001
                            if logger is not None:
                                logger.log_print(
                                    "WARNING: emergency checkpoint at "
                                    f"step {snap[1]} failed: {ce}")
                    if logger is not None:
                        logger.log_print(
                            f"DIVERGED during adaptive run (after "
                            f"{steps_taken} steps)"
                        )
                    raise SimulationDiverged(steps_taken)
                now = time.perf_counter()
                block_elapsed, block_prev = now - block_prev, now
                steps_taken += block_steps
                snap = (state, steps_taken, t, comp)
                self._snap = snap
                self.state, self._last_step = state, steps_taken
                faults.maybe_preempt(prev_steps, steps_taken)
                if logger is not None:
                    logger.log_print(
                        f"t={t:.6g}/{t_end:.6g} ({steps_taken} adaptive "
                        f"steps, dt in [{b_min:.3g}, {b_max:.3g}])"
                    )
                if metrics_logger is not None:
                    metrics_logger.log(
                        step=steps_taken, block_steps=block_steps,
                        block_s=block_elapsed, t=t,
                        dt_min=b_min if block_steps else None,
                        dt_max=b_max if block_steps else None,
                        **{pairs_metric_name(self.backend): (
                            pairs_per_step(self.n_real) * block_steps
                            / block_elapsed if block_elapsed > 0 else None)})
                if self.mesh is not None and block_steps > 0:
                    # The frame's particle axis gathered on every rank,
                    # padding dropped; rank 0's writer records it.
                    frame = parallel.mesh.all_gather_rows(
                        state.positions)[:self.n_real]
                else:
                    frame = state.positions
                if trajectory_writer is not None and block_steps > 0:
                    trajectory_writer.record(steps_taken, to_numpy(frame))
                if checkpoint_manager is not None and crossed_cadence(
                        prev_steps, steps_taken, config.checkpoint_every):
                    self._save_checkpoint(
                        checkpoint_manager, steps_taken,
                        self._checkpoint_state(state, queued=True),
                        {"t": t, "comp": comp}, submit=submit_save)
                if block_steps == 0:
                    break  # t >= t_end in the state's dtype
            if host_writer is not None:
                host_writer.barrier()
        except KeyboardInterrupt as e:
            if checkpoint_manager is not None and snap[1] > start_steps:
                word = ("Preempted (SIGTERM)"
                        if isinstance(e, SimulationPreempted)
                        else "Interrupted")
                try:
                    if host_writer is not None:
                        host_writer.barrier()
                    self._save_checkpoint(
                        checkpoint_manager, snap[1],
                        self._checkpoint_state(snap[0]),
                        extra={"t": snap[2], "comp": snap[3]})
                except Exception as ce:  # noqa: BLE001 — must not mask
                    if logger is not None:  # the interrupt itself
                        logger.log_print(
                            f"WARNING: {word} at adaptive step {snap[1]} "
                            f"but the checkpoint save failed: {ce}")
                else:
                    if logger is not None:
                        logger.log_print(
                            f"{word} at adaptive step {snap[1]} "
                            f"(t={snap[2]:.6g}); checkpoint saved")
            raise
        finally:
            if host_writer is not None:
                host_writer.close(raise_errors=False)
        sync(self.device)
        total_time = time.perf_counter() - t0_wall
        if trajectory_writer is not None:
            trajectory_writer.close()
        # The block loop's re-wrap, at the end of an adaptive run.
        self.state = state = self._wrap(state)

        run_steps = steps_taken - start_steps
        stats = self._stats(run_steps, total_time, count() - launches0)
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
        return self._finish(logger, total_time, run_steps, stats)

    def _banner(self, logger: Optional[RunLogger], steps: int,
                integrator_label: str) -> None:
        if logger is not None:
            logger.start_banner(
                platform="GPU" if self.device.type == "cuda" else "CPU",
                device=device_name(self.device),
                num_devices=self.mesh.size if self.mesh is not None else 1,
                num_particles=self.n_real,
                steps=steps,
                dt=self.config.dt,
                model=self.config.model,
                integrator=integrator_label,
                backend=self.backend,
                dtype=self.config.dtype,
                sharding=(self.config.sharding if self.mesh is not None
                          else "none"),
            )

    def _state_finite(self, state: ParticleState) -> bool:
        """Whether ``state`` is finite; on a mesh every rank's rows, one
        verdict, so that all stop together."""
        finite = (torch.isfinite(state.positions).all()
                  & torch.isfinite(state.velocities).all())
        if self.mesh is not None:
            finite = parallel.mesh.all_ranks_true(finite)
        return bool(finite)

    def _finish(self, logger: Optional[RunLogger], total_time: float,
                steps: int, stats: dict) -> dict:
        """Shared run epilogue: perf log, final positions, results dict."""
        final = stats["final_state"] = self.final_state()
        if logger is not None:
            logger.performance(
                total_time, steps, pairs_per_sec=stats["pairs_per_sec"]
            )
            logger.final_positions(to_numpy(final.positions))
            logger.completed()
        # This block's ledger rows, latest a signature (JAX simulation.py:
        # 2470-2473).
        stats["perf"] = _perf.summarize_rows([
            r for r in _perf.ledger().rows_list()
            if r.get("key") == self._run_block.key])
        if self.fmm_sparse:
            # The sparse sizing was fixed from the initial state: a run
            # whose structure spread out past k_cells degraded the
            # rank-overflow leaves to the monopole fallback, which the
            # solver itself cannot report. A host count on the final state.
            note = sfmm.final_occupancy_check(stats["final_state"].positions,
                                              self.sfmm_sizing)
            stats["sfmm_final_occupancy"] = note
            if note["overflow"] and logger is not None:
                logger.log_print(
                    "WARNING: sparse-FMM occupancy grew past k_cells during "
                    f"the run ({note['occupied']} occupied vs k_cells="
                    f"{note['k_cells']} at depth {note['depth']}); "
                    "rank-overflow cells degraded to the monopole fallback "
                    "- re-run with a larger k_cells")
        return stats

    def final_state(self) -> ParticleState:
        """The state of the real particles, on the run's device; on a mesh
        gathered from every rank (a collective), the padding dropped."""
        if self.mesh is None:
            return self.state
        whole = self.global_state(self.state)
        return ParticleState(whole.positions[:self.n_real],
                             whole.velocities[:self.n_real],
                             whole.masses[:self.n_real])

    def energy(self):
        """Total conserved energy of the current state: kinetic plus the
        self-gravity potential plus, under ``external``, the field's
        potential energy.

        A tree, FMM or p3m run above :data:`ENERGY_TREE_THRESHOLD` bodies
        prices the potential with the large-N potential of its device
        (:data:`LARGE_N_POTENTIAL`: ``ops/tree.py::tree_potential_energy``
        on the CPU, as the JAX package off the TPU;
        ``ops/fmm.py::fmm_potential_energy`` on the card, as the JAX
        package on its accelerator), at a depth resolved once a run, and
        returns a host ``np.float64`` (kinetic energy and the potential
        each in float64, since |PE| can pass fp32's range); the dense pair
        scan would cost ~5.5e11 pair evaluations at 1M bodies. A periodic
        run (either solver) prices the potential with the mesh potential
        the periodic solver integrates (the isolated pair sum is not
        conserved in a box and jumps at re-wraps): a host ``np.float64``.
        Otherwise the plain O(N^2) sum, a device scalar in the state's
        dtype. On a mesh every rank gathers the state and prices it
        whole."""
        c = self.config
        state = self.final_state()
        if c.periodic_box > 0.0:
            return diagnostics.kinetic_energy_f64(state) + np.float64(
                periodic.pm_periodic_potential_energy(
                    state.positions, state.masses, box=c.periodic_box,
                    grid=c.pm_grid, g=c.g, eps=c.eps,
                    assignment=c.pm_assignment))
        if (self.backend not in ("tree", "fmm", "sfmm", "p3m")
                or self.n_real <= ENERGY_TREE_THRESHOLD):
            return diagnostics.total_energy(
                state, g=c.g, cutoff=c.cutoff, eps=c.eps,
                external_phi=self._ext_phi,
            )
        if self._energy_tree_depth is None:
            self._energy_tree_depth = _resolve_depth_and_warn(
                c, state.positions, "energy diagnostic", n=self.n_real)
        kw = dict(depth=self._energy_tree_depth, leaf_cap=c.tree_leaf_cap,
                  ws=c.tree_ws, g=c.g, cutoff=c.cutoff, eps=c.eps)
        if LARGE_N_POTENTIAL[self.device.type] == "fmm":
            pe = fmm.fmm_potential_energy(state.positions, state.masses, **kw)
        else:
            pe = tree.tree_potential_energy(state.positions, state.masses,
                                            chunk=c.fast_chunk, **kw)
        e = diagnostics.kinetic_energy_f64(state) + pe
        if self._ext_phi is not None:
            e = e + np.float64(float(
                (state.masses * self._ext_phi(state.positions)).sum()))
        return e
