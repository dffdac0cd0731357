"""Configuration layer.

Counterpart of ``gravity_tpu/config.py``. One dataclass whose defaults
reproduce the reference constants, plus the reference presets. It holds
only the fields this package honours. A configuration that asks for a
feature of the JAX package that is not ported yet is refused with an
error naming its ROADMAP item, never silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from . import constants as C

MODELS = ("random", "solar", "disk", "plummer", "cold_collapse", "hernquist",
          "merger", "grf")
INTEGRATORS = ("euler", "leapfrog", "verlet", "yoshida4", "multirate")
TIMESTEP_CRITERIA = ("auto", "accel", "velocity")
DTYPES = ("float32", "float64", "bfloat16")
# "pallas" and "pallas-mxu" are the JAX names of the hand-written
# direct-sum kernels; here they name the CUDA kernels (ops/direct_kernel.py,
# ops/mxu_kernel.py). "nlist" is the cutoff-radius cell list (ops/nlist.py),
# "p3m" the particle-particle particle-mesh solver (ops/p3m.py), "tree" the
# octree (ops/tree.py), "fmm" the fast multipole solver (ops/fmm.py, its
# layout by fmm_mode), "sfmm" its sparse layout (ops/sfmm.py) and "pm" the
# particle-mesh solver (ops/pm.py isolated, ops/periodic.py in a box).
FORCE_BACKENDS = ("auto", "direct", "dense", "chunked", "pallas",
                  "pallas-mxu", "nlist", "p3m", "tree", "fmm", "sfmm", "pm")
PM_ASSIGNMENTS = ("cic", "tsc")
P3M_SHORT_MODES = ("auto", "gather", "slice", "nlist")
FMM_MODES = ("auto", "dense", "sparse")
TREE_FAR_MODES = ("direct", "expansion")
TREE_NEAR_MODES = ("gather", "nlist")
# none | allgather | ring (a (S, P/S) mesh_shape makes the ring the
# hierarchical one): the sharded direct sums of parallel/sharded.py.
SHARDING_MODES = ("none", "allgather", "ring")
# The cell-list family's mesh strategy (nlist and P3M's near field): halo
# (the slab decomposition, parallel/halo.py) | allgather | auto (halo on a
# single-axis mesh of >= 2 devices).
NLIST_MESH_MODES = ("auto", "halo", "allgather")

# P3M takes no bf16 state, as in the JAX package, whose mesh FFT refuses
# one: nothing is left to port there.
_BF16_REFUSED_BACKENDS = ("p3m",)
_BF16_REFUSED_REASON = (
    "the JAX package's P3M cannot run a bf16 state either: its mesh FFT, "
    "jnp.fft.rfftn at gravity_tpu/ops/pm.py:286, takes float32 or float64 "
    "only (ValueError: RFFT input must be float32 or float64)"
)
_UNPORTED_BACKENDS = {
    "cpp": (
        "ROADMAP.md Queue 2 (the JAX CPU XLA-FFI kernel has no port; "
        "use dense or chunked on the CPU)"
    ),
}

# Fields of gravity_tpu's SimulationConfig that this package does not
# carry: (the JAX default, which means "feature off", and the ROADMAP item
# that ports the feature). A JSON config may name them only at that value.
# Every field is carried now.
_NOT_PORTED: dict = {}
IO_PIPELINE_MODES = ("auto", "on", "off")
TRAJECTORY_FORMATS = ("npy", "native")
ON_DIVERGE = ("halve-dt", "abort")


class NotPortedError(ValueError):
    """A configuration asks for a feature that no slice has ported yet."""


@dataclasses.dataclass
class SimulationConfig:
    # Workload
    model: str = "random"  # one of MODELS
    n: int = 1024
    steps: int = C.DEFAULT_STEPS
    dt: float = C.DEFAULT_DT
    seed: int = 0

    # Physics
    g: float = C.G
    cutoff: float = C.CUTOFF_RADIUS
    eps: float = 0.0  # Plummer softening (0 = reference semantics)

    # Numerics / backend
    # euler | leapfrog | verlet | yoshida4 | multirate (block timesteps,
    # ops/multirate.py)
    integrator: str = "euler"
    multirate_k: int = 0  # fast-rung capacity; 0 = auto (n // 8)
    multirate_sub: int = 4  # substeps per outer step for the fast rung
    # > 2: the power-of-two rung ladder, rung r at dt / 2^r with capacity
    # k // 8^(r-1); multirate_sub is then unused.
    multirate_rungs: int = 2
    dtype: str = "float32"  # float32 | float64 | bfloat16
    # auto: the measured-fastest eligible backend (autotune.py); direct |
    # pallas: the CUDA direct-sum kernel on the card, dense/chunked plain
    # PyTorch on the CPU (simulation._resolve_direct).
    # dense | chunked: the plain PyTorch direct sum on any device.
    # pallas-mxu: the Gram-form CUDA kernel.
    # nlist: the cutoff-radius cell list; needs nlist_rcut > 0.
    # p3m: the P3M solver (mesh + cell-list near field), explicit only.
    # tree: the octree (ops/tree.py).
    force_backend: str = "auto"
    # With force_backend="auto": route by measurement (autotune.py, a
    # probe of the eligible candidates, kept in an on-disk cache); False
    # keeps the static route.
    autotune: bool = True
    chunk: int = 1024  # i-chunk of the chunked plain direct sum
    # Declared truncation radius (m): with nlist_rcut > 0 forces are
    # truncated at r > nlist_rcut (short-range physics), and auto/direct
    # take the rcut-masked direct sum. nlist_side/nlist_cap pin the cell
    # list's static sizing; 0 fits them to the initial state
    # (ops/nlist.py::resolve_nlist_sizing).
    nlist_rcut: float = 0.0
    nlist_side: int = 0
    nlist_cap: int = 0
    # P3M (force_backend="p3m", ops/p3m.py): mesh per axis, Ewald split
    # scale in mesh cells, short-range truncation in sigmas, source slots
    # per cell of its cell list, the short-range pass (nlist = the
    # cell-list kernel, gather = per-target block gathers; auto = nlist
    # on the GPU, gather on the CPU) and the gather pass's target chunk.
    pm_grid: int = 128
    p3m_sigma_cells: float = 1.25
    p3m_rcut_sigmas: float = 4.0
    p3m_cap: int = 128
    p3m_short: str = "auto"
    # Octree (force_backend="tree", ops/tree.py): leaf depth (0 = fit to the
    # initial state, recommended_depth_data), near-field slots per leaf,
    # opening criterion (theta ~ 0.87 / ws), far field (direct | expansion)
    # and near field (gather = per-target block gathers; nlist = the
    # cell-list kernel over the leaf blocks, ws = 1 only).
    tree_depth: int = 0
    tree_leaf_cap: int = 32
    tree_ws: int = 1
    tree_far: str = "direct"
    tree_near: str = "gather"
    # FMM layout (force_backend="fmm"): dense (the leaf grid, quasi-uniform
    # states) | sparse (the occupied-leaf compaction of ops/sfmm.py,
    # clustered states) | auto = sparse when the initial state occupies
    # under 5% of its resolving grid's leaves (sfmm.sfmm_auto_decision).
    # force_backend="sfmm" is the sparse layout whatever this says. Both
    # take their depth and cap from tree_depth / tree_leaf_cap.
    fmm_mode: str = "auto"
    # Target chunk of the tree's evaluation and of the p3m gather pass.
    fast_chunk: int = 4096

    # Multi-device execution (parallel/): one process a device on
    # torch.distributed. sharding = none | allgather | ring; mesh_shape =
    # (P,) or (S, P/S) (None: (world size,)); the hierarchical ring runs on
    # a two-axis mesh. nlist_mesh: the mesh strategy of nlist and p3m's near
    # field (halo = the slab decomposition, allgather = gather the world,
    # auto = halo on a single-axis mesh of >= 2 devices); nlist_mig_cap:
    # the halo's static migration bucket capacity a (device, destination
    # slab), 0 = fit from the initial state (parallel/halo.resolve_mig_cap).
    sharding: str = "none"
    mesh_shape: Optional[tuple] = None
    nlist_mesh: str = "auto"
    nlist_mig_cap: int = 0

    # Periodic-box gravity: the side of the periodic unit cell, 0 =
    # isolated boundaries. Needs force_backend "pm" (the periodic FFT
    # solver, ops/periodic.py) or "nlist" (the minimum-image cell list);
    # positions wrap mod box.
    periodic_box: float = 0.0
    pm_assignment: str = "cic"  # cic | tsc (pm mass assignment, both BCs)

    # Adaptive time stepping (ops/adaptive.py): steps * dt becomes the
    # target simulated time and dt the per-step ceiling.
    adaptive: bool = False
    eta: float = 0.025  # timestep safety factor
    # auto (accel if eps > 0, else velocity) | accel | velocity
    timestep_criterion: str = "auto"
    adaptive_max_steps: int = 1_000_000  # runaway-subdivision bound

    # Analytic background field added to self-gravity (ops/external.py),
    # e.g. "nfw:gm=1e13,rs=2e20" or "pointmass:gm=1.3e20 + uniform:gz=-9.8";
    # "" = none.
    external: str = ""

    # Collision merging (ops/encounters.py): radius > 0 merges pairs closer
    # than it inelastically every merge_every steps, from merge_k
    # candidate pairs a check.
    merge_radius: float = 0.0
    merge_k: int = 16
    merge_every: int = 100

    # I/O & observability
    log_dir: str = "gravity_logs_gpu"
    record_trajectories: bool = False
    trajectory_every: int = 1
    progress_every: int = C.PROGRESS_EVERY
    # npy: .npy shards + manifest; native: one .gtrj file (the JAX
    # package's C++ writer's format, written here in Python).
    trajectory_format: str = "npy"
    # Per-block NaN/Inf state check; raises SimulationDiverged.
    nan_check: bool = True

    # The host pipeline: auto/on = queue block k+1 before consuming block k
    # (its watchdog verdict, ledger, sentinel, trajectory copies and
    # writes, checkpoint saves, these two on a background writer), so the
    # card does not idle through them; the artifacts are bitwise those of
    # the serial loop (off). auto degrades to off with collision merging.
    io_pipeline: str = "auto"
    checkpoint_every: int = 0  # 0 = off
    checkpoint_dir: str = "checkpoints"
    metrics: bool = False  # the JSONL per-block metrics stream
    # Deprecated alias of `ledger`.
    metrics_energy: bool = False
    # The in-program conservation ledger: energy, momentum, angular
    # momentum and COM drift of every block, queued behind it on the card
    # and summed in float64 on the host.
    ledger: bool = False
    # The accuracy sentinel: every `sentinel_every` blocks, the backend's
    # force error on `sentinel_k` sampled targets against the exact direct
    # sum (rcut-masked for the truncated family). 0 = off (1 when an error
    # budget is set).
    sentinel_every: int = 0
    sentinel_k: int = 64
    # The largest acceptable sentinel p90 relative force error; 0 = observe
    # only. A breach raises AccuracyBreach: exit 2 alone, healed under
    # auto_recover (a leaf-cap re-size, then an exact direct sum).
    error_budget: float = 0.0
    debug_check: bool = False  # kernel vs plain direct sum on the final state
    # Capture a torch.profiler trace of the run (utils/profiling.trace)
    # into <log_dir>/profile_<timestamp>/.
    profile: bool = False
    # Span tracing: emit the run's lifecycle spans (blocks, checkpoints,
    # sentinel probes) as JSONL under log_dir — the solo twin of the
    # serving trace stream, exportable with `gravity_tpu_torch
    # trace-export`.
    trace: bool = False

    # Self-healing supervision (supervisor.py): divergence rolls back to
    # the last verified checkpoint and retries the bad interval at halved
    # dt, injected transient errors retry with backoff, an injected
    # unbuildable backend degrades pallas-mxu -> pallas -> chunked.
    auto_recover: bool = False
    max_retries: int = 3  # a failure class
    on_diverge: str = "halve-dt"  # halve-dt | abort

    def __post_init__(self) -> None:
        if (self.dtype == "bfloat16"
                and self.force_backend in _BF16_REFUSED_BACKENDS):
            raise ValueError(
                f"dtype='bfloat16' with force_backend={self.force_backend!r}"
                f": {_BF16_REFUSED_REASON}; use float32 or float64"
            )
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(int(x) for x in self.mesh_shape)
            if (len(self.mesh_shape) not in (1, 2)
                    or min(self.mesh_shape) < 1):
                raise ValueError(
                    f"mesh_shape must be (P,) or (S, P/S) of positive "
                    f"sizes, got {self.mesh_shape}")
        if self.force_backend in _UNPORTED_BACKENDS:
            raise NotPortedError(
                f"force_backend={self.force_backend!r} is not ported to "
                f"gravity_tpu_torch yet "
                f"({_UNPORTED_BACKENDS[self.force_backend]})"
            )
        for name, choices in (
            ("model", MODELS), ("integrator", INTEGRATORS),
            ("dtype", DTYPES), ("force_backend", FORCE_BACKENDS),
            ("p3m_short", P3M_SHORT_MODES), ("sharding", SHARDING_MODES),
            ("nlist_mesh", NLIST_MESH_MODES),
            ("tree_far", TREE_FAR_MODES), ("tree_near", TREE_NEAR_MODES),
            ("fmm_mode", FMM_MODES), ("pm_assignment", PM_ASSIGNMENTS),
            ("timestep_criterion", TIMESTEP_CRITERIA),
            ("io_pipeline", IO_PIPELINE_MODES),
            ("trajectory_format", TRAJECTORY_FORMATS),
            ("on_diverge", ON_DIVERGE),
        ):
            if getattr(self, name) not in choices:
                raise ValueError(
                    f"unknown {name} {getattr(self, name)!r}; choose from "
                    f"{sorted(choices)}"
                )
        for name in ("nlist_rcut", "nlist_side", "nlist_cap",
                     "nlist_mig_cap", "tree_depth",
                     "periodic_box",
                     "checkpoint_every", "sentinel_every", "error_budget",
                     "max_retries"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(self, name)}")
        for name in ("pm_grid", "p3m_sigma_cells", "p3m_rcut_sigmas",
                     "p3m_cap", "fast_chunk", "tree_leaf_cap", "tree_ws",
                     "sentinel_k"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0, got "
                                 f"{getattr(self, name)}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "SimulationConfig":
        """Parse a config written by this package or by gravity_tpu.

        A gravity_tpu field that this package does not carry is accepted
        only at its JAX default (the feature switched off); any other
        value raises :class:`NotPortedError` naming the ROADMAP item."""
        data = json.loads(text)
        own = {f.name for f in dataclasses.fields(SimulationConfig)}
        kept = {}
        for name, value in data.items():
            if name in own:
                kept[name] = value
                continue
            if name not in _NOT_PORTED:
                raise ValueError(f"unknown config field {name!r}")
            default, item = _NOT_PORTED[name]
            if value != default:
                raise NotPortedError(
                    f"{name}={value!r} is not ported to gravity_tpu_torch "
                    f"yet ({item})"
                )
        return SimulationConfig(**kept)


# Named presets: the three reference workloads, the single-card baselines
# and the two sharded ones, all 11 of gravity_tpu/config.py.
PRESETS = {
    "reference-mpi": SimulationConfig(model="random", n=8, integrator="euler"),
    # Pinned to the exact direct sum: reference parity means pairwise
    # forces.
    "reference-cuda": SimulationConfig(
        model="random", n=50_000, integrator="euler", force_backend="direct"
    ),
    "reference-spark": SimulationConfig(
        model="random", n=1000, integrator="euler", record_trajectories=True
    ),
    "baseline-1k": SimulationConfig(
        model="random", n=1024, integrator="leapfrog", force_backend="dense"
    ),
    "baseline-16k": SimulationConfig(
        model="plummer", n=16_384, integrator="leapfrog",
        force_backend="pallas", eps=1.0e9,
    ),
    # Galactic natural units (G = 1, kpc, 1e10 Msun; utils/units.py).
    "baseline-1m": SimulationConfig(
        model="disk", n=1_048_576, integrator="leapfrog",
        force_backend="tree", g=1.0, dt=2.0e-3, eps=0.05,
    ),
    "baseline-1m-p3m": SimulationConfig(
        model="disk", n=1_048_576, integrator="leapfrog",
        force_backend="p3m", pm_grid=256, p3m_cap=64,
        g=1.0, dt=2.0e-3, eps=0.05,
    ),
    "baseline-1m-fmm": SimulationConfig(
        model="disk", n=1_048_576, integrator="leapfrog",
        force_backend="fmm", g=1.0, dt=2.0e-3, eps=0.05,
    ),
    # The single-card 2M direct sum: 4.4e12 pairs a step.
    "baseline-2m": SimulationConfig(
        model="merger", n=2_097_152, integrator="leapfrog",
        force_backend="pallas", g=1.0, dt=2.0e-3, eps=0.05,
    ),
    # The sharded direct sums (parallel/sharded.py): allgather at 262,144
    # bodies, and the 2M merger's ring.
    "baseline-262k": SimulationConfig(
        model="cold_collapse", n=262_144, integrator="leapfrog",
        force_backend="pallas", sharding="allgather", eps=1.0e9,
    ),
    "baseline-2m-merger": SimulationConfig(
        model="merger", n=2_097_152, integrator="leapfrog",
        force_backend="pallas", sharding="ring", g=1.0, dt=2.0e-3, eps=0.05,
    ),
}
