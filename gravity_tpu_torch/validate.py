"""The ``validate`` verb: the physics self-test battery and its card gate.

Counterpart of ``gravity_tpu/cli.py``'s ``cmd_validate`` and
``_validate_tpu_battery``. :func:`physics_checks` are its six checks: the
run's active force kernel against the plain direct sum, the Earth's
orbit closing over a year, leapfrog's energy drift, yoshida4 against
leapfrog on a circular orbit, an adaptive run landing on ``t_end`` and a
merge conserving mass and momentum. :func:`gpu_battery` is ``--gpu``, the
JAX package's ``--tpu``: each kernel against the plain chunked sum, the
octree and both FMMs against it, the sharded path on a world of one, a
5-step bench line and the 2M direct sum, in records named ``gpu_*`` for
the JAX battery's ``tpu_*``.

On the card the battery runs at the JAX battery's on-chip sizes; with
``--device cpu`` at its off-chip sizes, and the 2M record is skipped.
The accuracy bars are the JAX battery's. The two rate bars are the
card's own: half the rate of ``nbody_direct.cu`` that PERF.md's kernel
table gives at that size on an NVIDIA H100 80GB HBM3 at a 700.00 W power
limit (mask-free at N = 65,536, 2.394 ms; ``baseline-2m``, 2,304.6 ms a
step). On the CPU the bench bar is the JAX package's liveness bar.

Each kernel record names its route (``nbody_direct.cu``, ``nbody_mxu.cu``
on the card; ``plain`` on the CPU) and the launches counted during it;
on the card a record whose kernel launched no time fails, so that a
plain route cannot pass as the card's.

Random states come from :func:`default_draw`'s ``draw(model, n, seed)``:
the model's factory on a ``torch.Generator`` seeded with ``seed`` (the CPU
tests put the JAX package's draws in its place).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from .constants import G
from .state import ParticleState

# pairs/s: half of nbody_direct.cu's rate on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md kernel table): 65,536 x 65,535 pairs in 2.394 ms,
# 2,097,152 x 2,097,151 in 2,304.6 ms a step.
GPU_BENCH_BAR = 0.5 * 65_536 * 65_535 / 2.394e-3
GPU_2M_BAR = 0.5 * 2_097_152 * 2_097_151 / 2.3046
CPU_BENCH_BAR = 1.0e6  # the JAX package's liveness bar off the chip
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

Draw = Callable[[str, int, int], ParticleState]


def default_draw(device: torch.device) -> Draw:
    """``draw(model, n, seed)``: the model's factory on a CPU generator
    seeded with ``seed``, float32, on ``device``."""
    from .models import create_model

    def draw(model: str, n: int, seed: int) -> ParticleState:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed)
        return create_model(model, gen, n, torch.float32, device=device)

    return draw


def _launches() -> dict:
    from .ops import direct_kernel, mxu_kernel

    return {"nbody_direct": direct_kernel.LAUNCHES,
            "nbody_mxu": mxu_kernel.LAUNCHES}


class _Counted:
    """The launches of one kernel over a ``with`` block, and the route
    they name."""

    def __init__(self, kernel: str, device: torch.device):
        self.kernel, self.on_card = kernel, device.type == "cuda"

    def __enter__(self):
        self.before = _launches()[self.kernel]
        return self

    def __exit__(self, *exc):
        self.count = _launches()[self.kernel] - self.before

    def fields(self) -> dict:
        return {"route": f"{self.kernel}.cu" if self.on_card else "plain",
                "launches": self.count}

    def ok(self) -> bool:
        """On the card the kernel must have launched."""
        return self.count > 0 or not self.on_card


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Median over rows of |a - b| / |b|, in float64."""
    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    na = np.linalg.norm(a - b, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    return float(np.median(na / np.maximum(nb, 1e-30)))


def physics_checks(device: torch.device, draw: Draw) -> dict:
    """The six checks of ``validate``, by name."""
    from .config import SimulationConfig
    from .ops import diagnostics as diag
    from .ops.adaptive import adaptive_run
    from .ops.encounters import merge_close_pairs
    from .ops.forces import pairwise_accelerations_dense
    from .ops.integrators import init_carry, make_step_fn
    from .simulation import Simulator
    from .utils.profiling import debug_check_forces

    checks = {}

    # 1. The active force kernel against the plain direct sum.
    state = draw("plummer", 2048, 0)
    with _Counted("nbody_direct", device) as c:
        res = debug_check_forces(state.positions, state.masses, eps=1e9)
    checks["kernel_cross_check"] = {
        "median_rel_err": res["median_rel_err"], **c.fields(),
        "ok": res["median_rel_err"] < 1e-3 and c.ok(),
    }

    # 2. The Earth's orbital closure over one year (leapfrog, dt = 1 h).
    cfg = SimulationConfig(
        model="solar", n=3, steps=int(365.25 * 24), dt=3600.0,
        integrator="leapfrog", force_backend="dense",
    )
    sim = Simulator(cfg, device=device)
    start = sim.state.positions[1].double().cpu().numpy()
    final = sim.run()["final_state"].positions[1].double().cpu().numpy()
    closure = float(np.linalg.norm(final - start) / np.linalg.norm(start))
    checks["earth_year_closure"] = {
        "rel_closure_err": closure, "ok": closure < 0.05,
    }

    # 3. Energy drift over 500 leapfrog steps on a Plummer sphere.
    cfg = SimulationConfig(
        model="plummer", n=512, steps=500, dt=3600.0, eps=1e10,
        integrator="leapfrog", force_backend="dense",
    )
    sim = Simulator(cfg, state=draw("plummer", 512, cfg.seed), device=device)
    e0 = float(diag.total_energy(sim.state, g=G, eps=1e10))
    e1 = float(diag.total_energy(sim.run()["final_state"], g=G, eps=1e10))
    drift = abs((e1 - e0) / e0)
    checks["leapfrog_energy_drift"] = {"drift": drift, "ok": drift < 0.01}

    # 4. yoshida4 against leapfrog on a circular two-body orbit.
    m_sun = 1.989e30
    r = 1.496e11
    v = float(np.sqrt(G * m_sun / r))

    def make(pos, vel, masses) -> ParticleState:
        return ParticleState.create(pos, vel, masses, dtype=torch.float32,
                                    device=device)

    base = make([[0.0, 0.0, 0.0], [r, 0.0, 0.0]],
                [[0.0, 0.0, 0.0], [0.0, v, 0.0]], [m_sun, 1.0e3])

    def accel(pos):
        return pairwise_accelerations_dense(pos, base.masses)

    # Long enough that leapfrog's truncation error clears the fp32
    # roundoff floor (~2e4 m at this radius) by orders of magnitude.
    t_total = 4.0e6

    def endpoint_err(integrator: str, n_steps: int) -> float:
        step = make_step_fn(integrator, accel, t_total / n_steps)
        st, acc = base, init_carry(accel, base)
        for _ in range(n_steps):
            st, acc = step(st, acc)
        theta = v / r * t_total
        exact = np.asarray([r * np.cos(theta), r * np.sin(theta), 0.0])
        got = st.positions[1].double().cpu().numpy()
        return float(np.linalg.norm(got - exact))

    # The same dt: yoshida4 (4th order, 3 evaluations) against leapfrog
    # (2nd, 1), a gap that fp32 roundoff cannot hide.
    e_lf = endpoint_err("leapfrog", 25)
    e_y4 = endpoint_err("yoshida4", 25)
    checks["yoshida4_vs_leapfrog"] = {
        "leapfrog_err_m": e_lf, "yoshida4_err_m": e_y4,
        "ok": e_y4 < e_lf / 20.0,
    }

    # 5. An adaptive run lands on t_end; a merge conserves mass and
    # momentum. An equal-mass circular binary: both bodies move, so the
    # velocity criterion is well conditioned on each.
    binary = make([[-r, 0.0, 0.0], [r, 0.0, 0.0]],
                  [[0.0, -v / 2, 0.0], [0.0, v / 2, 0.0]], [m_sun, m_sun])

    def accel_b(pos):
        return pairwise_accelerations_dense(pos, binary.masses)

    # At the JAX loop's default of 1e6 steps: the call stops within a
    # block of t_end, as the while_loop does at it.
    res = adaptive_run(binary, accel_b, t_end=1.0e5, dt_max=1.0e4, eta=0.05,
                       criterion="velocity")
    t_err = abs(float(res.t) - 1.0e5) / 1.0e5
    checks["adaptive_t_landing"] = {"rel_err": t_err, "ok": t_err < 1e-5}

    two = make([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
               [[0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], [1.0, 3.0])
    merged = merge_close_pairs(two, 2.0, k=4, chunk=2).state
    mass_err = abs(float(merged.masses.sum()) - 4.0)
    mom = (merged.masses[:, None] * merged.velocities).sum(dim=0)
    mom_err = float(np.abs(mom.double().cpu().numpy()
                           - np.asarray([-3.0, 0.0, 0.0])).max())
    checks["merge_conservation"] = {
        "mass_err": mass_err, "momentum_err": mom_err,
        "ok": mass_err < 1e-6 and mom_err < 1e-5,
    }
    return checks


def _sharded_mesh1(base: dict, device: torch.device, draw: Draw) -> float:
    """The sharded run's final positions against the unsharded run's, on
    a world of one: the one this process holds, or one made here and
    torn down after."""
    import torch.distributed as dist

    from .config import SimulationConfig
    from .simulation import Simulator

    made = not dist.is_initialized()
    try:
        state = draw(base["model"], base["n"], base["seed"])
        sh = Simulator(SimulationConfig(sharding="allgather",
                                        mesh_shape=(1,), **base),
                       state=state, device=device).run()["final_state"]
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    un = Simulator(SimulationConfig(**base), state=state,
                   device=device).run()["final_state"]
    return _rel_err(sh.positions, un.positions)


def _card() -> str:
    from .bench import nvidia_smi

    return nvidia_smi("name,power.limit") or "not read"


def gpu_battery(checks: dict, device: torch.device, draw: Draw) -> None:
    """``validate --gpu``: the eleven ``gpu_*`` records, added to
    ``checks``. At the JAX battery's on-chip sizes on the card, at its
    off-chip sizes on the CPU."""
    from .bench import run_benchmark
    from .config import PRESETS, SimulationConfig
    from .ops.direct_kernel import accelerations_vs_kernel
    from .ops.fmm import fmm_accelerations, fmm_potential_energy
    from .ops.forces import pairwise_accelerations_chunked, potential_energy
    from .ops.mxu_kernel import accelerations_vs_mxu_kernel
    from .ops.sfmm import resolve_sfmm_sizing, sfmm_accelerations
    from .ops.tree import recommended_depth_data, tree_accelerations

    on_card = device.type == "cuda"
    n_par = 16_384 if on_card else 512
    eps = 1.0e9

    state = draw("plummer", n_par, 1)
    pos, masses = state.positions, state.masses
    ref = pairwise_accelerations_chunked(pos, masses,
                                         chunk=min(2048, n_par), eps=eps)

    with _Counted("nbody_direct", device) as c:
        acc = accelerations_vs_kernel(pos, pos, masses, eps=eps)
    err = _rel_err(acc, ref)
    checks["gpu_pallas_parity"] = {
        "n": n_par, "median_rel_err": err, **c.fields(),
        "ok": err < 1e-3 and c.ok(),
    }
    # The Gram form, fp32 and bf16 operands with fp32 sums, at the JAX
    # battery's budgets.
    for name, precision, bar in (("gpu_pallas_mxu_parity", "fp32", 1e-3),
                                 ("gpu_pallas_mxu_bf16_parity", "bf16",
                                  0.01)):
        with _Counted("nbody_mxu", device) as c:
            acc = accelerations_vs_mxu_kernel(pos, pos, masses, eps=eps,
                                              precision=precision)
        err = _rel_err(acc, ref)
        checks[name] = {"n": n_par, "median_rel_err": err, **c.fields(),
                        "ok": err < bar and c.ok()}

    # The octree and the dense FMM on a disk (below ~2k bodies a disk is
    # too sparse for leaf statistics: a 2,048 floor), one depth for all.
    n_tree = max(n_par, 2048)
    disk = draw("disk", n_tree, 2)
    depth_d = recommended_depth_data(disk.positions)
    ref_d = pairwise_accelerations_chunked(
        disk.positions, disk.masses, chunk=min(2048, n_tree), g=1.0,
        eps=0.05)
    err = _rel_err(tree_accelerations(disk.positions, disk.masses,
                                      depth=depth_d, g=1.0, eps=0.05), ref_d)
    checks["gpu_tree_parity"] = {"n": n_tree, "median_rel_err": err,
                                 "ok": err < 0.05}
    err = _rel_err(fmm_accelerations(disk.positions, disk.masses,
                                     depth=depth_d, g=1.0, eps=0.05), ref_d)
    checks["gpu_fmm_parity"] = {"n": n_tree, "median_rel_err": err,
                                "ok": err < 0.01}
    e_dense = float(potential_energy(disk.positions, disk.masses, g=1.0,
                                     eps=0.05))
    e_fmm = float(fmm_potential_energy(disk.positions, disk.masses,
                                       depth=depth_d, g=1.0, eps=0.05))
    err = abs(e_fmm - e_dense) / max(abs(e_dense), 1e-300)
    checks["gpu_fmm_potential"] = {"n": n_tree, "rel_err": err,
                                   "ok": err < 0.02}
    cold = draw("cold_collapse", n_tree, 3)
    ref_c = pairwise_accelerations_chunked(
        cold.positions, cold.masses, chunk=min(2048, n_tree), eps=1.0e9)
    err = _rel_err(fmm_accelerations(
        cold.positions, cold.masses,
        depth=recommended_depth_data(cold.positions), eps=1.0e9), ref_c)
    checks["gpu_fmm_parity_cold"] = {"n": n_tree, "median_rel_err": err,
                                     "ok": err < 0.01}
    s_depth, s_cap, s_k = resolve_sfmm_sizing(disk.positions, 0, 32)
    err = _rel_err(sfmm_accelerations(
        disk.positions, disk.masses, depth=s_depth, leaf_cap=s_cap,
        k_cells=s_k, g=1.0, eps=0.05), ref_d)
    checks["gpu_sfmm_parity_disk"] = {
        "n": n_tree, "depth": s_depth, "cap": s_cap,
        "median_rel_err": err, "ok": err < 0.01,
    }

    # The sharded path (allgather on a (1,) mesh): a pod's program minus
    # the wires.
    n_sh = 4096 if on_card else 256
    base = dict(model="plummer", n=n_sh, steps=2, dt=3600.0, eps=eps,
                integrator="leapfrog", seed=2,
                force_backend="pallas" if on_card else "dense")
    with _Counted("nbody_direct", device) as c:
        err = _sharded_mesh1(base, device, draw)
    checks["gpu_sharded_mesh1"] = {"n": n_sh, "median_rel_err": err,
                                   **c.fields(),
                                   "ok": err < 1e-6 and c.ok()}

    # A 5-step bench line.
    n_b = 65_536 if on_card else 2048
    bar = GPU_BENCH_BAR if on_card else CPU_BENCH_BAR
    with _Counted("nbody_direct", device) as c:
        stats = run_benchmark(SimulationConfig(
            model="plummer", n=n_b, dt=3600.0, eps=eps,
            integrator="leapfrog",
            force_backend="pallas" if on_card else "chunked"),
            bench_steps=5, device=device)
    pps = stats["pairs_per_sec_per_chip"]
    record = {
        "n": n_b, "pairs_per_sec_per_chip": pps,
        "avg_step_s": stats["avg_step_s"], "platform": stats["platform"],
        "bar": bar, "ok": pps > bar and c.ok(),
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    if on_card:
        record.update(c.fields(), card=_card(),
                      bar_source=f"half of nbody_direct.cu's rate at "
                                 f"65,536 on an {CARD}")
    checks["gpu_bench_5step"] = record

    # The 2M direct sum: 3 steps of baseline-2m, on the card only (4.4e12
    # pairs a step is hours on host cores).
    if on_card:
        with _Counted("nbody_direct", device) as c:
            stats_2m = run_benchmark(PRESETS["baseline-2m"], bench_steps=3,
                                     device=device)
        pps_2m = stats_2m["pairs_per_sec_per_chip"]
        checks["gpu_2m_direct_3step"] = {
            "n": stats_2m["n"], "backend": stats_2m["backend"],
            "pairs_per_sec_per_chip": pps_2m,
            "avg_step_s": stats_2m["avg_step_s"], **c.fields(),
            "bar": GPU_2M_BAR, "card": _card(),
            "bar_source": f"half of baseline-2m's rate on an {CARD}",
            "ok": pps_2m > GPU_2M_BAR and c.ok(),
            "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
        }
    else:
        checks["gpu_2m_direct_3step"] = {
            "skipped": "no card (the 2M direct sum is hours on the CPU)",
            "ok": True,
        }


def run_validate(device, *, gpu: bool = False) -> dict:
    """``{"ok", "checks"}``: the physics checks, and with ``gpu`` the card
    gate, on ``device`` (the card unless ``"cpu"`` is asked for; with no
    card that raises)."""
    from .utils.platform import resolve_device

    device = resolve_device(device)
    draw = default_draw(device)
    checks = physics_checks(device, draw)
    if gpu:
        gpu_battery(checks, device, draw)
    return {"ok": all(c["ok"] for c in checks.values()), "checks": checks}
