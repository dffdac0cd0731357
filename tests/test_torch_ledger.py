"""The port's conservation ledger (``gravity_tpu_torch/ops/diagnostics.py``
and the Simulator's ledger) against the JAX package's, on the CPU.

The same numpy inputs go through both packages. Tolerances: 1e-12
relative in fp64 (the same formulas, summed in another order) and 1e-5
in fp32 (a few ulps of each summed term); the large-N tree potential 1e-5
in fp32. A whole run's drifts are compared where they are physical
(energy at a dt that leapfrog resolves poorly, the COM's motion), 1e-5
relative; the momentum and angular-momentum drifts there are round-off,
held under 1e-6 in both packages. The rest mirrors the solo-run part of
``tests/test_numerics_observatory.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import diagnostics as jdiag
from gravity_tpu.ops.tree import _tree_pe_scaled as jax_tree_pe
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import diagnostics as diag
from gravity_tpu_torch.ops import tree
from gravity_tpu_torch.ops.external import parse_external
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.utils.profiling import MetricsLogger
from gravity_tpu_torch.utils.trajectory import TrajectoryReader, TrajectoryWriter

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(n, dtype=np.float32, seed=3, pad=0, cold=False):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)) * 1e11
    vel = np.zeros((n, 3)) if cold else rng.standard_normal((n, 3)) * 1e4
    m = rng.random(n) * 1e29 + 1e28
    if pad:
        pos = np.concatenate([pos, np.repeat(pos[:1], pad, 0)])
        vel = np.concatenate([vel, np.zeros((pad, 3))])
        m = np.concatenate([m, np.zeros(pad)])
    return pos.astype(dtype), vel.astype(dtype), m.astype(dtype)


def _vec_scales(pos, vel, m):
    """Each ledger_vec component's scale: its sum of |terms|."""
    pos, vel, m = (np.asarray(a, np.float64) for a in (pos, vel, m))
    m_hat = m / m.max()
    w = m_hat / m_hat.sum()
    p = (m_hat[:, None] * np.abs(vel)).sum(0)
    l_mag = (m_hat * np.linalg.norm(pos, axis=1)
             * np.linalg.norm(vel, axis=1)).sum()
    com = (w[:, None] * np.abs(pos)).sum(0)
    r2 = (w * (pos ** 2).sum(1)).sum()
    return [1.0, m_hat.sum(), 0.5 * (m_hat * (vel ** 2).sum(1)).sum(),
            *p, l_mag, l_mag, l_mag, *com, r2]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got - want).max() <= rtol * scale, (got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pad", [0, 9])
def test_ledger_vec_matches_jax(dtype, pad, x64):
    pos, vel, m = _arrays(40, dtype, pad=pad)
    got = diag.ledger_vec(_t(pos), _t(vel), _t(m)).numpy()
    want = np.asarray(jdiag.ledger_vec(jnp.asarray(pos), jnp.asarray(vel),
                                       jnp.asarray(m)))
    assert got.dtype == want.dtype == dtype
    # Each component against the sum of its terms' magnitudes (they span
    # ~40 decades, and the momentum and L components cancel).
    for g, w, scale in zip(got, want, _vec_scales(pos, vel, m)):
        _close(g, w, RTOL[dtype], scale=scale)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rcut,eps,chunk", [(0.0, 0.0, 4096),
                                            (0.0, 1e9, 16),
                                            (1.2e11, 1e9, 16)])
def test_pe_hat_dense_matches_jax(dtype, rcut, eps, chunk, x64):
    """Plain, softened, and the truncated family's shifted kernel, one
    block and chunked."""
    pos, _, m = _arrays(40, dtype, pad=5)
    got = diag.pe_hat_dense(_t(pos), _t(m), eps=eps, rcut=rcut, chunk=chunk)
    want = jdiag.pe_hat_dense(jnp.asarray(pos), jnp.asarray(m), eps=eps,
                              rcut=rcut, chunk=chunk)
    _close(got.item(), float(want), RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ledger_host_and_drift_match_jax(dtype, x64):
    """The float64 host ledger and the drifts between two states, with an
    external potential term."""
    (p0, v0, m), (p1, v1, _) = _arrays(32, dtype, 1), _arrays(32, dtype, 2)
    ledgers = []
    for pos, vel in ((p0, v0), (p1, v1)):
        vec_t = diag.ledger_vec(_t(pos), _t(vel), _t(m))
        pe_t = diag.pe_hat_dense(_t(pos), _t(m))
        vec_j = jdiag.ledger_vec(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.asarray(m))
        pe_j = jdiag.pe_hat_dense(jnp.asarray(pos), jnp.asarray(m))
        ext = np.asarray(3.5e27, dtype)
        ledgers.append((
            diag.ledger_host(vec_t, pe_t, g=6.67e-11, ext=_t(ext)),
            jdiag.ledger_host(vec_j, pe_j, g=6.67e-11, ext=jnp.asarray(ext))))
    for got, want in ledgers:
        for key in ("m_sum", "kinetic", "potential", "energy", "r_rms"):
            _close(got[key], want[key], RTOL[dtype])
        for key in ("momentum", "ang_mom", "com"):
            _close(got[key], want[key], RTOL[dtype])
    (g0, w0), (g1, w1) = ledgers
    got, want = diag.ledger_drift(g0, g1), jdiag.ledger_drift(w0, w1)
    for key in want:
        _close(got[key], want[key], 1e-4 if dtype == np.float32 else 1e-10)
    assert diag.ledger_drift(g0, g0) == {
        "energy_drift": 0.0, "momentum_drift": 0.0, "angmom_drift": 0.0,
        "com_drift": 0.0}
    no_pe = diag.ledger_host(np.asarray(vec_t), pe_kind="none")
    assert no_pe["energy"] is None
    assert diag.ledger_drift(no_pe, no_pe)["energy_drift"] is None


def test_ledger_large_n_tree_branch_matches_jax():
    """Above LEDGER_DENSE_MAX the Simulator prices the energy with the
    octree's scaled potential, the JAX package's CPU branch: the same
    sums to 1e-5 relative in fp32."""
    n = diag.LEDGER_DENSE_MAX + 116
    pos, vel, m = _arrays(n, np.float32, seed=8)
    depth, cap, chunk = 4, 32, 4096
    s_t, sc_t = tree._tree_pe_scaled(
        _t(pos), _t(m), depth=depth, leaf_cap=cap, chunk=chunk, ws=1,
        cutoff=1e-10, eps=1e9, quad=True)
    s_j, sc_j = jax_tree_pe(jnp.asarray(pos), jnp.asarray(m), depth=depth,
                            leaf_cap=cap, chunk=chunk, ws=1, cutoff=1e-10,
                            eps=1e9, quad=True)
    _close(s_t.item(), float(s_j), 1e-5)
    assert sc_t.item() == float(sc_j)
    sim = Simulator(SimulationConfig(model="random", n=n, eps=1e9,
                                     force_backend="dense", tree_depth=depth,
                                     ledger=True),
                    state=state_from_numpy(pos, vel, m, device="cpu"),
                    device="cpu")
    assert sim.ledger_pe_kind == "tree"
    led = sim.ledger_of()
    want = jdiag.ledger_host(
        jdiag.ledger_vec(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(m)),
        s_j, sc_j, g=sim.config.g, pe_kind="tree")
    _close(led["energy"], want["energy"], 1e-5)


def _run_pair(dtype, **kw):
    pos, vel, m = _arrays(64, dtype)
    cfg = dict(model="random", n=64, steps=8, dt=3e6, eps=5e10,
               integrator="leapfrog", force_backend="dense", ledger=True,
               sentinel_every=1, progress_every=2,
               dtype=np.dtype(dtype).name, **kw)
    jax_stats = JaxSimulator(JaxConfig(**cfg), state=JaxState(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(m))).run()
    stats = Simulator(SimulationConfig(**cfg), state=state_from_numpy(
        pos, vel, m, dtype=getattr(torch, np.dtype(dtype).name),
        device="cpu"), device="cpu").run()
    return stats, jax_stats


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
def test_run_ledger_drifts_match_jax(dtype, rtol, x64):
    """A whole run with the ledger and the sentinel every block: the
    energy (its drift 0.068 here), the COM drift and the sentinel's
    verdict as the JAX package's."""
    stats, jax_stats = _run_pair(dtype)
    led, jled = stats["ledger"], jax_stats["ledger"]
    assert led["blocks"] == jled["blocks"] == 4
    for key in ("energy_drift", "max_energy_drift", "com_drift"):
        _close(led[key], jled[key], rtol)
    _close(stats["total_energy"], jax_stats["total_energy"], rtol)
    for key in ("momentum_drift", "angmom_drift"):
        assert led[key] < 1e-6 and jled[key] < 1e-6
    assert led["energy_drift"] > 0.01
    assert stats["sentinel"] == {**jax_stats["sentinel"]}


def test_ledger_bitwise_parity_and_alias(tmp_path):
    """Ledger on, off and the deprecated metrics_energy alias give the
    same trajectory frames and final state, bit for bit: the ledger only
    reads."""
    pos, vel, m = _arrays(32, seed=7)

    def run(tag, **kw):
        cfg = SimulationConfig(model="random", n=32, steps=40, seed=7,
                               progress_every=10, io_pipeline="on", **kw)
        w = TrajectoryWriter(str(tmp_path / tag), 32, every=1)
        sim = Simulator(cfg, state=state_from_numpy(pos, vel, m,
                                                    device="cpu"),
                        device="cpu")
        stats = sim.run(trajectory_writer=w)
        return stats, TrajectoryReader(str(tmp_path / tag)).load(mmap=False)

    s_off, t_off = run("off")
    with pytest.deprecated_call():
        s_alias, t_alias = run("alias", metrics_energy=True)
    s_on, t_on = run("on", ledger=True)
    assert np.array_equal(t_off, t_on) and np.array_equal(t_off, t_alias)
    assert torch.equal(s_off["final_state"].positions,
                       s_on["final_state"].positions)
    assert "ledger" in s_alias and "ledger" in s_on and "ledger" not in s_off
    assert s_alias["ledger"]["energy_drift"] == s_on["ledger"]["energy_drift"]


def test_ledger_drift_small_for_symplectic_run(tmp_path):
    """Leapfrog conserves: every ledger axis stays small, and the metrics
    stream carries the per-block series."""
    ml = MetricsLogger(str(tmp_path / "m.jsonl"))
    cfg = SimulationConfig(model="random", n=48, steps=40, eps=1e9,
                           ledger=True, progress_every=10, seed=1)
    stats = Simulator(cfg, device="cpu").run(metrics_logger=ml)
    led = stats["ledger"]
    assert led["blocks"] == 4 and led["pe_kind"] == "dense"
    assert led["max_energy_drift"] < 1e-4
    assert led["momentum_drift"] < 1e-6 and led["angmom_drift"] < 1e-5
    recs = ml.read()
    assert [r["step"] for r in recs] == [10, 20, 30, 40]
    for r in recs:
        for k in ("total_energy", "energy_drift", "momentum_drift",
                  "angmom_drift", "com_drift", "pairs_per_sec"):
            assert k in r, (k, r)


def test_truncated_ledger_energy_conserved():
    """The rcut-shifted potential is the one whose gradient is the masked
    force: a truncated run conserves the ledger's energy."""
    cfg = SimulationConfig(model="random", n=48, steps=60,
                           force_backend="dense", nlist_rcut=2.0e11,
                           eps=1e9, ledger=True, progress_every=15, seed=2)
    stats = Simulator(cfg, device="cpu").run()
    assert stats["ledger"]["max_energy_drift"] < 5e-3


def test_ledger_cold_start_momentum_scale():
    """Zero initial velocities (KE0 = 0) take the virial momentum scale:
    the momentum drift stays O(round-off), not ~1e290."""
    pos, vel, m = _arrays(32, seed=4, cold=True)
    cfg = SimulationConfig(model="random", n=32, steps=20, eps=1e9,
                           integrator="leapfrog", ledger=True,
                           progress_every=5)
    stats = Simulator(cfg, state=state_from_numpy(pos, vel, m, device="cpu"),
                      device="cpu").run()
    assert stats["ledger"]["momentum_drift"] < 1e-3


def test_ledger_includes_external_potential():
    """An --external run's ledger energy is KE + PE_self + PE_ext, the
    energy diagnostic's (fp64 here, 1e-12)."""
    spec = "pointmass:gm=1.3e20"
    pos, vel, m = _arrays(24, np.float64, seed=6)
    cfg = SimulationConfig(model="random", n=24, steps=4, external=spec,
                           dtype="float64", ledger=True, progress_every=2)
    sim = Simulator(cfg, state=state_from_numpy(
        pos, vel, m, dtype=torch.float64, device="cpu"), device="cpu")
    led = sim.ledger_of()
    want = diag.total_energy(sim.state, external_phi=parse_external(
        spec, kind="potential"))
    _close(led["energy"], want.item(), 1e-12)


def test_radial_density_profile_matches_jax(x64):
    pos, vel, m = _arrays(200, np.float64, seed=9)
    r_t, rho_t = diag.radial_density_profile(
        state_from_numpy(pos, vel, m, dtype=torch.float64, device="cpu"),
        bins=12)
    r_j, rho_j = jdiag.radial_density_profile(JaxState(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(m)), bins=12)
    _close(r_t.numpy(), np.asarray(r_j), 1e-12)
    _close(rho_t.numpy(), np.asarray(rho_j), 1e-10)


def test_merging_run_rebaselines_the_ledger():
    """A merger dissipates energy; the ledger takes a new baseline after
    it, so its drift stays an integrator's."""
    pos, vel, m = _arrays(32, seed=12)
    pos[1] = pos[0] + 1e8  # one pair inside the radius
    cfg = SimulationConfig(model="random", n=32, steps=20, eps=1e9,
                           merge_radius=1e9, merge_every=5, ledger=True,
                           progress_every=5)
    stats = Simulator(cfg, state=state_from_numpy(pos, vel, m, device="cpu"),
                      device="cpu").run()
    assert stats["merged_pairs"] >= 1 and stats["io_pipeline"] == "off"
    assert stats["ledger"]["energy_drift"] < 1e-3
