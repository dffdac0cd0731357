"""The rest of ROADMAP item 7 against the JAX package, on the CPU: P3M's
rectangular kernel (the multirate kick, sized by its target slots), P3M's
``slice`` short-range pass, and bf16 states through the FMM in its dense
and sparse layouts.

Inputs are drawn with numpy from a seed and given to both packages. Bars:

- the P3M kick and the slice pass in fp64: every row within 1e-12 of the
  largest |a| (the two packages add the same pair terms in other orders;
  ``tests/test_torch_p3m.py``'s fp64 bar is 1e-13 of the mean);
- a 3-step multirate P3M run in fp64: rows within 1e-9 of |row|;
- the kick's ``t_cap`` and the density warning's text: equal;
- bf16 FMM: against the JAX package at bf16, per target in units of its
  own |a|, a median of 2^-7 and a maximum of 2^-3, the bars of
  ``tests/test_torch_tree_bf16.py`` (the two round the same bf16 ops, XLA
  with excess precision inside its fusions and torch op by op; measured a
  median of 0.0046 dense and 0.0064 sparse, a maximum of 0.028 and
  0.046); and the port's bf16-against-fp32 median at most 1.5x the JAX
  package's own;
- the bf16 sparse FMM's segment sums take the bf16 chain, never an fp32
  sum.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu import simulation as jax_sim
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import fmm as jax_fmm
from gravity_tpu.ops import p3m as jax_p3m
from gravity_tpu.ops import sfmm as jax_sfmm
from conftest import REPO_ROOT
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch import simulation
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.ops import cells, fmm, p3m, sfmm
from gravity_tpu_torch.state import ParticleState

ROW_TOL_F64 = 1e-12
RUN_TOL_F64 = 1e-9
BF16_MEDIAN = 2.0**-7
BF16_MAX = 2.0**-3
BF16_VS_F32_RATIO = 1.5
GALAXY = dict(g=1.0, eps=0.05)
# The multirate P3M kick: 2,048 disk bodies, 64 fast targets (t_cap 49 of
# the cap's 64 on this disk's 9^3 binning grid).
KICK = dict(model="disk", n=2048, pm_grid=48, p3m_cap=64,
            integrator="multirate", multirate_k=64, **GALAXY)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _disk(n, seed, dtype=np.float64):
    """A thin exponential disk of mass 5 with circular-ish velocities."""
    rng = np.random.default_rng(seed)
    r = rng.exponential(3.0, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = np.stack([r * np.cos(phi), r * np.sin(phi),
                    0.3 * rng.normal(size=n)], axis=1)
    v = np.sqrt(5.0 / np.maximum(r, 0.1))
    vel = np.stack([-v * np.sin(phi), v * np.cos(phi),
                    0.05 * rng.normal(size=n)], axis=1)
    m = np.full(n, 5.0 / n)
    return pos.astype(dtype), vel.astype(dtype), m.astype(dtype)


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_rows(got, want) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want, axis=1)
            / np.linalg.norm(want, axis=1))


# --- P3M's rectangular kernel ---------------------------------------------


@pytest.mark.parametrize("short", ["gather", "nlist", "slice"])
def test_p3m_kick_matches_jax(short, x64):
    """make_local_kernel's p3m branch with the K-target hint: the same
    t_cap (below the source cap, sized on the binning grid the kernel
    runs on) and the same forces on K targets."""
    pos, _, m = _disk(KICK["n"], 3)
    fields = dict(KICK, p3m_short=short, dtype="float64")
    k = KICK["multirate_k"]
    jk = jax_sim.make_local_kernel(JaxConfig(**fields), "p3m",
                                   positions=jnp.asarray(pos), k_targets=k)
    pk = simulation.make_local_kernel(SimulationConfig(**fields), "p3m",
                                      positions=torch.from_numpy(pos),
                                      k_targets=k)
    side = p3m.binning_side(KICK["pm_grid"], 1.25, 4.0)
    assert pk.sizing == (side, KICK["p3m_cap"], jk.keywords["t_cap"])
    assert 0 < pk.sizing[2] < KICK["p3m_cap"]
    idx = np.random.default_rng(4).choice(KICK["n"], k, replace=False)
    want = np.asarray(jk(jnp.asarray(pos[idx]), jnp.asarray(pos),
                         jnp.asarray(m)))
    got = pk(torch.from_numpy(pos[idx]), torch.from_numpy(pos),
             torch.from_numpy(m)).numpy()
    assert _max_rel(got, want) <= ROW_TOL_F64


def test_p3m_kick_density_warning_matches_jax():
    """A clump holding half the bodies: even the full cap cannot hold the
    modeled fast-rung load, and both packages say so in the same words."""
    pos, _, m = _disk(KICK["n"], 5, np.float32)
    pos[: KICK["n"] // 2] *= 1e-3
    fields = dict(KICK)
    with pytest.warns(UserWarning, match="fast-rung target slots") as jw:
        jk = jax_sim.make_local_kernel(JaxConfig(**fields), "p3m",
                                       positions=jnp.asarray(pos),
                                       k_targets=1024)
    with pytest.warns(UserWarning, match="fast-rung target slots") as pw:
        pk = simulation.make_local_kernel(SimulationConfig(**fields), "p3m",
                                          positions=torch.from_numpy(pos),
                                          k_targets=1024)
    texts = [{str(w.message) for w in ws if "fast-rung" in str(w.message)}
             for ws in (jw, pw)]
    assert texts[0] == texts[1]
    assert pk.sizing[2] == jk.keywords["t_cap"] == KICK["p3m_cap"]


def _state_pair(n, seed, dtype=np.float64):
    pos, vel, m = _disk(n, seed, dtype)
    return (JaxState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(m)),
            ParticleState(*(torch.from_numpy(a) for a in (pos, vel, m))))


@pytest.mark.parametrize("fields", [
    dict(integrator="multirate", multirate_k=32, p3m_short="gather"),
    dict(integrator="multirate", multirate_k=32, p3m_short="nlist"),
    dict(integrator="leapfrog", p3m_short="slice"),
], ids=["multirate-gather", "multirate-nlist", "slice"])
def test_p3m_runs_match_jax(fields, x64):
    """``--integrator multirate --force-backend p3m`` (the kicks at t_cap
    < cap) and ``--p3m-short slice``: three fp64 steps against the JAX
    Simulator."""
    jax_state, state = _state_pair(512, 7)
    cfg = dict(model="disk", n=512, force_backend="p3m", pm_grid=32,
               p3m_cap=64, steps=3, dt=2e-3, dtype="float64", **GALAXY,
               **fields)
    want = jax_sim.Simulator(JaxConfig(**cfg), state=jax_state).run()
    got = simulation.Simulator(SimulationConfig(**cfg), state=state,
                               device="cpu").run()
    for f in ("positions", "velocities"):
        rel = _rel_rows(getattr(got["final_state"], f).numpy(),
                        getattr(want["final_state"], f))
        assert rel.max() < RUN_TOL_F64, (f, rel.max())
    if fields["integrator"] == "multirate":
        assert 0 < got["kick_t_cap"] < cfg["p3m_cap"]


# --- P3M's slice pass ------------------------------------------------------


def _binned(pos, m, *, grid, cap, t_cap):
    """The short-range pass's inputs, binned by the port (the JAX and
    port functions then take the same arrays)."""
    tp, tm = torch.from_numpy(pos), torch.from_numpy(m)
    origin, span = cells.bounding_cube(tp)
    sigma = 1.25 * span / (grid - 1)
    alpha = 1.0 / (np.sqrt(2.0) * sigma)
    rcut = 4.0 * sigma
    side = p3m.binning_side(grid, 1.25, 4.0)
    coords = cells.grid_coords(tp, origin, span, side)
    ids = cells.cell_ids(coords, side)
    cells_pos, cells_mass, count, _, _, _ = cells.bin_to_cells(
        tp, tm, coords, side, cap)
    tcells_pos = cells.bin_to_cells(tp, torch.ones_like(tm), coords, side,
                                    t_cap)[0]
    m_scale = tm.max()
    m_hat = tm / m_scale
    cmass_hat = cells.segment_sum(m_hat, ids, side**3)
    ccom = cells.segment_sum(m_hat[:, None] * tp, ids, side**3) \
        / torch.clamp_min(cmass_hat, 1e-37)[:, None]
    return (tcells_pos, t_cap, cells_pos, cells_mass, count, cmass_hat, ccom,
            m_scale, span, side, cap, 1.0, 1e-10, 0.05, alpha, rcut)


@pytest.mark.parametrize("cap,t_cap", [(16, 16), (4, 2)],
                         ids=["self", "overflow"])
def test_slice_pass_matches_jax_short_range_shifted(cap, t_cap, x64):
    """``_short_range_shifted`` on the same binned fp64 inputs; the
    overflow case has cells past both caps (the remainder monopoles)."""
    pos, _, m = _disk(1024, 9)
    args = _binned(pos, m, grid=24, cap=cap, t_cap=t_cap)
    if cap == 4:
        assert bool((args[4] > cap).any())
    got = p3m._short_range_shifted(*args).numpy()
    j = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
         for a in args]
    for i in (8, 14, 15):  # span, alpha, rcut: scalars in the JAX call
        j[i] = float(args[i])
    want = np.asarray(jax_p3m._short_range_shifted(*j, jnp.float64))
    assert got.shape == want.shape
    assert _max_rel(got, want) <= ROW_TOL_F64


# --- bf16 FMM states -------------------------------------------------------


FMM_KW = dict(depth=4, leaf_cap=32, g=1.0, eps=0.05)
SFMM_KW = dict(FMM_KW, k_cells=512, k_chunk=128)


@functools.lru_cache(maxsize=None)
def _jax_fmm(backend: str, dtype: str):
    pos, _, m = _disk(1024, 11)
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    fn, kw = ((jax_fmm.fmm_accelerations, FMM_KW) if backend == "fmm"
              else (jax_sfmm.sfmm_accelerations, SFMM_KW))
    return np.asarray(fn(jnp.asarray(pos, jdt), jnp.asarray(m, jdt),
                         **kw).astype(jnp.float32))


def _port_fmm(backend: str, dtype: str):
    pos, _, m = _disk(1024, 11)
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    fn, kw = ((fmm.fmm_accelerations, FMM_KW) if backend == "fmm"
              else (sfmm.sfmm_accelerations, SFMM_KW))
    out = fn(torch.tensor(pos, dtype=tdt), torch.tensor(m, dtype=tdt), **kw)
    assert out.dtype == tdt and bool(torch.isfinite(out).all())
    return out.float().numpy()


def _chip_smoke():
    """chip_smoke.py, loaded as a module (it imports nothing at the top
    but the standard library)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("backend", ["fmm", "sfmm"])
def test_bf16_fmm_matches_jax(backend):
    """Also pins the JAX figure that chip_smoke.py's ``fmm_bf16_path``
    holds the card to (FMM_BF16_JAX_CPU), on the same inputs (its
    ``fmm_bf16_disk`` is this file's disk)."""
    got_bf16, got_f32 = (_port_fmm(backend, d)
                         for d in ("bfloat16", "float32"))
    want_bf16, want_f32 = (_jax_fmm(backend, d)
                           for d in ("bfloat16", "float32"))
    rel = _rel_rows(got_bf16, want_bf16)
    assert np.median(rel) < BF16_MEDIAN and rel.max() < BF16_MAX, \
        (np.median(rel), rel.max())
    port_err = np.median(_rel_rows(got_bf16, got_f32))
    jax_err = np.median(_rel_rows(want_bf16, want_f32))
    assert port_err <= BF16_VS_F32_RATIO * jax_err, (port_err, jax_err)
    smoke = _chip_smoke()
    assert smoke.FMM_BF16_JAX_CPU[backend] == pytest.approx(jax_err,
                                                            rel=1e-6)
    pos, _, m = _disk(1024, 11)
    p2, m2 = smoke.fmm_bf16_disk(**smoke.FMM_BF16_STATE)
    assert np.array_equal(pos, p2) and np.array_equal(m, m2)
    kw = FMM_KW if backend == "fmm" else SFMM_KW
    assert smoke.FMM_BF16_KW[backend] == kw


def test_bf16_sparse_fmm_sums_take_the_bf16_chain(monkeypatch):
    """At bf16 ``sorted_segment_sum`` is the bf16 segment sum (the plain
    chain here, ``segment_sum.cu`` on the card): the JAX scatter-add's
    bits, never an fp32 sum rounded once."""
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(np.sort(rng.integers(0, 40, 3000)))
    values = torch.from_numpy(rng.normal(size=(3000, 4))).to(torch.bfloat16)
    fp_sum = cells._sum_sorted

    def no_bf16(v, *args):
        assert v.dtype != torch.bfloat16, "a bf16 sum took the fp32 path"
        return fp_sum(v, *args)

    monkeypatch.setattr(cells, "_sum_sorted", no_bf16)
    got = cells.sorted_segment_sum(values, ids, 40)
    assert torch.equal(got, cells.segment_sum_bf16_plain(values, ids, 40))
    _port_fmm("sfmm", "bfloat16")


@pytest.mark.parametrize("backend", ["fmm", "sfmm"])
def test_cli_runs_bf16_fmm(backend, tmp_path, capsys):
    from gravity_tpu_torch.cli import main

    assert main(["run", "--device", "cpu", "--model", "disk", "--n", "512",
                 "--g", "1.0", "--dt", "2e-3", "--eps", "0.05",
                 "--integrator", "leapfrog", "--steps", "2",
                 "--force-backend", backend, "--dtype", "bfloat16",
                 "--log-dir", str(tmp_path)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (stats["backend"], stats["dtype"]) == (backend, "bfloat16")
    assert stats["fmm_mode"] == ("sparse" if backend == "sfmm"
                                 else stats["fmm_mode"])


def test_cli_runs_multirate_p3m(tmp_path, capsys):
    from gravity_tpu_torch.cli import main

    assert main(["run", "--device", "cpu", "--model", "disk", "--n", "1024",
                 "--g", "1.0", "--dt", "2e-3", "--eps", "0.05",
                 "--force-backend", "p3m", "--pm-grid", "32", "--p3m-cap",
                 "32", "--integrator", "multirate", "--multirate-k", "16",
                 "--steps", "2", "--log-dir", str(tmp_path)]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["backend"] == "p3m" and stats["multirate_k"] == 16
    assert 0 < stats["kick_t_cap"] < stats["p3m_cap"] == 32


def test_kick_sizing_is_reported_from_the_binning_grid():
    """The kick's t_cap is sized on binning_side(grid, sigma, rcut), not
    on the mesh: a Simulator reports the kernel's own sizing."""
    _, state = _state_pair(1024, 13, np.float32)
    cfg = SimulationConfig(**dict(KICK, n=1024, multirate_k=64,
                                  force_backend="p3m"))
    sim = simulation.Simulator(cfg, state=state, device="cpu")
    side = p3m.binning_side(cfg.pm_grid, cfg.p3m_sigma_cells,
                            cfg.p3m_rcut_sigmas)
    assert sim.kick_sizing[:2] == (side, cfg.p3m_cap)
    want = simulation._occupancy_t_cap(cfg.p3m_cap, 64, cfg.n,
                                       state.positions, side, "p3m kernel")
    assert sim.kick_sizing[2] == want < cfg.p3m_cap
