"""bf16 states through the port's cutoff-radius cell list, against the JAX
package at bf16 on the CPU.

The same numpy inputs, rounded to bf16, go through
``gravity_tpu.ops.pallas_nlist`` (its jnp engine, and its Pallas kernel in
interpret mode) and ``gravity_tpu_torch.ops.nlist`` (its plain tile
engine, what a CPU tensor runs; the CUDA kernel's bf16 form keeps the
same contract, held on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Tolerances are in units of each row's sum of |terms| (float64, the scale
a row's roundings act on), per component:

- ``BAND``: where bf16's rounding of r^2 can put a pair on either side
  of rcut, |r^2 - rcut_eff^2| <= 2^-6 rcut_eff^2 (r^2 is one bf16
  rounding of three rounded squares: a few 2^-9 of r^2 apart between
  the engines), the pair may be in one sum and not the other, so the
  terms of those pairs are added to the bar whole;
- beyond that, 2^-5 of the row's sum of |terms|: both engines round each
  op of a term to bf16 (2^-9 each, a few per term), the JAX engines with
  XLA's excess precision inside a fusion, and each rounds every
  (cell, offset) row and its bf16 accumulator once an offset (27
  roundings of 2^-9 of at most the sum of |terms|, of either sign).
  Measured here: at most 0.020 (5 x 2^-8), p99 near 0.01.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import pallas_nlist as jax_nlist
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.ops import nlist
from gravity_tpu_torch.ops.cells import bin_to_cells, grid_coords, segment_sum
from gravity_tpu_torch.simulation import Simulator

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
G1 = dict(g=1.0, eps=0.5)
CUTOFF = 1e-10
# Bars, in units of each row's sum of |terms| (module docstring).
BAND = 2.0**-6
TERM_TOL = 2.0**-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cloud(n, span=100.0, seed=0):
    """Positions and masses drawn with numpy and rounded to bf16, as float32
    arrays (which hold every bf16 value exactly)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, span, (n, 3))
    m = rng.uniform(0.0, 1.0, n) + 0.5
    return (torch.from_numpy(pos).to(BF16).float().numpy(),
            torch.from_numpy(m).to(BF16).float().numpy())


def _jax_bf16(*arrays):
    return tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays)


def _port_bf16(*arrays):
    return tuple(torch.from_numpy(np.array(a)).to(BF16) for a in arrays)


def _to64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _scale_and_band(targets, pos, m, rcut2, g=1.0, eps=0.5):
    """Per target and component, in float64: the sum of |w d| over the
    pairs within rcut (widened by the band), and the part of it from the
    pairs in the band |r^2 - rcut2| <= BAND rcut2 (rcut2 None: no
    truncation, no band)."""
    diff = pos[None, :, :] - targets[:, None, :]
    r2 = (diff**2).sum(-1)
    w = g * m[None, :] / np.maximum(r2 + eps * eps, 1e-300) ** 1.5
    w[r2 <= 0] = 0.0
    band = np.zeros_like(r2, bool)
    if rcut2 is not None:
        w[r2 > rcut2 * (1 + BAND)] = 0.0
        band = np.abs(r2 - rcut2) <= BAND * rcut2
    terms = w[..., None] * np.abs(diff)
    return terms.sum(1), np.where(band[..., None], terms, 0.0).sum(1)


def _excess(got, want, scale, band) -> float:
    """max over components of (|got - want| - band) / scale."""
    err = np.abs(got - want) - band
    return float((np.maximum(err, 0.0) / scale)[scale > 0].max())


def _tiles(pos, m, side, cap, t_cap, rcut, n_targets=None):
    """bf16 tile arguments as nlist_accelerations_vs builds them (the
    targets the first ``n_targets`` bodies, binned at ``t_cap``)."""
    tp, tm = _port_bf16(pos, m)
    origin, span, params, _, binned = nlist.source_cells(
        tp, tm, rcut=rcut, side=side, cap=cap)
    cells_pos, cells_m, count = binned[:3]
    targets = tp[:n_targets] if n_targets else tp
    tcells, _, t_count, *_ = bin_to_cells(
        targets, torch.ones_like(targets[:, 0]),
        grid_coords(targets, origin, span, side), side, t_cap)
    return tcells, t_count, cells_pos, cells_m, count, params


@pytest.mark.parametrize("use_rcut,t_cap,n_targets", [
    (True, 32, None),    # nlist's form, targets = sources
    (False, 32, None),   # the octree's near field: no truncation
    (True, 8, 96),       # a multirate kick: t_cap below the cap
])
def test_pair_tiles_bf16_match_jax_engines(use_rcut, t_cap, n_targets):
    """The plain tile engine at bf16, slot for slot, against the JAX jnp
    engine and the Pallas kernel in interpret mode on the same bf16 tiles.
    Padded target slots are the port's zeros and are not compared."""
    pos, m = _cloud(300, span=60.0, seed=21)
    side, cap, rcut = 3, 32, 18.0
    tcells, t_count, cells_pos, cells_m, count, params = _tiles(
        pos, m, side, cap, t_cap, rcut, n_targets)
    assert params.dtype == BF16 and int(count.max()) <= cap
    kw = dict(cutoff=CUTOFF, eps=0.5, use_rcut=use_rcut)
    got = nlist.pair_cells_plain(tcells, t_count, cells_pos, cells_m, count,
                                 side, params, **kw)
    assert got.dtype == BF16
    real = (torch.arange(t_cap)[None, :] < t_count[:, None]).numpy()
    assert np.all(got.float().numpy()[~real] == 0)
    got64 = _to64(got)[real]
    targets = _to64(tcells)[real]
    rcut2 = float(params[0]) if use_rcut else None
    scale, band = _scale_and_band(targets, pos.astype(np.float64),
                                  m.astype(np.float64), rcut2)
    jargs = (jnp.asarray(tcells.float().numpy(), jnp.bfloat16),
             jnp.asarray(cells_pos.float().numpy(), jnp.bfloat16),
             jnp.asarray(cells_m.float().numpy(), jnp.bfloat16), side,
             jnp.asarray(params.float().numpy(), jnp.bfloat16))
    for name, want in (
        ("jnp", jax_nlist._jnp_pair_cells(*jargs, kind="newton", **kw)),
        ("pallas", jax_nlist._pallas_pair_cells(
            *jargs, kind="newton", interpret=True, **kw)),
    ):
        assert want.dtype == jnp.bfloat16
        excess = _excess(got64, _to64(want)[real], scale, band)
        assert excess <= TERM_TOL, (name, excess)


@pytest.mark.parametrize("impl,n_targets", [("jnp", 0), ("pallas", 0),
                                            ("jnp", 160)])
def test_nlist_accelerations_bf16_match_jax(impl, n_targets):
    """The whole evaluation (binning, rcut_eff^2 rounded to bf16, tiles,
    un-binning) at bf16 against the JAX package's, no cell over the cap,
    targets the sources or (``nlist_accelerations_vs``) apart from them;
    and both against the float64 truncated sum on the same bf16 inputs,
    with the same bars."""
    pos, m = _cloud(512, seed=0)
    targets = _cloud(n_targets, seed=1)[0] if n_targets else pos
    rcut = 20.0
    side, _ = jax_nlist.resolve_nlist_sizing(pos, rcut)
    kw = dict(rcut=rcut, side=side, cap=64, **G1)
    tp, tm = _port_bf16(pos, m)
    tt = _port_bf16(targets)[0]
    got = nlist.nlist_accelerations_vs(tt, tp, tm, _self=not n_targets,
                                       **kw)
    assert got.dtype == BF16
    jt, jp, jm = _jax_bf16(targets, pos, m)
    want = jax_nlist.nlist_accelerations_vs(jt, jp, jm, impl=impl,
                                            _self=not n_targets, **kw)
    assert want.dtype == jnp.bfloat16
    p64, m64 = pos.astype(np.float64), m.astype(np.float64)
    t64 = targets.astype(np.float64)
    rcut2 = float(torch.tensor(rcut * rcut, dtype=BF16))
    scale, band = _scale_and_band(t64, p64, m64, rcut2)
    assert _excess(_to64(got), _to64(want), scale, band) <= TERM_TOL
    diff = p64[None] - t64[:, None]
    r2 = (diff**2).sum(-1)
    w = m64[None] / (r2 + 0.25) ** 1.5
    w[(r2 > rcut2) | (r2 <= 0)] = 0.0
    exact = (w[..., None] * diff).sum(1)
    for a in (got, want):
        assert _excess(_to64(a), exact, scale, band) <= TERM_TOL


def test_nlist_overflow_channels_bf16_match_jax():
    """side 2 at ~32 bodies a cell against a cap of 8: remainder monopoles
    and the whole-cell target fallback, computed in bf16 by both packages.
    A remainder is a bf16 difference of a cell's total and its prefix
    (mass and weighted position), so both packages land a few percent
    from their float32 forces (the JAX package a median 2.1%, max 21%
    here), and XLA rounds those sums at other places than torch. Bar, per
    target relative to |a|: the port's gap to the JAX package and to
    float32 at most 1.5x the JAX package's own bf16-to-float32 gap, median
    and max."""
    pos, m = _cloud(256, span=30.0, seed=7)
    kw = dict(rcut=12.0, side=2, cap=8, **G1)
    got = _to64(nlist.nlist_accelerations(*_port_bf16(pos, m), **kw))
    want = _to64(jax_nlist.nlist_accelerations(*_jax_bf16(pos, m),
                                               impl="jnp", **kw))
    fp32 = _to64(jax_nlist.nlist_accelerations(jnp.asarray(pos),
                                               jnp.asarray(m), impl="jnp",
                                               **kw))
    assert np.isfinite(got).all()

    def rel(a, b):
        r = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
        return np.array([np.median(r), r.max()])

    jax_own = rel(want, fp32)
    assert np.all(rel(got, want) <= 1.5 * jax_own), (rel(got, want),
                                                     jax_own)
    assert np.all(rel(got, fp32) <= 1.5 * jax_own), (rel(got, fp32),
                                                     jax_own)


def test_sizing_of_a_bf16_state_matches_jax():
    """resolve_nlist_sizing reads a bf16 tensor through float32 on the
    host and gives the JAX package's (side, cap) on the same bf16 state."""
    for n, span, rcut in ((2048, 100.0, 10.0), (500, 40.0, 3.0),
                          (4096, 1e12, 5e10)):
        pos, _ = _cloud(n, span, seed=9)
        assert nlist.resolve_nlist_sizing(
            torch.from_numpy(pos).to(BF16), rcut
        ) == jax_nlist.resolve_nlist_sizing(jnp.asarray(pos, jnp.bfloat16),
                                            rcut)


def test_segment_sum_bf16_matches_jax_and_stalls_at_256():
    """``cells.segment_sum`` at bf16 is the JAX package's
    ``jax.ops.segment_sum``: a sum in bf16, element by element, so a
    segment of ones stalls at 256 (256 + 1 rounds back to 256), where a
    float32 sum would give 4,992 after rounding."""
    ids = np.repeat(np.arange(4), [5000, 300, 256, 1])
    vals = np.ones(ids.size, np.float32)
    got = segment_sum(torch.from_numpy(vals).to(BF16), torch.from_numpy(ids),
                      4)
    want = jax.ops.segment_sum(jnp.asarray(vals, jnp.bfloat16),
                               jnp.asarray(ids), num_segments=4)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(got.float().numpy(), [256, 256, 256, 1])
    # Masses and weighted positions, as the overflow channels sum them.
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8, 3000)
    vals = rng.uniform(0.5, 1.5, (3000, 3)).astype(np.float32)
    got = segment_sum(torch.from_numpy(vals).to(BF16), torch.from_numpy(ids),
                      8)
    want = jax.ops.segment_sum(jnp.asarray(vals, jnp.bfloat16),
                               jnp.asarray(ids), num_segments=8)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n,side,span,seed", [(3000, 2, 30.0, 8),
                                               (2000, 4, 100.0, 9),
                                               (5000, 8, 100.0, 10)])
def test_cell_totals_bf16_match_jax_bits(n, side, span, seed):
    """The overflow channels' cell totals at bf16 (``nlist.cell_totals``:
    masses and weighted positions in one ``Segments`` sum) against the
    JAX package's lines (``pallas_nlist.py:1005-1012``) on the same bf16
    state and cell ids: the same bits, in cells of ~375 bodies that stall
    (side 2) and in sparse ones."""
    pos, m = _cloud(n, span=span, seed=seed)
    c = np.clip((pos / span * side).astype(np.int64), 0, side - 1)
    ids = (c[:, 0] * side + c[:, 1]) * side + c[:, 2]
    n_cells = side**3
    tids = torch.from_numpy(ids)
    order = torch.argsort(tids, stable=True)
    got = nlist.cell_totals(*_port_bf16(pos, m), order, tids[order],
                            torch.bincount(tids, minlength=n_cells))
    jpos, jm = _jax_bf16(pos, m)
    m_scale = jnp.maximum(jnp.max(jm), jnp.asarray(1e-37, jnp.bfloat16))
    m_hat = jm / m_scale
    cmass_hat = jax.ops.segment_sum(m_hat, ids, num_segments=n_cells)
    cmw = jax.ops.segment_sum(m_hat[:, None] * jpos, ids,
                              num_segments=n_cells)
    ccom = cmw / jnp.maximum(cmass_hat,
                             jnp.asarray(1e-37, jnp.bfloat16))[:, None]
    for port, ref in zip(got, (m_scale, cmass_hat, ccom)):
        assert port.dtype == BF16
        np.testing.assert_array_equal(
            port.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))


def test_segment_sum_wrapper_on_cpu_is_the_plain_version():
    """cells.segment_sum at bf16 takes segment_sum_bf16, whose CPU form is
    the plain version (no kernel launch); int and float32 sums stay
    index_add_."""
    from gravity_tpu_torch.ops import cells

    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 5, 700))
    vals = torch.from_numpy(rng.uniform(0, 1, (700, 6))).to(BF16)
    before = cells.LAUNCHES
    got = segment_sum(vals, ids, 5)
    assert cells.LAUNCHES == before
    assert torch.equal(got, cells.segment_sum_bf16_plain(vals, ids, 5))
    assert torch.equal(got, cells.segment_sum_bf16(vals, ids, 5))
    assert got.shape == (5, 6) and got.dtype == BF16
    assert torch.equal(segment_sum(torch.ones_like(ids), ids, 5),
                       torch.bincount(ids, minlength=5))
    with pytest.raises(ValueError, match="one id a row"):
        cells.segment_sum_bf16(vals, ids[:-1], 5)


def test_bf16_launch_keys():
    """The bf16 form counts under its own keys, by kind and rcut form."""
    assert nlist.launch_key("newton", True, BF16) == "newton_bf16"
    assert nlist.launch_key("newton", False, BF16) == "near_bf16"
    assert nlist.launch_key("newton", True, torch.float32) == "newton"
    assert {"newton_bf16", "near_bf16"} <= set(nlist.LAUNCHES)


def test_plain_bf16_keeps_a_subnormal_weight():
    """Two bodies 1e12 m apart: the light one's weight G m / r^3 = 1e-39
    is a bf16 subnormal, kept (not flushed) by the plain version's bf16
    ops; its pull within 25% of float64 (a subnormal near 1e-39 holds ~4
    bits), the heavy one's within 2^-5."""
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e12, 0.0, 0.0],
                        [2.2e12, 0.0, 0.0]], dtype=BF16)
    masses = torch.tensor([1e24, 1.5e7, 0.0], dtype=BF16)
    acc = nlist.nlist_accelerations(pos, masses, rcut=1.2e12, side=2,
                                    cap=8).double()
    r2 = float(pos[1, 0].double() - pos[0, 0].double()) ** 2
    g = 6.6743e-11
    want = torch.tensor([g * float(masses[1]) / r2,
                         -g * float(masses[0]) / r2], dtype=torch.float64)
    rel = ((acc[:2, 0] - want) / want).abs()
    assert float(acc[0, 0]) != 0.0
    assert float(rel[0]) < 0.25 and float(rel[1]) < TERM_TOL


def test_ewald_kind_is_refused_at_bf16():
    pos, m = _cloud(64, span=30.0, seed=4)
    tcells, t_count, cells_pos, cells_m, count, params = _tiles(
        pos, m, 2, 64, 64, 10.0)
    params = torch.stack([params[0], params[0]])
    with pytest.raises(ValueError, match="pm.py:286"):
        nlist.pair_cells_kernel(tcells, t_count, cells_pos, cells_m, count,
                                2, params, cutoff=CUTOFF, eps=0.5,
                                kind="ewald")


# --- the Simulator and the CLI ----------------------------------------------


def _g1_state(n, seed):
    """A bf16 state in G = 1 units that moves at dt 1: v dt ~ 1 against a
    bf16 half-ulp of x of at most 0.25."""
    pos, m = _cloud(n, span=100.0, seed=seed)
    rng = np.random.default_rng(seed + 100)
    vel = torch.from_numpy(rng.normal(0.0, 1.0, (n, 3))).to(BF16)
    return pos, vel.float().numpy(), m


@pytest.mark.parametrize("integrator", ["leapfrog", "multirate"])
def test_simulator_bf16_nlist_matches_jax(integrator):
    """10 steps through the cell list at bf16 (side 5, cap 32: no cell
    over the cap; multirate: k = 64, sub 4, the fast kicks binned at a
    t_cap below the cap) against the JAX Simulator on the same state, at
    G = 0.1, where the kicks move |v| by a median 1% (a few bf16 ulps) and
    no close pair turns a force's rounding into a different orbit. Bar:
    each body's position and velocity within 2^-5 of its own norm, the
    force bar (measured: at most 1.1% of |v|, 0.4% of |x|)."""
    n = 512
    pos, vel, masses = _g1_state(n, seed=5)
    common = dict(model="random", n=n, steps=10, dt=1.0,
                  integrator=integrator, force_backend="nlist",
                  nlist_rcut=20.0, nlist_side=5, nlist_cap=32, g=0.1,
                  eps=0.5, dtype="bfloat16", progress_every=5)
    if integrator == "multirate":
        common.update(multirate_k=64, multirate_sub=4)
    jax_final = JaxSimulator(
        JaxConfig(**common), state=JaxState(*_jax_bf16(pos, vel, masses)),
    ).run()["final_state"]
    sim = Simulator(SimulationConfig(**common),
                    state_from_numpy(pos, vel, masses, dtype=BF16,
                                     device="cpu"),
                    device="cpu")
    stats = sim.run()
    final = stats["final_state"]
    assert final.positions.dtype == BF16 and stats["dtype"] == "bfloat16"
    if integrator == "multirate":
        assert sim.kick_sizing[2] < sim.kick_sizing[1]
    got_pos, got_vel, _ = state_to_numpy(final)
    assert np.mean(np.any(got_pos != pos, axis=1)) > 0.9  # it moved
    for got, want in ((got_pos, jax_final.positions),
                      (got_vel, jax_final.velocities)):
        want = _to64(want)
        err = np.linalg.norm(got - want, axis=1)
        norm = np.linalg.norm(want, axis=1)
        assert np.all(err <= TERM_TOL * norm), float(np.max(err / norm))


def test_cli_runs_nlist_at_bf16_on_cpu(tmp_path):
    """The README's cell-list command at bf16 on the CPU (cut to N =
    4,096 and 20 steps): the run keeps its dtype."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gravity_tpu_torch", "run", "--device", "cpu",
         "--model", "random", "--n", "4096", "--steps", "20",
         "--integrator", "leapfrog", "--force-backend", "nlist",
         "--nlist-rcut", "5e10", "--eps", "1e9", "--dtype", "bfloat16",
         "--log-dir", str(tmp_path)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["backend"] == "nlist" and stats["dtype"] == "bfloat16"
    assert stats["steps"] == 20 and stats["kernel_launches"] == 0
    proc = subprocess.run(
        [sys.executable, "-m", "gravity_tpu_torch", "run", "--device", "cpu",
         "--model", "disk", "--n", "256", "--steps", "1",
         "--force-backend", "p3m", "--dtype", "bfloat16", "--log-dir",
         str(tmp_path)],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0 and "pm.py:286" in proc.stderr
