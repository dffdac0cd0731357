"""Served truncated-physics jobs (``--force-backend nlist``) on the CPU.

The port's batched cell list (``ops/nlist.py::
nlist_accelerations_vs_batched``, its pair tiles through
``pair_cells_kernel_batched``, whose plain version CPU tensors take)
against ``jax.vmap`` of the JAX package's ``nlist_accelerations_vs`` (the
jnp engine, as the JAX suite runs it on the CPU): fp32 within 1e-5 and
fp64 within 1e-12 of each slot's largest |a|. Against the port's own
solo call slot by slot it is bit for bit, in fp32, fp64 and bf16, with a
slot whose zero-mass padding overflows its cell (within 1e-5 of the
unpadded solo call too), a slot of 3 bodies and an empty slot.

Then the serving layers with an nlist key: ``batch_key_for`` against the
JAX engine's on ``tests/test_nlist.py``'s cases, two slices of the port's
engine against the JAX engine's from the same numpy states (mixed
counts, dts and budgets, one empty slot; ``TOL`` of
``tests/test_torch_serve_engine.py``) with the batch ledger and the
sentinel probe, a scheduler job bit for bit the solo run of its padded
state, the breakers (the JAX ladder on the CPU; on the card an open
``nlist`` breaker refuses and a round that raises fails its jobs), and
the admission estimate against the JAX model and the buffers it lists.
Sizes are small: buckets 16 to 128, side 4, caps 8 and 16.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops.pallas_nlist import nlist_accelerations_vs as jax_vs
from gravity_tpu.serve.breaker import BreakerBoard as JaxBoard
from gravity_tpu.serve.engine import EnsembleEngine as JaxEngine
from gravity_tpu.serve.engine import batch_key_for as jax_key_for
from gravity_tpu.simulation import _resolve_nlist_config as jax_sizing
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu.telemetry.perf import estimate_peak_bytes as jax_estimate
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import cells, direct_kernel, nlist
from gravity_tpu_torch.serve import (
    EnsembleEngine,
    EnsembleScheduler,
    batch_key_for,
    bucket_size,
)
from gravity_tpu_torch.serve.breaker import BreakerBoard, BreakerOpen
from gravity_tpu_torch.serve.engine import BatchKey
from gravity_tpu_torch.simulation import Simulator, _resolve_nlist_config
from gravity_tpu_torch.telemetry import perf

TOL = {"float32": 1e-5, "float64": 1e-12}
TORCH = {"float32": torch.float32, "float64": torch.float64,
         "bfloat16": torch.bfloat16}
RCUT, SIDE, CAP, EPS = 5e10, 4, 8, 1e9
EV = dict(rcut=RCUT, side=SIDE, cap=CAP, eps=EPS)
# Slot 0: 50 bodies padded to 64, the padding parked in its first body's
# cell far past the cap; slot 1 full; slot 2 three bodies; slot 3 empty.
SLOT_N = (50, 64, 3, 0)


def _batch(bucket=64, ns=SLOT_N, seed=0):
    """float64 numpy positions (B, bucket, 3) and masses (B, bucket), each
    slot zero-mass-padded as ``ParticleState.pad_to`` pads it."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((len(ns), bucket, 3))
    m = np.zeros((len(ns), bucket))
    for b, n in enumerate(ns):
        if n:
            pos[b, :n] = rng.uniform(-3e11, 3e11, (n, 3))
            pos[b, n:] = pos[b, 0]
            m[b, :n] = rng.uniform(1e23, 1e25, n)
    return pos, m


def _slot_rel(a, b) -> float:
    scale = float(np.max(np.abs(b)))
    diff = float(np.max(np.abs(a - b)))
    return diff / scale if scale > 0 else diff


def _port(pos, m, dtype):
    return (torch.from_numpy(pos).to(TORCH[dtype]),
            torch.from_numpy(m).to(TORCH[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_matches_jax_vmap(dtype, request):
    if dtype == "float64":
        request.getfixturevalue("x64")
    pos, m = _batch()
    got = nlist.nlist_accelerations_vs_batched(*_port(pos, m, dtype), **EV)
    fn = jax.vmap(lambda p, mm: jax_vs(p, p, mm, impl="jnp", _self=True,
                                       **EV))
    want = np.asarray(fn(pos.astype(dtype), m.astype(dtype)))
    for b in range(len(SLOT_N)):
        assert _slot_rel(got[b].numpy(), want[b]) <= TOL[dtype], b
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_batched_is_each_slots_solo_bits(dtype):
    """Slot b of the batched evaluation has the bits of the solo call on
    slot b's arrays: the padding-overflow slot, the 3-body slot and the
    empty slot (finite, zero) included."""
    pos, m = _port(*_batch(), dtype)
    before = dict(nlist.LAUNCHES)
    got = nlist.nlist_accelerations_vs_batched(pos, m, **EV)
    assert nlist.LAUNCHES == before  # CPU tensors: the plain version
    for b in range(len(SLOT_N)):
        solo = nlist.nlist_accelerations_vs(pos[b], pos[b], m[b], **EV)
        assert torch.equal(got[b], solo), b
    assert bool(torch.isfinite(got).all()) and bool((got[3] == 0).all())
    kernel = nlist.make_nlist_batched_kernel(rcut=RCUT, side=SIDE, cap=CAP,
                                             eps=EPS)
    assert torch.equal(kernel(pos, pos, m), got)
    assert kernel.sizing == (SIDE, CAP, CAP)
    with pytest.raises(ValueError, match="self form"):
        kernel(pos.clone(), pos, m)


def test_padding_overflow_slot_matches_unpadded():
    """The 50-body slot's padding fills its first body's cell far past the
    cap; the stable sort keeps the real bodies first, so its real bodies
    come out within 1e-5 of the unpadded solo call."""
    pos, m = _port(*_batch(), "float32")
    binned = nlist.source_cells_batched(pos, m, rcut=RCUT, side=SIDE,
                                        cap=CAP)[4]
    assert int(binned[2][0].max()) > 14 + 1  # 14 padding bodies + its own
    got = nlist.nlist_accelerations_vs_batched(pos, m, **EV)[0, :50]
    solo = nlist.nlist_accelerations_vs(pos[0, :50], pos[0, :50], m[0, :50],
                                        **EV)
    assert _slot_rel(got.numpy(), solo.numpy()) <= 1e-5


def _padded_bf16_forces(born: str):
    """A 300-body random job padded to 512 (born in ``born``, then bf16),
    side 4, cap 8: the port's bf16 forces, the JAX package's bf16 and
    float32 forces on its real bodies, in float64."""
    from gravity_tpu_torch.simulation import make_initial_state

    state = make_initial_state(
        SimulationConfig(model="random", n=300, seed=1, dtype=born,
                         eps=EPS), torch.device("cpu"))
    padded, _ = state.pad_to(512)
    pb, mb = padded.positions.bfloat16(), padded.masses.bfloat16()
    got = nlist.nlist_accelerations_vs(pb, pb, mb, **EV)
    pos, m = pb.float().numpy(), mb.float().numpy()
    bf16 = [jax.numpy.asarray(a, jax.numpy.bfloat16) for a in (pos, pos, m)]
    want = jax_vs(*bf16, impl="jnp", **EV).astype(jax.numpy.float32)
    fp32 = jax_vs(pos, pos, m, impl="jnp", **EV)
    return [np.asarray(a, np.float64)[:300] for a in (got.float(), want,
                                                       fp32)]


def _rel(a, b):
    norm = np.linalg.norm(b, axis=1)
    r = np.linalg.norm(a - b, axis=1)[norm > 0] / norm[norm > 0]
    return np.array([np.median(r), r.max()])


def test_bf16_padded_state_stays_finite():
    """The padding of a bf16 job overflows its first body's cell with an
    empty remainder, and the rounding residue of the cell's weighted
    positions over the 1e-37 floor can overflow to inf: 0 x inf then made
    NaN of every neighbour's force, in the JAX package too
    (``gravity_tpu/ops/pallas_nlist.py:261-263``: 122 real bodies of this
    bf16-born state). The port now takes an empty remainder's centre as 0
    and stays finite. Where the JAX package is finite (the float64-born
    state) the two agree as tests/test_torch_nlist_bf16.py holds them: the
    port's gaps to the JAX package and to float32 at most 1.5x the JAX
    package's own bf16 gap to float32, median and max; on the bf16-born
    state the port's median gap to float32 stays under the same bar."""
    got, want, fp32 = _padded_bf16_forces("float64")
    assert np.isfinite(got).all() and np.isfinite(want).all()
    jax_own = _rel(want, fp32)
    assert np.all(_rel(got, want) <= 1.5 * jax_own)
    assert np.all(_rel(got, fp32) <= 1.5 * jax_own)
    got, want, fp32 = _padded_bf16_forces("bfloat16")
    assert int((~np.isfinite(want).all(axis=1)).sum()) == 122
    assert np.isfinite(got).all()
    assert _rel(got, fp32)[0] <= 1.5 * jax_own[0]


def test_bf16_cell_totals_take_flat_segment_sums():
    """At bf16 the batch's cell totals are the bf16 segment sums over the
    flattened ids (slot * side^3 + cell), element order inside a cell."""
    pos, m = _port(*_batch(), "bfloat16")
    kw = dict(rcut=RCUT, side=SIDE, cap=CAP)
    _, _, _, coords, binned = nlist.source_cells_batched(pos, m, **kw)
    ids = cells.slot_cell_ids(coords, SIDE)
    n_cells = len(SLOT_N) * SIDE**3
    m_scale, cmass_hat, ccom = nlist.cell_totals(
        pos, m, binned[4], binned[5], binned[2])
    m_hat = (m / m_scale[:, None]).reshape(-1)
    want = cells.segment_sum_bf16_plain(m_hat, ids, n_cells)
    assert torch.equal(cmass_hat.reshape(-1), want)
    for b in range(len(SLOT_N)):
        solo_binned = nlist.source_cells(pos[b], m[b], **kw)[4]
        solo = nlist.cell_totals(pos[b], m[b], solo_binned[4],
                                 solo_binned[5], solo_binned[2])
        assert torch.equal(solo[0], m_scale[b])
        assert torch.equal(solo[1], cmass_hat[b])
        assert torch.equal(solo[2], ccom[b])


def test_batched_pair_tiles_are_the_plain_version_on_the_cpu():
    pos, m = _port(*_batch(), "float32")
    _, _, params, _, binned = nlist.source_cells_batched(
        pos, m, rcut=RCUT, side=SIDE, cap=CAP)
    cells_pos, cells_mass, count = binned[:3]
    args = (cells_pos, count, cells_pos, cells_mass * 6.674e-11, count,
            SIDE, params)
    got = nlist.pair_cells_kernel_batched(*args, cutoff=1e-10, eps=EPS)
    for b in range(len(SLOT_N)):
        want = nlist.pair_cells_plain(
            cells_pos[b], count[b], cells_pos[b], args[3][b], count[b],
            SIDE, params[b:b + 1], cutoff=1e-10, eps=EPS)
        assert torch.equal(got[b], want)


def _cfg(n, cls=SimulationConfig, **kw):
    kw = {"model": "random", "dt": 3600.0, "integrator": "leapfrog",
          "steps": 20, "force_backend": "nlist", "nlist_rcut": RCUT,
          "nlist_side": SIDE, "nlist_cap": CAP, "eps": EPS, **kw}
    return cls(n=n, **kw)


def test_batch_key_matches_jax():
    """tests/test_nlist.py's serve keys on the port."""
    for kw in (dict(nlist_rcut=0.0), dict(nlist_side=0)):
        with pytest.raises(ValueError) as port:
            batch_key_for(_cfg(64, **kw), slots=2, device="cpu")
        with pytest.raises(ValueError) as jx:
            jax_key_for(_cfg(64, cls=JaxConfig, **kw), slots=2)
        assert str(port.value) == str(jx.value)
    for kw in (dict(), dict(nlist_rcut=2e11), dict(nlist_cap=16),
               dict(nlist_cap=0), dict(force_backend="auto"),
               dict(force_backend="dense"), dict(force_backend="chunked"),
               dict(dtype="bfloat16", n=100)):
        cfg = {"n": 64, **kw}
        port = batch_key_for(_cfg(**cfg), slots=2, device="cpu")
        jx = jax_key_for(_cfg(cls=JaxConfig, **cfg), slots=2)
        assert tuple(port) == tuple(jx), kw
    k1 = batch_key_for(_cfg(64), slots=2, device="cpu")
    k2 = batch_key_for(_cfg(64, nlist_rcut=2e11), slots=2, device="cpu")
    assert k1.backend == "nlist" and k1 != k2
    assert ("nlist_rcut", RCUT) in k1.extra
    auto = batch_key_for(_cfg(64, force_backend="auto"), slots=2,
                         device="cpu")
    assert auto.backend == "dense"
    for backend in ("pallas", "pallas-mxu"):
        with pytest.raises(ValueError, match="full gravity"):
            batch_key_for(_cfg(64, force_backend=backend), slots=2,
                          device="cpu")


def test_blind_sizing_matches_jax():
    """A served key's kernels are sized with no state: the given side,
    and the cap or the cell list's default, as the JAX package sizes
    them (the port fitted them to absent positions before)."""
    for cap in (0, 16):
        cfg = _cfg(64, nlist_cap=cap)
        assert _resolve_nlist_config(cfg, None) == jax_sizing(
            _cfg(64, cls=JaxConfig, nlist_cap=cap), None) == (SIDE,
                                                              cap or 64)
    with pytest.raises(ValueError, match="nlist-side"):
        _resolve_nlist_config(_cfg(64, nlist_side=0), None)
    key = batch_key_for(_cfg(64, nlist_cap=0), slots=2, device="cpu")
    kernel = EnsembleEngine("cpu")._solo_kernel(key)
    assert kernel.sizing == (SIDE, 64, 64)


def _states(seed=3):
    """Three float64 numpy states of 10, 16 and 13 bodies (bucket 16)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (10, 16, 13):
        out.append((rng.normal(0.0, 1e11, (n, 3)),
                    rng.normal(0.0, 1e3, (n, 3)),
                    rng.uniform(1e23, 1e25, n)))
    return out


def _both_engines(dtype):
    kw = dict(n=16, dtype=dtype)
    jkey = jax_key_for(_cfg(cls=JaxConfig, **kw), slots=4)
    pkey = batch_key_for(_cfg(**kw), slots=4, device="cpu")
    assert tuple(jkey) == tuple(pkey)
    jeng, peng = JaxEngine(), EnsembleEngine("cpu")
    jb, pb = jeng.new_batch(jkey), peng.new_batch(pkey)
    for slot, (arrays, dt, steps) in enumerate(
            zip(_states(), (3600.0, 1800.0, 7200.0), (20, 7, 13))):
        arrays = tuple(a.astype(dtype) for a in arrays)
        jb = jeng.load_slot(jb, slot, JaxState.create(*arrays), dt=dt,
                            steps=steps)
        pb = peng.load_slot(pb, slot, state_from_numpy(
            *arrays, dtype=TORCH[dtype], device="cpu"), dt=dt, steps=steps)
    return (jeng, jb), (peng, pb)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engine_matches_jax_engine(dtype, request):
    """Two slices of 8 steps of an nlist key over mixed n_real, dt and
    budgets with one empty slot: positions, velocities and carried
    accelerations agree with the JAX engine's; then the batch ledger (the
    truncated pair potential) and a slot's sentinel probe."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    (jeng, jb), (peng, pb) = _both_engines(dtype)
    for _ in range(2):
        jb, jres = jeng.run_slice(jb, 8)
        pb, pres = peng.run_slice(pb, 8)
        np.testing.assert_array_equal(pres.advanced, jres.advanced)
        np.testing.assert_array_equal(pres.finite, jres.finite)
    for name in ("positions", "velocities", "acc"):
        got = getattr(pb, name).numpy()
        want = np.asarray(getattr(jb, name))
        for slot in range(4):
            assert _slot_rel(got[slot], want[slot]) <= TOL[dtype], \
                (name, slot)
    assert list(peng.compile_counts.values()) == [1]
    assert peng.force_evals == {"nlist": 16}
    got, want = peng.batch_ledger(pb), np.asarray(jeng.batch_ledger(jb))
    rtol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got[:3], want[:3], rtol=rtol, atol=0.0)
    assert peng._ledger_pe_kind(pb.key) == "dense"
    rel_p = peng.probe_slot_accuracy(pb, 1, k=8)
    rel_j = np.asarray(jeng.probe_slot_accuracy(jb, 1, k=8))
    np.testing.assert_allclose(rel_p, rel_j, atol=TOL[dtype])


def _padded_solo(config):
    state = Simulator(config, device="cpu").state
    padded, _ = state.pad_to(bucket_size(config.n))
    return Simulator(dataclasses.replace(config, n=padded.n), state=padded,
                     device="cpu").run()["final_state"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scheduler_job_is_the_padded_solo_run(dtype):
    """A served nlist job (100 bodies in bucket 128, a batchmate beside
    it) has the bits of the solo run of its bucket-padded state, and
    (fp32) is within 1e-5 of the unpadded solo run."""
    config = _cfg(100, steps=12, seed=3, dtype=dtype)
    with EnsembleScheduler(slots=2, slice_steps=5, device="cpu") as sched:
        jid = sched.submit(config)
        sched.submit(dataclasses.replace(config, n=128, seed=4))
        sched.run_until_idle()
        assert sched.status(jid)["status"] == "completed"
        got = sched.result(jid)
        (key,) = sched.engine.compile_counts
        assert key.backend == "nlist"
        assert sched.engine.force_evals == {"nlist": 15}
    solo = _padded_solo(config)
    assert torch.equal(got.positions, solo.positions[:config.n])
    assert torch.equal(got.velocities, solo.velocities[:config.n])
    if dtype == "float32":
        unpadded = Simulator(config, device="cpu").run()["final_state"]
        assert _slot_rel(got.positions.numpy(),
                         unpadded.positions.numpy()) <= 1e-5


def test_breakers_on_the_cpu_follow_the_jax_ladder():
    """nlist's rung below is the masked direct sum, as in the JAX package;
    the rerouted job keys the rcut on chunked, as the JAX key does."""
    boards = [BreakerBoard(threshold=1, cooldown_s=1e9),
              JaxBoard(threshold=1, cooldown_s=1e9)]
    routes = []
    for board in boards:
        board.get("nlist").record_failure()
        routes.append(board.reroute("nlist"))
        board.get("chunked").record_failure()
        routes.append(board.reroute("nlist"))
    assert routes[:2] == routes[2:] == ["chunked", "dense"]
    port = batch_key_for(_cfg(64), slots=2, device="cpu",
                         reroute=boards[0].reroute)
    jx = jax_key_for(_cfg(64, cls=JaxConfig), slots=2,
                     reroute=boards[1].reroute)
    assert tuple(port) == tuple(jx) and port.backend == "dense"


def test_card_breaker_refuses_and_a_failed_round_fails_its_jobs(
        monkeypatch):
    """The card's floor, on the CPU with the breakers in card mode: an
    open nlist breaker refuses admission (no plain form takes a kernel's
    job); a round that raises fails its jobs with the error and trips the
    breaker, never rerouted to dense or chunked."""
    board = BreakerBoard(threshold=1, cooldown_s=1e9, on_card=True)
    board.get("nlist").trip(reason="nlist_pair launch failed")
    with pytest.raises(BreakerOpen, match="launch failed"):
        board.reroute("nlist")
    with EnsembleScheduler(slots=2, slice_steps=5, device="cpu") as sched:
        sched.breakers.on_card = True
        jid = sched.submit(_cfg(40, steps=20))

        def broken(*args, **kwargs):
            raise RuntimeError("nlist_pair batched launch failed: test")

        monkeypatch.setattr(nlist, "pair_cells_kernel_batched", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            sched.run_round()
        st = sched.status(jid)
        assert st["status"] == "failed" and "launch failed" in st["error"]
        assert sched.breakers.snapshot()["nlist"]["state"] == "open"
        with pytest.raises(BreakerOpen, match="launch failed"):
            sched.submit(_cfg(40))
        assert not sched.engine.force_evals.get("dense")
        assert not sched.engine.force_evals.get("chunked")


def _engine_key(backend, dtype, integrator, bucket, extra=()):
    return BatchKey(bucket, 4, backend, dtype, integrator, 6.674e-11, 1e9,
                    1e-10, "integrate", tuple(extra))


NLIST_EXTRAS = [(("nlist_rcut", 5e10), ("nlist_side", 12),
                 ("nlist_cap", 32)),
                (("nlist_rcut", 1e11), ("nlist_side", 4),
                 ("nlist_cap", 0))]
ADMISSION_KEYS = [
    _engine_key(b, d, i, n)
    for b in ("dense", "chunked", "pallas", "pallas-mxu")
    for d in ("float32", "float64", "bfloat16")
    for i in ("euler", "leapfrog", "verlet", "yoshida4")
    for n in (16, 1024, 8192)
    if not (b == "pallas-mxu" and d == "float64")
] + [_engine_key("nlist", d, i, n, e)
     for d in ("float32", "float64", "bfloat16")
     for i in ("leapfrog", "yoshida4") for n in (64, 8192)
     for e in NLIST_EXTRAS]


def _most_chunks(n: int) -> int:
    """The most source chunks any card's occupancy can give a launch at n
    targets and n sources (direct_kernel.source_chunks over every slot
    count up to 16 blocks an SM on 132 SMs, both kernels' block shapes)."""
    return max(direct_kernel.source_chunks(n, n, block_m=bm, tile=256,
                                           slots=s)
               for bm in (128, 256) for s in range(1, 132 * 16 + 1, 7))


@pytest.mark.parametrize("key", ADMISSION_KEYS,
                         ids=lambda k: f"{k.backend}-{k.dtype}-"
                                       f"{k.integrator}-{k.bucket_n}-"
                                       f"{dict(k.extra).get('nlist_side')}")
def test_estimate_covers_jax_and_its_buffers(key):
    """The cold-key estimate is at least the JAX model's figure for the
    key and at least the bytes of the buffers its docstring lists,
    worked out here from the key's shapes and source_chunks."""
    got = perf.estimate_peak_bytes(key)
    assert got >= jax_estimate(key)
    item = 8 if key.dtype == "float64" else 4
    b, n = key.slots, key.bucket_n
    vec = b * n * 3 * item
    listed = 2 * (3 * vec + b * n * item)  # the state's two generations
    listed += perf.STEP_GENERATIONS[key.integrator] * vec
    chunks = _most_chunks(n)
    assert perf.chunk_bound(n) >= chunks
    if key.backend in ("dense", "chunked"):
        rows = n if key.backend == "dense" else min(1024, n)
        listed += b * n * rows * 11 * item  # diffs, r^2, weights, masks
    elif key.backend == "pallas":
        listed += b * n * 4 * item + b * chunks * n * 3 * item
    elif key.backend == "pallas-mxu":
        listed += b * chunks * n * 4 * 4 + b * n * 4 * 4
    elif key.backend == "nlist":
        extra = dict(key.extra)
        grid = b * extra["nlist_side"] ** 3 * (extra["nlist_cap"] or 64)
        # nlist._remainder_cells' terms a (cell, offset, target slot):
        # the masked differences (3), r^2, the weights, the weighted
        # differences (3)
        remainder = (3 + 1 + 1 + 3) * item
        # nlist._overflow_targets' terms a (target, offset): the cells'
        # weights, the differences (3), r^2, the weights, the weighted
        # differences (3), and the int64 neighbour ids
        fallback = (1 + 3 + 1 + 1 + 3) * item + 8
        listed += (grid * 27 * (4 * item + remainder)  # and the JAX tile
                   + grid * 11 * item  # pos, mass, G m, tiles, their sum
                   + b * n * 27 * fallback)
    assert got >= listed
