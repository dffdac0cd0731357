"""The port's ensemble engine (``gravity_tpu_torch/serve/engine.py``)
against the JAX package's (``gravity_tpu/serve/engine.py``), on the CPU.

Keys and buckets must be the JAX package's for the same configs. The
same numpy states loaded into both engines (mixed real counts, dts and
budgets, one empty slot) must come out of two slices with the same
positions, velocities and carried accelerations: fp32 within 1e-5 and
fp64 within 1e-12 of each slot's largest value, through ``dense``,
``chunked`` and ``pallas`` (the JAX kernel in interpret mode, the port's
wrapper on its plain version for CPU tensors). The batch ledger and the
sentinel probe of a slot match the JAX engine's on the same state. The
rest mirrors ``tests/test_serve.py`` on the port alone: divergence
isolation, the rollback to the last finite state, bf16 keys apart, one
build per key.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.serve.engine import EnsembleEngine as JaxEngine
from gravity_tpu.serve.engine import batch_key_for as jax_key_for
from gravity_tpu.serve.engine import bucket_size as jax_bucket_size
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import NotPortedError, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.serve import (
    EnsembleEngine,
    EnsembleScheduler,
    batch_key_for,
    bucket_size,
)
from gravity_tpu_torch.serve.engine import MAX_BUCKET, account_slice
from gravity_tpu_torch.simulation import Simulator

TOL = {"float32": 1e-5, "float64": 1e-12}


def _cfg(n, steps=30, cls=SimulationConfig, **kw):
    kw.setdefault("model", "random")
    kw.setdefault("dt", 3600.0)
    kw.setdefault("integrator", "leapfrog")
    kw.setdefault("force_backend", "dense")
    return cls(n=n, steps=steps, **kw)


def _key(config, **kw):
    return batch_key_for(config, slots=4, device="cpu", **kw)


def _slot_rel(a, b) -> float:
    """Max |a - b| over the slot's largest |b| (a relative error at the
    slot's scale; 0 for an all-zero empty slot)."""
    scale = float(np.max(np.abs(b)))
    diff = float(np.max(np.abs(a - b)))
    return diff / scale if scale > 0 else diff


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 1024, 1025, 8192])
def test_bucket_size_matches_jax(n):
    assert bucket_size(n) == jax_bucket_size(n)


def test_bucket_size_rejects_empty():
    with pytest.raises(ValueError):
        bucket_size(0)


def test_batch_key_groups_and_rejections():
    """tests/test_serve.py's keys on the port: the same buckets and
    fields as the JAX package's keys of the same configs."""
    k1, k2 = _key(_cfg(10)), _key(_cfg(16))
    assert k1 == k2 and k1.backend == "dense"
    assert _key(_cfg(10, force_backend="auto")) == k1
    assert _key(_cfg(100)).bucket_n == 128
    for n, fb in ((10, "dense"), (100, "chunked"), (700, "pallas"),
                  (3000, "pallas-mxu")):
        port = _key(_cfg(n, force_backend=fb))
        jax = jax_key_for(_cfg(n, cls=JaxConfig, force_backend=fb), slots=4)
        assert tuple(port) == tuple(jax)
    bad = (
        dict(force_backend="tree"), dict(integrator="multirate"),
        dict(adaptive=True), dict(merge_radius=1e8),
        dict(external="uniform:gz=-9.8"), dict(sharding="allgather"),
        dict(n=50_000), dict(model="not-a-model"),
    )
    for fields in bad:
        # Through the JAX config's JSON, as the daemon receives configs:
        # the port refuses some fields already there (sharding).
        jax_cfg = _cfg(**{"n": 10, **fields}, cls=JaxConfig)
        with pytest.raises(ValueError):
            jax_key_for(jax_cfg, slots=4)
        with pytest.raises(ValueError):
            _key(SimulationConfig.from_json(jax_cfg.to_json()))


def test_batch_key_truncated_and_refused_backends():
    """nlist_rcut > 0 keys the rcut and routes auto to dense; a full-
    gravity kernel with a declared rcut is refused as the JAX package
    refuses it; served nlist is not ported (NotPortedError)."""
    key = _key(_cfg(10, force_backend="auto", nlist_rcut=5e10))
    assert key.backend == "dense"
    assert dict(key.extra)["nlist_rcut"] == 5e10
    with pytest.raises(ValueError):
        _key(_cfg(10, force_backend="pallas", nlist_rcut=5e10))
    with pytest.raises(NotPortedError, match="item 9"):
        _key(_cfg(10, force_backend="nlist", nlist_rcut=5e10,
                  nlist_side=4))
    assert MAX_BUCKET == 8192


def test_account_slice_masks_empty_slots():
    adv, rem, fin = account_slice(np.array([5, 0, 20]), np.array([3, 0, 7]),
                                  8, np.array([True, False, False]))
    assert adv.tolist() == [5, 0, 8] and rem.tolist() == [0, 0, 12]
    assert fin.tolist() == [True, True, False]


def _states(dtype, seed=3):
    """Three numpy states of 10, 16 and 13 bodies (bucket 16)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (10, 16, 13):
        pos = rng.normal(0.0, 1e11, (n, 3))
        vel = rng.normal(0.0, 1e3, (n, 3))
        m = rng.uniform(1e23, 1e25, n)
        out.append(tuple(a.astype(dtype) for a in (pos, vel, m)))
    return out


SLOT_DT = (3600.0, 1800.0, 7200.0)
SLOT_STEPS = (20, 7, 13)


def _both_batches(backend, dtype, integrator="leapfrog", eps=1e9):
    cfg = dict(n=16, force_backend=backend, dtype=dtype,
               integrator=integrator, eps=eps)
    jkey = jax_key_for(JaxConfig(**cfg), slots=4)
    pkey = batch_key_for(SimulationConfig(**cfg), slots=4, device="cpu")
    jeng, peng = JaxEngine(), EnsembleEngine("cpu")
    jb, pb = jeng.new_batch(jkey), peng.new_batch(pkey)
    tdtype = {"float32": torch.float32, "float64": torch.float64}[dtype]
    for slot, (arrays, dt, steps) in enumerate(
            zip(_states(dtype), SLOT_DT, SLOT_STEPS)):
        jb = jeng.load_slot(jb, slot, JaxState.create(*arrays), dt=dt,
                            steps=steps)
        pb = peng.load_slot(pb, slot,
                            state_from_numpy(*arrays, dtype=tdtype,
                                             device="cpu"),
                            dt=dt, steps=steps)
    return (jeng, jb), (peng, pb)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("backend", ["dense", "chunked", "pallas"])
def test_engine_matches_jax_engine(backend, dtype, request):
    """Two slices of 8 steps over mixed n_real, dt and budgets with one
    empty slot: every slot's positions, velocities and acc agree with
    the JAX engine's."""
    if dtype == "float64":
        request.getfixturevalue("x64")
    (jeng, jb), (peng, pb) = _both_batches(backend, dtype)
    for _ in range(2):
        jb, jres = jeng.run_slice(jb, 8)
        pb, pres = peng.run_slice(pb, 8)
        np.testing.assert_array_equal(pres.advanced, jres.advanced)
        np.testing.assert_array_equal(pres.finite, jres.finite)
        np.testing.assert_array_equal(pb.remaining, jb.remaining)
    for name in ("positions", "velocities", "acc"):
        got = getattr(pb, name).numpy()
        want = np.asarray(getattr(jb, name))
        for slot in range(4):
            assert _slot_rel(got[slot], want[slot]) <= TOL[dtype], \
                (name, slot)
    assert list(peng.compile_counts.values()) == [1]


def test_engine_yoshida_and_euler_match_jax_engine(x64):
    for integrator in ("yoshida4", "euler", "verlet"):
        (jeng, jb), (peng, pb) = _both_batches("dense", "float64",
                                               integrator=integrator)
        jb, _ = jeng.run_slice(jb, 8)
        pb, _ = peng.run_slice(pb, 8)
        for slot in range(3):
            assert _slot_rel(pb.positions[slot].numpy(),
                             np.asarray(jb.positions[slot])) <= 1e-12


def test_batch_ledger_and_sentinel_match_jax_engine(x64):
    """The (slots, 14) batch ledger, its host form, and a slot's sentinel
    probe against the JAX engine's on the same loaded states."""
    (jeng, jb), (peng, pb) = _both_batches("dense", "float64")
    got, want = peng.batch_ledger(pb), np.asarray(jeng.batch_ledger(jb))
    assert got.shape == want.shape == (4, 14)
    # The occupied slots (the scheduler reads no other).
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-12, atol=0.0)
    for slot in range(3):
        lp = peng.slot_ledger_host(got[slot], pb.key)
        lj = jeng.slot_ledger_host(want[slot], jb.key)
        assert lp["energy"] == pytest.approx(lj["energy"], rel=1e-12)
        np.testing.assert_allclose(lp["momentum"], lj["momentum"],
                                   rtol=1e-10)
    rel_p = peng.probe_slot_accuracy(pb, 1, k=8)
    rel_j = np.asarray(jeng.probe_slot_accuracy(jb, 1, k=8))
    np.testing.assert_allclose(rel_p, rel_j, atol=1e-12)
    assert peng.host_reads["ledger"] == 1 and peng.host_reads["probe"] == 1


def _solo_final(config):
    return Simulator(config, device="cpu").run()["final_state"] \
        .positions.numpy()


def _max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def test_ensemble_matches_solo_and_builds_once():
    """tests/test_serve.py's mixed sizes, dts, models and lengths across
    two buckets on the port: each job within 1e-5 of its solo run, one
    build per key."""
    configs = [
        _cfg(10, steps=40, seed=1), _cfg(14, steps=25, seed=2, dt=1800.0),
        _cfg(12, steps=40, seed=3, model="plummer"),
        _cfg(40, steps=35, seed=4), _cfg(60, steps=50, seed=5, dt=7200.0),
    ]
    with EnsembleScheduler(slots=4, slice_steps=16, device="cpu") as sched:
        ids = [sched.submit(c) for c in configs]
        sched.run_until_idle()
        for jid, config in zip(ids, configs):
            st = sched.status(jid)
            assert st["status"] == "completed" and \
                st["steps_done"] == config.steps
            got = sched.result(jid).positions.numpy()
            assert _max_rel(got, _solo_final(config)) <= 1e-5
        counts = sched.engine.compile_counts
    assert sorted(k.bucket_n for k in counts) == [16, 64]
    assert all(v == 1 for v in counts.values())


def test_diverging_slot_isolated_and_rolled_back():
    """One job at an overflow-scale dt in a full batch fails alone with a
    divergence error, its state rolled back to its last finite one (its
    initial state: it diverges in the first slice); the batchmates keep
    solo parity; nothing rebuilds."""
    good = [_cfg(10, steps=30, seed=11), _cfg(12, steps=30, seed=12),
            _cfg(16, steps=30, seed=13)]
    bad = _cfg(12, steps=30, seed=14, dt=1e30)
    with EnsembleScheduler(slots=4, slice_steps=10, device="cpu") as sched:
        good_ids = [sched.submit(c) for c in good]
        bad_id = sched.submit(bad)
        sched.run_until_idle()
        st = sched.status(bad_id)
        assert st["status"] == "failed" and "diverged" in st["error"]
        job = sched.jobs[bad_id]
        assert job.steps_done == 0
        start = Simulator(bad, device="cpu").state
        assert torch.equal(job.state.positions, start.positions)
        for jid, config in zip(good_ids, good):
            assert sched.status(jid)["status"] == "completed"
            got = sched.result(jid).positions.numpy()
            assert _max_rel(got, _solo_final(config)) <= 1e-5
        assert all(v == 1 for v in sched.engine.compile_counts.values())


@pytest.mark.parametrize("integrator", ["euler", "yoshida4"])
def test_euler_and_yoshida_parity(integrator):
    config = _cfg(12, steps=25, seed=21, integrator=integrator)
    with EnsembleScheduler(slots=2, slice_steps=10, device="cpu") as sched:
        jid = sched.submit(config)
        sched.run_until_idle()
        got = sched.result(jid).positions.numpy()
    assert _max_rel(got, _solo_final(config)) <= 1e-5


@pytest.mark.parametrize("backend", ["pallas", "pallas-mxu", "chunked"])
def test_kernel_backends_serve_with_parity(backend):
    """The kernels' keys serve through their batched entry points (their
    plain batched versions for CPU tensors) with solo parity, bit for bit
    against the solo run of the bucket-padded state."""
    config = _cfg(24, steps=12, seed=61, model="plummer",
                  force_backend=backend, eps=1e9)
    with EnsembleScheduler(slots=2, slice_steps=6, device="cpu") as sched:
        jid = sched.submit(config)
        sched.run_until_idle()
        assert sched.status(jid)["status"] == "completed"
        got = sched.result(jid)
    assert _max_rel(got.positions.numpy(), _solo_final(config)) <= 1e-5
    state = Simulator(config, device="cpu").state
    padded, _ = state.pad_to(bucket_size(config.n))
    solo = Simulator(dataclasses.replace(config, n=padded.n), state=padded,
                     device="cpu").run()["final_state"]
    assert torch.equal(got.positions, solo.positions[:config.n])
    assert torch.equal(got.velocities, solo.velocities[:config.n])


def test_bf16_jobs_batch_separately():
    c32 = _cfg(10, steps=10, seed=41)
    c16 = dataclasses.replace(c32, dtype="bfloat16")
    with EnsembleScheduler(slots=2, slice_steps=10, device="cpu") as sched:
        i32, i16 = sched.submit(c32), sched.submit(c16)
        sched.run_until_idle()
        assert sched.status(i32)["status"] == "completed"
        assert sched.status(i16)["status"] == "completed"
        assert len(sched.engine.compile_counts) == 2
        assert sched.result(i16).positions.dtype == torch.float32


def test_engine_guard_refuses_foreign_thread():
    """A launch from a thread that does not hold the engine's guard
    raises."""
    from gravity_tpu_torch.serve.service import RoundLock

    eng = EnsembleEngine("cpu")
    eng.guard = RoundLock()
    key = _key(_cfg(10))
    batch = eng.new_batch(key)
    with pytest.raises(RuntimeError, match="guard"):
        eng.run_slice(batch, 4)
    with eng.guard:
        eng.run_slice(batch, 4)
