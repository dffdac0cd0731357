"""The port's checkpoints (``gravity_tpu_torch/utils/checkpoint.py``)
against the JAX package's contract, on the CPU.

The SHA-256 digest of a payload is compared byte for byte with
``gravity_tpu.utils.checkpoint.payload_checksum`` on the same numpy
arrays, and ``crossed_cadence`` on a grid. The rest mirrors
``tests/test_checkpoint.py``: round trips are bitwise (a checkpoint stores
the tensors as they are), a resumed CPU run equals the uninterrupted one
bit for bit (the same ops in the same order), and a corrupt or torn newest
snapshot falls back to an older one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.utils.checkpoint import crossed_cadence as jax_crossed
from gravity_tpu.utils.checkpoint import payload_checksum as jax_checksum
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.simulation import Simulator
from gravity_tpu_torch.utils.checkpoint import (
    CheckpointCorrupt,
    crossed_cadence,
    make_checkpoint_manager,
    payload_checksum,
    restore_checkpoint,
    restore_checkpoint_with_extra,
    save_checkpoint,
)


def _cfg(**kw):
    base = dict(model="random", n=32, steps=20, dt=3600.0, seed=3,
                force_backend="dense")
    base.update(kw)
    return SimulationConfig(**base)


def _sim(**kw):
    return Simulator(_cfg(**kw), device="cpu")


def _payload(dtype, n=17, extra=False):
    rng = np.random.default_rng(5)
    out = {"positions": rng.standard_normal((n, 3)).astype(dtype),
           "velocities": rng.standard_normal((n, 3)).astype(dtype),
           "masses": rng.random(n).astype(dtype)}
    if extra:
        out["extra_t"] = np.asarray(1234.5, np.float64)
        out["extra_comp"] = np.asarray(-3.25e-9, np.float64)
    return out


@pytest.mark.parametrize("dtype,extra", [(np.float32, False),
                                         (np.float64, False),
                                         (np.float32, True)])
def test_payload_checksum_bytes_equal_jax(dtype, extra):
    """The same numpy payload gives the same 32 digest bytes in both
    packages, given as numpy arrays or as the port's tensors."""
    payload = _payload(dtype, extra=extra)
    want = jax_checksum(payload)
    np.testing.assert_array_equal(payload_checksum(payload), want)
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in payload.items()}
    np.testing.assert_array_equal(payload_checksum(tensors), want)


def test_payload_checksum_of_bf16_matches_jax():
    """A bf16 state hashes as the JAX package's bf16 arrays fetched to
    numpy (ml_dtypes bfloat16)."""
    payload = _payload(np.float32)
    jax_payload = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                   for k, v in payload.items()}
    tensors = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in payload.items()}
    np.testing.assert_array_equal(payload_checksum(tensors),
                                  jax_checksum(jax_payload))


def test_crossed_cadence_matches_jax_on_a_grid():
    for every in (0, 1, 3, 7, 10, 100):
        for prev in range(0, 40, 3):
            for step in range(prev, prev + 25, 4):
                assert crossed_cadence(prev, step, every) == \
                    jax_crossed(prev, step, every), (prev, step, every)


def test_roundtrip(tmp_path):
    sim = _sim()
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mgr, 7, sim.state)
    restored, step = restore_checkpoint(mgr)
    assert step == 7 and restored.positions.device.type == "cpu"
    for name in ("positions", "velocities", "masses"):
        assert torch.equal(getattr(restored, name), getattr(sim.state, name))
    assert os.path.exists(tmp_path / "ckpt" / "7" / "checkpoint.pt")


def test_resume_matches_uninterrupted_bitwise(tmp_path):
    """10 steps, a checkpoint, 10 more == a straight 20-step run, bit for
    bit on the CPU."""
    cfg = _cfg()
    straight = Simulator(cfg, device="cpu").run()["final_state"]
    sim1 = Simulator(dataclasses.replace(cfg, steps=10), device="cpu")
    sim1.run()
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mgr, 10, sim1.final_state())
    restored, step = restore_checkpoint(mgr)
    resumed = Simulator(cfg, state=restored, device="cpu").run(
        start_step=step)["final_state"]
    assert torch.equal(resumed.positions, straight.positions)
    assert torch.equal(resumed.velocities, straight.velocities)


def test_save_same_step_is_idempotent(tmp_path):
    sim = _sim()
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mgr, 7, sim.state)
    save_checkpoint(mgr, 7, sim.state)  # must not raise
    assert mgr.all_steps() == [7]


def test_save_different_state_same_step_raises(tmp_path):
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mgr, 7, _sim(seed=1).state)
    with pytest.raises(ValueError, match="DIFFERENT state at step 7"):
        save_checkpoint(mgr, 7, _sim(seed=2).state)


def test_torn_step_is_replaced(tmp_path):
    """A step whose file cannot be read back (a torn write) is replaced by
    the save in hand."""
    sim = _sim()
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mgr, 7, _sim(seed=9).state)
    path = tmp_path / "ckpt" / "7" / "checkpoint.pt"
    path.write_bytes(path.read_bytes()[:40])
    save_checkpoint(mgr, 7, sim.state)
    restored, _ = restore_checkpoint(mgr, 7)
    assert torch.equal(restored.positions, sim.state.positions)


def test_restore_missing_names_directory(tmp_path):
    mgr = make_checkpoint_manager(str(tmp_path / "empty_ckpt"))
    with pytest.raises(FileNotFoundError, match="empty_ckpt"):
        restore_checkpoint(mgr)


def test_integrity_checksum_roundtrip_with_extras(tmp_path):
    sim = _sim()
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    save_checkpoint(mgr, 5, sim.state, extra={"t": 123.5, "comp": 1e-9})
    state, step, extra = restore_checkpoint_with_extra(mgr)
    assert step == 5 and extra == {"t": 123.5, "comp": 1e-9}
    assert torch.equal(state.positions, sim.state.positions)


def test_explicit_step_corruption_raises(tmp_path):
    sim = _sim()
    ckpt = str(tmp_path / "ckpt")
    mgr = make_checkpoint_manager(ckpt)
    save_checkpoint(mgr, 5, sim.state)
    path = os.path.join(ckpt, "5", "checkpoint.pt")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(CheckpointCorrupt):
        restore_checkpoint_with_extra(make_checkpoint_manager(ckpt), 5)


def test_flipped_payload_byte_fails_its_checksum(tmp_path):
    """A payload changed on disk (the file still loads) fails its digest:
    a strict restore raises, the latest restore falls back."""
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"), max_to_keep=10)
    save_checkpoint(mgr, 5, _sim().state)
    save_checkpoint(mgr, 10, _sim(seed=4).state)
    path = tmp_path / "ckpt" / "10" / "checkpoint.pt"
    payload = torch.load(path, weights_only=True)
    payload["positions"][0, 0] += 1.0
    torch.save(payload, path)
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        restore_checkpoint_with_extra(mgr, 10)
    _, step, _ = restore_checkpoint_with_extra(mgr)
    assert step == 5


def test_corrupt_newest_falls_back_to_older(tmp_path):
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    older = _sim(seed=1).state
    save_checkpoint(mgr, 10, older)
    save_checkpoint(mgr, 20, _sim(seed=2).state)
    path = tmp_path / "ckpt" / "20" / "checkpoint.pt"
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    state, step, _ = restore_checkpoint_with_extra(mgr)
    assert step == 10 and torch.equal(state.positions, older.positions)
    # max_step bounds the walk (the supervisor's rollback).
    with pytest.raises(FileNotFoundError):
        restore_checkpoint_with_extra(mgr, max_step=5)


def test_keeps_the_newest_three_and_ignores_temporaries(tmp_path):
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"))
    sim = _sim()
    for step in (10, 20, 30, 40):
        save_checkpoint(mgr, step, sim.state)
    assert mgr.all_steps() == [20, 30, 40]
    # A step left with only its temporary file (a writer killed before
    # os.replace) is not a snapshot.
    os.makedirs(tmp_path / "ckpt" / "50")
    (tmp_path / "ckpt" / "50" / "checkpoint.pt.tmp.1").write_bytes(b"x")
    assert mgr.latest_step() == 40


def test_checkpoint_cadence_not_divisible(tmp_path):
    """A cadence that does not divide the block still saves at every
    crossed boundary: blocks end at 5, 10, 15, 20; 7 and 14 are crossed."""
    cfg = _cfg(steps=20, checkpoint_every=7, progress_every=5)
    mgr = make_checkpoint_manager(str(tmp_path / "ckpt"), max_to_keep=10)
    Simulator(cfg, device="cpu").run(checkpoint_manager=mgr)
    assert mgr.all_steps() == [10, 15]
