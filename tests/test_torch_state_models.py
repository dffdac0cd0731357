"""The port's state, constants, models, config and interop."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gravity_tpu.constants as jax_constants
from gravity_tpu.config import PRESETS as JAX_PRESETS
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.models import create_disk as jax_disk
from gravity_tpu.models import create_random_cube as jax_random_cube
from gravity_tpu.models import create_solar_system as jax_solar
from gravity_tpu_torch import constants
from gravity_tpu_torch.config import (
    PRESETS,
    NotPortedError,
    SimulationConfig,
)
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.models import (
    create_disk,
    create_model,
    create_random_cube,
    create_solar_system,
)
from gravity_tpu_torch.simulation import make_initial_state
from gravity_tpu_torch.state import ParticleState


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_constants_equal_the_jax_package():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names
    for name in names:
        assert getattr(constants, name) == getattr(jax_constants, name), name


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float32, jnp.float32), (torch.float64, jnp.float64),
])
def test_solar_system_is_the_reference_seed(x64, dtype, jdtype):
    got = state_to_numpy(create_solar_system(dtype=dtype))
    want = jax_solar(dtype=jdtype)
    for g, w in zip(got, (want.positions, want.velocities, want.masses)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].dtype == np.asarray(want.positions).dtype


def test_pad_to_contract():
    rng = np.random.default_rng(0)
    state = ParticleState.create(
        rng.uniform(-1, 1, (5, 3)), rng.uniform(-1, 1, (5, 3)),
        rng.uniform(1, 2, 5), dtype=torch.float32,
    )
    padded, mask = state.pad_to(8)
    assert padded.n == 8 and padded.dtype == torch.float32
    assert mask.tolist() == [True] * 5 + [False] * 3
    assert torch.equal(padded.positions[:5], state.positions)
    assert torch.equal(padded.positions[5:], state.positions[0].expand(3, 3))
    assert bool((padded.velocities[5:] == 0).all())
    assert bool((padded.masses[5:] == 0).all())
    same, full = state.pad_to(5)
    assert same is state and bool(full.all())
    with pytest.raises(ValueError, match="cannot pad"):
        state.pad_to(4)


def test_state_create_validates_and_converts():
    state = ParticleState.create(np.zeros((4, 3)), np.zeros((4, 3)),
                                 np.ones(4))
    assert state.astype(torch.float32).dtype == torch.float32
    both = ParticleState.concatenate([state, state])
    assert both.n == 8
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        ParticleState.create(np.zeros((4, 2)), np.zeros((4, 2)), np.ones(4))
    with pytest.raises(ValueError, match="velocities"):
        ParticleState.create(np.zeros((4, 3)), np.zeros((3, 3)), np.ones(4))
    with pytest.raises(ValueError, match="masses"):
        ParticleState.create(np.zeros((4, 3)), np.zeros((4, 3)), np.ones(3))


def test_random_cube_bounds_solar_seed_and_determinism():
    state = create_random_cube(_gen(0), 2000)
    pos, vel, masses = state_to_numpy(state)
    solar = state_to_numpy(create_solar_system())
    for got, want in zip((pos, vel, masses), solar):
        np.testing.assert_array_equal(got[:3], want)
    assert np.abs(pos[3:]).max() <= constants.RANDOM_POS_BOUND
    assert np.abs(vel[3:]).max() <= constants.RANDOM_VEL_BOUND
    assert masses[3:].min() >= np.float32(constants.RANDOM_MASS_LOW)
    assert masses[3:].max() <= np.float32(constants.RANDOM_MASS_HIGH)
    # Spread over the whole cube, like the JAX package's draw.
    jax_pos = np.asarray(jax_random_cube(jax.random.PRNGKey(0), 2000)
                         .positions)
    np.testing.assert_allclose(np.abs(pos[3:]).mean(),
                               np.abs(jax_pos[3:]).mean(), rtol=0.05)
    again = state_to_numpy(create_random_cube(_gen(0), 2000))
    other = state_to_numpy(create_random_cube(_gen(1), 2000))
    np.testing.assert_array_equal(again[0], pos)
    assert not np.array_equal(other[0], pos)


def test_initial_state_from_config_and_unported_models():
    cfg = SimulationConfig(n=10, seed=3, dtype="float64")
    a = make_initial_state(cfg, "cpu")
    b = make_initial_state(cfg, "cpu")
    assert a.dtype == torch.float64 and a.n == 10
    assert torch.equal(a.positions, b.positions)
    with pytest.raises(ValueError, match="exactly 3 bodies"):
        create_model("solar", _gen(0), 4, torch.float32)
    # grf is ported: it needs a perfect cube, and its lattice period is
    # the run's periodic box.
    with pytest.raises(ValueError, match="perfect-cube"):
        create_model("grf", _gen(0), 4, torch.float32)
    grf = make_initial_state(SimulationConfig(model="grf", n=64,
                                              periodic_box=1e12), "cpu")
    assert grf.n == 64 and float(grf.masses.sum()) == pytest.approx(1e33)
    assert bool(((grf.positions >= 0) & (grf.positions < 1e12)).all())


def test_interop_round_trip_with_a_jax_state():
    jax_state = jax_random_cube(jax.random.PRNGKey(4), 50)
    arrays = [np.asarray(a) for a in
              (jax_state.positions, jax_state.velocities, jax_state.masses)]
    state = state_from_numpy(*arrays, device="cpu")
    assert state.device.type == "cpu" and state.dtype == torch.float32
    for got, want in zip(state_to_numpy(state), arrays):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fields,item", [
    ({"sharding": "allgather"}, "Queue 1 item 5"),
    ({"periodic_box": 1e12}, "Queue 1 item 7"),
    ({"profile": True}, "Queue 1 item 8"),
    ({"pm_assignment": "tsc"}, "Queue 1 item 7"),
    ({"trace": True}, "Queue 1 item 9"),
    ({"model": "grf"}, "Queue 1 item 7"),
    ({"force_backend": "fmm", "dtype": "bfloat16"}, "Queue 1 item 7"),
    ({"force_backend": "pm"}, "Queue 1 item 7"),
    ({"p3m_short": "slice"}, "Queue 1 item 7"),
    ({"nlist_mesh": "halo"}, "Queue 1 item 5"),
    # The sharded multirate forms (item 5); merging in a periodic box is
    # ported.
    ({"integrator": "multirate", "sharding": "allgather"}, "Queue 1 item 5"),
    ({"merge_radius": 1e9, "periodic_box": 1e12}, "Queue 1 item 7"),
    # The FMM takes fp32, fp64 and (since item 7 closed) bf16 states.
    ({"force_backend": "sfmm", "dtype": "bfloat16"}, "Queue 1 item 7"),
])
def test_unported_features_are_refused(fields, item):
    """A JAX config asking for a feature no slice has ported is refused
    with the ROADMAP item that ports it. ``profile`` (item 8) and the
    periodic family (item 7: ``periodic_box``, ``pm_assignment``, the
    ``grf`` model, the ``pm`` backend, merging in a box), the rest of
    item 7 (the P3M slice pass, bf16 FMM states), item 5's sharded
    direct sums, halo slab engine and sharded multirate, and item 9's
    ``trace`` are ported now: such a config loads and carries its
    fields."""
    data = json.loads(JaxConfig().to_json())
    data.update(fields)
    ported = ({"profile": True}, {"periodic_box": 1e12},
              {"pm_assignment": "tsc"}, {"model": "grf"},
              {"force_backend": "pm"},
              {"merge_radius": 1e9, "periodic_box": 1e12},
              # Item 7's rest and item 5's sharded direct sums.
              {"sharding": "allgather"}, {"p3m_short": "slice"},
              {"force_backend": "fmm", "dtype": "bfloat16"},
              {"force_backend": "sfmm", "dtype": "bfloat16"},
              # Item 5's halo slab engine and sharded multirate.
              {"nlist_mesh": "halo"},
              {"integrator": "multirate", "sharding": "allgather"},
              # Item 9's solo-run span tracing.
              {"trace": True})
    if fields in ported:
        cfg = SimulationConfig.from_json(json.dumps(data))
        for name, value in fields.items():
            assert getattr(cfg, name) == value
        return
    with pytest.raises(NotPortedError, match=item):
        SimulationConfig.from_json(json.dumps(data))


@pytest.mark.parametrize("fields", [
    {"force_backend": "nlist", "nlist_rcut": 5e10, "nlist_side": 12,
     "nlist_cap": 256},
    {"force_backend": "pallas-mxu", "eps": 1e9},
    {"force_backend": "p3m", "model": "disk", "pm_grid": 256, "p3m_cap": 64,
     "p3m_short": "nlist", "p3m_sigma_cells": 1.5, "p3m_rcut_sigmas": 3.5,
     "fast_chunk": 2048, "g": 1.0},
    {"model": "plummer", "n": 16_384, "force_backend": "pallas", "eps": 1e9},
    {"model": "merger", "dtype": "bfloat16", "force_backend": "pallas-mxu",
     "g": 1.0, "eps": 0.05},
    # bf16 states through the cell-list kernel and the octree, with the
    # integration modes.
    {"adaptive": True, "dtype": "bfloat16", "force_backend": "nlist",
     "nlist_rcut": 5e10},
    {"external": "pointmass:gm=1e20", "dtype": "bfloat16",
     "force_backend": "nlist", "nlist_rcut": 5e10},
    {"integrator": "multirate", "dtype": "bfloat16", "force_backend": "nlist",
     "nlist_rcut": 5e10},
    {"dtype": "bfloat16", "force_backend": "nlist", "nlist_rcut": 5e10},
    {"merge_radius": 1e9, "dtype": "bfloat16", "force_backend": "nlist",
     "nlist_rcut": 5e10},
    {"force_backend": "tree", "dtype": "bfloat16"},
    {"force_backend": "tree", "tree_near": "nlist", "dtype": "bfloat16"},
])
def test_ported_backends_construct(fields):
    """The cell list, the Gram-form kernel, P3M, the octree, the remaining
    models and bf16 states (P3M's aside) are ported: a JAX config naming
    them carries over."""
    data = json.loads(JaxConfig().to_json())
    data.update(fields)
    cfg = SimulationConfig.from_json(json.dumps(data))
    for name, value in fields.items():
        assert getattr(cfg, name) == value


@pytest.mark.parametrize("fields", [
    {"dtype": "bfloat16", "force_backend": "p3m"},
    {"merge_radius": 1e9, "dtype": "bfloat16", "force_backend": "p3m"},
])
def test_bf16_p3m_is_refused_with_the_reference_reason(fields):
    """P3M takes no bf16 state in either package: the JAX package's mesh
    FFT raises on one (gravity_tpu/ops/pm.py:286), so the config refuses
    it with that reason, and not as a feature still to port."""
    data = json.loads(JaxConfig().to_json())
    data.update(fields)
    with pytest.raises(ValueError, match="pm.py:286") as e:
        SimulationConfig.from_json(json.dumps(data))
    assert not isinstance(e.value, NotPortedError)


@pytest.mark.parametrize("fields", [
    {"integrator": "multirate", "multirate_k": 64, "multirate_sub": 3},
    {"integrator": "multirate", "multirate_rungs": 4, "force_backend": "nlist",
     "nlist_rcut": 5e10},
    {"adaptive": True, "eta": 0.01, "timestep_criterion": "velocity",
     "adaptive_max_steps": 5000, "integrator": "leapfrog"},
    {"adaptive": True, "integrator": "multirate", "force_backend":
     "pallas-mxu", "eps": 1e9},
    {"external": "nfw:gm=1e13,rs=2e20 + uniform:gz=-9.8"},
    {"merge_radius": 1e9, "merge_k": 32, "merge_every": 10},
])
def test_integration_modes_parse_and_round_trip(fields):
    """Multirate, adaptive dt, external fields and merging are ported: a
    JAX config naming them carries over and round-trips."""
    data = json.loads(JaxConfig().to_json())
    data.update(fields)
    cfg = SimulationConfig.from_json(json.dumps(data))
    for name, value in fields.items():
        assert getattr(cfg, name) == value
    assert SimulationConfig.from_json(cfg.to_json()) == cfg


def test_adaptive_refuses_merging_as_jax_does():
    """The JAX package refuses adaptive dt with collision merging when
    the run starts (a ValueError, not a NotPortedError): so does the
    port."""
    from gravity_tpu_torch.simulation import Simulator

    cfg = SimulationConfig(n=8, adaptive=True, merge_radius=1e9,
                           integrator="leapfrog")
    with pytest.raises(ValueError, match="does not support collision") as e:
        Simulator(cfg, device="cpu").run()
    assert not isinstance(e.value, NotPortedError)
    with pytest.raises(ValueError, match="unknown timestep_criterion"):
        SimulationConfig(timestep_criterion="energy")


def test_jax_default_config_and_presets_carry_over():
    cfg = SimulationConfig.from_json(JaxConfig().to_json())
    assert cfg.n == JaxConfig().n and cfg.force_backend == "auto"
    assert SimulationConfig.from_json(cfg.to_json()) == cfg
    for name, preset in PRESETS.items():
        jax_preset = JAX_PRESETS[name]
        for field in dataclasses.fields(SimulationConfig):
            if field.name != "log_dir":
                assert getattr(preset, field.name) == getattr(
                    jax_preset, field.name
                ), (name, field.name)
    with pytest.raises(ValueError, match="unknown config field"):
        SimulationConfig.from_json(json.dumps({"warp_drive": True}))


def test_disk_bulge_masses_and_determinism():
    state = create_disk(_gen(0), 5000)
    pos, vel, masses = state_to_numpy(state)
    assert state.dtype == torch.float32 and state.n == 5000
    np.testing.assert_array_equal(pos[0], 0.0)  # the bulge, at rest
    np.testing.assert_array_equal(vel[0], 0.0)
    assert masses[0] == 1.0
    np.testing.assert_allclose(masses[1:], np.float32(5.0 / 4999))
    # Bulge 1.0 plus disk 5.0, within the fp32 rounding of the masses.
    assert abs(masses.astype(np.float64).sum() - 6.0) < 5000 * 6e-8 * 6.0
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    again = state_to_numpy(create_disk(_gen(0), 5000))
    other = state_to_numpy(create_disk(_gen(1), 5000))
    for a, b in zip(again, (pos, vel, masses)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(other[0], pos)
    f64 = create_disk(_gen(0), 100, dtype=torch.float64)
    assert f64.dtype == torch.float64
    assert torch.equal(create_model("disk", _gen(0), 5000,
                                    torch.float32).positions,
                       state.positions)


def test_disk_moments_match_the_jax_disk():
    """Radial and vertical moments and the rotation speed against the JAX
    package's disk of the same size: within 5 sampling standard errors
    (the draws differ; the distributions must not)."""
    n = 20_000
    got = state_to_numpy(create_disk(_gen(3), n))
    jax_state = jax_disk(jax.random.PRNGKey(3), n)
    want = [np.asarray(a) for a in (jax_state.positions,
                                    jax_state.velocities, jax_state.masses)]

    def moments(pos, vel):
        r = np.hypot(pos[1:, 0], pos[1:, 1])
        vphi = (pos[1:, 0] * vel[1:, 1] - pos[1:, 1] * vel[1:, 0]) / r
        return {"r": r, "r2": r * r, "|z|": np.abs(pos[1:, 2]),
                "z2": pos[1:, 2] ** 2, "vphi": vphi, "vz2": vel[1:, 2] ** 2}

    mg, mw = moments(*got[:2]), moments(*want[:2])
    for key in mg:
        a, b = mg[key].astype(np.float64), mw[key].astype(np.float64)
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) < 5 * se, key
    # The exponential disk: mean radius 2 Rd = 6 kpc, height rms 0.3 kpc.
    assert abs(mg["r"].mean() - 6.0) < 0.1
    assert abs(np.sqrt(mg["z2"].mean()) - 0.3) < 0.01
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
