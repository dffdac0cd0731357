"""The port's plummer, cold_collapse, hernquist and merger models and its
state diagnostics, against the JAX package on the CPU.

The two packages draw different numbers (a CPU ``torch.Generator`` in
float64 against ``jax.random``), so each model is held to its JAX factory
on the distribution: Lagrangian radii (10/50/90 %), the virial ratio and
the velocity dispersion at N = 4,096, within 5 sampling standard errors.
The standard error of one realization's statistic is the spread (std)
of that statistic over 6 seeds of the port's factory; the difference of
two independent realizations has sqrt(2) times it. Plummer's <r^2>
diverges, and the JAX default draws its radius quantile in float32 (a
tail cut near 5,000 a), so no second moment of r is compared.

Runs hand one state to both packages through ``interop`` and compare
the two Simulators in float64: rtol 1e-10 per particle after 5 leapfrog
steps (the two direct sums differ in summation order only).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu import models as jax_models
from gravity_tpu.config import PRESETS as JAX_PRESETS
from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.models.hernquist import _jeans_sigma2 as jax_jeans_sigma2
from gravity_tpu.ops import diagnostics as jax_diag
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import PRESETS, SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy, state_to_numpy
from gravity_tpu_torch.models import create_model
from gravity_tpu_torch.models.hernquist import _jeans_sigma2
from gravity_tpu_torch.ops import diagnostics
from gravity_tpu_torch.simulation import Simulator

N = 4096
SEEDS = 6
NEW_MODELS = ("plummer", "cold_collapse", "hernquist", "merger")
# Units and softening of each model's run: SI with eps = 1e9 m, except the
# merger in galactic units (G = 1, eps = 0.05 kpc, the baseline-2m preset).
PHYSICS = {"plummer": (6.6743e-11, 1e9), "cold_collapse": (6.6743e-11, 1e9),
           "hernquist": (6.6743e-11, 1e9), "merger": (1.0, 0.05)}
# The other fields of each model's run: its preset where one exists
# (baseline-16k, baseline-2m; baseline-262k without its sharding).
RUN_FIELDS = {
    "plummer": dict(integrator="leapfrog", eps=1e9),
    "cold_collapse": dict(integrator="leapfrog", eps=1e9),
    "hernquist": dict(integrator="leapfrog", eps=1e9, dt=1e4),
    "merger": dict(integrator="leapfrog", g=1.0, dt=2e-3, eps=0.05),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _stats(state, g, eps, diag):
    """Lagrangian radii, virial ratio and velocity dispersion of a state,
    by ``diag`` (either package's diagnostics module)."""
    radii = np.asarray(diag.lagrangian_radii(state), np.float64)
    return np.concatenate([
        radii, [float(diag.virial_ratio(state, g=g, eps=eps)),
                float(diag.velocity_dispersion(state))]])


@pytest.mark.parametrize("name", NEW_MODELS)
def test_model_distribution_matches_jax(name):
    g, eps = PHYSICS[name]
    port = np.stack([
        _stats(create_model(name, _gen(seed), N, torch.float32), g, eps,
               diagnostics)
        for seed in range(SEEDS)])
    jax_state = jax_models.create_model(name, jax.random.PRNGKey(0), N,
                                        jnp.float32)
    want = _stats(jax_state, g, eps, jax_diag)
    se = port.std(axis=0, ddof=1) * math.sqrt(2.0)
    gap = np.abs(port[0] - want)
    labels = ("r10", "r50", "r90", "virial", "sigma_v")
    for label, d, s in zip(labels, gap, se):
        assert d <= 5.0 * s, (name, label, d, s)
    if name == "cold_collapse":
        # At rest: no kinetic energy in either package.
        assert port[:, 3:].max() == 0.0 and want[3] == 0 and want[4] == 0
    if name == "plummer":
        # Softened at eps = 1e9 m (a thousandth of a), the sphere sits near
        # virial equilibrium; finite-N and softening lift 2T/|W| above 0.5.
        assert 0.45 < port[:, 3].mean() < 0.8


@pytest.mark.parametrize("name", NEW_MODELS)
def test_model_determinism_dtypes_and_mass(name):
    a = create_model(name, _gen(5), 1000, torch.float32)
    b = create_model(name, _gen(5), 1000, torch.float32)
    c = create_model(name, _gen(6), 1000, torch.float32)
    for x, y in zip(state_to_numpy(a), state_to_numpy(b)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(state_to_numpy(c)[0], state_to_numpy(a)[0])
    f64 = create_model(name, _gen(5), 1000, torch.float64)
    bf16 = create_model(name, _gen(5), 1000, torch.bfloat16)
    assert (a.dtype, f64.dtype, bf16.dtype) == (torch.float32, torch.float64,
                                                torch.bfloat16)
    if name != "merger":
        # One float64 draw, rounded once to each dtype (the merger tilts
        # and offsets its rounded disks in the state's dtype, as JAX).
        assert torch.equal(f64.positions.float(), a.positions)
        assert torch.equal(f64.positions.to(torch.bfloat16), bf16.positions)
    for state in (a, f64, bf16):
        assert state.n == 1000
        assert bool(torch.isfinite(state.positions).all()
                    & torch.isfinite(state.velocities).all())
    jax_masses = np.asarray(jax_models.create_model(
        name, jax.random.PRNGKey(0), 1000, jnp.float32).masses)
    np.testing.assert_allclose(state_to_numpy(a)[2], jax_masses, rtol=1e-6)


@pytest.mark.parametrize("name", ["plummer", "cold_collapse", "hernquist"])
def test_spheres_are_centred_exactly(name):
    state = create_model(name, _gen(2), 3000, torch.float64)
    for t in (state.positions, state.velocities):
        assert float(t.mean(dim=0).abs().max()) <= 1e-13 * float(
            t.abs().max())


def test_hernquist_jeans_dispersion_equals_jax(x64):
    s = np.logspace(-9, 4, 200)
    want = np.asarray(jax_jeans_sigma2(jnp.asarray(s), 3.0))
    got = _jeans_sigma2(torch.from_numpy(s), 3.0).numpy()
    # The bracket cancels at large s: the tolerance is in units of its
    # first term, 12 s (1 + s)^3 ln(1 + 1/s) (times gm/a / 12).
    term = 3.0 * s * (1.0 + s) ** 3 * np.log1p(1.0 / s)
    assert np.all(np.abs(got - want) <= 1e-14 * term)
    # Hernquist's profile: every speed under 0.95 of the escape speed.
    state = create_model("hernquist", _gen(1), 5000, torch.float64)
    r = torch.linalg.norm(state.positions, dim=1)
    v = torch.linalg.norm(state.velocities, dim=1)
    v_esc = torch.sqrt(2 * 6.6743e-11 * 1e30 / (r + 1e12))
    # Scaled to at most 0.95 v_esc before the re-centring, which shifts
    # each velocity by the draw's mean (~1e-2 of sigma): bound by v_esc.
    assert float((v / v_esc).max()) < 1.0


def _group_geometry(pos, vel, masses, n):
    """Each disk's centre and the unit normal of its angular momentum
    about that centre."""
    out = []
    for sl in (slice(0, n // 2), slice(n // 2, n)):
        p, v, m = (np.asarray(a[sl], np.float64) for a in (pos, vel, masses))
        centre = (m[:, None] * p).sum(0) / m.sum()
        vbar = (m[:, None] * v).sum(0) / m.sum()
        ang = (m[:, None] * np.cross(p - centre, v - vbar)).sum(0)
        out.append((centre, ang / np.linalg.norm(ang)))
    return out


def test_merger_groups_separation_and_tilt():
    n = 4001
    state = create_model("merger", _gen(0), n, torch.float32)
    pos, vel, masses = state_to_numpy(state)
    # n // 2 and n - n // 2 bodies, each disk's bulge (mass 1) first.
    assert masses[0] == 1.0 and masses[n // 2] == 1.0
    assert (masses == 1.0).sum() == 2
    (c1, l1), (c2, l2) = _group_geometry(pos, vel, masses, n)
    jax_state = jax_models.create_model("merger", jax.random.PRNGKey(0), n,
                                        jnp.float32)
    (j1, k1), (j2, k2) = _group_geometry(
        *(np.asarray(a) for a in (jax_state.positions, jax_state.velocities,
                                  jax_state.masses)), n)
    # Offsets -/+ (18, 3, 0)/2 about the centre, the bulge dominating each
    # disk's centre of mass: within 0.2 kpc of the target and of JAX's.
    for got, jax_c, want in ((c1, j1, [-9.0, -1.5, 0.0]),
                             (c2, j2, [9.0, 1.5, 0.0])):
        np.testing.assert_allclose(got, want, atol=0.2)
        np.testing.assert_allclose(got, jax_c, atol=0.2)
    # Disk 1 spins about +z; disk 2 about z tilted by 0.5 rad about x.
    tilt = np.array([0.0, -math.sin(0.5), math.cos(0.5)])
    np.testing.assert_allclose(l1, [0.0, 0.0, 1.0], atol=0.02)
    np.testing.assert_allclose(l2, tilt, atol=0.02)
    np.testing.assert_allclose(k2, tilt, atol=0.02)
    # Approach velocities +/- (0.7, 0, 0) / 2, the bulges at rest.
    np.testing.assert_allclose(vel[0], [0.35, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(vel[n // 2], [-0.35, 0.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("name", NEW_MODELS)
def test_new_models_run_like_the_jax_simulator(x64, name):
    """A few leapfrog steps of each model with its run's fields, one
    state handed to both Simulators, fp64."""
    n, steps = 128, 5
    jax_state = jax_models.create_model(name, jax.random.PRNGKey(1), n,
                                        jnp.float64)
    arrays = [np.asarray(a) for a in (jax_state.positions,
                                      jax_state.velocities, jax_state.masses)]
    fields = dict(RUN_FIELDS[name], model=name, n=n, steps=steps,
                  dtype="float64", progress_every=steps)
    jax_final = JaxSimulator(
        JaxConfig(**fields, force_backend="dense"),
        state=JaxState(*(jnp.asarray(a) for a in arrays)),
    ).run()["final_state"]
    # "pallas" is the kernel's wrapper, which takes the plain version on
    # CPU tensors: the route of the baseline presets.
    sim = Simulator(SimulationConfig(**fields, force_backend="pallas"),
                    state_from_numpy(*arrays, dtype=torch.float64,
                                     device="cpu"), device="cpu")
    stats = sim.run()
    got = state_to_numpy(stats["final_state"])
    for g_arr, w_arr in zip(got[:2], (jax_final.positions,
                                      jax_final.velocities)):
        w_arr = np.asarray(w_arr)
        err = np.linalg.norm(g_arr - w_arr, axis=1)
        scale = np.linalg.norm(w_arr, axis=1)
        assert np.all(err <= 1e-10 * scale), float(np.max(err / scale))
    assert sim.backend == "nbody_direct" and stats["kernel_launches"] == 0


def test_diagnostics_equal_the_jax_diagnostics(x64):
    """Every ported diagnostic on one fp64 state, against the JAX one:
    rtol 1e-12 (summation order only); the Lagrangian radii exactly."""
    jax_state = jax_models.create_model("plummer", jax.random.PRNGKey(2),
                                        2000, jnp.float64)
    arrays = [np.asarray(a) for a in (jax_state.positions,
                                      jax_state.velocities, jax_state.masses)]
    state = state_from_numpy(*arrays, dtype=torch.float64, device="cpu")
    kw = dict(g=6.6743e-11, eps=1e9)
    pos, vel, masses = arrays
    # Absolute tolerances in units of the terms summed: the centred
    # state's momentum and centre of mass are sums that cancel to ~0.
    scales = {"kinetic_energy": 0.0,
              "total_momentum": float((masses[:, None] * np.abs(vel)).sum()),
              "center_of_mass": float(np.abs(pos).max()),
              "velocity_dispersion": 0.0}
    for fn, scale in scales.items():
        np.testing.assert_allclose(
            np.asarray(getattr(diagnostics, fn)(state)),
            np.asarray(getattr(jax_diag, fn)(jax_state)), rtol=1e-12,
            atol=1e-12 * scale, err_msg=fn)
    for fn in ("total_energy", "virial_ratio"):
        np.testing.assert_allclose(
            float(getattr(diagnostics, fn)(state, **kw)),
            float(getattr(jax_diag, fn)(jax_state, **kw)), rtol=1e-12,
            err_msg=fn)
    np.testing.assert_allclose(diagnostics.kinetic_energy_f64(state),
                               jax_diag.kinetic_energy_f64(jax_state),
                               rtol=1e-12)
    np.testing.assert_allclose(diagnostics.total_angular_momentum(state),
                               jax_diag.total_angular_momentum(jax_state),
                               rtol=1e-12)
    # Radii are order statistics: the fraction k m / M of equal masses
    # sits on a boundary of the cumulative sum, which the two packages
    # round in different orders, so either may pick the next radius.
    fracs = (0.1, 0.25, 0.5, 0.9)
    got = np.append(diagnostics.lagrangian_radii(state, fracs).numpy(),
                    float(diagnostics.half_mass_radius(state)))
    want = np.append(np.asarray(jax_diag.lagrangian_radii(jax_state, fracs)),
                     float(jax_diag.half_mass_radius(jax_state)))
    com = np.asarray(jax_diag.center_of_mass(jax_state))
    r_sorted = np.sort(np.linalg.norm(pos - com, axis=1))
    rank = lambda r: np.argmin(np.abs(r_sorted[:, None] - r), axis=0)  # noqa: E731
    assert np.all(np.abs(rank(got) - rank(want)) <= 1), (got, want)
    assert diagnostics.energy_drift(-2.0, -2.5) == float(
        jax_diag.energy_drift(-2.0, -2.5))


@pytest.mark.parametrize("name", ["baseline-16k", "baseline-2m",
                                  "baseline-1m"])
def test_baseline_presets_load_from_the_jax_config(name):
    """The JAX package's preset, written by its to_json, is the port's
    preset field for field."""
    cfg = SimulationConfig.from_json(JAX_PRESETS[name].to_json())
    assert dataclasses.replace(cfg, log_dir=PRESETS[name].log_dir) == \
        PRESETS[name]
    assert json.loads(cfg.to_json())["model"] == JAX_PRESETS[name].model
