"""The port's external fields (ops/external.py) against the JAX package.

The same numpy positions, made from a seed, go through each JAX field
and its counterpart. Tolerances, relative on each row's vector (or
value): fp64 1e-12, fp32 1e-5 (the two packages' rsqrt, sqrt, log and
log1p differ by an ulp or two, and a field's few ops add a few ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.config import SimulationConfig as JaxConfig
from gravity_tpu.ops import external as jext
from gravity_tpu.simulation import Simulator as JaxSimulator
from gravity_tpu.state import ParticleState as JaxState
from gravity_tpu_torch.config import SimulationConfig
from gravity_tpu_torch.interop import state_from_numpy
from gravity_tpu_torch.ops import external
from gravity_tpu_torch.simulation import Simulator

TOL = {"float32": 1e-5, "float64": 1e-12}
CENTER = (1e10, -2e10, 5e9)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

FIELDS = [
    ("point_mass", dict(gm=1.3e20, center=CENTER, eps=1e9)),
    ("plummer", dict(gm=1.3e20, a=1e11, center=CENTER)),
    ("hernquist", dict(gm=1.3e20, a=1e11, center=CENTER)),
    ("nfw", dict(gm=1e21, rs=2e11, center=CENTER)),
    ("logarithmic", dict(v0=2e4, rc=1e11, center=CENTER)),
    ("uniform", dict(gx=1e-6, gy=-2e-6, gz=3e-7)),
]


def _positions(dtype, n=512, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3e11, 3e11, (n, 3))
    pos[0] = CENTER  # the centre itself: the floors of each field
    return pos.astype(dtype)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if want.ndim == 1:
        got, want = got[:, None], want[:, None]
    err = np.linalg.norm(got - want, axis=1)
    scale = np.linalg.norm(want, axis=1)
    assert np.all(err <= tol * scale + 1e-300), float(np.max(err / scale))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,kwargs", FIELDS, ids=[f[0] for f in FIELDS])
def test_field_and_potential_match_jax(x64, name, kwargs, dtype):
    pos = _positions(dtype)
    for suffix in ("", "_phi"):
        want = getattr(jext, name + suffix)(**kwargs)(jnp.asarray(pos))
        got = getattr(external, name + suffix)(**kwargs)(
            torch.from_numpy(pos))
        assert got.dtype == getattr(torch, dtype)
        assert got.shape == want.shape
        _close(got.numpy(), np.asarray(want), TOL[dtype])


@pytest.mark.parametrize("name,kwargs", FIELDS, ids=[f[0] for f in FIELDS])
def test_field_is_minus_the_gradient_of_its_potential(name, kwargs):
    """a = -grad phi, by central differences in fp64 away from the
    centre."""
    pos = torch.from_numpy(_positions(np.float64, n=16)[1:])
    acc = getattr(external, name)(**kwargs)(pos)
    phi = getattr(external, name + "_phi")(**kwargs)
    h = 1e5
    grad = torch.stack([
        (phi(pos + h * e) - phi(pos - h * e)) / (2 * h)
        for e in torch.eye(3, dtype=torch.float64)
    ], dim=1)
    _close((-grad).numpy(), acc.numpy(), 1e-6)


SPECS = [
    "pointmass:gm=1.3e20",
    "pointmass:gm=1.3e20,x=1e10,eps=1e9 + uniform:gz=-9.8e-6",
    "nfw:gm=1e21,rs=2e11 + hernquist:gm=1e20,a=1e11 + "
    "logarithmic:v0=2e4,rc=1e11",
    "Plummer: GM=1e+20, A=1e11 + uniform:gx=1e-7",
]


@pytest.mark.parametrize("kind", ["accel", "potential"])
@pytest.mark.parametrize("spec", SPECS)
def test_parse_external_sums_match_jax(x64, spec, kind):
    pos = _positions(np.float64)
    want = jext.parse_external(spec, kind)(jnp.asarray(pos))
    got = external.parse_external(spec, kind)(torch.from_numpy(pos))
    _close(got.numpy(), np.asarray(want), TOL["float64"])


@pytest.mark.parametrize("spec,match", [
    ("warp:gm=1", "unknown external potential"),
    ("nfw:gm=1", "needs"),
    ("plummer:gm=1,a=2,q=3", "unknown parameter"),
    ("  ", "empty external-potential spec"),
])
def test_parse_external_refuses_like_jax(spec, match):
    for parse in (jext.parse_external, external.parse_external):
        with pytest.raises(ValueError, match=match):
            parse(spec)
    with pytest.raises(ValueError, match="unknown kind"):
        external.parse_external("pointmass:gm=1", kind="density")


@pytest.mark.parametrize("integrator", ["leapfrog", "multirate"])
def test_external_run_and_energy_match_jax(x64, integrator):
    """A run under a Plummer halo plus a uniform field: the final state
    and KE + PE_self + PE_ext equal the JAX Simulator's (fp64)."""
    rng = np.random.default_rng(5)
    n = 128
    pos = rng.uniform(-3e11, 3e11, (n, 3))
    vel = rng.uniform(-3e4, 3e4, (n, 3))
    masses = rng.uniform(1e23, 1e25, n)
    kw = dict(n=n, steps=8, dtype="float64", integrator=integrator,
              multirate_k=16, force_backend="dense", eps=1e9,
              external="plummer:gm=1.3e20,a=1e11 + uniform:gz=-1e-6",
              progress_every=4)
    jax_sim = JaxSimulator(JaxConfig(**kw), state=JaxState(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(masses)))
    sim = Simulator(SimulationConfig(**kw), device="cpu",
                    state=state_from_numpy(pos, vel, masses,
                                           dtype=torch.float64,
                                           device="cpu"))
    e0, e0_jax = float(sim.energy()), float(jax_sim.energy())
    assert abs(e0 - e0_jax) <= 1e-12 * abs(e0_jax)
    final = sim.run()["final_state"]
    want = jax_sim.run()["final_state"]
    for a, b in ((final.positions, want.positions),
                 (final.velocities, want.velocities)):
        _close(a.numpy(), np.asarray(b), TOL["float64"])
    e1, e1_jax = float(sim.energy()), float(jax_sim.energy())
    assert abs(e1 - e1_jax) <= 1e-12 * abs(e1_jax)
    # The field's own energy is part of the sum.
    no_ext = Simulator(SimulationConfig(**{**kw, "external": ""}),
                       device="cpu", state=final)
    assert abs(float(no_ext.energy()) - e1) > 1e-6 * abs(e1)
