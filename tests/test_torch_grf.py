"""The port's grf model (models/grf.py) against the JAX package's, on the
CPU, one realization in both: the port's spectral core takes the JAX
package's normal draws ``jax.random.normal(kr|ki, shape)`` of the same
key. States are compared by minimum-image position difference: 1e-10 of
the box in fp64 and 1e-5 of the box in fp32 (the two FFT libraries round
differently; a displaced body next to a face may wrap on one side and
not the other, which the minimum image absorbs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravity_tpu.models import grf as jax_grf
from gravity_tpu_torch.models import create_model, grf

BOX = 1.0e13
TOL = {"float32": 1e-5, "float64": 1e-10}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the suite runs several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _normals(seed, side):
    """The JAX package's two normal fields of ``PRNGKey(seed)``."""
    kr, ki = jax.random.split(jax.random.PRNGKey(seed))
    shape = (side, side, side // 2 + 1)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                 for k in (kr, ki))


def _min_image_gap(a, b, box=BOX):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(d - box * np.round(d / box)).max() / box


def _table():
    k = np.geomspace(1e-13, 1e-10, 40)
    return np.stack([k, 1e40 * k**-1.5 / (1 + (k / 3e-12) ** 2)], axis=1)


SPECTRA = {
    "power_law": (None, None),
    "table": (_table(), _table()),
    "callable": (lambda k: jnp.exp(-k / 5e-12) * (k + 1e-14) ** -1.0,
                 lambda k: torch.exp(-k / 5e-12) * (k + 1e-14) ** -1.0),
}


@pytest.mark.parametrize("lpt_order", [1, 2])
@pytest.mark.parametrize("spectrum", sorted(SPECTRA))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grf_states_equal_jax(dtype, spectrum, lpt_order, x64):
    if dtype == "float32":
        jax.config.update("jax_enable_x64", False)
    n, side = 8**3, 8
    j_spec, t_spec = SPECTRA[spectrum]
    kw = dict(box=BOX, sigma_psi=0.02, vel_factor=1e-3, lpt_order=lpt_order)
    want = jax_grf.create_grf(jax.random.PRNGKey(3), n,
                              dtype=getattr(jnp, dtype),
                              power_spectrum=j_spec, **kw)
    got = grf.create_grf(_normals(3, side), n, dtype=getattr(torch, dtype),
                         power_spectrum=t_spec, **kw)
    assert got.positions.dtype == getattr(torch, dtype)
    assert _min_image_gap(got.positions.numpy(), want.positions) \
        < TOL[dtype]
    vel = np.asarray(want.velocities, np.float64)
    assert np.abs(got.velocities.double().numpy() - vel).max() \
        <= TOL[dtype] * np.abs(vel).max() * 10
    np.testing.assert_array_equal(got.masses.numpy(),
                                  np.asarray(want.masses))


def test_fields_lattice_and_registry_match_jax(x64):
    """grf_displacement_fields, the lattice, the 2LPT field of crossed
    waves and the registry's periodic_box against the JAX package."""
    n, side = 8**3, 8
    jp1, jp2 = jax_grf.grf_displacement_fields(jax.random.PRNGKey(1), n,
                                               box=BOX)
    p1, p2 = grf.grf_displacement_fields(_normals(1, side), n, box=BOX,
                                         dtype=torch.float64)
    for got, want in ((p1, jp1), (p2, jp2)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
    np.testing.assert_array_equal(
        grf.grf_lattice(side, BOX, dtype=torch.float64).numpy(),
        np.asarray(jax_grf.grf_lattice(side, BOX, dtype=jnp.float64)))
    with pytest.raises(ValueError, match="perfect-cube"):
        grf.grf_side(100)
    with pytest.raises(ValueError, match="table"):
        grf.create_grf(_normals(0, side), n, power_spectrum=np.ones((3, 3)))
    with pytest.raises(ValueError, match="lpt_order"):
        grf.create_grf(_normals(0, side), n, lpt_order=3)
    # The registry honours the run's box: the lattice spans it.
    st = create_model("grf", torch.Generator().manual_seed(0), n,
                      torch.float64, periodic_box=3e12)
    pos = st.positions.numpy()
    assert pos.max() < 3e12 and pos.max() > 0.8 * 3e12
