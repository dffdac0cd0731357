"""The port's unit helpers (``gravity_tpu_torch/utils/units.py``) against
the JAX package's ``gravity_tpu/utils/units.py``: every constant the same
bits, every converter the same value on the same inputs."""

import numpy as np
import pytest

from gravity_tpu.utils import units as jax_units
from gravity_tpu_torch.utils import units

CONSTANTS = ("G_SI", "KPC_M", "MSUN_KG", "LENGTH_UNIT_M", "MASS_UNIT_KG",
             "VELOCITY_UNIT_MS", "TIME_UNIT_S")
CONVERTERS = tuple(f"{a}_to_{b}_{q}" for a, b in (("si", "galactic"),
                                                   ("galactic", "si"))
                   for q in ("length", "mass", "velocity", "time"))


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_are_the_jax_packages_bits(name):
    ours, theirs = getattr(units, name), getattr(jax_units, name)
    assert type(ours) is float
    assert np.float64(ours).tobytes() == np.float64(theirs).tobytes()


@pytest.mark.parametrize("name", CONVERTERS)
def test_converters_agree(name):
    x = np.random.default_rng(0).uniform(-1e3, 1e3, 64) * 10.0 ** np.arange(
        -16, 48)
    ours, theirs = getattr(units, name), getattr(jax_units, name)
    assert np.array_equal(ours(x), theirs(x))
    assert ours(2.5) == theirs(2.5)


def test_round_trips_and_galactic_scales():
    assert units.galactic_to_si_length(units.si_to_galactic_length(
        3.0e20)) == pytest.approx(3.0e20, rel=1e-15)
    # ~207.4 km/s and ~4.7 Myr, the module's stated scales.
    assert units.VELOCITY_UNIT_MS == pytest.approx(2.074e5, rel=1e-3)
    assert units.TIME_UNIT_S / 3.15576e13 == pytest.approx(4.7, rel=0.01)
