"""Physical and behavioral constants shared by every backend.

Counterpart of ``gravity_tpu/constants.py``, copied so that the PyTorch
port imports nothing of the JAX package. The values reproduce the
reference's cross-backend constants: G, the ``r < 1e-10`` close-approach
cutoff, dt/steps, the solar seed and the random-cube bounds.
"""

# Newtonian gravitational constant [m^3 kg^-1 s^-2].
G = 6.67430e-11

# Close-approach cutoff: pairs with r < CUTOFF contribute zero force.
# (The reference uses this instead of Plummer softening.)
CUTOFF_RADIUS = 1e-10

# Reference defaults for the step loop.
DEFAULT_DT = 3600.0  # seconds
DEFAULT_STEPS = 500

# Solar-system seed bodies (identical constants in all three reference
# backends).
SUN_MASS = 1.989e30  # kg
EARTH_ORBIT_RADIUS = 1.496e11  # m
EARTH_ORBIT_SPEED = 29.78e3  # m/s
EARTH_MASS = 5.972e24  # kg
MARS_ORBIT_RADIUS = 2.279e11  # m
MARS_ORBIT_SPEED = 24.077e3  # m/s
MARS_MASS = 6.39e23  # kg

# Random-IC distributions.
RANDOM_POS_BOUND = 3.0e11  # m; positions uniform in [-bound, bound]^3
RANDOM_VEL_BOUND = 3.0e4  # m/s; velocities uniform in [-bound, bound]^3
RANDOM_MASS_LOW = 1.0e23  # kg
RANDOM_MASS_HIGH = 1.0e25  # kg

# Progress print cadence ("Step k/STEPS" every 100 steps).
PROGRESS_EVERY = 100
