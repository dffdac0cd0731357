"""gravity_tpu_torch: the PyTorch and CUDA port of gravity_tpu.

The JAX package ``gravity_tpu`` beside it is the reference. This package
imports neither it nor JAX. Module names mirror the JAX package's, and
each module's docstring names its counterpart. Entry points run on the
GPU unless the caller asks for the CPU (``utils/platform.py``).

Ported so far: the reference direct-sum ``run`` (the solar and
random-cube initial conditions, the O(N^2) direct sum with its CUDA
kernel ``csrc/nbody_direct.cu``, the four fixed-dt integrators, the
reference log and ``.npy`` trajectories); the cutoff-radius cell list
(``--force-backend nlist``: ``ops/cells.py``, ``ops/nlist.py``,
``csrc/nlist_pair.cu``); the Gram-form direct sum
(``--force-backend pallas-mxu``: ``ops/mxu_kernel.py``,
``csrc/nbody_mxu.cu``); P3M (``ops/pm.py``, ``ops/p3m.py``); the
plummer, cold_collapse, hernquist, disk and merger models with the
``baseline-16k`` and ``baseline-2m`` presets; bf16 states on the direct
sums; the state diagnostics (``ops/diagnostics.py``); and the
integration modes: multirate block timesteps whose fast kicks launch
each kernel at a rectangular shape (``ops/multirate.py``,
``simulation.make_local_kernel``), adaptive dt (``ops/adaptive.py``),
external fields (``ops/external.py``) and collision merging
(``ops/encounters.py``); the octree (``ops/tree.py``, preset
``baseline-1m``), whose ``--tree-near nlist`` near field launches the
cell-list kernel untruncated; the fast multipole solvers
(``ops/fmm.py``, ``ops/sfmm.py``, preset ``baseline-1m-fmm``), plain
PyTorch as the JAX package's are jnp; and the measurement layer:
``bench.py``
(the ``bench`` verb and ``python -m gravity_tpu_torch.bench``),
``autotune.py`` (plain ``auto`` routes by measurement; the ``tune``
verb) and ``utils/timing.py``; and the ensemble serving path
(``serve/``, ``telemetry/``: the ``serve``, ``submit``, ``status``,
``result`` and ``cancel`` verbs, a batch's force evaluation one launch
of ``nbody_direct.cu`` or ``nbody_mxu.cu`` with a slot grid axis); and
the periodic box and cosmology, plain PyTorch and ``torch.fft`` as the
JAX package's are XLA and ``jnp.fft``: the ``pm`` solver isolated and
periodic (``ops/pm.py``, ``ops/periodic.py``), the minimum-image cell
list, the ``grf`` model (``models/grf.py``), ``ops/cosmo.py`` with the
``cosmo`` verb, ``ops/spectra.py`` and ``ops/halos.py`` with the
``analyze`` verb; and multi-device runs (``parallel/``: the sharded
direct sums on ``torch.distributed``, allgather, the ring and the
hierarchical ring, with the presets ``baseline-262k`` and
``baseline-2m-merger``; the halo slab engine of the cell list and of
P3M's near field, ``parallel/halo.py``; sharded multirate and adaptive
steps); and the tooling: ``validate.py`` (the ``validate`` verb and its
card gate), ``utils/gtrj_tool.py`` (``traj``), ``bench --report``,
``analysis/`` (``lint``), ``utils/units.py`` and ``examples/``.
``ops/cuda_build.py`` builds every kernel.
"""

from .config import PRESETS, SimulationConfig
from .state import ParticleState

__all__ = ["PRESETS", "ParticleState", "SimulationConfig"]
