"""Served job classes.

Counterpart of ``gravity_tpu/serve/jobs/__init__.py``. Importing this
package registers the traffic classes:

- ``integrate``: advance N steps;
- ``fit``: inverse problems through the differentiable rollout, an Adam
  or gradient-descent loop over a batch of slots (the kernels' backward
  is the JAX package's dense VJP, ``ops/forces.DenseVJP``);
- ``sweep`` and its internal ``sweep-member``: ensemble stability
  surveys, perturbed ICs fanned into the batches, per-member energy
  drift, escape and minimum-separation verdicts aggregated by the parent;
- ``watch``: event-driven runs, closest-pair encounter and merger events
  through the serving stream, with optional high-resolution follow-ups;
- ``sharded-integrate``: one big-n job across a worker group's devices.
"""

from .fit import FitJob, fit_solo  # noqa: F401
from .integrate import IntegrateJob  # noqa: F401
from .registry import (  # noqa: F401
    NOT_PORTED,
    REGISTRY,
    JobClass,
    JobValidationError,
    get_class,
    job_types,
)
from .sharded import ShardedIntegrateJob  # noqa: F401
from .sweep import (  # noqa: F401
    SweepJob,
    SweepMemberJob,
    sweep_member_solo,
)
from .watch import WatchJob, watch_solo  # noqa: F401
