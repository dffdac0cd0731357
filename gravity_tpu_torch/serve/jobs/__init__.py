"""Served job classes.

Counterpart of ``gravity_tpu/serve/jobs/__init__.py``. Importing this
package registers ``integrate`` (advance N steps) and
``sharded-integrate`` (one big-n job across a worker group's devices).
The JAX package's ``fit``, ``sweep`` and ``watch`` (ROADMAP.md Queue 1
item 9) are refused at submit by :func:`~.registry.get_class`.
"""

from .integrate import IntegrateJob  # noqa: F401
from .sharded import ShardedIntegrateJob  # noqa: F401
from .registry import (  # noqa: F401
    NOT_PORTED,
    REGISTRY,
    JobClass,
    JobValidationError,
    get_class,
    job_types,
)
