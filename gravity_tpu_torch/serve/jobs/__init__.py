"""Served job classes.

Counterpart of ``gravity_tpu/serve/jobs/__init__.py``. Importing this
package registers ``integrate`` (advance N steps). The JAX package's
``fit``, ``sweep`` and ``watch`` (ROADMAP.md Queue 1 item 9) and
``sharded-integrate`` (item 5) are refused at submit by
:func:`~.registry.get_class`.
"""

from .integrate import IntegrateJob  # noqa: F401
from .registry import (  # noqa: F401
    NOT_PORTED,
    REGISTRY,
    JobClass,
    JobValidationError,
    get_class,
    job_types,
)
