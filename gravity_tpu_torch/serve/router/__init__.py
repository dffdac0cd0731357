"""Pod router — the evidence-driven placement tier over serving workers.

Counterpart of ``gravity_tpu/serve/router/``:

- :mod:`.policy` — placement as a PURE function: worker views
  (registry capability metadata + published metrics + perf-ledger
  memory evidence) in, one auditable :class:`~.policy.Decision` (or a
  typed :class:`~.policy.PlacementError`) out.
- :mod:`.daemon` — the stateless ``gravity_tpu_torch route`` HTTP
  daemon: same API as a worker in front, policy-placed proxying behind,
  status/result/cancel served straight from the shared spool.
"""

from .daemon import ROUTER_FILE, RouterDaemon  # noqa: F401
from .policy import (  # noqa: F401
    Decision,
    JobSpec,
    PlacementError,
    WorkerView,
    place,
)
