"""Ensemble serving: many independent simulations as one batched loop.

Counterpart of ``gravity_tpu/serve/``. Three layers:

- :mod:`.engine` — the batched multi-simulation engine: B systems,
  zero-mass-padded to one power-of-two bucket, step together, a force
  evaluation of the batch one launch of a hand-written kernel with a
  slot grid axis; one build per (bucket, slots, backend, dtype,
  integrator, physics) key.
- :mod:`.scheduler` — bucketed continuous batching: admission queue,
  slot backfill, priority preemption, anti-starvation yields, per-slot
  divergence isolation, occupancy/latency metrics, spool persistence.
- :mod:`.service` — the localhost HTTP/JSON daemon
  (``python -m gravity_tpu_torch serve``) and the
  submit/status/result/cancel client verbs.

Fleet resilience: :mod:`.leases` (TTL job leases with fencing tokens and
heartbeats) and :mod:`.breaker` (per-backend circuit breakers at
admission). Traffic classes (:mod:`.jobs`): ``integrate``, ``fit``,
``sweep``, ``watch`` and ``sharded-integrate``, each under the same
scheduler, lease and breaker contracts. :mod:`.router` — the pod router
(``python -m gravity_tpu_torch route``): a stateless placement tier that
speaks the worker API in front and places each submit onto a worker by
measured evidence (compile affinity, sharded capability, memory fit,
per-class latency, load); ``drain`` takes a worker out of its rotation.
"""

from .breaker import BreakerBoard, CircuitBreaker  # noqa: F401
from .engine import (  # noqa: F401
    ENGINE_BACKENDS,
    BatchKey,
    EnsembleBatch,
    EnsembleEngine,
    batch_key_for,
    bucket_size,
)
from .jobs import (  # noqa: F401
    JobValidationError,
    fit_solo,
    get_class,
    job_types,
    sweep_member_solo,
    watch_solo,
)
from .leases import Lease, LeaseManager  # noqa: F401
from .scheduler import (  # noqa: F401
    EnsembleScheduler,
    Job,
    QueueFull,
    Spool,
    default_worker_id,
)
from .router import (  # noqa: F401
    PlacementError,
    RouterDaemon,
    WorkerView,
    place,
)
from .service import (  # noqa: F401
    DaemonUnreachable,
    GravityDaemon,
    backoff_delay,
    find_daemon,
    request,
    wait_for,
)
