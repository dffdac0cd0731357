"""The ``integrate`` job class: advance N steps.

Counterpart of ``gravity_tpu/serve/jobs/integrate.py``. Its round is the
:class:`~gravity_tpu_torch.serve.engine.EnsembleEngine`'s own batched
loop; what the class adds is the admission half: an optional inline
``params["state"]`` (positions/velocities/masses at config.n) that
replaces the model's initial conditions.
"""

from __future__ import annotations

from .registry import (
    JobClass,
    JobValidationError,
    register,
    validate_params_state,
)


class IntegrateJob(JobClass):
    name = "integrate"
    units = "steps"

    def validate(self, config, params):
        params = dict(params or {})
        unknown = set(params) - {"state"}
        if unknown:
            raise JobValidationError(
                f"integrate takes no params {sorted(unknown)} "
                "(only an optional inline 'state')"
            )
        validate_params_state(config, params)
        return params


register(IntegrateJob())
