"""Host-side utilities: device selection, run logging, trajectories.

Counterpart of ``gravity_tpu/utils/``.
"""
