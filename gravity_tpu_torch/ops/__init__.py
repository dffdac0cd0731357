"""Force and integration operators.

Counterpart of ``gravity_tpu/ops/``: the plain PyTorch direct sum
(``forces``), its hand-written CUDA kernel (``direct_kernel``) and the
time integrators (``integrators``).
"""
