"""Force and integration operators.

Counterpart of ``gravity_tpu/ops/``: the plain PyTorch direct sum
(``forces``) and its hand-written CUDA kernel (``direct_kernel``), the
Gram-form direct sum and its kernel (``mxu_kernel``), the cell binning
(``cells``) and the cutoff-radius cell list with its kernel (``nlist``,
whose ``ewald`` kind is P3M's near field), the CIC mass assignment
(``pm``) and the P3M solver (``p3m``), the kernels' build and load step
(``cuda_build``) and the time integrators (``integrators``).
"""
