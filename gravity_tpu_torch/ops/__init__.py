"""Force and integration operators.

Counterpart of ``gravity_tpu/ops/``: the plain PyTorch direct sum
(``forces``) and its hand-written CUDA kernel (``direct_kernel``), the
Gram-form direct sum and its kernel (``mxu_kernel``), the cell binning
(``cells``) and the cutoff-radius cell list with its kernel (``nlist``),
the kernels' build and load step (``cuda_build``) and the time integrators
(``integrators``).
"""
