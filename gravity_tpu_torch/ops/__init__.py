"""Force and integration operators.

Counterpart of ``gravity_tpu/ops/``: the plain PyTorch direct sum
(``forces``) and its hand-written CUDA kernel (``direct_kernel``), the
Gram-form direct sum and its kernel (``mxu_kernel``), the cell binning
(``cells``) and the cutoff-radius cell list with its kernel (``nlist``,
whose ``ewald`` kind is P3M's near field), the CIC mass assignment
(``pm``), the P3M solver (``p3m``), the octree (``tree``, whose
cell-list near field is ``nlist.nlist_near_field``), the fast multipole
solvers (``fmm``, its sparse layout ``sfmm``), the kernels' build
and load step
(``cuda_build``), the time integrators (``integrators``), the state
diagnostics (``diagnostics``) and the integration modes: multirate
block timesteps (``multirate``), adaptive dt (``adaptive``), external
fields (``external``) and collision merging (``encounters``).
"""
