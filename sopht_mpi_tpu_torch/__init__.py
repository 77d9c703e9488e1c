"""sopht_mpi_tpu_torch: the PyTorch / CUDA port of ``sopht_mpi_tpu``.

The same vorticity-form unbounded Navier-Stokes solver with penalty
immersed-boundary coupling, on one NVIDIA Hopper GPU. The module layout
and public names mirror ``sopht_mpi_tpu`` so each counterpart is easy to
find. Plain tensor work is PyTorch; each Pallas kernel of the JAX package
becomes a hand-written Hopper kernel (``csrc/``, built at first use by
``_build``). The port covers the fused 3D flow-past-sphere FSI step; see
ROADMAP.md for what follows.
"""

from sopht_mpi_tpu_torch import models, ops, utils

__version__ = "0.1.0"
