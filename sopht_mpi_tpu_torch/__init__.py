"""sopht_mpi_tpu_torch: the PyTorch / CUDA port of ``sopht_mpi_tpu``.

The same vorticity-form unbounded Navier-Stokes solver with penalty
immersed-boundary coupling, on one NVIDIA Hopper GPU. The module layout
and public names mirror ``sopht_mpi_tpu`` so each counterpart is easy to
find. Plain tensor work is PyTorch; each Pallas kernel of the JAX package
becomes a hand-written Hopper kernel (``csrc/``, built at first use by
``_build``). The port covers the fused 3D FSI steps of a rigid sphere, a
Cosserat rod and any mix of rods and rigid bodies, and the 2D flow
(Lamb-Oseen vortex, flow past a cylinder); see ROADMAP.md for what follows.
"""

from sopht_mpi_tpu_torch import models, ops, utils

__version__ = "0.1.0"


def enable_fast_spectral(enable: bool | None = True) -> None:
    """Set the construction-time default of the Poisson solvers'
    ``fast_spectral`` mode: the velocity recovery through the fused-curl
    route (the curl mixed into the Poisson z pass, the ring, free stream
    and ``max |u|_1`` into its last pass; plain FP32 arithmetic, so the
    exact tier's solve error). ``None`` restores the unset default, which
    resolves to False.

    Only solvers (and simulators) built after the call read it: built ones
    keep their mode, and solvers of both modes coexist. Per solver, pass
    ``fast_spectral=`` to ``UnboundedPoissonSolver3D`` or
    ``UnboundedFlowSimulator3D`` instead.
    """
    from sopht_mpi_tpu_torch.ops import poisson

    poisson.DEFAULT_FAST_SPECTRAL = None if enable is None else bool(enable)
