"""The spectral passes of the doubled-domain Poisson solve (Hopper kernels
and their plain ``torch.fft`` versions, counterpart of
``sopht_mpi_tpu/parallel/pallas_fft.py``), the mesh and the multi-process
bootstrap (``create_mesh``, ``auto_mesh``, ``initialize_distributed``)."""

from sopht_mpi_tpu_torch.parallel.cuda_fft import (
    KERNELS,
    fft_greens_ifft_pass,
    fft_pass_padded,
    fused_edge_pass_ok,
    ifft_irfft_pass_fused,
    ifft_pass_truncated,
    irfft_pass_merge,
    irfft_pass_truncated,
    kernel_fft_supported,
    rfft_fft_pass_fused,
    rfft_pass_padded,
    rfft_pass_padded_split,
)
from sopht_mpi_tpu_torch.parallel.distributed import (
    auto_mesh,
    compute_mesh_dims,
    initialize_distributed,
)
from sopht_mpi_tpu_torch.parallel.mesh import create_mesh
