"""Spectral passes of the doubled-domain Poisson solve: Hopper kernels and
their plain ``torch.fft`` versions (counterpart of
``sopht_mpi_tpu/parallel/pallas_fft.py``)."""

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
