"""Utilities: precision helpers."""

from sopht_mpi_tpu_torch.utils.types import get_real_t, get_test_tol
