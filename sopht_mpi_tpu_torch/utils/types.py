"""Precision utilities (counterpart of ``sopht_mpi_tpu/utils/types.py``).

float32 is the default flow precision; float64 is the double-precision
test tier. ``get_test_tol("single")`` also enters the CFL timestep
(``models/fsi.py:_flow_dt_fn``), so its value is reproduced exactly.
"""

import numpy as np
import torch


def get_real_t(precision: str = "single") -> torch.dtype:
    """Return the floating dtype for a named precision level."""
    if precision == "single":
        return torch.float32
    elif precision == "double":
        return torch.float64
    raise ValueError(f"Invalid precision: {precision}")


def get_test_tol(precision: str = "single") -> float:
    """Testing tolerance matching the reference's numerical parity contract."""
    if precision == "single":
        return float(1e3 * np.finfo(np.float32).eps)
    elif precision == "double":
        return float(1e6 * np.finfo(np.float64).eps)
    raise ValueError(f"Invalid precision: {precision}")


def get_dtype_eps(real_t) -> float:
    """Machine epsilon of a torch or a numpy floating dtype."""
    if isinstance(real_t, torch.dtype):
        return float(torch.finfo(real_t).eps)
    return float(np.finfo(np.dtype(real_t)).eps)
