"""Elementwise field ops (counterpart of ``sopht_mpi_tpu/ops/elementwise.py``)."""

from __future__ import annotations

import torch


def set_fixed_val(field, fixed_val):
    """A field of ``field``'s shape, dtype and device filled with
    ``fixed_val``."""
    return torch.full_like(field, fixed_val)


def add_fixed_val(field, fixed_vals):
    """Add per-component constants to a vector field (free-stream
    velocity). ``fixed_vals`` is a (c,) tensor on the field's device, or a
    sequence of numbers."""
    if not torch.is_tensor(fixed_vals):
        fixed_vals = torch.tensor(fixed_vals, dtype=field.dtype)
    vals = fixed_vals.to(dtype=field.dtype, device=field.device)
    return field + vals.reshape((-1,) + (1,) * (field.ndim - 1))


def saxpby(field_1, field_1_prefac, field_2, field_2_prefac):
    """``field_1_prefac * field_1 + field_2_prefac * field_2``."""
    return field_1_prefac * field_1 + field_2_prefac * field_2


def cross_product_3d(field_1, field_2):
    """Elementwise cross product of two (3, nz, ny, nx) vector fields,
    components ordered (x, y, z)."""
    x1, y1, z1 = field_1[0], field_1[1], field_1[2]
    x2, y2, z2 = field_2[0], field_2[1], field_2[2]
    return torch.stack(
        [y1 * z2 - z1 * y2, z1 * x2 - x1 * z2, x1 * y2 - y1 * x2]
    )
