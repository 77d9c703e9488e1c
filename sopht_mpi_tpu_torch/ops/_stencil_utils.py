"""Shared stencil machinery: axis slicing helpers, written as shifted
slices on whole tensors (counterpart of ``sopht_mpi_tpu/ops/_stencil_utils.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def axslice(a, lo, hi, axis: int):
    """a[..., lo:hi, ...] along ``axis`` (hi may be None or negative)."""
    n = a.shape[axis]
    if hi is None:
        hi = n
    elif hi < 0:
        hi = n + hi
    if lo < 0:
        lo = n + lo
    return a.narrow(axis, lo, hi - lo)


def pad_all(a, width: int, start_axis: int = 0):
    """Zero-pad all axes from ``start_axis`` on by ``width``."""
    pad = [width, width] * (a.ndim - start_axis)  # last axis first
    return F.pad(a, pad)


def laplacian_interior(field, ndim_offset: int = 0):
    """Discrete (undivided) Laplacian on the interior (shape shrinks by 2 on
    every grid axis). ``ndim_offset`` grid axes lead the array (e.g. a
    vector component axis)."""
    grid_axes = range(ndim_offset, field.ndim)
    center = field
    for ax in grid_axes:
        center = axslice(center, 1, -1, ax)
    out = -2.0 * len(grid_axes) * center
    for ax in grid_axes:
        plus = field
        minus = field
        for ax2 in grid_axes:
            if ax2 == ax:
                plus = axslice(plus, 2, None, ax2)
                minus = axslice(minus, 0, -2, ax2)
            else:
                plus = axslice(plus, 1, -1, ax2)
                minus = axslice(minus, 1, -1, ax2)
        out = out + plus + minus
    return out


def central_diff_interior(field, axis: int, ndim_offset: int = 0):
    """Undivided central difference f[i+1]-f[i-1] along ``axis``, restricted
    to the interior of every grid axis (shape shrinks by 2 on each)."""
    plus = field
    minus = field
    for ax in range(ndim_offset, field.ndim):
        if ax == axis:
            plus = axslice(plus, 2, None, ax)
            minus = axslice(minus, 0, -2, ax)
        else:
            plus = axslice(plus, 1, -1, ax)
            minus = axslice(minus, 1, -1, ax)
    return plus - minus
