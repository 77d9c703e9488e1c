"""Shared stencil machinery: axis slicing helpers and the ENO3 face flux,
written as shifted slices on whole tensors (counterpart of
``sopht_mpi_tpu/ops/_stencil_utils.py``).
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


def pad_axis(a, lo: int, hi: int, axis: int):
    """Zero-pad ``a`` along ``axis`` by (lo, hi)."""
    pad = [0, 0] * (a.ndim - 1 - axis % a.ndim) + [lo, hi]  # last axis first
    return F.pad(a, pad)


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


def _eno3_left_biased(gm2, gm1, g0, gp1, gp2):
    """Left-biased (positive-wind) 3rd-order ENO face value at i+1/2:
    start from cell i, extend to the side with the smaller undivided
    difference, then take the reconstruction of the chosen 3-cell stencil
    (Shu 1997)."""
    sixth = 1.0 / 6.0
    d1l = g0 - gm1
    d1r = gp1 - g0
    d2a = g0 - 2.0 * gm1 + gm2  # stencil {i-2, i-1, i}
    d2b = gp1 - 2.0 * g0 + gm1  # stencil {i-1, i, i+1}
    d2c = gp2 - 2.0 * gp1 + g0  # stencil {i, i+1, i+2}
    f_r2 = sixth * (2.0 * gm2 - 7.0 * gm1 + 11.0 * g0)
    f_r1 = sixth * (-gm1 + 5.0 * g0 + 2.0 * gp1)
    f_r0 = sixth * (2.0 * g0 + 5.0 * gp1 - gp2)
    take_left = d1l.abs() < d1r.abs()
    left_branch = torch.where(d2a.abs() < d2b.abs(), f_r2, f_r1)
    right_branch = torch.where(d2b.abs() < d2c.abs(), f_r1, f_r0)
    return torch.where(take_left, left_branch, right_branch)


def eno3_divergence_interior(field, velocity_axis_component, axis: int):
    """Per-cell conservative ENO3 flux divergence along one axis:
    ``F_{i+1/2} - F_{i-1/2}`` (undivided), same shape as ``field``.

    Face fluxes use the 3rd-order ENO reconstruction of the cell flux
    ``g = u * q``, upwinded by the face velocity ``0.5 (u_i + u_{i+1})``.
    The domain is zero-padded at the walls."""
    u = velocity_axis_component
    g = pad_axis(field * u, 3, 3, axis)
    up = pad_axis(u, 3, 3, axis)
    n = field.shape[axis]

    # faces j+1/2 for padded j in [2, n+2] (n+1 faces bracketing real cells)
    def cell(off):  # g at padded index (j + off) for j in [2, n+2]
        return axslice(g, 2 + off, 2 + off + n + 1, axis)

    u_face = 0.5 * (
        axslice(up, 2, 2 + n + 1, axis) + axslice(up, 3, 3 + n + 1, axis)
    )
    f_pos = _eno3_left_biased(cell(-2), cell(-1), cell(0), cell(1), cell(2))
    f_neg = _eno3_left_biased(cell(3), cell(2), cell(1), cell(0), cell(-1))
    f_face = torch.where(u_face >= 0.0, f_pos, f_neg)
    return axslice(f_face, 1, None, axis) - axslice(f_face, 0, -1, axis)
