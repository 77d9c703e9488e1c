"""Eulerian <-> Lagrangian grid transfer ops for the immersed boundary
method (counterpart of ``sopht_mpi_tpu/ops/ibm.py``, 2D and 3D).

Nearest-index and support computation, cosine / Peskin-2002 delta weights,
the gather interpolation E->L and the scatter-add spreading L->E, and the
separable-matmul (``*_mm``) form of both transfers. Marker arrays are
``(grid_dim, n)`` with components (x, y[, z]); grid axes are ([z,] y, x).

The einsums of the matmul form run in full float32: the simulator turns
TF32 off for CUDA matmuls (``torch.backends.cuda.matmul.allow_tf32``), as
the JAX package pins them to ``Precision.HIGHEST``.
"""

from __future__ import annotations

import math

import torch

INTERP_KERNEL_WIDTH = 2


def nearest_grid_index_and_support(
    lag_positions, dx, eul_grid_coord_shift, interp_kernel_width=INTERP_KERNEL_WIDTH
):
    """Nearest Eulerian index and support-point displacements per marker:
    ``idx = floor((pos - shift) / dx)``, support ``idx + (-w+1 .. w)``,
    displacements = support position - marker position.

    :returns: (nearest (grid_dim, n) int32, support_idx (grid_dim, 2w, n)
        int32, support_disp (grid_dim, 2w, n) in the positions' dtype).
    """
    w = interp_kernel_width
    nearest = torch.floor((lag_positions - eul_grid_coord_shift) / dx).to(
        torch.int32
    )
    offsets = torch.arange(
        -w + 1, w + 1, dtype=torch.int32, device=lag_positions.device
    )
    support_idx = nearest[:, None, :] + offsets[None, :, None]
    support_disp = (
        support_idx.to(lag_positions.dtype) * dx
        + eul_grid_coord_shift
        - lag_positions[:, None, :]
    )
    return nearest, support_idx, support_disp


def cosine_delta_weights_1d(support_disp, dx):
    """Per-axis cosine delta factors ``(0.25/dx) (1 + cos(pi/2 d/dx))``."""
    r = support_disp / dx
    return (0.25 / dx) * (1.0 + torch.cos(0.5 * math.pi * r))


def peskin_delta_weights_1d(support_disp, dx):
    """Per-axis Peskin (2002, eq. 6.27) 4-point delta factors."""
    r = torch.abs(support_disp) / dx
    inner = (0.125 / dx) * (
        3.0 - 2.0 * r + torch.sqrt(torch.abs(1.0 + 4.0 * r - 4.0 * r**2))
    )
    outer = (0.125 / dx) * (
        5.0 - 2.0 * r - torch.sqrt(torch.abs(-7.0 + 12.0 * r - 4.0 * r**2))
    )
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return torch.where(r < 1.0, inner, torch.where(r < 2.0, outer, zero))


_DELTA_KERNELS = {
    "cosine": cosine_delta_weights_1d,
    "peskin": peskin_delta_weights_1d,
}


def interpolation_weights(support_disp, dx, kind="cosine"):
    """Full tensor-product weights from (grid_dim, 2w, n) displacements:
    (2w, 2w, n) in 2D, offsets ordered [y, x]; (2w, 2w, 2w, n) in 3D,
    [z, y, x]."""
    d1 = _DELTA_KERNELS[kind](support_disp, dx)
    if support_disp.shape[0] == 2:
        return d1[1][:, None, :] * d1[0][None, :, :]
    return (
        d1[2][:, None, None, :]
        * d1[1][None, :, None, :]
        * d1[0][None, None, :, :]
    )


def _support_gather_indices(support_idx, grid_shape):
    """Broadcast (2w, [2w,] 2w, n) index tensors, one per grid axis,
    selecting every support point of every marker, clipped to the grid."""
    s, n = support_idx.shape[1], support_idx.shape[2]
    if support_idx.shape[0] == 2:
        iy = support_idx[1][:, None, :].clamp(0, grid_shape[0] - 1)
        ix = support_idx[0][None, :, :].clamp(0, grid_shape[1] - 1)
        return tuple(i.long().expand((s, s, n)) for i in (iy, ix))
    shape = (s, s, s, n)
    iz = support_idx[2][:, None, None, :].clamp(0, grid_shape[0] - 1)
    iy = support_idx[1][None, :, None, :].clamp(0, grid_shape[1] - 1)
    ix = support_idx[0][None, None, :, :].clamp(0, grid_shape[2] - 1)
    return tuple(i.long().expand(shape) for i in (iz, iy, ix))


def axis_delta_weight_matrices(
    support_idx, support_disp, dx, window_shape, kind="cosine"
):
    """Per-grid-axis (n, W_axis) delta-factor matrices ((Az,) Ay, Ax) such
    that the full weight of marker m at window cell (z, y, x) is
    ``Az[m, z] * Ay[m, y] * Ax[m, x]``. Support indices are clipped to the
    window per axis, matching :func:`_support_gather_indices`."""
    grid_dim = support_idx.shape[0]
    d1 = _DELTA_KERNELS[kind](support_disp, dx)  # (grid_dim, 2w, n)
    mats = []
    for g in range(grid_dim):
        comp = grid_dim - 1 - g  # marker components ordered (x, y[, z])
        w_axis = int(window_shape[g])
        idx = support_idx[comp].long().clamp(0, w_axis - 1)  # (2w, n)
        oh = torch.nn.functional.one_hot(idx, w_axis).to(d1.dtype)
        mats.append(torch.einsum("sn,snw->nw", d1[comp], oh))
    return tuple(mats)


def eulerian_to_lagrangian_interpolation_mm(eul_grid_field, axis_mats, dx):
    """Separable-matmul E->L interpolation of a (c, [Wz,] Wy, Wx) field:
    ``lag_m = sum_zyx E[z,y,x] Az[m,z] Ay[m,y] Ax[m,x] dx^dim``; in 3D z
    and y contract through the combined (n, Wz*Wy) matrix."""
    grid_dim = len(axis_mats)
    vector = eul_grid_field.ndim == grid_dim + 1
    eul = eul_grid_field if vector else eul_grid_field[None]
    out_dtype = torch.promote_types(eul.dtype, axis_mats[0].dtype)
    eul = eul.to(out_dtype)
    mats = [m.to(out_dtype) for m in axis_mats]
    if grid_dim == 2:
        a_y, a_x = mats
        u = torch.einsum("ny,cyx->cnx", a_y, eul)
    else:
        a_z, a_y, a_x = mats
        n = a_z.shape[0]
        a_zy = (a_z[:, :, None] * a_y[:, None, :]).reshape(n, -1)
        u = torch.einsum(
            "ns,csx->cnx", a_zy, eul.reshape(eul.shape[0], -1, eul.shape[-1])
        )
    lag = torch.einsum("cnx,nx->cn", u, a_x) * dx**grid_dim
    return lag if vector else lag[0]


def lagrangian_to_eulerian_spread_mm(eul_grid_field, lag_grid_field, axis_mats):
    """Separable-matmul L->E spreading (adjoint of the mm interpolation):
    ``E[z,y,x] += sum_m lag_m Az[m,z] Ay[m,y] Ax[m,x]``."""
    vector = lag_grid_field.ndim == 2
    lag = lag_grid_field if vector else lag_grid_field[None]
    lag = lag.to(eul_grid_field.dtype)
    mats = [m.to(eul_grid_field.dtype) for m in axis_mats]
    g = lag[:, :, None] * mats[-1][None]  # (c, n, Wx)
    if len(mats) == 2:
        add = torch.einsum("ny,cnx->cyx", mats[0], g)
    else:
        a_z, a_y, a_x = mats
        n = a_z.shape[0]
        a_zy = (a_z[:, :, None] * a_y[:, None, :]).reshape(n, -1)
        add = torch.einsum("ns,cnx->csx", a_zy, g).reshape(
            lag.shape[0], a_z.shape[1], a_y.shape[1], a_x.shape[1]
        )
    return eul_grid_field + (add if vector else add[0])


def eulerian_to_lagrangian_interpolation(
    eul_grid_field, interp_weights, support_idx, dx
):
    """Gather interpolation ``lag_i = sum_support eul * w * dx^dim`` of a
    scalar ([nz,] ny, nx) or vector (c, [nz,] ny, nx) field; returns (n,)
    or (c, n)."""
    grid_dim = support_idx.shape[0]
    vector = eul_grid_field.ndim == grid_dim + 1
    grid_shape = eul_grid_field.shape[1:] if vector else eul_grid_field.shape
    idx = _support_gather_indices(support_idx, grid_shape)
    scale = dx**grid_dim
    if vector:
        gathered = eul_grid_field[(slice(None), *idx)]
        return (gathered * interp_weights[None]).sum(
            dim=tuple(range(1, grid_dim + 1))) * scale
    gathered = eul_grid_field[idx]
    return (gathered * interp_weights).sum(dim=tuple(range(grid_dim))) * scale


def lagrangian_to_eulerian_spread(
    eul_grid_field, lag_grid_field, interp_weights, support_idx
):
    """Scatter-add spreading ``eul[support] += lag * w``; returns the
    updated field (the input is not modified)."""
    vector = lag_grid_field.ndim == 2
    grid_shape = eul_grid_field.shape[1:] if vector else eul_grid_field.shape
    idx = _support_gather_indices(support_idx, grid_shape)
    lag_grid_field = lag_grid_field.to(eul_grid_field.dtype)
    interp_weights = interp_weights.to(eul_grid_field.dtype)
    out = eul_grid_field.clone()
    if vector:
        n_comp = lag_grid_field.shape[0]
        lead = (n_comp,) + (1,) * (interp_weights.ndim - 1)
        updates = interp_weights[None] * lag_grid_field.reshape(*lead, -1)
        comp = torch.arange(n_comp, device=out.device).reshape(*lead, 1)
        bidx = (comp.expand(updates.shape),) + tuple(
            i[None].expand(updates.shape) for i in idx
        )
        return out.index_put_(bidx, updates, accumulate=True)
    return out.index_put_(idx, interp_weights * lag_grid_field, accumulate=True)
