"""Moving-window primitives of the sparse IBM forcing path on a mesh
(counterpart of ``sopht_mpi_tpu/parallel/windows.py``).

The sparse-window FSI steps (:mod:`sopht_mpi_tpu_torch.models.fsi`) do all
marker math on a small ``(3, Wz, Wy, Wx)`` window that tracks the body's
support. On a mesh that window work is replicated, as in the JAX package
(every shard would hold the same markers), and only two touches of the
sharded grid remain, provided here on the in-process layout of
:mod:`sopht_mpi_tpu_torch.parallel.mesh` (a sharded vector field is one
tensor (pz, py, c, nz/pz, ny/py, nx)):

- :func:`windowed_e2l_mm_sharded`: the separable-matmul E->L interpolation
  against the window, without forming it: each shard contracts its own
  masked overlap and one counted ``psum`` of the ``(c, n_markers)`` result
  sums the shards' parts;
- :func:`add_window_into_field`: add a replicated window into the sharded
  field, each shard adding its overlap; no collective;
- :func:`gather_window_replicated`: the window itself, each shard's masked
  overlap summed by one ``psum``.

Every shard is handled in the same batched tensor ops on the one sharded
tensor (no loop over shards), nothing assembles the field, and the window
start is a ``(3,)`` integer tensor on the device in marker component order
(x, y, z) that is never read on the host. For any start inside the domain
the results equal the meshless ``field[window]`` / ``index_put_`` pair of
:func:`sopht_mpi_tpu_torch.models.fsi._sparse_window_tools`, the E->L up
to the order of its sums. All three are differentiable.
"""

from __future__ import annotations

import torch

from sopht_mpi_tpu_torch.ops.ibm import eulerian_to_lagrangian_interpolation_mm
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import Mesh


def _window_rows(start, length: int, n: int):
    """The rows ``start + [0, length)`` of an axis of ``n`` rows, clamped
    into it, and whether each lies inside: two tensors of shape
    ``start.shape + (length,)``."""
    idx = start[..., None] + torch.arange(length, device=start.device)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def _masked_axis_gather(arr, axis: int, start, length: int):
    """``arr[start : start + length]`` along ``axis`` with the rows outside
    the axis ZERO (not clamped); ``start`` is a 0-d tensor and may lie out
    of range in either direction."""
    idx, valid = _window_rows(start.to(torch.int64), length, arr.shape[axis])
    out = torch.index_select(arr, axis, idx)
    mask_shape = [1] * out.ndim
    mask_shape[axis] = length
    return torch.where(valid.reshape(mask_shape), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _masked_rows_per_shard(mat, start, length: int):
    """:func:`_masked_axis_gather` of a replicated (n, W) matrix along its
    columns, one start a shard: ``start`` (p,) -> (p, n, length)."""
    idx, valid = _window_rows(start, length, mat.shape[1])
    out = mat[:, idx]  # (n, p, length)
    out = torch.where(valid[None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.permute(1, 0, 2)


def _shard_grid(field, mesh: Mesh):
    """(pz, py, nz/pz, ny/py, nx) of a sharded vector field, and the global
    z and y offset of each shard's first plane and row, (pz,) and (py,)."""
    pz, py = mesh.axis_sizes
    if field.ndim != 6 or tuple(field.shape[:2]) != (pz, py):
        raise ValueError(
            f"a sharded 3D vector field on a {pz} x {py} mesh is (pz, py, c, "
            f"nz/pz, ny/py, nx), got {tuple(field.shape)}")
    nzl, nyl, nx = field.shape[3:]
    ar = lambda p: torch.arange(p, device=field.device)  # noqa: E731
    return (pz, py, nzl, nyl, nx), ar(pz) * nzl, ar(py) * nyl


def _shard_index(pz: int, py: int, device):
    """Index tensors selecting shard (i, j) along the two leading axes,
    broadcast against three trailing grid axes."""
    i = torch.arange(pz, device=device).reshape(pz, 1, 1, 1, 1)
    j = torch.arange(py, device=device).reshape(1, py, 1, 1, 1)
    return i, j


def gather_window_replicated(field, start_xyz, wshape, mesh: Mesh):
    """``field[:, sz:sz+Wz, sy:sy+Wy, sx:sx+Wx]`` of a sharded 3D vector
    field as one replicated ``(c, Wz, Wy, Wx)`` tensor: each shard takes its
    masked overlap with the window and one ``psum`` over the mesh sums
    them. ``start_xyz``: the ``(3,)`` window start in marker component
    order (x, y, z), inside the domain (callers clip)."""
    wz, wy, wx = (int(w) for w in wshape)
    (pz, py, nzl, nyl, nx), z_off, y_off = _shard_grid(field, mesh)
    start = start_xyz.to(torch.int64)
    zi, zv = _window_rows(start[2] - z_off, wz, nzl)  # (pz, wz)
    yi, yv = _window_rows(start[1] - y_off, wy, nyl)  # (py, wy)
    xi, xv = _window_rows(start[0], wx, nx)  # (wx,)
    i, j = _shard_index(pz, py, field.device)
    part = field[i, j, :, zi.reshape(pz, 1, wz, 1, 1),
                 yi.reshape(1, py, 1, wy, 1), xi.reshape(1, 1, 1, 1, wx)]
    # (pz, py, wz, wy, wx, c): the advanced indices lead
    valid = (zv.reshape(pz, 1, wz, 1, 1) & yv.reshape(1, py, 1, wy, 1)
             & xv.reshape(1, 1, 1, 1, wx))
    part = torch.where(valid[..., None], part,
                       torch.zeros((), dtype=part.dtype, device=part.device))
    return collectives.psum(part.movedim(-1, 2), mesh)


def windowed_e2l_mm_sharded(field, axis_mats, start_xyz, wshape, dx,
                            mesh: Mesh):
    """Separable-matmul E->L interpolation against a (moving) window of a
    SHARDED 3D vector field without forming the window: each shard
    contracts a block of its own cells with the matching columns of the
    weight matrices, masked to the window, and ONE ``psum`` of the
    ``(c, n_markers)`` result sums the shards' parts.

    Each window cell lies in exactly one shard; a shard's block has the
    static length ``min(W, local)`` an axis and starts at its overlap's
    first row, clipped into the shard, so it covers the whole overlap, and
    its cells outside the window get zero weight. ``axis_mats`` are the
    (n, W_axis) window-coordinate matrices of
    :func:`~sopht_mpi_tpu_torch.ops.ibm.axis_delta_weight_matrices`
    (replicated); ``start_xyz`` the (x, y, z) window start. Matches
    ``eulerian_to_lagrangian_interpolation_mm`` of
    :mod:`sopht_mpi_tpu_torch.ops.ibm` on the window up to the order of
    the sums."""
    wz, wy, wx = (int(w) for w in wshape)
    (pz, py, nzl, nyl, nx), z_off, y_off = _shard_grid(field, mesh)
    c = field.shape[2]
    lz, ly, lx = min(wz, nzl), min(wy, nyl), min(wx, nx)
    start = start_xyz.to(torch.int64)
    # each shard's block start in its own coordinates: (pz,), (py,), ()
    sz = torch.clamp(torch.clamp(start[2] - z_off, min=0), max=nzl - lz)
    sy = torch.clamp(torch.clamp(start[1] - y_off, min=0), max=nyl - ly)
    sx = torch.clamp(torch.clamp(start[0], min=0), max=nx - lx)
    rz = torch.arange(lz, device=field.device)
    ry = torch.arange(ly, device=field.device)
    rx = torch.arange(lx, device=field.device)
    i, j = _shard_index(pz, py, field.device)
    block = field[i, j, :, (sz[:, None] + rz).reshape(pz, 1, lz, 1, 1),
                  (sy[:, None] + ry).reshape(1, py, 1, ly, 1),
                  (sx + rx).reshape(1, 1, 1, 1, lx)]  # (pz, py, lz, ly, lx, c)
    a_z, a_y, a_x = axis_mats
    out_dtype = torch.promote_types(field.dtype, a_z.dtype)
    azb = _masked_rows_per_shard(a_z, sz + z_off - start[2], lz)  # (pz, n, lz)
    ayb = _masked_rows_per_shard(a_y, sy + y_off - start[1], ly)  # (py, n, ly)
    axb = _masked_axis_gather(a_x, 1, sx - start[0], lx)  # (n, lx)
    n = a_z.shape[0]
    a_zy = (azb.to(out_dtype)[:, None, :, :, None]
            * ayb.to(out_dtype)[None, :, :, None, :]).reshape(
                pz, py, n, lz * ly)
    u = torch.einsum("pqns,pqsxc->pqcnx", a_zy,
                     block.to(out_dtype).reshape(pz, py, lz * ly, lx, c))
    part = torch.einsum("pqcnx,nx->pqcn", u, axb.to(out_dtype)) * dx**3
    return collectives.psum(part, mesh)


def add_window_into_field(field, window, start_xyz, mesh: Mesh):
    """A copy of the sharded 3D vector ``field`` with the replicated
    ``(c, Wz, Wy, Wx)`` ``window`` added at ``start_xyz`` ((x, y, z)
    component order). Each shard adds its overlap with the window: every
    window cell goes to the one shard that owns it, at its local index, in
    one batched indexed add; cells outside the domain add nothing. No
    collective."""
    (pz, py, nzl, nyl, nx), _, _ = _shard_grid(field, mesh)
    wz, wy, wx = window.shape[1:]
    start = start_xyz.to(torch.int64)
    gz, zv = _window_rows(start[2], wz, pz * nzl)
    gy, yv = _window_rows(start[1], wy, py * nyl)
    gx, xv = _window_rows(start[0], wx, nx)
    valid = (zv.reshape(wz, 1, 1) & yv.reshape(1, wy, 1)
             & xv.reshape(1, 1, wx))
    add = torch.where(valid, window.to(field.dtype),
                      torch.zeros((), dtype=field.dtype, device=field.device))
    comp = torch.arange(window.shape[0], device=field.device)
    idx = (comp.reshape(-1, 1, 1, 1), (gz // nzl).reshape(wz, 1, 1),
           (gy // nyl).reshape(1, wy, 1), (gz % nzl).reshape(wz, 1, 1),
           (gy % nyl).reshape(1, wy, 1), gx.reshape(1, 1, wx))
    out = field.clone()
    # (c, pz, py, ...) view of the copy, so every index is a tensor; the
    # clamped duplicates of cells outside the domain add zeros
    out.permute(2, 0, 1, 3, 4, 5).index_put_(
        tuple(torch.broadcast_to(k, add.shape) for k in idx), add,
        accumulate=True)
    return out
