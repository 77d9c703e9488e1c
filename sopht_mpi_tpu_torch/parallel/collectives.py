"""Collectives between the shards of a mesh (the JAX package takes these
from ``jax.lax`` under ``shard_map``): one interface, and the in-process
backend, where a sharded tensor carries its shard axes leading
((p0, p1, *local), see :mod:`sopht_mpi_tpu_torch.parallel.mesh`) and a
collective is a roll, a permutation or a reduction over a shard axis.

Every collective adds one to its ``calls`` count, as the kernel wrappers
count their launches, so a run can pin the halo exchanges and transposes a
step makes.

:func:`halo_apply_2d` runs a single-device 2D stencil op on a 2D mesh's
sharded fields: the ops the JAX package leaves to its SPMD partitioner
there, which it serves with halo exchanges of its own.
"""

from __future__ import annotations

import torch

from sopht_mpi_tpu_torch.parallel.mesh import (
    MESH_AXES_2D,
    Mesh,
    apply_assembled,
)


def _axis_dims(mesh: Mesh, axes):
    if axes is None:
        axes = mesh.axis_names
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(mesh.axis_names.index(a) for a in axes)


def ppermute(x, mesh: Mesh, axis: str, shift: int):
    """Shard ``i`` along ``axis`` sends its block to shard
    ``(i + shift) % p`` (``lax.ppermute`` with the cyclic permutation
    ``[(i, (i + shift) % p)]``)."""
    ppermute.calls += 1
    return torch.roll(x, shift, dims=_axis_dims(mesh, axis)[0])


def all_to_all(x, mesh: Mesh, axis: str, split_axis: int, concat_axis: int):
    """``lax.all_to_all(..., tiled=True)`` along mesh axis ``axis``: every
    shard cuts its local block into ``p`` chunks along the local
    ``split_axis`` and sends chunk ``j`` to shard ``j``, which concatenates
    what it receives along the local ``concat_axis`` in sender order."""
    all_to_all.calls += 1
    d = _axis_dims(mesh, axis)[0]
    p = x.shape[d]
    nd_local = x.ndim - 2
    sa = 2 + split_axis % nd_local
    ca = 2 + concat_axis % nd_local
    if x.shape[sa] % p:
        raise ValueError(
            f"all_to_all: local axis {split_axis} of size {x.shape[sa]} does "
            f"not split over {p} shards")
    shape = list(x.shape)
    # (.., j, n/p, ..): the chunk index j becomes the receiving shard
    y = x.reshape(*shape[:sa], p, shape[sa] // p, *shape[sa + 1:])
    if ca >= sa:
        ca += 1
    y = y.transpose(d, sa)  # dim d: receiver j; dim sa: sender i
    # the sender index goes right in front of the concat axis
    y = y.movedim(sa, ca - 1 if ca > sa else ca)
    out = list(shape)
    out[sa] //= p
    out[2 + concat_axis % nd_local] *= p
    return y.reshape(out)


def pmax(x, mesh: Mesh, axes=None):
    """The maximum over the shards along ``axes`` (default: all mesh axes)
    of the per-shard values ``x`` (p0, p1, ...); the reduced shard axes
    drop out, so a full reduction of per-shard scalars is a 0-d tensor."""
    pmax.calls += 1
    return torch.amax(x, dim=_axis_dims(mesh, axes))


def psum(x, mesh: Mesh, axes=None):
    """The sum over the shards along ``axes``, as :func:`pmax`."""
    psum.calls += 1
    return torch.sum(x, dim=_axis_dims(mesh, axes))


def _ghost_axis(x, mesh: Mesh, axis: str, dim: int, width: int):
    """``x`` (p0, p1, c, ...) with ``width`` ghost cells on both sides of
    the local array axis ``dim``, along mesh axis ``axis``: the
    neighbours' edge cells through two counted :func:`ppermute`, zero
    beyond the physical walls; zeros alone where the axis has one shard."""
    p = mesh.shape[axis]
    if p == 1:
        pad = [0, 0] * (x.ndim - 1 - dim) + [width, width]
        return torch.nn.functional.pad(x, pad)
    shard_dim = mesh.axis_names.index(axis)
    # shard i receives the last rows of shard i - 1 and the first of i + 1
    lo = ppermute(x.narrow(dim, x.shape[dim] - width, width), mesh, axis, 1)
    hi = ppermute(x.narrow(dim, 0, width), mesh, axis, -1)
    lo.select(shard_dim, 0).zero_()
    hi.select(shard_dim, p - 1).zero_()
    return torch.cat([lo, x, hi], dim=dim)


def halo_apply_2d(fn, mesh: Mesh, *fields, width: int, band: int = 0):
    """``fn`` of the assembled 2D fields, computed shard by shard: the
    sharded ``fields`` (scalar (py, px, nyl, nxl) or vector (py, px, c,
    nyl, nxl)) get ghost cells ``width`` deep on every side (the
    neighbours' cells through :func:`ppermute` along "y" and, on a pencil,
    "x", the corners with them; zero beyond the physical walls), ``fn``
    (the single-device op, reading at most ``width`` cells away) runs on
    every ghosted block at once (``torch.vmap`` over the shards), the
    blocks are cropped to the shard, and the op's zero band ``band`` cells
    deep at the physical walls is set again on the shards that touch a
    wall (inside a block, the wall cells were computed as interior ones).

    Where a sharded axis is thinner than ``width`` (a neighbour's cells
    would not be enough) the op runs on the assembled fields instead
    (:func:`~sopht_mpi_tpu_torch.parallel.mesh.apply_assembled`, counted),
    as the JAX package's partitioner takes any shard size."""
    if mesh.axis_names != MESH_AXES_2D:
        raise ValueError("halo_apply_2d needs a mesh from create_mesh(2, ...)")
    nyl, nxl = fields[0].shape[-2:]
    py, px = mesh.axis_sizes
    if (py > 1 and nyl < width) or (px > 1 and nxl < width):
        return apply_assembled(fn, mesh, *fields)
    vector = [f.ndim == 5 for f in fields]
    # every field's components in one stack: one exchange for all of them
    stacked = torch.cat([f if v else f[:, :, None]
                         for f, v in zip(fields, vector)], dim=2)
    ghosted = _ghost_axis(stacked, mesh, "y", 3, width)
    ghosted = _ghost_axis(ghosted, mesh, "x", 4, width)
    blocks, at = [], 0
    for v, f in zip(vector, fields):
        c = f.shape[2] if v else 1
        b = ghosted[:, :, at:at + c]
        blocks.append((b if v else b[:, :, 0]).flatten(0, 1))
        at += c
    out = torch.vmap(fn)(*blocks)
    out = out.reshape(py, px, *out.shape[1:])
    out = out[..., width:width + nyl, width:width + nxl]
    if band:
        out = out.clone()
        out[0, :, ..., :band, :] = 0
        out[py - 1, :, ..., nyl - band:, :] = 0
        out[:, 0, ..., :, :band] = 0
        out[:, px - 1, ..., :, nxl - band:] = 0
    return out.contiguous()


#: everything that moves data between shards, for code that resets or reads
#: every count
COLLECTIVES = (ppermute, all_to_all, pmax, psum, apply_assembled)
for _fn in (ppermute, all_to_all, pmax, psum):
    _fn.calls = 0


def reset_counts():
    for fn in COLLECTIVES:
        fn.calls = 0


def counts() -> dict:
    return {fn.__name__: fn.calls for fn in COLLECTIVES}
