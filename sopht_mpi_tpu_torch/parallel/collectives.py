"""Collectives between the shards of a mesh (the JAX package takes these
from ``jax.lax`` under ``shard_map``): one interface and two backends. A
sharded tensor carries its shard axes leading ((p0, p1, *local), see
:mod:`sopht_mpi_tpu_torch.parallel.mesh`).

- In-process mesh: a collective is a roll, a permutation or a reduction
  over a shard axis.
- Distributed mesh (one shard a process, leading axes (1, 1)): a
  collective goes through ``torch.distributed`` on the process group of
  its mesh axis (:mod:`sopht_mpi_tpu_torch.parallel.transport`, which
  stages device tensors through the host for a gloo group and counts the
  bytes). ``ppermute`` is a ``batch_isend_irecv`` in the axis ring,
  ``all_to_all`` an ``all_to_all_single`` of the same chunks in the same
  order, ``pmax`` an all-reduce, and ``psum`` an all-gather followed by the
  in-process sum over the gathered shards, so every rank and the in-process
  mesh add in one order and get the same bits.

Every collective adds one to its ``calls`` count, as the kernel wrappers
count their launches, so a run can pin the halo exchanges and transposes a
step makes; the two backends count alike.

:func:`halo_apply_2d` runs a single-device 2D stencil op on a 2D mesh's
sharded fields: the ops the JAX package leaves to its SPMD partitioner
there, which it serves with halo exchanges of its own.
"""

from __future__ import annotations

import torch

from sopht_mpi_tpu_torch.parallel import transport
from sopht_mpi_tpu_torch.parallel.mesh import (
    MESH_AXES_2D,
    Mesh,
    apply_assembled,
    gather_blocks,
    refuse_distributed,
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
    if not mesh.distributed:
        return torch.roll(x, shift, dims=_axis_dims(mesh, axis)[0])
    p = mesh.shape[axis]
    if shift % p == 0:
        return x.clone()
    ranks = mesh.axis_ranks[axis]
    i = mesh.coords[mesh.axis_names.index(axis)]
    return transport.send_recv(x, mesh.groups[axis], ranks[(i + shift) % p],
                               ranks[(i - shift) % p])


def all_to_all(x, mesh: Mesh, axis: str, split_axis: int, concat_axis: int):
    """``lax.all_to_all(..., tiled=True)`` along mesh axis ``axis``: every
    shard cuts its local block into ``p`` chunks along the local
    ``split_axis`` and sends chunk ``j`` to shard ``j``, which concatenates
    what it receives along the local ``concat_axis`` in sender order."""
    all_to_all.calls += 1
    d = _axis_dims(mesh, axis)[0]
    p = mesh.shape[axis]
    nd_local = x.ndim - 2
    sa = 2 + split_axis % nd_local
    ca = 2 + concat_axis % nd_local
    if x.shape[sa] % p:
        raise ValueError(
            f"all_to_all: local axis {split_axis} of size {x.shape[sa]} does "
            f"not split over {p} shards")
    shape = list(x.shape)
    out = list(shape)
    out[sa] //= p
    out[ca] *= p
    if mesh.distributed:
        if p == 1:
            return x.clone()
        # (j, ..., n/p, ...): chunk j goes to the shard at coordinate j
        block = x[0, 0]
        chunks = block.reshape(*shape[2:sa], p, shape[sa] // p,
                               *shape[sa + 1:]).movedim(sa - 2, 0)
        got = transport.all_to_all_rows(chunks, mesh.groups[axis])
        return torch.cat(got.unbind(0), dim=ca - 2).reshape(out)
    # (.., j, n/p, ..): the chunk index j becomes the receiving shard
    y = x.reshape(*shape[:sa], p, shape[sa] // p, *shape[sa + 1:])
    if ca >= sa:
        ca += 1
    y = y.transpose(d, sa)  # dim d: receiver j; dim sa: sender i
    # the sender index goes right in front of the concat axis
    y = y.movedim(sa, ca - 1 if ca > sa else ca)
    return y.reshape(out)


def _reduce_group(mesh: Mesh, dims):
    """The process group of the mesh axes ``dims``: the world for all of
    them, else the one axis's group."""
    if len(dims) == len(mesh.axis_names):
        return mesh.group, mesh.size
    axis = mesh.axis_names[dims[0]]
    return mesh.groups.get(axis), mesh.shape[axis]


def pmax(x, mesh: Mesh, axes=None):
    """The maximum over the shards along ``axes`` (default: all mesh axes)
    of the per-shard values ``x`` (p0, p1, ...); the reduced shard axes
    drop out, so a full reduction of per-shard scalars is a 0-d tensor."""
    pmax.calls += 1
    dims = _axis_dims(mesh, axes)
    local = torch.amax(x, dim=dims)
    group, n = _reduce_group(mesh, dims) if mesh.distributed else (None, 1)
    if n == 1:
        return local
    return transport.all_reduce_max(local, group)


def psum(x, mesh: Mesh, axes=None):
    """The sum over the shards along ``axes``, as :func:`pmax`. On a
    distributed mesh each rank gathers the shards' values and sums them as
    the in-process backend does."""
    psum.calls += 1
    dims = _axis_dims(mesh, axes)
    if mesh.distributed and mesh.size > 1:
        group, n = _reduce_group(mesh, dims)
        if len(dims) == len(mesh.axis_names):
            x = transport.all_gather_rows(x[0, 0], group, n).reshape(
                *mesh.axis_sizes, *x.shape[2:])
        elif n > 1:
            rows = transport.all_gather_rows(x.select(dims[0], 0), group, n)
            x = rows.movedim(0, dims[0])
    return torch.sum(x, dim=dims)


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
    refuse_distributed(mesh, "halo_apply_2d")
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
    """Zero every collective's ``calls``, the distributed mesh's block
    gathers and the bytes staged through the host."""
    for fn in COLLECTIVES:
        fn.calls = 0
    gather_blocks.calls = 0
    transport.stage.bytes = 0


def counts() -> dict:
    return {fn.__name__: fn.calls for fn in COLLECTIVES}


def transfer_counts() -> dict:
    """What a distributed mesh moves besides the collectives: the block
    gathers of its ``unshard_*`` calls (``gathers``) and the bytes staged
    between the device and the host for gloo groups (``staged_bytes``);
    both zero in-process."""
    return {"gathers": gather_blocks.calls,
            "staged_bytes": transport.stage.bytes}
