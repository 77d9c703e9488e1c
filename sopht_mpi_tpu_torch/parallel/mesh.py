"""The (pz, py) mesh of shards and the sharded-field layout (counterpart of
``sopht_mpi_tpu/parallel/mesh.py``).

The mesh is in-process: every shard of a mesh lives on the mesh's one
device, as the JAX package's tests run eight virtual devices in one
process. The collectives of
:mod:`sopht_mpi_tpu_torch.parallel.collectives` move data between shards.

Conventions, as in the JAX package:

- 2D scalar fields (ny, nx), mesh axes ("y", "x"); 3D scalar fields
  (nz, ny, nx), mesh axes ("z", "y") (x always stays local);
- vector fields carry a leading component axis that is never sharded.

A sharded field is ONE tensor with the two shard axes leading: a 3D vector
field (3, nz, ny, nx) on a (pz, py) mesh is (pz, py, 3, nz/pz, ny/py, nx),
contiguous, so shard (i, j) is the contiguous block ``field[i, j]`` with
storage of its own: no shard's block holds a neighbour's cell, and what a
shard needs of its neighbours it gets from a halo exchange. The JAX
package's sharding objects (``grid_partition_spec``, the ``*_sharding``
helpers, ``replicated_sharding``) have no counterpart: the layout above is
the only one.
"""

from __future__ import annotations

import math

import torch

MESH_AXES_2D = ("y", "x")
MESH_AXES_3D = ("z", "y")


def mesh_axis_names(grid_dim: int) -> tuple[str, ...]:
    if grid_dim == 2:
        return MESH_AXES_2D
    elif grid_dim == 3:
        return MESH_AXES_3D
    raise ValueError(f"Invalid grid dim {grid_dim}")


class Mesh:
    """An in-process mesh of shards on one device.

    ``shape`` maps each axis name to its number of shards (in
    ``axis_names`` order), ``size`` is their product."""

    def __init__(self, mesh_shape, axis_names, device):
        if len(mesh_shape) != len(axis_names):
            raise ValueError(
                f"mesh_shape {tuple(mesh_shape)} does not name one size for "
                f"each of the axes {tuple(axis_names)}"
            )
        if any(int(n) < 1 for n in mesh_shape):
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} is not positive")
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(axis_names, mesh_shape)}
        self.device = torch.device(device)

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def grid_dim(self) -> int:
        return 2 if self.axis_names == MESH_AXES_2D else 3

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def create_mesh(grid_dim: int, mesh_shape=None, *, device) -> Mesh:
    """A mesh for a ``grid_dim``-dimensional flow domain.

    :param mesh_shape: shards per mesh axis, (pz, py) in 3D: a slab
        ``(n, 1)`` or a pencil ``(pz, py)``. None is the single shard.
    :param device: the one torch device every shard lives on.
    """
    axes = mesh_axis_names(grid_dim)
    if mesh_shape is None:
        mesh_shape = (1,) * len(axes)
    return Mesh(tuple(mesh_shape), axes, device)


def check_grid_divisibility(grid_size, mesh: Mesh) -> None:
    """Ensure the grid divides evenly over the mesh."""
    for size, axis in zip(grid_size, mesh.axis_names):
        n = mesh.shape[axis]
        if size % n != 0:
            raise RuntimeError(
                f"Grid axis of size {size} not divisible by {n} devices on "
                f"mesh axis '{axis}'"
            )


def shard_dims(x, mesh: Mesh, dims):
    """Cut the global tensor ``x`` along ``dims`` (one array axis for each
    mesh axis, in ``mesh.axis_names`` order) into the sharded layout
    (p0, p1, *local), contiguous."""
    sizes = mesh.axis_sizes
    shape, lead = [], [0, 0]
    for d, n in enumerate(x.shape):
        if d in dims:
            p = sizes[dims.index(d)]
            if n % p:
                raise RuntimeError(
                    f"axis {d} of size {n} is not divisible by {p} shards")
            lead[dims.index(d)] = len(shape)
            shape += [p, n // p]
        else:
            shape.append(n)
    rest = [d for d in range(len(shape)) if d not in lead]
    out = x.reshape(shape).permute(*lead, *rest)
    # a copy even where the permutation is trivial: the shards own their
    # storage
    return out.clone(memory_format=torch.contiguous_format)


def unshard_dims(x, mesh: Mesh, dims):
    """Inverse of :func:`shard_dims`: the global tensor of a sharded one."""
    local = list(x.shape[2:])
    order, shape = [], []
    for d, n in enumerate(local):
        if d in dims:
            k = dims.index(d)
            order.append(k)
            shape.append(x.shape[k] * n)
        else:
            shape.append(n)
        order.append(2 + d)
    return x.permute(*order).reshape(shape)


def _grid_dims(mesh: Mesh, offset: int):
    return tuple(range(offset, offset + len(mesh.axis_names)))


def shard_scalar_field(field, mesh: Mesh | None):
    """(nz, ny, nx) -> (pz, py, nz/pz, ny/py, nx); the field itself without
    a mesh."""
    if mesh is None:
        return field
    return shard_dims(field, mesh, _grid_dims(mesh, 0))


def shard_vector_field(field, mesh: Mesh | None):
    """(3, nz, ny, nx) -> (pz, py, 3, nz/pz, ny/py, nx); the field itself
    without a mesh."""
    if mesh is None:
        return field
    return shard_dims(field, mesh, _grid_dims(mesh, 1))


def unshard_scalar_field(field, mesh: Mesh | None):
    if mesh is None:
        return field
    return unshard_dims(field, mesh, _grid_dims(mesh, 0))


def unshard_vector_field(field, mesh: Mesh | None):
    if mesh is None:
        return field
    return unshard_dims(field, mesh, _grid_dims(mesh, 1))


def _is_vector(field, mesh: Mesh, sharded: bool) -> bool:
    """A vector field carries one axis more than the mesh's grid; a
    sharded field leads with one axis for each of the mesh's axes."""
    return field.ndim == (mesh.grid_dim + 1
                          + (len(mesh.axis_names) if sharded else 0))


def _reshard(out, mesh: Mesh):
    if out is None:
        return None
    if _is_vector(out, mesh, False):
        return shard_vector_field(out, mesh)
    return shard_scalar_field(out, mesh)


def on_assembled(fn, mesh: Mesh, *fields, aux: bool = False):
    """``fn`` of the assembled (global) fields, scalar or vector, sharded
    again, uncounted: for plain versions and tests. ``fn`` gets contiguous
    fields (on one-plane or one-row shards the assembled field is a strided
    view), as the single-device kernels need. With ``aux`` ``fn`` returns
    ``(field or None, other)``: the field is sharded again, ``other`` (the
    marker arrays of an IBM interaction) returned as it is."""
    out = fn(*(
        (unshard_vector_field if _is_vector(f, mesh, True)
         else unshard_scalar_field)(f, mesh).contiguous()
        for f in fields))
    if aux:
        out, other = out
        return _reshard(out, mesh), other
    return _reshard(out, mesh)


def apply_assembled(fn, mesh: Mesh, *fields, aux: bool = False):
    """:func:`on_assembled` on a path of the port: for the ops the JAX
    package leaves to its SPMD partitioner under a mesh (the Laplacian
    filter, the wall sponge outside the fused kernel, the forcing update,
    the passive transport, the dense IBM interpolation and spreading),
    which have no sharded kernel. It gathers every shard, so it counts its
    calls like a collective (``apply_assembled.calls``); the four ops that
    have a sharded kernel never come here."""
    apply_assembled.calls += 1
    return on_assembled(fn, mesh, *fields, aux=aux)


apply_assembled.calls = 0
