"""The (py, px) and (pz, py) meshes of shards and the sharded-field layout
(counterpart of ``sopht_mpi_tpu/parallel/mesh.py``).

A mesh has one of two backends:

- in-process (:class:`Mesh`): every shard of the mesh lives on the mesh's
  one device, as the JAX package's tests run eight virtual devices in one
  process;
- distributed (:class:`DistributedMesh`, ``create_mesh(...,
  distributed=True)`` after
  :func:`~sopht_mpi_tpu_torch.parallel.distributed.initialize_distributed`):
  one shard a process of a ``torch.distributed`` world, shard (i, j) on
  rank ``i p1 + j``, as the JAX package's mesh spans the processes of
  ``jax.distributed``.

The collectives of :mod:`sopht_mpi_tpu_torch.parallel.collectives` move
data between shards, in the process or through ``torch.distributed``.

Conventions, as in the JAX package:

- 2D scalar fields (ny, nx), mesh axes ("y", "x"); 3D scalar fields
  (nz, ny, nx), mesh axes ("z", "y") (x always stays local);
- vector fields carry a leading component axis that is never sharded.

A sharded field is ONE tensor with the two shard axes leading: a 3D vector
field (3, nz, ny, nx) on a (pz, py) mesh is (pz, py, 3, nz/pz, ny/py, nx),
and a 2D one (2, ny, nx) on a (py, px) mesh (py, px, 2, ny/py, nx/px),
contiguous, so shard (i, j) is the contiguous block ``field[i, j]`` with
storage of its own: no shard's block holds a neighbour's cell, and what a
shard needs of its neighbours it gets from a halo exchange. On a
distributed mesh a process holds its own shard only, so its shard axes are
(1, 1): (1, 1, 3, nz/pz, ny/py, nx), its block the one at ``[i, j]`` of
the in-process layout. ``mesh.axis_sizes`` is always the GLOBAL shard
count of each axis, ``mesh.local_axis_sizes`` the leading axes a process
holds, and :meth:`Mesh.shard_starts` the global offsets of those shards.
The JAX package's sharding objects (``grid_partition_spec``, the
``*_sharding`` helpers, ``replicated_sharding``) have no counterpart: the
layout above is the only one.
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

    distributed = False

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
        """The global number of shards of each axis."""
        return tuple(self.shape[a] for a in self.axis_names)

    @property
    def local_axis_sizes(self) -> tuple[int, ...]:
        """The leading shard axes of a sharded field in this process."""
        return self.axis_sizes

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def grid_dim(self) -> int:
        return 2 if self.axis_names == MESH_AXES_2D else 3

    def first_shard(self, k: int) -> int:
        """The mesh coordinate along axis ``k`` of this process's first
        shard."""
        return 0

    def shard_starts(self, k: int, n_local: int, device=None):
        """(local shards along axis ``k``,) int64: the global index of the
        first cell of each shard this process holds along mesh axis ``k``,
        shards of ``n_local`` cells."""
        first = self.first_shard(k)
        return torch.arange(first, first + self.local_axis_sizes[k],
                            device=device) * n_local

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


class DistributedMesh(Mesh):
    """A mesh of one shard a process: shard (i, j) lives on rank
    ``i p1 + j`` of the default ``torch.distributed`` group, on that
    process's ``device``.

    ``coords`` is this rank's (i, j); ``groups`` maps each axis of more
    than one shard to the process group of the ranks that share this
    rank's other coordinate, and ``axis_ranks`` to their global ranks in
    mesh order (so group rank ``k`` is the shard at coordinate ``k``);
    ``group`` is the whole world."""

    distributed = True

    def __init__(self, mesh_shape, axis_names, device):
        import torch.distributed as dist

        super().__init__(mesh_shape, axis_names, device)
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "a distributed mesh needs torch.distributed initialised "
                "(parallel.distributed.initialize_distributed)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(
                f"mesh {tuple(mesh_shape)} has {self.size} shards, the "
                f"world {world} processes")
        p0, p1 = self.axis_sizes
        self.rank = dist.get_rank()
        self.coords = divmod(self.rank, p1)
        self.group = dist.group.WORLD
        self.groups, self.axis_ranks = {}, {}
        # every rank creates every group, in the same order
        lines = {
            0: [[i * p1 + j for i in range(p0)] for j in range(p1)],
            1: [[i * p1 + j for j in range(p1)] for i in range(p0)],
        }
        for k, axis in enumerate(self.axis_names):
            if self.axis_sizes[k] == 1:
                continue
            for ranks in lines[k]:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[axis], self.axis_ranks[axis] = group, ranks

    @property
    def local_axis_sizes(self) -> tuple[int, ...]:
        return (1,) * len(self.axis_names)

    def first_shard(self, k: int) -> int:
        return self.coords[k]

    def __repr__(self):
        return (f"DistributedMesh({self.shape}, rank {self.rank} at "
                f"{self.coords}, device={self.device})")


def create_mesh(grid_dim: int, mesh_shape=None, *, device,
                distributed: bool = False) -> Mesh:
    """A mesh for a ``grid_dim``-dimensional flow domain.

    :param mesh_shape: shards per mesh axis, (pz, py) in 3D, (py, px) in
        2D: a slab ``(n, 1)`` or a pencil. None is the single shard (the
        whole world's slab with ``distributed``).
    :param device: the torch device of the shards: every shard's on an
        in-process mesh, this process's shard's on a distributed one.
    :param distributed: one shard a process of the initialised
        ``torch.distributed`` world, whose size must be the mesh's
        (:class:`DistributedMesh`); every rank calls this with the same
        arguments.
    """
    axes = mesh_axis_names(grid_dim)
    if distributed:
        if mesh_shape is None:
            import torch.distributed as dist

            mesh_shape = (dist.get_world_size(),) + (1,) * (len(axes) - 1)
        return DistributedMesh(tuple(mesh_shape), axes, device)
    if mesh_shape is None:
        mesh_shape = (1,) * len(axes)
    return Mesh(tuple(mesh_shape), axes, device)


def is_distributed(mesh) -> bool:
    """Whether ``mesh`` is a distributed mesh of more than one shard."""
    return mesh is not None and mesh.distributed and mesh.size > 1


def refuse_distributed(mesh, what: str) -> None:
    """Raise where ``what`` is asked to run on a distributed mesh of more
    than one shard: only the 3D flow and the rigid-body FSI steps run
    there yet."""
    if is_distributed(mesh):
        raise ValueError(
            f"{what} does not run on a distributed mesh yet: the rod and "
            "multi-body steps and the 2D mesh take an in-process mesh "
            "(ROADMAP.md queue A #11e, the next slice)")


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
    (p0, p1, *local), contiguous; on a distributed mesh this process's
    block, (1, 1, *local)."""
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
    if mesh.distributed:
        i, j = mesh.coords
        out = out[i:i + 1, j:j + 1]
    # a copy even where the permutation is trivial: the shards own their
    # storage
    return out.clone(memory_format=torch.contiguous_format)


def gather_blocks(x, mesh: Mesh):
    """The sharded tensor ``x`` with every shard's block, (p0, p1, *local):
    ``x`` itself in-process; on a distributed mesh every rank's block
    through an all-gather, counted (``gather_blocks.calls``)."""
    if not mesh.distributed:
        return x
    from sopht_mpi_tpu_torch.parallel import transport

    gather_blocks.calls += 1
    blocks = transport.all_gather_rows(x[0, 0], mesh.group, mesh.size)
    return blocks.reshape(*mesh.axis_sizes, *x.shape[2:])


gather_blocks.calls = 0


def unshard_dims(x, mesh: Mesh, dims):
    """Inverse of :func:`shard_dims`: the global tensor of a sharded one
    (on a distributed mesh on every rank, :func:`gather_blocks`)."""
    x = gather_blocks(x, mesh)
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
    """(nz, ny, nx) -> (pz, py, nz/pz, ny/py, nx), (ny, nx) -> (py, px,
    ny/py, nx/px); the field itself without a mesh."""
    if mesh is None:
        return field
    return shard_dims(field, mesh, _grid_dims(mesh, 0))


def shard_vector_field(field, mesh: Mesh | None):
    """(3, nz, ny, nx) -> (pz, py, 3, nz/pz, ny/py, nx), (2, ny, nx) ->
    (py, px, 2, ny/py, nx/px); the field itself without a mesh."""
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
    again, uncounted: for plain versions and tests. On a distributed mesh
    every rank gathers the fields, runs ``fn`` on them and keeps its own
    block. ``fn`` gets contiguous
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
