"""Collectives between the shards of a mesh (the JAX package takes these
from ``jax.lax`` under ``shard_map``): one interface, and the in-process
backend, where a sharded tensor carries its shard axes leading
((p0, p1, *local), see :mod:`sopht_mpi_tpu_torch.parallel.mesh`) and a
collective is a roll, a permutation or a reduction over a shard axis.

Every collective adds one to its ``calls`` count, as the kernel wrappers
count their launches, so a run can pin the halo exchanges and transposes a
step makes.
"""

from __future__ import annotations

import torch

from sopht_mpi_tpu_torch.parallel.mesh import Mesh, apply_assembled


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
