"""The multi-process bootstrap and the automatic factoring of a shard count
over the mesh axes (counterpart of ``sopht_mpi_tpu/parallel/
distributed.py``: ``initialize_distributed``, ``compute_mesh_dims`` and
``auto_mesh``).

:func:`initialize_distributed` starts ``torch.distributed`` (the JAX
package starts ``jax.distributed``); :func:`auto_mesh` factors the world,
or a given shard count, over the mesh axes. A driver calls both at its
top, identical on every process::

    initialize_distributed()      # no-op in a plain single-process run
    mesh = auto_mesh(3, grid_size)

and is launched with ``python -m torch.distributed.run --nproc-per-node N
driver.py``.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch

from sopht_mpi_tpu_torch.parallel.mesh import Mesh, create_mesh

#: the variables a launcher (``torch.distributed.run``) sets for each
#: process that announce a launched job (``MASTER_ADDR`` and
#: ``LOCAL_RANK`` alone do not: some cluster shells export them for every
#: job)
DIST_ENV_HINTS = ("RANK", "WORLD_SIZE")

#: how long a collective may wait for the other processes before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_state = {"device": None}


def _dist():
    import torch.distributed as dist

    return dist


def initialize_distributed(*, device=None, backend: str | None = None,
                           timeout: datetime.timedelta | None = None,
                           **kwargs) -> bool:
    """Start ``torch.distributed`` when the run is one of several
    processes; safe to call unconditionally at the top of a driver:

    - explicit ``kwargs`` (``init_method``, ``world_size``, ``rank``,
      ``store``: those of ``torch.distributed.init_process_group``) always
      initialise;
    - a launcher's environment (``RANK`` or ``WORLD_SIZE`` set, as
      ``torch.distributed.run`` sets them with ``MASTER_ADDR`` and
      ``LOCAL_RANK``) initialises from it (``init_method="env://"``);
    - otherwise nothing happens and the call returns False.

    Where explicit ``kwargs`` or a ``WORLD_SIZE`` above 1 fail to
    initialise, the error propagates: a run that carried on as a single
    process would compute another case. (The JAX package warns and carries
    on single-host there.) A launcher's world of one that fails to
    initialise warns and carries on as the single process it is.

    :param device: this process's device: ``cuda:LOCAL_RANK`` by default,
        ``"cpu"`` (or any device) where the caller asks for it;
        :func:`process_device` returns it afterwards.
    :param backend: ``"nccl"`` for a CUDA device and ``"gloo"`` for the CPU
        by default; the caller may name either.
    :param timeout: how long a collective waits for the other processes
        before it raises (:data:`DEFAULT_TIMEOUT`).

    Returns whether ``torch.distributed`` was (or already is) live; an
    initialised run given ``kwargs`` again raises ``RuntimeError``.
    """
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        if kwargs:
            raise RuntimeError(
                "torch.distributed is already initialized; the explicit "
                f"configuration {sorted(kwargs)} cannot be applied")
        if _state["device"] is None:
            _state["device"] = _default_device(device)
        return True
    announced = any(os.environ.get(k) is not None for k in DIST_ENV_HINTS)
    if not kwargs and not announced:
        return False
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "PyTorch build")
    dev = _default_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    explicit = bool(kwargs)
    if not explicit:
        kwargs = {"init_method": "env://"}
    try:
        dist.init_process_group(backend=backend,
                                timeout=timeout or DEFAULT_TIMEOUT, **kwargs)
    except (RuntimeError, ValueError) as err:
        if explicit or int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise
        warnings.warn(f"torch.distributed did not initialise ({err}); "
                      "running as the single process of a world of one")
        return False
    _state["device"] = dev
    return True


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def process_device() -> torch.device:
    """The device :func:`initialize_distributed` chose for this process
    (``cuda:LOCAL_RANK`` unless the caller named another); ``cuda:0``
    where it was never called."""
    return _state["device"] or _default_device(None)


def compute_mesh_dims(
    grid_dim: int,
    n_devices: int,
    grid_size: tuple[int, ...] | None = None,
) -> tuple[int, int]:
    """Factor ``n_devices`` shards over the two shardable mesh axes: prefer
    a slab on the leading axis, fall back to the most balanced pencil whose
    axes divide the grid (on a balance tie, more shards on the leading
    axis). Raises when no factorization divides the grid evenly.

    :param grid_size: optional global grid shape used for divisibility;
        without it the slab shape is returned directly.
    """
    if grid_dim not in (2, 3):
        raise ValueError(f"Invalid grid dim {grid_dim}")
    if n_devices < 1:
        raise ValueError("n_devices must be positive")
    if grid_size is None:
        return (n_devices, 1)
    # the two shardable grid axes: (z, y) in 3D, (y, x) in 2D
    s0, s1 = int(grid_size[0]), int(grid_size[1])
    candidates = []
    for a in range(n_devices, 0, -1):
        if n_devices % a:
            continue
        b = n_devices // a
        if s0 % a == 0 and s1 % b == 0:
            # rank by balance, slab-first on a tie
            candidates.append((abs(a - b), -a, (a, b)))
    if not candidates:
        raise RuntimeError(
            f"grid {grid_size[:2]} not evenly divisible over any "
            f"{n_devices}-device mesh factorization"
        )
    slab = (n_devices, 1)
    if any(c[2] == slab for c in candidates):
        return slab
    candidates.sort()
    return candidates[0][2]


def auto_mesh(grid_dim: int, grid_size=None, n_shards: int | None = None, *,
              device=None) -> Mesh:
    """:func:`create_mesh` with the shards factored automatically
    (slab-first, divisibility-aware) over the mesh axes.

    With ``n_shards`` an in-process mesh of that many shards on
    ``device``. Without it the mesh spans the processes: a distributed
    mesh of the world's size where ``torch.distributed`` is initialised
    (on :func:`process_device` unless ``device`` is given), else the
    single shard."""
    if n_shards is not None:
        if device is None:
            raise ValueError("auto_mesh: an in-process mesh needs a device")
        shape = compute_mesh_dims(grid_dim, n_shards, grid_size)
        return create_mesh(grid_dim, shape, device=device)
    dist = _dist()
    live = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if live else 1
    shape = compute_mesh_dims(grid_dim, world, grid_size)
    return create_mesh(grid_dim, shape,
                       device=device if device is not None
                       else process_device(),
                       distributed=live)
