"""Automatic factoring of a shard count over the mesh axes (counterpart of
``compute_mesh_dims`` and ``auto_mesh`` in
``sopht_mpi_tpu/parallel/distributed.py``; the multi-process bootstrap has
no in-process counterpart)."""

from __future__ import annotations

from sopht_mpi_tpu_torch.parallel.mesh import Mesh, create_mesh


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


def auto_mesh(grid_dim: int, grid_size, n_shards: int, *, device) -> Mesh:
    """:func:`create_mesh` with ``n_shards`` factored automatically
    (slab-first, divisibility-aware) over the mesh axes."""
    shape = compute_mesh_dims(grid_dim, n_shards, grid_size)
    return create_mesh(grid_dim, shape, device=device)
