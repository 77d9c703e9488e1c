"""The port's in-process mesh, its sharded-field layout, the mesh factoring
and the collectives, against the JAX package on its eight virtual CPU
devices: shards against ``addressable_shards``, the collectives against
``jax.lax`` under ``shard_map`` on the same arrays, bit for bit (they only
move data, or take maxima and sums of integer-valued floats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu.parallel.distributed import (
    compute_mesh_dims as jax_compute_mesh_dims,
)
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.distributed import (
    auto_mesh,
    compute_mesh_dims,
)
from sopht_mpi_tpu_torch.parallel.mesh import (
    Mesh,
    apply_assembled,
    check_grid_divisibility,
    create_mesh,
    mesh_axis_names,
    shard_dims,
    shard_scalar_field,
    shard_vector_field,
    unshard_dims,
    unshard_scalar_field,
    unshard_vector_field,
)

MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (2, 2), (1, 1)]
GRID = (16, 32, 12)


def _field(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_shard_then_unshard_is_identity(mesh_shape):
    mesh = create_mesh(3, mesh_shape, device="cpu")
    pz, py = mesh_shape
    scalar = torch.tensor(_field(GRID))
    vector = torch.tensor(_field((3, *GRID), 1))
    s, v = shard_scalar_field(scalar, mesh), shard_vector_field(vector, mesh)
    assert s.shape == (pz, py, GRID[0] // pz, GRID[1] // py, GRID[2])
    assert v.shape == (pz, py, 3, GRID[0] // pz, GRID[1] // py, GRID[2])
    assert s.is_contiguous() and v.is_contiguous()
    # the shards own their storage, whatever the mesh
    assert v.data_ptr() != vector.data_ptr()
    assert torch.equal(unshard_scalar_field(s, mesh), scalar)
    assert torch.equal(unshard_vector_field(v, mesh), vector)
    # a shard is the block of the global field at its offsets
    i, j = pz - 1, py - 1
    nzl, nyl = GRID[0] // pz, GRID[1] // py
    assert torch.equal(
        v[i, j], vector[:, i * nzl:(i + 1) * nzl, j * nyl:(j + 1) * nyl])
    # without a mesh a field is itself
    assert shard_vector_field(vector, None) is vector
    assert unshard_scalar_field(scalar, None) is scalar


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_shards_equal_jax_addressable_shards(mesh_shape):
    field = _field((3, *GRID), 2)
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    sharded = jax_mesh.shard_vector_field(jnp.asarray(field), jmesh)
    ours = shard_vector_field(
        torch.tensor(field), create_mesh(3, mesh_shape, device="cpu"))
    nzl, nyl = GRID[0] // mesh_shape[0], GRID[1] // mesh_shape[1]
    seen = set()
    for shard in sharded.addressable_shards:
        i = (shard.index[1].start or 0) // nzl
        j = (shard.index[2].start or 0) // nyl
        seen.add((i, j))
        np.testing.assert_array_equal(ours[i, j].numpy(),
                                      np.asarray(shard.data))
    assert len(seen) == mesh_shape[0] * mesh_shape[1]


def test_mesh_object_and_axis_names():
    mesh = create_mesh(3, (4, 2), device="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("z", "y") == mesh_axis_names(3)
    assert mesh.shape == {"z": 4, "y": 2} and mesh.size == 8
    assert mesh.axis_sizes == (4, 2) and mesh.grid_dim == 3
    assert mesh.device == torch.device("cpu")
    flat = create_mesh(2, (2, 1), device="cpu")
    assert flat.axis_names == ("y", "x") == mesh_axis_names(2)
    assert flat.grid_dim == 2
    assert create_mesh(3, device="cpu").size == 1
    assert jax_mesh.mesh_axis_names(3) == mesh_axis_names(3)
    assert jax_mesh.mesh_axis_names(2) == mesh_axis_names(2)
    with pytest.raises(ValueError):
        mesh_axis_names(4)
    with pytest.raises(ValueError):
        create_mesh(3, (2, 2, 2), device="cpu")
    with pytest.raises(ValueError):
        create_mesh(3, (0, 2), device="cpu")
    with pytest.raises(TypeError):
        create_mesh(3, (2, 2))  # device is required


@pytest.mark.parametrize("grid,mesh_shape", [((16, 32, 12), (4, 2)),
                                             ((10, 32, 12), (4, 2)),
                                             ((16, 30, 12), (2, 4))])
def test_check_grid_divisibility_raises_as_jax(grid, mesh_shape):
    def outcome(check, mesh):
        try:
            check(grid, mesh)
        except RuntimeError as e:
            return str(e)
        return None

    ours = outcome(check_grid_divisibility,
                   create_mesh(3, mesh_shape, device="cpu"))
    theirs = outcome(jax_mesh.check_grid_divisibility,
                     jax_mesh.create_mesh(3, mesh_shape))
    assert ours == theirs
    assert (ours is None) == (grid == (16, 32, 12))


@pytest.mark.parametrize("grid_dim,n,grid", [
    (3, 8, None), (3, 8, (16, 32, 128)), (3, 8, (4, 32, 128)),
    (3, 8, (12, 32, 64)), (3, 6, (9, 8, 16)), (3, 4, (2, 2, 8)),
    (2, 8, (64, 64)), (2, 8, (4, 64)), (2, 6, (9, 4)), (3, 1, (5, 7, 9)),
    (3, 16, (8, 8, 8)), (3, 12, (18, 8, 4)),
])
def test_compute_mesh_dims_equals_jax(grid_dim, n, grid):
    assert compute_mesh_dims(grid_dim, n, grid) \
        == jax_compute_mesh_dims(grid_dim, n, grid)


def test_compute_mesh_dims_errors_and_auto_mesh():
    for args in ((4, 8, None), (3, 0, None)):
        with pytest.raises(ValueError):
            compute_mesh_dims(*args)
        with pytest.raises(ValueError):
            jax_compute_mesh_dims(*args)
    with pytest.raises(RuntimeError):
        compute_mesh_dims(3, 8, (3, 3, 16))
    mesh = auto_mesh(3, (4, 32, 128), 8, device="cpu")
    assert mesh.axis_sizes == (4, 2) and mesh.device.type == "cpu"
    assert auto_mesh(3, (16, 32, 128), 8, device="cpu").axis_sizes == (8, 1)


# ---------------------------------------------------------------------------
# collectives against jax.lax under shard_map
# ---------------------------------------------------------------------------


def _jax_shard_map(body, jmesh, x, in_spec, out_spec):
    return np.asarray(shard_map(
        body, mesh=jmesh, in_specs=in_spec, out_specs=out_spec,
        check_vma=False,
    )(jnp.asarray(x)))


def _spec_dims(spec):
    """The array axes a PartitionSpec gives the mesh axes (z, y)."""
    return tuple(list(spec).index(a) for a in ("z", "y"))


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("axis,shift", [("z", 1), ("z", -1), ("y", 1),
                                        ("y", -1)])
def test_ppermute_equals_lax(mesh_shape, axis, shift):
    x = _field((16, 8, 5), 3)
    spec = P("z", "y", None)
    p = dict(zip("zy", mesh_shape))[axis]
    perm = [(i, (i + shift) % p) for i in range(p)]
    ref = _jax_shard_map(lambda a: lax.ppermute(a, axis, perm),
                         jax_mesh.create_mesh(3, mesh_shape), x, spec, spec)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    calls = collectives.ppermute.calls
    out = collectives.ppermute(
        shard_dims(torch.tensor(x), mesh, (0, 1)), mesh, axis, shift)
    assert collectives.ppermute.calls == calls + 1
    np.testing.assert_array_equal(
        unshard_dims(out, mesh, (0, 1)).numpy(), ref)


# (local array rank, in spec, mesh axis, split, concat, out spec): the
# transposes of the 3D transforms and of the batched convolve
A2A_CASES = [
    (P("z", "y", None), "y", 2, 1, P("z", None, "y")),
    (P("z", None, "y"), "z", 1, 0, P(None, "z", "y")),
    (P(None, "z", "y"), "z", 0, 1, P("z", None, "y")),
    (P("z", None, "y"), "y", 1, 2, P("z", "y", None)),
    (P(None, "z", None, "y"), "z", 2, 1, P(None, None, "z", "y")),
    (P(None, None, "z", "y"), "z", 1, 2, P(None, "z", None, "y")),
    (P("z", "y", None), "y", 1, 1, P("z", "y", None)),
]


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("case", range(len(A2A_CASES)))
def test_all_to_all_equals_lax(mesh_shape, case):
    in_spec, axis, split, concat, out_spec = A2A_CASES[case]
    shape = (16, 16, 16) if len(in_spec) == 3 else (3, 16, 16, 16)
    x = _field(shape, 4) + 1j * _field(shape, 5)
    ref = _jax_shard_map(
        lambda a: lax.all_to_all(a, axis, split_axis=split,
                                 concat_axis=concat, tiled=True),
        jax_mesh.create_mesh(3, mesh_shape), x, in_spec, out_spec)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    calls = collectives.all_to_all.calls
    out = collectives.all_to_all(
        shard_dims(torch.tensor(x), mesh, _spec_dims(in_spec)), mesh, axis,
        split, concat)
    assert collectives.all_to_all.calls == calls + 1
    np.testing.assert_array_equal(
        unshard_dims(out, mesh, _spec_dims(out_spec)).numpy(), ref)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1)])
def test_pmax_and_psum_equal_lax(mesh_shape):
    x = np.round(20 * _field((16, 8, 5), 6))  # integer-valued: exact sums
    spec = P("z", "y", None)
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    ours = shard_dims(torch.tensor(x), mesh, (0, 1))
    local_max = ours.amax(dim=(2, 3, 4))
    local_sum = ours.sum(dim=(2, 3, 4))
    for name, ref_fn, fn, local in (
            ("pmax", lax.pmax, collectives.pmax, local_max),
            ("psum", lax.psum, collectives.psum, local_sum)):
        reduce = jnp.max if name == "pmax" else jnp.sum
        ref = _jax_shard_map(
            lambda a: ref_fn(reduce(a), ("z", "y")), jmesh, x, spec, P())
        out = fn(local, mesh)
        assert out.ndim == 0
        assert float(out) == float(ref), name
        ref_z = _jax_shard_map(
            lambda a: ref_fn(reduce(a).reshape(1), "z"), jmesh, x, spec,
            P("y"))
        np.testing.assert_array_equal(fn(local, mesh, "z").numpy(), ref_z)


def test_counts_reset_and_assembled_helper():
    mesh = create_mesh(3, (2, 2), device="cpu")
    field = shard_vector_field(torch.tensor(_field((3, 4, 4, 4), 7)), mesh)
    collectives.reset_counts()
    out = apply_assembled(lambda f: 2.0 * f, mesh, field)
    assert torch.equal(out, 2.0 * field)
    collectives.ppermute(field, mesh, "y", 1)
    counts = collectives.counts()
    assert counts == {"ppermute": 1, "all_to_all": 0, "pmax": 0, "psum": 0,
                      "apply_assembled": 1}
    collectives.reset_counts()
    assert not any(collectives.counts().values())


@pytest.mark.parametrize("mesh_shape,grid", [
    ((4, 1), (4, 8, 6)), ((1, 4), (4, 4, 6)), ((4, 2), (4, 8, 6))])
def test_assembled_fields_are_contiguous(mesh_shape, grid):
    """On one-plane ((4, 1) over 4 planes) and one-row ((1, 4) over 4 rows)
    shards the assembled field is a strided view of the shards; the
    function of :func:`apply_assembled` gets it contiguous, as the
    single-device kernels need on the card."""
    mesh = create_mesh(3, mesh_shape, device="cpu")
    field = shard_vector_field(torch.tensor(_field((3, *grid), 3)), mesh)

    def fn(f):
        assert f.is_contiguous()
        return f + 1.0

    assert torch.equal(apply_assembled(fn, mesh, field), field + 1.0)
