"""The port's four sharded 3D stencils against the JAX package's sharded
Pallas functions (interpret mode on the eight virtual CPU devices) and
against the port's own single-device plain ops on the assembled field.

On the CPU the port's wrappers exchange the halos and run the per-shard
computation in plain PyTorch on them (the CUDA kernels are held against
the same plain versions on the card). Tolerances: float64 1e-13 absolute
(the same sums in another order); float32 ``1e-5 max(1, |ref|max)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.pallas_stencils_sharded as pss
from sopht_mpi_tpu.parallel import create_mesh as jax_create_mesh
from sopht_mpi_tpu.parallel import shard_vector_field as jax_shard
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as single
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)

MESH_SHAPES = [(8, 1), (4, 2), (2, 4)]
SHAPE = (3, 16, 32, 128)
NP_T = {"single": np.float32, "double": np.float64}
FSV = [1.0, -0.5, 0.25]


def _fields(precision, shape=SHAPE, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(NP_T[precision]),
            rng.standard_normal(shape).astype(NP_T[precision]))


def _close(out, ref, precision, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    tol = 1e-13 if precision == "double" else \
        1e-5 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _port(op, mesh_shape, fields, *args, **kwargs):
    """``op`` of the sharded ``fields`` on the port's mesh, assembled."""
    mesh = create_mesh(3, mesh_shape, device="cpu")
    res = op(*(shard_vector_field(torch.tensor(f), mesh) for f in fields),
             *args, mesh=mesh, **kwargs)
    if isinstance(res, tuple):
        return unshard_vector_field(res[0], mesh).numpy(), float(res[1])
    return unshard_vector_field(res, mesh).numpy()


def _jax_fields(mesh_shape, fields):
    jmesh = jax_create_mesh(3, mesh_shape)
    return jmesh, [jax_shard(jnp.asarray(f), jmesh) for f in fields]


CASES = [(m, p) for m in MESH_SHAPES for p in ("double", "single")]


@pytest.mark.parametrize("mesh_shape,precision", CASES)
def test_diffusion_matches_jax_sharded(mesh_shape, precision):
    w, _ = _fields(precision)
    jmesh, (jw,) = _jax_fields(mesh_shape, [w])
    assert pss.sharded_stencil_ytiles(SHAPE, jmesh, 3, w.itemsize) is not None
    ref = pss.diffusion_timestep_vector_3d_sharded(
        jw, jnp.asarray(0.37, w.dtype), jmesh)
    out = _port(sharded.diffusion_timestep_vector_3d_sharded, mesh_shape,
                [w], 0.37)
    _close(out, ref, precision, "diffusion")


@pytest.mark.parametrize("mesh_shape,precision", CASES)
def test_curl_with_add_and_global_l1max_matches_jax_sharded(mesh_shape,
                                                            precision):
    w, _ = _fields(precision)
    jmesh, (jw,) = _jax_fields(mesh_shape, [w])
    ref, l1_ref = pss.curl_3d_sharded(
        jw, jnp.asarray(8.0, w.dtype), jmesh,
        add_vector=jnp.asarray(FSV, w.dtype), compute_l1_max=True)
    out, l1 = _port(sharded.curl_3d_sharded, mesh_shape, [w], 8.0,
                    add_vector=FSV, compute_l1_max=True)
    _close(out, ref, precision, "curl")
    _close(l1, float(l1_ref), precision, "global max |u|_1")
    # without the add vector and the maximum
    plain = _port(sharded.curl_3d_sharded, mesh_shape, [w], 8.0)
    _close(plain, out - np.asarray(FSV, w.dtype).reshape(3, 1, 1, 1),
           precision, "curl without add")


@pytest.mark.parametrize("mesh_shape,precision", CASES)
def test_rotational_matches_jax_sharded(mesh_shape, precision):
    w, u = _fields(precision)
    jmesh, (jw, ju) = _jax_fields(mesh_shape, [w, u])
    ref = pss.rotational_curl_add_3d_sharded(
        jw, ju, jnp.asarray(0.05, w.dtype), jmesh)
    out = _port(sharded.rotational_curl_add_3d_sharded, mesh_shape, [w, u],
                0.05)
    _close(out, ref, precision, "rotational transport")


@pytest.mark.parametrize("mesh_shape,width,precision", [
    ((4, 2), 2, "double"), ((2, 4), 3, "double"), ((8, 1), 1, "double"),
    ((8, 1), 2, "double"), ((4, 2), 2, "single"),
])
def test_diffusion_penalise_matches_jax_sharded(mesh_shape, width, precision):
    w, _ = _fields(precision)
    jmesh, (jw,) = _jax_fields(mesh_shape, [w])
    mesh = create_mesh(3, mesh_shape, device="cpu")
    # where both gates speak of the same condition they agree; (8, 1) at
    # width 2 has nzl = 2 < 2 width and falls back in both packages
    supported = sharded.diffusion_penalise_sharded_supported(
        SHAPE, mesh, width)
    assert supported == pss.diffusion_penalise_sharded_supported(
        SHAPE, jmesh, width, w.itemsize)
    assert supported == (mesh_shape != (8, 1) or width == 1)
    ref = pss.diffusion_penalise_vector_3d_sharded(
        jw, jnp.asarray(0.37, w.dtype), width, jmesh)
    collectives.reset_counts()
    out = _port(sharded.diffusion_penalise_vector_3d_sharded, mesh_shape,
                [w], 0.37, width)
    # the fallback is the sharded diffusion and the sponge on the assembled
    # field; the fused path assembles nothing
    assert collectives.apply_assembled.calls == (0 if supported else 1)
    _close(out, ref, precision, f"diffusion + sponge, width {width}")


# ---------------------------------------------------------------------------
# against the port's own single-device plain ops
# ---------------------------------------------------------------------------

# (grid, mesh): shards on 0, 1 and 2 walls ((3, 3) has an interior shard and
# corner shards), slabs along either axis, shard extents that are no
# multiple of 8, the single shard
OWN_CASES = [
    ((3, 18, 33, 20), (3, 3)),
    ((3, 16, 32, 24), (4, 2)),
    ((3, 16, 32, 24), (8, 1)),
    ((3, 16, 32, 24), (1, 8)),
    ((3, 34, 66, 17), (2, 2)),
    ((3, 12, 10, 9), (1, 1)),
]


def _wall_poisoning_ppermute(monkeypatch):
    """Make every halo that wraps around a physical wall large and wrong
    (never NaN): no unmasked cell may read it."""
    real = collectives.ppermute

    def poisoned(x, mesh, axis, shift):
        out = real(x, mesh, axis, shift).clone()
        dim = mesh.axis_names.index(axis)
        # shard 0 receives from the last shard (shift > 0), and the last
        # from shard 0 (shift < 0): across the wall
        out.select(dim, 0 if shift > 0 else -1).fill_(1e30)
        return out

    # the module looks its own count up under the patched name
    poisoned.calls = 0
    monkeypatch.setattr(collectives, "ppermute", poisoned)


@pytest.mark.parametrize("shape,mesh_shape", OWN_CASES)
def test_sharded_ops_match_own_single_device_plain(precision, shape,
                                                   mesh_shape, monkeypatch):
    _wall_poisoning_ppermute(monkeypatch)
    w, u = _fields(precision, shape, seed=9)
    tw, tu = torch.tensor(w), torch.tensor(u)
    add = torch.tensor(FSV, dtype=tw.dtype)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    _close(_port(sharded.diffusion_timestep_vector_3d_sharded, mesh_shape,
                 [w], 0.37),
           single.diffusion_timestep_vector_3d_ref(tw, 0.37), precision,
           "diffusion")
    _close(_port(sharded.rotational_curl_add_3d_sharded, mesh_shape, [w, u],
                 0.05),
           single.rotational_curl_add_3d_ref(tw, tu, 0.05), precision,
           "rotational transport")
    out, l1 = _port(sharded.curl_3d_sharded, mesh_shape, [w], 8.0,
                    add_vector=add, compute_l1_max=True)
    ref, l1_ref = single.curl_3d_ref(tw, 8.0, add, True)
    _close(out, ref, precision, "curl")
    _close(l1, float(l1_ref), precision, "max |u|_1")
    for width in (1, 2, 3):
        _close(_port(sharded.diffusion_penalise_vector_3d_sharded,
                     mesh_shape, [w], 0.37, width),
               single.diffusion_penalise_vector_3d_ref(tw, 0.37, width),
               precision, f"diffusion + sponge, width {width}")
    # the plain versions beside the wrappers are the same oracle, sharded
    ws = shard_vector_field(tw, mesh)
    assert torch.equal(
        sharded.diffusion_timestep_vector_3d_sharded_ref(ws, 0.37, mesh),
        shard_vector_field(
            single.diffusion_timestep_vector_3d_ref(tw, 0.37), mesh))


def test_halo_helpers_and_shard_coords():
    mesh = create_mesh(3, (2, 3), device="cpu")
    f = torch.arange(3 * 4 * 6 * 2, dtype=torch.float64).reshape(3, 4, 6, 2)
    fs = shard_vector_field(f, mesh)
    collectives.reset_counts()
    zlo, zhi = sharded._halo_z_planes(fs, mesh)
    ylo, yhi = sharded._halo_y_rows(fs, mesh)
    assert collectives.ppermute.calls == 4
    # the shards between their z halo planes
    fg = torch.cat([zlo, fs, zhi], dim=3)
    assert fg.shape == (2, 3, 3, 4, 2, 2)
    assert ylo.shape == yhi.shape == (2, 3, 3, 2, 1, 2)
    # shard (1, 1): planes 2..3, rows 2..3 of the grid
    assert torch.equal(fg[1, 1][:, 0], f[:, 1, 2:4])       # plane below
    assert torch.equal(fg[0, 1][:, -1], f[:, 2, 2:4])      # plane above
    assert torch.equal(ylo[1, 1][:, :, 0], f[:, 2:4, 1])   # row below
    assert torch.equal(yhi[1, 1][:, :, 0], f[:, 2:4, 4])   # row above
    coords = sharded._shard_coords((2, 3), 2, 2, torch.device("cpu"))
    assert coords.dtype == torch.int32 and coords.is_contiguous()
    assert coords.tolist() == [[[0, 0], [0, 2], [0, 4]],
                               [[2, 0], [2, 2], [2, 4]]]
    # a slab exchanges along its one sharded axis only
    slab = create_mesh(3, (2, 1), device="cpu")
    collectives.reset_counts()
    sharded.diffusion_timestep_vector_3d_sharded(
        shard_vector_field(f, slab), 0.1, slab)
    assert collectives.ppermute.calls == 2


def test_shape_the_jax_gate_refuses_runs_sharded_and_agrees(precision):
    """``nyl = 4`` is below the JAX functions' 8-row tile: they fall back to
    the global jnp op; the port's take the shape through their halo path.
    Both give the same field."""
    w, _ = _fields(precision)
    jmesh, (jw,) = _jax_fields((1, 8), [w])
    assert pss.sharded_stencil_ytiles(SHAPE, jmesh, 3, w.itemsize) is None
    ref = pss.diffusion_timestep_vector_3d_sharded(
        jw, jnp.asarray(0.37, w.dtype), jmesh)
    collectives.reset_counts()
    out = _port(sharded.diffusion_timestep_vector_3d_sharded, (1, 8), [w],
                0.37)
    assert collectives.ppermute.calls == 2  # the y rows were exchanged
    _close(out, ref, precision, "diffusion on (1, 8)")


def test_gate_and_argument_checks():
    mesh = create_mesh(3, (4, 2), device="cpu")
    ok = sharded.diffusion_penalise_sharded_supported
    assert ok(SHAPE, mesh, 2)
    assert not ok(SHAPE, mesh, 0)
    assert not ok(SHAPE, mesh, 3)  # nzl = 4 < 6
    assert not ok((3, 4, 32, 128), mesh, 2)  # nz <= 2 width
    assert not ok((3, 18, 32, 128), mesh, 1)  # nz does not divide
    f = shard_vector_field(torch.zeros(SHAPE), mesh)
    with pytest.raises(ValueError):
        sharded.diffusion_timestep_vector_3d_sharded(torch.zeros(SHAPE), 0.1,
                                                     mesh)
    with pytest.raises(ValueError):
        sharded.rotational_curl_add_3d_sharded(f, f.double(), 0.1, mesh)
    with pytest.raises(TypeError):
        sharded.curl_3d_sharded(f.half(), 0.1, mesh)
    with pytest.raises(ValueError):
        sharded.curl_3d_sharded(f, 0.1, create_mesh(2, (4, 2), device="cpu"))
    for fn in sharded.KERNELS:
        assert fn.launches == 0  # nothing launches on the CPU
