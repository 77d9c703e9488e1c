"""The port's 2D mesh against the JAX package on its eight virtual CPU
devices: the distributed 2D transforms (slab and pencil, the pencil's
x-major chunk order of the x-frequency axis included), the sharded 2D
Poisson solve (its y step through the plain version of the
``fft_greens_ifft_pass`` wrapper, ``force_kernels``), a Green's function
converted from a JAX solver on a mesh, the 2D stencils on a mesh (halo
exchanges, the thin-shard route and the sponge on the assembled field) and
the factoring of a shard count.

Inputs are made from a seed with numpy. Tolerances: float64 ``1e-12``
(absolute, the values are O(1)); float32 ``get_test_tol("single")`` of the
largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.poisson as jax_poisson
from sopht_mpi_tpu.ops import stencils_2d as jax_stencils
from sopht_mpi_tpu.parallel import distributed as jax_distributed
from sopht_mpi_tpu.parallel import fft as jax_fft
from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu_torch.convert import sharded_greens_from_numpy
from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.ops import stencils_2d as stencils
from sopht_mpi_tpu_torch.parallel import collectives, cuda_fft, distributed
from sopht_mpi_tpu_torch.parallel import fft as dist
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_scalar_field,
    shard_vector_field,
    unshard_scalar_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import get_test_tol

MESH_SHAPES = [(8, 1), (4, 2), (2, 4)]
NP_T = {"single": np.float32, "double": np.float64}


def _close(out, ref, tol, what, relative=False):
    out = np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = float(np.abs(ref).max()) if relative else 1.0
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _jax_shards(arr, jmesh):
    """{(j, i) mesh position: the block of the JAX array's shard there}."""
    where = {d.id: pos for pos, d in np.ndenumerate(jmesh.devices)}
    return {where[sh.device.id]: np.asarray(sh.data)
            for sh in arr.addressable_shards}


@pytest.mark.parametrize("nx", [16, 24, 126])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES + [(1, 8), (2, 2), (1, 1)])
def test_padded_rfft_size_2d_equals_jax(mesh_shape, nx):
    ours = dist.padded_rfft_size(nx, create_mesh(2, mesh_shape, device="cpu"))
    assert ours == jax_fft.padded_rfft_size(
        nx, jax_mesh.create_mesh(2, mesh_shape), 2)


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_rfftn_2d_against_jax(precision, mesh_shape):
    """The forward transform against JAX ``distributed_rfftn`` on the same
    mesh, shard by shard (the Fourier layout's chunk order), and the
    inverse back to the field."""
    grid = (16, 24)
    field = np.random.default_rng(3).standard_normal(grid).astype(
        NP_T[precision])
    mesh = create_mesh(2, mesh_shape, device="cpu")
    jmesh = jax_mesh.create_mesh(2, mesh_shape)
    py, px = mesh_shape
    collectives.reset_counts()
    fhat = dist.distributed_rfftn(
        shard_scalar_field(torch.tensor(field), mesh), mesh)
    transposes = (py > 1) + 2 * (px > 1)
    assert collectives.all_to_all.calls == transposes
    fxp = dist.padded_rfft_size(grid[1], mesh)
    assert fhat.shape == (py, px, grid[0], fxp // (py * px))
    jhat = jax.jit(lambda f: jax_fft.distributed_rfftn(f, jmesh))(
        jax_mesh.shard_scalar_field(jnp.asarray(field), jmesh))
    if precision == "double":
        tol, relative = 1e-12, False
    else:
        tol, relative = get_test_tol("single"), True
    for (j, i), block in _jax_shards(jhat, jmesh).items():
        # the JAX shard at mesh position (y j, x i) is the port's [j, i]
        _close(fhat[j, i].numpy(), block, tol, f"shard {(j, i)}", relative)
    ours = dist.unshard_fourier(fhat, mesh).numpy()
    _close(ours, np.asarray(jhat), tol, "spectrum", relative)
    assert torch.equal(dist.shard_fourier(torch.tensor(ours), mesh), fhat)
    back = dist.distributed_irfftn(fhat, grid[1], mesh)
    assert collectives.all_to_all.calls == 2 * transposes
    assert back.shape == (py, px, grid[0] // py, grid[1] // px)
    _close(unshard_scalar_field(back, mesh).numpy(), field, tol,
           "round trip", relative)


def test_transforms_refuse_a_mesh_that_is_neither_2d_nor_3d():
    """A mesh of other axes raises, as does a 2D convolve of a component
    stack."""
    from sopht_mpi_tpu_torch.parallel.mesh import Mesh

    odd = Mesh((2, 1), ("a", "b"), "cpu")
    with pytest.raises(ValueError, match="create_mesh"):
        dist.distributed_rfftn(torch.zeros(2, 1, 4, 8), odd)
    with pytest.raises(ValueError, match="create_mesh"):
        dist.distributed_free_space_convolve(
            torch.zeros(2, 1, 4, 8), torch.zeros(2, 1, 16, 5), odd)
    # the 2D convolve takes a sharded scalar field only
    flat = create_mesh(2, (2, 1), device="cpu")
    with pytest.raises(ValueError, match="scalar field"):
        dist.distributed_free_space_convolve(
            torch.zeros(2, 1, 2, 4, 8), torch.zeros(2, 1, 16, 5), flat)


@pytest.fixture(scope="module")
def jax_solvers():
    """The JAX 2D solver at 32^2 (the smallest grid whose doubled y axis
    the kernel takes), float64, on each mesh of JAX ``test_poisson.py``'s
    2D cases, its solve of one seeded field and its Green's function."""
    n = 32
    rhs = np.random.default_rng(5).standard_normal((n, n))
    out = {}
    for shape in [(8, 1), (4, 1), (4, 2), (2, 4)]:
        jmesh = jax_mesh.create_mesh(2, shape)
        solver = jax_poisson.UnboundedPoissonSolver2D(
            n, n, real_t=jnp.float64, mesh=jmesh)
        sol = jax.jit(solver.solve)(
            jax_mesh.shard_scalar_field(jnp.asarray(rhs), jmesh))
        out[shape] = (np.asarray(sol),
                      np.asarray(solver.fourier_greens_times_dx_pow_dim))
    return rhs, out


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 1), (4, 2), (2, 4)])
def test_sharded_solve_2d_matches_jax(jax_solvers, mesh_shape, monkeypatch):
    """``UnboundedPoissonSolver2D(mesh=)`` against the JAX solver on the
    same mesh (float64, 1e-12; the stored Green's function is JAX's in the
    port's layout), and in float32 with the y step forced onto the
    ``fft_greens_ifft_pass`` wrapper (its plain version on the CPU), once a
    shard a solve."""
    rhs, ref = jax_solvers
    n = rhs.shape[0]
    mesh = create_mesh(2, mesh_shape, device="cpu")
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    solver = poisson.UnboundedPoissonSolver2D(
        n, n, real_t=torch.float64, device="cpu", mesh=mesh)
    assert solver.mesh is mesh
    jsol, jgreens = ref[mesh_shape]
    _close(dist.unshard_fourier(solver.fourier_greens_times_dx_pow_dim,
                                mesh).numpy(), jgreens, 1e-12, "greens")
    calls = []
    plain = cuda_fft.fft_greens_ifft_pass_ref
    monkeypatch.setattr(cuda_fft, "fft_greens_ifft_pass_ref",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    collectives.reset_counts()
    out = solver.solve(shard_scalar_field(torch.tensor(rhs), mesh))
    py, px = mesh_shape
    # float64 never takes the kernel route; float32 does, once a shard
    assert calls == []
    assert collectives.all_to_all.calls == 2 * (py > 1) + 4 * (px > 1)
    _close(unshard_scalar_field(out, mesh).numpy(), jsol, 1e-12, "solve")
    out32 = dist.distributed_free_space_convolve(
        shard_scalar_field(torch.tensor(rhs, dtype=torch.float32), mesh),
        solver.fourier_greens_times_dx_pow_dim.float(), mesh)
    assert calls == [(1, n, dist.padded_rfft_size(2 * n, mesh) // (py * px))
                     ] * (py * px)
    _close(unshard_scalar_field(out32, mesh).numpy(), jsol,
           get_test_tol("single"), "float32 kernel route", relative=True)
    single = poisson.UnboundedPoissonSolver2D(
        n, n, real_t=torch.float64, device="cpu")
    _close(unshard_scalar_field(out, mesh).numpy(),
           single.solve(torch.tensor(rhs)).numpy(), 1e-12, "single device")


def test_converted_jax_greens_gives_the_same_solve(jax_solvers):
    """A JAX solver's Green's function on the (2, 4) pencil, converted with
    ``sharded_greens_from_numpy`` (x-major chunk order), solves as the
    port's own; on the (4, 2) pencil the chunk order differs from a plain
    cut of the x-frequency axis."""
    rhs, ref = jax_solvers
    n = rhs.shape[0]
    for shape in [(2, 4), (4, 2)]:
        mesh = create_mesh(2, shape, device="cpu")
        jsol, jgreens = ref[shape]
        greens = sharded_greens_from_numpy(jgreens, mesh, device="cpu",
                                           dtype=torch.float64)
        py, px = shape
        plain_cut = torch.tensor(jgreens).reshape(n * 2, py, px, -1).permute(
            1, 2, 0, 3)
        assert not torch.equal(greens, plain_cut)
        out = dist.distributed_free_space_convolve(
            shard_scalar_field(torch.tensor(rhs), mesh), greens, mesh)
        _close(unshard_scalar_field(out, mesh).numpy(), jsol, 1e-12,
               f"solve {shape}")


def _stencil_cases(port, mesh):
    """(name, fn(q, u), ppermute calls on a (py, px) mesh) of the 2D ops a
    flow step runs, ``mesh`` None for the single-device ops."""
    return [
        ("diffusion", lambda q, u: port.diffusion_flux_2d(q, 0.1, *mesh), 1),
        ("advection", lambda q, u: port.advection_timestep_eno3_2d(
            q, u, 0.05, *mesh), 3),
        ("curl", lambda q, u: port.outplane_field_curl_2d(q, 5.0, *mesh), 1),
        ("forcing curl", lambda q, u:
            port.update_vorticity_from_velocity_forcing_2d(q, u, 0.3, *mesh),
         1),
        ("sponge", lambda q, u: port.penalise_field_boundary_2d(
            q, 3, *mesh), None),
    ]


@pytest.fixture(scope="module")
def jax_stencil_outputs():
    rng = np.random.default_rng(10)
    q = rng.standard_normal((32, 32))
    u = rng.standard_normal((2, 32, 32))
    refs = [np.asarray(fn(jnp.asarray(q), jnp.asarray(u)))
            for _, fn, _ in _stencil_cases(jax_stencils, [])]
    return q, u, refs


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (16, 1)])
def test_stencils_2d_on_a_mesh_match_jax(jax_stencil_outputs, mesh_shape):
    """Each op on the sharded fields against the JAX op on the whole grid
    (JAX ``test_stencils_2d.py::test_sharded_matches_single_device``):
    halo exchanges of the op's reach (two ``ppermute`` a sharded axis), and
    on (16, 1), whose 2-row shards are thinner than ENO3's 3-cell reach,
    the advection on the assembled field; the sponge always there."""
    q, u, refs = jax_stencil_outputs
    mesh = create_mesh(2, mesh_shape, device="cpu")
    qs = shard_scalar_field(torch.tensor(q), mesh)
    us = shard_vector_field(torch.tensor(u), mesh)
    sharded_axes = sum(p > 1 for p in mesh_shape)
    for (name, fn, reach), ref in zip(_stencil_cases(stencils, [mesh]),
                                      refs):
        collectives.reset_counts()
        out = fn(qs, us)
        assert out.is_contiguous()
        assemble = (unshard_vector_field if out.ndim == 5
                    else unshard_scalar_field)
        _close(assemble(out, mesh).numpy(), ref, 1e-12, name)
        thin = reach is not None and q.shape[0] // mesh_shape[0] < reach
        assert collectives.counts()["ppermute"] == (
            0 if reach is None or thin else 2 * sharded_axes), name
        assert collectives.counts()["apply_assembled"] == int(
            reach is None or thin), name


def test_halo_apply_2d_zero_walls_and_bands():
    """The ghost cells beyond the physical walls are zero and the op's wall
    band is set again on the wall shards only: an op that reads its
    neighbours' sum sees the assembled field's zero-padded neighbours."""
    from sopht_mpi_tpu_torch.ops._stencil_utils import laplacian_interior

    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((12, 16)))
    ref = torch.nn.functional.pad(laplacian_interior(
        torch.nn.functional.pad(q, (1, 1, 1, 1))), (0, 0, 0, 0))
    banded = ref.clone()
    banded[:2], banded[-2:], banded[:, :2], banded[:, -2:] = 0, 0, 0, 0
    for shape in [(3, 2), (2, 4), (1, 1)]:
        mesh = create_mesh(2, shape, device="cpu")
        qs = shard_scalar_field(q, mesh)
        for band, want in [(0, ref), (2, banded)]:
            op = lambda f: torch.nn.functional.pad(  # noqa: E731
                laplacian_interior(f), (1, 1, 1, 1))
            out = collectives.halo_apply_2d(op, mesh, qs, width=1, band=band)
            _close(unshard_scalar_field(out, mesh).numpy(), want.numpy(),
                   1e-12, f"{shape} band {band}")
    with pytest.raises(ValueError, match="create_mesh"):
        collectives.halo_apply_2d(lambda f: f, create_mesh(3, (2, 1),
                                  device="cpu"), torch.zeros(2, 1, 4, 4),
                                  width=1)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
@pytest.mark.parametrize("grid", [None, (32, 32), (12, 32), (30, 64)])
def test_mesh_dims_2d_match_jax(n, grid):
    try:
        ref = jax_distributed.compute_mesh_dims(2, n, grid)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            distributed.compute_mesh_dims(2, n, grid)
        return
    assert distributed.compute_mesh_dims(2, n, grid) == ref
    if grid is not None:
        mesh = distributed.auto_mesh(2, grid, n, device="cpu")
        assert mesh.axis_names == ("y", "x") and mesh.axis_sizes == ref
