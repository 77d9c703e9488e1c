"""The port's distributed transforms, free-space convolve and Poisson solver
on an in-process (pz, py) mesh against the JAX package on its eight virtual
CPU devices, and against the port's own single-device solver.

On the CPU the port's y and z passes are ``torch.fft`` or, with
``force_kernels=True``, the FFT-pass wrappers' plain versions; the JAX side
runs its einsum passes or, with ``force_pallas=True``, its Pallas passes in
interpret mode. Tolerances: float64 ``1e-10 max|ref|``; float32
``2e-5 max|ref|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.poisson as jax_poisson
from sopht_mpi_tpu.parallel import fft as jax_fft
from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu_torch.convert import sharded_greens_from_numpy
from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver3D
from sopht_mpi_tpu_torch.parallel import collectives, cuda_fft
from sopht_mpi_tpu_torch.parallel import fft as dist
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_dims,
    shard_scalar_field,
    shard_vector_field,
    unshard_dims,
    unshard_scalar_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import get_real_t

MESH_SHAPES = [(4, 2), (2, 4), (8, 1), (2, 2)]
NP_T = {"single": np.float32, "double": np.float64}
TOL = {"single": 2e-5, "double": 1e-10}


def _close(out, ref, tol, what):
    out = np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _fourier_global(fourier, mesh):
    """The global (nz, ny, fxp) array of a sharded Fourier-layout tensor."""
    return unshard_dims(fourier, mesh, dist.FOURIER_SHARDED_DIMS).numpy()


@pytest.mark.parametrize("nx", [24, 26, 128, 510])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES + [(1, 8), (1, 1)])
def test_padded_rfft_size_equals_jax(mesh_shape, nx):
    ours = dist.padded_rfft_size(nx, create_mesh(3, mesh_shape, device="cpu"))
    assert ours == jax_fft.padded_rfft_size(
        nx, jax_mesh.create_mesh(3, mesh_shape), 3)
    assert dist.padded_rfft_size(nx, None) == nx // 2 + 1


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_rfftn_round_trip_and_against_jax(mesh_shape):
    grid = (16, 16, 24)
    field = np.random.default_rng(3).standard_normal(grid)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    collectives.reset_counts()
    fhat = dist.distributed_rfftn(
        shard_scalar_field(torch.tensor(field), mesh), mesh)
    transposes = sum(p > 1 for p in mesh_shape)
    assert collectives.all_to_all.calls == transposes
    pz, py = mesh_shape
    fxp = dist.padded_rfft_size(grid[2], mesh)
    assert fhat.shape == (pz, py, grid[0], grid[1] // pz, fxp // py)
    ref = np.asarray(jax.jit(lambda f: jax_fft.distributed_rfftn(f, jmesh))(
        jax_mesh.shard_scalar_field(jnp.asarray(field), jmesh)))
    ours = _fourier_global(fhat, mesh)
    _close(ours, ref, 1e-12, "spectrum")
    nxf = grid[2] // 2 + 1
    _close(ours[..., :nxf], np.fft.rfftn(field), 1e-12, "against numpy")
    # the padded x-frequency columns are exactly zero
    assert not ours[..., nxf:].any()
    back = dist.distributed_irfftn(fhat, grid[2], mesh)
    assert collectives.all_to_all.calls == 2 * transposes
    assert back.shape == (pz, py, grid[0] // pz, grid[1] // py, grid[2])
    _close(unshard_scalar_field(back, mesh).numpy(), field, 1e-12,
           "round trip")
    jback = jax.jit(lambda f: jax_fft.distributed_irfftn(f, grid[2], jmesh))(
        jnp.asarray(ref))
    _close(unshard_scalar_field(back, mesh).numpy(), np.asarray(jback),
           1e-12, "inverse against jax")


def test_transforms_without_a_mesh_and_2d_refusal():
    field = np.random.default_rng(4).standard_normal((6, 8, 10))
    for mesh in (None, create_mesh(3, (1, 1), device="cpu")):
        fhat = dist.distributed_rfftn(torch.tensor(field), mesh)
        _close(fhat.numpy(), np.fft.rfftn(field), 1e-12, "meshless spectrum")
        _close(dist.distributed_irfftn(fhat, 10, mesh).numpy(), field, 1e-12,
               "meshless round trip")
    # a 2D mesh takes the 2D transforms (tests/test_torch_mesh_2d.py holds
    # them against the JAX package)
    flat = create_mesh(2, (2, 1), device="cpu")
    plane = field[0]
    fhat = dist.distributed_rfftn(shard_scalar_field(torch.tensor(plane),
                                                     flat), flat)
    _close(dist.unshard_fourier(fhat, flat).numpy()[:, :6],
           np.fft.rfft2(plane), 1e-12, "2D mesh spectrum")
    _close(unshard_scalar_field(dist.distributed_irfftn(fhat, 10, flat),
                                flat).numpy(), plane, 1e-12,
           "2D mesh round trip")
    assert dist.padded_rfft_size(8, flat) == (
        jax_fft.padded_rfft_size(8, jax_mesh.create_mesh(2, (2, 1)), 2))


def _convolve_inputs(grid, precision, seed=11):
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal((3, *grid)).astype(NP_T[precision])
    kernel = rng.standard_normal(
        tuple(2 * s for s in grid)).astype(NP_T[precision])
    return rhs, kernel


def _jax_greens(kernel, jmesh):
    # under jit: an eager shard_map lowers every primitive on its own
    return jax.jit(
        lambda k: jnp.real(jax_fft.distributed_rfftn(k, jmesh))
    )(jax_mesh.shard_scalar_field(jnp.asarray(kernel), jmesh))


def _jax_convolve(rhs, greens, jmesh, **kw):
    return jax.jit(lambda r, g: jax_fft.distributed_free_space_convolve(
        r, g, jmesh, **kw))(rhs, greens)


@pytest.mark.parametrize("mesh_shape,grid,force", [
    ((4, 2), (32, 32, 32), True),
    ((2, 4), (16, 32, 32), False),
    ((8, 1), (16, 32, 16), False),
    ((2, 2), (16, 16, 16), False),
])
def test_convolve_scalar_and_batched_match_jax(precision, mesh_shape, grid,
                                               force):
    """Scalar and batched convolve with one random real multiplier, the JAX
    side through its Pallas passes in interpret mode (``force``, float32)
    or its einsum passes, the port's through the pass wrappers' plain
    versions or ``torch.fft``."""
    force = force and precision == "single"
    rhs, kernel = _convolve_inputs(grid, precision)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    jg = _jax_greens(kernel, jmesh)
    greens = sharded_greens_from_numpy(
        np.asarray(jg), mesh, device="cpu", dtype=get_real_t(precision))
    pz, py = mesh_shape
    assert greens.shape == (pz, py, 2 * grid[0], 2 * grid[1] // pz,
                            dist.padded_rfft_size(2 * grid[2], mesh) // py)
    # the port's own transform of the kernel gives the same multiplier
    own = dist.distributed_rfftn(
        shard_scalar_field(torch.tensor(kernel), mesh), mesh).real
    _close(_fourier_global(own, mesh), np.asarray(jg), TOL[precision],
           "multiplier")
    ref = _jax_convolve(
        jax_mesh.shard_vector_field(jnp.asarray(rhs), jmesh), jg, jmesh,
        force_pallas=force)
    for fn in cuda_fft.KERNELS:
        fn.launches = 0
    collectives.reset_counts()
    out = dist.distributed_free_space_convolve(
        shard_vector_field(torch.tensor(rhs), mesh), greens, mesh,
        force_kernels=force)
    # a batched convolve moves all components in every transpose
    assert collectives.all_to_all.calls == 2 * sum(p > 1 for p in mesh_shape)
    assert not any(fn.launches for fn in cuda_fft.KERNELS)  # CPU tensors
    _close(unshard_vector_field(out, mesh).numpy(), ref, TOL[precision],
           "batched convolve")
    ref0 = _jax_convolve(
        jax_mesh.shard_scalar_field(jnp.asarray(rhs[1]), jmesh), jg, jmesh,
        force_pallas=force)
    out0 = dist.distributed_free_space_convolve(
        shard_scalar_field(torch.tensor(rhs[1]), mesh), greens, mesh,
        force_kernels=force)
    _close(unshard_scalar_field(out0, mesh).numpy(), ref0, TOL[precision],
           "scalar convolve")
    # the scalar convolve is one component of the batched one
    _close(unshard_scalar_field(out0, mesh).numpy(),
           unshard_vector_field(out, mesh).numpy()[1], TOL[precision],
           "scalar against batched")


def test_convolve_kernel_route_equals_torch_fft_route():
    """On the CPU ``force_kernels`` swaps the y and z passes between the
    pass wrappers' plain versions and ``torch.fft``; where a doubled length
    is off the kernels' range (2 nz = 32) that pass stays ``torch.fft``."""
    for grid, mesh_shape in (((32, 32, 32), (2, 2)), ((16, 32, 20), (4, 2))):
        rhs, kernel = _convolve_inputs(grid, "single", seed=5)
        mesh = create_mesh(3, mesh_shape, device="cpu")
        greens = dist.distributed_rfftn(
            shard_scalar_field(torch.tensor(kernel), mesh), mesh
        ).real.contiguous()
        field = shard_vector_field(torch.tensor(rhs), mesh)
        plain = dist.distributed_free_space_convolve(
            field, greens, mesh, force_kernels=False)
        routed = dist.distributed_free_space_convolve(
            field, greens, mesh, force_kernels=True)
        _close(routed.numpy(), plain.numpy(), 2e-5, f"routes at {grid}")
    assert cuda_fft.kernel_fft_supported(64)
    assert not cuda_fft.kernel_fft_supported(32)


def test_convolve_options():
    grid, mesh_shape = (16, 16, 16), (2, 2)
    rhs, kernel = _convolve_inputs(grid, "double", seed=6)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    greens = dist.distributed_rfftn(
        shard_scalar_field(torch.tensor(kernel), mesh), mesh).real.contiguous()
    field = shard_vector_field(torch.tensor(rhs), mesh)
    base = dist.distributed_free_space_convolve(field, greens, mesh)
    for chunks in (1, 4, 7):
        assert torch.equal(base, dist.distributed_free_space_convolve(
            field, greens, mesh, overlap_chunks=chunks))
    assert torch.equal(base, dist.distributed_free_space_convolve(
        field, greens, mesh, fast=True))
    with pytest.raises(ValueError, match="overlap_chunks must be >= 1"):
        dist.distributed_free_space_convolve(field, greens, mesh,
                                             overlap_chunks=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dist.distributed_free_space_convolve(field, greens, mesh,
                                             comm_bf16=True)
    with pytest.raises(ValueError, match="Fourier layout"):
        dist.distributed_free_space_convolve(field, greens[..., :-1], mesh)
    # the JAX function raises the same ValueError for the same request
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    with pytest.raises(ValueError, match="overlap_chunks must be >= 1"):
        jax_fft.distributed_free_space_convolve(
            jax_mesh.shard_vector_field(jnp.asarray(rhs), jmesh),
            _jax_greens(kernel, jmesh), jmesh, overlap_chunks=0)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1), (2, 4)])
def test_solver_on_a_mesh_matches_jax_and_single_device(precision,
                                                        mesh_shape):
    grid = (16, 32, 24)
    real_t = get_real_t(precision)
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    rhs = np.random.default_rng(7).standard_normal(
        (3, *grid)).astype(NP_T[precision])
    mesh = create_mesh(3, mesh_shape, device="cpu")
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    jsolver = jax_poisson.UnboundedPoissonSolver3D(
        *grid, x_range=1.0, real_t=jax_t, mesh=jmesh)
    solver = UnboundedPoissonSolver3D(*grid, x_range=1.0, real_t=real_t,
                                      device="cpu", mesh=mesh,
                                      overlap_chunks=4)
    single = UnboundedPoissonSolver3D(*grid, x_range=1.0, real_t=real_t,
                                      device="cpu")
    assert solver.mesh is mesh
    assert not solver.fused_curl_supported(real_t, torch.device("cpu"))
    jg_dev = jsolver.fourier_greens_times_dx_pow_dim
    jg = np.asarray(jg_dev)
    own = solver.fourier_greens_times_dx_pow_dim
    assert own.dtype == real_t
    # the port transforms the float64 kernel in float64 and casts; the JAX
    # solver transforms in real_t
    _close(_fourier_global(own, mesh), jg, TOL[precision], "Green's")
    converted = sharded_greens_from_numpy(jg, mesh, device="cpu",
                                          dtype=real_t)
    jref = jax.jit(jsolver.vector_field_solve)(
        jax_mesh.shard_vector_field(jnp.asarray(rhs), jmesh), jg_dev)
    field = shard_vector_field(torch.tensor(rhs), mesh)
    out = unshard_vector_field(
        solver.vector_field_solve(field, converted), mesh).numpy()
    _close(out, jref, TOL[precision], "vector solve, converted Green's")
    own_out = unshard_vector_field(solver.vector_field_solve(field),
                                   mesh).numpy()
    _close(own_out, jref, TOL[precision], "vector solve, own Green's")
    _close(own_out, single.vector_field_solve(torch.tensor(rhs)).numpy(),
           TOL[precision], "vector solve against the single-device solver")
    scalar = unshard_scalar_field(
        solver.solve(shard_scalar_field(torch.tensor(rhs[2]), mesh)), mesh)
    _close(scalar.numpy(), jax.jit(jsolver.solve)(jax_mesh.shard_scalar_field(
        jnp.asarray(rhs[2]), jmesh), jg_dev), TOL[precision], "scalar solve")


def test_solver_option_checks_and_single_shard_mesh():
    kw = dict(x_range=1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UnboundedPoissonSolver3D(8, 8, 8, comm_bf16=True, **kw)
    with pytest.raises(ValueError, match="overlap_chunks"):
        UnboundedPoissonSolver3D(8, 8, 8, overlap_chunks=0, **kw)
    one = UnboundedPoissonSolver3D(
        8, 8, 8, mesh=create_mesh(3, (1, 1), device="cpu"), **kw)
    assert one.mesh is None  # a mesh of one shard is the single device
    ref = UnboundedPoissonSolver3D(8, 8, 8, **kw)
    rhs = torch.tensor(np.random.default_rng(8).standard_normal(
        (8, 8, 8)).astype(np.float32))
    assert torch.equal(one.solve(rhs), ref.solve(rhs))
    # the Fourier layout's sharded axes: y over "z", x-frequency over "y"
    mesh = create_mesh(3, (2, 2), device="cpu")
    g = torch.arange(4 * 4 * 8, dtype=torch.float64).reshape(4, 4, 8)
    s = shard_dims(g, mesh, dist.FOURIER_SHARDED_DIMS)
    assert torch.equal(s[1, 0], g[:, 2:, :4])
