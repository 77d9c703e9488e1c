"""The port's 2D free-space Poisson solver against the JAX package's on
both routes (dense, and the split-spectrum route with the JAX Pallas passes
in interpret mode and the port's passes as plain versions) and against the
direct Green's-function sum.

Tolerances: float64 relative ``1e-10``; float32 relative ``1e-5``, both
against the reference's largest magnitude (two float32 transform pipelines
of different factorisation, solve error ~1e-7 each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.poisson as jax_poisson
from sopht_mpi_tpu.ops import UnboundedPoissonSolver2D as JaxSolver
from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver2D
from sopht_mpi_tpu_torch.utils import get_real_t

RTOL = {"single": 1e-5, "double": 1e-10}
GRIDS = [(16, 16), (24, 40)]
KERNEL_GRIDS = [(32, 32), (32, 64), (48, 32)]


def _rel_close(out, ref, rtol, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err}"


def _solvers(grid, precision):
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    jax_solver = JaxSolver(*grid, x_range=1.0, real_t=jax_t)
    solver = UnboundedPoissonSolver2D(*grid, x_range=1.0,
                                      real_t=get_real_t(precision), device="cpu")
    return jax_solver, solver


@pytest.mark.parametrize("grid", GRIDS, ids=["16^2", "24x40"])
def test_dense_greens_and_solve_match_jax(grid, precision):
    jax_solver, solver = _solvers(grid, precision)
    ref = np.asarray(jax_solver.fourier_greens_times_dx_pow_dim)
    out = solver.fourier_greens_times_dx_pow_dim
    ny, nx = grid
    assert tuple(out.shape) == (2 * ny, nx + 1)
    assert out.dtype == get_real_t(precision)
    _rel_close(out, ref, RTOL[precision], "greens")
    np_t = np.float32 if precision == "single" else np.float64
    rhs = np.random.default_rng(5).standard_normal((2,) + grid).astype(np_t)
    _rel_close(solver.solve(torch.tensor(rhs[0])),
               np.asarray(jax_solver.solve(jnp.asarray(rhs[0]))),
               RTOL[precision], "solve")
    # a leading component axis is solved per component
    both = solver.solve(torch.tensor(rhs))
    _rel_close(both[1], np.asarray(jax_solver.solve(jnp.asarray(rhs[1]))),
               RTOL[precision], "batched solve")


def test_solve_matches_direct_sum():
    """The doubled-domain convolution equals the direct O(N^2) sum of
    ``G(r) rhs dx^2`` with G = -log(r)/(2 pi) and the regularised origin."""
    ny, nx = 10, 14
    solver = UnboundedPoissonSolver2D(ny, nx, x_range=1.0,
                                      real_t=torch.float64, device="cpu")
    dx = solver.dx
    rhs = np.random.default_rng(1).standard_normal((ny, nx))
    out = solver.solve(torch.tensor(rhs)).numpy()
    pts = np.stack(np.meshgrid(np.arange(ny) * dx, np.arange(nx) * dx,
                               indexing="ij"), -1).reshape(-1, 2)
    r = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    with np.errstate(divide="ignore"):
        g = -np.log(r) / (2 * np.pi)
    g[r == 0] = -(2.0 * np.log(dx / np.sqrt(np.pi)) - 1.0) / (4.0 * np.pi)
    ref = (g @ rhs.reshape(-1) * dx**2).reshape(ny, nx)
    _rel_close(out, ref, 1e-10, "direct sum")


@pytest.mark.parametrize("grid", KERNEL_GRIDS, ids=["32^2", "32x64", "48x32"])
def test_kernel_route_matches_jax_pallas_route(grid, monkeypatch):
    monkeypatch.setattr(jax_poisson, "FORCE_PALLAS_CONVOLVE", True)
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    jax_solver, solver = _solvers(grid, "single")
    ref_pair = jax_solver.fourier_greens_times_dx_pow_dim
    pair = solver.fourier_greens_times_dx_pow_dim
    assert isinstance(ref_pair, tuple) and isinstance(pair, tuple)
    scale = float(np.abs(np.asarray(ref_pair[0])).max())
    for out, ref, what in zip(pair, ref_pair, ("bulk", "side")):
        ref = np.asarray(ref)
        assert tuple(out.shape) == ref.shape, what
        err = np.abs(out.numpy().astype(np.float64) - ref).max()
        assert err <= RTOL["single"] * scale, f"greens {what}: {err}"
    rhs = np.random.default_rng(11).standard_normal((2,) + grid).astype(
        np.float32)
    assert solver.uses_kernel_route(torch.tensor(rhs))
    _rel_close(solver.solve(torch.tensor(rhs[0])),
               np.asarray(jax_solver.solve(jnp.asarray(rhs[0]))),
               RTOL["single"], "solve")


@pytest.mark.parametrize("grid", KERNEL_GRIDS, ids=["32^2", "32x64", "48x32"])
def test_kernel_route_matches_dense_route(grid, monkeypatch):
    rhs = torch.tensor(np.random.default_rng(7).standard_normal(
        (2,) + grid).astype(np.float32))
    dense_solver = UnboundedPoissonSolver2D(*grid, device="cpu")
    assert not dense_solver.uses_kernel_route(rhs)
    ref = dense_solver.solve(rhs)
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    solver = UnboundedPoissonSolver2D(*grid, device="cpu")
    bulk, side = solver.fourier_greens_times_dx_pow_dim
    assert tuple(bulk.shape) == (2 * grid[0], grid[1])
    assert tuple(side.shape) == (2 * grid[0],)
    _rel_close(solver.solve(rhs), ref.numpy(), 1e-5, "batched")
    _rel_close(solver.solve(rhs[1]), ref[1].numpy(), 1e-5, "single field")
    # a dense spectrum passed explicitly is split on the way in
    _rel_close(solver.solve(rhs[0],
                            dense_solver.fourier_greens_times_dx_pow_dim),
               ref[0].numpy(), 1e-5, "dense greens argument")
    # float64 stays on the dense route, with the pair reassembled
    assert not solver.uses_kernel_route(rhs.double())
    _rel_close(solver._dense_greens(),
               dense_solver.fourier_greens_times_dx_pow_dim.numpy(), 0.0,
               "reassembled")


def test_fast_spectral_is_inert_in_2d():
    rhs = torch.tensor(np.random.default_rng(2).standard_normal(
        (16, 16)).astype(np.float32))
    plain = UnboundedPoissonSolver2D(16, 16, device="cpu")
    fast = UnboundedPoissonSolver2D(16, 16, device="cpu", fast_spectral=True)
    assert fast.fast_spectral and not plain.fast_spectral
    assert torch.equal(fast.solve(rhs), plain.solve(rhs))


@pytest.mark.cuda
def test_kernel_route_on_card_matches_dense():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    grid = (256, 512)
    rhs = torch.tensor(np.random.default_rng(3).standard_normal(grid).astype(
        np.float32), device="cuda")
    solver = UnboundedPoissonSolver2D(*grid, device="cuda")
    assert solver.uses_kernel_route(rhs)
    out = solver.solve(rhs)
    ref = torch.fft.irfftn(
        torch.fft.rfftn(rhs, s=solver.doubled) * solver._dense_greens(),
        s=solver.doubled)[: grid[0], : grid[1]]
    _rel_close(out.cpu(), ref.cpu().numpy(), 1e-5, "card")
