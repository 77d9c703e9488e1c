"""The port's free-space Poisson solver against the JAX package's (dense
Green's spectrum on CPU, where the Pallas convolve is off) and against the
direct Green's-function sum.

Tolerances: float64 relative ``1e-10``; float32 relative ``1e-5``, both
against the reference's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.ops import UnboundedPoissonSolver3D as JaxSolver
from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver3D
from sopht_mpi_tpu_torch.utils import get_real_t

RTOL = {"single": 1e-5, "double": 1e-10}
GRIDS = [(16, 16, 16), (12, 16, 20)]


def _rel_close(out, ref, rtol, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err}"


def _solvers(grid, precision):
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    jax_solver = JaxSolver(*grid, x_range=1.0, real_t=jax_t)
    solver = UnboundedPoissonSolver3D(*grid, x_range=1.0,
                                      real_t=get_real_t(precision), device="cpu")
    return jax_solver, solver


@pytest.mark.parametrize("grid", GRIDS, ids=["16^3", "12x16x20"])
def test_greens_spectrum_matches_jax(grid, precision):
    jax_solver, solver = _solvers(grid, precision)
    ref = np.asarray(jax_solver.fourier_greens_times_dx_pow_dim)
    out = solver.fourier_greens_times_dx_pow_dim
    nz, ny, nx = grid
    assert tuple(out.shape) == (2 * nz, 2 * ny, nx + 1)
    assert out.dtype == get_real_t(precision)
    _rel_close(out, ref, RTOL[precision], "greens")


@pytest.mark.parametrize("grid", GRIDS, ids=["16^3", "12x16x20"])
def test_solve_and_vector_solve_match_jax(grid, precision):
    jax_solver, solver = _solvers(grid, precision)
    np_t = np.float32 if precision == "single" else np.float64
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((3,) + grid).astype(np_t)
    ref = np.asarray(jax_solver.vector_field_solve(jnp.asarray(rhs)))
    out = solver.vector_field_solve(torch.tensor(rhs))
    _rel_close(out, ref, RTOL[precision], "vector_field_solve")
    _rel_close(solver.solve(torch.tensor(rhs[1])),
               np.asarray(jax_solver.solve(jnp.asarray(rhs[1]))),
               RTOL[precision], "solve")
    # an explicit Green's function argument is the stored one
    _rel_close(solver.solve(torch.tensor(rhs[2]),
                            solver.fourier_greens_times_dx_pow_dim),
               np.asarray(jax_solver.solve(jnp.asarray(rhs[2]))),
               RTOL[precision], "solve(greens=)")


def test_solve_matches_direct_sum():
    """The doubled-domain convolution equals the direct O(N^2) sum of
    ``G(r) rhs dx^3`` with G = 1/(4 pi r), G(0) = 1/(4 pi dx)."""
    n = 8
    solver = UnboundedPoissonSolver3D(n, n, n, x_range=1.0,
                                      real_t=torch.float64, device="cpu")
    dx = solver.dx
    rhs = np.random.default_rng(1).standard_normal((n, n, n))
    out = solver.solve(torch.tensor(rhs)).numpy()
    idx = np.arange(n) * dx
    pts = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), -1).reshape(-1, 3)
    r = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    with np.errstate(divide="ignore"):
        g = 1.0 / (4 * np.pi * r)
    g[r == 0] = 1.0 / (4 * np.pi * dx)
    ref = (g @ rhs.reshape(-1) * dx**3).reshape(n, n, n)
    _rel_close(out, ref, 1e-10, "direct sum")


@pytest.mark.parametrize("grid", [(32, 32, 32), (32, 32, 64)],
                         ids=["32^3", "32x32x64"])
def test_kernel_route_matches_jax_pallas_route(grid, monkeypatch):
    """Both packages forced onto their split-spectrum route (the JAX Pallas
    convolve in interpret mode, the port's FFT passes as plain versions):
    the (bulk, side) Green's pair and the vector solve agree to 1e-5
    relative."""
    import sopht_mpi_tpu.ops.poisson as jax_poisson
    from sopht_mpi_tpu_torch.ops import poisson

    monkeypatch.setattr(jax_poisson, "FORCE_PALLAS_CONVOLVE", True)
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    jax_solver, solver = _solvers(grid, "single")
    ref_pair = jax_solver.fourier_greens_times_dx_pow_dim
    pair = solver.fourier_greens_times_dx_pow_dim
    assert isinstance(ref_pair, tuple) and isinstance(pair, tuple)
    # the pair is two slices of the dense spectrum: each is held to the
    # dense test's bound, 1e-5 of the whole spectrum's largest magnitude
    scale = float(np.abs(np.asarray(ref_pair[0])).max())
    for out, ref, what in zip(pair, ref_pair, ("bulk", "side")):
        ref = np.asarray(ref)
        assert tuple(out.shape) == ref.shape, what
        err = np.abs(out.numpy().astype(np.float64) - ref).max()
        assert err <= RTOL["single"] * scale, f"greens {what}: {err}"
    rhs = np.random.default_rng(11).standard_normal((3,) + grid).astype(
        np.float32)
    ref = np.asarray(jax_solver.vector_field_solve(jnp.asarray(rhs)))
    _rel_close(solver.vector_field_solve(torch.tensor(rhs)), ref,
               RTOL["single"], "vector_field_solve")
