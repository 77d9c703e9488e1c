"""Unbounded (free-space) 3D Poisson solver via Green's-function convolution
(counterpart of ``UnboundedPoissonSolver3D`` in ``sopht_mpi_tpu/ops/poisson.py``,
single device).

Hockney-Eastwood domain doubling: the right-hand side is zero-padded to
(2nz, 2ny, 2nx), multiplied in Fourier space by the real spectrum of the
even-reflected Green's function ``1/(4 pi r)``, and the first (nz, ny, nx)
cells of the inverse are kept. Solves ``-del^2(solution) = rhs``.

The doubled-domain transforms are ``torch.fft`` (the place XLA's FFT holds
in the JAX package when its Pallas convolve is off). The Green's spectrum
is built as the JAX package builds it: the half-grid kernel in float64 on
the host, then per-axis symmetric DFTs (DCT-I) - contracted here in float64
on the target device and cast - and stored dense, (2nz, 2ny, nx+1).
"""

from __future__ import annotations

import numpy as np
import torch


def _even_reflected_axis_dist(n_doubled: int, dx: float, axis_range: float, dtype):
    """Per-axis distance ``min(x, 2 L - x)`` on the doubled grid."""
    x = np.arange(n_doubled, dtype=np.float64) * dx
    return np.minimum(x, 2.0 * axis_range - x).astype(dtype)


def _build_greens_kernel(axis_dists, compute_greens, regularized_origin, dtype):
    """Real-space Green's function from per-axis distance vectors, built on
    the host in float64 (``compute_greens(xp, r)`` maps distances to kernel
    values with the array module ``xp``)."""
    nd = len(axis_dists)
    sq = sum(
        np.asarray(d, np.float64).reshape((-1,) + (1,) * (nd - 1 - i)) ** 2
        for i, d in enumerate(axis_dists)
    )
    with np.errstate(divide="ignore"):
        g = compute_greens(np, np.sqrt(sq))
    g[(0,) * nd] = regularized_origin
    return g.astype(dtype)


def _fourier_greens_from_half(greens_half: np.ndarray, scale: float,
                              dtype: torch.dtype, device) -> torch.Tensor:
    """Dense Fourier Green's function from the HALF-grid kernel (N+1
    points per axis) via per-axis symmetric DFTs, exploiting the even
    reflection g[n] = g[2N - n]:

        Ghat[k] = g[0] + (-1)^k g[N] + 2 sum_{n=1}^{N-1} g[n] cos(pi n k / N)

    then expanded to the doubled length on every axis but the last (kept at
    N+1 by rfft symmetry). Contracted in float64, then cast to ``dtype``."""
    h = torch.as_tensor(greens_half, dtype=torch.float64, device=device)
    nd = h.ndim
    for ax in range(nd):
        n_half = greens_half.shape[ax]
        n = np.arange(n_half, dtype=np.float64)[:, None]
        k = np.arange(n_half, dtype=np.float64)[None, :]
        w = np.full((n_half, 1), 2.0)
        w[0, 0] = 1.0
        w[-1, 0] = 1.0
        mat = torch.as_tensor(
            w * np.cos(np.pi * n * k / (n_half - 1)), device=device
        )
        h = torch.movedim(
            torch.tensordot(torch.movedim(h, ax, -1), mat, dims=1), -1, ax
        )
    for ax in range(nd - 1):
        tail = torch.flip(h.narrow(ax, 1, h.shape[ax] - 2), dims=(ax,))
        h = torch.cat([h, tail], dim=ax)
    return (h * scale).to(dtype).contiguous()


class UnboundedPoissonSolver3D:
    """Free-space Poisson solver on a 3D (nz, ny, nx) grid on one device.

    Green's function ``1/(4 pi r)`` with origin regularization
    ``1/(4 pi dx)``.
    """

    grid_dim = 3

    def __init__(self, grid_size_z, grid_size_y, grid_size_x, x_range=1.0,
                 real_t=torch.float32, device="cpu"):
        self.grid_size_z = grid_size_z
        self.grid_size_y = grid_size_y
        self.grid_size_x = grid_size_x
        self.x_range = x_range
        self.y_range = x_range * (grid_size_y / grid_size_x)
        self.z_range = x_range * (grid_size_z / grid_size_x)
        self.dx = float(x_range / grid_size_x)
        self.real_t = real_t
        self.device = torch.device(device)

        dz = _even_reflected_axis_dist(
            2 * grid_size_z, self.dx, self.z_range, np.float64
        )
        dy = _even_reflected_axis_dist(
            2 * grid_size_y, self.dx, self.y_range, np.float64
        )
        dxs = _even_reflected_axis_dist(
            2 * grid_size_x, self.dx, self.x_range, np.float64
        )
        half = _build_greens_kernel(
            (dz[: grid_size_z + 1], dy[: grid_size_y + 1],
             dxs[: grid_size_x + 1]),
            lambda xp, r: 1.0 / (4.0 * np.pi * r),
            1.0 / (4.0 * np.pi * self.dx),
            np.float64,
        )
        self.fourier_greens_times_dx_pow_dim = _fourier_greens_from_half(
            half, self.dx**self.grid_dim, real_t, self.device
        )

    @property
    def doubled(self) -> tuple[int, int, int]:
        return (2 * self.grid_size_z, 2 * self.grid_size_y, 2 * self.grid_size_x)

    def solve(self, rhs_field, greens=None):
        """Solve ``-del^2(solution) = rhs`` for a (nz, ny, nx) field, or
        for each component of a (c, nz, ny, nx) field. ``greens`` defaults
        to ``self.fourier_greens_times_dx_pow_dim``. Returns a contiguous
        tensor of the input's shape."""
        if greens is None:
            greens = self.fourier_greens_times_dx_pow_dim
        nz, ny, nx = self.grid_size_z, self.grid_size_y, self.grid_size_x
        fhat = torch.fft.rfftn(rhs_field, s=self.doubled, dim=(-3, -2, -1))
        sol = torch.fft.irfftn(fhat * greens, s=self.doubled, dim=(-3, -2, -1))
        return sol[..., :nz, :ny, :nx].contiguous()

    def vector_field_solve(self, rhs_vector_field, greens=None):
        """Component-wise solve for a (3, nz, ny, nx) vector field, the
        components batched through one transform."""
        return self.solve(rhs_vector_field, greens)
