"""Unbounded (free-space) 2D and 3D Poisson solvers via Green's-function
convolution (counterparts of ``UnboundedPoissonSolver2D`` and
``UnboundedPoissonSolver3D`` in ``sopht_mpi_tpu/ops/poisson.py``; single
device, and the 3D solver also on a (pz, py) mesh of shards).

Hockney-Eastwood domain doubling: the right-hand side is zero-padded to
(2nz, 2ny, 2nx), multiplied in Fourier space by the real spectrum of the
even-reflected Green's function ``1/(4 pi r)``, and the first (nz, ny, nx)
cells of the inverse are kept. Solves ``-del^2(solution) = rhs``.

Two routes, selected as the JAX package selects its own:

- the kernel route (counterpart of the Pallas convolve,
  ``_pallas_convolve_local``): float32, every doubled axis length passing
  :func:`~sopht_mpi_tpu_torch.parallel.cuda_fft.kernel_fft_supported`, and
  a CUDA device (or ``FORCE_KERNEL_CONVOLVE``). The five split real/imag
  passes of :mod:`sopht_mpi_tpu_torch.parallel.cuda_fft` run x r2c, y
  forward, z forward x Green's x z inverse, y inverse and x c2r; the kx
  Nyquist column is convolved on a small ``torch.fft`` side path. The
  Green's spectrum is stored as the (bulk, side) pair the route consumes.
- otherwise the dense route: ``torch.fft`` rfftn/irfftn on the doubled
  grid (where XLA's FFT serves the JAX package), with the dense spectrum.

With ``cuda_fft.USE_FUSED_EDGE_PASSES`` on (default off, as in the JAX
package), the 3D kernel route swaps its four edge passes for the two fused
ones (``rfft_fft_pass_fused``, ``ifft_irfft_pass_fused``); the fused-curl
route keeps the unfused edges.

The 2D solver (Green's function ``-log(r)/(2 pi)``) takes the same two
routes. Its kernel route runs three passes: x r2c split on (c*ny, nx) rows,
the y pass ``fft_greens_ifft_pass`` on (c, ny, mx/2) with the bulk Green's
spectrum as (1, my, mx/2), and the c2r merge; the Nyquist column again on
``torch.fft``.

The Green's spectrum is built as the JAX package builds it: the half-grid
kernel in float64 on the host, then per-axis symmetric DFTs (DCT-I) -
contracted here in float64 on the target device and cast - giving the
dense (2nz, 2ny, nx+1) real spectrum.

On a mesh of more than one shard (``mesh=``, 3D only) fields and the
Green's spectrum are sharded (:mod:`sopht_mpi_tpu_torch.parallel.mesh`):
the full doubled kernel goes through
:func:`~sopht_mpi_tpu_torch.parallel.fft.distributed_rfftn` once, its real
part times dx^3 is stored dense in the Fourier layout, and the solves are
:func:`~sopht_mpi_tpu_torch.parallel.fft.distributed_free_space_convolve`.

The fast spectral tier (``fast_spectral=True``, counterpart of the JAX
package's) recovers the velocity of a vorticity field in one pipeline,
:meth:`UnboundedPoissonSolver3D.velocity_from_vorticity_fused`: the
central-difference curl is mixed into the z pass as the spectral symbols
``i sin(2 pi k / M) / dx``, and the wall-ring zeroing, the free-stream add
and ``max |u|_1`` ride the final c2r pass, so the streamfunction and the
curl pass never exist. The JAX tier also swaps its matmuls to 3-pass bf16;
the port's passes stay plain FP32, so the tier keeps the exact tier's
solve error.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft
from sopht_mpi_tpu_torch.parallel import fft as _dist
from sopht_mpi_tpu_torch.parallel.mesh import shard_scalar_field

# Tests force the kernel route on CPU tensors (the passes then run their
# plain versions): None = auto (on for a CUDA device), True/False = override.
FORCE_KERNEL_CONVOLVE: bool | None = None

# Construction-time default of the solvers' ``fast_spectral`` parameter
# (a None argument takes this value), set with
# ``sopht_mpi_tpu_torch.enable_fast_spectral``. Read only when a solver is
# built: built solvers keep their mode. None resolves to False on every
# device (the JAX package's resolution off the TPU).
DEFAULT_FAST_SPECTRAL: bool | None = None


def resolve_fast_spectral(flag: bool | None) -> bool:
    """A solver's ``fast_spectral`` argument: an explicit bool wins, then
    ``DEFAULT_FAST_SPECTRAL``; unset, False."""
    if flag is not None:
        return bool(flag)
    return bool(DEFAULT_FAST_SPECTRAL)


# cells above which the vector solve runs the components one after another
# through the kernel route instead of batching them (512^3 class)
_COMPONENT_MAP_THRESHOLD = 2**27


def _kernel_convolve_supported(doubled, dtype, device) -> bool:
    """The kernel route: float32, a CUDA device unless
    ``FORCE_KERNEL_CONVOLVE`` says otherwise, and every doubled axis length
    supported by the FFT-pass kernels (at most 1024: the JAX gate's cap on
    the minor axis, applied to every axis)."""
    device_ok = (
        torch.device(device).type == "cuda"
        if FORCE_KERNEL_CONVOLVE is None
        else FORCE_KERNEL_CONVOLVE
    )
    return (
        bool(device_ok)
        and dtype == torch.float32
        and all(cuda_fft.kernel_fft_supported(m) for m in doubled)
    )


def split_kernel_greens(greens):
    """Split a dense real Fourier Green's function (.., fx) into the
    contiguous (bulk, nyquist-column) pair the kernel route consumes
    (``split_pallas_greens``)."""
    return greens[..., :-1].contiguous(), greens[..., -1].contiguous()


def _kernel_convolve_local(rhs, greens, doubled):
    """Free-space convolution through the FFT-pass kernels
    (``_pallas_convolve_local``). ``rhs`` is a field on the grid of
    ``len(doubled)`` axes, or carries a leading component axis that is
    folded into the kernels' batch axis; ``greens`` is the pair of
    :func:`split_kernel_greens`. In 3D the edge passes are the fused ones
    where :func:`~sopht_mpi_tpu_torch.parallel.cuda_fft.fused_edge_pass_ok`."""
    g_bulk, g_side = greens
    nd = len(doubled)
    batched = rhs.ndim == nd + 1
    if not batched:
        rhs = rhs[None]
    c = rhs.shape[0]
    mx = doubled[-1]
    bx = mx // 2

    def side_pair(s, rows):
        return (s.real.reshape(*rows, 1).contiguous(),
                s.imag.reshape(*rows, 1).contiguous())

    if nd == 2:
        ny, nx = rhs.shape[1:]
        my = doubled[0]
        fr, fi, sr, si = cuda_fft.rfft_pass_padded_split(
            rhs.reshape(c * ny, nx), mx)
        fr, fi = cuda_fft.fft_greens_ifft_pass(
            fr.view(c, ny, bx), fi.view(c, ny, bx), g_bulk.view(1, my, bx))
        # kx Nyquist column, (c, ny) complex, on torch.fft
        s = torch.complex(sr, si).reshape(c, ny)
        s = torch.fft.fft(s, n=my, dim=1) * g_side
        s = torch.fft.ifft(s, dim=1)[:, :ny]
        sol = cuda_fft.irfft_pass_merge(
            fr.view(c * ny, bx), fi.view(c * ny, bx),
            *side_pair(s, (c * ny,)), mx, nx,
        ).view(c, ny, nx)
        return sol if batched else sol[0]

    nz, ny, nx = rhs.shape[1:]
    mz, my = doubled[0], doubled[1]
    fused_edges = cuda_fft.fused_edge_pass_ok(ny, nx, my, mx)
    if fused_edges:
        # (c*nz, my, bx) bulk pair + (c*nz, ny, 1) side pair
        fr, fi, sr, si = cuda_fft.rfft_fft_pass_fused(
            rhs.reshape(c * nz, ny, nx), mx, my)
    else:
        fr, fi, sr, si = cuda_fft.rfft_pass_padded_split(
            rhs.reshape(c * nz * ny, nx), mx)
        fr, fi = cuda_fft.fft_pass_padded(
            fr.view(c * nz, ny, bx), fi.view(c * nz, ny, bx), my)
    fr, fi = cuda_fft.fft_greens_ifft_pass(
        fr.view(c, nz, my * bx), fi.view(c, nz, my * bx),
        g_bulk.view(1, mz, my * bx))
    # kx Nyquist column, (c, nz, ny) complex, on torch.fft
    s = torch.complex(sr, si).reshape(c, nz, ny)
    s = torch.fft.fft(s, n=my, dim=2)
    s = torch.fft.fft(s, n=mz, dim=1)
    s = s * g_side
    s = torch.fft.ifft(s, dim=1)[:, :nz]
    s = torch.fft.ifft(s, dim=2)[:, :, :ny]
    if fused_edges:
        sol = cuda_fft.ifft_irfft_pass_fused(
            fr.view(c * nz, my, bx), fi.view(c * nz, my, bx),
            *side_pair(s, (c * nz, ny)), mx, nx,
        ).view(c, nz, ny, nx)
    else:
        fr, fi = cuda_fft.ifft_pass_truncated(
            fr.view(c * nz, my, bx), fi.view(c * nz, my, bx))
        sol = cuda_fft.irfft_pass_merge(
            fr.view(c * nz * ny, bx), fi.view(c * nz * ny, bx),
            *side_pair(s, (c * nz * ny,)), mx, nx,
        ).view(c, nz, ny, nx)
    return sol if batched else sol[0]


def _curl_symbol(m: int, dx: float, device) -> torch.Tensor:
    """``sin(2 pi k / m) / dx`` for k < m in float32 on ``device``, the
    symbol of the width-2 central difference on a periodic axis of m
    cells."""
    k = torch.arange(m, dtype=torch.float32, device=device)
    return torch.sin(2.0 * math.pi * k / m) / dx


def _curl_symbols(doubled, dx, device):
    """The fused route's curl symbols on ``device``: ``sym_z`` (mz,),
    ``sym_y`` (my,) and ``sym_yx`` (2, my*bx), the B-major axis (ky), then
    the B-minor one (bulk kx, k < mx/2)."""
    mz, my, mx = doubled
    bx = mx // 2
    sym_y = _curl_symbol(my, dx, device)
    sym_x = _curl_symbol(mx, dx, device)[:bx]
    sym_yx = torch.stack([sym_y.repeat_interleave(bx), sym_x.repeat(my)])
    return _curl_symbol(mz, dx, device), sym_y, sym_yx


def _kernel_convolve_curl_local(rhs, greens, doubled, symbols, free_stream):
    """Velocity recovery ``u = FD-curl(G * omega)`` (wall ring zeroed)
    ``+ free_stream`` through the FFT-pass kernels, with ``max |u|_1``
    (``_pallas_convolve_curl_local``): x r2c split, y forward, the z pass
    with the curl mixed in (``fft_greens_curl_ifft_pass``), the kx Nyquist
    column's curl on ``torch.fft``, y inverse, and the c2r merge with the
    ring / free-stream / max epilogue (``irfft_pass_merge_velocity``).
    ``rhs`` is the (3, nz, ny, nx) vorticity, ``symbols`` those of
    :func:`_curl_symbols`; returns ``(u, l1_max)``."""
    g_bulk, g_side = greens
    sym_z, sym_y, sym_yx = symbols
    c, nz, ny, nx = rhs.shape
    mz, my, mx = doubled
    bx = mx // 2
    fr, fi, sr, si = cuda_fft.rfft_pass_padded_split(
        rhs.reshape(c * nz * ny, nx), mx)
    fr, fi = cuda_fft.fft_pass_padded(
        fr.view(c * nz, ny, bx), fi.view(c * nz, ny, bx), my)
    fr, fi = cuda_fft.fft_greens_curl_ifft_pass(
        fr.view(c, nz, my * bx), fi.view(c, nz, my * bx),
        g_bulk.view(1, mz, my * bx), sym_z, sym_yx)

    # kx Nyquist column: its x symbol sin(pi) is 0, so no x term enters
    s = torch.complex(sr, si).reshape(c, nz, ny)
    s = torch.fft.fft(s, n=my, dim=2)
    s = torch.fft.fft(s, n=mz, dim=1)
    psi = s * g_side  # (3, mz, my)
    szc = sym_z.view(mz, 1)
    syc = sym_y.view(1, my)
    s = 1j * torch.stack([
        syc * psi[2] - szc * psi[1],
        szc * psi[0],
        -syc * psi[0],
    ])
    s = torch.fft.ifft(s, dim=1)[:, :nz]
    s = torch.fft.ifft(s, dim=2)[:, :, :ny]

    fr, fi = cuda_fft.ifft_pass_truncated(
        fr.view(c * nz, my, bx), fi.view(c * nz, my, bx))
    u, l1_max = cuda_fft.irfft_pass_merge_velocity(
        fr.view(c, nz * ny, bx), fi.view(c, nz * ny, bx),
        s.real.reshape(c, nz * ny, 1).contiguous(),
        s.imag.reshape(c, nz * ny, 1).contiguous(),
        free_stream, mx, nx, ny, nz,
    )
    return u.view(c, nz, ny, nx), l1_max


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


class _UnboundedPoissonSolver:
    """What the 2D and 3D solvers share: the stored Green's spectrum (dense,
    or the kernel route's (bulk, side) pair), the route choice and the two
    convolutions. Subclasses give ``grid_dim``, ``grid_size`` (slow axis
    first) and build the half-grid Green's kernel."""

    grid_dim: int

    def _init_greens(self, greens_half: np.ndarray):
        dense = _fourier_greens_from_half(
            greens_half, self.dx**self.grid_dim, self.real_t, self.device
        )
        if _kernel_convolve_supported(self.doubled, self.real_t, self.device):
            self.fourier_greens_times_dx_pow_dim = split_kernel_greens(dense)
        else:
            self.fourier_greens_times_dx_pow_dim = dense

    @property
    def doubled(self) -> tuple[int, ...]:
        return tuple(2 * n for n in self.grid_size)

    def _dense_greens(self, greens=None):
        """The dense (.., fx) real Fourier Green's function, reassembled
        from the split pair if that is the stored form."""
        if greens is None:
            greens = self.fourier_greens_times_dx_pow_dim
        if isinstance(greens, tuple):
            bulk, side = greens
            return torch.cat([bulk, side[..., None]], dim=-1)
        return greens

    def uses_kernel_route(self, rhs_field) -> bool:
        """Whether a solve of ``rhs_field`` takes the kernel route."""
        return _kernel_convolve_supported(
            self.doubled, rhs_field.dtype, rhs_field.device)

    def solve(self, rhs_field, greens=None):
        """Solve ``-del^2(solution) = rhs`` for a field on the grid, or for
        each component of a field with a leading component axis. ``greens``
        defaults to ``self.fourier_greens_times_dx_pow_dim``, dense or
        split. Returns a contiguous tensor of the input's shape."""
        if greens is None:
            greens = self.fourier_greens_times_dx_pow_dim
        if self.uses_kernel_route(rhs_field):
            if not isinstance(greens, tuple):
                greens = split_kernel_greens(greens)
            return _kernel_convolve_local(
                rhs_field.contiguous(), greens, self.doubled)
        dims = tuple(range(-self.grid_dim, 0))
        fhat = torch.fft.rfftn(rhs_field, s=self.doubled, dim=dims)
        sol = torch.fft.irfftn(fhat * self._dense_greens(greens),
                               s=self.doubled, dim=dims)
        keep = (Ellipsis, *(slice(0, n) for n in self.grid_size))
        return sol[keep].contiguous()


class UnboundedPoissonSolver2D(_UnboundedPoissonSolver):
    """Free-space Poisson solver on a 2D (ny, nx) grid on one device.

    Green's function ``-log(r)/(2 pi)`` with the origin regularization
    ``-(2 log(dx/sqrt(pi)) - 1)/(4 pi)``.

    :param device: the torch device of the Green's spectrum; required, no
        default is taken from the environment.
    :param fast_spectral: accepted and stored; it changes nothing in 2D
        (the JAX tier's only 2D effect is the precision of its matmuls).
    """

    grid_dim = 2

    def __init__(self, grid_size_y, grid_size_x, x_range=1.0,
                 real_t=torch.float32, *, device,
                 fast_spectral: bool | None = None):
        self.grid_size_y = grid_size_y
        self.grid_size_x = grid_size_x
        self.fast_spectral = resolve_fast_spectral(fast_spectral)
        self.x_range = x_range
        self.y_range = x_range * (grid_size_y / grid_size_x)
        self.dx = float(x_range / grid_size_x)
        self.real_t = real_t
        self.device = torch.device(device)

        dy = _even_reflected_axis_dist(
            2 * grid_size_y, self.dx, self.y_range, np.float64
        )
        dxs = _even_reflected_axis_dist(
            2 * grid_size_x, self.dx, self.x_range, np.float64
        )
        self._init_greens(_build_greens_kernel(
            (dy[: grid_size_y + 1], dxs[: grid_size_x + 1]),
            lambda xp, r: -xp.log(r) / (2.0 * np.pi),
            -(2.0 * np.log(self.dx / np.sqrt(np.pi)) - 1.0) / (4.0 * np.pi),
            np.float64,
        ))

    @property
    def grid_size(self) -> tuple[int, int]:
        return (self.grid_size_y, self.grid_size_x)


class UnboundedPoissonSolver3D(_UnboundedPoissonSolver):
    """Free-space Poisson solver on a 3D (nz, ny, nx) grid on one device.

    Green's function ``1/(4 pi r)`` with origin regularization
    ``1/(4 pi dx)``.

    :param device: the torch device of the Green's spectrum; required, no
        default is taken from the environment.
    :param fast_spectral: the fast spectral tier (velocity recovery through
        :meth:`velocity_from_vorticity_fused` where
        :meth:`fused_curl_supported`); None takes ``DEFAULT_FAST_SPECTRAL``.
        Accepted and inert on a mesh, which never takes the fused route.
    :param mesh: a 3D mesh from ``parallel.create_mesh(3, (pz, py))``. With
        more than one shard the solver takes and returns sharded fields,
        (pz, py, [c,] nz/pz, ny/py, nx), and stores the Green's spectrum
        dense in the sharded Fourier layout; a mesh of one shard is the
        single-device solver.
    :param overlap_chunks: the JAX package's comm/compute pipelining request
        of the distributed convolve: any value >= 1 (or None) is accepted
        and one chunk is realised.
    :param comm_bf16: the JAX package's bf16 wire format of the transposes;
        True is refused.
    """

    grid_dim = 3
    mesh = None  # the single-device solver, unless the constructor is given one

    def __init__(self, grid_size_z, grid_size_y, grid_size_x, x_range=1.0,
                 real_t=torch.float32, *, device,
                 fast_spectral: bool | None = None, mesh=None,
                 overlap_chunks: int | None = None, comm_bf16: bool = False):
        if comm_bf16:
            raise NotImplementedError(
                "comm_bf16=True is not ported (ROADMAP.md, 'Do not port': "
                "the bf16 wire format of the TPU transposes)")
        if overlap_chunks is not None and overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks must be >= 1 (got {overlap_chunks}); "
                "pass 1 to disable the comm/compute pipeline")
        self.overlap_chunks = overlap_chunks
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.grid_size_z = grid_size_z
        self.grid_size_y = grid_size_y
        self.grid_size_x = grid_size_x
        self.fast_spectral = resolve_fast_spectral(fast_spectral)
        self._symbols = {}  # the fused route's curl symbols, by device
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
        compute = lambda xp, r: 1.0 / (4.0 * np.pi * r)
        origin = 1.0 / (4.0 * np.pi * self.dx)
        if self.mesh is None:
            self._init_greens(_build_greens_kernel(
                (dz[: grid_size_z + 1], dy[: grid_size_y + 1],
                 dxs[: grid_size_x + 1]), compute, origin, np.float64,
            ))
        else:
            # the full doubled kernel, built on the host in float64, feeds
            # the distributed transform (in float64, then cast: the
            # single-device spectrum is contracted in float64 too)
            kernel = torch.as_tensor(
                _build_greens_kernel((dz, dy, dxs), compute, origin,
                                     np.float64),
                device=self.device)
            ghat = _dist.distributed_rfftn(
                shard_scalar_field(kernel, self.mesh), self.mesh)
            self.fourier_greens_times_dx_pow_dim = (
                ghat.real * self.dx**3).to(self.real_t).contiguous()

    @property
    def grid_size(self) -> tuple[int, int, int]:
        return (self.grid_size_z, self.grid_size_y, self.grid_size_x)

    def uses_kernel_route(self, rhs_field) -> bool:
        """Whether a solve of ``rhs_field`` takes the single-device kernel
        route (never on a mesh: the distributed convolve chooses its passes
        itself)."""
        return self.mesh is None and super().uses_kernel_route(rhs_field)

    def solve(self, rhs_field, greens=None):
        """Solve ``-del^2(solution) = rhs``; on a mesh for a sharded field
        (pz, py, [c,] nz/pz, ny/py, nx) through
        :func:`~sopht_mpi_tpu_torch.parallel.fft.distributed_free_space_convolve`
        (``greens`` then in the sharded Fourier layout)."""
        if self.mesh is None:
            return super().solve(rhs_field, greens)
        if greens is None:
            greens = self.fourier_greens_times_dx_pow_dim
        return _dist.distributed_free_space_convolve(
            rhs_field, greens, self.mesh, fast=self.fast_spectral,
            overlap_chunks=self.overlap_chunks)

    def vector_field_solve(self, rhs_vector_field, greens=None):
        """Component-wise solve for a (3, nz, ny, nx) vector field: the
        components batched through one pipeline, or, on the kernel route
        at ``nz*ny*nx >= 2**27`` (512^3 class, where the batched spectra
        outgrow device memory), one component after another. On a mesh the
        components fold into every transpose of the distributed convolve."""
        if (
            self.uses_kernel_route(rhs_vector_field)
            and self.grid_size_z * self.grid_size_y * self.grid_size_x
            >= _COMPONENT_MAP_THRESHOLD
        ):
            return torch.stack([self.solve(f, greens) for f in rhs_vector_field])
        return self.solve(rhs_vector_field, greens)

    def fused_curl_supported(self, dtype, device) -> bool:
        """Whether :meth:`velocity_from_vorticity_fused` applies to a field
        of ``dtype`` on ``device``: the kernel route with the components
        batched (below the 512^3-class threshold, where the component loop
        cannot mix them), and no mesh. The JAX gate's VMEM tile checks
        (``conv_curl_pass_tile_ok``, ``merge_velocity_epilogue_ok``) have
        no counterpart: the kernels take every length of the route."""
        nz, ny, nx = self.grid_size_z, self.grid_size_y, self.grid_size_x
        return (
            self.mesh is None
            and _kernel_convolve_supported(self.doubled, dtype, device)
            and nz * ny * nx < _COMPONENT_MAP_THRESHOLD
        )

    def velocity_from_vorticity_fused(self, vorticity, greens=None,
                                      free_stream=None):
        """Biot-Savart velocity recovery without the streamfunction:
        ``u = FD-curl(G * omega)`` (width-1 wall ring zeroed) ``+
        free_stream``, and the global ``max |u|_1`` as a 0-d tensor (see
        :func:`_kernel_convolve_curl_local`). Equal in exact arithmetic to
        ``curl_3d(vector_field_solve(omega), 0.5/dx) + free_stream``. Only
        valid where :meth:`fused_curl_supported`; returns ``(u, l1_max)``."""
        if not self.fused_curl_supported(vorticity.dtype, vorticity.device):
            raise ValueError(
                "velocity_from_vorticity_fused needs the kernel route "
                f"(float32, supported lengths {self.doubled}) below the "
                "512^3-class threshold; see fused_curl_supported"
            )
        if greens is None:
            greens = self.fourier_greens_times_dx_pow_dim
        if not isinstance(greens, tuple):
            greens = split_kernel_greens(greens)
        if free_stream is None:
            free_stream = torch.zeros(3, dtype=vorticity.dtype,
                                      device=vorticity.device)
        key = str(vorticity.device)
        if key not in self._symbols:  # built once a device, on it
            self._symbols[key] = _curl_symbols(self.doubled, self.dx,
                                               vorticity.device)
        return _kernel_convolve_curl_local(
            vorticity.contiguous(), greens, self.doubled, self._symbols[key],
            free_stream,
        )

    def _fd_curl_symbols(self, dtype):
        """Spectral symbols ``i sin(2 pi k / M) / dx`` of the width-2
        central difference on the doubled periodic grid, per axis (z, y
        full length, x the rfft half), shaped to broadcast."""
        nz, ny, nx = self.grid_size_z, self.grid_size_y, self.grid_size_x
        ctype = torch.complex64 if dtype == torch.float32 else torch.complex128

        def mk(freqs):
            sym = 1j * np.sin(2.0 * np.pi * freqs) / self.dx
            return torch.as_tensor(sym, dtype=ctype, device=self.device)

        return (
            mk(np.fft.fftfreq(2 * nz)).view(-1, 1, 1),
            mk(np.fft.fftfreq(2 * ny)).view(1, -1, 1),
            mk(np.fft.rfftfreq(2 * nx)).view(1, 1, -1),
        )

    def velocity_from_vorticity_spectral(self, vorticity, greens=None):
        """Velocity recovery ``u = FD-curl(G * omega)`` with the width-1
        wall ring zeroed, all in the doubled Fourier domain on dense
        ``torch.fft`` (no free stream): the plain form of the fused route
        on any device, numerically equal to ``curl_3d(vector_field_solve(
        omega), 0.5/dx)``."""
        nz, ny, nx = self.grid_size_z, self.grid_size_y, self.grid_size_x
        dims = (-3, -2, -1)
        psi_hat = torch.fft.rfftn(vorticity, s=self.doubled, dim=dims) \
            * self._dense_greens(greens)
        dz, dy, dxs = self._fd_curl_symbols(self.real_t)
        # component order (x, y, z) over array axes (z, y, x)
        u_hat = torch.stack([
            dy * psi_hat[2] - dz * psi_hat[1],
            dz * psi_hat[0] - dxs * psi_hat[2],
            dxs * psi_hat[1] - dy * psi_hat[0],
        ])
        u = torch.fft.irfftn(u_hat, s=self.doubled, dim=dims)[..., :nz, :ny, :nx]
        mask = torch.zeros((nz, ny, nx), dtype=u.dtype, device=u.device)
        mask[1:-1, 1:-1, 1:-1] = 1.0
        return u * mask
