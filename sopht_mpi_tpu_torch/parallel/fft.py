"""Distributed real FFTs and the doubled-domain free-space convolution over
a (pz, py) mesh (the 3D part of ``sopht_mpi_tpu/parallel/fft.py``).

Every shard transforms along its unsharded axes and
:func:`~sopht_mpi_tpu_torch.parallel.collectives.all_to_all` performs the
pencil transposes. Arrays carry the two shard axes leading
(:mod:`sopht_mpi_tpu_torch.parallel.mesh`); "local" shapes below are one
shard's.

3D real field (Nz, Ny, Nx) sharded over ("z", "y"), x local:
    rfft(x, local) -> pad x-freq to a multiple of py -> all_to_all over "y"
    -> fft(y, local) -> all_to_all over "z" (split y, concat z) ->
    fft(z, local). Fourier layout: (Nz, Ny, Fxp) complex, the y axis sharded
    over "z" and the x-frequency axis over "y".

The x-frequency axis is zero-padded from ``Nx//2 + 1`` to
:func:`padded_rfft_size` so the all_to_all split is even; padded columns
stay exactly zero through every (linear) stage and are cut off on the way
back. Forward transforms are unnormalised, inverses normalised.

The x transforms are ``torch.fft.rfft`` / ``irfft`` (the JAX package's are
``jnp.fft`` outside any Pallas kernel). The y and z passes of the convolve
are the Hopper kernels of :mod:`sopht_mpi_tpu_torch.parallel.cuda_fft`
where the route applies (float32, a CUDA device unless
``poisson.FORCE_KERNEL_CONVOLVE`` says otherwise, supported doubled lengths)
and ``torch.fft`` elsewhere, where the JAX package runs its MXU einsums.
The y passes fold every shard into the kernels' batch axis, one launch for
all shards; the z pass shares one Green's block over its batch, so it is
launched once a shard with that shard's block.
"""

from __future__ import annotations

import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft
from sopht_mpi_tpu_torch.parallel.collectives import all_to_all
from sopht_mpi_tpu_torch.parallel.mesh import Mesh

#: the JAX package's default chunk count of its comm/compute software
#: pipeline. The port realises one chunk whatever is asked (a TPU
#: interconnect schedule has no in-process counterpart); the constant stays
#: because the padding of the x-frequency axis, and so the Fourier layout,
#: depends on it.
DEFAULT_OVERLAP_CHUNKS = 4


def _cpad(n: int, mult: int) -> int:
    """Round n up to a multiple of mult."""
    return ((n + mult - 1) // mult) * mult


def padded_rfft_size(nx: int, mesh: Mesh | None, grid_dim: int = 3) -> int:
    """Global size of the (padded) x-frequency axis for a given mesh:
    ``nx//2 + 1`` rounded up to a multiple of ``py``, and of
    ``py * DEFAULT_OVERLAP_CHUNKS`` when the z mesh axis is nontrivial (the
    JAX package's layout, kept so a Green's function converts)."""
    if grid_dim != 3:
        raise NotImplementedError(
            "the 2D distributed transforms are not ported yet "
            "(ROADMAP.md queue A #11f)")
    nxf = nx // 2 + 1
    if mesh is None or mesh.size == 1:
        return nxf
    chunkable = DEFAULT_OVERLAP_CHUNKS if mesh.shape["z"] > 1 else 1
    return _cpad(nxf, mesh.shape["y"] * chunkable)


#: the array axes of the Fourier layout (Nz, Ny, Fxp) that the mesh axes
#: ("z", "y") shard (``fourier_partition_spec``: P(None, "z", "y"))
FOURIER_SHARDED_DIMS = (1, 2)


def _pad_last(f, size: int):
    return torch.nn.functional.pad(f, (0, size - f.shape[-1]))


def _rfft3_local(field, mesh: Mesh, fxp: int):
    """(pz, py, nz/pz, ny/py, nx) real -> (pz, py, nz, ny/pz, fxp/py)."""
    fhat = _pad_last(torch.fft.rfft(field, dim=-1), fxp)
    if mesh.shape["y"] > 1:
        fhat = all_to_all(fhat, mesh, "y", 2, 1)
    fhat = torch.fft.fft(fhat, dim=3)
    if mesh.shape["z"] > 1:
        fhat = all_to_all(fhat, mesh, "z", 1, 0)
    return torch.fft.fft(fhat, dim=2)


def _irfft3_local(fourier, mesh: Mesh, nx: int):
    fhat = torch.fft.ifft(fourier, dim=2)
    if mesh.shape["z"] > 1:
        fhat = all_to_all(fhat, mesh, "z", 0, 1)
    fhat = torch.fft.ifft(fhat, dim=3)
    if mesh.shape["y"] > 1:
        fhat = all_to_all(fhat, mesh, "y", 1, 2)
    return torch.fft.irfft(fhat[..., : nx // 2 + 1], n=nx, dim=-1)


def _check_3d_mesh(mesh: Mesh):
    if mesh.axis_names != ("z", "y"):
        raise NotImplementedError(
            "the 2D distributed transforms are not ported yet "
            "(ROADMAP.md queue A #11f)")


def distributed_rfftn(field, mesh: Mesh | None):
    """Forward real FFT of a grid field (unnormalised). Without a mesh (or
    on a mesh of one shard) ``field`` is the plain (nz, ny, nx) tensor and
    the result the plain spectrum; on a mesh ``field`` is sharded
    (pz, py, nz/pz, ny/py, nx) and the result is in the Fourier layout,
    (pz, py, nz, ny/pz, fxp/py)."""
    if mesh is None or mesh.size == 1:
        out = torch.fft.rfft(field, dim=-1)
        return torch.fft.fft(torch.fft.fft(out, dim=-2), dim=-3)
    _check_3d_mesh(mesh)
    return _rfft3_local(
        field, mesh, padded_rfft_size(field.shape[-1], mesh))


def distributed_irfftn(fourier, nx: int, mesh: Mesh | None):
    """Inverse of :func:`distributed_rfftn` (normalised). ``nx`` is the
    global size of the last (real) axis."""
    if mesh is None or mesh.size == 1:
        out = torch.fft.ifft(torch.fft.ifft(fourier, dim=-3), dim=-2)
        return torch.fft.irfft(out[..., : nx // 2 + 1], n=nx, dim=-1)
    _check_3d_mesh(mesh)
    return _irfft3_local(fourier, mesh, nx)


# ---------------------------------------------------------------------------
# Doubled-domain free-space convolution (lazy padding + early truncation)
# ---------------------------------------------------------------------------
#
# The free-space Poisson solve transforms a zero-padded (2N)^3 domain and
# keeps the first N cells of the inverse. Padding lazily per axis and
# truncating as early as possible means the transposes move the UNPADDED
# volume, and the doubled field never exists.


def _split_reim(f):
    return f.real.contiguous(), f.imag.contiguous()


def _fold(f, n_lead: int):
    """Fold the first ``n_lead`` axes of ``f`` into one (the kernels'
    batch axis A)."""
    return f.reshape(-1, *f.shape[n_lead:])


def _fwd_y_local(f, my: int, use_kernels: bool):
    """Padded forward pass along the second-to-last axis of a complex
    (..., ny, b) array to ``my`` points: the kernel with every leading axis
    (shards included) folded into its batch, or ``torch.fft``."""
    if not use_kernels:
        return torch.fft.fft(f, n=my, dim=-2)
    lead = f.shape[:-2]
    rr, ii = cuda_fft.fft_pass_padded(*_split_reim(_fold(f, len(lead))), my)
    return torch.complex(rr, ii).reshape(*lead, my, f.shape[-1])


def _inv_y_local(f, ny: int, use_kernels: bool):
    """Truncated inverse pass along the second-to-last axis of a complex
    (..., 2 ny, b) array, keeping ``ny`` points."""
    if not use_kernels:
        return torch.fft.ifft(f, dim=-2)[..., :ny, :]
    lead = f.shape[:-2]
    rr, ii = cuda_fft.ifft_pass_truncated(*_split_reim(_fold(f, len(lead))))
    return torch.complex(rr, ii).reshape(*lead, ny, f.shape[-1])


def _conv_z_local_batched(f, greens, nz: int, use_kernels: bool):
    """Padded forward * ``greens`` -> truncated inverse along z of one
    shard's complex (c, nz, ...) block, ``greens`` that shard's real
    (2 nz, ...) block: the fused kernel on the (c, nz, rest) view with one
    Green's copy shared by the components, or ``torch.fft``."""
    if not use_kernels:
        full = torch.fft.fft(f, n=2 * nz, dim=1) * greens[None]
        return torch.fft.ifft(full, dim=1)[:, :nz]
    shp = f.shape
    fr, fi = _split_reim(f.reshape(shp[0], nz, -1))
    rr, ii = cuda_fft.fft_greens_ifft_pass(
        fr, fi, greens.reshape(1, 2 * nz, -1))
    return torch.complex(rr, ii).reshape(shp)


def _convolve3_local_batched(field, greens, mesh: Mesh, *, nz: int, ny: int,
                             nx: int, fxp: int, kernels_y: bool,
                             kernels_z: bool):
    """The convolve of (pz, py, c, nzl, nyl, nx) with the sharded Green's
    (pz, py, 2 nz, 2 ny/pz, fxp/py): the components fold into each
    segment's batch rows, so every all_to_all moves all of them at once."""
    pz, py = mesh.shape["z"], mesh.shape["y"]
    c, nzl = field.shape[2], field.shape[3]
    # x r2c of the doubled rows, then the y segment: (.., c*nzl, ny/py, nx)
    f = torch.fft.rfft(field.reshape(pz, py, c * nzl, ny // py, nx),
                       n=2 * nx, dim=-1)
    f = _pad_last(f, fxp)
    if py > 1:
        f = all_to_all(f, mesh, "y", 2, 1)
    f = _fwd_y_local(f, 2 * ny, kernels_y)  # (.., c*nzl, 2ny, fxp/py)
    bxl = f.shape[-1]
    # the z segment, on the (c, nzl, 2ny, bxl) view
    f = f.reshape(pz, py, c, nzl, 2 * ny, bxl)
    if pz > 1:
        f = all_to_all(f, mesh, "z", 2, 1)  # (.., c, nz, 2ny/pz, bxl)
    # fused z-forward * greens -> z-inverse on each shard: the doubled
    # z-spectrum never reaches device memory
    f = torch.stack([
        torch.stack([
            _conv_z_local_batched(f[i, j], greens[i, j], nz, kernels_z)
            for j in range(py)])
        for i in range(pz)])
    if pz > 1:
        f = all_to_all(f, mesh, "z", 1, 2)  # (.., c, nzl, 2ny, bxl)
    # the inverse y segment and the x c2r
    f = _inv_y_local(f.reshape(pz, py, c * nzl, 2 * ny, bxl), ny, kernels_y)
    if py > 1:
        f = all_to_all(f, mesh, "y", 1, 2)  # (.., c*nzl, ny/py, fxp)
    out = torch.fft.irfft(f[..., : nx + 1], n=2 * nx, dim=-1)[..., :nx]
    return out.reshape(pz, py, c, nzl, ny // py, nx).contiguous()


def _convolve3_local(field, greens, mesh: Mesh, **kw):
    """:func:`_convolve3_local_batched` of a sharded scalar field
    (pz, py, nzl, nyl, nx)."""
    return _convolve3_local_batched(field[:, :, None], greens, mesh,
                                    **kw)[:, :, 0]


def distributed_free_space_convolve(rhs, greens, mesh: Mesh,
                                    force_kernels: bool | None = None,
                                    fast: bool = False,
                                    overlap_chunks: int | None = None,
                                    comm_bf16: bool = False):
    """Spectral free-space convolution of a sharded N-domain ``rhs``
    ((pz, py, nzl, nyl, nx), or (pz, py, c, nzl, nyl, nx) with a component
    axis) with a real doubled-domain Fourier multiplier ``greens`` in the
    Fourier layout ((pz, py, 2 nz, 2 ny/pz, fxp/py), the real part of
    :func:`distributed_rfftn` of the even-reflected doubled kernel).
    Returns the N-domain solution in the input's layout.

    The per-shard y and z passes run the FFT-pass kernels for float32 on a
    CUDA device where the doubled lengths pass
    :func:`~sopht_mpi_tpu_torch.parallel.cuda_fft.kernel_fft_supported`;
    ``force_kernels`` overrides the device part of that policy (None takes
    ``poisson.FORCE_KERNEL_CONVOLVE``), so tests can run the passes' plain
    versions on the CPU.

    ``overlap_chunks`` (the JAX package's comm/compute pipelining request)
    is accepted for any value >= 1 and realised as one chunk; chunking is
    exact there, so the result is the same. ``fast`` is accepted and inert:
    the port's fast tier is the single-device fused-curl route only.
    ``comm_bf16`` (a lossy wire format of the TPU transposes) is refused.
    """
    _check_3d_mesh(mesh)
    if comm_bf16:
        raise NotImplementedError(
            "comm_bf16: the bf16 wire format of the transposes is not "
            "ported (ROADMAP.md, 'Do not port')")
    if overlap_chunks is not None and overlap_chunks < 1:
        raise ValueError(
            f"overlap_chunks must be >= 1 (got {overlap_chunks}); "
            "pass 1 to disable the comm/compute pipeline"
        )
    batched = rhs.ndim == 6
    nzl, nyl, nx = rhs.shape[-3:]
    pz, py = mesh.shape["z"], mesh.shape["y"]
    nz, ny = nzl * pz, nyl * py
    fxp = padded_rfft_size(2 * nx, mesh)
    if tuple(greens.shape) != (pz, py, 2 * nz, 2 * ny // pz, fxp // py):
        raise ValueError(
            f"greens: shape {tuple(greens.shape)} is not the Fourier layout "
            f"{(pz, py, 2 * nz, 2 * ny // pz, fxp // py)} of this grid and "
            "mesh")
    if force_kernels is None:
        from sopht_mpi_tpu_torch.ops import poisson

        force_kernels = poisson.FORCE_KERNEL_CONVOLVE
    on_route = rhs.dtype == torch.float32 and (
        rhs.device.type == "cuda" if force_kernels is None else force_kernels)
    fn = _convolve3_local_batched if batched else _convolve3_local
    return fn(
        rhs, greens, mesh, nz=nz, ny=ny, nx=nx, fxp=fxp,
        kernels_y=on_route and cuda_fft.kernel_fft_supported(2 * ny),
        kernels_z=on_route and cuda_fft.kernel_fft_supported(2 * nz),
    )
