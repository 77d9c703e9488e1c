"""Distributed real FFTs and the doubled-domain free-space convolution over
a 2D (py, px) or a 3D (pz, py) mesh (counterpart of
``sopht_mpi_tpu/parallel/fft.py``).

Every shard transforms along its unsharded axes and
:func:`~sopht_mpi_tpu_torch.parallel.collectives.all_to_all` performs the
pencil transposes. Arrays carry the two shard axes leading
(:mod:`sopht_mpi_tpu_torch.parallel.mesh`); "local" shapes below are one
shard's.

2D real field (Ny, Nx) sharded over ("y", "x"):
    slab (px = 1): rfft(x, local) -> pad x-freq to a multiple of py ->
    all_to_all over "y" (split x-freq, concat y) -> fft(y, local).
    pencil (px > 1): an all_to_all over "x" first gathers the whole x axis
    (split y) -> rfft(x, local) -> pad x-freq to a multiple of px py ->
    all_to_all over "x", then over "y" (split x-freq, concat y each time)
    -> fft(y, local). Fourier layout: (Ny, Fxp) complex with every y row
    on each shard and the x-frequency axis cut into px py chunks, x-major:
    shard (j, i) of the (py, px, Ny, Fxp/(px py)) layout holds chunk
    i py + j (the JAX package's P(None, ("x", "y")); its slab layout
    P("x", "y") is the case px = 1).

3D real field (Nz, Ny, Nx) sharded over ("z", "y"), x local:
    rfft(x, local) -> pad x-freq to a multiple of py -> all_to_all over "y"
    -> fft(y, local) -> all_to_all over "z" (split y, concat z) ->
    fft(z, local). Fourier layout: (Nz, Ny, Fxp) complex, the y axis sharded
    over "z" and the x-frequency axis over "y".

The x-frequency axis is zero-padded from ``Nx//2 + 1`` to
:func:`padded_rfft_size` so the all_to_all split is even; padded columns
stay exactly zero through every (linear) stage and are cut off on the way
back. Forward transforms are unnormalised, inverses normalised.

On a distributed mesh (one shard a process) the same steps run on each
process's block, (1, 1, ...) where the shapes below say (pz, py, ...), and
the all_to_all goes through ``torch.distributed``; the 2D transforms take
an in-process mesh only.

The x transforms are ``torch.fft.rfft`` / ``irfft`` (the JAX package's are
``jnp.fft`` outside any Pallas kernel). The middle passes of the convolve
are the Hopper kernels of :mod:`sopht_mpi_tpu_torch.parallel.cuda_fft`
where the route applies (float32, a CUDA device unless
``poisson.FORCE_KERNEL_CONVOLVE`` says otherwise, supported doubled lengths)
and ``torch.fft`` elsewhere, where the JAX package runs its MXU einsums.
In 3D the y passes fold every shard into the kernels' batch axis, one
launch for all shards; the z pass shares one Green's block over its batch,
so it is launched once a shard with that shard's block. The 2D y step
(pad, forward, Green's product, inverse, truncate: the function of the z
pass) is that same kernel, launched once a shard.
"""

from __future__ import annotations

import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft
from sopht_mpi_tpu_torch.parallel.collectives import all_to_all
from sopht_mpi_tpu_torch.parallel.mesh import (
    MESH_AXES_2D,
    MESH_AXES_3D,
    Mesh,
    refuse_distributed,
    shard_dims,
    unshard_dims,
)

#: the JAX package's default chunk count of its comm/compute software
#: pipeline. The port realises one chunk whatever is asked (a TPU
#: interconnect schedule has no in-process counterpart); the constant stays
#: because the padding of the x-frequency axis, and so the Fourier layout,
#: depends on it.
DEFAULT_OVERLAP_CHUNKS = 4


def _cpad(n: int, mult: int) -> int:
    """Round n up to a multiple of mult."""
    return ((n + mult - 1) // mult) * mult


def padded_rfft_size(nx: int, mesh: Mesh | None) -> int:
    """Global size of the (padded) x-frequency axis for a given mesh:
    ``nx//2 + 1`` rounded up, on a 2D mesh to a multiple of ``py * px``
    (the pencil splits it over both mesh axes), on a 3D mesh to a multiple
    of ``py``, and of ``py * DEFAULT_OVERLAP_CHUNKS`` when the z mesh axis
    is nontrivial (the JAX package's layout, kept so a Green's function
    converts)."""
    nxf = nx // 2 + 1
    if mesh is None or mesh.size == 1:
        return nxf
    if mesh.grid_dim == 2:
        return _cpad(nxf, mesh.shape["y"] * mesh.shape["x"])
    chunkable = DEFAULT_OVERLAP_CHUNKS if mesh.shape["z"] > 1 else 1
    return _cpad(nxf, mesh.shape["y"] * chunkable)


#: the array axes of the 3D Fourier layout (Nz, Ny, Fxp) that the mesh axes
#: ("z", "y") shard (``fourier_partition_spec``: P(None, "z", "y"))
FOURIER_SHARDED_DIMS = (1, 2)


def shard_fourier(spectrum, mesh: Mesh):
    """A global Fourier-layout array -> the sharded one: in 3D (Nz, Ny,
    Fxp) -> (pz, py, Nz, Ny/pz, Fxp/py); in 2D (Ny, Fxp) -> (py, px, Ny,
    Fxp/(px py)), shard (j, i) holding x-frequency chunk i py + j."""
    if mesh.grid_dim == 3:
        return shard_dims(spectrum, mesh, FOURIER_SHARDED_DIMS)
    py, px = mesh.axis_sizes
    ny, fxp = spectrum.shape
    return spectrum.reshape(ny, px, py, fxp // (px * py)).permute(
        2, 1, 0, 3).contiguous()


def unshard_fourier(fourier, mesh: Mesh):
    """Inverse of :func:`shard_fourier`: the global Fourier-layout array."""
    if mesh.grid_dim == 3:
        return unshard_dims(fourier, mesh, FOURIER_SHARDED_DIMS)
    py, px, ny, b = fourier.shape
    return fourier.permute(2, 1, 0, 3).reshape(ny, px * py * b)


def _pad_last(f, size: int):
    return torch.nn.functional.pad(f, (0, size - f.shape[-1]))


def _rfft2_local(field, mesh: Mesh, fxp: int):
    """(py, px, ny/py, nx/px) real -> (py, px, ny, fxp/(py px))."""
    py, px = mesh.axis_sizes
    if px > 1:
        # gather the whole x axis on each shard (y splits further)
        field = all_to_all(field, mesh, "x", 0, 1)
    fhat = _pad_last(torch.fft.rfft(field, dim=-1), fxp)
    if px > 1:
        fhat = all_to_all(fhat, mesh, "x", 1, 0)
    if py > 1:
        fhat = all_to_all(fhat, mesh, "y", 1, 0)
    return torch.fft.fft(fhat, dim=2)


def _irfft2_local(fourier, mesh: Mesh, nx: int):
    py, px = mesh.axis_sizes
    fhat = torch.fft.ifft(fourier, dim=2)
    if py > 1:
        fhat = all_to_all(fhat, mesh, "y", 0, 1)
    if px > 1:
        fhat = all_to_all(fhat, mesh, "x", 0, 1)
    out = torch.fft.irfft(fhat[..., : nx // 2 + 1], n=nx, dim=-1)
    if px > 1:
        out = all_to_all(out, mesh, "x", 1, 0)
    return out


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


def _check_mesh(mesh: Mesh):
    if mesh.axis_names not in (MESH_AXES_2D, MESH_AXES_3D):
        raise ValueError(
            f"mesh axes {mesh.axis_names}: the distributed transforms take "
            "a mesh from create_mesh(2, (py, px)) or create_mesh(3, "
            "(pz, py))")
    if mesh.grid_dim == 2:
        refuse_distributed(mesh, "the 2D distributed transforms")


def distributed_rfftn(field, mesh: Mesh | None):
    """Forward real FFT of a grid field (unnormalised). Without a mesh (or
    on a mesh of one shard) ``field`` is the plain (nz, ny, nx) or (ny, nx)
    tensor and the result the plain spectrum; on a mesh ``field`` is
    sharded, (pz, py, nz/pz, ny/py, nx) or (py, px, ny/py, nx/px), and the
    result is in the Fourier layout, (pz, py, nz, ny/pz, fxp/py) or
    (py, px, ny, fxp/(py px))."""
    if mesh is None or mesh.size == 1:
        out = torch.fft.rfft(field, dim=-1)
        for ax in range(field.ndim - 2, -1, -1):
            out = torch.fft.fft(out, dim=ax)
        return out
    _check_mesh(mesh)
    local = _rfft2_local if mesh.grid_dim == 2 else _rfft3_local
    nx = field.shape[-1] * (mesh.shape["x"] if mesh.grid_dim == 2 else 1)
    return local(field, mesh, padded_rfft_size(nx, mesh))


def distributed_irfftn(fourier, nx: int, mesh: Mesh | None):
    """Inverse of :func:`distributed_rfftn` (normalised). ``nx`` is the
    global size of the last (real) axis."""
    if mesh is None or mesh.size == 1:
        out = fourier
        for ax in range(fourier.ndim - 2, -1, -1):
            out = torch.fft.ifft(out, dim=ax)
        return torch.fft.irfft(out[..., : nx // 2 + 1], n=nx, dim=-1)
    _check_mesh(mesh)
    local = _irfft2_local if mesh.grid_dim == 2 else _irfft3_local
    return local(fourier, mesh, nx)


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


def _conv_y_shards(f, greens, ny: int, use_kernels: bool):
    """The 2D y step of every shard of a complex (py, px, ny, b) array:
    pad to 2 ny, forward FFT, times the shard's real (2 ny, b) block of
    ``greens`` (py, px, 2 ny, b), inverse FFT, keep ny rows. On the kernel
    route ``fft_greens_ifft_pass`` once a shard (each shard has its own
    Green's block), else ``torch.fft`` over all shards at once."""
    if not use_kernels:
        full = torch.fft.fft(f, n=2 * ny, dim=2) * greens
        return torch.fft.ifft(full, dim=2)[:, :, :ny]
    py, px = f.shape[:2]
    # one split for every shard: each [j, i] block of it is contiguous
    fr, fi = _split_reim(f)
    greens = greens.contiguous()
    outs = [cuda_fft.fft_greens_ifft_pass(fr[j, i][None], fi[j, i][None],
                                          greens[j, i][None])
            for j in range(py) for i in range(px)]
    rr = torch.cat([o[0] for o in outs])
    ii = torch.cat([o[1] for o in outs])
    return torch.complex(rr, ii).reshape(f.shape)


def _convolve2_local(field, greens, mesh: Mesh, *, ny: int, nx: int,
                     fxp: int, kernels_y: bool):
    """The convolve of (py, px, ny/py, nx/px) with the sharded Green's
    (py, px, 2 ny, fxp/(py px)), the JAX package's ``_convolve2_local``."""
    py, px = mesh.axis_sizes
    if px > 1:
        # gather the whole x axis on each shard (y splits further)
        field = all_to_all(field, mesh, "x", 0, 1)
    f = _pad_last(torch.fft.rfft(field, n=2 * nx, dim=-1), fxp)
    if px > 1:
        f = all_to_all(f, mesh, "x", 1, 0)
    if py > 1:
        f = all_to_all(f, mesh, "y", 1, 0)  # (.., ny, fxp/(py px))
    f = _conv_y_shards(f, greens, ny, kernels_y)
    if py > 1:
        f = all_to_all(f, mesh, "y", 0, 1)
    if px > 1:
        f = all_to_all(f, mesh, "x", 0, 1)
    out = torch.fft.irfft(f[..., : nx + 1], n=2 * nx, dim=-1)[..., :nx]
    if px > 1:
        out = all_to_all(out, mesh, "x", 1, 0)
    return out.contiguous()


def _convolve3_local_batched(field, greens, mesh: Mesh, *, nz: int, ny: int,
                             nx: int, fxp: int, kernels_y: bool,
                             kernels_z: bool):
    """The convolve of (pz, py, c, nzl, nyl, nx) with the sharded Green's
    (pz, py, 2 nz, 2 ny/pz, fxp/py): the components fold into each
    segment's batch rows, so every all_to_all moves all of them at once.
    (pz, py) are the shards in ``field``: (1, 1) on a distributed mesh."""
    pz, py = mesh.shape["z"], mesh.shape["y"]
    lz, ly = field.shape[:2]
    c, nzl = field.shape[2], field.shape[3]
    # x r2c of the doubled rows, then the y segment: (.., c*nzl, ny/py, nx)
    f = torch.fft.rfft(field.reshape(lz, ly, c * nzl, ny // py, nx),
                       n=2 * nx, dim=-1)
    f = _pad_last(f, fxp)
    if py > 1:
        f = all_to_all(f, mesh, "y", 2, 1)
    f = _fwd_y_local(f, 2 * ny, kernels_y)  # (.., c*nzl, 2ny, fxp/py)
    bxl = f.shape[-1]
    # the z segment, on the (c, nzl, 2ny, bxl) view
    f = f.reshape(lz, ly, c, nzl, 2 * ny, bxl)
    if pz > 1:
        f = all_to_all(f, mesh, "z", 2, 1)  # (.., c, nz, 2ny/pz, bxl)
    # fused z-forward * greens -> z-inverse on each shard: the doubled
    # z-spectrum never reaches device memory
    f = torch.stack([
        torch.stack([
            _conv_z_local_batched(f[i, j], greens[i, j], nz, kernels_z)
            for j in range(ly)])
        for i in range(lz)])
    if pz > 1:
        f = all_to_all(f, mesh, "z", 1, 2)  # (.., c, nzl, 2ny, bxl)
    # the inverse y segment and the x c2r
    f = _inv_y_local(f.reshape(lz, ly, c * nzl, 2 * ny, bxl), ny, kernels_y)
    if py > 1:
        f = all_to_all(f, mesh, "y", 1, 2)  # (.., c*nzl, ny/py, fxp)
    out = torch.fft.irfft(f[..., : nx + 1], n=2 * nx, dim=-1)[..., :nx]
    return out.reshape(lz, ly, c, nzl, ny // py, nx).contiguous()


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
    """Spectral free-space convolution of a sharded N-domain ``rhs`` with a
    real doubled-domain Fourier multiplier ``greens`` in the Fourier layout
    (the real part of :func:`distributed_rfftn` of the even-reflected
    doubled kernel). Returns the N-domain solution in the input's layout.

    In 3D ``rhs`` is (pz, py, nzl, nyl, nx), or (pz, py, c, nzl, nyl, nx)
    with a component axis, and ``greens`` (pz, py, 2 nz, 2 ny/pz, fxp/py);
    in 2D ``rhs`` is (py, px, nyl, nxl) and ``greens`` (py, px, 2 ny,
    fxp/(py px)).

    The per-shard middle passes run the FFT-pass kernels for float32 on a
    CUDA device where the doubled lengths pass
    :func:`~sopht_mpi_tpu_torch.parallel.cuda_fft.kernel_fft_supported`;
    ``force_kernels`` overrides the device part of that policy (None takes
    ``poisson.FORCE_KERNEL_CONVOLVE``), so tests can run the passes' plain
    versions on the CPU.

    ``overlap_chunks`` (the JAX package's comm/compute pipelining request
    of its 3D convolve) is accepted for any value >= 1 and realised as one
    chunk; chunking is exact there, so the result is the same. ``fast`` is
    accepted and inert: the port's fast tier is the single-device
    fused-curl route only. ``comm_bf16`` (a lossy wire format of the TPU
    transposes) is refused.
    """
    _check_mesh(mesh)
    if comm_bf16:
        raise NotImplementedError(
            "comm_bf16: the bf16 wire format of the transposes is not "
            "ported (ROADMAP.md, 'Do not port')")
    if overlap_chunks is not None and overlap_chunks < 1:
        raise ValueError(
            f"overlap_chunks must be >= 1 (got {overlap_chunks}); "
            "pass 1 to disable the comm/compute pipeline"
        )
    if force_kernels is None:
        from sopht_mpi_tpu_torch.ops import poisson

        force_kernels = poisson.FORCE_KERNEL_CONVOLVE
    on_route = rhs.dtype == torch.float32 and (
        rhs.device.type == "cuda" if force_kernels is None else force_kernels)
    p0, p1 = mesh.axis_sizes
    if mesh.grid_dim == 2:
        if rhs.ndim != 4:
            raise ValueError(
                f"rhs: shape {tuple(rhs.shape)}; the 2D convolve takes a "
                "sharded scalar field (py, px, ny/py, nx/px)")
        nyl, nxl = rhs.shape[-2:]
        ny, nx = nyl * p0, nxl * p1
        fxp = padded_rfft_size(2 * nx, mesh)
        _check_greens(greens, (p0, p1, 2 * ny, fxp // (p0 * p1)))
        return _convolve2_local(
            rhs, greens, mesh, ny=ny, nx=nx, fxp=fxp,
            kernels_y=on_route and cuda_fft.kernel_fft_supported(2 * ny))
    batched = rhs.ndim == 6
    nzl, nyl, nx = rhs.shape[-3:]
    nz, ny = nzl * p0, nyl * p1
    fxp = padded_rfft_size(2 * nx, mesh)
    _check_greens(greens, (*mesh.local_axis_sizes, 2 * nz, 2 * ny // p0,
                           fxp // p1))
    fn = _convolve3_local_batched if batched else _convolve3_local
    return fn(
        rhs, greens, mesh, nz=nz, ny=ny, nx=nx, fxp=fxp,
        kernels_y=on_route and cuda_fft.kernel_fft_supported(2 * ny),
        kernels_z=on_route and cuda_fft.kernel_fft_supported(2 * nz),
    )


def _check_greens(greens, layout):
    if tuple(greens.shape) != layout:
        raise ValueError(
            f"greens: shape {tuple(greens.shape)} is not the Fourier layout "
            f"{layout} of this grid and mesh")
