"""The four 3D stencils of the Navier-Stokes step on a sharded field: halo
exchange, Hopper kernels, plain versions (counterpart of
``sopht_mpi_tpu/ops/pallas_stencils_sharded.py``).

A field is sharded over a (pz, py) mesh as (pz, py, 3, nzl, nyl, nx)
(:mod:`sopht_mpi_tpu_torch.parallel.mesh`). Each public op

1. exchanges the width-1 halos with
   :func:`~sopht_mpi_tpu_torch.parallel.collectives.ppermute`: whole z
   planes along "z" (:func:`_halo_z_planes`), single y rows along "y"
   (:func:`_halo_y_rows`), each into a buffer of its own. These 3-point
   stencils need no corner halos;
2. on a CUDA tensor launches its kernel in ``csrc/stencils_3d.cu`` once for
   all shards, on the current stream, without synchronising, and adds one
   to its ``launches`` count (or raises: there is no fallback). All four
   run z-marching kernels that read the field(s) and their four halo
   buffers as they are, never a ghosted copy, under a plan the launcher
   checks (:func:`sharded_stencil_plan`). Wall masks, clamps and ramps use
   GLOBAL coordinates (:func:`_shard_coords`), so a shard seam is interior
   and a physical wall behaves as in the single-device kernel; the
   wraparound halo at a physical wall is garbage that no unmasked cell
   reads. The fused sponge forms each cell's diffusion at its in-plane
   clamp source and lets the z wall band's source plane write the band
   (where an in-plane source lies in another tile, the launcher takes an
   instance that scatters from the sources);
3. on a CPU tensor runs the same per-shard computation in plain PyTorch on
   the exchanged halos (``_*_on_halos``).

Beside each op stands its plain version ``*_sharded_ref``: the
single-device plain op on the assembled field, sharded again. It serves
the tests and the comparison on the card, and nothing on a path.

Reverse mode: where autograd records a call, each op goes through
``_autograd.PlainVJP``, whose backward is the VJP of its ``*_sharded_ref``
on the saved inputs (the JAX package's rule: the VJP of the global op on
the sharded layout); tensor prefactors and ``add_vector`` receive
gradients. The forward exchanges halos and launches as above; the backward
launches no kernel and counts no collective.

Replaced TPU kernels: :func:`diffusion_timestep_vector_3d_sharded` <-
``_diffusion_sharded_impl``, :func:`curl_3d_sharded` <-
``_curl_sharded_impl``, :func:`rotational_curl_add_3d_sharded` <-
``_rotational_sharded_impl``,
:func:`diffusion_penalise_vector_3d_sharded` <- ``_diffpen_sharded_impl``.
The JAX functions fall back to the global op unless the shard's y extent
is a multiple of 8 (their VMEM tiling); these kernels take every shard
shape, and the fused sponge needs only the clamp sources in the shard
(:func:`diffusion_penalise_sharded_supported`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as _single
from sopht_mpi_tpu_torch.ops import stencils_3d as _plain
from sopht_mpi_tpu_torch.ops._autograd import kernel_or_plain_vjp
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.cuda_fft import (
    BLOCK_SHARED_MAX,
    BLOCK_SHARED_RESERVE,
    H100_SMS,
    SM_SHARED_BYTES,
)
from sopht_mpi_tpu_torch.parallel.mesh import (
    Mesh,
    apply_assembled,
    on_assembled,
    shard_vector_field,
    unshard_vector_field,
)

# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _halo_z_planes(f, mesh: Mesh):
    """((pz, py, 3, 1, nyl, nx) zlo, zhi), contiguous: the plane below each
    shard's first (the previous shard's last) and above its last (the next
    shard's first); wraparound garbage at the physical walls, wall-masked."""
    last, first = f[:, :, :, -1:], f[:, :, :, :1]
    if mesh.shape["z"] > 1:
        zlo = collectives.ppermute(last, mesh, "z", +1)
        zhi = collectives.ppermute(first, mesh, "z", -1)
    else:
        zlo, zhi = last, first
    return zlo.contiguous(), zhi.contiguous()


def _halo_y_rows(f, mesh: Mesh):
    """((pz, py, 3, nzl, 1, nx) ylo, yhi): the y-neighbour shards' edge
    rows."""
    last, first = f[:, :, :, :, -1:], f[:, :, :, :, :1]
    if mesh.shape["y"] > 1:
        ylo = collectives.ppermute(last, mesh, "y", +1)
        yhi = collectives.ppermute(first, mesh, "y", -1)
    else:
        ylo, yhi = last, first
    return ylo.contiguous(), yhi.contiguous()


@functools.cache
def _shard_coords(mesh_shape, nzl: int, nyl: int, device):
    """(pz, py, 2) int32 [z0 plane, y0 row]: each shard's global offsets."""
    pz, py = mesh_shape
    z0 = torch.arange(pz, dtype=torch.int32).view(pz, 1) * nzl
    y0 = torch.arange(py, dtype=torch.int32).view(1, py) * nyl
    return torch.stack(
        [z0.expand(pz, py), y0.expand(pz, py)], dim=-1
    ).contiguous().to(device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def diffusion_timestep_vector_3d_sharded_ref(vector_field, nu_dt_by_dx2, mesh):
    """The single-device plain diffusion step on the assembled field,
    sharded again."""
    return on_assembled(
        lambda f: _single.diffusion_timestep_vector_3d_ref(f, nu_dt_by_dx2),
        mesh, vector_field)


def curl_3d_sharded_ref(field, prefactor, mesh, add_vector=None,
                        compute_l1_max=False):
    """The single-device plain curl (+ constant, + ``max |u|_1``) on the
    assembled field, sharded again."""
    res = _single.curl_3d_ref(unshard_vector_field(field, mesh), prefactor,
                              add_vector, compute_l1_max)
    if compute_l1_max:
        return shard_vector_field(res[0], mesh), res[1]
    return shard_vector_field(res, mesh)


def rotational_curl_add_3d_sharded_ref(vorticity, velocity, prefactor, mesh):
    """The single-device plain rotational transport on the assembled
    fields, sharded again."""
    return on_assembled(
        lambda w, u: _single.rotational_curl_add_3d_ref(w, u, prefactor),
        mesh, vorticity, velocity)


def diffusion_penalise_vector_3d_sharded_ref(vector_field, nu_dt_by_dx2,
                                             width: int, mesh):
    """The single-device plain diffusion step and wall sponge on the
    assembled field, sharded again."""
    return on_assembled(
        lambda f: _single.diffusion_penalise_vector_3d_ref(
            f, nu_dt_by_dx2, width),
        mesh, vector_field)


# the per-shard computation in plain PyTorch, on the exchanged halos: what a
# CPU tensor runs


def _global_index(mesh, nzl, nyl, device):
    """((pz, 1, nzl, 1) gz, (1, py, 1, nyl) gy): every shard cell's global
    z plane and y row."""
    pz, py = mesh.axis_sizes
    gz = torch.arange(pz * nzl, device=device).view(pz, 1, nzl, 1)
    gy = torch.arange(py * nyl, device=device).view(1, py, 1, nyl)
    return gz, gy


def _zy_wall(mesh, nzl, nyl, device):
    """(pz, py, 1, nzl, nyl, 1) bool: the cell lies on a global z or y
    wall."""
    gz, gy = _global_index(mesh, nzl, nyl, device)
    pz, py = mesh.axis_sizes
    wall = ((gz == 0) | (gz == pz * nzl - 1) | (gy == 0)
            | (gy == py * nyl - 1))
    return wall.view(pz, py, 1, nzl, nyl, 1)


def _per_shard(op, *extended):
    """``op`` of each shard's extended block(s), the halo cut off again."""
    pz, py = extended[0].shape[:2]
    return torch.stack([
        torch.stack([
            op(*(e[i, j] for e in extended))[:, 1:-1, 1:-1]
            for j in range(py)])
        for i in range(pz)])


def _extended_from(f, zlo, zhi, ylo, yhi):
    """(pz, py, 3, nzl + 2, nyl + 2, nx): a field's blocks between their
    z halo planes, with their y rows attached; the four z-y corner lines,
    which no 3-point stencil reads, are zero."""
    fg = torch.cat([zlo, f, zhi], dim=3)
    corner = fg.new_zeros((*fg.shape[:3], 1, 1, fg.shape[-1]))
    lo = torch.cat([corner, ylo, corner], dim=3)
    hi = torch.cat([corner, yhi, corner], dim=3)
    return torch.cat([lo, fg, hi], dim=4)


def _diffusion_on_halos(f, halos, nu_dt_by_dx2, mesh):
    res = _per_shard(
        lambda e: _plain.diffusion_timestep_vector_3d(e, nu_dt_by_dx2),
        _extended_from(f, *halos))
    wall = _zy_wall(mesh, f.shape[3], f.shape[4], f.device)
    return torch.where(wall, f, res)


def _rotational_on_halos(w, u, w_halos, u_halos, prefactor, mesh):
    res = _per_shard(
        lambda we, ue: _single.rotational_curl_add_3d_ref(we, ue, prefactor),
        _extended_from(w, *w_halos), _extended_from(u, *u_halos))
    wall = _zy_wall(mesh, w.shape[3], w.shape[4], w.device)
    return torch.where(wall, w, res)


def _curl_on_halos(f, halos, prefactor, add_vector, mesh):
    res = _per_shard(lambda e: _plain.curl_3d(e, prefactor),
                     _extended_from(f, *halos))
    wall = _zy_wall(mesh, f.shape[3], f.shape[4], f.device)
    out = torch.where(wall, torch.zeros((), dtype=f.dtype, device=f.device),
                      res)
    if add_vector is not None:
        out = out + add_vector.to(out.dtype).reshape(3, 1, 1, 1)
    return out


def _sponge_in_shards(d, width, mesh):
    """The wall sponge of the sharded field ``d`` with every clamp source
    in its own shard (``nzl, nyl >= 2 width``): clamp and ramp by global
    index along z and y, along x as on one device."""
    pz, py, _, nzl, nyl, nx = d.shape
    gz, gy = _global_index(mesh, nzl, nyl, d.device)

    def clamp_and_ramp(g, n):
        src = g.clamp(width - 1, n - width)
        k = torch.minimum(g, n - 1 - g)  # the distance to the nearer wall
        ramp = torch.sin(0.5 * math.pi * k.to(d.dtype) / width)
        return src, torch.where(k < width, ramp, torch.ones_like(ramp))

    d = _plain._penalise_axes(d, width, (5,))
    ys, ry = clamp_and_ramp(gy, py * nyl)           # (1, py, 1, nyl)
    yl = (ys - ys.new_tensor(range(0, py * nyl, nyl)).view(1, py, 1, 1))
    d = torch.gather(
        d, 4, yl.view(1, py, 1, 1, nyl, 1).expand(pz, py, 3, nzl, nyl, nx))
    d = d * ry.view(1, py, 1, 1, nyl, 1)
    zs, rz = clamp_and_ramp(gz, pz * nzl)           # (pz, 1, nzl, 1)
    zl = (zs - zs.new_tensor(range(0, pz * nzl, nzl)).view(pz, 1, 1, 1))
    d = torch.gather(
        d, 3, zl.view(pz, 1, 1, nzl, 1, 1).expand(pz, py, 3, nzl, nyl, nx))
    return d * rz.view(pz, 1, 1, nzl, 1, 1)


# ---------------------------------------------------------------------------
# the z-marching kernels' launch plan
# ---------------------------------------------------------------------------

#: the z-marching kernels' tiles, (x, y) cells a block: the instances the
#: launcher takes
ZMARCH_TILES = ((32, 8), (32, 16), (64, 4), (64, 8))
#: the ring depths the launcher takes, at least ``2 + ZMARCH_KEEP[kind]``:
#: the ring keeps the centre plane and ``ZMARCH_KEEP[kind] - 1`` below it,
#: so ``stages - 1 - keep`` planes are in flight while one is used
ZMARCH_STAGE_RANGE = (3, 5)
#: the planes each kind's walk keeps at and below the centre plane: the
#: diffusion pair reads its z - 1 values from the ring (the sponge forms a
#: cell's diffusion at its clamp source's place in the tiles); "filter" is
#: the single-device multiplicative filter pass (one shard, no halo
#: buffers, ``mult_filter_zmarch_kernel``), which reads its centre plane's
#: value from the ring
ZMARCH_KEEP = {"curl": 1, "rotational": 1, "diffusion": 2, "sponge": 2,
               "filter": 1}
#: the tile and each kernel's ring stages the plan takes (the fastest at
#: 256^3 on (2, 2) and (8, 1) on one H100, ``tools/probe_sharded.py
#: --sweep``; the filter's at the rod's (3, 256, 64, 256) and 256^3,
#: ``tools/probe_filter.py --sweep``): "diffusion" is the diffusion step,
#: "sponge" the diffusion step with the wall sponge
ZMARCH_TILE = (64, 8)
ZMARCH_STAGES = {"curl": 4, "rotational": 3, "diffusion": 5, "sponge": 5,
                 "filter": 4}
#: the fields each kernel reads
ZMARCH_FIELDS = {"curl": 1, "rotational": 2, "diffusion": 1, "sponge": 1,
                 "filter": 1}
#: threads an SM holds at the kernels' launch bound (64 registers a thread)
ZMARCH_SM_THREADS = 1024


class ShardedStencilPlan(NamedTuple):
    """How a z-marching kernel covers a sharded field: a block owns a
    ``tx`` x ``ty`` tile of (x, y) cells of one shard (a thread a cell) and
    marches through ``zchunk`` of its planes; ``stages`` plane tiles in its
    shared-memory ring, ``smem`` dynamic shared bytes a block, ``blocks``
    (tiles x chunks x shards), ``vec`` (16-byte copies) and the
    ``blocks_per_sm`` an SM holds at least: what the kernel's launch bound
    (registers) and the shared bytes allow."""

    tx: int
    ty: int
    zchunk: int
    stages: int
    smem: int
    blocks: int
    vec: bool
    blocks_per_sm: int

    def args(self):
        """The plan as the C entry point takes it."""
        return (self.tx, self.ty, self.zchunk, self.stages, self.smem,
                self.blocks, int(self.vec))


def zmarch_smem(kind: str, tx: int, ty: int, stages: int,
                itemsize: int) -> int:
    """Dynamic shared bytes of a z-marching block: ``stages`` plane tiles
    of the fields' 3 components (``ty + 2`` rows of ``tx`` cells, their two
    halo columns and 16-byte pads), the transport's two q tiles and the
    filter's H_x tile (3 components of ``ty + 2`` rows of ``tx``)."""
    nf = ZMARCH_FIELDS[kind]
    tile = (ty + 2) * (tx + 2 * (16 // itemsize))
    scratch = 3 * (ty + 2) * tx if kind == "filter" else 0
    return itemsize * (tile * (3 * nf * stages + (6 if nf == 2 else 0))
                       + scratch)


def zmarch_plan_of(nshards: int, nzl: int, nyl: int, nx: int,
                   itemsize: int, aligned: bool, tile, stages: int,
                   zchunk: int, *, keep: int, smem: int,
                   sm_threads: int) -> ShardedStencilPlan:
    """The plan of a z-marching kernel whose walk keeps ``keep`` planes
    below the newest, whose block takes ``smem`` dynamic shared bytes and
    whose launch bound lets an SM hold ``sm_threads`` threads, on
    ``nshards`` shards of (3, ``nzl``, ``nyl``, ``nx``) values of
    ``itemsize`` bytes with the given tile (one of :data:`ZMARCH_TILES`),
    ring ``stages`` (:data:`ZMARCH_STAGE_RANGE`, at least ``2 + keep``) and
    ``zchunk`` planes a block; 16-byte copies where the pointers are
    ``aligned`` and ``nx`` is a multiple of 16 bytes' values."""
    if itemsize not in (4, 8):
        raise ValueError(f"itemsize {itemsize}: float32 or float64 only")
    if min(nshards, nzl, nyl, nx) < 1:
        raise ValueError(
            f"no plan for {nshards} shards of ({nzl}, {nyl}, {nx})")
    tile = tuple(tile)
    if tile not in ZMARCH_TILES:
        raise ValueError(f"tile {tile} is not one of {ZMARCH_TILES}")
    hi = ZMARCH_STAGE_RANGE[1]
    lo = max(ZMARCH_STAGE_RANGE[0], 2 + keep)
    if not lo <= stages <= hi or not 1 <= zchunk <= nzl:
        raise ValueError(f"stages {stages} ({lo}-{hi}) or zchunk {zchunk} "
                         f"(1-{nzl}) out of range")
    if smem > BLOCK_SHARED_MAX:
        raise ValueError(f"{smem} shared bytes a block")
    tx, ty = tile
    tiles = -(-nx // tx) * -(-nyl // ty)
    per_sm = max(1, min(sm_threads // (tx * ty),
                        SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVE)))
    return ShardedStencilPlan(
        tx, ty, zchunk, stages, smem, tiles * -(-nzl // zchunk) * nshards,
        aligned and nx % (16 // itemsize) == 0, per_sm)


def one_wave_plan(plan_of, nzl: int, sms: int) -> ShardedStencilPlan:
    """``plan_of(zchunk)`` with z cut into as many chunks as one wave of
    resident blocks holds (the tiles of all shards times the chunks at
    most ``blocks_per_sm * sms``), at least one, at most ``nzl``, so every
    block marches as far as the card allows and the chunks' extra planes
    are read as rarely as possible."""
    base = plan_of(nzl)
    chunks = max(1, min(nzl, base.blocks_per_sm * sms // base.blocks))
    return plan_of(-(-nzl // chunks))


def sharded_stencil_plan_of(kind: str, nshards: int, nzl: int, nyl: int,
                            nx: int, itemsize: int, aligned: bool,
                            tile, stages: int,
                            zchunk: int) -> ShardedStencilPlan:
    """The plan of ``kind`` (a key of :data:`ZMARCH_FIELDS`) on
    ``nshards`` shards of (3, ``nzl``, ``nyl``, ``nx``) values of
    ``itemsize`` bytes with the given tile, ring ``stages`` (at least ``2 +
    ZMARCH_KEEP[kind]``) and ``zchunk`` planes a block
    (:func:`zmarch_plan_of`)."""
    if kind not in ZMARCH_FIELDS:
        raise ValueError(f"no z-marching kernel {kind!r}")
    tx, ty = tile
    return zmarch_plan_of(
        nshards, nzl, nyl, nx, itemsize, aligned, tile, stages, zchunk,
        keep=ZMARCH_KEEP[kind], smem=zmarch_smem(kind, tx, ty, stages,
                                                 itemsize),
        sm_threads=ZMARCH_SM_THREADS)


@functools.lru_cache(maxsize=64)
def sharded_stencil_plan(kind: str, nshards: int, nzl: int, nyl: int,
                         nx: int, itemsize: int, aligned: bool = True,
                         sms: int = H100_SMS) -> ShardedStencilPlan:
    """The launch plan of the z-marching ``kind`` (a key of
    :data:`ZMARCH_FIELDS`) on ``nshards`` shards of (3, ``nzl``, ``nyl``,
    ``nx``) values of ``itemsize`` bytes, on a card of ``sms`` SMs: the
    tile :data:`ZMARCH_TILE`, the kind's :data:`ZMARCH_STAGES` and one
    wave of z chunks (:func:`one_wave_plan`). The C entry point refuses any
    other plan."""
    stages = ZMARCH_STAGES.get(kind)
    return one_wave_plan(
        lambda zchunk: sharded_stencil_plan_of(
            kind, nshards, nzl, nyl, nx, itemsize, aligned, ZMARCH_TILE,
            stages, zchunk),
        nzl, sms)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_sharded(name, t, mesh: Mesh, like=None):
    if mesh.axis_names != ("z", "y"):
        raise ValueError(f"{name}: the sharded stencils need a 3D (z, y) mesh")
    if not torch.is_tensor(t) or t.ndim != 6 or t.shape[2] != 3 \
            or tuple(t.shape[:2]) != mesh.axis_sizes:
        raise ValueError(
            f"{name}: expected a (pz, py, 3, nzl, nyl, nx) tensor on the "
            f"mesh {mesh.shape}, got "
            f"{tuple(t.shape) if torch.is_tensor(t) else type(t)}")
    if t.dtype not in _single._SUFFIX:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
    if min(t.shape) == 0:
        raise ValueError(f"{name}: empty shard {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if like is not None and (
        t.shape != like.shape or t.dtype != like.dtype
        or t.device != like.device
    ):
        raise ValueError(
            f"{name}: shape/dtype/device {tuple(t.shape)}/{t.dtype}/"
            f"{t.device} differ from {tuple(like.shape)}/{like.dtype}/"
            f"{like.device}")


def _geometry(f):
    """The kernels' integer arguments: shards, a shard's (nzl, nyl, nx) and
    the grid's (NZ, NY)."""
    pz, py, _, nzl, nyl, nx = f.shape
    return pz * py, nzl, nyl, nx, pz * nzl, py * nyl


def _coords(f):
    pz, py, _, nzl, nyl, _ = f.shape
    return _shard_coords((pz, py), nzl, nyl, f.device)


def _halos(f, mesh: Mesh):
    """(zlo, zhi, ylo, yhi): the four halo buffers of ``f``."""
    return (*_halo_z_planes(f, mesh), *_halo_y_rows(f, mesh))


def _zmarch_plan(kind, fields):
    """The plan of a z-marching launch on ``fields`` (each a (field, its
    four halo buffers) tuple): 16-byte copies only where the fields'
    pointers allow them (the halo buffers are fresh allocations; the
    launcher checks every pointer)."""
    f = fields[0][0]
    pz, py, _, nzl, nyl, nx = f.shape
    aligned = all(ts[0].data_ptr() % 16 == 0 for ts in fields)
    return sharded_stencil_plan(kind, pz * py, nzl, nyl, nx,
                                f.element_size(), aligned)


def diffusion_timestep_vector_3d_sharded(vector_field, nu_dt_by_dx2,
                                         mesh: Mesh):
    """Diffusion Euler step ``f + nu_dt_by_dx2 * lap7(f)`` of a sharded
    field, the global wall ring unchanged. Differentiable in the field and
    the prefactor."""
    _check_sharded("vector_field", vector_field, mesh)
    return kernel_or_plain_vjp(_diffusion_sharded,
                               diffusion_timestep_vector_3d_sharded_ref,
                               vector_field, nu_dt_by_dx2, mesh)


def _diffusion_sharded(vector_field, nu_dt_by_dx2, mesh):
    f = vector_field.contiguous()
    halos = _halos(f, mesh)
    if f.device.type == "cpu":
        return _diffusion_on_halos(f, halos, nu_dt_by_dx2, mesh)
    pref = _single._device_tensor(f, nu_dt_by_dx2, 1, "nu_dt_by_dx2")
    out = torch.empty_like(f)
    plan = _zmarch_plan("diffusion", [(f, *halos)])
    _single._launch(
        "sopht_diffusion_vector_3d_sharded_zmarch", f,
        f.data_ptr(), *(t.data_ptr() for t in halos),
        _coords(f).data_ptr(), pref.data_ptr(), out.data_ptr(), *_geometry(f),
        *plan.args(),
    )
    diffusion_timestep_vector_3d_sharded.launches += 1
    return out


def curl_3d_sharded(field, prefactor, mesh: Mesh, add_vector=None, *,
                    compute_l1_max=False):
    """``prefactor * 2 * curl(field)`` of a sharded field (zero on the
    global wall ring) plus the optional (3,) ``add_vector`` on every cell;
    with ``compute_l1_max`` returns ``(u, max |u|_1)``: each shard's
    maximum, then :func:`~sopht_mpi_tpu_torch.parallel.collectives.pmax`
    over the mesh, a 0-d tensor on the field's device. Differentiable in
    the field, the prefactor and the add vector, both outputs."""
    _check_sharded("field", field, mesh)
    if add_vector is not None and not torch.is_tensor(add_vector):
        add_vector = torch.tensor(add_vector, dtype=field.dtype,
                                  device=field.device)
    return kernel_or_plain_vjp(_curl_sharded, curl_3d_sharded_ref, field,
                               prefactor, mesh, add_vector,
                               bool(compute_l1_max))


def _curl_sharded(field, prefactor, mesh, add_vector, compute_l1_max):
    f = field.contiguous()
    halos = _halos(f, mesh)
    if f.device.type == "cpu":
        out = _curl_on_halos(f, halos, prefactor, add_vector, mesh)
        if compute_l1_max:
            shard_max = out.abs().sum(dim=2).amax(dim=(2, 3, 4))
            return out, collectives.pmax(shard_max, mesh)
        return out
    pref = _single._device_tensor(f, prefactor, 1, "prefactor")
    add = (
        None if add_vector is None
        else _single._device_tensor(f, add_vector, 3, "add_vector")
    )
    out = torch.empty_like(f)
    shard_max = (
        torch.zeros(mesh.axis_sizes, dtype=f.dtype, device=f.device)
        if compute_l1_max else None
    )
    plan = _zmarch_plan("curl", [(f, *halos)])
    _single._launch(
        "sopht_curl_3d_sharded_zmarch", f,
        f.data_ptr(), *(t.data_ptr() for t in halos),
        _coords(f).data_ptr(), pref.data_ptr(),
        None if add is None else add.data_ptr(), out.data_ptr(),
        None if shard_max is None else shard_max.data_ptr(), *_geometry(f),
        *plan.args(),
    )
    curl_3d_sharded.launches += 1
    if compute_l1_max:
        return out, collectives.pmax(shard_max, mesh)
    return out


def rotational_curl_add_3d_sharded(vorticity, velocity, prefactor, mesh: Mesh):
    """Fused rotational-form transport ``w + prefactor * curl(u x w)`` of
    sharded fields, the global wall ring of ``w`` unchanged; halos of both
    fields are exchanged. Differentiable in all three arguments."""
    _check_sharded("vorticity", vorticity, mesh)
    _check_sharded("velocity", velocity, mesh, like=vorticity)
    return kernel_or_plain_vjp(_rotational_sharded,
                               rotational_curl_add_3d_sharded_ref, vorticity,
                               velocity, prefactor, mesh)


def _rotational_sharded(vorticity, velocity, prefactor, mesh):
    w, u = vorticity.contiguous(), velocity.contiguous()
    w_halos, u_halos = _halos(w, mesh), _halos(u, mesh)
    if w.device.type == "cpu":
        return _rotational_on_halos(w, u, w_halos, u_halos, prefactor, mesh)
    pref = _single._device_tensor(w, prefactor, 1, "prefactor")
    out = torch.empty_like(w)
    plan = _zmarch_plan("rotational", [(w, *w_halos), (u, *u_halos)])
    _single._launch(
        "sopht_rotational_curl_add_3d_sharded_zmarch", w,
        *(t.data_ptr() for t in (w, *w_halos, u, *u_halos)),
        _coords(w).data_ptr(), pref.data_ptr(), out.data_ptr(), *_geometry(w),
        *plan.args(),
    )
    rotational_curl_add_3d_sharded.launches += 1
    return out


def diffusion_penalise_sharded_supported(global_shape, mesh: Mesh,
                                         width: int) -> bool:
    """Whether the fused sharded diffusion + sponge kernel handles this
    (global shape, mesh, sponge width): a sponge, more than ``2 width``
    cells on every global axis, the grid dividing over the mesh, and every
    clamp source in its own shard (``nzl >= 2 width``, ``nyl >= 2 width``).
    Otherwise :func:`diffusion_penalise_vector_3d_sharded` runs the sharded
    diffusion kernel and the sponge on the assembled field. The JAX gate's
    tiling terms (rows a multiple of 8, the VMEM budget) have no
    counterpart."""
    if width <= 0:
        return False
    _, nz, ny, nx = global_shape
    if nz <= 2 * width or ny <= 2 * width or nx <= 2 * width:
        return False
    pz, py = mesh.shape["z"], mesh.shape["y"]
    if nz % pz or ny % py:
        return False
    return nz // pz >= 2 * width and ny // py >= 2 * width


def _global_shape(f):
    pz, py, _, nzl, nyl, nx = f.shape
    return (3, pz * nzl, py * nyl, nx)


def diffusion_penalise_vector_3d_sharded(vector_field, nu_dt_by_dx2,
                                         width: int, mesh: Mesh):
    """Fused diffusion Euler step and wall sponge of a sharded field,
    ``penalise_field_boundary_vector_3d(diffusion_timestep_vector_3d(f,
    nu_dt_by_dx2), width)`` on the global grid. Where
    :func:`diffusion_penalise_sharded_supported` is False it runs the
    sharded diffusion kernel and then the single-device sponge on the
    assembled field. Differentiable in the field and the prefactor."""
    _check_sharded("vector_field", vector_field, mesh)
    width = int(width)
    if not diffusion_penalise_sharded_supported(
            _global_shape(vector_field), mesh, width):
        out = diffusion_timestep_vector_3d_sharded(
            vector_field, nu_dt_by_dx2, mesh)
        if width == 0:
            return out
        return apply_assembled(
            lambda f: _single.penalise_field_boundary_vector_3d(f, width),
            mesh, out)
    return kernel_or_plain_vjp(_diffpen_sharded,
                               diffusion_penalise_vector_3d_sharded_ref,
                               vector_field, nu_dt_by_dx2, width, mesh)


def _diffpen_sharded(vector_field, nu_dt_by_dx2, width, mesh):
    f = vector_field.contiguous()
    halos = _halos(f, mesh)
    if f.device.type == "cpu":
        return _sponge_in_shards(
            _diffusion_on_halos(f, halos, nu_dt_by_dx2, mesh), width, mesh)
    pref = _single._device_tensor(f, nu_dt_by_dx2, 1, "nu_dt_by_dx2")
    out = torch.empty_like(f)
    ramp = _single._sponge_ramp(width, f.dtype, f.device)
    plan = _zmarch_plan("sponge", [(f, *halos)])
    _single._launch(
        "sopht_diffusion_penalise_vector_3d_sharded_zmarch", f,
        f.data_ptr(), *(t.data_ptr() for t in halos),
        _coords(f).data_ptr(), pref.data_ptr(), ramp.data_ptr(),
        out.data_ptr(), *_geometry(f), width, *plan.args(),
    )
    diffusion_penalise_vector_3d_sharded.launches += 1
    return out


#: the wrappers, for code that resets or reads every launch count
KERNELS = (
    rotational_curl_add_3d_sharded,
    diffusion_penalise_vector_3d_sharded,
    curl_3d_sharded,
    diffusion_timestep_vector_3d_sharded,
)
for _fn in KERNELS:
    _fn.launches = 0
