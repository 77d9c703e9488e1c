"""Hopper CUDA kernels for the 3D stencils of the Navier-Stokes step, with
their plain PyTorch versions.

Each wrapper takes (3, nz, ny, nx) float32 or float64 fields and:

- on a CUDA tensor launches its kernel from ``csrc/stencils_3d.cu`` on the
  current stream, without synchronising, and adds one to its ``launches``
  count (or raises: there is no fallback);
- on a CPU tensor returns its plain version (``*_ref``), the composition
  the JAX package uses as the kernel's VJP reference.

Prefactors may be numbers or 0-d tensors on the field's device; the kernels
read them from device memory, so a step needs no host sync.

Reverse mode: where autograd records a call (a tensor argument requires a
gradient), the wrapper goes through ``_autograd.PlainVJP``, whose backward
is the VJP of the plain version on the saved inputs, the JAX package's rule
for these kernels. Tensor prefactors and ``add_vector`` receive gradients.
The backward launches no kernel: ``launches`` counts forward launches.

Replaced TPU kernels (``sopht_mpi_tpu/ops/pallas_stencils_3d.py``):
:func:`rotational_curl_add_3d` <- ``rotational_curl_add_3d_pallas``,
:func:`diffusion_penalise_vector_3d` <- ``diffusion_penalise_vector_3d_pallas``,
:func:`curl_3d` <- ``curl_3d_pallas``,
:func:`diffusion_timestep_vector_3d` <- ``diffusion_timestep_vector_3d_pallas``,
:func:`laplacian_filter_vector_3d` <- ``laplacian_filter_vector_3d_pallas``,
:func:`penalise_field_boundary_vector_3d` <-
``penalise_field_boundary_vector_3d_pallas``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sopht_mpi_tpu_torch.ops import stencils_3d as _plain
from sopht_mpi_tpu_torch.ops._autograd import kernel_or_plain_vjp
from sopht_mpi_tpu_torch.ops.elementwise import cross_product_3d

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sopht_rotational_curl_add_3d": (_P, _P, _P, _P, _I, _I, _I, _P),
    "sopht_diffusion_penalise_vector_3d": (_P, _P, _P, _I, _I, _I, _I, _P),
    "sopht_curl_3d": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "sopht_diffusion_vector_3d": (_P, _P, _P, _I, _I, _I, _P),
    # buf, orig (or null), out, (nz, ny, nx), then the plan (tx, ty,
    # zchunk, stages, smem, blocks, vec)
    "sopht_mult_filter_3d_zmarch": (_P,) * 3 + (_I,) * 10 + (_P,),
    # f, out, (nz, ny, nx), the order, then the plan
    "sopht_conv_filter_3d_zmarch": (_P,) * 2 + (_I,) * 11 + (_P,),
    "sopht_conv_filter_line_3d": (_P, _P, _I, _I, _I, _I, _I, _P),
    "sopht_conv_filter_z_pass_3d": (_P, _P, _P, _I, _I, _I, _P),
    "sopht_penalise_vector_3d": (_P, _P, _P, _I, _I, _I, _I, _P),
    # the z-marching sharded kernels (wrappers in
    # cuda_stencils_3d_sharded.py): each field and its four halo buffers
    # (zlo, zhi, ylo, yhi), the shards' global offsets, ... (the sponge's
    # ramp values after the prefactor), (shards, nz, ny, nx) of a shard, the
    # grid's (NZ, NY), the sponge's width (diffusion + sponge only), then
    # the plan (tx, ty, zchunk, stages, smem, blocks, vec)
    "sopht_curl_3d_sharded_zmarch": (
        (_P,) * 10 + (_I,) * 13 + (_P,)),
    "sopht_rotational_curl_add_3d_sharded_zmarch": (
        (_P,) * 13 + (_I,) * 13 + (_P,)),
    "sopht_diffusion_vector_3d_sharded_zmarch": (
        (_P,) * 8 + (_I,) * 13 + (_P,)),
    "sopht_diffusion_penalise_vector_3d_sharded_zmarch": (
        (_P,) * 9 + (_I,) * 14 + (_P,)),
}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/stencils_3d.cu``."""
    from sopht_mpi_tpu_torch._build import load_library

    lib = load_library("stencils_3d", ("stencils_3d.cu",))
    for base, argtypes in _SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.sopht_error_string.argtypes = (ctypes.c_int,)
    lib.sopht_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def rotational_curl_add_3d_ref(vorticity, velocity, prefactor):
    """``w + prefactor * curl(u x w)``, the wall ring of ``w`` unchanged."""
    return _plain.update_vorticity_from_velocity_forcing_3d(
        vorticity, cross_product_3d(velocity, vorticity), prefactor
    )


def diffusion_penalise_vector_3d_ref(vector_field, nu_dt_by_dx2, width: int):
    """``penalise_field_boundary_vector_3d(diffusion_timestep_vector_3d(f,
    nu_dt_by_dx2), width)``."""
    return _plain.penalise_field_boundary_vector_3d(
        _plain.diffusion_timestep_vector_3d(vector_field, nu_dt_by_dx2), width
    )


def curl_3d_ref(field, prefactor, add_vector=None, compute_l1_max=False):
    """``curl_3d(field, prefactor)`` plus an optional per-component
    constant; with ``compute_l1_max`` also ``max |u_x|+|u_y|+|u_z|``."""
    out = _plain.curl_3d(field, prefactor)
    if add_vector is not None:
        out = out + add_vector.to(out.dtype).reshape(3, 1, 1, 1)
    if compute_l1_max:
        return out, out.abs().sum(dim=0).max()
    return out


def diffusion_timestep_vector_3d_ref(vector_field, nu_dt_by_dx2):
    """``f + nu_dt_by_dx2 * lap7(f)``, the wall ring unchanged."""
    return _plain.diffusion_timestep_vector_3d(vector_field, nu_dt_by_dx2)


def laplacian_filter_vector_3d_ref(vector_field, filter_order: int,
                                   filter_type: str):
    """The Laplacian filter of ``ops/stencils_3d.py``."""
    return _plain.laplacian_filter_vector_3d(
        vector_field, filter_order, filter_type
    )


def mult_filter_pass_ref(buf, orig=None):
    """One launch of the multiplicative filter's kernel in plain PyTorch:
    ``res = clear . H_z . clear . H_y . clear . H_x (buf)``, the plain
    version's passes, or ``orig - res``."""
    hp = _plain._highpass_1d
    res = torch.stack([
        hp(hp(hp(c, _plain._XAX), _plain._YAX), _plain._ZAX) for c in buf])
    return res if orig is None else orig - res


def penalise_field_boundary_vector_3d_ref(vector_field, width: int):
    """The wall sponge of ``ops/stencils_3d.py``."""
    return _plain.penalise_field_boundary_vector_3d(vector_field, width)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def diffusion_penalise_supported(shape, width: int) -> bool:
    """The fused kernel needs a sponge (``width > 0``) and more than
    ``2 width`` cells on every axis."""
    _, nz, ny, nx = shape
    return width > 0 and min(nz, ny, nx) > 2 * width


def _check_field(name, t, like=None):
    if not torch.is_tensor(t) or t.ndim != 4 or t.shape[0] != 3:
        raise ValueError(f"{name}: expected a (3, nz, ny, nx) tensor")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
    if min(t.shape) == 0:
        raise ValueError(f"{name}: empty grid {tuple(t.shape)}")
    if like is not None and (
        t.shape != like.shape or t.dtype != like.dtype
        or t.device != like.device
    ):
        raise ValueError(
            f"{name}: shape/dtype/device {tuple(t.shape)}/{t.dtype}/"
            f"{t.device} differ from {tuple(like.shape)}/{like.dtype}/"
            f"{like.device}"
        )
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def _device_tensor(field, value, numel, name):
    """``value`` as a contiguous tensor of the field's dtype on its device.
    A number is filled in on the device (no host copy); a sequence is
    copied from the host; a tensor must already lie on the device."""
    if not torch.is_tensor(value):
        if numel == 1:
            return torch.full((), float(value), dtype=field.dtype,
                              device=field.device)
        value = torch.tensor(value, dtype=field.dtype, device=field.device)
    if value.device != field.device:
        raise ValueError(
            f"{name} lies on {value.device}, the field on {field.device}"
        )
    if value.numel() != numel:
        raise ValueError(f"{name}: expected {numel} values, got {value.numel()}")
    return value.to(field.dtype).contiguous()


def _launch(fn_base, field, *args):
    fn = getattr(library(), f"{fn_base}_{_SUFFIX[field.dtype]}")
    with torch.cuda.device(field.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = library().sopht_error_string(err).decode()
        raise RuntimeError(f"{fn_base} launch failed: CUDA error {err} ({msg})")


def rotational_curl_add_3d(vorticity, velocity, prefactor):
    """Fused rotational-form transport ``w + prefactor * curl(u x w)``
    (``prefactor = dt/(2 dx)``), the wall ring of ``w`` unchanged;
    differentiable in all three arguments."""
    _check_field("vorticity", vorticity)
    _check_field("velocity", velocity, like=vorticity)
    return kernel_or_plain_vjp(_rotational_curl_add_3d,
                               rotational_curl_add_3d_ref, vorticity,
                               velocity, prefactor)


def _rotational_curl_add_3d(vorticity, velocity, prefactor):
    if vorticity.device.type == "cpu":
        return rotational_curl_add_3d_ref(vorticity, velocity, prefactor)
    pref = _device_tensor(vorticity, prefactor, 1, "prefactor")
    out = torch.empty_like(vorticity)
    _, nz, ny, nx = vorticity.shape
    _launch(
        "sopht_rotational_curl_add_3d", vorticity,
        vorticity.data_ptr(), velocity.data_ptr(), pref.data_ptr(),
        out.data_ptr(), nz, ny, nx,
    )
    rotational_curl_add_3d.launches += 1
    return out


def diffusion_penalise_vector_3d(vector_field, nu_dt_by_dx2, width: int):
    """Fused diffusion Euler step and wall sponge:
    ``penalise_field_boundary_vector_3d(diffusion_timestep_vector_3d(f,
    nu_dt_by_dx2), width)``. Needs :func:`diffusion_penalise_supported`.
    Differentiable in the field and the prefactor."""
    _check_field("vector_field", vector_field)
    width = int(width)
    if not diffusion_penalise_supported(vector_field.shape, width):
        raise ValueError(
            f"diffusion_penalise_vector_3d needs width > 0 and more than "
            f"2 * width cells per axis; got width {width}, shape "
            f"{tuple(vector_field.shape)}"
        )
    return kernel_or_plain_vjp(_diffusion_penalise_vector_3d,
                               diffusion_penalise_vector_3d_ref, vector_field,
                               nu_dt_by_dx2, width)


def _diffusion_penalise_vector_3d(vector_field, nu_dt_by_dx2, width):
    if vector_field.device.type == "cpu":
        return diffusion_penalise_vector_3d_ref(vector_field, nu_dt_by_dx2, width)
    pref = _device_tensor(vector_field, nu_dt_by_dx2, 1, "nu_dt_by_dx2")
    out = torch.empty_like(vector_field)
    _, nz, ny, nx = vector_field.shape
    _launch(
        "sopht_diffusion_penalise_vector_3d", vector_field,
        vector_field.data_ptr(), pref.data_ptr(), out.data_ptr(),
        nz, ny, nx, width,
    )
    diffusion_penalise_vector_3d.launches += 1
    return out


def curl_3d(field, prefactor, add_vector=None, compute_l1_max=False):
    """``prefactor * 2 * curl(field)`` (``prefactor = 0.5/dx``, zero on
    the wall ring) plus the optional (3,) ``add_vector`` on every cell;
    with ``compute_l1_max`` returns ``(u, max |u_x|+|u_y|+|u_z|)``, the
    maximum a 0-d tensor on the field's device. Differentiable in the field,
    the prefactor and the add vector, both outputs."""
    _check_field("field", field)
    if add_vector is not None and not torch.is_tensor(add_vector):
        add_vector = torch.tensor(add_vector, dtype=field.dtype,
                                  device=field.device)
    return kernel_or_plain_vjp(_curl_3d, curl_3d_ref, field, prefactor,
                               add_vector, bool(compute_l1_max))


def _curl_3d(field, prefactor, add_vector, compute_l1_max):
    if field.device.type == "cpu":
        return curl_3d_ref(field, prefactor, add_vector, compute_l1_max)
    pref = _device_tensor(field, prefactor, 1, "prefactor")
    add = (
        None if add_vector is None
        else _device_tensor(field, add_vector, 3, "add_vector")
    )
    out = torch.empty_like(field)
    l1 = (
        torch.zeros((), dtype=field.dtype, device=field.device)
        if compute_l1_max else None
    )
    _, nz, ny, nx = field.shape
    _launch(
        "sopht_curl_3d", field,
        field.data_ptr(), pref.data_ptr(),
        None if add is None else add.data_ptr(), out.data_ptr(),
        None if l1 is None else l1.data_ptr(), nz, ny, nx,
    )
    curl_3d.launches += 1
    return (out, l1) if compute_l1_max else out


def diffusion_timestep_vector_3d(vector_field, nu_dt_by_dx2):
    """Diffusion Euler step ``f + nu_dt_by_dx2 * lap7(f)``, the wall ring
    unchanged. Differentiable in the field and the prefactor."""
    _check_field("vector_field", vector_field)
    return kernel_or_plain_vjp(_diffusion_timestep_vector_3d,
                               diffusion_timestep_vector_3d_ref, vector_field,
                               nu_dt_by_dx2)


def _diffusion_timestep_vector_3d(vector_field, nu_dt_by_dx2):
    if vector_field.device.type == "cpu":
        return diffusion_timestep_vector_3d_ref(vector_field, nu_dt_by_dx2)
    pref = _device_tensor(vector_field, nu_dt_by_dx2, 1, "nu_dt_by_dx2")
    out = torch.empty_like(vector_field)
    _, nz, ny, nx = vector_field.shape
    _launch(
        "sopht_diffusion_vector_3d", vector_field,
        vector_field.data_ptr(), pref.data_ptr(), out.data_ptr(), nz, ny, nx,
    )
    diffusion_timestep_vector_3d.launches += 1
    return out


def filter_plan(vector_field):
    """The launch plan of ``mult_filter_zmarch_kernel`` on a (3, nz, ny,
    nx) field: the z-marching plan of kind ``"filter"`` on one shard
    (``cuda_stencils_3d_sharded.sharded_stencil_plan``), 16-byte copies
    where the field's pointer allows them."""
    from sopht_mpi_tpu_torch.ops.cuda_stencils_3d_sharded import (
        sharded_stencil_plan,
    )

    _, nz, ny, nx = vector_field.shape
    return sharded_stencil_plan("filter", 1, nz, ny, nx,
                                vector_field.element_size(),
                                vector_field.data_ptr() % 16 == 0)


#: the convolution filter's orders that ``conv_filter_zmarch_kernel`` has
#: instances for
CONV_FILTER_ORDERS = range(1, 6)
#: the convolution filter's tile by order: 64 x 8 at two blocks an SM up to
#: order 2, 32 x 16 (fewer halo rows a cell) at one block above (the
#: fastest at orders 1 and 5 at the rod's (3, 256, 64, 256), 256^3 and the
#: freely rotating rod's (3, 64, 64, 128) on one H100,
#: ``tools/probe_filter.py --sweep conv``), and its ring stages
CONV_FILTER_TILES = {1: (64, 8), 2: (64, 8), 3: (32, 16), 4: (32, 16),
                     5: (32, 16)}
CONV_FILTER_STAGES = 4


def conv_filter_smem(order: int, tx: int, ty: int, stages: int,
                     itemsize: int) -> int:
    """Dynamic shared bytes of a ``conv_filter_zmarch_kernel`` block:
    ``stages`` plane tiles of 3 components with an ``order``-cell halo
    (``ty + 2 order`` rows of ``tx`` cells and ``order`` rounded up to 16
    bytes' values on each side), the x-staged rows (3 components of ``ty +
    2 order`` rows of ``tx``) and above order 2 the y-staged cells (3 of
    ``ty`` rows of ``tx``)."""
    v = 16 // itemsize
    pad, rows = -(-order // v) * v, ty + 2 * order
    return itemsize * (3 * stages * rows * (tx + 2 * pad) + 3 * rows * tx
                       + (3 * ty * tx if order > 2 else 0))


def conv_filter_sm_threads(order: int) -> int:
    """Threads an SM holds at the launch bound of the order's kernel: 1,024
    (64 registers a thread) up to order 2, else 512 (128 registers: the z
    stage keeps 3 (3 order - 1) values a thread; ``conv_sm_threads`` in the
    source)."""
    return 1024 if order <= 2 else 512


def conv_filter_plan_of(order: int, nz: int, ny: int, nx: int,
                        itemsize: int, aligned: bool, tile, stages: int,
                        zchunk: int):
    """The plan of ``conv_filter_zmarch_kernel`` at ``order`` (one of
    :data:`CONV_FILTER_ORDERS`) on a (3, ``nz``, ``ny``, ``nx``) field of
    ``itemsize``-byte values with the given tile, ring ``stages`` and
    ``zchunk`` planes a block: a z-marching plan on one shard whose walk
    keeps the newest plane alone
    (``cuda_stencils_3d_sharded.zmarch_plan_of``)."""
    from sopht_mpi_tpu_torch.ops.cuda_stencils_3d_sharded import (
        zmarch_plan_of,
    )

    if order not in CONV_FILTER_ORDERS:
        raise ValueError(f"no convolution filter instance of order {order}")
    tx, ty = tile
    return zmarch_plan_of(
        1, nz, ny, nx, itemsize, aligned, tile, stages, zchunk, keep=0,
        smem=conv_filter_smem(order, tx, ty, stages, itemsize),
        sm_threads=conv_filter_sm_threads(order))


@functools.lru_cache(maxsize=64)
def conv_filter_launch_plan(order: int, nz: int, ny: int, nx: int,
                            itemsize: int, aligned: bool = True,
                            sms: int | None = None):
    """The launch plan of ``conv_filter_zmarch_kernel`` at ``order`` on a
    (3, ``nz``, ``ny``, ``nx``) field on a card of ``sms`` SMs (an H100's
    by default): the order's :data:`CONV_FILTER_TILES`,
    :data:`CONV_FILTER_STAGES` and one wave of z chunks. The C entry point
    refuses any other plan."""
    from sopht_mpi_tpu_torch.ops.cuda_stencils_3d_sharded import (
        H100_SMS,
        one_wave_plan,
    )

    return one_wave_plan(
        lambda zchunk: conv_filter_plan_of(
            order, nz, ny, nx, itemsize, aligned,
            CONV_FILTER_TILES.get(order), CONV_FILTER_STAGES,
            zchunk),
        nz, H100_SMS if sms is None else sms)


def conv_filter_plan(vector_field, order: int):
    """The launch plan of ``conv_filter_zmarch_kernel`` at ``order`` on a
    (3, nz, ny, nx) field (:func:`conv_filter_launch_plan`), 16-byte copies
    where the field's pointer allows them."""
    _, nz, ny, nx = vector_field.shape
    return conv_filter_launch_plan(order, nz, ny, nx,
                                   vector_field.element_size(),
                                   vector_field.data_ptr() % 16 == 0)


def laplacian_filter_vector_3d(vector_field, filter_order: int,
                               filter_type: str):
    """Laplacian (vorticity-stabilisation) filter, per-application wall
    clearing included. ``multiplicative``: ``f - (H_z H_y H_x)^order f``,
    one launch of the z-marching ``mult_filter_zmarch_kernel`` per
    application under :func:`filter_plan` (the last one subtracts from
    ``f``); ``convolution``: per axis x, y, z ``f - H_axis^order f``, one
    launch of the z-marching ``conv_filter_zmarch_kernel`` for all three
    axes under :func:`conv_filter_plan` up to order 5 (its instances; the
    plain version's values for a finite field); above
    that the line route, one launch of ``conv_filter_line_kernel`` for each
    in-plane axis and ``order`` of ``conv_filter_z_pass_kernel`` for z.
    ``launches`` counts every launch. Differentiable in the field: one
    backward over all the passes, the VJP of the plain filter."""
    _check_field("vector_field", vector_field)
    if not isinstance(filter_order, int) or filter_order < 0:
        raise ValueError("Invalid filter order")
    if filter_type not in ("multiplicative", "convolution"):
        raise ValueError("Invalid filter type")
    if filter_order == 0:
        return vector_field
    return kernel_or_plain_vjp(_laplacian_filter_vector_3d,
                               laplacian_filter_vector_3d_ref, vector_field,
                               filter_order, filter_type)


def _laplacian_filter_vector_3d(vector_field, filter_order, filter_type):
    if vector_field.device.type == "cpu":
        return laplacian_filter_vector_3d_ref(
            vector_field, filter_order, filter_type
        )
    _, nz, ny, nx = vector_field.shape

    def three_plane_pass(fn_base, buf, orig, *plan):
        out = torch.empty_like(vector_field)
        _launch(
            fn_base, vector_field, buf.data_ptr(),
            None if orig is None else orig.data_ptr(), out.data_ptr(),
            nz, ny, nx, *plan,
        )
        laplacian_filter_vector_3d.launches += 1
        return out

    if filter_type == "multiplicative":
        # a pass reads the field or a fresh (16-byte aligned) allocation:
        # the field's plan holds for every pass
        plan = filter_plan(vector_field).args()
        buf = vector_field
        for it in range(filter_order):
            last = it == filter_order - 1
            buf = three_plane_pass(
                "sopht_mult_filter_3d_zmarch", buf,
                vector_field if last else None, *plan,
            )
        return buf
    if filter_order in CONV_FILTER_ORDERS:
        out = torch.empty_like(vector_field)
        _launch(
            "sopht_conv_filter_3d_zmarch", vector_field,
            vector_field.data_ptr(), out.data_ptr(), nz, ny, nx, filter_order,
            *conv_filter_plan(vector_field, filter_order).args(),
        )
        laplacian_filter_vector_3d.launches += 1
        return out
    field = vector_field
    for axis in (0, 1):  # the x stage, then the y stage
        out = torch.empty_like(vector_field)
        _launch(
            "sopht_conv_filter_line_3d", vector_field, field.data_ptr(),
            out.data_ptr(), nz, ny, nx, axis, filter_order,
        )
        laplacian_filter_vector_3d.launches += 1
        field = out
    buf = field
    for it in range(filter_order):
        last = it == filter_order - 1
        buf = three_plane_pass(
            "sopht_conv_filter_z_pass_3d", buf, field if last else None
        )
    return buf


def penalise_supported(shape, width: int) -> bool:
    """The sponge kernel runs for ``width > 0`` and more than ``2 width``
    cells on every axis; elsewhere the JAX package's Pallas function takes
    its jnp path, and so does :func:`penalise_field_boundary_vector_3d`."""
    _, nz, ny, nx = shape
    return width > 0 and min(nz, ny, nx) > 2 * width


@functools.cache
def _sponge_ramp(width: int, dtype, device) -> torch.Tensor:
    """``sin(pi k / 2 width)``, k < width, computed in double on the host
    and copied to the device once."""
    ramp = np.sin(0.5 * np.pi * np.arange(width) / width)
    return torch.tensor(ramp, dtype=dtype, device=device)


def penalise_field_boundary_vector_3d(vector_field, width: int):
    """Wall sponge: ``r(z) r(y) r(x) f[clamp(z), clamp(y), clamp(x)]`` with
    the clamp to ``[width - 1, n - width]`` and the sine ramp over the
    ``width`` cells next to each wall. Where :func:`penalise_supported` is
    False it returns the plain version on any device, as the JAX function
    does (the identity at ``width == 0``). Differentiable in the field."""
    _check_field("vector_field", vector_field)
    width = int(width)
    if not penalise_supported(vector_field.shape, width):
        return penalise_field_boundary_vector_3d_ref(vector_field, width)
    return kernel_or_plain_vjp(_penalise_field_boundary_vector_3d,
                               penalise_field_boundary_vector_3d_ref,
                               vector_field, width)


def _penalise_field_boundary_vector_3d(vector_field, width):
    if vector_field.device.type == "cpu":
        return penalise_field_boundary_vector_3d_ref(vector_field, width)
    ramp = _sponge_ramp(width, vector_field.dtype, vector_field.device)
    out = torch.empty_like(vector_field)
    _, nz, ny, nx = vector_field.shape
    _launch(
        "sopht_penalise_vector_3d", vector_field,
        vector_field.data_ptr(), ramp.data_ptr(), out.data_ptr(),
        nz, ny, nx, width,
    )
    penalise_field_boundary_vector_3d.launches += 1
    return out


#: the wrappers, for code that resets or reads every launch count
KERNELS = (
    rotational_curl_add_3d,
    diffusion_penalise_vector_3d,
    curl_3d,
    diffusion_timestep_vector_3d,
    laplacian_filter_vector_3d,
    penalise_field_boundary_vector_3d,
)
for _fn in KERNELS:
    _fn.launches = 0
