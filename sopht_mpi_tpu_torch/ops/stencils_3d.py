"""3D Eulerian grid stencil ops, plain PyTorch (counterpart of
``sopht_mpi_tpu/ops/stencils_3d.py``).

These are the plain versions the Hopper kernels of
:mod:`sopht_mpi_tpu_torch.ops.cuda_stencils_3d` are held against, and what
the CPU path runs. Conventions as in the JAX package: scalar fields
(nz, ny, nx); vector fields (3, nz, ny, nx) with components (x, y, z), so
vector component c varies along grid axis (2 - c).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sopht_mpi_tpu_torch.ops._stencil_utils import (
    axslice,
    central_diff_interior,
    eno3_divergence_interior,
    laplacian_interior,
    pad_all,
)

_X, _Y, _Z = 0, 1, 2  # vector component indices
_ZAX, _YAX, _XAX = 0, 1, 2  # grid axes of a scalar field


def diffusion_flux_3d(field, prefactor):
    """``prefactor * discrete_laplacian(field)`` of a scalar field, zero in
    a width-1 band at the walls."""
    return pad_all(prefactor * laplacian_interior(field), 1)


def diffusion_timestep_3d(field, nu_dt_by_dx2):
    """Euler-forward diffusion of a scalar field: ``field += flux``."""
    return field + diffusion_flux_3d(field, nu_dt_by_dx2)


def diffusion_timestep_vector_3d(vector_field, nu_dt_by_dx2):
    """``f + nu_dt_by_dx2 * laplacian(f)`` with the width-1 wall ring left
    unchanged."""
    return vector_field + pad_all(
        nu_dt_by_dx2 * laplacian_interior(vector_field, ndim_offset=1),
        1,
        start_axis=1,
    )


def advection_flux_conservative_eno3_3d(field, velocity, inv_dx):
    """Conservative ENO3 advective flux of a scalar field, summed over the
    three axes: ``inv_dx * div(u q)`` (undivided differences); the
    advection timestep passes ``inv_dx = -dt/dx`` and adds the result."""
    div = eno3_divergence_interior(field, velocity[_Z], axis=_ZAX)
    div = div + eno3_divergence_interior(field, velocity[_Y], axis=_YAX)
    div = div + eno3_divergence_interior(field, velocity[_X], axis=_XAX)
    return inv_dx * div


def advection_timestep_eno3_3d(field, velocity, dt_by_dx):
    """Euler-forward conservative ENO3 advection of a scalar field."""
    return field + advection_flux_conservative_eno3_3d(
        field, velocity, -dt_by_dx)


def advection_timestep_eno3_vector_3d(vector_field, velocity, dt_by_dx):
    """:func:`advection_timestep_eno3_3d` on each component, all advected
    by the one ``velocity``."""
    return torch.stack([advection_timestep_eno3_3d(f, velocity, dt_by_dx)
                        for f in vector_field])


def curl_3d(field, prefactor):
    """``prefactor * 2 * nabla x field`` via central differences with
    ``prefactor = 0.5/dx``; zero band width 1 at the walls. ``field`` is a
    (3, nz, ny, nx) vector field; returns the same shape."""
    d = lambda comp, ax: central_diff_interior(field[comp], axis=ax)
    curl_x = d(_Z, _YAX) - d(_Y, _ZAX)
    curl_y = d(_X, _ZAX) - d(_Z, _XAX)
    curl_z = d(_Y, _XAX) - d(_X, _YAX)
    return pad_all(
        prefactor * torch.stack([curl_x, curl_y, curl_z]), 1, start_axis=1
    )


def update_vorticity_from_velocity_forcing_3d(
    vorticity, velocity_forcing, prefactor
):
    """``vorticity += prefactor * 2 * curl(velocity_forcing)`` on the
    interior with ``prefactor = dt/(2 dx)``; the wall ring is unchanged."""
    return vorticity + curl_3d(velocity_forcing, prefactor)


def divergence_3d(field, inv_dx):
    """Central-difference divergence of a (3, nz, ny, nx) vector field,
    ``0.5 inv_dx (d_x u_x + d_y u_y + d_z u_z)``; zero in a width-1 band at
    the walls."""
    div = (
        central_diff_interior(field[_X], axis=_XAX)
        + central_diff_interior(field[_Y], axis=_YAX)
        + central_diff_interior(field[_Z], axis=_ZAX)
    )
    return pad_all(0.5 * inv_dx * div, 1)


def update_vorticity_from_penalised_velocity_3d(
    vorticity, penalised_velocity, velocity, prefactor
):
    """``vorticity += prefactor * 2 * curl(penalised_velocity - velocity)``
    on the interior; the wall ring is unchanged."""
    return vorticity + curl_3d(penalised_velocity - velocity, prefactor)


def brinkmann_penalise_3d(velocity, penalty_factor, char_field,
                          penalty_velocity):
    """Implicit Brinkmann penalisation toward ``penalty_velocity`` inside
    the body (``char_field`` in [0, 1]):
    ``u = (u + k chi u_body) / (1 + k chi)``."""
    denom = 1.0 + penalty_factor * char_field
    return (velocity + penalty_factor * char_field * penalty_velocity) / denom


def char_func_from_level_set_via_sine_heaviside_3d(level_set, blend_width):
    """Smooth characteristic function from a signed-distance level set
    (positive inside the body), blended over ``blend_width``:
    ``H = 0.5 (1 + phi/w + sin(pi phi/w)/pi)`` clipped to [0, 1].

    The sine term is written ``x sinc(x)`` (x = phi/w), which is
    ``sin(pi x)/pi``: on the CPU ``torch.sin`` goes to MKL's vector math,
    split over threads in chunks of 2048 values, and the first such call in
    a process has returned values off by up to 1.5e-4 in a worker thread's
    chunk; ``torch.sinc`` takes the C library's scalar ``sin``."""
    phi = level_set / blend_width
    h = 0.5 * (1.0 + phi + phi * torch.sinc(phi))
    return torch.clamp(h, 0.0, 1.0)


def _penalise_axes(field, width: int, axes):
    ramp = torch.sin(
        0.5 * math.pi
        * torch.arange(width, dtype=field.dtype, device=field.device)
        / width
    )
    for ax in axes:
        shape = [1] * field.ndim
        shape[ax] = width
        r = ramp.reshape(shape)
        edge_lo = axslice(field, width - 1, width, ax)
        edge_hi = axslice(field, -width, -width + 1 if width > 1 else None, ax)
        mid = axslice(field, width, -width, ax)
        field = torch.cat(
            [edge_lo * r, mid, edge_hi * torch.flip(r, dims=(ax,))], dim=ax
        )
    return field


def penalise_field_boundary_3d(field, width: int):
    """Sponge-penalise toward the walls over ``width`` cells: the first
    ``width`` cells of each axis take the value of cell ``width - 1``
    times a sine ramp ``sin(pi/2 i/width)`` (mirrored at the high wall).
    Applied along x, then y, then z."""
    if width == 0:
        return field
    return _penalise_axes(field, width, (_XAX, _YAX, _ZAX))


def penalise_field_boundary_vector_3d(vector_field, width: int):
    """:func:`penalise_field_boundary_3d` on each component."""
    if width == 0:
        return vector_field
    return _penalise_axes(vector_field, width, (3, 2, 1))


# ---------------------------------------------------------------------------
# Laplacian (vorticity-stabilisation) filter: the CPU composition of the
# filtered transport path (Jeanmart & Winckelmans 2007).
# ---------------------------------------------------------------------------


def _highpass_1d(field, axis: int):
    """Directional high-pass ``0.25 (2 f[i] - f[i+1] - f[i-1])`` along one
    axis, then zero a width-1 band at every wall."""
    inner = 0.25 * (
        2.0 * axslice(field, 1, -1, axis)
        - axslice(field, 2, None, axis)
        - axslice(field, 0, -2, axis)
    )
    pad = [0, 0] * field.ndim
    k = 2 * (field.ndim - 1 - axis)
    pad[k], pad[k + 1] = 1, 1
    out = F.pad(inner, pad)
    return pad_all(out[1:-1, 1:-1, 1:-1], 1)


def laplacian_filter_3d(field, filter_order: int, filter_type: str):
    """multiplicative: ``field -= (H_z H_y H_x)^order field``;
    convolution: sequentially per axis a, ``field -= H_a^order field``."""
    if filter_order < 0 or not isinstance(filter_order, int):
        raise ValueError("Invalid filter order")
    if filter_order == 0:
        return field
    if filter_type == "multiplicative":
        buf = field
        for _ in range(filter_order):
            buf = _highpass_1d(buf, _XAX)
            buf = _highpass_1d(buf, _YAX)
            buf = _highpass_1d(buf, _ZAX)
        return field - buf
    elif filter_type == "convolution":
        for axis in (_XAX, _YAX, _ZAX):
            buf = field
            for _ in range(filter_order):
                buf = _highpass_1d(buf, axis)
            field = field - buf
        return field
    raise ValueError("Invalid filter type")


def laplacian_filter_vector_3d(vector_field, filter_order: int, filter_type: str):
    return torch.stack(
        [laplacian_filter_3d(f, filter_order, filter_type) for f in vector_field]
    )
