"""2D Eulerian grid stencil ops (counterpart of
``sopht_mpi_tpu/ops/stencils_2d.py``): diffusion flux and timestep,
conservative ENO3 advection flux and timestep, the out-of-plane curl, the
vorticity update from a velocity forcing, the wall sponge, Brinkmann
penalisation and the characteristic function of a level set.

Fields are ghost-free whole-grid tensors, each op a shifted-slice
expression with an explicit zero band at the physical walls, returning a
new tensor. Scalar fields are (ny, nx); vector fields (2, ny, nx) with
component 0 = x, 1 = y. Plain PyTorch: the JAX package has no Pallas
kernel for these either.
"""

from __future__ import annotations

import math

import torch

from sopht_mpi_tpu_torch.ops._stencil_utils import (
    axslice,
    central_diff_interior,
    eno3_divergence_interior,
    laplacian_interior,
    pad_all,
)

DIFFUSION_KERNEL_SUPPORT = 1
ADVECTION_ENO3_KERNEL_SUPPORT = 2
CURL_KERNEL_SUPPORT = 1


def diffusion_flux_2d(field, prefactor):
    """``flux = prefactor * discrete_laplacian(field)`` with a zero band of
    width 1 at the physical walls."""
    return pad_all(prefactor * laplacian_interior(field), 1)


def diffusion_timestep_2d(field, nu_dt_by_dx2):
    """Euler-forward diffusion: ``field += flux``."""
    return field + diffusion_flux_2d(field, nu_dt_by_dx2)


def advection_flux_conservative_eno3_2d(field, velocity, inv_dx):
    """Conservative ENO3 advective flux:
    ``inv_dx * (d(u_x q)/dx + d(u_y q)/dy)`` (undivided differences); the
    advection timestep passes ``inv_dx = -dt/dx`` and adds the result."""
    div = eno3_divergence_interior(field, velocity[1], axis=0)
    div = div + eno3_divergence_interior(field, velocity[0], axis=1)
    return inv_dx * div


def advection_timestep_eno3_2d(field, velocity, dt_by_dx):
    """Euler-forward conservative ENO3 advection."""
    return field + advection_flux_conservative_eno3_2d(field, velocity, -dt_by_dx)


def outplane_field_curl_2d(field, prefactor):
    """Velocity from an out-of-plane scalar field (the streamfunction):
    ``(u, v) = (d(psi)/dy, -d(psi)/dx)`` by central differences
    (``prefactor = 0.5/dx``), zero in a width-1 band at the walls. Returns a
    (2, ny, nx) vector field."""
    u = prefactor * central_diff_interior(field, axis=0)
    v = -prefactor * central_diff_interior(field, axis=1)
    return pad_all(torch.stack([u, v]), 1, start_axis=1)


def update_vorticity_from_velocity_forcing_2d(vorticity, velocity_forcing,
                                              prefactor):
    """``vorticity += prefactor * curl_z(velocity_forcing)`` on the interior
    (``prefactor = dt/(2 dx)``; the boundary ring stays)."""
    curl_z = central_diff_interior(
        velocity_forcing[1], axis=1
    ) - central_diff_interior(velocity_forcing[0], axis=0)
    return vorticity + pad_all(prefactor * curl_z, 1)


def penalise_field_boundary_2d(field, width: int):
    """Sponge-penalise the field toward zero at the physical domain
    boundary over ``width`` cells: clamp the band to its inner-edge value,
    then ramp with ``sin(pi/2 * j / width)`` (j = distance from the wall in
    cells), along x first, then y. ``width=0`` is a no-op."""
    if width == 0:
        return field
    ramp = torch.sin(
        0.5 * math.pi
        * torch.arange(width, dtype=field.dtype, device=field.device) / width
    )
    for ax in (1, 0):
        shape = [1, 1]
        shape[ax] = width
        r = ramp.reshape(shape)
        edge_lo = axslice(field, width - 1, width, ax)
        edge_hi = axslice(field, -width, -width + 1 if width > 1 else None, ax)
        mid = axslice(field, width, -width, ax)
        field = torch.cat(
            [edge_lo * r, mid, edge_hi * torch.flip(r, dims=(ax,))], dim=ax)
    return field


def brinkmann_penalise_2d(velocity, penalty_factor, char_field,
                          penalty_velocity):
    """Implicit Brinkmann penalisation of a vector field toward
    ``penalty_velocity`` inside the body (``char_field`` in [0, 1]):
    ``u = (u + k chi u_body) / (1 + k chi)``."""
    denom = 1.0 + penalty_factor * char_field
    return (velocity + penalty_factor * char_field * penalty_velocity) / denom


def char_func_from_level_set_via_sine_heaviside_2d(level_set, blend_width):
    """Smooth characteristic function from a signed-distance level set
    (positive inside the body), blended over ``blend_width``:
    ``H = 0.5 (1 + phi/w + sin(pi phi/w)/pi)`` clipped to [0, 1], the sine
    term as ``x sinc(x)`` for the reason the 3D op gives."""
    phi = level_set / blend_width
    h = 0.5 * (1.0 + phi + phi * torch.sinc(phi))
    return torch.clamp(h, 0.0, 1.0)
