"""The flow-past-sphere FSI cases a user runs (counterparts of
``__graft_entry__._build_fsi_case`` and
``examples/3d/flow_past_sphere.py:flow_past_sphere_fused_case``).
"""

from __future__ import annotations

import numpy as np
import torch

from sopht_mpi_tpu_torch.models import (
    RigidBodyFlowInteraction,
    Sphere,
    SphereForcingGrid,
    UnboundedFlowSimulator3D,
    build_rigid_fsi_step,
    init_rigid_fsi_carry,
    scan_steps,
)
from sopht_mpi_tpu_torch.utils import get_real_t


def _build_fsi_case(grid_size, *, device, precision="single",
                    sparse_forcing=None, sim_kwargs=None):
    """A 3D flow-past-sphere FSI case (the benchmark's sphere case: sphere
    of radius 0.125 at the domain centre, Re = 100 on its diameter, unit
    free stream in x, a weak random vorticity blob from seed 0); returns
    (fused step fn, (initial carry,)).

    ``sparse_forcing=False`` forces the dense IBM path; the default
    engages the sparse-window matmul path where the window is interior.
    ``sim_kwargs`` are extra :class:`UnboundedFlowSimulator3D` options."""
    real_t = get_real_t(precision)
    x_range = 1.0
    sphere_radius = 0.125 * x_range
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=sphere_radius * 2.0 / 100.0,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        **(sim_kwargs or {}),
    )
    sphere = Sphere(
        center=np.array([0.5, 0.5, 0.5]) * x_range,
        radius=sphere_radius,
        device=flow_sim.device,
        dtype=real_t,
    )
    forcing_grid = SphereForcingGrid(
        rigid_body=sphere,
        num_forcing_points_along_equator=max(
            8, int(1.875 * (2.0 * sphere_radius) / x_range * grid_size[-1])
        ),
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=forcing_grid,
        virtual_boundary_stiffness_coeff=-1e4,
        virtual_boundary_damping_coeff=-1e1,
    )
    gen = torch.Generator(device=flow_sim.device).manual_seed(0)
    flow_sim.primary_field = flow_sim.primary_field + 0.1 * torch.randn(
        flow_sim.primary_field.shape, generator=gen, dtype=real_t,
        device=flow_sim.device,
    )
    free_stream = torch.tensor([1.0, 0.0, 0.0], dtype=real_t,
                               device=flow_sim.device)
    fsi_step = build_rigid_fsi_step(
        flow_sim,
        interactor,
        dt_prefac=0.5,
        free_stream_fn=lambda t: free_stream,
        sparse_forcing=sparse_forcing,
    )
    carry = init_rigid_fsi_carry(flow_sim, interactor, fsi_step)
    return fsi_step, (carry,)


def flow_past_sphere_fused_case(
    nondim_time=10.0,
    grid_size=(128, 128, 128),
    reynolds=100.0,
    coupling_stiffness=-6e5 / 4,
    coupling_damping=-3.5e2 / 4,
    precision="single",
    window=100,
    *,
    device,
):
    """Flow past a fixed sphere at Re = 100 (the drag benchmark): sphere
    diameter 0.4 of the smaller cross-stream extent, centred at
    (0.25, 0.5, 0.5) of the domain, unit free stream in x. The coupled
    loop runs ``window`` steps between host reads of the drag; returns
    (t* at each window end, Cd at the window's last step)."""
    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    x_range = 1.0
    far_field_velocity = 1.0
    sphere_diameter = 0.4 * min(grid_size_z, grid_size_y) / grid_size_x * x_range
    nu = far_field_velocity * sphere_diameter / reynolds
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        real_t=real_t,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        device=device,
    )
    sphere = Sphere(
        center=np.array(
            [0.25 * flow_sim.x_range, 0.5 * flow_sim.y_range,
             0.5 * flow_sim.z_range]
        ),
        radius=sphere_diameter / 2.0,
        device=flow_sim.device,
        dtype=real_t,
    )
    forcing_grid = SphereForcingGrid(
        rigid_body=sphere,
        num_forcing_points_along_equator=int(
            1.875 * sphere_diameter / x_range * grid_size_x
        ),
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=forcing_grid,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )
    free_stream = torch.tensor([far_field_velocity, 0.0, 0.0], dtype=real_t,
                               device=flow_sim.device)
    step = build_rigid_fsi_step(
        flow_sim,
        interactor,
        dt_prefac=0.5,
        free_stream_fn=lambda t: free_stream,
    )
    carry = init_rigid_fsi_carry(flow_sim, interactor, step)
    drag_scale = 0.5 * far_field_velocity**2 * 0.25 * np.pi * sphere_diameter**2
    timescale = sphere_diameter / far_field_velocity
    t_end = nondim_time * timescale
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window)
        times.append(float(carry.time) / timescale)
        drag_coeffs.append(float(lag_forces[-1, 0].abs()) / drag_scale)
    return np.asarray(times), np.asarray(drag_coeffs)
