"""The cases a user runs: the 2D Lamb-Oseen vortex and flow past a cylinder
(counterparts of ``examples/2d/lamb_oseen_vortex.py`` and
``examples/2d/flow_past_cylinder.py:flow_past_cylinder_fused_case``), flow
past a sphere (counterparts of
``__graft_entry__._build_fsi_case`` and
``examples/3d/flow_past_sphere.py:flow_past_sphere_fused_case``), flow
past a flexible rod (``__graft_entry__._build_rod_fsi_case`` and
``_build_rod_bench_case``), a rod with a sphere in its wake
(``_build_multibody_case`` and ``_build_multibody_bench_case``), flow
past a freely rotating rod (the fused branch of
``examples/3d/flow_past_freely_rotating_rod.py``,
:func:`_build_freely_rotating_rod_case`), a flow-only 3D case on a mesh
of shards (:func:`sharded_flow_case`), a point source advected and diffused
as a passive vector (``examples/3d/point_source_advect_diffuse.py``), a
flexible rod in a 2D flow (``examples/2d/flow_past_rod.py``) and a rigid
sphere sedimenting under its weight (``examples/3d/sedimenting_sphere.py``).
The 3D body cases take a ``mesh`` (``create_mesh(3, (pz, py),
device=...)``) that shards the flow over an in-process mesh;
:func:`dryrun_multichip` holds them on a mesh against one device
(``__graft_entry__.dryrun_multichip``).

The ``_build_*_objects`` functions build an example's objects from its
keywords; the example drivers under ``examples_torch/`` and the benchmark
cases here both call them, so a case is set up in one place.
"""

from __future__ import annotations

import tempfile
from typing import NamedTuple

import numpy as np
import torch

from sopht_mpi_tpu_torch.models import (
    AnalyticalLinearDamper,
    BaseSystemCollection,
    CircularCylinderForcingGrid,
    CosseratRod,
    CosseratRodElementCentricForcingGrid,
    CosseratRodFlowInteraction,
    CosseratRodSurfaceForcingGrid,
    Cylinder,
    DynamicRigidBody,
    FixedRigidBody,
    FlowForces,
    GeneralConstraint,
    GravityForces,
    OneEndFixedBC,
    RigidBodyFlowInteraction,
    RodBody,
    Sphere,
    SphereForcingGrid,
    UnboundedFlowSimulator2D,
    UnboundedFlowSimulator3D,
    build_flow_only_step,
    build_multi_body_fsi_step,
    build_rigid_fsi_step,
    build_rod_fsi_step,
    init_flow_only_carry,
    init_multi_body_fsi_carry,
    init_rigid_fsi_carry,
    init_rod_fsi_carry,
    scan_steps,
    suggest_rod_forcing_window,
)
from sopht_mpi_tpu_torch.models.flow.simulator_3d import (
    compute_flow_velocity_3d,
)
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import CarryCheckpointer, get_real_t


def _build_fsi_case(grid_size, *, device, precision="single",
                    sparse_forcing=None, sim_kwargs=None, mesh=None):
    """A 3D flow-past-sphere FSI case (the benchmark's sphere case: sphere
    of radius 0.125 at the domain centre, Re = 100 on its diameter, unit
    free stream in x, a weak random vorticity blob from seed 0); returns
    (fused step fn, (initial carry,)).

    ``sparse_forcing=False`` forces the dense IBM path; the default
    engages the sparse-window matmul path where the window is interior.
    ``sim_kwargs`` are extra :class:`UnboundedFlowSimulator3D` options;
    ``mesh`` (``create_mesh(3, (pz, py), device=...)``) shards the flow over
    an in-process mesh, from the same seeded field. ``step.flow_sim`` is
    the simulator."""
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
        mesh=mesh,
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
    # drawn on the global grid, then sharded: one field on any mesh
    flow_sim.primary_field = flow_sim.primary_field + shard_vector_field(
        0.1 * torch.randn((3, *flow_sim.grid_size), generator=gen,
                          dtype=real_t, device=flow_sim.device),
        flow_sim.mesh)
    free_stream = torch.tensor([1.0, 0.0, 0.0], dtype=real_t,
                               device=flow_sim.device)
    fsi_step = build_rigid_fsi_step(
        flow_sim,
        interactor,
        dt_prefac=0.5,
        free_stream_fn=lambda t: free_stream,
        sparse_forcing=sparse_forcing,
    )
    fsi_step.flow_sim = flow_sim
    carry = init_rigid_fsi_carry(flow_sim, interactor, fsi_step)
    return fsi_step, (carry,)


def sharded_flow_case(grid_size, mesh_shape, *, device, precision="single",
                      seed=0, sim_kwargs=None):
    """A flow-only 3D case on an in-process (pz, py) mesh: the sphere
    case's flow (``navier_stokes_with_forcing`` with a zero forcing field,
    unit free stream in x, viscosity 0.0025, sponge width 2, no filter)
    from a smooth seeded vorticity field, three Gaussian blobs of random
    centre, width and orientation. ``mesh_shape=None`` builds the same case
    on one device. Returns (flow-only step fn, (initial carry,)); the step
    is :func:`~sopht_mpi_tpu_torch.models.build_flow_only_step` with
    ``dt_prefac`` 0.5."""
    real_t = get_real_t(precision)
    mesh = (None if mesh_shape is None
            else create_mesh(3, mesh_shape, device=device))
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=0.0025,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        mesh=mesh,
        **(sim_kwargs or {}),
    )
    rng = np.random.default_rng(seed)
    nz, ny, nx = flow_sim.grid_size
    axes = [(np.arange(n) + 0.5) / nx for n in (nz, ny, nx)]
    extent = np.array([nz, ny, nx]) / nx
    vort = np.zeros((3, nz, ny, nx))
    for _ in range(3):
        centre = (0.3 + 0.4 * rng.random(3)) * extent
        width = (0.08 + 0.04 * rng.random()) * extent.min()
        direction = rng.standard_normal(3)
        direction /= np.linalg.norm(direction)
        blob = np.ones(())
        for k, axis in enumerate(axes):
            shape = [1, 1, 1]
            shape[k] = -1
            blob = blob * np.exp(
                -0.5 * ((axis - centre[k]) / width) ** 2).reshape(shape)
        vort += 4.0 * direction.reshape(3, 1, 1, 1) * blob
    flow_sim.primary_field = shard_vector_field(
        torch.as_tensor(vort, dtype=real_t, device=flow_sim.device),
        flow_sim.mesh)
    free_stream = torch.tensor([1.0, 0.0, 0.0], dtype=real_t,
                               device=flow_sim.device)
    # start from the velocity the vorticity induces
    flow_sim.primary_field, flow_sim.velocity_field = compute_flow_velocity_3d(
        flow_sim.primary_field, free_stream,
        poisson_greens=flow_sim._poisson_greens,
        **{k: v for k, v in flow_sim.step_config().items()
           if k in ("dx", "penalty_zone_width", "poisson_solver",
                    "with_free_stream", "use_kernels", "mesh")})
    step = build_flow_only_step(
        flow_sim, dt_prefac=0.5, free_stream_fn=lambda t: free_stream)
    step.flow_sim = flow_sim
    return step, (init_flow_only_carry(flow_sim),)


class SphereDragCase(NamedTuple):
    """The objects of the flow-past-sphere drag case: the simulator, the
    sphere's interactor (its ``forcing_grid``), the free stream tensor, the
    drag force scale ``0.5 rho U^2 pi d^2 / 4`` and the time scale d / U."""

    flow_sim: UnboundedFlowSimulator3D
    interactor: RigidBodyFlowInteraction
    free_stream: torch.Tensor
    drag_scale: float
    timescale: float


def _build_sphere_drag_case(
    grid_size=(128, 128, 128),
    reynolds=100.0,
    coupling_stiffness=-6e5 / 4,
    coupling_damping=-3.5e2 / 4,
    precision="single",
    *,
    device,
    mesh=None,
) -> SphereDragCase:
    """Flow past a fixed sphere at Re = 100 (the drag benchmark of
    ``examples/3d/flow_past_sphere.py``): sphere diameter 0.4 of the smaller
    cross-stream extent, centred at (0.25, 0.5, 0.5) of the domain, unit
    free stream in x, the sphere's forcing grid with 1.875 d / dx points
    along its equator. ``mesh`` shards the flow over an in-process
    mesh."""
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
        mesh=mesh,
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
    return SphereDragCase(
        flow_sim, interactor, free_stream,
        drag_scale=0.5 * far_field_velocity**2 * 0.25 * np.pi
        * sphere_diameter**2,
        timescale=sphere_diameter / far_field_velocity,
    )


def build_sphere_drag_step(case: SphereDragCase):
    """(fused rigid FSI step, initial carry) of the drag case, dt_prefac
    0.5."""
    step = build_rigid_fsi_step(
        case.flow_sim,
        case.interactor,
        dt_prefac=0.5,
        free_stream_fn=lambda t: case.free_stream,
    )
    return step, init_rigid_fsi_carry(case.flow_sim, case.interactor, step)


def sphere_drag_coefficient(case: SphereDragCase, lag_forces) -> float:
    """Cd of the step diagnostic ``lag_forces`` (the Lagrangian force sum,
    one row a step): its last row's x force over the drag scale (a host
    read)."""
    return float(lag_forces[-1, 0].abs()) / case.drag_scale


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
    """Flow past a fixed sphere at Re = 100 (the drag benchmark,
    :func:`_build_sphere_drag_case`). The coupled loop runs ``window``
    steps between host reads of the drag; returns (t* at each window end,
    Cd at the window's last step)."""
    case = _build_sphere_drag_case(
        grid_size, reynolds, coupling_stiffness, coupling_damping, precision,
        device=device)
    step, carry = build_sphere_drag_step(case)
    t_end = nondim_time * case.timescale
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window)
        times.append(float(carry.time) / case.timescale)
        drag_coeffs.append(sphere_drag_coefficient(case, lag_forces))
    return np.asarray(times), np.asarray(drag_coeffs)


def compute_lamb_oseen_vorticity(x, y, x_cm, y_cm, nu, gamma, t):
    """Vorticity of the Lamb-Oseen vortex of circulation ``gamma`` centred
    at (x_cm, y_cm) at time ``t`` (numpy)."""
    return (
        gamma
        / (4 * np.pi * nu * t)
        * np.exp(-((x - x_cm) ** 2 + (y - y_cm) ** 2) / (4 * nu * t))
    )


def compute_lamb_oseen_velocity(x, y, x_cm, y_cm, nu, gamma, t):
    """Velocity (2, ...) of the same vortex (numpy)."""
    r2 = np.maximum((x - x_cm) ** 2 + (y - y_cm) ** 2, 1e-14)
    r = np.sqrt(r2)
    u_theta = gamma / (2 * np.pi * r) * (1 - np.exp(-r2 / (4 * nu * t)))
    return np.stack([-u_theta * (y - y_cm) / r, u_theta * (x - x_cm) / r])


def _build_lamb_oseen_sim(grid_size, *, device, precision="single",
                          t_start=1.0):
    """The Lamb-Oseen simulator at ``t_start``: nu = 1e-3, circulation
    ``4 pi nu t_start`` (maximum vorticity 1), the vortex at (0.3, 0.3), a
    unit free stream in x and y. Returns (simulator, free stream (2,)
    numpy, analytic vorticity ``t -> (ny, nx) numpy`` of the advected,
    diffused vortex)."""
    real_t = get_real_t(precision)
    nu = 1e-3
    x_cm_start = y_cm_start = 0.3
    gamma = 4 * np.pi * nu * t_start
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=nu,
        flow_type="navier_stokes",
        with_free_stream_flow=True,
        real_t=real_t,
        time=t_start,
        device=device,
    )
    x = flow_sim.position_field[0].cpu().numpy().astype(np.float64)
    y = flow_sim.position_field[1].cpu().numpy().astype(np.float64)
    free_stream = np.ones(2)

    def to_field(a):
        return torch.as_tensor(a, dtype=real_t, device=flow_sim.device)

    flow_sim.vorticity_field = to_field(compute_lamb_oseen_vorticity(
        x, y, x_cm_start, y_cm_start, nu, gamma, t_start))
    flow_sim.velocity_field = to_field(
        compute_lamb_oseen_velocity(
            x, y, x_cm_start, y_cm_start, nu, gamma, t_start)
        + free_stream[:, None, None])

    def analytic_vorticity(t):
        return compute_lamb_oseen_vorticity(
            x, y, x_cm_start + free_stream[0] * (t - t_start),
            y_cm_start + free_stream[1] * (t - t_start), nu, gamma, t)

    return flow_sim, free_stream, analytic_vorticity


def lamb_oseen_vortex_case(grid_size=(256, 256), precision="single",
                           t_end=1.4, *, device):
    """Lamb-Oseen vortex against its analytic solution: the vortex advects
    with the free stream and diffuses from t = 1.0 to ``t_end``, the
    timestep the stable one capped at the time left. Returns the (L2, Linf)
    vorticity errors, L2 = ||err||_2 dx."""
    flow_sim, free_stream, analytic_vorticity = _build_lamb_oseen_sim(
        grid_size, device=device, precision=precision)
    while flow_sim.time < t_end - 1e-10:
        dt = min(flow_sim.compute_stable_timestep(), t_end - flow_sim.time)
        flow_sim.time_step(dt=dt, free_stream_velocity=free_stream)
    error = np.abs(
        flow_sim.vorticity_field.cpu().numpy().astype(np.float64)
        - analytic_vorticity(flow_sim.time)
    )
    return float(np.linalg.norm(error) * flow_sim.dx), float(error.max())


class CylinderCase(NamedTuple):
    """The objects of the cylinder case: the simulator, the cylinder, its
    interactor and the free stream tensor."""

    flow_sim: UnboundedFlowSimulator2D
    cylinder: Cylinder
    interactor: RigidBodyFlowInteraction
    free_stream: torch.Tensor


def _build_cylinder_objects(grid_size=(256, 512), *, device, reynolds=200.0,
                            coupling_stiffness=-5e4, coupling_damping=-20.0,
                            precision="single") -> CylinderCase:
    """Flow past a fixed circular cylinder, as
    ``examples/2d/flow_past_cylinder.py`` builds it: radius 0.03 of a unit
    x range, centred 2.5 radii from the inflow wall at mid height, unit
    free stream in x, Re on the radius, 60 forcing points."""
    real_t = get_real_t(precision)
    velocity_scale = 1.0
    cyl_radius = 0.03
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=cyl_radius * velocity_scale / reynolds,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
    )
    cylinder = Cylinder(
        center=(2.5 * cyl_radius, 0.5 * grid_size[0] / grid_size[1]),
        radius=cyl_radius,
        device=flow_sim.device,
        dtype=real_t,
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim,
        cylinder,
        CircularCylinderForcingGrid(cylinder, 60),
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )
    free_stream = torch.tensor([velocity_scale, 0.0], dtype=real_t,
                               device=flow_sim.device)
    return CylinderCase(flow_sim, cylinder, interactor, free_stream)


def _build_cylinder_fsi_case(grid_size=(256, 512), *, device, reynolds=200.0,
                             coupling_stiffness=-5e4, coupling_damping=-20.0,
                             precision="single"):
    """Flow past a fixed circular cylinder (:func:`_build_cylinder_objects`)
    on the dense IBM path. Returns (fused step fn, (initial carry,))."""
    case = _build_cylinder_objects(
        grid_size, device=device, reynolds=reynolds,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, precision=precision)
    step = build_rigid_fsi_step(
        case.flow_sim, case.interactor, dt_prefac=1.0,
        free_stream_fn=lambda t: case.free_stream,
    )
    return step, (init_rigid_fsi_carry(case.flow_sim, case.interactor,
                                       step),)


def flow_past_cylinder_fused_case(
    nondim_final_time=200.0,
    grid_size=(256, 512),
    reynolds=200.0,
    coupling_stiffness=-5e4,
    coupling_damping=-20.0,
    precision="single",
    window=500,
    *,
    device,
):
    """Flow past a fixed cylinder at Re = 200 (vortex shedding and drag,
    :func:`_build_cylinder_fsi_case`). The coupled loop runs ``window``
    steps between host reads of the drag; returns (t* = t U / r at each
    window end, Cd = |F_x| / (U^2 r) at the window's last step)."""
    step, (carry,) = _build_cylinder_fsi_case(
        grid_size, device=device, reynolds=reynolds,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, precision=precision,
    )
    velocity_scale, cyl_radius = 1.0, 0.03
    timescale = cyl_radius / velocity_scale
    t_end = nondim_final_time * timescale
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window)
        times.append(float(carry.time) / timescale)
        drag_coeffs.append(
            float(lag_forces[-1, 0].abs()) / (velocity_scale**2 * cyl_radius))
    return np.asarray(times), np.asarray(drag_coeffs)


def _build_rod_fsi_case(grid_size, *, device, surface_density=4,
                        sparse_forcing=False, mesh=None):
    """A small 3D flexible-rod FSI case (float32 flow, float64 rod,
    surface forcing grid, one rod substep per flow step); returns (fused
    step, carry). ``sparse_forcing=True`` takes the moving-window sparse
    IBM path; the step's diagnostics then include the window_ok flag.
    ``mesh`` shards the flow over an in-process mesh."""
    real_t = torch.float32
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        mesh=mesh,
    )
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    rod = CosseratRod.straight_rod(
        6,
        np.array([0.5, 0.4, 0.4]),
        np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]),
        base_length=0.3,
        base_radius=0.02,
        density=1e3,
        youngs_modulus=1e5,
        shear_modulus=1e5 / 1.5,
        device=flow_sim.device,
    )
    collection = BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.finalize()
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=surface_density,
    )
    window = None
    if sparse_forcing:
        window = suggest_rod_forcing_window(interactor, rod, grid_size)
        if window is None:
            raise RuntimeError("sparse rod case: no window fits this grid")
    free_stream = torch.tensor([1.0, 0.0, 0.0], dtype=real_t,
                               device=flow_sim.device)
    step = build_rod_fsi_step(
        flow_sim,
        interactor,
        collection,
        rod_substeps=1,
        dt_prefac=0.5,
        free_stream_fn=lambda t: free_stream,
        sparse_forcing_window=window,
    )
    return step, init_rod_fsi_carry(flow_sim, interactor, rod)


class RodCase(NamedTuple):
    """The objects of a 3D rod case: the simulator, the rod, its system
    collection (finalized), the rod's interactor, the free stream tensor
    and the rod's dt."""

    flow_sim: UnboundedFlowSimulator3D
    rod: CosseratRod
    collection: BaseSystemCollection
    interactor: CosseratRodFlowInteraction
    free_stream: torch.Tensor
    rod_dt: float


def _build_flow_past_rod_objects(
        grid_size=(128, 32, 128), *, device, n_elem=40,
        surface_grid_density_for_largest_element=16, cauchy_number=0.1,
        mass_ratio=100.0, froude_number=0.5, stretch_bending_ratio=None,
        poisson_ratio=0.5, reynolds=100.0, coupling_stiffness=-2e5,
        coupling_damping=-1e2, rod_start_incline_angle=0.0,
        precision="single", flow_forces=False,
        sim_kwargs=None, mesh=None) -> RodCase:
    """A flexible rod hanging into a free stream, as
    ``examples/3d/flow_past_rod.py`` builds it, with its parameters and
    defaults: the rod from (0.2, 0.5, 0.75) of the domain along (sin a, 0,
    -cos a) for the incline a, diameter y_range / 5, Young's modulus from
    the Cauchy number, shear stiffened by the stretch-to-bending ratio
    (default: the experimental filament's, 25 mm x 0.4 mm), gravity from
    the Froude number, ``OneEndFixedBC``, the linear damper (1e-3) at the
    rod's dt (0.01 dl, capped by the axial wave speed); Re on the
    diameter, an x range of 1.8 L, unit free stream in x, the order-1
    multiplicative vorticity filter; the surface forcing grid.
    ``flow_forces`` adds the host-coupled ``FlowForces`` to the collection,
    as the example's host loop does. ``sim_kwargs`` are extra
    :class:`UnboundedFlowSimulator3D` options; ``mesh`` shards the flow
    over an in-process mesh. The rod is float64, the flow ``precision``."""
    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    rho_f, u_free_stream, base_length = 1.0, 1.0, 1.0
    x_range = 1.8 * base_length
    y_range = grid_size_y / grid_size_x * x_range
    z_range = grid_size_z / grid_size_x * x_range

    start = np.array([0.2 * x_range, 0.5 * y_range, 0.75 * z_range])
    direction = np.array([np.sin(rod_start_incline_angle), 0.0,
                          -np.cos(rod_start_incline_angle)])
    normal = np.array([0.0, 1.0, 0.0])
    base_diameter = y_range / 5.0
    base_radius = base_diameter / 2.0
    base_area = np.pi * base_radius**2
    rho_s = mass_ratio * rho_f
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        rho_f * u_free_stream**2 * base_length**3 * base_diameter
    ) / (cauchy_number * moment_of_inertia)
    gravitational_acc = froude_number * u_free_stream**2 / base_diameter
    # stretch-to-bending ratio EAL^2/EI of the experimental filament (25 mm x
    # 0.4 mm), stiffer axially and in shear than the simulated thick rod
    if stretch_bending_ratio is None:
        exp_radius, exp_length = 0.2e-3, 25e-3
        exp_area = np.pi * exp_radius**2
        exp_moi = np.pi / 4 * exp_radius**4
        stretch_bending_ratio = exp_area * exp_length**2 / exp_moi
    es_eb = stretch_bending_ratio * moment_of_inertia / (
        base_area * base_length**2
    )

    device = torch.device(device)
    collection = BaseSystemCollection()
    rod = CosseratRod.straight_rod(
        n_elem,
        start,
        direction,
        normal,
        base_length,
        base_radius,
        rho_s,
        youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / (poisson_ratio + 1.0),
        device=device,
    )
    shear_diag = rod.params.shear_diag.clone()
    shear_diag[2] *= es_eb
    rod.params = rod.params._replace(shear_diag=shear_diag)
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.add_forcing_to(rod).using(
        GravityForces, acc_gravity=np.array([0.0, 0.0, -gravitational_acc])
    )
    dl = base_length / n_elem
    # the rod's dt: 0.01 dl, capped by the axial wave speed of the
    # stretch-stiffened rod, c = sqrt(E es_eb / rho)
    axial_wave_speed = np.sqrt(youngs_modulus * es_eb / rho_s)
    rod_dt = min(0.01 * dl, 0.3 * dl / axial_wave_speed)
    collection.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=1e-3, time_step=rod_dt
    )

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=u_free_stream * base_diameter / reynolds,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        filter_vorticity=True,
        filter_setting_dict={"order": 1, "type": "multiplicative"},
        mesh=mesh,
        **(sim_kwargs or {}),
    )
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
    )
    if flow_forces:
        collection.add_forcing_to(rod).using(FlowForces, interactor)
    collection.finalize()
    free_stream = torch.tensor([u_free_stream, 0.0, 0.0], dtype=real_t,
                               device=device)
    return RodCase(flow_sim, rod, collection, interactor, free_stream, rod_dt)


def _build_rod_bench_case(grid_size, *, device, sparse_forcing=None,
                          precision="single", substep_load_refresh="every",
                          sim_kwargs=None, mesh=None):
    """The flexible-rod FSI benchmark case, sized as the reference's own
    driver (flow_past_rod_case.py): grid (nx, nx/4, nx), n_elem = 5 nx / 16,
    surface grid density nx / 8 (at least 4), the rest
    :func:`_build_flow_past_rod_objects` at its defaults (Cauchy 0.1, mass
    ratio 100, Re 100, stretch stiffening, gravity, the linear damper, the
    order-1 multiplicative filter), dynamic substeps from the rod's dt. The
    rod is float64, the flow float32 (``precision="single"``). Returns
    (fused step, (carry,)).

    ``sparse_forcing=False`` forces the dense IBM path; None takes the
    moving sparse window that :func:`suggest_rod_forcing_window` gives.
    ``sim_kwargs`` are extra :class:`UnboundedFlowSimulator3D` options;
    ``mesh`` shards the flow over an in-process mesh."""
    grid_size_x = grid_size[2]
    case = _build_flow_past_rod_objects(
        grid_size, device=device, n_elem=5 * grid_size_x // 16,
        surface_grid_density_for_largest_element=max(4, grid_size_x // 8),
        precision=precision, sim_kwargs=sim_kwargs, mesh=mesh)
    sparse_window = None
    if sparse_forcing is not False:
        sparse_window = suggest_rod_forcing_window(case.interactor, case.rod,
                                                   grid_size)
    step = build_rod_fsi_step(
        case.flow_sim,
        case.interactor,
        case.collection,
        dt_prefac=0.25,
        free_stream_fn=lambda t: case.free_stream,
        rod_dt=case.rod_dt,
        sparse_forcing_window=sparse_window,
        substep_load_refresh=substep_load_refresh,
    )
    carry = init_rod_fsi_carry(case.flow_sim, case.interactor, case.rod, step)
    return step, (carry,)


def _build_freely_rotating_rod_objects(
        grid_size=(64, 64, 128), *, device, n_elem=16,
        surface_grid_density_for_largest_element=12, cauchy_number=0.2,
        mass_ratio=10.0, aspect_ratio=10.0, base_length=1.0,
        poisson_ratio=0.5, reynolds=100.0, coupling_stiffness=-2e5,
        coupling_damping=-1e2, rod_start_incline_angle=np.pi / 2,
        precision="single", flow_forces=False, mesh=None) -> RodCase:
    """Flow past a rod clamped in translation at its first node but free to
    turn about its own axis, as ``examples/3d/flow_past_freely_rotating_rod.py``
    builds it, with its parameters and defaults: the rod from (0.08, 0.502,
    0.502) of the domain along (sin a, 0, -cos a) for the incline a;
    ``GeneralConstraint`` at node and element 0 (translation fixed, the
    lab-frame rotation about x free), the linear damper (1e-3) at the rod's
    dt 0.01 L / n_elem; Re on the diameter, an x range of 5 L, unit free
    stream in x, the order-5 convolution vorticity filter; the surface
    forcing grid. ``flow_forces`` adds the host-coupled ``FlowForces`` to
    the collection, as the example's host loop does; ``mesh`` shards the
    flow over an in-process mesh. The rod is float64, the flow
    ``precision``."""
    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    rho_f, u_free_stream = 1.0, 1.0
    x_range = 5.0 * base_length
    y_range = grid_size_y / grid_size_x * x_range
    z_range = grid_size_z / grid_size_x * x_range
    start = np.array([0.08 * x_range, 0.502 * y_range, 0.502 * z_range])
    direction = np.array([np.sin(rod_start_incline_angle), 0.0,
                          -np.cos(rod_start_incline_angle)])
    normal = np.array([0.0, 1.0, 0.0])
    base_diameter = base_length / aspect_ratio
    base_radius = base_diameter / 2.0
    rho_s = mass_ratio * rho_f
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        rho_f * u_free_stream**2 * base_length**3 * base_diameter
    ) / (cauchy_number * moment_of_inertia)

    device = torch.device(device)
    collection = BaseSystemCollection()
    rod = CosseratRod.straight_rod(
        n_elem,
        start,
        direction,
        normal,
        base_length,
        base_radius,
        rho_s,
        youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / (poisson_ratio + 1.0),
        device=device,
    )
    collection.append(rod)
    collection.constrain(rod).using(
        GeneralConstraint,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
        translational_constraint_selector=np.array([True, True, True]),
        rotational_constraint_selector=np.array([False, True, True]),
    )
    rod_dt = 0.01 * base_length / n_elem
    collection.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=1e-3, time_step=rod_dt
    )

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=u_free_stream * base_diameter / reynolds,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        filter_vorticity=True,
        filter_setting_dict={"order": 5, "type": "convolution"},
        mesh=mesh,
    )
    free_stream = torch.tensor([u_free_stream, 0.0, 0.0], dtype=real_t,
                               device=device)
    flow_sim.velocity_field = (flow_sim.velocity_field
                               + free_stream.view(3, 1, 1, 1))
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
    )
    if flow_forces:
        collection.add_forcing_to(rod).using(FlowForces, interactor)
    collection.finalize()
    return RodCase(flow_sim, rod, collection, interactor, free_stream, rod_dt)


def build_freely_rotating_rod_step(case: RodCase):
    """(fused rod FSI step, carry from the objects' current state) of the
    freely rotating rod: dynamic substeps, dt_prefac 0.25, the dense IBM
    path."""
    step = build_rod_fsi_step(
        case.flow_sim,
        case.interactor,
        case.collection,
        dt_prefac=0.25,
        free_stream_fn=lambda t: case.free_stream,
        rod_dt=case.rod_dt,
    )
    return step, init_rod_fsi_carry(case.flow_sim, case.interactor, case.rod,
                                    step)


def _build_freely_rotating_rod_case(
        grid_size=(64, 64, 128), *, device, n_elem=16,
        surface_grid_density_for_largest_element=12, precision="single"):
    """The fused branch of ``examples/3d/flow_past_freely_rotating_rod.py``
    at the example's values (:func:`_build_freely_rotating_rod_objects`;
    the defaults are its command line's: grid (64, 64, 128), n_elem 16,
    surface density 12). Returns (fused step, carry). The example's
    checkpoint IO, restart and host loop are in
    ``examples_torch/3d/flow_past_freely_rotating_rod.py``."""
    return build_freely_rotating_rod_step(_build_freely_rotating_rod_objects(
        grid_size, device=device, n_elem=n_elem,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
        precision=precision))


class RodAndSphereCase(NamedTuple):
    """The objects of the rod and sphere case: the simulator, the two
    bodies (the rod's, the sphere's), the free stream tensor, the rod's dt
    and the sphere's diameter."""

    flow_sim: UnboundedFlowSimulator3D
    bodies: tuple
    free_stream: torch.Tensor
    rod_dt: float
    sphere_diameter: float


def _build_rod_and_sphere_objects(
        grid_size=(32, 32, 64), *, device, n_elem=8,
        surface_grid_density_for_largest_element=8, cauchy_number=0.1,
        mass_ratio=100.0, reynolds=100.0, coupling_stiffness=-2e5,
        coupling_damping=-1e2, precision="single", fast_spectral=None,
        sim_kwargs=None, mesh=None) -> RodAndSphereCase:
    """A flexible rod and a fixed sphere in its wake, as
    ``examples/3d/rod_and_sphere.py`` builds them, with its parameters and
    defaults: a Cosserat rod hanging from 0.85 of the height, half the
    height long, Young's modulus from the Cauchy number, stretch
    stiffening of the experimental filament, ``OneEndFixedBC``, the linear
    damper (1e-3) at the rod's dt, no gravity; a sphere of 0.4 rod lengths
    at (0.65, 0.5, 0.5) of the domain; Re on the rod's diameter, an x range
    of 1.8, unit free stream in x, the order-1 multiplicative filter.
    ``fast_spectral`` is the simulator's, ``sim_kwargs`` are extra
    :class:`UnboundedFlowSimulator3D` options, ``mesh`` shards the flow over
    an in-process mesh. The rod is float64, the flow ``precision``."""
    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    rho_f, u_free_stream = 1.0, 1.0
    x_range = 1.8
    y_range = grid_size_y / grid_size_x * x_range
    z_range = grid_size_z / grid_size_x * x_range
    # the rod hangs from 0.85 of the height and is half the height long, so
    # its tip stays inside the domain at any grid aspect
    base_length = 0.5 * z_range

    device = torch.device(device)
    collection = BaseSystemCollection()
    start = np.array([0.25 * x_range, 0.5 * y_range, 0.85 * z_range])
    direction = np.array([0.0, 0.0, -1.0])
    normal = np.array([0.0, 1.0, 0.0])
    base_diameter = base_length / 5.0
    base_radius = base_diameter / 2.0
    base_area = np.pi * base_radius**2
    rho_s = mass_ratio * rho_f
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        rho_f * u_free_stream**2 * base_length**3 * base_diameter
    ) / (cauchy_number * moment_of_inertia)
    # stretch stiffening of the experimental filament, as in flow_past_rod
    exp_radius, exp_length = 0.2e-3, 25e-3
    stretch_bending_ratio = (
        np.pi * exp_radius**2 * exp_length**2 / (np.pi / 4 * exp_radius**4)
    )
    es_eb = stretch_bending_ratio * moment_of_inertia / (
        base_area * base_length**2
    )
    rod = CosseratRod.straight_rod(
        n_elem,
        start,
        direction,
        normal,
        base_length,
        base_radius,
        rho_s,
        youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / 1.5,
        device=device,
    )
    shear_diag = rod.params.shear_diag.clone()
    shear_diag[2] *= es_eb
    rod.params = rod.params._replace(shear_diag=shear_diag)
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    dl = base_length / n_elem
    axial_wave_speed = np.sqrt(youngs_modulus * es_eb / rho_s)
    rod_dt = min(0.01 * dl, 0.3 * dl / axial_wave_speed)
    collection.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=1e-3, time_step=rod_dt
    )
    collection.finalize()

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=u_free_stream * base_diameter / reynolds,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        filter_vorticity=True,
        filter_setting_dict={"order": 1, "type": "multiplicative"},
        fast_spectral=fast_spectral,
        mesh=mesh,
        **(sim_kwargs or {}),
    )
    rod_interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
    )
    sphere_diameter = 0.4 * base_length
    sphere = Sphere(
        center=np.array([0.65 * x_range, 0.5 * y_range, 0.5 * z_range]),
        radius=sphere_diameter / 2.0,
        device=device,
        dtype=real_t,
    )
    sphere_grid = SphereForcingGrid(
        rigid_body=sphere,
        num_forcing_points_along_equator=max(
            8, int(1.875 * sphere_diameter / x_range * grid_size_x)
        ),
    )
    sphere_interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=sphere_grid,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )
    bodies = (
        RodBody(rod_interactor, collection),
        FixedRigidBody(sphere_interactor),
    )
    free_stream = torch.tensor([u_free_stream, 0.0, 0.0], dtype=real_t,
                               device=device)
    return RodAndSphereCase(flow_sim, bodies, free_stream, rod_dt,
                            sphere_diameter)


def _build_multibody_bench_case(grid_size, *, device, sparse_forcing=None,
                                precision="single",
                                substep_load_refresh="every",
                                fast_spectral=None, sim_kwargs=None,
                                mesh=None):
    """The mixed rod + rigid-sphere FSI benchmark case
    (``__graft_entry__._build_multibody_bench_case``, BASELINE config 5, the
    physics of ``examples/3d/rod_and_sphere.py``): n_elem = max(8, 5 nx /
    16), surface grid density max(4, nx / 8), the rest
    :func:`_build_rod_and_sphere_objects` at its defaults (Cauchy 0.1, mass
    ratio 100, Re 100); both bodies sharing the forcing, dynamic substeps
    from the rod's dt. Float64 rod, float32 flow (``precision="single"``).
    Meant for (nx/2, nx/2, nx) grids. Returns (fused step, (carry,)).

    ``sparse_forcing`` is the step's (None: per-body moving windows where
    they fit); ``fast_spectral`` the simulator's; ``sim_kwargs`` are extra
    :class:`UnboundedFlowSimulator3D` options; ``mesh`` shards the flow over
    an in-process mesh."""
    grid_size_x = grid_size[2]
    case = _build_rod_and_sphere_objects(
        grid_size, device=device, n_elem=max(8, 5 * grid_size_x // 16),
        surface_grid_density_for_largest_element=max(4, grid_size_x // 8),
        precision=precision, fast_spectral=fast_spectral,
        sim_kwargs=sim_kwargs, mesh=mesh)
    step = build_multi_body_fsi_step(
        case.flow_sim,
        case.bodies,
        dt_prefac=0.25,
        free_stream_fn=lambda t: case.free_stream,
        sub_dt=case.rod_dt,
        sparse_forcing=sparse_forcing,
        substep_load_refresh=substep_load_refresh,
    )
    carry = init_multi_body_fsi_carry(case.flow_sim, case.bodies, step)
    return step, (carry,)


def _build_multibody_case(grid_size, *, device, fast_spectral=None,
                          mesh=None):
    """A small mixed rod + rigid-sphere case
    (``__graft_entry__._build_multibody_case``): a clamped 5-element rod
    and a fixed sphere sharing the forcing, a unit-velocity flow, float32
    flow, float64 rod, one substep a flow step; returns (fused step,
    carry). ``mesh`` shards the flow over an in-process mesh."""
    real_t = torch.float32
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
        fast_spectral=fast_spectral,
        mesh=mesh,
    )
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    rod = CosseratRod.straight_rod(
        5,
        np.array([0.3, 0.4, 0.4]),
        np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]),
        base_length=0.25,
        base_radius=0.02,
        density=1e3,
        youngs_modulus=1e5,
        shear_modulus=1e5 / 1.5,
        device=flow_sim.device,
    )
    collection = BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.finalize()
    rod_interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=4,
    )
    sphere = Sphere(center=np.array([0.7, 0.5, 0.5]), radius=0.1,
                    device=flow_sim.device, dtype=real_t)
    sph_grid = SphereForcingGrid(
        rigid_body=sphere, num_forcing_points_along_equator=8
    )
    sph_interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=sph_grid,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
    )
    bodies = (
        RodBody(rod_interactor, collection),
        FixedRigidBody(sph_interactor),
    )
    free_stream = torch.tensor([1.0, 0.0, 0.0], dtype=real_t,
                               device=flow_sim.device)
    step = build_multi_body_fsi_step(
        flow_sim,
        bodies,
        dt_prefac=0.5,
        free_stream_fn=lambda t: free_stream,
    )
    return step, init_multi_body_fsi_carry(flow_sim, bodies)


# the point source of examples/3d/point_source_advect_diffuse.py: viscosity,
# start and end times, the source's start and its unit velocity in x, y, z
POINT_SOURCE_NU = 1e-3
POINT_SOURCE_T_START, POINT_SOURCE_T_END = 5.0, 5.4
POINT_SOURCE_START = np.array([0.3, 0.3, 0.3])
POINT_SOURCE_VELOCITY = 1.0
# the source's strength: a peak of about 1 at the start time
POINT_SOURCE_MAG = 4.0 * np.pi * POINT_SOURCE_NU * POINT_SOURCE_T_START**1.5


def compute_diffused_point_source_field(x_grid, y_grid, z_grid, cm, nu,
                                        point_mag, t):
    """Green's function of the diffusion equation,
    ``M / (4 pi nu t)^1.5 exp(-r^2 / 4 nu t)`` about ``cm`` (numpy)."""
    r2 = ((x_grid - cm[0]) ** 2 + (y_grid - cm[1]) ** 2
          + (z_grid - cm[2]) ** 2)
    return (point_mag / (4 * np.pi * nu * t) ** 1.5
            * np.exp(-r2 / (4 * nu * t)))


def _grid_positions(flow_sim):
    """(x, y, z) cell centres of the assembled grid, numpy in the
    simulator's dtype."""
    pos = unshard_vector_field(flow_sim.position_field, flow_sim.mesh)
    return tuple(pos.cpu().numpy())


def point_source_advection_diffusion_case(grid_size, *, device,
                                          precision="single", mesh=None):
    """A point source advected and diffused as a ``passive_vector`` field,
    the case of ``examples/3d/point_source_advect_diffuse.py``: a unit x
    range, nu = 1e-3, each component the diffused point source of strength
    ``4 pi nu t^1.5`` about (0.3, 0.3, 0.3) at t = 5.0, a unit velocity in
    x, y and z. ``mesh`` is a mesh from ``create_mesh(3, (pz, py),
    device=...)``, or None for one device. Returns (flow-only step,
    carry); ``step.flow_sim`` is the simulator. Run it with
    :func:`run_point_source_case`. The example's IO and host loop are not
    here."""
    real_t = get_real_t(precision)
    grid_size = tuple(grid_size)
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=POINT_SOURCE_NU,
        flow_type="passive_vector",
        real_t=real_t,
        mesh=mesh,
        time=POINT_SOURCE_T_START,
        device=device,
    )
    x, y, z = _grid_positions(flow_sim)
    init = compute_diffused_point_source_field(
        x, y, z, POINT_SOURCE_START, POINT_SOURCE_NU, POINT_SOURCE_MAG,
        POINT_SOURCE_T_START)
    flow_sim.primary_vector_field = shard_vector_field(torch.as_tensor(
        np.broadcast_to(init, (3, *grid_size)).copy(), dtype=real_t,
        device=flow_sim.device), flow_sim.mesh)
    flow_sim.velocity_field = POINT_SOURCE_VELOCITY * torch.ones_like(
        flow_sim.velocity_field)
    step = build_flow_only_step(flow_sim)
    step.flow_sim = flow_sim
    return step, init_flow_only_carry(flow_sim)


def run_point_source_case(step, carry, *, window=100):
    """Run the point source of :func:`point_source_advection_diffusion_case`
    to t = 5.4 as the example's fused branch does: ``window`` steps
    between host reads of the time, so the run ends up to ``window - 1``
    steps past t = 5.4. Returns (final carry, L2, Linf) of
    :func:`point_source_errors`."""
    while float(carry.time) < POINT_SOURCE_T_END - 1e-10:
        carry, _ = scan_steps(step, carry, window)
    return (carry, *point_source_errors(
        step.flow_sim, carry.flow_state.primary_field, float(carry.time)))


def point_source_errors(flow_sim, field, t_final):
    """(L2, Linf) of the point source's primary ``field`` against the
    analytic field at ``t_final``: L2 = ``||err||_2 dx^1.5``."""
    cm_final = (POINT_SOURCE_START
                + POINT_SOURCE_VELOCITY * (t_final - POINT_SOURCE_T_START))
    x, y, z = _grid_positions(flow_sim)
    ref = compute_diffused_point_source_field(
        x, y, z, cm_final, POINT_SOURCE_NU, POINT_SOURCE_MAG, t_final)
    field = unshard_vector_field(field, flow_sim.mesh).cpu().numpy()
    error = np.abs(field - ref)
    return (float(np.linalg.norm(error) * flow_sim.dx**1.5),
            float(error.max()))


class Rod2DCase(NamedTuple):
    """The objects of the 2D rod case: the simulator, the rod, its system
    collection (finalized), the rod's interactor, the fused step's free
    stream as a function of the time (a tensor), the rod's dt and the tip's
    start (x, y) as numpy."""

    flow_sim: UnboundedFlowSimulator2D
    rod: CosseratRod
    collection: BaseSystemCollection
    interactor: CosseratRodFlowInteraction
    free_stream_fn: object
    rod_dt: float
    tip_start: np.ndarray


def _build_flow_past_rod_2d_objects(
        grid_size=(256, 512), *, device, reynolds=200.0,
        nondim_bending_stiffness=1.5e-3, nondim_mass_ratio=1.5, froude=0.5,
        rod_start_incline_angle=0.0, coupling_stiffness=-8e4,
        coupling_damping=-30.0, precision="single",
        flow_forces=False) -> Rod2DCase:
    """A flexible rod clamped at one end in a 2D flow, as
    ``examples/2d/flow_past_rod.py`` builds it, with its parameters and
    defaults: an x range of 6 rod lengths, the rod from (1, 0.501 y_range)
    along (cos a, sin a) for the incline a with n_elem = nx / 8,
    ``OneEndFixedBC``, gravity along x from the Froude number, the linear
    damper (5e-4) at the rod's dt 0.01 L / n_elem; the element-centric
    forcing grid; a free stream ramping up to 1 in x with a decaying 0.5
    perturbation in y. ``flow_forces`` adds the host-coupled
    ``FlowForces`` to the collection, as the example's host loop does. The
    rod is float64, the flow ``precision``."""
    grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    velocity_free_stream, rho_f, base_length = 1.0, 1.0, 1.0
    x_range = 6.0 * base_length
    y_range = grid_size_y / grid_size_x * x_range
    n_elem = grid_size_x // 8
    base_radius = 0.01
    base_area = np.pi * base_radius**2
    z_axis_width = 1.0
    density = (nondim_mass_ratio * rho_f * base_length * z_axis_width
               / base_area)
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        nondim_bending_stiffness
        * (rho_f * velocity_free_stream**2 * base_length**3 * z_axis_width)
        / moment_of_inertia
    )
    poisson_ratio = 0.5

    device = torch.device(device)
    collection = BaseSystemCollection()
    rod = CosseratRod.straight_rod(
        n_elem,
        np.array([base_length, 0.501 * y_range, 0.0]),
        np.array([np.cos(rod_start_incline_angle),
                  np.sin(rod_start_incline_angle), 0.0]),
        np.array([0.0, 0.0, 1.0]),
        base_length,
        base_radius,
        density,
        youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / (poisson_ratio + 1.0),
        device=device,
    )
    tip_start = rod.state.position[:2, -1].cpu().numpy()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.add_forcing_to(rod).using(
        GravityForces,
        acc_gravity=np.array(
            [froude * velocity_free_stream**2 / base_length, 0.0, 0.0]),
    )
    rod_dt = 0.01 * base_length / n_elem
    collection.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=0.5e-3, time_step=rod_dt
    )

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=base_length * velocity_free_stream / reynolds,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        device=device,
    )
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
        forcing_grid_cls=CosseratRodElementCentricForcingGrid,
    )
    if flow_forces:
        collection.add_forcing_to(rod).using(FlowForces, interactor)
    collection.finalize()
    timescale = base_length / velocity_free_stream

    def free_stream(t):
        # the ramp and the decaying y perturbation, on the device
        ramp = torch.exp(-t / timescale)
        return torch.stack([velocity_free_stream * (1.0 - ramp),
                            0.5 * velocity_free_stream * ramp])

    return Rod2DCase(flow_sim, rod, collection, interactor, free_stream,
                     rod_dt, tip_start)


def flow_past_rod_2d_case(grid_size=(256, 512), *, device,
                          precision="single"):
    """The fused branch of ``examples/2d/flow_past_rod.py`` at the example's
    values (:func:`_build_flow_past_rod_2d_objects`: Re 200, bending
    stiffness 1.5e-3, mass ratio 1.5, Froude 0.5, coupling stiffness -8e4
    and damping -30): dynamic substeps, dt_prefac 0.5, the dense IBM path.
    Returns (fused step, carry, the tip's start (x, y) as numpy); the tip
    trajectory of the example is ``(carry.rod_state.position[:2, -1] -
    tip start) / L``. The example's IO and host loop are in
    ``examples_torch/2d/flow_past_rod.py``."""
    case = _build_flow_past_rod_2d_objects(grid_size, device=device,
                                           precision=precision)
    step = build_rod_fsi_step(
        case.flow_sim,
        case.interactor,
        case.collection,
        dt_prefac=0.5,
        free_stream_fn=case.free_stream_fn,
        rod_dt=case.rod_dt,
    )
    return (step, init_rod_fsi_carry(case.flow_sim, case.interactor, case.rod),
            case.tip_start)


def sedimenting_sphere_case(grid_size=(64, 64, 64), *, device,
                            precision="double", sphere_radius=0.06,
                            density_ratio=2.0, kinematic_viscosity=1.0,
                            terminal_velocity_target=0.05,
                            coupling_stiffness=-5e5, coupling_damping=-2e2,
                            substeps=1, mesh=None):
    """A rigid sphere sedimenting under its net weight, the step of
    ``examples/3d/sedimenting_sphere.py`` with its defaults: a unit box,
    the sphere of radius 0.06 and density 2 (fluid 1) at (0.5, 0.5, 0.65),
    nu = 1, gravity chosen so that the Stokes terminal velocity ``v_t =
    2 (rho_s - rho_f) g R^2 / (9 mu)`` is 0.05; ``SphereForcingGrid`` with
    ``max(8, int(1.875 2R / L nx))`` points on the equator, coupling
    stiffness -5e5 and damping -2e2; one ``DynamicRigidBody`` whose loads
    are the net weight (gravity less buoyancy); ``dt_prefac`` 0.5,
    ``substeps`` rigid substeps a flow step, the sparse window where it
    fits (the step's default). Returns (fused step, carry, v_t, tau) with
    the relaxation time ``tau = 2 rho_s R^2 / (9 mu)``; ``step.flow_sim``
    is the simulator. ``mesh`` shards the flow over an in-process mesh. The
    example's host loop is not here."""
    real_t = get_real_t(precision)
    grid_size = tuple(grid_size)
    x_range, rho_f = 1.0, 1.0
    rho_s = density_ratio * rho_f
    mu = rho_f * kinematic_viscosity
    radius = sphere_radius
    g = (terminal_velocity_target * 9.0 * mu
         / (2.0 * (rho_s - rho_f) * radius**2))
    v_t = 2.0 * (rho_s - rho_f) * g * radius**2 / (9.0 * mu)
    tau = 2.0 * rho_s * radius**2 / (9.0 * mu)

    device = torch.device(device)
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=kinematic_viscosity,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=False,
        real_t=real_t,
        device=device,
        mesh=mesh,
    )
    sphere = Sphere(
        center=np.array([0.5, 0.5, 0.65]) * x_range,
        radius=radius,
        device=device,
        dtype=real_t,
        density=rho_s,
    )
    forcing_grid = SphereForcingGrid(
        rigid_body=sphere,
        num_forcing_points_along_equator=max(
            8, int(1.875 * 2.0 * radius / x_range * grid_size[-1])),
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=forcing_grid,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )
    # net weight: gravity less buoyancy (the flow carries no body force)
    net_weight = -(rho_s - rho_f) * (4.0 / 3.0) * np.pi * radius**3 * g
    loads = (torch.tensor([0.0, 0.0, net_weight], dtype=real_t,
                          device=device),
             torch.zeros(3, dtype=real_t, device=device))
    bodies = (DynamicRigidBody(interactor, sphere, lambda state, t: loads),)
    step = build_multi_body_fsi_step(flow_sim, bodies, dt_prefac=0.5,
                                     substeps=substeps)
    step.flow_sim = flow_sim
    carry = init_multi_body_fsi_carry(flow_sim, bodies, step)
    return step, carry, v_t, tau


# ---------------------------------------------------------------------------
# the multi-device gate
# ---------------------------------------------------------------------------


def _case_row(results, name, diff, tol):
    ok = diff <= tol
    results.append((name, diff, tol, ok))
    print(
        f"  case {name:<26s} |delta|_max={diff:10.3e}  tol={tol:7.1e}  "
        f"{'PASS' if ok else 'FAIL'}",
        flush=True,
    )


def dryrun_multichip(mesh_shape=(4, 2), *, device):
    """The multi-device gate of ``__graft_entry__.dryrun_multichip`` on an
    in-process ``mesh_shape`` mesh on ``device``: the coupled steps on the
    mesh against one device, each case a row of the printed table:

    - the rigid sphere (:func:`_build_fsi_case`), 3 steps;
    - the rod (:func:`_build_rod_fsi_case`), 3 steps: vorticity and tip;
    - the rod's sparse window against the dense path, both on the mesh:
      vorticity and tip;
    - the rod and sphere (:func:`_build_multibody_case`, per-body sparse
      windows), 2 steps;
    - a checkpoint after 2 steps on the mesh, restored
      (``CarryCheckpointer``) and run 2 more, bit-exact against 4 straight
      steps;
    - the flow step with ``use_kernels`` on against off on the same mesh
      (the sharded kernels on a card, their per-shard plain versions on the
      CPU; the JAX package's Pallas fork) at its (16, 16, 128)-based grid.

    The base grid is (32, 32, 32), each sharded axis rounded up to a
    multiple of its shards; the tolerances are the JAX function's
    (``3e-5 max(1, |ref|)`` for fields, ``1e-5`` for the tip, 0 for the
    restart). Prints the table; returns its rows (name, |delta|, tol, ok);
    raises if any row fails."""
    mesh = create_mesh(3, mesh_shape, device=device)
    pz, py = mesh.axis_sizes

    def lcm_grid(base, per):
        return max(base, per * ((base + per - 1) // per))

    grid = (lcm_grid(32, pz), lcm_grid(32, py), 32)
    print(f"dryrun_multichip: mesh={mesh.shape} base grid={grid} "
          f"device={mesh.device}", flush=True)
    results = []
    field = lambda f, m: unshard_vector_field(f, m).double().cpu()  # noqa
    scale = lambda a: max(1.0, float(a.abs().max()))  # noqa: E731
    diff = lambda a, b: float((a - b).abs().max())  # noqa: E731

    # -- the rigid sphere, 3 steps
    def rigid_final(m):
        step, (carry,) = _build_fsi_case(grid, device=device, mesh=m)
        carry, _ = scan_steps(step, carry, 3)
        return field(carry.flow_state.primary_field, m)

    w_single, w_sharded = rigid_final(None), rigid_final(mesh)
    _case_row(results, "rigid-sphere FSI x3", diff(w_sharded, w_single),
              3e-5 * scale(w_single))

    # -- the rod, 3 steps
    def rod_final(m, sparse=False):
        step, carry = _build_rod_fsi_case(grid, device=device, mesh=m,
                                          sparse_forcing=sparse)
        carry, diag = scan_steps(step, carry, 3)
        if sparse and not bool(diag[1].all()):
            raise RuntimeError("rod forcing window tripped")
        return (field(carry.flow_state.primary_field, m),
                carry.rod_state.position[:, -1].double().cpu())

    wr_single, tip_single = rod_final(None)
    wr_sharded, tip_sharded = rod_final(mesh)
    _case_row(results, "rod FSI x3 (vorticity)", diff(wr_sharded, wr_single),
              3e-5 * scale(wr_single))
    _case_row(results, "rod FSI x3 (tip)", diff(tip_sharded, tip_single),
              1e-5)

    # -- the rod's sparse window against the dense path, both on the mesh
    wr_sp, tip_sp = rod_final(mesh, sparse=True)
    _case_row(results, "rod sparse-vs-dense (mesh)", diff(wr_sp, wr_sharded),
              3e-5 * scale(wr_sharded))
    _case_row(results, "rod sparse-vs-dense (tip)", diff(tip_sp, tip_sharded),
              1e-5)

    # -- the rod and sphere, 2 steps
    def multi_final(m):
        step, carry = _build_multibody_case(grid, device=device, mesh=m)
        carry, _ = scan_steps(step, carry, 2)
        return field(carry.flow_state.primary_field, m)

    wm_single, wm_sharded = multi_final(None), multi_final(mesh)
    _case_row(results, "multi-body FSI x2", diff(wm_sharded, wm_single),
              3e-5 * scale(wm_single))

    # -- checkpoint -> restore -> resume on the mesh, bit-exact
    step, (carry0,) = _build_fsi_case(grid, device=device, mesh=mesh)
    straight, _ = scan_steps(step, carry0, 4)
    mid, _ = scan_steps(step, carry0, 2)
    with tempfile.TemporaryDirectory() as d:
        ckpt = CarryCheckpointer(d)
        ckpt.save(2, mid, wait=True)
        restored = ckpt.restore(template=mid)
        ckpt.close()
    resumed, _ = scan_steps(step, restored, 2)
    _case_row(results, "checkpoint-restart x(2+2)",
              diff(field(resumed.flow_state.primary_field, mesh),
                   field(straight.flow_state.primary_field, mesh)), 0.0)

    # -- the kernel fork against the plain fork on the same mesh
    kernel_grid = (lcm_grid(16, pz), lcm_grid(16, py), 128)
    start = np.random.default_rng(3).standard_normal((3, *kernel_grid))

    def kernel_fork_final(use_kernels):
        sim = UnboundedFlowSimulator3D(
            grid_size=kernel_grid, x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes", with_free_stream_flow=True,
            real_t=torch.float32, device=device, mesh=mesh,
            use_kernels=use_kernels)
        sim.primary_field = shard_vector_field(
            torch.as_tensor(0.1 * start, dtype=torch.float32,
                            device=sim.device), mesh)
        sim.time_step(1e-3, free_stream_velocity=(1.0, 0.0, 0.0))
        return field(sim.primary_field, mesh)

    wp_plain = kernel_fork_final(False)
    wp_kernels = kernel_fork_final(True)
    _case_row(results, "sharded kernel fork x1", diff(wp_kernels, wp_plain),
              3e-5 * scale(wp_plain))

    print("dryrun_multichip results:", flush=True)
    for name, d, tol, ok in results:
        print(f"  case {name:<26s} |delta|_max={d:10.3e}  tol={tol:7.1e}  "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
    failed = [r for r in results if not r[3]]
    if failed:
        raise AssertionError(
            f"dryrun_multichip: {len(failed)}/{len(results)} cases FAILED: "
            + ", ".join(r[0] for r in failed))
    print(f"dryrun_multichip OK: {len(results)} cases parity-asserted on "
          f"mesh={mesh.shape}", flush=True)
    return results
