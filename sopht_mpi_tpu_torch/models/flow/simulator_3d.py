"""3D unbounded flow simulator (counterpart of
``sopht_mpi_tpu/models/flow/simulator_3d.py``): the flow types
``passive_scalar``, ``passive_vector``, ``navier_stokes`` and
``navier_stokes_with_forcing``, on one device or on an in-process (pz, py)
mesh of shards.

The passive types advect the primary field (a scalar, or three components
with one velocity) by conservative ENO3 and diffuse it; their velocity
never changes in the step, they build no Poisson solver, and their
transport is plain torch on every device, as it is jnp in the JAX package
(on a mesh it runs on the assembled fields through
:func:`~sopht_mpi_tpu_torch.parallel.mesh.apply_assembled`).

The Navier-Stokes transport is the rotational form:
``omega += dt/(2dx) curl(u x omega)``, then vector diffusion, then optional
filtering, then velocity recovery (wall penalisation -> vector Poisson
solve -> curl -> free stream).

With ``use_kernels`` (the default on a CUDA device) the stencil passes
run the Hopper kernels of :mod:`sopht_mpi_tpu_torch.ops.cuda_stencils_3d`
(on CPU tensors those wrappers run their plain versions): the rotational
transport, then either diffusion fused with the wall sponge (filter off) or
diffusion, the Laplacian filter and the sponge as three kernels (filter on,
the rod cases), then the curl. The vector Poisson solve takes the solver's
kernel route on a CUDA device (the five FFT-pass kernels of
:mod:`sopht_mpi_tpu_torch.parallel.cuda_fft`). With ``fast_spectral=True``
(the fast spectral tier) and the kernels on, the velocity recovery is the
solver's fused route instead - the curl mixed into the Poisson z pass, the
ring, free stream and ``max |u|_1`` in its last pass - wherever the solver
supports it (``fused_curl_supported``), and the solve + curl elsewhere, as
the JAX package routes.
The step keeps dt, its prefactors and ``max |u|_1`` as 0-d tensors on the
device: nothing in it waits for the device.

With a mesh (``mesh=create_mesh(3, (pz, py), device=...)``) every field is
sharded, (pz, py, 3, nz/pz, ny/py, nx)
(:mod:`sopht_mpi_tpu_torch.parallel.mesh`), and the step is the JAX
package's mesh branch: the four sharded stencils of
:mod:`sopht_mpi_tpu_torch.ops.cuda_stencils_3d_sharded` with their halo
exchanges, and the Poisson solve through the distributed convolve; the fused
velocity recovery is never taken. The ops the JAX package leaves to its
SPMD partitioner there have no sharded kernel and run on the assembled
field (:func:`~sopht_mpi_tpu_torch.parallel.mesh.apply_assembled`): the
Laplacian filter with the sponge after it, and the sponge where the fused
sharded kernel does not apply. The forcing update ``omega + dt/(2dx)
curl(f)`` is the sharded curl kernel and an add. With ``use_kernels`` off
the whole transport and the curl are the plain ops on the assembled fields.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as kernels
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
from sopht_mpi_tpu_torch.ops.elementwise import add_fixed_val, cross_product_3d
from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver3D
from sopht_mpi_tpu_torch.ops.stencils_3d import (
    advection_timestep_eno3_3d,
    advection_timestep_eno3_vector_3d,
    curl_3d,
    diffusion_timestep_3d,
    diffusion_timestep_vector_3d,
    divergence_3d,
    laplacian_filter_vector_3d,
    penalise_field_boundary_vector_3d,
    update_vorticity_from_velocity_forcing_3d,
)
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import (
    MESH_AXES_3D,
    apply_assembled,
    check_grid_divisibility,
    shard_scalar_field,
    shard_vector_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils.types import get_test_tol


class FlowState3D(NamedTuple):
    """``primary_field`` is the advected (nz, ny, nx) scalar for
    passive_scalar flows, and the (3, nz, ny, nx) vorticity or passive
    vector otherwise; on a mesh every field is sharded, (pz, py, 3, nz/pz,
    ny/py, nx) or (pz, py, nz/pz, ny/py, nx)."""

    primary_field: torch.Tensor
    velocity_field: torch.Tensor
    eul_grid_forcing_field: torch.Tensor | None = None


# options of the JAX simulator that the port takes only at some values,
# with the place in ROADMAP.md that says why
_RESTRICTED = {
    "comm_bf16": ((False,), "'Do not port': the TPU transposes' bf16 wire "
                            "format"),
}


class UnboundedFlowSimulator3D:
    """3D unbounded flow simulator.

    :param grid_size: (nz, ny, nx).
    :param flow_type: one of ``SUPPORTED_FLOW_TYPES``; the default
        ``"passive_scalar"`` is the JAX package's.
    :param device: the torch device every field lives on; required, no
        default is taken from the environment.
    :param mesh: a mesh from ``parallel.create_mesh(3, (pz, py),
        device=...)``, slab (n, 1) or pencil (pz, py), on the same device:
        the fields are sharded over it and the step takes its mesh branch.
        A mesh of one shard is the single-device simulator.
    :param overlap_chunks: keyword option, the JAX package's pipelining
        request of the sharded Poisson solve: any value >= 1 (or None) is
        accepted and one chunk is realised.
    :param filter_vorticity: apply the Laplacian filter (default
        ``{"order": 2, "type": "multiplicative"}``, set with
        ``filter_setting_dict``).
    :param fast_spectral: keyword option, the Poisson solver's fast spectral
        tier (None takes the package default; see
        ``sopht_mpi_tpu_torch.enable_fast_spectral``).

    Float32 matmuls run in full precision: building a simulator turns TF32
    off for CUDA matmuls and cuDNN (``torch.backends.cuda.matmul.allow_tf32``
    and ``torch.backends.cudnn.allow_tf32``), matching the JAX package's
    ``Precision.HIGHEST`` IBM einsums.
    """

    grid_dim = 3

    SUPPORTED_FLOW_TYPES = [
        "passive_scalar",
        "passive_vector",
        "navier_stokes",
        "navier_stokes_with_forcing",
    ]
    PASSIVE_FLOW_TYPES = ("passive_scalar", "passive_vector")

    def __init__(
        self,
        grid_size,
        x_range,
        kinematic_viscosity,
        *,
        device,
        time=0.0,
        CFL=0.1,
        flow_type="passive_scalar",
        with_free_stream_flow=False,
        real_t=torch.float32,
        mesh=None,
        filter_vorticity=False,
        **kwargs,
    ):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.grid_size = tuple(int(n) for n in grid_size)
        self.grid_size_z, self.grid_size_y, self.grid_size_x = self.grid_size
        self.x_range = x_range
        self.real_t = real_t
        self.flow_type = flow_type
        self.with_free_stream_flow = with_free_stream_flow
        self.kinematic_viscosity = kinematic_viscosity
        self.CFL = CFL
        self.time = time
        self.filter_vorticity = filter_vorticity
        if flow_type not in self.SUPPORTED_FLOW_TYPES:
            raise ValueError("Invalid flow type given")
        if flow_type in self.PASSIVE_FLOW_TYPES and with_free_stream_flow:
            raise ValueError(
                "Free stream flow not defined for passive advection diffusion!"
            )
        if mesh is not None:
            if getattr(mesh, "axis_names", None) != MESH_AXES_3D:
                raise ValueError(
                    "mesh: the 3D simulator needs a mesh from "
                    "create_mesh(3, (pz, py), device=...)")
            if mesh.device != self.device:
                raise ValueError(
                    f"mesh lies on {mesh.device}, the simulator on "
                    f"{self.device}")
            check_grid_divisibility(self.grid_size, mesh)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.penalty_zone_width = kwargs.get("penalty_zone_width", 2)
        self.use_kernels = kwargs.get("use_kernels", self.device.type == "cuda")
        self.filter_setting_dict = kwargs.get(
            "filter_setting_dict", {"order": 2, "type": "multiplicative"}
        ) or {"order": 2, "type": "multiplicative"}
        self.fast_spectral = kwargs.get("fast_spectral")
        self.overlap_chunks = kwargs.get("overlap_chunks")
        known_kwargs = {"penalty_zone_width", "use_kernels",
                        "filter_setting_dict", "fast_spectral",
                        "overlap_chunks"}
        known_kwargs |= set(_RESTRICTED)
        unknown = set(kwargs) - known_kwargs
        if unknown:
            # a typo'd option silently running the defaults would poison a
            # benchmark's control arm
            raise TypeError(
                f"Unknown keyword argument(s) {sorted(unknown)}; "
                f"supported: {sorted(known_kwargs)}"
            )
        for name, (allowed, item) in _RESTRICTED.items():
            if name in kwargs and kwargs[name] not in allowed:
                raise NotImplementedError(
                    f"{name}={kwargs[name]!r} is not ported "
                    f"(ROADMAP.md {item}); allowed: {allowed}"
                )
        self._init_domain()
        self._init_fields()

    def _init_domain(self):
        gx = self.grid_size_x
        self.y_range = self.x_range * self.grid_size_y / gx
        self.z_range = self.x_range * self.grid_size_z / gx
        self.dx = float(self.x_range / gx)
        shift = self.dx / 2.0
        axes = [
            np.linspace(shift, rng - shift, n)
            for rng, n in (
                (self.x_range, self.grid_size_x),
                (self.y_range, self.grid_size_y),
                (self.z_range, self.grid_size_z),
            )
        ]
        zg, yg, xg = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        self.position_field = shard_vector_field(torch.as_tensor(
            np.stack([xg, yg, zg]), dtype=self.real_t, device=self.device
        ), self.mesh)

    def _zeros(self):
        return shard_vector_field(torch.zeros(
            (3, *self.grid_size), dtype=self.real_t, device=self.device
        ), self.mesh)

    def _init_fields(self):
        if self.flow_type == "passive_scalar":
            self.primary_field = shard_scalar_field(torch.zeros(
                self.grid_size, dtype=self.real_t, device=self.device
            ), self.mesh)
        else:
            self.primary_field = self._zeros()
        self.velocity_field = self._zeros()
        self.eul_grid_forcing_field = (
            self._zeros() if self.flow_type == "navier_stokes_with_forcing"
            else None
        )
        if self.flow_type in self.PASSIVE_FLOW_TYPES:
            # the passive types never solve for a velocity: no solver, and
            # no doubled-grid Green's spectrum
            self.unbounded_poisson_solver = None
            return
        self.unbounded_poisson_solver = UnboundedPoissonSolver3D(
            grid_size_z=self.grid_size_z,
            grid_size_y=self.grid_size_y,
            grid_size_x=self.grid_size_x,
            x_range=self.x_range,
            real_t=self.real_t,
            device=self.device,
            fast_spectral=self.fast_spectral,
            mesh=self.mesh,
            overlap_chunks=self.overlap_chunks,
        )

    @property
    def vorticity_field(self):
        return self.primary_field

    @vorticity_field.setter
    def vorticity_field(self, value):
        self.primary_field = value

    # the name of the primary field of passive_vector flows
    @property
    def primary_vector_field(self):
        return self.primary_field

    @primary_vector_field.setter
    def primary_vector_field(self, value):
        self.primary_field = value

    def step_config(self, flow_type=None) -> dict:
        """Keyword arguments of :func:`flow_step_3d` for this simulator
        (``flow_type`` overrides the simulator's own)."""
        return dict(
            dx=self.dx,
            nu=self.kinematic_viscosity,
            flow_type=flow_type or self.flow_type,
            with_free_stream=self.with_free_stream_flow,
            penalty_zone_width=self.penalty_zone_width,
            filter_order=(
                int(self.filter_setting_dict["order"])
                if self.filter_vorticity
                else 0
            ),
            filter_type=self.filter_setting_dict["type"],
            poisson_solver=self.unbounded_poisson_solver,
            use_kernels=self.use_kernels,
            mesh=self.mesh,
        )

    @property
    def _poisson_greens(self):
        """The solver's stored spectrum: dense (on a mesh in the sharded
        Fourier layout), or the kernel route's (bulk, side) pair; a 0-d
        placeholder for the passive types, which build no solver."""
        solver = self.unbounded_poisson_solver
        if solver is None:
            return torch.zeros((), dtype=self.real_t, device=self.device)
        return solver.fourier_greens_times_dx_pow_dim

    def _get_state(self) -> FlowState3D:
        return FlowState3D(
            self.primary_field, self.velocity_field, self.eul_grid_forcing_field
        )

    def _set_state(self, state: FlowState3D):
        self.primary_field = state.primary_field
        self.velocity_field = state.velocity_field
        self.eul_grid_forcing_field = state.eul_grid_forcing_field

    # -- public API ----------------------------------------------------------

    def time_step(self, dt, free_stream_velocity=(0.0, 0.0, 0.0)):
        fsv = torch.as_tensor(
            free_stream_velocity, dtype=self.real_t, device=self.device
        )
        dt_t = torch.as_tensor(dt, dtype=self.real_t, device=self.device)
        self._set_state(
            flow_step_3d(
                self._get_state(), dt_t, fsv,
                poisson_greens=self._poisson_greens, **self.step_config(),
            )
        )
        self.time += float(dt)

    def compute_stable_timestep(self, dt_prefac=1.0, precision="single") -> float:
        dt = compute_stable_timestep_3d(
            self.velocity_field,
            CFL=self.CFL,
            dx=self.dx,
            nu=self.kinematic_viscosity,
            tol=get_test_tol(precision),
            mesh=self.mesh,
        )
        return float(dt) * dt_prefac

    def diffusion_limited_timestep(self, dt_prefac=1.0) -> float:
        """Upper bound on every CFL/diffusion timestep this simulator can
        return: the diffusion limit ``0.9 dx^2 / (2 dim nu)`` times
        ``dt_prefac``."""
        return float(
            dt_prefac * 0.9 * self.dx**2
            / (2 * self.grid_dim * self.kinematic_viscosity)
        )

    def get_max_vorticity(self) -> float:
        """The largest value of the primary field (a host read)."""
        return float(self.vorticity_field.max())

    def compute_flow_velocity(self):
        """Recompute the velocity from the current vorticity: the wall
        sponge, the vector Poisson solve and the curl, no free stream.
        Needs a Navier-Stokes flow type (the passive types have no
        solver)."""
        solver = self.unbounded_poisson_solver
        if solver is None:
            raise ValueError(
                f"compute_flow_velocity: a {self.flow_type} simulator has no "
                "Poisson solver")
        self.vorticity_field, self.velocity_field = compute_flow_velocity_3d(
            self.vorticity_field,
            torch.zeros(3, dtype=self.real_t, device=self.device),
            dx=self.dx,
            penalty_zone_width=self.penalty_zone_width,
            poisson_solver=solver,
            with_free_stream=False,
            poisson_greens=self._poisson_greens,
            use_kernels=self.use_kernels,
            mesh=self.mesh,
        )

    def get_vorticity_divergence_l2_norm(self) -> float:
        """``||div(omega)||_2 dx^1.5`` over the assembled field (a host
        read)."""
        div = divergence_3d(
            unshard_vector_field(self.vorticity_field, self.mesh),
            1.0 / self.dx)
        return float(torch.linalg.vector_norm(div) * self.dx**1.5)


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------


def compute_flow_velocity_3d(
    vorticity, free_stream_velocity, *,
    dx, penalty_zone_width, poisson_solver, with_free_stream,
    poisson_greens=None,
    use_kernels=False,
    mesh=None,
    return_velocity_l1_max=False,
    skip_penalise=False,
):
    """Wall-penalise vorticity -> vector Poisson -> curl -> free stream.
    Returns (vorticity, velocity), plus the global ``max |u|_1`` of the new
    velocity (a 0-d tensor, reduced inside the curl kernel on the kernel
    path, and over the mesh after it) when ``return_velocity_l1_max``.

    With the kernels on and a solver built with ``fast_spectral=True`` that
    supports the fused route for this field, the solve, the curl and the
    epilogue are the solver's ``velocity_from_vorticity_fused`` (never on a
    mesh). On a ``mesh`` the fields are sharded: the sponge runs on the
    assembled field, the curl is the sharded kernel."""
    if mesh is not None:
        return _compute_flow_velocity_3d_sharded(
            vorticity, free_stream_velocity, mesh, dx=dx,
            penalty_zone_width=penalty_zone_width,
            poisson_solver=poisson_solver, with_free_stream=with_free_stream,
            poisson_greens=poisson_greens, use_kernels=use_kernels,
            return_velocity_l1_max=return_velocity_l1_max,
            skip_penalise=skip_penalise)
    if not skip_penalise:
        vorticity = penalise_field_boundary_vector_3d(
            vorticity, penalty_zone_width
        )
    if (
        use_kernels
        and getattr(poisson_solver, "fast_spectral", False)
        and poisson_solver.fused_curl_supported(
            vorticity.dtype, vorticity.device)
    ):
        fsv = (
            torch.as_tensor(free_stream_velocity, dtype=vorticity.dtype,
                            device=vorticity.device)
            if with_free_stream
            else torch.zeros(3, dtype=vorticity.dtype, device=vorticity.device)
        )
        velocity, l1_max = poisson_solver.velocity_from_vorticity_fused(
            vorticity, poisson_greens, fsv
        )
        if return_velocity_l1_max:
            return vorticity, velocity, l1_max
        return vorticity, velocity
    stream_func = poisson_solver.vector_field_solve(vorticity, poisson_greens)
    pref = 0.5 / dx
    l1_max = None
    if use_kernels:
        # free-stream add folded into the curl kernel
        res = kernels.curl_3d(
            stream_func, pref,
            add_vector=free_stream_velocity if with_free_stream else None,
            compute_l1_max=return_velocity_l1_max,
        )
        velocity, l1_max = res if return_velocity_l1_max else (res, None)
    else:
        velocity = curl_3d(stream_func, pref)
        if with_free_stream:
            velocity = add_fixed_val(velocity, free_stream_velocity)
        if return_velocity_l1_max:
            l1_max = velocity.abs().sum(dim=0).max()
    if return_velocity_l1_max:
        return vorticity, velocity, l1_max
    return vorticity, velocity


def _sponge(use_kernels: bool):
    return (kernels.penalise_field_boundary_vector_3d if use_kernels
            else penalise_field_boundary_vector_3d)


def _compute_flow_velocity_3d_sharded(
    vorticity, free_stream_velocity, mesh, *,
    dx, penalty_zone_width, poisson_solver, with_free_stream,
    poisson_greens, use_kernels, return_velocity_l1_max, skip_penalise,
):
    """The mesh branch of :func:`compute_flow_velocity_3d`."""
    if not skip_penalise and penalty_zone_width > 0:
        sponge = _sponge(use_kernels)
        vorticity = apply_assembled(
            lambda w: sponge(w, penalty_zone_width), mesh, vorticity)
    stream_func = poisson_solver.vector_field_solve(vorticity, poisson_greens)
    pref = 0.5 / dx
    add_vector = free_stream_velocity if with_free_stream else None
    if use_kernels:
        res = sharded.curl_3d_sharded(
            stream_func, pref, mesh, add_vector=add_vector,
            compute_l1_max=return_velocity_l1_max)
        velocity, l1_max = res if return_velocity_l1_max else (res, None)
    else:
        velocity = apply_assembled(
            lambda psi: kernels.curl_3d_ref(
                psi, pref,
                None if add_vector is None else torch.as_tensor(
                    add_vector, dtype=psi.dtype, device=psi.device)),
            mesh, stream_func)
        l1_max = (velocity_l1_max_3d(velocity, mesh)
                  if return_velocity_l1_max else None)
    if return_velocity_l1_max:
        return vorticity, velocity, l1_max
    return vorticity, velocity


def velocity_l1_max_3d(velocity, mesh=None):
    """``max |u_x| + |u_y| + |u_z|`` over the grid, a 0-d tensor: on a mesh
    each shard's maximum, then the maximum over the mesh."""
    magnitude = velocity.abs().sum(dim=-4)
    if mesh is None:
        return magnitude.max()
    return collectives.pmax(magnitude.amax(dim=(-3, -2, -1)), mesh)


def _transport_3d_sharded(field, velocity, mesh, *, pref, nu_dt_by_dx2,
                          penalty_zone_width, filter_order, filter_type,
                          use_kernels):
    """The mesh branch of the transport of :func:`flow_step_3d`: (field,
    whether the wall sponge was applied)."""
    if not use_kernels:
        def plain(w, u):
            w = update_vorticity_from_velocity_forcing_3d(
                w, cross_product_3d(u, w), pref)
            w = diffusion_timestep_vector_3d(w, nu_dt_by_dx2)
            if filter_order > 0:
                w = laplacian_filter_vector_3d(w, filter_order, filter_type)
            return w

        return apply_assembled(plain, mesh, field, velocity), False
    field = sharded.rotational_curl_add_3d_sharded(field, velocity, pref, mesh)
    if filter_order == 0:
        # the wall sponge fused into the sharded diffusion pass where every
        # clamp source lies in its shard; the sharded diffusion kernel and
        # the sponge on the assembled field elsewhere
        return sharded.diffusion_penalise_vector_3d_sharded(
            field, nu_dt_by_dx2, penalty_zone_width, mesh), True
    field = sharded.diffusion_timestep_vector_3d_sharded(
        field, nu_dt_by_dx2, mesh)

    def filter_and_sponge(w):
        w = kernels.laplacian_filter_vector_3d(w, filter_order, filter_type)
        return kernels.penalise_field_boundary_vector_3d(
            w, penalty_zone_width)

    return apply_assembled(filter_and_sponge, mesh, field), True


def _passive_scalar_transport(field, velocity, dt_by_dx, nu_dt_by_dx2):
    field = advection_timestep_eno3_3d(field, velocity, dt_by_dx)
    return diffusion_timestep_3d(field, nu_dt_by_dx2)


def _passive_vector_transport(field, velocity, dt_by_dx, nu_dt_by_dx2):
    field = advection_timestep_eno3_vector_3d(field, velocity, dt_by_dx)
    return diffusion_timestep_vector_3d(field, nu_dt_by_dx2)


def flow_step_3d(
    state: FlowState3D,
    dt,
    free_stream_velocity,
    *,
    dx,
    nu,
    flow_type,
    with_free_stream,
    penalty_zone_width,
    filter_order,
    filter_type,
    poisson_solver,
    poisson_greens=None,
    use_kernels=False,
    mesh=None,
    return_velocity_l1_max=False,
):
    """One full 3D flow timestep (pure). ``dt`` is a 0-d tensor on the
    fields' device. ``return_velocity_l1_max=True`` returns
    ``(state, l1_max)`` with the new velocity's ``max |u|_1``, or None for
    the passive flow types, whose velocity never changes in the step. With
    a ``mesh`` the state's fields are sharded and the step takes the mesh
    branch."""
    field = state.primary_field
    velocity = state.velocity_field
    forcing = state.eul_grid_forcing_field
    if flow_type not in UnboundedFlowSimulator3D.SUPPORTED_FLOW_TYPES:
        raise ValueError(f"Invalid flow type {flow_type!r}")
    nu_dt_by_dx2 = nu * dt / dx / dx
    if flow_type in UnboundedFlowSimulator3D.PASSIVE_FLOW_TYPES:
        transport = (_passive_scalar_transport
                     if flow_type == "passive_scalar"
                     else _passive_vector_transport)
        args = (dt / dx, nu_dt_by_dx2)
        if mesh is None:
            field = transport(field, velocity, *args)
        else:
            field = apply_assembled(
                lambda f, u: transport(f, u, *args), mesh, field, velocity)
        new_state = FlowState3D(field, velocity, forcing)
        return (new_state, None) if return_velocity_l1_max else new_state
    pref = dt / (2.0 * dx)
    if flow_type == "navier_stokes_with_forcing" and mesh is None:
        field = update_vorticity_from_velocity_forcing_3d(field, forcing, pref)
    elif flow_type == "navier_stokes_with_forcing" and use_kernels:
        # omega + pref * 2 curl(f), the curl by the sharded kernel
        field = field + sharded.curl_3d_sharded(forcing, pref, mesh)
    elif flow_type == "navier_stokes_with_forcing":
        field = apply_assembled(
            lambda w, f: update_vorticity_from_velocity_forcing_3d(w, f, pref),
            mesh, field, forcing)
    penalised_in_transport = False
    if mesh is not None:
        field, penalised_in_transport = _transport_3d_sharded(
            field, velocity, mesh, pref=pref, nu_dt_by_dx2=nu_dt_by_dx2,
            penalty_zone_width=penalty_zone_width, filter_order=filter_order,
            filter_type=filter_type, use_kernels=use_kernels)
    elif use_kernels:
        field = kernels.rotational_curl_add_3d(field, velocity, pref)
        if filter_order == 0 and kernels.diffusion_penalise_supported(
            field.shape, penalty_zone_width
        ):
            # boundary penalisation fused into the diffusion pass (the
            # velocity-recovery stage then skips it)
            field = kernels.diffusion_penalise_vector_3d(
                field, nu_dt_by_dx2, penalty_zone_width
            )
            penalised_in_transport = True
        else:
            # the filtered (or sponge-less) transport: diffusion, the
            # filter, then the wall sponge, each its own kernel
            field = kernels.diffusion_timestep_vector_3d(field, nu_dt_by_dx2)
            if filter_order > 0:
                field = kernels.laplacian_filter_vector_3d(
                    field, filter_order, filter_type
                )
            if penalty_zone_width > 0:
                field = kernels.penalise_field_boundary_vector_3d(
                    field, penalty_zone_width
                )
                penalised_in_transport = True
    else:
        field = update_vorticity_from_velocity_forcing_3d(
            field, cross_product_3d(velocity, field), pref
        )
        field = diffusion_timestep_vector_3d(field, nu_dt_by_dx2)
        if filter_order > 0:
            field = laplacian_filter_vector_3d(field, filter_order, filter_type)
    res = compute_flow_velocity_3d(
        field,
        free_stream_velocity,
        dx=dx,
        penalty_zone_width=penalty_zone_width,
        poisson_solver=poisson_solver,
        with_free_stream=with_free_stream,
        poisson_greens=poisson_greens,
        use_kernels=use_kernels,
        mesh=mesh,
        return_velocity_l1_max=return_velocity_l1_max,
        skip_penalise=penalised_in_transport,
    )
    if return_velocity_l1_max:
        field, velocity, l1_max = res
    else:
        field, velocity = res
    if flow_type == "navier_stokes_with_forcing":
        forcing = torch.zeros_like(forcing)
    new_state = FlowState3D(field, velocity, forcing)
    if return_velocity_l1_max:
        return new_state, l1_max
    return new_state


def compute_stable_timestep_3d(velocity_field, *, CFL, dx, nu, tol, mesh=None):
    """CFL and diffusion limited dt, a 0-d tensor on the field's device;
    with a ``mesh`` the velocity is sharded and its maximum reduced over
    the mesh."""
    num = torch.full((), CFL * dx, dtype=velocity_field.dtype,
                     device=velocity_field.device)
    dt_advection = num / (velocity_l1_max_3d(velocity_field, mesh) + tol)
    dt_diffusion = 0.9 * dx**2 / (2 * 3) / (nu + tol)
    return torch.clamp(dt_advection, max=dt_diffusion)
