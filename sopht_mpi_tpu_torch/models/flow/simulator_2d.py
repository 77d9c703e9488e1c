"""2D unbounded flow simulator, vorticity formulation (counterpart of
``sopht_mpi_tpu/models/flow/simulator_2d.py``, single device): flow types
``passive_scalar``, ``navier_stokes`` and ``navier_stokes_with_forcing``,
free-stream flow, the wall sponge, stable-timestep control and the
max-vorticity diagnostic.

One step is ENO3 advection and Euler-forward diffusion of the scalar, then
(Navier-Stokes) the wall sponge, the Poisson solve for the streamfunction
and its curl. The stencils are plain PyTorch (the JAX package has no Pallas
kernel for them); the Poisson solve takes the solver's kernel route on a
CUDA device (three FFT-pass kernels of
:mod:`sopht_mpi_tpu_torch.parallel.cuda_fft`). The step keeps dt and its
prefactors as 0-d tensors on the device: nothing in it waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sopht_mpi_tpu_torch.ops.elementwise import add_fixed_val
from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver2D
from sopht_mpi_tpu_torch.ops.stencils_2d import (
    advection_timestep_eno3_2d,
    diffusion_timestep_2d,
    outplane_field_curl_2d,
    penalise_field_boundary_2d,
    update_vorticity_from_velocity_forcing_2d,
)
from sopht_mpi_tpu_torch.utils.types import get_test_tol


class FlowState2D(NamedTuple):
    """``primary_scalar_field`` is the advected scalar for passive flows and
    the vorticity for Navier-Stokes."""

    primary_scalar_field: torch.Tensor
    velocity_field: torch.Tensor
    eul_grid_forcing_field: torch.Tensor | None = None


class UnboundedFlowSimulator2D:
    """2D unbounded flow simulator on one device.

    :param grid_size: (ny, nx).
    :param x_range: physical length of the x side of the domain.
    :param device: the torch device every field lives on; required, no
        default is taken from the environment.
    :param flow_type: "passive_scalar" | "navier_stokes" |
        "navier_stokes_with_forcing".
    :param penalty_zone_width: keyword option, wall sponge width in cells
        (default 2).
    :param fast_spectral: keyword option handed to the Poisson solver, where
        it changes nothing in 2D.
    """

    grid_dim = 2

    SUPPORTED_FLOW_TYPES = [
        "passive_scalar",
        "navier_stokes",
        "navier_stokes_with_forcing",
    ]

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
        **kwargs,
    ):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.grid_size = tuple(int(n) for n in grid_size)
        self.grid_size_y, self.grid_size_x = self.grid_size
        self.x_range = x_range
        self.real_t = real_t
        self.flow_type = flow_type
        self.with_free_stream_flow = with_free_stream_flow
        self.kinematic_viscosity = kinematic_viscosity
        self.CFL = CFL
        self.time = time
        if flow_type not in self.SUPPORTED_FLOW_TYPES:
            raise ValueError("Invalid flow type given")
        if flow_type == "passive_scalar" and with_free_stream_flow:
            raise ValueError(
                "Free stream flow not defined for passive advection diffusion!"
            )
        if mesh is not None:
            raise NotImplementedError(
                "mesh: the 2D mesh is not ported yet "
                "(ROADMAP.md queue A #11f)"
            )
        self.penalty_zone_width = kwargs.get("penalty_zone_width", 2)
        self.fast_spectral = kwargs.get("fast_spectral")
        unknown = set(kwargs) - {"penalty_zone_width", "fast_spectral"}
        if unknown:
            # a typo'd option silently running the defaults would poison a
            # benchmark's control arm
            raise TypeError(
                f"Unknown keyword argument(s) {sorted(unknown)}; "
                "supported: ['fast_spectral', 'penalty_zone_width']"
            )
        self._init_domain()
        self._init_fields()

    def _init_domain(self):
        self.y_range = self.x_range * self.grid_size_y / self.grid_size_x
        self.dx = float(self.x_range / self.grid_size_x)
        shift = self.dx / 2.0
        x = np.linspace(shift, self.x_range - shift, self.grid_size_x)
        y = np.linspace(shift, self.y_range - shift, self.grid_size_y)
        # position_field[0] = x grid, [1] = y grid
        self.position_field = torch.as_tensor(
            np.stack(np.meshgrid(x, y, indexing="xy")), dtype=self.real_t,
            device=self.device,
        )

    def _zeros(self, *lead):
        return torch.zeros(
            (*lead, *self.grid_size), dtype=self.real_t, device=self.device
        )

    def _init_fields(self):
        self.primary_scalar_field = self._zeros()
        self.velocity_field = self._zeros(self.grid_dim)
        self.eul_grid_forcing_field = (
            self._zeros(self.grid_dim)
            if self.flow_type == "navier_stokes_with_forcing" else None
        )
        self.unbounded_poisson_solver = None
        if self.flow_type in ("navier_stokes", "navier_stokes_with_forcing"):
            self.unbounded_poisson_solver = UnboundedPoissonSolver2D(
                grid_size_y=self.grid_size_y,
                grid_size_x=self.grid_size_x,
                x_range=self.x_range,
                real_t=self.real_t,
                device=self.device,
                fast_spectral=self.fast_spectral,
            )

    # vorticity is an alias of the primary scalar for NS flows
    @property
    def vorticity_field(self):
        return self.primary_scalar_field

    @vorticity_field.setter
    def vorticity_field(self, value):
        self.primary_scalar_field = value

    def step_config(self, flow_type=None) -> dict:
        """Keyword arguments of :func:`flow_step_2d` for this simulator
        (``flow_type`` overrides the simulator's own)."""
        return dict(
            dx=self.dx,
            nu=self.kinematic_viscosity,
            flow_type=flow_type or self.flow_type,
            with_free_stream=self.with_free_stream_flow,
            penalty_zone_width=self.penalty_zone_width,
            poisson_solver=self.unbounded_poisson_solver,
        )

    @property
    def _poisson_greens(self):
        """The solver's stored spectrum (dense, or the kernel route's
        (bulk, side) pair); None for a passive scalar."""
        solver = self.unbounded_poisson_solver
        return None if solver is None else solver.fourier_greens_times_dx_pow_dim

    def _get_state(self) -> FlowState2D:
        return FlowState2D(
            self.primary_scalar_field,
            self.velocity_field,
            self.eul_grid_forcing_field,
        )

    def _set_state(self, state: FlowState2D):
        self.primary_scalar_field = state.primary_scalar_field
        self.velocity_field = state.velocity_field
        self.eul_grid_forcing_field = state.eul_grid_forcing_field

    def _step_l1_fn(self, state, dt, free_stream_velocity, poisson_greens):
        """``(new state, max |u|_1 of its velocity)``, the maximum a 0-d
        tensor on the device."""
        new = flow_step_2d(
            state, dt, free_stream_velocity, poisson_greens=poisson_greens,
            **self.step_config(),
        )
        return new, new.velocity_field.abs().sum(dim=0).max()

    # -- public API ----------------------------------------------------------

    def time_step(self, dt, free_stream_velocity=(0.0, 0.0)):
        """Advance the flow by ``dt``."""
        fsv = torch.as_tensor(
            free_stream_velocity, dtype=self.real_t, device=self.device
        )
        dt_t = torch.as_tensor(dt, dtype=self.real_t, device=self.device)
        self._set_state(
            flow_step_2d(
                self._get_state(), dt_t, fsv,
                poisson_greens=self._poisson_greens, **self.step_config(),
            )
        )
        self.time += float(dt)

    def compute_stable_timestep(self, dt_prefac=1.0, precision="single") -> float:
        """CFL and diffusion limited timestep."""
        dt = compute_stable_timestep_2d(
            self.velocity_field,
            CFL=self.CFL,
            dx=self.dx,
            nu=self.kinematic_viscosity,
            tol=get_test_tol(precision),
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
        """Global maximum vorticity."""
        return float(self.vorticity_field.max())

    def compute_velocity_from_vorticity(self):
        """Recompute the velocity from the current vorticity (final
        diagnostics)."""
        vorticity, velocity, _ = compute_velocity_from_vorticity_2d(
            self.vorticity_field,
            dx=self.dx,
            penalty_zone_width=self.penalty_zone_width,
            poisson_solver=self.unbounded_poisson_solver,
        )
        self.vorticity_field = vorticity
        self.velocity_field = velocity


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------


def advection_and_diffusion_timestep_2d(field, velocity, dt, *, dx, nu):
    """ENO3 advection + Euler-forward diffusion."""
    field = advection_timestep_eno3_2d(field, velocity, dt / dx)
    return diffusion_timestep_2d(field, nu * dt / dx / dx)


def compute_velocity_from_vorticity_2d(
    vorticity, *, dx, penalty_zone_width, poisson_solver, poisson_greens=None
):
    """Penalise vorticity toward the walls, solve for the streamfunction,
    curl it into the velocity; returns (vorticity, velocity,
    streamfunction)."""
    vorticity = penalise_field_boundary_2d(vorticity, penalty_zone_width)
    stream_func = poisson_solver.solve(vorticity, poisson_greens)
    velocity = outplane_field_curl_2d(stream_func, 0.5 / dx)
    return vorticity, velocity, stream_func


def flow_step_2d(
    state: FlowState2D,
    dt,
    free_stream_velocity,
    *,
    dx,
    nu,
    flow_type,
    with_free_stream,
    penalty_zone_width,
    poisson_solver,
    poisson_greens=None,
) -> FlowState2D:
    """One full flow timestep (pure); ``dt`` a 0-d tensor on the fields'
    device or a number.

    [forcing: vorticity += dt/(2dx) curl(f)] -> advect+diffuse ->
    [NS: penalise walls -> Poisson -> curl -> free stream] ->
    [forcing: reset forcing field]."""
    field = state.primary_scalar_field
    velocity = state.velocity_field
    forcing = state.eul_grid_forcing_field

    if flow_type == "navier_stokes_with_forcing":
        field = update_vorticity_from_velocity_forcing_2d(
            field, forcing, dt / (2.0 * dx)
        )

    field = advection_and_diffusion_timestep_2d(field, velocity, dt, dx=dx, nu=nu)

    if flow_type in ("navier_stokes", "navier_stokes_with_forcing"):
        field, velocity, _ = compute_velocity_from_vorticity_2d(
            field,
            dx=dx,
            penalty_zone_width=penalty_zone_width,
            poisson_solver=poisson_solver,
            poisson_greens=poisson_greens,
        )
        if with_free_stream:
            velocity = add_fixed_val(velocity, free_stream_velocity)

    if flow_type == "navier_stokes_with_forcing":
        forcing = torch.zeros_like(forcing)

    return FlowState2D(field, velocity, forcing)


def compute_stable_timestep_2d(velocity_field, *, CFL, dx, nu, tol):
    """``min(CFL dx / max|u|_1, 0.9 dx^2 / (2 dim nu))``, a 0-d tensor on the
    field's device."""
    velocity_mag = velocity_field.abs().sum(dim=0)
    num = torch.full((), CFL * dx, dtype=velocity_field.dtype,
                     device=velocity_field.device)
    dt_advection = num / (velocity_mag.max() + tol)
    dt_diffusion = 0.9 * dx**2 / (2 * 2) / (nu + tol)
    return torch.clamp(dt_advection, max=dt_diffusion)
