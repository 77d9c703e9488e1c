"""Immersed body <-> flow interaction (counterpart of
``sopht_mpi_tpu/models/immersed_body/interaction.py``: the base class, the
rigid-body and the Cosserat-rod interactors).

Bridges a flow simulator and a body's forcing grid through the penalty
virtual-boundary forcing::

    interactor = RigidBodyFlowInteraction(flow_sim, sphere, forcing_grid, ...)
    interactor.time_step(dt)   # integrate position mismatch
    interactor()               # penalty force -> flow_sim.eul_grid_forcing_field
    flow_sim.time_step(dt)

On a 3D simulator's mesh the dense interpolation and spreading run on the
assembled fields (``parallel.mesh.apply_assembled``, counted), the ops the
JAX package leaves to its partitioner there.
"""

from __future__ import annotations

import numpy as np
import torch

from sopht_mpi_tpu_torch.ops.virtual_boundary import (
    VirtualBoundaryForcingParams,
    compute_interaction_force_on_eul_and_lag_grid,
    compute_interaction_force_on_lag_grid,
    init_virtual_boundary_state,
    virtual_boundary_time_step,
)
from sopht_mpi_tpu_torch.utils.logging_utils import logger


class ImmersedBodyFlowInteraction:
    """Base interactor between a flow simulator and a forcing grid."""

    def __init__(
        self,
        flow_sim,
        forcing_grid,
        virtual_boundary_stiffness_coeff: float,
        virtual_boundary_damping_coeff: float,
        eul_grid_coord_shift=None,
        interp_kernel_width=None,
        delta_kind="cosine",
        start_time=0.0,
        body_dim=3,
    ):
        self.flow_sim = flow_sim
        self.forcing_grid = forcing_grid
        grid_dim = forcing_grid.grid_dim
        dx = flow_sim.dx

        max_lag_grid_dx = forcing_grid.get_maximum_lagrangian_grid_spacing()
        grid_type = type(forcing_grid).__name__
        if max_lag_grid_dx > 2 * dx:
            logger.warning(
                f"For {grid_type}: Eulerian grid spacing (dx): {dx}; max "
                f"Lagrangian grid spacing {max_lag_grid_dx} > 2 * dx: the "
                "body's Lagrangian grid is too coarse for the flow grid."
            )
        elif max_lag_grid_dx < 0.5 * dx:
            logger.warning(
                f"For {grid_type}: Eulerian grid spacing (dx): {dx}; max "
                f"Lagrangian grid spacing {max_lag_grid_dx} < 0.5 * dx: the "
                "body's Lagrangian grid has redundant forcing points."
            )

        # rescale coeffs by the Lagrangian spacing
        scale = max_lag_grid_dx ** (grid_dim - 1)
        self.params = VirtualBoundaryForcingParams(
            virtual_boundary_stiffness_coeff=virtual_boundary_stiffness_coeff * scale,
            virtual_boundary_damping_coeff=virtual_boundary_damping_coeff * scale,
            grid_dim=grid_dim,
            dx=dx,
            eul_grid_coord_shift=eul_grid_coord_shift,
            interp_kernel_width=interp_kernel_width or 2,
            delta_kind=delta_kind,
        )
        dtype, device = flow_sim.real_t, flow_sim.device
        n = forcing_grid.num_lag_nodes
        self.state = init_virtual_boundary_state(
            n, grid_dim, device=device, dtype=dtype, start_time=start_time
        )
        self._velocity_mismatch = torch.zeros(
            (grid_dim, n), dtype=dtype, device=device
        )
        self.global_lag_grid_forcing_field = torch.zeros(
            (grid_dim, n), dtype=dtype, device=device
        )
        self.body_flow_forces = torch.zeros(
            (3, body_dim), dtype=dtype, device=device
        )
        self.body_flow_torques = torch.zeros(
            (3, body_dim), dtype=dtype, device=device
        )

    # -- interaction --------------------------------------------------------

    def compute_interaction_on_lag_grid(self):
        """Penalty force on the Lagrangian grid only."""
        pos = self.forcing_grid.compute_lag_grid_position_field()
        vel = self.forcing_grid.compute_lag_grid_velocity_field()
        interaction = compute_interaction_force_on_lag_grid(
            self.state, self.flow_sim.velocity_field, pos, vel, self.params,
            mesh=getattr(self.flow_sim, "mesh", None),
        )
        self.global_lag_grid_forcing_field = interaction.lag_forcing
        self._velocity_mismatch = interaction.velocity_mismatch
        return interaction

    def compute_full_interaction(self):
        """Penalty force plus spreading onto the flow's forcing field."""
        pos = self.forcing_grid.compute_lag_grid_position_field()
        vel = self.forcing_grid.compute_lag_grid_velocity_field()
        eul_forcing, interaction = compute_interaction_force_on_eul_and_lag_grid(
            self.state,
            self.flow_sim.eul_grid_forcing_field,
            self.flow_sim.velocity_field,
            pos,
            vel,
            self.params,
            mesh=getattr(self.flow_sim, "mesh", None),
        )
        self.flow_sim.eul_grid_forcing_field = eul_forcing
        self.global_lag_grid_forcing_field = interaction.lag_forcing
        self._velocity_mismatch = interaction.velocity_mismatch
        return interaction

    def __call__(self):
        self.compute_full_interaction()

    def time_step(self, dt):
        """Integrate the position mismatch with the mismatch of the most
        recent interaction computation."""
        self.state = virtual_boundary_time_step(
            self.state, self._velocity_mismatch, dt
        )

    # -- diagnostics / body coupling ----------------------------------------

    def compute_flow_forces_and_torques(self):
        """Force/torque transfer onto the body."""
        self.compute_interaction_on_lag_grid()
        self.body_flow_forces, self.body_flow_torques = (
            self.forcing_grid.transfer_forcing_from_grid_to_body(
                self.global_lag_grid_forcing_field
            )
        )

    @property
    def position_mismatch(self):
        """The penalty position-mismatch field, the IBM state a restart
        must restore for the run to go on exactly."""
        return self.state.position_mismatch

    @position_mismatch.setter
    def position_mismatch(self, value):
        old = self.state.position_mismatch
        self.state = self.state._replace(position_mismatch=torch.as_tensor(
            value, dtype=old.dtype, device=old.device))

    def get_grid_deviation_error_l2_norm(self) -> float:
        """L2 norm of the flow-body grid deviation."""
        num = max(self.forcing_grid.num_lag_nodes, 1)
        return float(
            torch.linalg.norm(self.state.position_mismatch) / np.sqrt(num)
        )


class RigidBodyFlowInteraction(ImmersedBodyFlowInteraction):
    """Rigid body interactor: body forces/torques shape (3, 1)."""

    def __init__(self, flow_sim, rigid_body, forcing_grid, **kwargs):
        self.rigid_body = rigid_body
        super().__init__(flow_sim, forcing_grid, body_dim=1, **kwargs)


class CosseratRodFlowInteraction(ImmersedBodyFlowInteraction):
    """Cosserat rod interactor: body forces on nodes (3, n_elems+1),
    torques on elements (3, n_elems).

    :param forcing_grid_cls: e.g. ``CosseratRodSurfaceForcingGrid`` (3D);
        the grid's own keyword arguments
        (``surface_grid_density_for_largest_element``, ``with_cap``,
        ``num_forcing_points``) go to it, the rest to the base class.
    """

    def __init__(
        self,
        flow_sim,
        cosserat_rod,
        virtual_boundary_stiffness_coeff,
        virtual_boundary_damping_coeff,
        forcing_grid_cls,
        **kwargs,
    ):
        self.cosserat_rod = cosserat_rod
        grid_kwargs = {
            k: kwargs.pop(k)
            for k in list(kwargs)
            if k
            in (
                "surface_grid_density_for_largest_element",
                "with_cap",
                "num_forcing_points",
            )
        }
        forcing_grid = forcing_grid_cls(cosserat_rod=cosserat_rod, **grid_kwargs)
        super().__init__(
            flow_sim,
            forcing_grid,
            virtual_boundary_stiffness_coeff,
            virtual_boundary_damping_coeff,
            body_dim=cosserat_rod.n_elems,
            **kwargs,
        )
        n = cosserat_rod.n_elems
        self.body_flow_forces = torch.zeros(
            (3, n + 1), dtype=flow_sim.real_t, device=flow_sim.device
        )
        self.body_flow_torques = torch.zeros(
            (3, n), dtype=flow_sim.real_t, device=flow_sim.device
        )
