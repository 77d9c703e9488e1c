"""Penalty immersed-boundary ("virtual boundary") forcing (counterpart of
``sopht_mpi_tpu/ops/virtual_boundary.py``), after Goldstein 1993 JCP:

    lag_forcing = k * position_mismatch + c * velocity_mismatch,
    mismatch = flow - body,

with the stiffness/damping coefficients passed NEGATIVE by convention, so
the forcing decelerates the flow toward the body; the force ON the body is
``-sum(lag_forcing)``. The state is a small NamedTuple of tensors and every
function is pure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from sopht_mpi_tpu_torch.ops.ibm import (
    INTERP_KERNEL_WIDTH,
    eulerian_to_lagrangian_interpolation,
    interpolation_weights,
    lagrangian_to_eulerian_spread,
    nearest_grid_index_and_support,
)
from sopht_mpi_tpu_torch.parallel.mesh import apply_assembled


class VirtualBoundaryState(NamedTuple):
    """Forcing state; ``position_mismatch`` integrates the flow-body
    velocity mismatch (Euler forward)."""

    position_mismatch: torch.Tensor  # (grid_dim, n)
    time: torch.Tensor  # 0-d


class LagGridInteraction(NamedTuple):
    """Per-call results of the penalty force computation."""

    lag_forcing: torch.Tensor  # (grid_dim, n)
    velocity_mismatch: torch.Tensor  # (grid_dim, n)
    flow_velocity: torch.Tensor  # (grid_dim, n)


@dataclass(frozen=True)
class VirtualBoundaryForcingParams:
    """Static configuration.

    :param virtual_boundary_stiffness_coeff: penalty stiffness (negative).
    :param virtual_boundary_damping_coeff: penalty damping (negative).
    :param grid_dim: 2 or 3.
    :param dx: Eulerian grid spacing.
    :param eul_grid_coord_shift: grid-start offset (default dx/2).
    :param interp_kernel_width: delta support half-width (must be 2).
    :param delta_kind: "cosine" or "peskin".
    """

    virtual_boundary_stiffness_coeff: float
    virtual_boundary_damping_coeff: float
    grid_dim: int
    dx: float
    eul_grid_coord_shift: float | None = None
    interp_kernel_width: int = INTERP_KERNEL_WIDTH
    delta_kind: str = "cosine"

    def __post_init__(self):
        if self.grid_dim not in (2, 3):
            raise ValueError(
                "Invalid grid dimensions for virtual boundary forcing!"
            )
        if self.eul_grid_coord_shift is None:
            object.__setattr__(self, "eul_grid_coord_shift", self.dx / 2.0)


def init_virtual_boundary_state(
    num_lag_nodes: int, grid_dim: int, *, device, dtype=torch.float32,
    start_time=0.0,
) -> VirtualBoundaryState:
    return VirtualBoundaryState(
        position_mismatch=torch.zeros(
            (grid_dim, num_lag_nodes), dtype=dtype, device=device
        ),
        time=torch.tensor(start_time, dtype=dtype, device=device),
    )


def compute_penalty_force(position_mismatch, velocity_mismatch, params):
    """The penalty force law ``k dx_mismatch + c dv``, shared by the dense
    and sparse-window interaction paths."""
    return (
        params.virtual_boundary_stiffness_coeff * position_mismatch
        + params.virtual_boundary_damping_coeff * velocity_mismatch
    )


def _support_and_weights(lag_grid_position_field, params):
    _, support_idx, support_disp = nearest_grid_index_and_support(
        lag_grid_position_field,
        params.dx,
        params.eul_grid_coord_shift,
        params.interp_kernel_width,
    )
    weights = interpolation_weights(support_disp, params.dx, params.delta_kind)
    return support_idx, weights


def compute_interaction_force_on_lag_grid(
    state: VirtualBoundaryState,
    eul_grid_velocity_field,
    lag_grid_position_field,
    lag_grid_velocity_field,
    params: VirtualBoundaryForcingParams,
    mesh=None,
) -> LagGridInteraction:
    """Penalty force on the Lagrangian markers: grid support -> delta
    weights -> interpolate flow velocity -> mismatch -> ``k dx + c dv``.
    With a ``mesh`` the velocity is sharded and the interpolation reads the
    assembled field (one counted ``apply_assembled``), the op the JAX
    package leaves to its partitioner there."""
    if mesh is not None:
        return apply_assembled(
            lambda velocity: (None, compute_interaction_force_on_lag_grid(
                state, velocity, lag_grid_position_field,
                lag_grid_velocity_field, params)),
            mesh, eul_grid_velocity_field, aux=True)[1]
    support_idx, weights = _support_and_weights(lag_grid_position_field, params)
    flow_velocity = eulerian_to_lagrangian_interpolation(
        eul_grid_velocity_field, weights, support_idx, params.dx
    )
    velocity_mismatch = flow_velocity - lag_grid_velocity_field
    lag_forcing = compute_penalty_force(
        state.position_mismatch, velocity_mismatch, params
    )
    return LagGridInteraction(lag_forcing, velocity_mismatch, flow_velocity)


def compute_interaction_force_on_eul_and_lag_grid(
    state: VirtualBoundaryState,
    eul_grid_forcing_field,
    eul_grid_velocity_field,
    lag_grid_position_field,
    lag_grid_velocity_field,
    params: VirtualBoundaryForcingParams,
    reset_eul_grid_forcing_field: bool = False,
    mesh=None,
):
    """Penalty force on the markers plus its spreading onto the Eulerian
    forcing field. Returns (updated eul_grid_forcing_field,
    LagGridInteraction). With a ``mesh`` both fields are sharded, and the
    interpolation and the spreading run on the assembled fields in one
    counted ``apply_assembled``."""
    if mesh is not None:
        return apply_assembled(
            lambda forcing, velocity:
                compute_interaction_force_on_eul_and_lag_grid(
                    state, forcing, velocity, lag_grid_position_field,
                    lag_grid_velocity_field, params,
                    reset_eul_grid_forcing_field),
            mesh, eul_grid_forcing_field, eul_grid_velocity_field, aux=True)
    if reset_eul_grid_forcing_field:
        eul_grid_forcing_field = torch.zeros_like(eul_grid_forcing_field)
    support_idx, weights = _support_and_weights(lag_grid_position_field, params)
    flow_velocity = eulerian_to_lagrangian_interpolation(
        eul_grid_velocity_field, weights, support_idx, params.dx
    )
    velocity_mismatch = flow_velocity - lag_grid_velocity_field
    lag_forcing = compute_penalty_force(
        state.position_mismatch, velocity_mismatch, params
    )
    eul_grid_forcing_field = lagrangian_to_eulerian_spread(
        eul_grid_forcing_field, lag_forcing, weights, support_idx
    )
    return eul_grid_forcing_field, LagGridInteraction(
        lag_forcing, velocity_mismatch, flow_velocity
    )


def virtual_boundary_time_step(
    state: VirtualBoundaryState, velocity_mismatch, dt
) -> VirtualBoundaryState:
    """Euler-forward update of the position mismatch; the increment is cast
    to the state's dtype."""
    pm = state.position_mismatch
    return VirtualBoundaryState(
        position_mismatch=pm + (dt * velocity_mismatch).to(pm.dtype),
        time=state.time + torch.as_tensor(
            dt, dtype=state.time.dtype, device=state.time.device
        ),
    )
