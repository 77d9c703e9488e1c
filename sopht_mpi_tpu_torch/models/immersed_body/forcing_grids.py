"""Forcing grids: Lagrangian marker sets attached to immersed bodies
(counterpart of ``sopht_mpi_tpu/models/immersed_body/forcing_grids.py``;
the base class, the empty grid, the 2D cylinder and the sphere).

A forcing grid computes marker positions/velocities from the body state
each call, and ``transfer_forcing_from_grid_to_body`` returns the body
forces/torques (force on body = -sum of the Lagrangian penalty forcing).
"""

from __future__ import annotations

import numpy as np
import torch


class ImmersedBodyForcingGrid:
    """Abstract forcing grid interface."""

    grid_dim: int
    num_lag_nodes: int

    def compute_lag_grid_position_field(self):
        raise NotImplementedError

    def compute_lag_grid_velocity_field(self):
        raise NotImplementedError

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        """Return (body_flow_forces (3, ...), body_flow_torques (3, ...))."""
        raise NotImplementedError

    def get_maximum_lagrangian_grid_spacing(self) -> float:
        raise NotImplementedError


class EmptyForcingGrid(ImmersedBodyForcingGrid):
    """Zero-node grid.

    :param device: the torch device of the (empty) marker tensors."""

    def __init__(self, grid_dim, *, device, dtype=torch.float32):
        self.grid_dim = grid_dim
        self.num_lag_nodes = 0
        self._device, self._dtype = torch.device(device), dtype

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self._dtype, device=self._device)

    def compute_lag_grid_position_field(self):
        return self._zeros(self.grid_dim, 0)

    def compute_lag_grid_velocity_field(self):
        return self._zeros(self.grid_dim, 0)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self._zeros(3, 1), self._zeros(3, 1)

    def get_maximum_lagrangian_grid_spacing(self):
        return 0.0


class CircularCylinderForcingGrid(ImmersedBodyForcingGrid):
    """Markers on the perimeter of a 2D circular cylinder."""

    grid_dim = 2

    def __init__(self, rigid_body, num_forcing_points: int):
        self.body = rigid_body
        self.num_lag_nodes = num_forcing_points
        theta = np.linspace(
            0.0, 2.0 * np.pi, num_forcing_points, endpoint=False
        )
        position = self.body.state.position
        self._local_points = torch.as_tensor(
            rigid_body.radius * np.stack([np.cos(theta), np.sin(theta)]),
            dtype=position.dtype, device=position.device,
        )

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.body.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.body.state)

    def lag_positions(self, state):
        return state.position[:2, None] + self._rotated_points(state)

    def lag_velocities(self, state):
        # v + omega x r (z-rotation only in 2D)
        omega_z = state.omega[2]
        r = self._rotated_points(state)
        rot = torch.stack([-omega_z * r[1], omega_z * r[0]])
        return state.velocity[:2, None] + rot

    def body_loads(self, state, lag_grid_forcing_field):
        """(3, 1) global-frame force and torque about the centre of mass
        from the Lagrangian penalty forcing."""
        f = lag_grid_forcing_field
        zero = f.new_zeros(())
        forces = torch.stack([-f[0].sum(), -f[1].sum(), zero]).reshape(3, 1)
        r = self._rotated_points(state)
        torque_z = -(r[0] * f[1] - r[1] * f[0]).sum()
        torques = torch.stack([zero, zero, torque_z]).reshape(3, 1)
        return forces, torques

    def _rotated_points(self, state):
        """Body-frame marker offsets rotated into the global frame."""
        return (state.director[:2, :2] @ self._local_points).to(
            self._local_points.dtype
        )

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.body.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return 2.0 * np.pi * self.body.radius / self.num_lag_nodes


class SphereForcingGrid(ImmersedBodyForcingGrid):
    """Near-uniform markers on a sphere surface, parameterised by the
    number of points along the equator (rows at constant polar angle with
    azimuthal counts proportional to sin(theta)), plus the two poles."""

    grid_dim = 3

    def __init__(self, rigid_body, num_forcing_points_along_equator: int):
        self.body = rigid_body
        n_eq = num_forcing_points_along_equator
        polar = np.linspace(0, np.pi, n_eq // 2 + 1)[1:-1]  # exclude poles
        pts = [np.array([[0.0, 0.0, 1.0]]), np.array([[0.0, 0.0, -1.0]])]
        for theta in polar:
            n_az = max(1, int(round(n_eq * np.sin(theta))))
            phi = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
            pts.append(
                np.stack(
                    [
                        np.sin(theta) * np.cos(phi),
                        np.sin(theta) * np.sin(phi),
                        np.full(n_az, np.cos(theta)),
                    ],
                    axis=1,
                )
            )
        unit = np.concatenate(pts, axis=0).T  # (3, N)
        self.num_lag_nodes = unit.shape[1]
        position = self.body.state.position
        self._local_points = torch.as_tensor(
            rigid_body.radius * unit, dtype=position.dtype,
            device=position.device,
        )
        self._max_spacing = 2.0 * np.pi * rigid_body.radius / n_eq

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.body.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.body.state)

    def lag_positions(self, state):
        return state.position[:, None] + self._rotated_points(state)

    def lag_velocities(self, state):
        omega = state.omega
        r = self._rotated_points(state)
        rot = torch.stack(
            [
                omega[1] * r[2] - omega[2] * r[1],
                omega[2] * r[0] - omega[0] * r[2],
                omega[0] * r[1] - omega[1] * r[0],
            ]
        )
        return state.velocity[:, None] + rot

    def body_loads(self, state, lag_grid_forcing_field):
        forces = -lag_grid_forcing_field.sum(dim=1, keepdim=True)
        r = self._rotated_points(state)
        f = lag_grid_forcing_field
        torques = -torch.stack(
            [
                (r[1] * f[2] - r[2] * f[1]).sum(dim=0, keepdim=True),
                (r[2] * f[0] - r[0] * f[2]).sum(dim=0, keepdim=True),
                (r[0] * f[1] - r[1] * f[0]).sum(dim=0, keepdim=True),
            ]
        )
        return forces, torques

    def _rotated_points(self, state):
        return (state.director @ self._local_points).to(
            self._local_points.dtype
        )

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.body.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return self._max_spacing
