"""Forcing grids for Cosserat rods (counterpart of
``sopht_mpi_tpu/models/immersed_body/rod_forcing_grids.py``).

All marker kinematics are tensor expressions on the rod state. The
surface grid's per-marker element index and angle are built once on the
host (radii are time-invariant), leaving gathers and a marker-to-element
sum per transfer at call time. That sum gathers each element's markers
into a row of an (elements, largest ring) table built on the host, padded
with zeros, and adds along the row: its order is fixed, so it gives the
same bits on every run (an ``index_add_`` on a CUDA tensor adds with
atomics in no fixed order).

Marker-side tensors may carry another float dtype than the rod (a float64
rod coupled to a float32 flow gives float64 markers and forcing, as JAX's
type promotion does); where ``torch.einsum`` or ``torch.linalg.cross``
would see two dtypes, the operands are cast to the promoted one first.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sopht_mpi_tpu_torch.models.immersed_body.forcing_grids import (
    ImmersedBodyForcingGrid,
)


def _promoted(*tensors):
    """The tensors cast to their promoted float dtype (JAX's promotion)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def _split_to_nodes(elem_force, rows=3):
    """(c, n) element forces -> (rows, n+1) node forces, half to each
    adjacent node (zero rows below ``c``)."""
    half = 0.5 * elem_force
    forces = F.pad(half, (0, 1)) + F.pad(half, (1, 0))
    return F.pad(forces, (0, 0, 0, rows - forces.shape[0]))


class CosseratRodElementCentricForcingGrid(ImmersedBodyForcingGrid):
    """2D grid with one marker per rod element (element centers). Forces
    go back to the two adjacent nodes with equal weights; no torques."""

    grid_dim = 2

    def __init__(self, cosserat_rod, **kwargs):
        self.rod = cosserat_rod
        self.num_lag_nodes = cosserat_rod.n_elems

    @property
    def position_field(self):
        return self.compute_lag_grid_position_field()

    def lag_positions(self, rod_state):
        pos = rod_state.position
        return 0.5 * (pos[:2, 1:] + pos[:2, :-1])

    def lag_velocities(self, rod_state):
        vel = rod_state.velocity
        return 0.5 * (vel[:2, 1:] + vel[:2, :-1])

    def body_loads(self, rod_state, lag_grid_forcing_field):
        n = lag_grid_forcing_field.shape[1]
        forces = _split_to_nodes(-lag_grid_forcing_field)  # force ON body
        torques = lag_grid_forcing_field.new_zeros((3, n))
        return forces, torques

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.rod.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.rod.state)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.rod.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return float(self.rod.lengths.max())


class CosseratRodEdgeForcingGrid(ImmersedBodyForcingGrid):
    """2D grid with markers at rod element centers and both lateral edges
    (centers +- radius along the in-plane normal): ``3 * n_elems``
    markers, ordered ``[:n]`` centers, ``[n:2n]`` the "+normal" edge,
    ``[2n:]`` the "-normal" edge, with the in-plane normal ``z x t``.
    Edge-marker velocities include the element's rotation; edge forces
    add moments about the element centers."""

    grid_dim = 2

    def __init__(self, cosserat_rod, **kwargs):
        self.rod = cosserat_rod
        self.num_lag_nodes = 3 * cosserat_rod.n_elems
        self._radius = cosserat_rod.params.radius.clone()
        self._max_spacing = float(cosserat_rod.params.rest_lengths.max())

    def _frames(self, rod_state):
        """(centers (2,n), vels (2,n), omega_z (n,), arm (2,n)) with
        ``arm = radius * (z x t)`` the "+edge" moment arm in-plane."""
        pos = rod_state.position
        vel = rod_state.velocity
        centers = 0.5 * (pos[:2, 1:] + pos[:2, :-1])
        vels = 0.5 * (vel[:2, 1:] + vel[:2, :-1])
        tangent = pos[:2, 1:] - pos[:2, :-1]
        tangent = tangent / torch.linalg.norm(tangent, dim=0, keepdim=True)
        normal = torch.stack([-tangent[1], tangent[0]])  # z x t
        arm = self._radius * normal
        # lab-frame angular velocity, z component (the only in-plane one)
        omega_z = torch.einsum(
            "jn,jn->n", rod_state.director[:, 2], rod_state.omega
        )
        return centers, vels, omega_z, arm

    @property
    def position_field(self):
        return self.compute_lag_grid_position_field()

    def lag_positions(self, rod_state):
        centers, _, _, arm = self._frames(rod_state)
        return torch.cat([centers, centers + arm, centers - arm], dim=1)

    def lag_velocities(self, rod_state):
        centers, vels, omega_z, arm = self._frames(rod_state)
        rot = omega_z * torch.stack([-arm[1], arm[0]])  # omega_z z x arm
        return torch.cat([vels, vels + rot, vels - rot], dim=1)

    def body_loads(self, rod_state, lag_grid_forcing_field):
        n = rod_state.omega.shape[1]
        body_force = -lag_grid_forcing_field  # Newton's third law
        f_center = body_force[:, :n]
        f_plus = body_force[:, n : 2 * n]
        f_minus = body_force[:, 2 * n :]
        forces = _split_to_nodes(f_center + f_plus + f_minus)
        # edge moments about the element centers: arm x F ("-edge" arm is
        # -arm), z component only in-plane
        _, _, _, arm = self._frames(rod_state)
        df = f_plus - f_minus
        torque_z = arm[0] * df[1] - arm[1] * df[0]
        elem_torque_lab = F.pad(
            torque_z.to(body_force.dtype)[None], (0, 0, 2, 0)
        )
        director, elem_torque_lab = _promoted(
            rod_state.director, elem_torque_lab
        )
        torques = torch.einsum("ijn,jn->in", director, elem_torque_lab)
        return forces, torques

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.rod.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.rod.state)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.rod.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return self._max_spacing


class CosseratRodSurfaceForcingGrid(ImmersedBodyForcingGrid):
    """3D grid with markers on the rod's lateral surface: one ring per
    element, with ``surface_grid_density_for_largest_element`` points on
    the largest ring and the others scaled by radius.

    Marker kinematics include the element's rigid rotation
    (``v = v_elem + omega_lab x arm``); the force transfer splits each
    marker's force between the adjacent nodes and sums the material-frame
    torque about the element center.
    """

    grid_dim = 3

    def __init__(
        self,
        cosserat_rod,
        surface_grid_density_for_largest_element: int,
        with_cap: bool = False,
        **kwargs,
    ):
        self.rod = cosserat_rod
        position = cosserat_rod.state.position
        radii = cosserat_rod.params.radius.cpu().numpy()
        n_elems = cosserat_rod.n_elems
        r_max = float(radii.max())
        density = int(surface_grid_density_for_largest_element)

        elem_idx = []
        angles = []
        for k in range(n_elems):
            n_theta = max(1, int(np.ceil(density * radii[k] / r_max)))
            th = np.linspace(0.0, 2.0 * np.pi, n_theta, endpoint=False)
            elem_idx.extend([k] * n_theta)
            angles.extend(th.tolist())
        np_elem_idx = np.asarray(elem_idx, np.int64)
        angles = np.asarray(angles, radii.dtype)
        device = position.device
        self._elem_idx = torch.tensor(np_elem_idx, device=device)
        self._cos_t = torch.tensor(np.cos(angles), device=device)
        self._sin_t = torch.tensor(np.sin(angles), device=device)
        self._radius = torch.tensor(radii[np_elem_idx], device=device)
        self.num_lag_nodes = len(elem_idx)

        ring_counts = np.bincount(np_elem_idx, minlength=n_elems)
        # each element's markers in a row, padded with the index of a zero
        # column past the last marker (the markers come element by element)
        starts = np.concatenate(([0], np.cumsum(ring_counts)[:-1]))
        cols = np.arange(max(1, ring_counts.max()))
        table = np.where(cols < ring_counts[:, None], starts[:, None] + cols,
                         len(np_elem_idx))
        self._elem_rows = torch.tensor(table, device=device)
        lengths = cosserat_rod.params.rest_lengths.cpu().numpy()
        self._max_spacing = float(
            max(
                lengths.max(),
                (2.0 * np.pi * radii / np.maximum(ring_counts, 1)).max(),
            )
        )

    def _element_frames(self, state):
        """(centers, velocities, omega_lab, d1, d2) gathered per marker."""
        idx = self._elem_idx
        centers = 0.5 * (state.position[:, 1:] + state.position[:, :-1])
        vels = 0.5 * (state.velocity[:, 1:] + state.velocity[:, :-1])
        # omega in lab frame: w_lab = Q^T w_material
        omega_lab = torch.einsum("jin,jn->in", state.director, state.omega)
        d1 = state.director[0]  # (3, n): material axis 1 in lab frame
        d2 = state.director[1]
        return (
            centers[:, idx],
            vels[:, idx],
            omega_lab[:, idx],
            d1[:, idx],
            d2[:, idx],
        )

    def _moment_arms(self, state):
        _, _, _, d1, d2 = self._element_frames(state)
        return self._radius * (self._cos_t * d1 + self._sin_t * d2)

    @property
    def position_field(self):
        return self.compute_lag_grid_position_field()

    def lag_positions(self, rod_state):
        centers, _, _, d1, d2 = self._element_frames(rod_state)
        return centers + self._radius * (self._cos_t * d1 + self._sin_t * d2)

    def lag_velocities(self, rod_state):
        _, vels, omega_lab, d1, d2 = self._element_frames(rod_state)
        arm = self._radius * (self._cos_t * d1 + self._sin_t * d2)
        return vels + torch.linalg.cross(omega_lab, arm, dim=0)

    def _element_sums(self, marker_values):
        """(3, markers) -> (3, elements): each element's markers summed
        in the fixed order of its row of ``_elem_rows``."""
        padded = F.pad(marker_values, (0, 1))
        return padded[:, self._elem_rows].sum(dim=-1)

    def body_loads(self, rod_state, lag_grid_forcing_field):
        dtype = lag_grid_forcing_field.dtype
        body_force = -lag_grid_forcing_field  # Newton's third law
        # per-element force, split half-half to the adjacent nodes
        forces = _split_to_nodes(self._element_sums(body_force))
        # material-frame torque about the element centers
        arm, force = _promoted(self._moment_arms(rod_state), body_force)
        torque_lab = torch.linalg.cross(arm, force, dim=0).to(dtype)
        elem_torque_lab = self._element_sums(torque_lab)
        director, elem_torque_lab = _promoted(
            rod_state.director, elem_torque_lab
        )
        torques = torch.einsum("ijn,jn->in", director, elem_torque_lab)
        return forces, torques

    def compute_lag_grid_position_field(self):
        return self.lag_positions(self.rod.state)

    def compute_lag_grid_velocity_field(self):
        return self.lag_velocities(self.rod.state)

    def transfer_forcing_from_grid_to_body(self, lag_grid_forcing_field):
        return self.body_loads(self.rod.state, lag_grid_forcing_field)

    def get_maximum_lagrangian_grid_spacing(self):
        return self._max_spacing
