"""Boundary conditions, external forcings and damping for Cosserat rods
(counterpart of ``sopht_mpi_tpu/models/elastica/forcing.py``).

PyElastica's ``OneEndFixedBC``, ``GeneralConstraint``, ``GravityForces``,
``EndpointForces`` and ``AnalyticalLinearDamper``, and sopht's
``FlowForces`` coupling. Each is a small object whose methods map a rod
state to a new one without changing their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from sopht_mpi_tpu_torch.models.elastica.rod import (
    CosseratRodState,
    compute_geometry,
)


class OneEndFixedBC:
    """Clamp one end: fixed node position and element director."""

    def __init__(self, fixed_position, fixed_director, node_idx=0, elem_idx=0):
        self.fixed_position = fixed_position
        self.fixed_director = fixed_director
        self.node_idx = node_idx
        self.elem_idx = elem_idx

    def constrain_values(self, state: CosseratRodState) -> CosseratRodState:
        position = state.position.clone()
        position[:, self.node_idx] = self.fixed_position
        director = state.director.clone()
        director[:, :, self.elem_idx] = self.fixed_director
        return state._replace(position=position, director=director)

    def constrain_rates(self, state: CosseratRodState) -> CosseratRodState:
        velocity = state.velocity.clone()
        velocity[:, self.node_idx] = 0.0
        omega = state.omega.clone()
        omega[:, self.elem_idx] = 0.0
        return state._replace(velocity=velocity, omega=omega)


class FreeBC:
    """No constraint (free rod)."""

    def constrain_values(self, state):
        return state

    def constrain_rates(self, state):
        return state


class GeneralConstraint:
    """Selective end constraint (PyElastica's ``GeneralConstraint``).

    :param translational_constraint_selector: (3,) bool, lab frame - which
        node velocity/position components are fixed.
    :param rotational_constraint_selector: (3,) bool, LAB frame - which
        lab-frame angular-velocity components are zeroed.
    """

    def __init__(
        self,
        fixed_position,
        fixed_director,
        translational_constraint_selector,
        rotational_constraint_selector,
        node_idx=0,
        elem_idx=0,
    ):
        device = fixed_position.device
        self.fixed_position = fixed_position
        self.t_sel = torch.tensor(
            np.asarray(translational_constraint_selector, bool), device=device
        )
        self.r_sel = torch.tensor(
            np.asarray(rotational_constraint_selector, bool), device=device
        )
        self.node_idx = node_idx
        self.elem_idx = elem_idx

    def constrain_values(self, state: CosseratRodState) -> CosseratRodState:
        i = self.node_idx
        position = state.position.clone()
        position[:, i] = torch.where(
            self.t_sel, self.fixed_position, state.position[:, i]
        )
        return state._replace(position=position)

    def constrain_rates(self, state: CosseratRodState) -> CosseratRodState:
        i, k = self.node_idx, self.elem_idx
        velocity = state.velocity.clone()
        velocity[:, i] = torch.where(self.t_sel, 0.0, state.velocity[:, i])
        # the rotational selector acts in the LAB frame: rotate the
        # element's angular velocity out, mask, rotate back
        q = state.director[:, :, k]  # (3, 3): rows are material axes
        w_lab = q.T @ state.omega[:, k]
        w_lab = torch.where(self.r_sel, 0.0, w_lab)
        omega = state.omega.clone()
        omega[:, k] = q @ w_lab
        return state._replace(velocity=velocity, omega=omega)


class _HostVector:
    """A float64 host vector, copied once to each (dtype, device) asked."""

    def __init__(self, value):
        self.value = np.asarray(value, np.float64)
        self._copies = {}

    def on(self, like):
        key = (like.dtype, like.device)
        if key not in self._copies:
            self._copies[key] = torch.tensor(
                self.value, dtype=like.dtype, device=like.device
            )
        return self._copies[key]


class GravityForces:
    """Uniform gravitational force on nodes: ``F_i = m_i g``."""

    requires_host = False

    def __init__(self, acc_gravity):
        self.acc_gravity = _HostVector(acc_gravity)

    def compute(self, state: CosseratRodState, params, time):
        like = state.position
        forces = self.acc_gravity.on(like)[:, None] * params.mass[None, :]
        torques = like.new_zeros((3, params.rest_lengths.shape[0]))
        return forces, torques


class EndpointForces:
    """Forces on the two end nodes with an optional linear ramp-up
    (PyElastica's ``EndpointForces``)."""

    requires_host = False

    def __init__(self, start_force, end_force, ramp_up_time=0.0):
        self.start_force = _HostVector(start_force)
        self.end_force = _HostVector(end_force)
        self.ramp_up_time = float(ramp_up_time)

    def compute(self, state: CosseratRodState, params, time):
        n = params.rest_lengths.shape[0]
        like = state.position
        if self.ramp_up_time > 0:
            t = torch.as_tensor(time, dtype=like.dtype, device=like.device)
            factor = torch.clamp(t / self.ramp_up_time, max=1.0)
        else:
            factor = 1.0
        forces = like.new_zeros((3, n + 1))
        forces[:, 0] += factor * self.start_force.on(like)
        forces[:, -1] += factor * self.end_force.on(like)
        return forces, like.new_zeros((3, n))


class FlowForces:
    """Two-way FSI coupling forcing (sopht's ``FlowForces``): before each
    rod step the interactor's penalty body forces/torques are refreshed
    and passed into the rod step as host-supplied buffers."""

    requires_host = True

    def __init__(self, cosserat_rod_flow_interactor):
        self.interactor = cosserat_rod_flow_interactor

    def compute_host(self, rod, time=0.0):
        self.interactor.compute_flow_forces_and_torques()
        dtype = rod.state.position.dtype
        return (
            self.interactor.body_flow_forces.to(dtype),
            self.interactor.body_flow_torques.to(dtype),
        )


class AnalyticalLinearDamper:
    """Exponential velocity damping (PyElastica's analytical damper):
    ``v <- v exp(-c dt)``, ``w <- w exp(-c dt)^e`` with element dilatation
    ``e``."""

    def __init__(self, damping_constant, time_step):
        self.damping_constant = float(damping_constant)
        self.time_step = float(time_step)
        self._factor = float(np.exp(-damping_constant * time_step))

    def dampen_rates(self, state: CosseratRodState, params) -> CosseratRodState:
        _, _, dilatation, _ = compute_geometry(state, params)
        return state._replace(
            velocity=state.velocity * self._factor,
            omega=state.omega * self._factor**dilatation,
        )
