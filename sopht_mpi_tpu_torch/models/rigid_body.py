"""Rigid bodies (counterpart of ``sopht_mpi_tpu/models/rigid_body.py``): the
body state, the 2D cylinder, the 3D sphere and the position-Verlet rigid-body dynamics that
two-way coupling hands the flow loads to. A body built with a ``density``
carries ``mass`` and ``inertia_body``; without one it stays kinematic
(fixed or prescribed)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RigidBodyState(NamedTuple):
    """Rigid body kinematic state: position/velocity/angular velocity in
    the global frame, shape (3,) (a 2D body uses the x-y components and the
    z rotation); ``director`` the body->global rotation matrix, shape
    (3, 3)."""

    position: torch.Tensor
    velocity: torch.Tensor
    omega: torch.Tensor
    director: torch.Tensor

    @staticmethod
    def create(position, velocity=None, omega=None, director=None, *,
               device, dtype=None):
        position = torch.as_tensor(position, dtype=dtype, device=device)
        dtype = position.dtype
        if position.shape[0] == 2:
            position = torch.cat([position, position.new_zeros(1)])

        def vec(v, default):
            return (
                default if v is None
                else torch.as_tensor(v, dtype=dtype, device=device)
            )

        return RigidBodyState(
            position=position,
            velocity=vec(velocity, torch.zeros(3, dtype=dtype, device=device)),
            omega=vec(omega, torch.zeros(3, dtype=dtype, device=device)),
            director=vec(director, torch.eye(3, dtype=dtype, device=device)),
        )


def _rotate_matrix(director, omega, dt):
    """Advance the body->global director by a rotation about the global
    angular velocity: ``Q <- exp(hat(omega) dt) Q`` (Rodrigues form, with
    the series of sin and cos below ``|omega| dt = 1e-10``)."""
    phi = omega * dt
    theta2 = (phi * phi).sum()
    theta = torch.sqrt(theta2)
    safe = theta > 1e-10
    theta_s = torch.where(safe, theta, torch.ones_like(theta))
    sinc = torch.where(safe, torch.sin(theta_s) / theta_s, 1.0 - theta2 / 6.0)
    cosc = torch.where(
        safe, (1.0 - torch.cos(theta_s)) / (theta_s * theta_s),
        0.5 - theta2 / 24.0,
    )
    zero = torch.zeros((), dtype=director.dtype, device=director.device)
    px = torch.stack([
        torch.stack([zero, -phi[2], phi[1]]),
        torch.stack([phi[2], zero, -phi[0]]),
        torch.stack([-phi[1], phi[0], zero]),
    ]).to(director.dtype)
    eye = torch.eye(3, dtype=director.dtype, device=director.device)
    rot = eye + sinc * px + cosc * (px @ px)
    return rot @ director


def rigid_body_acceleration(state: RigidBodyState, force, torque, mass,
                            inertia_body):
    """Linear and angular acceleration from global-frame loads: Euler's
    equation in the global frame with the body-frame principal inertia
    ``inertia_body`` (3,), ``alpha = I_g^{-1} (T - omega x (I_g omega))``,
    ``I_g = Q I_b Q^T``."""
    q = state.director
    inertia_body = torch.as_tensor(inertia_body, dtype=q.dtype, device=q.device)
    i_omega = q @ (inertia_body * (q.T @ state.omega))
    gyro = torch.linalg.cross(state.omega, i_omega)
    torque = torch.as_tensor(torque, dtype=q.dtype, device=q.device)
    alpha = q @ ((q.T @ (torque - gyro)) / inertia_body)
    acc = torch.as_tensor(force, dtype=q.dtype, device=q.device) / mass
    return acc, alpha


def rigid_body_position_verlet_step(state: RigidBodyState, dt, force, torque,
                                    mass, inertia_body) -> RigidBodyState:
    """One position-Verlet step of free rigid-body dynamics under constant
    global-frame loads (half kinematic, full dynamic, half kinematic, the
    splitting PyElastica's ``PositionVerlet`` applies). ``force`` and
    ``torque`` have shape (3,) or (3, 1)."""
    force = torch.as_tensor(force).reshape(3)
    torque = torch.as_tensor(torque).reshape(3)
    half = 0.5 * dt
    pos = state.position + half * state.velocity
    director = _rotate_matrix(state.director, state.omega, half)
    acc, alpha = rigid_body_acceleration(
        state._replace(position=pos, director=director), force, torque, mass,
        inertia_body,
    )
    vel = state.velocity + dt * acc
    omega = state.omega + dt * alpha
    pos = pos + half * vel
    director = _rotate_matrix(director, omega, half)
    return RigidBodyState(
        position=pos, velocity=vel, omega=omega, director=director
    )


class Cylinder:
    """2D circular cylinder (axis out of plane). ``density`` (per unit
    span) enables dynamics: ``mass = rho pi r^2``, axial inertia
    ``m r^2 / 2`` (in-plane entries the thin-disk values ``m r^2 / 4``)."""

    def __init__(self, center, radius, *, device, dtype=torch.float32,
                 density=None):
        self.radius = float(radius)
        self.state = RigidBodyState.create(
            np.asarray(center), device=device, dtype=dtype
        )
        self.density = density
        if density is not None:
            self.mass = float(density) * np.pi * self.radius**2
            i_axis = 0.5 * self.mass * self.radius**2
            self.inertia_body = np.array([0.5 * i_axis, 0.5 * i_axis, i_axis])

    n_elems = 1


class Sphere:
    """Rigid sphere. ``density`` enables dynamics: ``mass = rho 4/3 pi
    r^3``, isotropic inertia ``2/5 m r^2`` (PyElastica ``Sphere`` values)."""

    def __init__(self, center, radius, *, device, dtype=torch.float32,
                 density=None):
        self.radius = float(radius)
        self.state = RigidBodyState.create(
            np.asarray(center), device=device, dtype=dtype
        )
        self.density = density
        if density is not None:
            self.mass = float(density) * 4.0 / 3.0 * np.pi * self.radius**3
            self.inertia_body = np.full(3, 0.4 * self.mass * self.radius**2)

    n_elems = 1
