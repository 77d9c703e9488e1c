"""Rigid bodies (counterpart of ``sopht_mpi_tpu/models/rigid_body.py``;
the port covers the fixed sphere of the flow-past-sphere case)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RigidBodyState(NamedTuple):
    """Rigid body kinematic state: position/velocity/angular velocity in
    the global frame, shape (3,); ``director`` the body->global rotation
    matrix, shape (3, 3)."""

    position: torch.Tensor
    velocity: torch.Tensor
    omega: torch.Tensor
    director: torch.Tensor

    @staticmethod
    def create(position, velocity=None, omega=None, director=None, *,
               device="cpu", dtype=None):
        position = torch.as_tensor(position, dtype=dtype, device=device)
        dtype = position.dtype

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


class Sphere:
    """Fixed rigid sphere (the port does not step rigid-body dynamics yet,
    so it takes no ``density``)."""

    def __init__(self, center, radius, *, device, dtype=torch.float32):
        self.radius = float(radius)
        self.state = RigidBodyState.create(
            np.asarray(center), device=device, dtype=dtype
        )

    n_elems = 1
