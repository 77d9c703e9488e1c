"""SO(3) exp/log maps for director kinematics, batched over elements
(counterpart of ``sopht_mpi_tpu/models/elastica/rotations.py``).

Closed-form Rodrigues formulas with series fallbacks at theta -> 0.
``torch.where`` evaluates both branches, so the guarded ``theta_s`` keeps
the unused branch finite exactly as in the JAX package.

Conventions: a director collection ``Q`` has shape (3, 3, n); row ``i`` of
``Q[..., k]`` is the lab-frame direction of material axis ``d_i`` of
element ``k``, so ``Q u_lab -> u_material``.
"""

from __future__ import annotations

import torch

_SMALL = 1e-10


def _skew_apply(phi, u):
    """Batched cross product ``phi x u`` for (3, n) tensors."""
    return torch.stack(
        [
            phi[1] * u[2] - phi[2] * u[1],
            phi[2] * u[0] - phi[0] * u[2],
            phi[0] * u[1] - phi[1] * u[0],
        ]
    )


def exp_rotate(director_collection, rotation_vector):
    """Apply ``Q <- exp(-hat(phi)) Q`` per element: the exact integral of
    ``dQ/dt = -hat(omega_local) Q`` over a step with constant local angular
    velocity (``phi = omega_local * dt``).

    :param director_collection: (3, 3, n)
    :param rotation_vector: (3, n) material-frame rotation vector.
    """
    phi = rotation_vector
    theta2 = (phi * phi).sum(dim=0)  # (n,)
    theta = torch.sqrt(theta2)
    # sin(t)/t and (1-cos t)/t^2 with series fallbacks at t -> 0
    safe = theta > _SMALL
    theta_s = torch.where(safe, theta, 1.0)
    sinc = torch.where(safe, torch.sin(theta_s) / theta_s, 1.0 - theta2 / 6.0)
    cosc = torch.where(
        safe,
        (1.0 - torch.cos(theta_s)) / (theta_s * theta_s),
        0.5 - theta2 / 24.0,
    )

    # Q <- R Q with R = exp(-hat(phi)) = I - sinc*hat(phi) + cosc*hat(phi)^2;
    # the columns of Q transform as vectors
    def rot_col(c):
        pxc = _skew_apply(phi, c)
        pxpxc = _skew_apply(phi, pxc)
        return c - sinc * pxc + cosc * pxpxc

    return torch.stack(
        [rot_col(director_collection[:, j]) for j in range(3)], dim=1
    )


def log_rotation_vector(rot):
    """Rotation vector of a batch of rotation matrices, shape (3, 3, n) ->
    (3, n): ``rot = exp(hat(phi))``."""
    trace = rot[0, 0] + rot[1, 1] + rot[2, 2]
    cos_theta = torch.clip(0.5 * (trace - 1.0), -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    # skew part: rot - rot^T = 2 sin(theta) hat(u)
    v = torch.stack(
        [
            rot[2, 1] - rot[1, 2],
            rot[0, 2] - rot[2, 0],
            rot[1, 0] - rot[0, 1],
        ]
    )
    sin_theta = torch.sin(theta)
    safe = sin_theta > _SMALL
    scale = torch.where(
        safe,
        theta / torch.where(safe, 2.0 * sin_theta, 1.0),
        0.5 + theta * theta / 12.0,
    )
    return scale * v


def relative_rotation_vectors(director_collection):
    """Rotation vectors between consecutive element frames: ``phi_k`` with
    ``Q_{k+1} Q_k^T = exp(hat(phi_k))``, shape (3, n-1). The material-frame
    curvature is ``kappa = -phi / rest_voronoi_length`` (see rod.py)."""
    q_next = director_collection[..., 1:]  # (3, 3, n-1)
    q_prev = director_collection[..., :-1]
    rot = torch.einsum("ijn,kjn->ikn", q_next, q_prev)
    return log_rotation_vector(rot)
