"""Fused rigid-body FSI stepping (counterpart of ``build_rigid_fsi_step``
and its carry in ``sopht_mpi_tpu/models/fsi.py``).

One coupled iteration - CFL timestep control from the carried
``max |u|_1``, penalty IBM interaction with a fixed body, and the flow
step - is a pure function of a :class:`RigidFSICarry`; :func:`scan_steps`
rolls it out with a Python loop. Every scalar of the step (dt, time,
``max |u|_1``) stays a 0-d tensor on the device, so a run of steps queues
on the device without waiting for it.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple

import numpy as np
import torch

from sopht_mpi_tpu_torch.models.flow.simulator_3d import flow_step_3d
from sopht_mpi_tpu_torch.ops.ibm import (
    axis_delta_weight_matrices,
    eulerian_to_lagrangian_interpolation_mm,
    lagrangian_to_eulerian_spread_mm,
    nearest_grid_index_and_support,
)
from sopht_mpi_tpu_torch.ops.stencils_3d import curl_3d
from sopht_mpi_tpu_torch.ops.virtual_boundary import (
    compute_interaction_force_on_eul_and_lag_grid,
    compute_penalty_force,
    virtual_boundary_time_step,
)
from sopht_mpi_tpu_torch.utils.types import get_test_tol

logger = logging.getLogger("sopht_mpi_tpu_torch")


class RigidFSICarry(NamedTuple):
    flow_state: object
    vb_state: object
    velocity_mismatch: torch.Tensor  # from the previous step's interaction
    time: torch.Tensor
    # the Poisson solver's Fourier Green's function, threaded unchanged:
    # the dense spectrum, or the (bulk, side) pair of the kernel route
    greens: torch.Tensor | tuple = None
    # max |u|_1 of flow_state.velocity_field, carried so the CFL dt needs
    # no fresh velocity read (on the kernel path the curl kernel reduces it)
    velocity_l1_max: torch.Tensor = None
    # sparse-window path: per-axis delta weight matrices (Az, Ay, Ax), each
    # (n_markers, W_axis), threaded unchanged through every step
    ibm_mats: tuple = None


def velocity_l1_max(velocity_field):
    """The CFL control quantity ``max(sum_c |u_c|)``."""
    return velocity_field.abs().sum(dim=0).max()


def _flow_dt_fn(flow_sim, dt_prefac):
    """dt from the carried ``max |u|_1`` - the arithmetic of
    ``compute_stable_timestep_3d`` on the same reduction."""
    CFL = flow_sim.CFL
    dx = flow_sim.dx
    nu = flow_sim.kinematic_viscosity
    tol = get_test_tol("single")
    dim = flow_sim.grid_dim
    real_t = flow_sim.real_t

    def flow_dt(l1_max):
        num = torch.full((), CFL * dx, dtype=l1_max.dtype, device=l1_max.device)
        dt_advection = num / (l1_max + tol)
        dt_diffusion = 0.9 * dx**2 / (2 * dim) / (nu + tol)
        return torch.clamp(dt_advection, max=dt_diffusion).to(real_t) * dt_prefac

    return flow_dt


def _flow_step_l1(flow_sim, flow_type=None):
    """``(state, dt, free_stream, greens) -> (state, max |u|_1)``."""
    cfg = flow_sim.step_config(flow_type)

    def step(state, dt, free_stream_velocity, greens):
        return flow_step_3d(
            state, dt, free_stream_velocity, poisson_greens=greens,
            return_velocity_l1_max=True, **cfg,
        )

    return step


def _free_stream(free_stream_fn, flow_sim):
    """``time -> (3,) free-stream tensor`` on the simulator's device."""
    dtype, device = flow_sim.real_t, flow_sim.device
    if free_stream_fn is None:
        zero = torch.zeros(flow_sim.grid_dim, dtype=dtype, device=device)
        return lambda time: zero
    return lambda time: torch.as_tensor(
        free_stream_fn(time), dtype=dtype, device=device
    )


def _static_rigid_forcing_window(lag_pos, params, grid_size):
    """Static ``(z0, z1, y0, y1, x0, x1)`` window covering the delta
    support of FIXED markers plus the forcing-curl reach, or None when the
    sparse path would not pay (window covering most of the domain) or
    would change boundary semantics (support + margin touching a wall).
    ``pad = 2``: curl support is delta-support +- 1, and the window's own
    curl ring zeroing then only ever touches cells whose curl is zero."""
    w = params.interp_kernel_width
    pos = lag_pos.detach().cpu().numpy()
    nearest = np.floor(
        (pos - params.eul_grid_coord_shift) / params.dx
    ).astype(int)
    lo = nearest.min(axis=1) - (w - 1)
    hi = nearest.max(axis=1) + w
    pad = 2
    nz, ny, nx = (int(s) for s in grid_size)
    # marker components ordered (x, y, z); grid axes (z, y, x)
    x0, x1 = int(lo[0] - pad), int(hi[0] + pad + 1)
    y0, y1 = int(lo[1] - pad), int(hi[1] + pad + 1)
    z0, z1 = int(lo[2] - pad), int(hi[2] + pad + 1)
    if x0 < 0 or y0 < 0 or z0 < 0 or x1 > nx or y1 > ny or z1 > nz:
        return None  # wall-adjacent support: keep the dense path's clipping
    if (z1 - z0) * (y1 - y0) * (x1 - x0) >= 0.5 * nz * ny * nx:
        return None
    return z0, z1, y0, y1, x0, x1


def build_rigid_fsi_step(
    flow_sim,
    interactor,
    dt_prefac=0.5,
    free_stream_fn: Callable | None = None,
    sparse_forcing: bool | None = None,
):
    """One fused coupled step for a fixed rigid body.

    :param free_stream_fn: optional ``time -> (3,) velocity``; defaults to
        the zero vector. Return a tensor on the simulator's device to keep
        the step free of host-to-device copies.
    :param sparse_forcing: apply the IBM forcing as a static sparse-window
        vorticity update (spread + curl on the support window only, flow
        stepped without the full-field forcing pass). None = auto (an
        interior window that covers less than half the domain). When it
        engages, the step has ``uses_sparse_forcing = True``, ``window``
        and ``ibm_mats``; build the carry with
        ``init_rigid_fsi_carry(flow_sim, interactor, step)``.
    :returns: ``step(carry) -> (carry, lag_force_sum)``, the diagnostics
        being the summed Lagrangian forcing (for drag).
    """
    params = interactor.params
    lag_pos = interactor.forcing_grid.compute_lag_grid_position_field()
    lag_vel = interactor.forcing_grid.compute_lag_grid_velocity_field()
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    free_stream = _free_stream(free_stream_fn, flow_sim)

    window = None
    if (
        sparse_forcing is not False
        and flow_sim.flow_type == "navier_stokes_with_forcing"
    ):
        window = _static_rigid_forcing_window(
            lag_pos, params, flow_sim.grid_size
        )
    if sparse_forcing is True and window is None:
        raise ValueError(
            "sparse_forcing=True requested but unsupported here (needs "
            "navier_stokes_with_forcing and an interior window)"
        )
    if window is not None:
        logger.info(
            "build_rigid_fsi_step: sparse-window IBM forcing engaged "
            f"(window z{window[0]}:{window[1]} y{window[2]}:{window[3]} "
            f"x{window[4]}:{window[5]})"
        )
        return _build_rigid_fsi_step_sparse(
            flow_sim, interactor, window, lag_pos, lag_vel, flow_dt,
            free_stream,
        )

    flow_step_l1 = _flow_step_l1(flow_sim)

    def step(carry: RigidFSICarry):
        """Integrate the mismatch with the PREVIOUS interaction's velocity
        mismatch, then compute the new interaction, then step the flow."""
        flow_state, vb_state, prev_mismatch, time, greens, u_l1, _ = carry
        dt = flow_dt(u_l1)
        vb_state = virtual_boundary_time_step(vb_state, prev_mismatch, dt)
        eul_forcing, interaction = compute_interaction_force_on_eul_and_lag_grid(
            vb_state,
            flow_state.eul_grid_forcing_field,
            flow_state.velocity_field,
            lag_pos,
            lag_vel,
            params,
            reset_eul_grid_forcing_field=True,
        )
        flow_state = flow_state._replace(eul_grid_forcing_field=eul_forcing)
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, free_stream(time), greens
        )
        lag_force_sum = interaction.lag_forcing.sum(dim=1)
        new_carry = RigidFSICarry(
            flow_state, vb_state, interaction.velocity_mismatch, time + dt,
            greens, new_l1,
        )
        return new_carry, lag_force_sum

    step.uses_sparse_forcing = False
    return step


def _build_rigid_fsi_step_sparse(
    flow_sim, interactor, window, lag_pos, lag_vel, flow_dt, free_stream
):
    """Sparse-window variant of the rigid FSI step: the IBM spread and the
    forcing curl act on the static support window only, and the flow
    advances through the no-forcing step (the forcing curl commutes into a
    windowed vorticity add; forcing is zero outside the window by
    construction). Both transfer directions run on the separable-matmul
    path (``axis_delta_weight_matrices`` + ``*_mm``); for fixed markers
    the per-axis weight matrices are built once here and ride in the
    carry."""
    params = interactor.params
    flow_step_l1 = _flow_step_l1(flow_sim, "navier_stokes")
    z0, z1, y0, y1, x0, x1 = window
    dx = params.dx
    wshape = (z1 - z0, y1 - y0, x1 - x0)
    win_slice = (slice(None), slice(z0, z1), slice(y0, y1), slice(x0, x1))

    _, support_idx, support_disp = nearest_grid_index_and_support(
        lag_pos, dx, params.eul_grid_coord_shift, params.interp_kernel_width
    )
    start = torch.tensor(
        [x0, y0, z0], dtype=support_idx.dtype, device=support_idx.device
    )
    ibm_mats = axis_delta_weight_matrices(
        support_idx - start.reshape(3, 1, 1), support_disp, dx, wshape,
        params.delta_kind,
    )

    def step(carry: RigidFSICarry):
        flow_state, vb_state, prev_mismatch, time, greens, u_l1, mats = carry
        if mats is None:
            raise ValueError(
                "sparse rigid FSI step needs the mm weight matrices in the "
                "carry - build the carry with init_rigid_fsi_carry("
                "flow_sim, interactor, step) passing THIS step"
            )
        dt = flow_dt(u_l1)
        vb_state = virtual_boundary_time_step(vb_state, prev_mismatch, dt)
        flow_velocity = eulerian_to_lagrangian_interpolation_mm(
            flow_state.velocity_field[win_slice], mats, dx
        )
        velocity_mismatch = flow_velocity - lag_vel
        lag_forcing = compute_penalty_force(
            vb_state.position_mismatch, velocity_mismatch, params
        )
        # L->E spread into the window, curl, and one windowed vorticity add
        field = flow_state.primary_field
        win = torch.zeros((3,) + wshape, dtype=field.dtype, device=field.device)
        win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
        curl_win = curl_3d(win, dt / (2.0 * dx))
        # the carry stays pure: the add goes into a copy of the vorticity
        field = field.clone()
        field[win_slice] += curl_win
        flow_state = flow_state._replace(primary_field=field)
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, free_stream(time), greens
        )
        lag_force_sum = lag_forcing.sum(dim=1)
        new_carry = RigidFSICarry(
            flow_state, vb_state, velocity_mismatch, time + dt,
            greens, new_l1, mats,
        )
        return new_carry, lag_force_sum

    step.uses_sparse_forcing = True
    step.window = window
    step.ibm_mats = ibm_mats
    return step


def init_rigid_fsi_carry(flow_sim, interactor, step=None) -> RigidFSICarry:
    """Initial carry matching a fresh interactor (zero mismatch).

    Pass the built ``step``: the sparse-forcing step then gets its weight
    matrices, and the never-read full-field forcing leaf shrinks to a
    zero-size placeholder."""
    flow_state = flow_sim._get_state()
    forcing = flow_state.eul_grid_forcing_field
    if getattr(step, "uses_sparse_forcing", False):
        flow_state = flow_state._replace(
            eul_grid_forcing_field=forcing.new_zeros(
                (forcing.shape[0],) + (0,) * (forcing.ndim - 1)
            )
        )
    return RigidFSICarry(
        flow_state=flow_state,
        vb_state=interactor.state,
        velocity_mismatch=torch.zeros_like(interactor.state.position_mismatch),
        time=torch.tensor(
            flow_sim.time, dtype=flow_sim.real_t, device=flow_sim.device
        ),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=velocity_l1_max(flow_sim.velocity_field),
        ibm_mats=getattr(step, "ibm_mats", None),
    )


def scan_steps(step_fn, carry, n_steps: int):
    """Roll ``n_steps`` coupled steps; returns (final carry, per-step
    diagnostics stacked on a leading axis). Nothing waits for the device."""
    diags = []
    for _ in range(n_steps):
        carry, diag = step_fn(carry)
        diags.append(diag)
    return carry, torch.stack(diags)
