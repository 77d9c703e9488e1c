"""Fused FSI stepping (counterpart of ``sopht_mpi_tpu/models/fsi.py``):
the rigid-body step :func:`build_rigid_fsi_step` (on a 2D or a 3D
simulator) and the Cosserat-rod step :func:`build_rod_fsi_step`, with
their carries.

One coupled iteration - CFL timestep control from the carried
``max |u|_1``, the penalty IBM interaction, the rod substeps (rod step
only) and the flow step - is a pure function of the carry;
:func:`scan_steps` rolls it out with a Python loop. Every scalar of the
step (dt, time, ``max |u|_1``) stays a 0-d tensor on the device. The rigid
step never waits for the device; the rod step with dynamic substeps reads
its substep count once per step (see :func:`build_rod_fsi_step`).

On a 3D simulator's in-process mesh the flow state is sharded and the
steps take the JAX package's mesh branches: the flow step is the sharded
one; the sparse-window paths touch the grid only through
:mod:`sopht_mpi_tpu_torch.parallel.windows` (the E->L a shard-local
contraction and one ``psum`` of the (3, n_markers) result, the windowed
vorticity add collective-free), the marker math replicated; the dense
interpolation and spreading run on the assembled fields
(``apply_assembled``, counted), as the JAX package leaves them to its
partitioner.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from sopht_mpi_tpu_torch.models.flow.simulator_3d import (
    flow_step_3d,
    velocity_l1_max_3d,
)
from sopht_mpi_tpu_torch.ops.ibm import (
    axis_delta_weight_matrices,
    eulerian_to_lagrangian_interpolation_mm,
    lagrangian_to_eulerian_spread_mm,
    nearest_grid_index_and_support,
)
from sopht_mpi_tpu_torch.ops.stencils_3d import curl_3d
from sopht_mpi_tpu_torch.ops.virtual_boundary import (
    compute_interaction_force_on_eul_and_lag_grid,
    compute_interaction_force_on_lag_grid,
    compute_penalty_force,
    virtual_boundary_time_step,
)
from sopht_mpi_tpu_torch.parallel.mesh import shard_vector_field
from sopht_mpi_tpu_torch.parallel.windows import (
    add_window_into_field,
    windowed_e2l_mm_sharded,
)
from sopht_mpi_tpu_torch.utils.logging_utils import logger
from sopht_mpi_tpu_torch.utils.types import get_test_tol

# substep_interp="auto" crossover of the JAX package (its fsi.py): the
# substeps' E->L takes the full-field gather instead of the windowed
# matmul once the sparse window holds this many cells
_GATHER_SUBSTEP_WINDOW_CELLS = 3_000_000


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


class RodFSICarry(NamedTuple):
    flow_state: object
    vb_state: object
    rod_state: object
    time: torch.Tensor
    greens: torch.Tensor | tuple = None  # see RigidFSICarry.greens
    velocity_l1_max: torch.Tensor = None  # see RigidFSICarry
    # substep_load_refresh="flow_step": (forces, torques, velocity_mismatch)
    # of the last full interaction, applied frozen through the next step's
    # substeps; None with the default per-substep refresh
    frozen_loads: tuple | None = None


def velocity_l1_max(velocity_field):
    """The CFL control quantity ``max(sum_c |u_c|)``."""
    return velocity_field.abs().sum(dim=0).max()


def _carry_l1_max(flow_sim):
    """``max |u|_1`` of the simulator's velocity for a fresh carry (over
    the mesh on a sharded 3D simulator)."""
    if flow_sim.grid_dim == 3:
        return velocity_l1_max_3d(flow_sim.velocity_field, flow_sim.mesh)
    return velocity_l1_max(flow_sim.velocity_field)


def _without_forcing_field(flow_sim, flow_state):
    """``flow_state`` with its never-read full-field forcing leaf shrunk to
    a zero-size placeholder, (3, 0, 0, 0) in the simulator's layout."""
    forcing = flow_state.eul_grid_forcing_field
    placeholder = forcing.new_zeros(
        (flow_sim.grid_dim,) + (0,) * flow_sim.grid_dim)
    if getattr(flow_sim, "mesh", None) is not None:
        placeholder = shard_vector_field(placeholder, flow_sim.mesh)
    return flow_state._replace(eul_grid_forcing_field=placeholder)


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
    if flow_sim.grid_dim == 2:
        return flow_sim._step_l1_fn
    cfg = flow_sim.step_config(flow_type)

    def step(state, dt, free_stream_velocity, greens):
        return flow_step_3d(
            state, dt, free_stream_velocity, poisson_greens=greens,
            return_velocity_l1_max=True, **cfg,
        )

    return step


def _free_stream(free_stream_fn, flow_sim):
    """``time -> (grid_dim,) free-stream tensor`` on the simulator's
    device."""
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

    :param free_stream_fn: optional ``time -> (grid_dim,) velocity``;
        defaults to the zero vector. Return a tensor on the simulator's device to keep
        the step free of host-to-device copies.
    :param sparse_forcing: apply the IBM forcing as a static sparse-window
        vorticity update (spread + curl on the support window only, flow
        stepped without the full-field forcing pass), 3D only. None = auto
        (3D with an interior window that covers less than half the domain;
        a 2D simulator always takes the dense path). When it
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
        and flow_sim.grid_dim == 3
        and flow_sim.flow_type == "navier_stokes_with_forcing"
    ):
        window = _static_rigid_forcing_window(
            lag_pos, params, flow_sim.grid_size
        )
    if sparse_forcing is True and window is None:
        raise ValueError(
            "sparse_forcing=True requested but unsupported here (needs 3D "
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
    mesh = getattr(flow_sim, "mesh", None)

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
            mesh=mesh,
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
    carry. On a mesh the E->L and the add go through
    :mod:`sopht_mpi_tpu_torch.parallel.windows`."""
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
    mesh = flow_sim.mesh
    if mesh is not None:
        def e2l(velocity_field, mats):
            return windowed_e2l_mm_sharded(
                velocity_field, mats, start, wshape, dx, mesh)

        def windowed_add(field, curl_win):
            return add_window_into_field(field, curl_win, start, mesh)
    else:
        def e2l(velocity_field, mats):
            return eulerian_to_lagrangian_interpolation_mm(
                velocity_field[win_slice], mats, dx)

        def windowed_add(field, curl_win):
            # the carry stays pure: the add goes into a copy of the vorticity
            field = field.clone()
            field[win_slice] += curl_win
            return field

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
        flow_velocity = e2l(flow_state.velocity_field, mats)
        velocity_mismatch = flow_velocity - lag_vel
        lag_forcing = compute_penalty_force(
            vb_state.position_mismatch, velocity_mismatch, params
        )
        # L->E spread into the window, curl, and one windowed vorticity add
        field = flow_state.primary_field
        win = torch.zeros((3,) + wshape, dtype=field.dtype, device=field.device)
        win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
        curl_win = curl_3d(win, dt / (2.0 * dx))
        flow_state = flow_state._replace(
            primary_field=windowed_add(field, curl_win))
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
    if getattr(step, "uses_sparse_forcing", False):
        flow_state = _without_forcing_field(flow_sim, flow_state)
    return RigidFSICarry(
        flow_state=flow_state,
        vb_state=interactor.state,
        velocity_mismatch=torch.zeros_like(interactor.state.position_mismatch),
        time=torch.tensor(
            flow_sim.time, dtype=flow_sim.real_t, device=flow_sim.device
        ),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=_carry_l1_max(flow_sim),
        ibm_mats=getattr(step, "ibm_mats", None),
    )


def _sparse_window_tools(flow_sim, params, wshape):
    """The moving-window machinery of the sparse rod path, for a static
    ``(Wz, Wy, Wx)`` window tracking a body's marker support:

    - ``window_mats(lagp) -> (start, axis_mats, ok)``: the window start
      (components x, y, z; a device tensor), the per-axis matmul weight
      matrices in window coordinates, and the validity flag (support >= 2
      cells inside the window per side, or the window flush with the
      domain wall there, so the clipping matches the dense path's);
    - ``e2l_interp(field, start, mats)``: the separable-matmul E->L
      interpolation of a grid vector field over the window;
    - ``windowed_add(field, win, start)``: a copy of ``field`` with ``win``
      added into the window.

    The JAX package slices with ``dynamic_slice`` at the device start; here
    the window is a gather (and its add an ``index_put_``) at index tensors
    built on the device from the start, so nothing reads it on the host. On
    a mesh both go through :mod:`sopht_mpi_tpu_torch.parallel.windows`: a
    shard-local contraction and one ``psum`` of the (3, n_markers) result,
    and a collective-free add.
    """
    Wz, Wy, Wx = (int(w) for w in wshape)
    nz, ny, nx = flow_sim.grid_size
    if Wz > nz or Wy > ny or Wx > nx:
        raise ValueError(
            f"sparse forcing window {wshape} exceeds the grid "
            f"{flow_sim.grid_size}"
        )
    device = flow_sim.device
    n_xyz = torch.tensor([nx, ny, nz], dtype=torch.int32, device=device)
    w_xyz = torch.tensor([Wx, Wy, Wz], dtype=torch.int32, device=device)
    zero = torch.zeros(3, dtype=torch.int32, device=device)
    ranges = [torch.arange(w, device=device) for w in (Wz, Wy, Wx)]

    def window_mats(lagp):
        _, support_idx, support_disp = nearest_grid_index_and_support(
            lagp, params.dx, params.eul_grid_coord_shift,
            params.interp_kernel_width,
        )
        mins = support_idx.amin(dim=(1, 2))  # (3,) components x, y, z
        maxs = support_idx.amax(dim=(1, 2))
        start = torch.clamp(mins - 2, min=zero, max=n_xyz - w_xyz)
        lo_ok = (start == 0) | (mins - start >= 2)
        hi_ok = (start + w_xyz == n_xyz) | (maxs - start <= w_xyz - 3)
        ok = (lo_ok & hi_ok).all()
        shifted = support_idx - start[:, None, None]
        mats = axis_delta_weight_matrices(
            shifted, support_disp, params.dx, (Wz, Wy, Wx), params.delta_kind
        )
        return start, mats, ok

    mesh = flow_sim.mesh
    if mesh is not None:
        def e2l_interp(field, start, mats):
            return windowed_e2l_mm_sharded(
                field, mats, start, (Wz, Wy, Wx), params.dx, mesh)

        def windowed_add(field, win, start):
            return add_window_into_field(field, win, start, mesh)

        return window_mats, e2l_interp, windowed_add

    def window_index(start):
        z = (start[2] + ranges[0])[:, None, None]
        y = (start[1] + ranges[1])[None, :, None]
        x = (start[0] + ranges[2])[None, None, :]
        return slice(None), z, y, x

    def e2l_interp(field, start, mats):
        return eulerian_to_lagrangian_interpolation_mm(
            field[window_index(start)], mats, params.dx
        )

    def windowed_add(field, win, start):
        idx = window_index(start)
        field = field.clone()
        field[idx] = field[idx] + win
        return field

    return window_mats, e2l_interp, windowed_add


def build_rod_fsi_step(
    flow_sim,
    interactor,
    rod_collection,
    rod_substeps: int | None = None,
    dt_prefac=0.5,
    free_stream_fn: Callable | None = None,
    *,
    rod_dt: float | None = None,
    max_rod_substeps: int | None = None,
    sparse_forcing_window: tuple[int, int, int] | None = None,
    substep_load_refresh: str = "every",
    substep_interp: str = "auto",
):
    """One fused coupled step for a two-way coupled Cosserat rod: per flow
    step the rod takes position-Verlet substeps, then the full penalty
    interaction runs, the Lagrangian forcing is spread onto the Eulerian
    forcing field (or its windowed curl adds straight into the vorticity on
    the sparse path) and the flow advances.

    ``substep_load_refresh``: ``"every"`` (default, the reference's
    semantics) recomputes the penalty flow loads at each substep from the
    frozen flow velocity; ``"flow_step"`` (an approximation) applies the
    loads of the last full interaction, frozen (build the carry with
    ``init_rod_fsi_carry(..., step=step)``).

    Substeps: static (``rod_substeps=k``, exactly ``k`` per flow step) or
    dynamic (``rod_dt``): the reference's count
    ``clip(floor(dt / min(dt, rod_dt)), 1, max_rod_substeps)``, in the flow
    dtype. The JAX package runs a scan of ``max_rod_substeps`` iterations
    and masks the inactive ones; here the count is read on the host once per
    flow step (the step's only host sync) and exactly that many substeps
    run. ``max_rod_substeps`` defaults to
    ``ceil(flow_sim.diffusion_limited_timestep(dt_prefac) / rod_dt) + 2``,
    a bound the count can never reach, as in the JAX package.

    On a simulator's mesh the sparse path runs on the sharded field through
    :mod:`sopht_mpi_tpu_torch.parallel.windows`, and the dense loads and
    spreading on the assembled fields (see the module's docstring).

    ``sparse_forcing_window`` (3D ``navier_stokes_with_forcing``): static
    ``(Wz, Wy, Wx)`` cell counts of a moving window tracking the marker
    support (see :func:`suggest_rod_forcing_window`); the IBM spread and
    the forcing curl act on the window and the flow advances through the
    no-forcing step. The diagnostic is then ``(lag_force_sum, window_ok)``,
    ``window_ok`` a device bool that is False on a step whose support did
    not fit the window.

    ``substep_interp`` (sparse path only) picks the substeps' E->L:
    ``"window_mm"`` (the windowed separable matmul), ``"gather"`` (the
    full-field support gather; refused on a mesh, as in the JAX package),
    ``"auto"`` (gather from ``_GATHER_SUBSTEP_WINDOW_CELLS`` window cells,
    and always the matmul on a mesh). The JAX package ignores a non-default
    value without a sparse window; the port raises.

    The rod must be the only system in ``rod_collection``, already
    finalized, with the ``FlowForces`` coupling not registered.

    The returned step carries ``stats``, host-side counts of the steps,
    substeps and host reads it made.
    """
    if substep_interp not in ("auto", "window_mm", "gather"):
        raise ValueError(
            "substep_interp must be 'auto', 'window_mm' or 'gather', got "
            f"{substep_interp!r}"
        )
    if substep_load_refresh not in ("every", "flow_step"):
        raise ValueError(
            "substep_load_refresh must be 'every' or 'flow_step', got "
            f"{substep_load_refresh!r}"
        )
    frozen_mode = substep_load_refresh == "flow_step"
    dynamic = rod_substeps is None
    if dynamic and rod_dt is None:
        raise ValueError(
            "pass either rod_substeps (static) or rod_dt (dynamic)"
        )
    if not dynamic and (rod_dt is not None or max_rod_substeps is not None):
        raise ValueError(
            "rod_substeps (static mode) conflicts with rod_dt/"
            "max_rod_substeps (dynamic mode) - pass one or the other"
        )
    sparse = sparse_forcing_window is not None
    if substep_interp != "auto" and not sparse:
        raise ValueError(
            f"substep_interp={substep_interp!r} picks the sparse window's "
            "substep interpolation and needs sparse_forcing_window"
        )
    if dynamic and max_rod_substeps is None:
        max_rod_substeps = (
            math.ceil(flow_sim.diffusion_limited_timestep(dt_prefac) / rod_dt)
            + 2
        )
    assert rod_collection._finalized
    assert len(rod_collection._systems) == 1
    rod_step = rod_collection._step_fns[0]
    grid = interactor.forcing_grid
    params = interactor.params
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    free_stream = _free_stream(free_stream_fn, flow_sim)
    real_t = flow_sim.real_t
    mesh = getattr(flow_sim, "mesh", None)

    if sparse:
        if flow_sim.flow_type != "navier_stokes_with_forcing":
            raise ValueError(
                "sparse_forcing_window needs a navier_stokes_with_forcing "
                "simulator"
            )
        Wz, Wy, Wx = (int(w) for w in sparse_forcing_window)
        flow_step_l1 = _flow_step_l1(flow_sim, "navier_stokes")
        _refuse_gather_on_a_mesh(flow_sim, substep_interp)
        gather_substeps = substep_interp == "gather" or (
            substep_interp == "auto"
            and mesh is None
            and Wz * Wy * Wx >= _GATHER_SUBSTEP_WINDOW_CELLS
        )
        window_mats, e2l_interp, windowed_add = _sparse_window_tools(
            flow_sim, params, (Wz, Wy, Wx)
        )
    else:
        flow_step_l1 = _flow_step_l1(flow_sim)
        gather_substeps = False

    def rod_flow_loads(rod_state, vb_state, velocity_field):
        interaction = compute_interaction_force_on_lag_grid(
            vb_state,
            velocity_field,
            grid.lag_positions(rod_state),
            grid.lag_velocities(rod_state),
            params,
            mesh=mesh,
        )
        forces, torques = grid.body_loads(rod_state, interaction.lag_forcing)
        return forces, torques, interaction.velocity_mismatch

    def rod_flow_loads_windowed(rod_state, vb_state, velocity_field):
        """The loads of rod_flow_loads, the E->L reading only the moving
        support window through the separable matmul."""
        start, mats, ok = window_mats(grid.lag_positions(rod_state))
        flow_velocity = e2l_interp(velocity_field, start, mats)
        mismatch = flow_velocity - grid.lag_velocities(rod_state)
        lag_forcing = compute_penalty_force(
            vb_state.position_mismatch, mismatch, params
        )
        forces, torques = grid.body_loads(rod_state, lag_forcing)
        return forces, torques, mismatch, ok

    stats = {"steps": 0, "substeps": 0, "host_syncs": 0}

    def substep_count(dt):
        if not dynamic:
            return rod_substeps
        # reference: int(dt / min(dt, rod_dt)), >= 1, in the flow dtype
        n_raw = torch.floor(dt / torch.clamp(dt, max=rod_dt))
        stats["host_syncs"] += 1
        return int(min(max(int(n_raw.item()), 1), max_rod_substeps))

    def step(carry: RodFSICarry):
        (flow_state, vb_state, rod_state, time, greens, u_l1,
         frozen) = carry
        if frozen_mode and frozen is None:
            raise ValueError(
                "substep_load_refresh='flow_step' needs the frozen-loads "
                "carry leaves - build the carry with init_rod_fsi_carry("
                "flow_sim, interactor, rod, step) passing THIS step"
            )
        dt = flow_dt(u_l1)
        n_sub = substep_count(dt)
        sub_dt = dt / n_sub
        rod_t = rod_state.position.dtype
        velocity_field = flow_state.velocity_field
        t = time
        substeps_ok = torch.ones((), dtype=torch.bool, device=time.device)
        for _ in range(n_sub):
            if frozen_mode:
                forces, torques, mismatch = frozen
            elif sparse and not gather_substeps:
                forces, torques, mismatch, sub_ok = rod_flow_loads_windowed(
                    rod_state, vb_state, velocity_field
                )
                substeps_ok = substeps_ok & sub_ok
            else:
                forces, torques, mismatch = rod_flow_loads(
                    rod_state, vb_state, velocity_field
                )
            rod_state = rod_step(
                rod_state, t.to(rod_t), sub_dt.to(rod_t),
                forces.to(rod_t), torques.to(rod_t),
            )
            vb_state = virtual_boundary_time_step(vb_state, mismatch, sub_dt)
            t = t + sub_dt
        stats["steps"] += 1
        stats["substeps"] += n_sub

        lagp = grid.lag_positions(rod_state)
        if sparse:
            # the windowed interaction at the post-substep state
            start, mats, window_ok = window_mats(lagp)
            window_ok = window_ok & substeps_ok
            flow_velocity = e2l_interp(velocity_field, start, mats)
            velocity_mismatch = flow_velocity - grid.lag_velocities(rod_state)
            lag_forcing = compute_penalty_force(
                vb_state.position_mismatch, velocity_mismatch, params
            )
            if frozen_mode:
                frozen = (*grid.body_loads(rod_state, lag_forcing),
                          velocity_mismatch)
            win = torch.zeros((3, Wz, Wy, Wx), dtype=real_t,
                              device=velocity_field.device)
            win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
            curl_win = curl_3d(win, dt / (2.0 * params.dx))
            flow_state = flow_state._replace(
                primary_field=windowed_add(
                    flow_state.primary_field, curl_win, start
                )
            )
        else:
            eul_forcing, interaction = compute_interaction_force_on_eul_and_lag_grid(
                vb_state,
                flow_state.eul_grid_forcing_field,
                velocity_field,
                lagp,
                grid.lag_velocities(rod_state),
                params,
                reset_eul_grid_forcing_field=True,
                mesh=mesh,
            )
            lag_forcing = interaction.lag_forcing
            if frozen_mode:
                frozen = (*grid.body_loads(rod_state, lag_forcing),
                          interaction.velocity_mismatch)
            flow_state = flow_state._replace(eul_grid_forcing_field=eul_forcing)
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, free_stream(time), greens
        )
        lag_force_sum = lag_forcing.sum(dim=1)
        new_carry = RodFSICarry(
            flow_state, vb_state, rod_state, time + dt, greens, new_l1,
            frozen if frozen_mode else None,
        )
        return new_carry, (lag_force_sum, window_ok) if sparse else lag_force_sum

    step.uses_frozen_loads = frozen_mode
    step.sparse_forcing_window = (Wz, Wy, Wx) if sparse else None
    step.gather_substeps = gather_substeps
    step.stats = stats
    return step


def _refuse_gather_on_a_mesh(flow_sim, substep_interp):
    if (substep_interp == "gather"
            and getattr(flow_sim, "mesh", None) is not None):
        raise ValueError(
            "substep_interp='gather' needs an unsharded simulator (it "
            "would gather the sharded velocity field at every substep); use "
            "'window_mm' or 'auto' under a mesh"
        )


def suggest_rod_forcing_window(
    interactor, rod, grid_size, margin=1.1, max_grid_fraction=0.7
):
    """Static ``(Wz, Wy, Wx)`` window cells for
    ``build_rod_fsi_step(sparse_forcing_window=...)``, sized from the
    rod's reachable envelope: an (almost) inextensible rod of length L and
    radius r always fits a per-axis box of ``L + 2r``, so the window (that
    envelope times ``margin``, plus the delta-support and curl margins)
    covers the marker support for the whole run. None when the window
    would exceed ``max_grid_fraction`` of the grid (the dense path is then
    the better choice)."""
    params = interactor.params
    lengths = rod.params.rest_lengths.cpu().numpy()
    radius = float(rod.params.radius.max())
    reach = float(lengths.sum()) + 2.0 * radius
    cells = int(np.ceil(margin * reach / params.dx))
    w = cells + 2 * params.interp_kernel_width + 6
    nz, ny, nx = (int(v) for v in grid_size)
    win = (min(w, nz), min(w, ny), min(w, nx))
    if np.prod(win) > max_grid_fraction * nz * ny * nx:
        return None
    return win


def init_rod_fsi_carry(flow_sim, interactor, rod, step=None) -> RodFSICarry:
    """Initial carry for :func:`build_rod_fsi_step`. Pass the built
    ``step`` when it uses ``substep_load_refresh='flow_step'``: the carry
    then gains zero frozen-loads leaves (forces (3, n+1), torques (3, n),
    mismatch (3, markers)) in the marker dtype, the promotion of the flow's
    and the rod's."""
    frozen = None
    if getattr(step, "uses_frozen_loads", False):
        dtype = torch.promote_types(flow_sim.real_t, rod.state.position.dtype)
        n = rod.n_elems
        zeros = lambda *shape: torch.zeros(
            shape, dtype=dtype, device=flow_sim.device
        )
        frozen = (
            zeros(3, n + 1), zeros(3, n),
            zeros(3, interactor.forcing_grid.num_lag_nodes),
        )
    return RodFSICarry(
        flow_state=flow_sim._get_state(),
        vb_state=interactor.state,
        rod_state=rod.state,
        time=torch.tensor(
            flow_sim.time, dtype=flow_sim.real_t, device=flow_sim.device
        ),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=_carry_l1_max(flow_sim),
        frozen_loads=frozen,
    )


class RodBody(NamedTuple):
    """Multi-body spec: a two-way coupled Cosserat rod. ``rod_collection``
    is finalized and holds exactly this rod (one collection per rod), with
    the ``FlowForces`` coupling not registered."""

    interactor: object  # CosseratRodFlowInteraction
    rod_collection: object  # BaseSystemCollection with one finalized rod


class DynamicRigidBody(NamedTuple):
    """Multi-body spec: a two-way coupled rigid body with dynamics; the
    body carries ``mass`` and ``inertia_body`` (built with a ``density``).
    ``load_fn(state, time) -> (force (3,), torque (3,))`` adds user loads
    on top of the flow loads."""

    interactor: object  # RigidBodyFlowInteraction
    rigid_body: object
    load_fn: Callable | None = None


class FixedRigidBody(NamedTuple):
    """Multi-body spec: a fixed rigid body; its markers are constants."""

    interactor: object  # RigidBodyFlowInteraction


class MultiBodyFSICarry(NamedTuple):
    flow_state: object
    body_states: tuple  # per body: rod state | RigidBodyState | None (fixed)
    vb_states: tuple  # per body VirtualBoundaryState
    prev_mismatches: tuple  # per body; read by the FixedRigidBody entries
    time: torch.Tensor
    greens: torch.Tensor | tuple = None  # see RigidFSICarry.greens
    velocity_l1_max: torch.Tensor = None  # see RigidFSICarry
    # substep_load_refresh="flow_step": per body (forces, torques, mismatch)
    # of the last full interaction (None for fixed bodies); None otherwise
    frozen_loads: tuple | None = None


def build_multi_body_fsi_step(
    flow_sim,
    bodies,
    dt_prefac=0.5,
    free_stream_fn: Callable | None = None,
    substeps: int | None = None,
    *,
    sub_dt: float | None = None,
    max_substeps: int | None = None,
    sparse_forcing: bool | None = None,
    substep_load_refresh: str = "every",
    substep_interp: str = "auto",
):
    """One fused coupled step for any mix of Cosserat rods
    (:class:`RodBody`), dynamic rigid bodies (:class:`DynamicRigidBody`) and
    fixed rigid bodies (:class:`FixedRigidBody`), the reference's stacked
    interactors accumulating onto one forcing field before the flow step:

    - all substepped bodies (rods and dynamic rigid bodies) take the same
      ``n_sub`` substeps a flow step; each substep computes the body's
      penalty flow loads from the frozen flow velocity, advances the body
      (position Verlet) and integrates its IBM position mismatch;
    - fixed bodies integrate their mismatch once a flow step with the
      previous interaction's velocity mismatch;
    - every body's penalty forcing then spreads onto one shared Eulerian
      forcing field (in body order), and the flow advances.

    Substeps: static (``substeps=k``) or dynamic (``sub_dt``, optional
    ``max_substeps``), as in :func:`build_rod_fsi_step`: the dynamic count
    ``clip(floor(dt / min(dt, sub_dt)), 1, max_substeps)`` is read on the
    host once a flow step. With no substepped body both may be omitted.

    ``sparse_forcing``: per-body moving sparse windows
    (:func:`suggest_rod_forcing_window`, :func:`suggest_rigid_forcing_window`).
    None engages them on a ``navier_stokes_with_forcing`` simulator when
    every body's window stays under 70% of the grid; True requires them;
    False takes the dense path. Each body's windowed forcing curl adds into
    the vorticity in body order, the flow advancing through the no-forcing
    step; the step then has ``uses_sparse_forcing = True`` and its
    diagnostic is ``(lag_force_sums, windows_ok)``. ``substep_interp``
    picks each body's substep E->L on the sparse path as in
    :func:`build_rod_fsi_step` ("auto" by that body's window size); the
    JAX package ignores a non-default value on the dense path, the port
    raises.

    :returns: ``step(carry) -> (carry, lag_force_sums)``, a per-body tuple
        of summed Lagrangian forcing (3,). The step carries ``stats``
        (steps, substeps, host reads).
    """
    from sopht_mpi_tpu_torch.models.rigid_body import (
        rigid_body_position_verlet_step,
    )

    bodies = tuple(bodies)
    if not bodies:
        raise ValueError("bodies must be non-empty")
    if substep_interp not in ("auto", "window_mm", "gather"):
        raise ValueError(
            "substep_interp must be 'auto', 'window_mm' or 'gather', got "
            f"{substep_interp!r}"
        )
    if substep_load_refresh not in ("every", "flow_step"):
        raise ValueError(
            "substep_load_refresh must be 'every' or 'flow_step', got "
            f"{substep_load_refresh!r}"
        )
    frozen_mode = substep_load_refresh == "flow_step"
    substepped = [isinstance(b, (RodBody, DynamicRigidBody)) for b in bodies]
    any_sub = any(substepped)
    dynamic = substeps is None and sub_dt is not None
    if any_sub and substeps is None and sub_dt is None:
        substeps = 1
    if substeps is not None and (sub_dt is not None or max_substeps is not None):
        raise ValueError(
            "substeps (static mode) conflicts with sub_dt/max_substeps "
            "(dynamic mode) - pass one or the other"
        )
    if dynamic and max_substeps is None:
        max_substeps = (
            math.ceil(flow_sim.diffusion_limited_timestep(dt_prefac) / sub_dt)
            + 2
        )

    rod_steps = {}
    for i, spec in enumerate(bodies):
        if isinstance(spec, RodBody):
            assert spec.rod_collection._finalized
            assert len(spec.rod_collection._systems) == 1, (
                "one rod per RodBody/collection; use several RodBody "
                "entries for several rods"
            )
            rod_steps[i] = spec.rod_collection._step_fns[0]
        elif isinstance(spec, DynamicRigidBody):
            if not hasattr(spec.rigid_body, "mass"):
                raise ValueError(
                    "DynamicRigidBody needs a rigid body constructed with "
                    "a density (mass/inertia_body)"
                )

    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    free_stream = _free_stream(free_stream_fn, flow_sim)
    real_t = flow_sim.real_t
    fixed_lag = {
        i: (
            spec.interactor.forcing_grid.compute_lag_grid_position_field(),
            spec.interactor.forcing_grid.compute_lag_grid_velocity_field(),
        )
        for i, spec in enumerate(bodies)
        if isinstance(spec, FixedRigidBody)
    }

    body_windows = None
    if (
        sparse_forcing is not False
        and flow_sim.flow_type == "navier_stokes_with_forcing"
    ):
        wins = [
            suggest_rod_forcing_window(
                spec.interactor, spec.rod_collection._systems[0],
                flow_sim.grid_size,
            )
            if isinstance(spec, RodBody)
            else suggest_rigid_forcing_window(spec.interactor,
                                              flow_sim.grid_size)
            for spec in bodies
        ]
        if all(w is not None for w in wins):
            body_windows = tuple(wins)
    if sparse_forcing is True and body_windows is None:
        raise ValueError(
            "sparse_forcing=True requested but unsupported here (needs a "
            "navier_stokes_with_forcing simulator and per-body support "
            "windows each under 70% of the grid)"
        )
    sparse = body_windows is not None
    if substep_interp != "auto" and not sparse:
        raise ValueError(
            f"substep_interp={substep_interp!r} picks the sparse windows' "
            "substep interpolation and needs sparse forcing"
        )
    mesh = getattr(flow_sim, "mesh", None)
    if sparse:
        _refuse_gather_on_a_mesh(flow_sim, substep_interp)
    gather_sub = tuple(
        sparse and (
            substep_interp == "gather"
            or (substep_interp == "auto"
                and mesh is None
                and math.prod(body_windows[i]) >= _GATHER_SUBSTEP_WINDOW_CELLS)
        )
        for i in range(len(bodies))
    )
    # each dynamic body's principal inertia, on the device once: a copy
    # from host memory at each substep would wait for the device
    inertias = tuple(
        torch.as_tensor(spec.rigid_body.inertia_body,
                        dtype=spec.rigid_body.state.position.dtype,
                        device=flow_sim.device)
        if isinstance(spec, DynamicRigidBody) else None
        for spec in bodies
    )
    if sparse:
        flow_step_l1 = _flow_step_l1(flow_sim, "navier_stokes")
        body_tools = tuple(
            _sparse_window_tools(flow_sim, spec.interactor.params, w)
            for spec, w in zip(bodies, body_windows)
        )
        logger.info(
            "build_multi_body_fsi_step: per-body sparse-window IBM forcing "
            f"engaged (windows {body_windows})"
        )
    else:
        flow_step_l1 = _flow_step_l1(flow_sim)

    def windowed_interaction(i, vb, velocity_field, pos, vel):
        """Body i's penalty interaction through its moving window:
        (lag_forcing, velocity_mismatch, start, mats, ok)."""
        window_mats, e2l_interp, _ = body_tools[i]
        start, mats, ok = window_mats(pos)
        mismatch = e2l_interp(velocity_field, start, mats) - vel
        lag_forcing = compute_penalty_force(
            vb.position_mismatch, mismatch, bodies[i].interactor.params
        )
        return lag_forcing, mismatch, start, mats, ok

    def interaction_on_lag_grid(i, state, vb, velocity_field):
        """Body i's (lag_forcing, velocity_mismatch, window ok) at ``state``
        (sparse window or dense support)."""
        grid = bodies[i].interactor.forcing_grid
        pos, vel = grid.lag_positions(state), grid.lag_velocities(state)
        if sparse and not gather_sub[i]:
            lag_forcing, mismatch, _, _, ok = windowed_interaction(
                i, vb, velocity_field, pos, vel)
            return lag_forcing, mismatch, ok
        interaction = compute_interaction_force_on_lag_grid(
            vb, velocity_field, pos, vel, bodies[i].interactor.params,
            mesh=mesh,
        )
        return interaction.lag_forcing, interaction.velocity_mismatch, None

    def body_substep(i, spec, state, vb, velocity_field, t, dt_sub,
                     frozen_i=None):
        """One substep of body i: (state, vb, window ok or None)."""
        grid = spec.interactor.forcing_grid
        ok = None
        if frozen_mode:
            forces, torques, mismatch = frozen_i
        else:
            lag_forcing, mismatch, ok = interaction_on_lag_grid(
                i, state, vb, velocity_field)
            forces, torques = grid.body_loads(state, lag_forcing)
        pdtype = state.position.dtype
        if isinstance(spec, RodBody):
            state = rod_steps[i](
                state, t.to(pdtype), dt_sub.to(pdtype),
                forces.to(pdtype), torques.to(pdtype),
            )
        else:  # DynamicRigidBody
            force = forces.reshape(3)
            torque = torques.reshape(3)
            if spec.load_fn is not None:
                f_extra, t_extra = spec.load_fn(state, t)
                force = force + torch.as_tensor(
                    f_extra, dtype=force.dtype, device=force.device
                ).reshape(3)
                torque = torque + torch.as_tensor(
                    t_extra, dtype=torque.dtype, device=torque.device
                ).reshape(3)
            state = rigid_body_position_verlet_step(
                state, dt_sub.to(pdtype), force.to(pdtype),
                torque.to(pdtype), spec.rigid_body.mass,
                inertias[i].to(pdtype),
            )
        vb = virtual_boundary_time_step(vb, mismatch, dt_sub)
        return state, vb, ok

    stats = {"steps": 0, "substeps": 0, "host_syncs": 0}

    def substep_count(dt):
        if not dynamic:
            return substeps
        # reference: int(dt / min(dt, sub_dt)), >= 1, in the flow dtype
        n_raw = torch.floor(dt / torch.clamp(dt, max=sub_dt))
        stats["host_syncs"] += 1
        return int(min(max(int(n_raw.item()), 1), max_substeps))

    def step(carry: MultiBodyFSICarry):
        (flow_state, body_states, vb_states, prev_mis, time, greens, u_l1,
         frozen) = carry
        if frozen_mode and frozen is None:
            raise ValueError(
                "substep_load_refresh='flow_step' needs the frozen-loads "
                "carry leaves - build the carry with "
                "init_multi_body_fsi_carry(flow_sim, bodies, step) passing "
                "THIS step"
            )
        dt = flow_dt(u_l1)
        velocity_field = flow_state.velocity_field
        windows_ok = torch.ones((), dtype=torch.bool, device=time.device)
        body_states, vb_states = list(body_states), list(vb_states)
        n_sub = 0
        if any_sub:
            n_sub = substep_count(dt)
            dt_sub = dt / n_sub
            t = time
            for _ in range(n_sub):
                for i, spec in enumerate(bodies):
                    if not substepped[i]:
                        continue
                    body_states[i], vb_states[i], ok = body_substep(
                        i, spec, body_states[i], vb_states[i],
                        velocity_field, t, dt_sub,
                        frozen[i] if frozen_mode else None,
                    )
                    if ok is not None:
                        windows_ok = windows_ok & ok
                t = t + dt_sub
        stats["steps"] += 1
        stats["substeps"] += n_sub

        # fixed bodies integrate their mismatch with the previous one, then
        # every body spreads its forcing, in body order: onto the shared
        # forcing field (dense) or as its windowed forcing curl added into
        # the vorticity (sparse; the curl is linear)
        new_vbs, new_prev, lag_sums, new_frozen = [], [], [], []
        if sparse:
            field = flow_state.primary_field
        else:
            eul_forcing = torch.zeros_like(flow_state.eul_grid_forcing_field)
        for i, spec in enumerate(bodies):
            vb = vb_states[i]
            params = spec.interactor.params
            grid = spec.interactor.forcing_grid
            if isinstance(spec, FixedRigidBody):
                vb = virtual_boundary_time_step(vb, prev_mis[i], dt)
                pos, vel = fixed_lag[i]
            else:
                pos = grid.lag_positions(body_states[i])
                vel = grid.lag_velocities(body_states[i])
            if sparse:
                lag_forcing, mismatch, start, mats, ok = windowed_interaction(
                    i, vb, velocity_field, pos, vel)
                windows_ok = windows_ok & ok
                win = torch.zeros((3, *body_windows[i]), dtype=real_t,
                                  device=velocity_field.device)
                win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
                curl_win = curl_3d(win, dt / (2.0 * params.dx))
                field = body_tools[i][2](field, curl_win, start)
            else:
                eul_forcing, interaction = (
                    compute_interaction_force_on_eul_and_lag_grid(
                        vb, eul_forcing, velocity_field, pos, vel, params,
                        mesh=mesh)
                )
                lag_forcing = interaction.lag_forcing
                mismatch = interaction.velocity_mismatch
            new_vbs.append(vb)
            # the carried dtype: f64 rod kinematics feeding an f32 flow must
            # not promote the leaf
            new_prev.append(mismatch.to(prev_mis[i].dtype))
            lag_sums.append(lag_forcing.sum(dim=1))
            if frozen_mode and substepped[i]:
                new_frozen.append(
                    (*grid.body_loads(body_states[i], lag_forcing), mismatch))
            else:
                new_frozen.append(None)

        if sparse:
            flow_state = flow_state._replace(primary_field=field)
        else:
            flow_state = flow_state._replace(eul_grid_forcing_field=eul_forcing)
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, free_stream(time), greens
        )
        new_carry = MultiBodyFSICarry(
            flow_state, tuple(body_states), tuple(new_vbs), tuple(new_prev),
            time + dt, greens, new_l1,
            tuple(new_frozen) if frozen_mode else None,
        )
        diag = tuple(lag_sums)
        return new_carry, (diag, windows_ok) if sparse else diag

    def frozen_loads_template(body_states, vb_states, velocity_field):
        """Per body, the (forces, torques, mismatch) the step stores as
        frozen loads, at the given state (None for fixed bodies)."""
        out = []
        for i, spec in enumerate(bodies):
            if not substepped[i]:
                out.append(None)
                continue
            lag_forcing, mismatch, _ = interaction_on_lag_grid(
                i, body_states[i], vb_states[i], velocity_field)
            forces, torques = spec.interactor.forcing_grid.body_loads(
                body_states[i], lag_forcing)
            out.append((forces, torques, mismatch))
        return tuple(out)

    step.uses_sparse_forcing = sparse
    step.uses_frozen_loads = frozen_mode
    step.body_windows = body_windows
    step.gather_substeps = gather_sub
    step.frozen_loads_template = frozen_loads_template
    step.stats = stats
    return step


def init_multi_body_fsi_carry(flow_sim, bodies, step=None) -> MultiBodyFSICarry:
    """Initial carry for :func:`build_multi_body_fsi_step` (fresh
    interactors, zero mismatch). Pass the built ``step``: with per-body
    sparse windows the never-read full-field forcing leaf shrinks to a
    zero-size placeholder, and with ``substep_load_refresh='flow_step'``
    the carry gains zero frozen loads of the shapes and dtypes the step
    stores."""
    body_states, vb_states, prev = [], [], []
    for spec in bodies:
        if isinstance(spec, RodBody):
            body_states.append(spec.rod_collection._systems[0].state)
        elif isinstance(spec, DynamicRigidBody):
            body_states.append(spec.rigid_body.state)
        else:
            body_states.append(None)
        vb_states.append(spec.interactor.state)
        prev.append(torch.zeros_like(spec.interactor.state.position_mismatch))
    flow_state = flow_sim._get_state()
    if getattr(step, "uses_sparse_forcing", False):
        flow_state = _without_forcing_field(flow_sim, flow_state)
    frozen = None
    if getattr(step, "uses_frozen_loads", False):
        loads = step.frozen_loads_template(
            tuple(body_states), tuple(vb_states), flow_sim.velocity_field)
        frozen = tuple(
            None if body is None else tuple(torch.zeros_like(v) for v in body)
            for body in loads
        )
    return MultiBodyFSICarry(
        flow_state=flow_state,
        body_states=tuple(body_states),
        vb_states=tuple(vb_states),
        prev_mismatches=tuple(prev),
        time=torch.tensor(
            flow_sim.time, dtype=flow_sim.real_t, device=flow_sim.device
        ),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=_carry_l1_max(flow_sim),
        frozen_loads=frozen,
    )


def suggest_rigid_forcing_window(
    interactor, grid_size, margin=1.1, max_grid_fraction=0.7
):
    """Static ``(Wz, Wy, Wx)`` window cells for a (possibly moving) rigid
    body's sparse IBM forcing, sized from its rotation-safe envelope (the
    markers fit a box of the circumscribing diameter however the body
    turns; the window start follows the translation on the device). None
    when the window would exceed ``max_grid_fraction`` of the grid."""
    params = interactor.params
    pos = (interactor.forcing_grid.compute_lag_grid_position_field()
           .detach().cpu().numpy())
    centroid = pos.mean(axis=1, keepdims=True)
    diameter = 2.0 * float(np.linalg.norm(pos - centroid, axis=0).max())
    cells = int(np.ceil(margin * diameter / params.dx))
    w = cells + 2 * params.interp_kernel_width + 6
    nz, ny, nx = (int(v) for v in grid_size)
    win = (min(w, nz), min(w, ny), min(w, nx))
    if np.prod(win) > max_grid_fraction * nz * ny * nx:
        return None
    return win


def _stack(diags):
    """Stack per-step diagnostics on a leading axis, tuples element-wise."""
    if isinstance(diags[0], tuple):
        return tuple(_stack(list(d)) for d in zip(*diags))
    return torch.stack(diags)


class FlowOnlyCarry(NamedTuple):
    flow_state: object
    time: torch.Tensor
    greens: object
    velocity_l1_max: torch.Tensor = None  # see RigidFSICarry


def build_flow_only_step(
    flow_sim,
    dt_prefac=1.0,
    free_stream_fn: Callable | None = None,
):
    """One flow-only step (CFL dt control from the carried ``max |u|_1`` +
    flow step) for the cases without a body, on one device or on the
    simulator's mesh: nothing in it waits for the device. Compose with
    :func:`scan_steps` using :func:`init_flow_only_carry`; the per-step
    diagnostic is dt. The passive flow types leave the velocity as it was,
    so their step keeps the carried ``max |u|_1``."""
    flow_step_l1 = _flow_step_l1(flow_sim)
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    free_stream = _free_stream(free_stream_fn, flow_sim)

    def step(carry: FlowOnlyCarry):
        flow_state, time, greens, u_l1 = carry
        dt = flow_dt(u_l1)
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, free_stream(time), greens)
        if new_l1 is None:
            new_l1 = u_l1
        return FlowOnlyCarry(flow_state, time + dt, greens, new_l1), dt

    return step


def init_flow_only_carry(flow_sim) -> FlowOnlyCarry:
    velocity = flow_sim.velocity_field
    return FlowOnlyCarry(
        flow_state=flow_sim._get_state(),
        time=torch.as_tensor(flow_sim.time, dtype=flow_sim.real_t,
                             device=flow_sim.device),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=(
            velocity_l1_max(velocity) if flow_sim.grid_dim == 2
            else velocity_l1_max_3d(velocity, flow_sim.mesh)),
    )


def scan_steps(step_fn, carry, n_steps: int, *, donate: bool = False):
    """Roll ``n_steps`` coupled steps; returns (final carry, per-step
    diagnostics stacked on a leading axis, each element of a (nested)
    tuple diagnostic stacked on its own). ``donate`` (the JAX package's
    buffer donation of the carry) is accepted and changes nothing: eager
    PyTorch frees each step's carry as the next replaces it."""
    diags = []
    for _ in range(n_steps):
        carry, diag = step_fn(carry)
        diags.append(diag)
    return carry, _stack(diags)
