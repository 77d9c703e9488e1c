"""The port's fused flow-past-cylinder step (2D rigid FSI, dense IBM path)
against the JAX package's: the example's case at (32, 64), three steps from
a carry converted from the JAX one, on both Poisson routes; the 2D
immersed-boundary transfers, the cylinder and its forcing grids.

Tolerances: float64 ``1e-9 max(1, |ref|max)``, float32
``1e-4 max(1, |ref|max)`` over 3 strongly forced steps (as for the sphere
step); the transfers ``1e-5`` / ``1e-12`` relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.poisson as jax_poisson
from sopht_mpi_tpu import models as jax_models
from sopht_mpi_tpu.ops import ibm as jax_ibm
from sopht_mpi_tpu.utils import get_real_t as jax_real_t
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch import models
from sopht_mpi_tpu_torch.convert import rigid_fsi_carry_from_numpy
from sopht_mpi_tpu_torch.ops import ibm, poisson
from sopht_mpi_tpu_torch.utils import get_real_t

GRID = (32, 64)
N_STEPS = 3
TOL = {"single": 1e-4, "double": 1e-9}


def _close(out, ref, tol, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _jax_cylinder_case(precision, grid=GRID):
    """The body of ``examples/2d/flow_past_cylinder.py``'s fused case up to
    its carry."""
    real_t = jax_real_t(precision)
    cyl_radius = 0.03
    flow_sim = jax_models.UnboundedFlowSimulator2D(
        grid_size=grid, x_range=1.0, kinematic_viscosity=cyl_radius / 200.0,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=real_t,
    )
    cylinder = jax_models.Cylinder(
        center=(2.5 * cyl_radius, 0.5 * grid[0] / grid[1]), radius=cyl_radius,
        dtype=real_t,
    )
    interactor = jax_models.RigidBodyFlowInteraction(
        flow_sim, cylinder,
        jax_models.CircularCylinderForcingGrid(cylinder, 60),
        virtual_boundary_stiffness_coeff=-5e4,
        virtual_boundary_damping_coeff=-20.0,
    )
    step = jax_models.build_rigid_fsi_step(
        flow_sim, interactor, dt_prefac=1.0,
        free_stream_fn=lambda t: jnp.asarray([1.0, 0.0], real_t),
    )
    return step, jax_models.init_rigid_fsi_carry(flow_sim, interactor)


@pytest.mark.parametrize(
    "precision,kernel_route",
    [("single", False), ("double", False), ("single", True)],
    ids=["single", "double", "single-kernel-route"],
)
def test_cylinder_fsi_steps_match_jax(precision, kernel_route, monkeypatch):
    if kernel_route:
        monkeypatch.setattr(jax_poisson, "FORCE_PALLAS_CONVOLVE", True)
        monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    jax_step, jax_carry = _jax_cylinder_case(precision)
    step, (own_carry,) = cases._build_cylinder_fsi_case(
        GRID, device="cpu", precision=precision)
    assert not step.uses_sparse_forcing
    start = jax.tree_util.tree_map(np.asarray, jax_carry)
    dtype = get_real_t(precision)
    carry = rigid_fsi_carry_from_numpy(start, device="cpu", dtype=dtype)
    assert isinstance(carry.greens, tuple) == kernel_route
    assert isinstance(own_carry.greens, tuple) == kernel_route
    assert carry.flow_state.primary_scalar_field.shape == GRID
    assert carry.ibm_mats is None and own_carry.ibm_mats is None
    rtol = 1e-5 if precision == "single" else 1e-10
    pairs = (zip(own_carry.greens, start.greens) if kernel_route
             else [(own_carry.greens, start.greens)])
    g_scale = np.abs(np.asarray(
        start.greens[0] if kernel_route else start.greens)).max()
    for own_g, g_ref in pairs:
        _close(own_g, np.asarray(g_ref), rtol * g_scale, "greens")
    _close(own_carry.velocity_l1_max, start.velocity_l1_max, 0.0, "l1")

    jax_final, jax_forces = jax_models.scan_steps(jax_step, jax_carry, N_STEPS)
    final, forces = models.scan_steps(step, carry, N_STEPS)
    tol = TOL[precision]
    ref = jax.tree_util.tree_map(np.asarray, jax_final)
    _close(final.flow_state.primary_scalar_field,
           ref.flow_state.primary_scalar_field, tol, "vorticity")
    _close(final.flow_state.velocity_field, ref.flow_state.velocity_field,
           tol, "velocity")
    assert tuple(forces.shape) == (N_STEPS, 2)
    _close(forces, np.asarray(jax_forces), tol, "lag_force_sum")
    _close(final.time, ref.time, tol, "time")
    _close(final.velocity_l1_max, ref.velocity_l1_max, tol, "velocity_l1_max")
    _close(final.vb_state.position_mismatch, ref.vb_state.position_mismatch,
           tol, "position_mismatch")
    assert final.flow_state.primary_scalar_field.dtype == dtype
    # the port's own carry gives the same steps
    own_final, own_forces = models.scan_steps(step, own_carry, N_STEPS)
    _close(own_forces, np.asarray(jax_forces), tol, "own lag_force_sum")


def test_sparse_forcing_is_3d_only():
    flow_sim = models.UnboundedFlowSimulator2D(
        GRID, 1.0, 1e-3, flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True, device="cpu")
    cylinder = models.Cylinder((0.3, 0.25), 0.05, device="cpu")
    interactor = models.RigidBodyFlowInteraction(
        flow_sim, cylinder, models.CircularCylinderForcingGrid(cylinder, 40),
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1.0)
    with pytest.raises(ValueError, match="3D"):
        models.build_rigid_fsi_step(flow_sim, interactor, sparse_forcing=True)
    assert not models.build_rigid_fsi_step(
        flow_sim, interactor).uses_sparse_forcing


def test_host_loop_interactor_matches_jax():
    """The unfused loop of the example (interactor.time_step, interactor(),
    flow_sim.time_step) for 3 steps, with the body loads."""
    def build(m, sim_kw, body_kw):
        flow_sim = m.UnboundedFlowSimulator2D(
            grid_size=GRID, x_range=1.0, kinematic_viscosity=1.5e-4,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True, **sim_kw)
        cylinder = m.Cylinder(center=(0.075, 0.25), radius=0.03, **body_kw)
        grid = m.CircularCylinderForcingGrid(cylinder, 60)
        return flow_sim, m.RigidBodyFlowInteraction(
            flow_sim, cylinder, grid, virtual_boundary_stiffness_coeff=-5e4,
            virtual_boundary_damping_coeff=-20.0)

    jax_sim, jax_int = build(jax_models, {}, {})
    sim, inter = build(models, {"device": "cpu"}, {"device": "cpu"})
    for _ in range(N_STEPS):
        dt = jax_sim.compute_stable_timestep()
        for s, i in ((jax_sim, jax_int), (sim, inter)):
            i.time_step(dt=dt)
            i()
            s.time_step(dt=dt, free_stream_velocity=(1.0, 0.0))
    _close(sim.vorticity_field, jax_sim.vorticity_field, 1e-4, "vorticity")
    _close(inter.global_lag_grid_forcing_field,
           jax_int.global_lag_grid_forcing_field, 1e-4, "lag forcing")
    jax_int.compute_flow_forces_and_torques()
    inter.compute_flow_forces_and_torques()
    assert tuple(inter.body_flow_forces.shape) == (3, 1)
    _close(inter.body_flow_forces, jax_int.body_flow_forces, 1e-4, "forces")
    _close(inter.body_flow_torques, jax_int.body_flow_torques, 1e-4, "torques")
    assert inter.get_grid_deviation_error_l2_norm() == pytest.approx(
        jax_int.get_grid_deviation_error_l2_norm(), rel=1e-3)


def test_cylinder_grid_kinematics_match_jax():
    """A translating, spinning cylinder's marker positions, velocities and
    loads."""
    state_kw = dict(velocity=[0.2, -0.1, 0.0], omega=[0.0, 0.0, 1.5])
    c, s = np.cos(0.4), np.sin(0.4)
    director = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    jax_cyl = jax_models.Cylinder((0.3, 0.4), 0.05, dtype=jnp.float64,
                                  density=2.0)
    cyl = models.Cylinder((0.3, 0.4), 0.05, device="cpu", dtype=torch.float64,
                          density=2.0)
    assert cyl.mass == pytest.approx(jax_cyl.mass)
    np.testing.assert_allclose(cyl.inertia_body, jax_cyl.inertia_body)
    assert tuple(cyl.state.position.shape) == (3,)
    jax_cyl.state = jax_models.RigidBodyState.create(
        [0.3, 0.4], director=director, dtype=jnp.float64, **state_kw)
    cyl.state = models.RigidBodyState.create(
        [0.3, 0.4], director=director, device="cpu", dtype=torch.float64,
        **state_kw)
    jax_grid = jax_models.CircularCylinderForcingGrid(jax_cyl, 24)
    grid = models.CircularCylinderForcingGrid(cyl, 24)
    assert grid.grid_dim == 2 and grid.num_lag_nodes == 24
    _close(grid.compute_lag_grid_position_field(),
           jax_grid.compute_lag_grid_position_field(), 1e-14, "positions")
    _close(grid.compute_lag_grid_velocity_field(),
           jax_grid.compute_lag_grid_velocity_field(), 1e-14, "velocities")
    f = np.random.default_rng(2).standard_normal((2, 24))
    for out, ref in zip(
            grid.transfer_forcing_from_grid_to_body(torch.tensor(f)),
            jax_grid.transfer_forcing_from_grid_to_body(jnp.asarray(f))):
        _close(out, ref, 1e-13, "loads")
    assert grid.get_maximum_lagrangian_grid_spacing() == pytest.approx(
        jax_grid.get_maximum_lagrangian_grid_spacing())


def test_empty_forcing_grid():
    grid = models.EmptyForcingGrid(2, device="cpu")
    assert grid.num_lag_nodes == 0
    assert tuple(grid.compute_lag_grid_position_field().shape) == (2, 0)
    assert tuple(grid.compute_lag_grid_velocity_field().shape) == (2, 0)
    forces, torques = grid.transfer_forcing_from_grid_to_body(None)
    assert tuple(forces.shape) == (3, 1) and tuple(torques.shape) == (3, 1)
    assert grid.get_maximum_lagrangian_grid_spacing() == 0.0


@pytest.mark.parametrize("kind", ["cosine", "peskin"])
def test_2d_transfers_match_jax(kind, precision):
    np_t = np.float32 if precision == "single" else np.float64
    tol = 1e-5 if precision == "single" else 1e-12
    rng = np.random.default_rng(6)
    ny, nx, n = 20, 28, 15
    dx = 1.0 / nx
    pos = np.stack([rng.uniform(0.1, 0.9, n),
                    rng.uniform(0.1, 0.6, n)]).astype(np_t)
    pos[:, 0] = (0.01, 0.02)  # support clipped at the walls
    field = rng.standard_normal((2, ny, nx)).astype(np_t)
    lag = rng.standard_normal((2, n)).astype(np_t)

    def run(m, xp):
        _, idx, disp = m.nearest_grid_index_and_support(xp(pos), dx, dx / 2)
        w = m.interpolation_weights(disp, dx, kind)
        mats = m.axis_delta_weight_matrices(idx, disp, dx, (ny, nx), kind)
        return dict(
            weights=w,
            interp=m.eulerian_to_lagrangian_interpolation(xp(field), w, idx, dx),
            interp_scalar=m.eulerian_to_lagrangian_interpolation(
                xp(field[0]), w, idx, dx),
            spread=m.lagrangian_to_eulerian_spread(xp(field), xp(lag), w, idx),
            spread_scalar=m.lagrangian_to_eulerian_spread(
                xp(field[1]), xp(lag[1]), w, idx),
            interp_mm=m.eulerian_to_lagrangian_interpolation_mm(
                xp(field), mats, dx),
            spread_mm=m.lagrangian_to_eulerian_spread_mm(
                xp(field), xp(lag), mats),
        )

    ref = run(jax_ibm, jnp.asarray)
    out = run(ibm, torch.tensor)
    for key in ref:
        _close(out[key], ref[key], tol, key)
    _close(out["interp_mm"], np.asarray(ref["interp"]), 10 * tol, "mm == gather")


def write_jax_cylinder_reference(n_steps=2000, every=250):
    """Write ``sopht_mpi_tpu_torch/data/cylinder_reference.json``: the drag
    coefficient of the (256, 512) Re = 200 cylinder case at every
    ``every``-th of ``n_steps`` fused steps of the JAX package (float32
    flow, CPU), which the card's run of the same steps is held against."""
    import json
    import os

    grid = (256, 512)
    step, carry = _jax_cylinder_case("single", grid)
    cds, steps = [], []
    cyl_radius, velocity_scale = 0.03, 1.0
    drag_scale = velocity_scale**2 * cyl_radius
    for k in range(every, n_steps + 1, every):
        carry, forces = jax_models.scan_steps(step, carry, every)
        steps.append(k)
        cds.append(float(np.abs(np.asarray(forces[-1, 0]))) / drag_scale)
    timescale = cyl_radius / velocity_scale
    out = {
        "grid_size": list(grid), "n_steps": n_steps, "steps": steps,
        "cd": cds, "drag_scale": drag_scale, "timescale": timescale,
        "t_star": float(carry.time) / timescale,
        "source": "sopht_mpi_tpu build_rigid_fsi_step, float32, CPU",
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sopht_mpi_tpu_torch", "data",
        "cylinder_reference.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out
