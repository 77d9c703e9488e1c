"""The port's flexible rod in a 2D flow (``cases.flow_past_rod_2d_case``)
against the JAX package's ``examples/2d/flow_past_rod.py``, fused branch:
the element-centric forcing grid on a 2D flow, dynamic substeps and the
example's ramped, perturbed free stream.

Also holds :func:`write_jax_rod_2d_reference`, which computes the JAX tip
trajectory at (64, 128) that ``chip_smoke.py`` holds the card's run to.

Tolerances, as the rod FSI tests': float32 flow ``1e-4 max(1, |ref|max)``
after 3 steps (float32 rounding of two differently ordered FFTs through the
Poisson solve and the penalty force), the float64 rod held to the same.
"""

import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROD_2D_REFERENCE = os.path.join(
    REPO, "sopht_mpi_tpu_torch", "data", "rod_2d_reference.json"
)
ROD_2D_REFERENCE_COMMAND = (
    "JAX_PLATFORMS=cpu python -c \"import sys; sys.path[:0] = ['.', 'tests']; "
    "import test_torch_rod_2d as t; t.write_jax_rod_2d_reference()\""
)


def jax_rod_2d_case(grid_size=(256, 512)):
    """(step, carry, tip start) of the JAX package's flow past a rod, built
    as the fused branch of ``flow_past_rod_case`` builds them (float32
    flow, float64 rod), without its IO."""
    import jax.numpy as jnp

    from sopht_mpi_tpu.models import (
        AnalyticalLinearDamper,
        BaseSystemCollection,
        CosseratRod,
        CosseratRodElementCentricForcingGrid,
        CosseratRodFlowInteraction,
        GravityForces,
        OneEndFixedBC,
        UnboundedFlowSimulator2D,
        build_rod_fsi_step,
        init_rod_fsi_carry,
    )

    grid_size_y, grid_size_x = grid_size
    real_t = jnp.float32
    x_range = 6.0
    y_range = grid_size_y / grid_size_x * x_range
    sim = BaseSystemCollection()
    n_elem = grid_size_x // 8
    base_radius = 0.01
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = 1.5e-3 / moment_of_inertia
    rod = CosseratRod.straight_rod(
        n_elem, np.array([1.0, 0.501 * y_range, 0.0]),
        np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]), 1.0,
        base_radius, 1.5 / (np.pi * base_radius**2),
        youngs_modulus=youngs_modulus, shear_modulus=youngs_modulus / 1.5,
    )
    tip_start = np.asarray(rod.position_collection[(0, 1), -1])
    sim.append(rod)
    sim.constrain(rod).using(
        OneEndFixedBC, constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    sim.add_forcing_to(rod).using(
        GravityForces, acc_gravity=np.array([0.5, 0.0, 0.0]))
    rod_dt = 0.01 / n_elem
    sim.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=0.5e-3, time_step=rod_dt)
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size, x_range=x_range, kinematic_viscosity=1.0 / 200,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=real_t,
    )
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim, cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-8e4,
        virtual_boundary_damping_coeff=-30.0,
        forcing_grid_cls=CosseratRodElementCentricForcingGrid,
    )
    sim.finalize()

    def free_stream(t):
        ramp = jnp.exp(-t / 1.0)
        return jnp.asarray([1.0 - ramp, 0.5 * ramp], real_t)

    step = build_rod_fsi_step(
        flow_sim, interactor, sim, dt_prefac=0.5,
        free_stream_fn=free_stream, rod_dt=rod_dt,
    )
    return step, init_rod_fsi_carry(flow_sim, interactor, rod), tip_start


def write_jax_rod_2d_reference(grid_size=(64, 128), n_steps=40,
                               path=ROD_2D_REFERENCE):
    """Write the JAX tip trajectory of the flow past a rod at ``grid_size``
    (``n_steps`` fused steps) as JSON."""
    import jax

    from sopht_mpi_tpu.models import scan_steps

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    step, carry, tip_start = jax_rod_2d_case(tuple(grid_size))
    times = [float(carry.time)]
    tips = [np.asarray(carry.rod_state.position[:, -1]).tolist()]
    for _ in range(n_steps):
        carry, _ = scan_steps(step, carry, 1)
        times.append(float(carry.time))
        tips.append(np.asarray(carry.rod_state.position[:, -1]).tolist())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "case": "examples/2d/flow_past_rod.py, fused branch",
            "grid_size": list(grid_size),
            "n_steps": n_steps,
            "precision": "float32 flow, float64 rod (x64), CPU",
            "jax_version": jax.__version__,
            "command": ROD_2D_REFERENCE_COMMAND,
            "rod_length": 1.0,
            "tip_start": tip_start.tolist(),
            "times": times,
            "tip": tips,
        }, f, indent=None)
        f.write("\n")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import sopht_mpi_tpu.models as jm  # noqa: E402
import sopht_mpi_tpu_torch.models as tm  # noqa: E402
from sopht_mpi_tpu_torch import cases  # noqa: E402
from sopht_mpi_tpu_torch.convert import rod_fsi_carry_from_numpy  # noqa: E402

TOL = 1e-4
N_STEPS = 3
GRID = (32, 64)


def _close(out, ref, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max|diff| {err} > {TOL} * {scale}"


def _close_carry(carry, jcarry):
    ref = jax.tree_util.tree_map(np.asarray, jcarry)
    for what in ("primary_scalar_field", "velocity_field"):
        _close(getattr(carry.flow_state, what),
               getattr(ref.flow_state, what), what)
    for what in ("position", "velocity", "director", "omega"):
        _close(getattr(carry.rod_state, what), getattr(ref.rod_state, what),
               f"rod {what}")
    _close(carry.vb_state.position_mismatch, ref.vb_state.position_mismatch,
           "position_mismatch")
    _close(carry.time, ref.time, "time")
    _close(carry.velocity_l1_max, ref.velocity_l1_max, "l1")


@pytest.fixture(scope="module")
def both_cases():
    return jax_rod_2d_case(GRID), cases.flow_past_rod_2d_case(GRID,
                                                              device="cpu")


@pytest.fixture(scope="module")
def jax_trajectory(both_cases):
    """The JAX carries after 3 and 6 fused steps from rest, and the lag
    force sums of steps 4-6: one compiled program of 3 steps."""
    jstep, jcarry, _ = both_cases[0]
    after_3, _ = jm.scan_steps(jstep, jcarry, N_STEPS)
    after_6, forces = jm.scan_steps(jstep, after_3, N_STEPS)
    return after_3, after_6, forces


def test_case_builds_what_the_example_builds(both_cases):
    (_, jcarry, jtip), (step, carry, tip) = both_cases
    start = jax.tree_util.tree_map(np.asarray, jcarry)
    for what in ("position", "director", "velocity", "omega"):
        _close(getattr(carry.rod_state, what),
               getattr(start.rod_state, what), what)
    np.testing.assert_array_equal(tip, jtip)
    assert carry.rod_state.position.shape == (3, GRID[1] // 8 + 1)
    assert carry.rod_state.position.dtype == torch.float64
    assert carry.flow_state.primary_scalar_field.shape == GRID
    assert carry.flow_state.primary_scalar_field.dtype == torch.float32
    assert step.sparse_forcing_window is None


def test_steps_from_the_jax_carry_match(both_cases, jax_trajectory):
    """3 fused steps of the port's case from the JAX carry after 3 JAX
    steps, converted with ``rod_fsi_carry_from_numpy``, against the next 3
    JAX steps; one host sync a step reads the dynamic substep count."""
    step = both_cases[1][0]
    jcarry, jfinal, jforces = jax_trajectory
    carry = rod_fsi_carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcarry), device="cpu",
        dtype=torch.float32)
    syncs = step.stats["host_syncs"]
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal)
    _close(forces, jforces, "lag_force_sum")
    assert float(np.abs(np.asarray(jforces)).max()) > 0
    assert step.stats["host_syncs"] - syncs == N_STEPS


def test_steps_from_rest_match_jax(both_cases, jax_trajectory):
    """3 fused steps of each package's own case from rest, where the flow
    step is diffusion-limited and the rod takes its most substeps."""
    step, carry, tip = both_cases[1]
    jfinal = jax_trajectory[0]
    substeps = step.stats["substeps"]
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal)
    assert step.stats["substeps"] - substeps > 10 * N_STEPS
    moved = final.rod_state.position[:2, -1].numpy() - tip
    assert float(np.abs(moved).max()) > 0
