"""The port's freely rotating rod case
(``cases._build_freely_rotating_rod_case``) against the JAX package's
``examples/3d/flow_past_freely_rotating_rod.py``, fused branch.

Also holds :func:`write_jax_free_rod_reference`, which computes the JAX tip
trajectory at the example's default size that ``chip_smoke.py`` holds the
card's run to.

Tolerances, as the rod FSI tests': float32 flow ``1e-4 max(1, |ref|max)``
after 3 steps (float32 rounding of two differently ordered FFTs through the
Poisson solve and the penalty force), the float64 rod held to the same.
"""

import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREE_ROD_REFERENCE = os.path.join(
    REPO, "sopht_mpi_tpu_torch", "data", "freely_rotating_rod_reference.json"
)
FREE_ROD_REFERENCE_COMMAND = (
    "JAX_PLATFORMS=cpu python -c \"import sys; sys.path[:0] = ['.', 'tests']; "
    "import test_torch_freely_rotating_rod as t; "
    "t.write_jax_free_rod_reference()\""
)


def jax_free_rod_case(grid_size=(64, 64, 128), n_elem=16,
                      surface_grid_density_for_largest_element=12):
    """(step, carry) of the JAX package's freely rotating rod, built as the
    fused branch of ``flow_past_freely_rotating_rod_case`` builds them
    (float32 flow, float64 rod), without its checkpoint IO."""
    import jax.numpy as jnp

    from sopht_mpi_tpu.models import (
        AnalyticalLinearDamper,
        BaseSystemCollection,
        CosseratRod,
        CosseratRodFlowInteraction,
        CosseratRodSurfaceForcingGrid,
        GeneralConstraint,
        UnboundedFlowSimulator3D,
        build_rod_fsi_step,
        init_rod_fsi_carry,
    )
    from sopht_mpi_tpu.utils import get_real_t

    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t("single")
    rho_f, u_free_stream, base_length = 1.0, 1.0, 1.0
    x_range = 5.0 * base_length
    y_range = grid_size_y / grid_size_x * x_range
    z_range = grid_size_z / grid_size_x * x_range
    velocity_free_stream = [u_free_stream, 0.0, 0.0]
    sim = BaseSystemCollection()
    start = np.array([0.08 * x_range, 0.502 * y_range, 0.502 * z_range])
    incline = np.pi / 2
    direction = np.array([np.sin(incline), 0.0, -np.cos(incline)])
    normal = np.array([0.0, 1.0, 0.0])
    base_diameter = base_length / 10.0
    base_radius = base_diameter / 2.0
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        rho_f * u_free_stream**2 * base_length**3 * base_diameter
    ) / (0.2 * moment_of_inertia)
    rod = CosseratRod.straight_rod(
        n_elem, start, direction, normal, base_length, base_radius,
        10.0 * rho_f, youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / 1.5,
    )
    sim.append(rod)
    sim.constrain(rod).using(
        GeneralConstraint,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
        translational_constraint_selector=np.array([True, True, True]),
        rotational_constraint_selector=np.array([False, True, True]),
    )
    rod_dt = 0.01 * base_length / n_elem
    sim.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=1e-3, time_step=rod_dt
    )
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=u_free_stream * base_diameter / 100.0,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        filter_vorticity=True,
        filter_setting_dict={"order": 5, "type": "convolution"},
    )
    flow_sim.velocity_field = flow_sim.velocity_field + jnp.asarray(
        velocity_free_stream, real_t
    ).reshape(3, 1, 1, 1)
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-2e5,
        virtual_boundary_damping_coeff=-1e2,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
    )
    sim.finalize()
    step = build_rod_fsi_step(
        flow_sim, interactor, sim, dt_prefac=0.25,
        free_stream_fn=lambda t: jnp.asarray(velocity_free_stream, real_t),
        rod_dt=rod_dt,
    )
    return step, init_rod_fsi_carry(flow_sim, interactor, rod)


def write_jax_free_rod_reference(n_steps=20, path=FREE_ROD_REFERENCE):
    """Write the JAX tip trajectory of the freely rotating rod at the
    example's default size (``n_steps`` fused steps) as JSON."""
    import jax

    from sopht_mpi_tpu.models import scan_steps

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    grid = (64, 64, 128)
    step, carry = jax_free_rod_case(grid)
    times = [float(carry.time)]
    tips = [np.asarray(carry.rod_state.position[:, -1]).tolist()]
    for _ in range(n_steps):
        carry, _ = scan_steps(step, carry, 1)
        times.append(float(carry.time))
        tips.append(np.asarray(carry.rod_state.position[:, -1]).tolist())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "case": "examples/3d/flow_past_freely_rotating_rod.py, fused "
                    "branch",
            "grid_size": list(grid),
            "n_elem": 16,
            "surface_grid_density_for_largest_element": 12,
            "n_steps": n_steps,
            "precision": "float32 flow, float64 rod (x64), exact tier, CPU",
            "jax_version": jax.__version__,
            "command": FREE_ROD_REFERENCE_COMMAND,
            "rod_length": 1.0,
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
GRID = (16, 16, 32)
N_ELEM = 4


def _close(out, ref, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max|diff| {err} > {TOL} * {scale}"


def _close_carry(carry, jcarry):
    ref = jax.tree_util.tree_map(np.asarray, jcarry)
    for what in ("primary_field", "velocity_field"):
        _close(getattr(carry.flow_state, what),
               getattr(ref.flow_state, what), what)
    for what in ("position", "velocity", "director", "omega"):
        _close(getattr(carry.rod_state, what), getattr(ref.rod_state, what),
               f"rod {what}")
    _close(carry.vb_state.position_mismatch, ref.vb_state.position_mismatch,
           "position_mismatch")
    _close(carry.time, ref.time, "time")


@pytest.fixture(scope="module")
def both_cases():
    jstep, jcarry = jax_free_rod_case(GRID, N_ELEM, 12)
    step, carry = cases._build_freely_rotating_rod_case(
        GRID, device="cpu", n_elem=N_ELEM)
    return (jstep, jcarry), (step, carry)


def test_case_builds_what_the_example_builds(both_cases):
    (_, jcarry), (step, carry) = both_cases
    start = jax.tree_util.tree_map(np.asarray, jcarry)
    for what in ("position", "director", "velocity", "omega"):
        _close(getattr(carry.rod_state, what),
               getattr(start.rod_state, what), what)
    _close(carry.flow_state.velocity_field, start.flow_state.velocity_field,
           "velocity")
    assert carry.rod_state.position.dtype == torch.float64
    assert carry.flow_state.primary_field.dtype == torch.float32
    assert step.sparse_forcing_window is None


def test_steps_match_jax(both_cases):
    """3 fused steps of the port's case against the JAX package's, each
    package building its own; the order-5 convolution filter runs once a
    step."""
    (jstep, jcarry), (step, carry) = both_cases
    jfinal, jforces = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal)
    _close(forces, jforces, "lag_force_sum")
    assert step.stats["host_syncs"] >= N_STEPS


def test_steps_from_the_jax_carry_match(both_cases):
    """3 steps from the JAX carry after one JAX step, converted with
    ``rod_fsi_carry_from_numpy``: the rod's state after the first step
    (the free axial rotation started) lands and steps alike."""
    (jstep, jcarry), (step, _) = both_cases
    jcarry, _ = jm.scan_steps(jstep, jcarry, 1)
    tree = jax.tree_util.tree_map(np.asarray, jcarry)
    carry = rod_fsi_carry_from_numpy(tree, device="cpu", dtype=torch.float32)
    jfinal, _ = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal)


def test_filter_is_the_case_s(monkeypatch):
    """The case filters the vorticity once a step with the order-5
    convolution filter, as the example does."""
    from sopht_mpi_tpu_torch.models.flow import simulator_3d

    calls = []
    original = simulator_3d.laplacian_filter_vector_3d

    def spy(field, order, kind):
        calls.append((order, kind))
        return original(field, order, kind)

    monkeypatch.setattr(simulator_3d, "laplacian_filter_vector_3d", spy)
    step, carry = cases._build_freely_rotating_rod_case(
        GRID, device="cpu", n_elem=N_ELEM)
    tm.scan_steps(step, carry, 2)
    assert calls == [(5, "convolution")] * 2
