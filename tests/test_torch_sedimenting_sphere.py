"""The port's sedimenting sphere (``cases.sedimenting_sphere_case``)
against the JAX package's ``examples/3d/sedimenting_sphere.py``: one
dynamic rigid body under its net weight in the multi-body step, float64.

Also holds :func:`write_jax_sedimenting_sphere_reference`, which computes
the JAX trajectory at the example's 64^3 that ``chip_smoke.py`` holds the
card's run to.

Tolerance, as the multi-body tests' float64 steps: ``1e-9 max(1,
|ref|max)`` after 3 fused steps.
"""

import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEDIMENTING_SPHERE_REFERENCE = os.path.join(
    REPO, "sopht_mpi_tpu_torch", "data", "sedimenting_sphere_reference.json"
)
SEDIMENTING_SPHERE_REFERENCE_COMMAND = (
    "JAX_PLATFORMS=cpu python -c \"import sys; sys.path[:0] = ['.', 'tests']; "
    "import test_torch_sedimenting_sphere as t; "
    "t.write_jax_sedimenting_sphere_reference()\""
)


def jax_sedimenting_sphere_case(grid_size=(64, 64, 64)):
    """(step, carry) of the JAX package's sedimenting sphere, built as
    ``sedimenting_sphere_case`` builds them with its defaults (float64)."""
    import jax.numpy as jnp

    from sopht_mpi_tpu.models import (
        DynamicRigidBody,
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )

    real_t = jnp.float64
    radius, rho_s, mu = 0.06, 2.0, 1.0
    g = 0.05 * 9.0 * mu / (2.0 * (rho_s - 1.0) * radius**2)
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size, x_range=1.0, kinematic_viscosity=1.0,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=False,
        real_t=real_t,
    )
    sphere = Sphere(center=np.array([0.5, 0.5, 0.65]), radius=radius,
                    dtype=real_t, density=rho_s)
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=sphere,
        forcing_grid=SphereForcingGrid(
            rigid_body=sphere,
            num_forcing_points_along_equator=max(
                8, int(1.875 * 2.0 * radius * grid_size[-1]))),
        virtual_boundary_stiffness_coeff=-5e5,
        virtual_boundary_damping_coeff=-2e2,
    )
    net_weight = -(rho_s - 1.0) * (4.0 / 3.0) * np.pi * radius**3 * g

    def load_fn(state, t):
        return (jnp.asarray([0.0, 0.0, net_weight], state.position.dtype),
                jnp.zeros(3, state.position.dtype))

    bodies = (DynamicRigidBody(interactor, sphere, load_fn),)
    step = build_multi_body_fsi_step(flow_sim, bodies, dt_prefac=0.5,
                                     substeps=1)
    return step, init_multi_body_fsi_carry(flow_sim, bodies, step)


def write_jax_sedimenting_sphere_reference(
        grid_size=(64, 64, 64), n_steps=20,
        path=SEDIMENTING_SPHERE_REFERENCE):
    """Write the JAX trajectory of the sedimenting sphere (time, the
    sphere's z position and z velocity after each of ``n_steps`` fused
    steps) as JSON."""
    import jax

    from sopht_mpi_tpu.models import scan_steps

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    step, carry = jax_sedimenting_sphere_case(tuple(grid_size))
    sparse = bool(getattr(step, "uses_sparse_forcing", False))
    times = [float(carry.time)]
    z = [float(carry.body_states[0].position[2])]
    vz = [float(carry.body_states[0].velocity[2])]
    for _ in range(n_steps):
        carry, diag = scan_steps(step, carry, 1)
        if sparse:
            assert bool(np.all(np.asarray(diag[1])))
        times.append(float(carry.time))
        z.append(float(carry.body_states[0].position[2]))
        vz.append(float(carry.body_states[0].velocity[2]))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "case": "examples/3d/sedimenting_sphere.py, defaults",
            "grid_size": list(grid_size),
            "n_steps": n_steps,
            "sparse_forcing": sparse,
            "precision": "float64 (x64), CPU",
            "jax_version": jax.__version__,
            "command": SEDIMENTING_SPHERE_REFERENCE_COMMAND,
            "times": times,
            "z": z,
            "v_z": vz,
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
from sopht_mpi_tpu_torch.convert import (  # noqa: E402
    multi_body_fsi_carry_from_numpy,
)

TOL = 1e-9
N_STEPS = 3
GRID = (16, 16, 16)


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
    for what in ("position", "velocity", "omega", "director"):
        _close(getattr(carry.body_states[0], what),
               getattr(ref.body_states[0], what), f"sphere {what}")
    _close(carry.vb_states[0].position_mismatch,
           ref.vb_states[0].position_mismatch, "position_mismatch")
    _close(carry.time, ref.time, "time")
    _close(carry.velocity_l1_max, ref.velocity_l1_max, "l1")


@pytest.fixture(scope="module")
def both_cases():
    return (jax_sedimenting_sphere_case(GRID),
            cases.sedimenting_sphere_case(GRID, device="cpu"))


@pytest.fixture(scope="module")
def jax_trajectory(both_cases):
    """The JAX carries after 3 and 6 fused steps from rest, and the
    diagnostics of steps 4-6: one compiled program of 3 steps."""
    jstep, jcarry = both_cases[0]
    after_3, _ = jm.scan_steps(jstep, jcarry, N_STEPS)
    after_6, diag = jm.scan_steps(jstep, after_3, N_STEPS)
    return after_3, after_6, diag


def test_case_builds_what_the_example_builds(both_cases):
    (jstep, jcarry), (step, carry, v_t, tau) = both_cases
    assert step.uses_sparse_forcing == jstep.uses_sparse_forcing
    start = jax.tree_util.tree_map(np.asarray, jcarry)
    _close(carry.body_states[0].position, start.body_states[0].position,
           "position")
    assert carry.flow_state.primary_field.dtype == torch.float64
    assert carry.body_states[0].position.dtype == torch.float64
    assert v_t == pytest.approx(0.05, rel=1e-12)
    assert tau == pytest.approx(2.0 * 2.0 * 0.06**2 / 9.0, rel=1e-12)


def test_steps_from_the_jax_carry_match(both_cases, jax_trajectory):
    """3 fused steps of the port's case from the JAX carry after 3 JAX
    steps, converted with ``multi_body_fsi_carry_from_numpy``, against the
    next 3 JAX steps: the sphere falls, and every sparse window covered its
    support."""
    step = both_cases[1][0]
    jcarry, jfinal, jdiag = jax_trajectory
    carry = multi_body_fsi_carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcarry), device="cpu",
        dtype=torch.float64)
    final, diag = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal)
    if step.uses_sparse_forcing:
        (forces, ok), (jforces, jok) = diag, jdiag
        assert bool(ok.all())
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    else:
        forces, jforces = diag, jdiag
    _close(forces[0], jforces[0], "lag_force_sum")
    assert float(final.body_states[0].velocity[2]) < 0
    assert step.stats["host_syncs"] == 0


def test_steps_from_rest_match_jax(both_cases, jax_trajectory):
    step, carry, _, _ = both_cases[1]
    jfinal = jax_trajectory[0]
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal)


def test_position_mismatch_property_matches_jax():
    """``position_mismatch`` reads and sets the interactor's IBM state in
    its dtype and on its device, as the JAX property does (a restart sets
    it)."""
    import jax.numpy as jnp

    def interactor(pkg, **kw):
        flow_sim = pkg.UnboundedFlowSimulator3D(
            grid_size=GRID, x_range=1.0, kinematic_viscosity=1.0,
            flow_type="navier_stokes_with_forcing", **kw)
        sphere = pkg.Sphere(center=np.array([0.5, 0.5, 0.65]), radius=0.1,
                            **({"device": "cpu"} if pkg is tm else {}),
                            dtype=kw["real_t"])
        return pkg.RigidBodyFlowInteraction(
            flow_sim=flow_sim, rigid_body=sphere,
            forcing_grid=pkg.SphereForcingGrid(
                rigid_body=sphere, num_forcing_points_along_equator=8),
            virtual_boundary_stiffness_coeff=-5e5,
            virtual_boundary_damping_coeff=-2e2)

    jint = interactor(jm, real_t=jnp.float32)
    port = interactor(tm, real_t=torch.float32, device="cpu")
    np.testing.assert_array_equal(port.position_mismatch.numpy(),
                                  np.asarray(jint.position_mismatch))
    value = np.random.default_rng(7).standard_normal(
        tuple(port.position_mismatch.shape))
    jint.position_mismatch = value
    port.position_mismatch = value
    assert port.position_mismatch.dtype == torch.float32
    assert port.state.position_mismatch is port.position_mismatch
    np.testing.assert_array_equal(port.position_mismatch.numpy(),
                                  np.asarray(jint.position_mismatch))
