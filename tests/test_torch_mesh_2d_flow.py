"""The port's 2D flow, IBM and FSI steps on an in-process (py, px) mesh
against the JAX package's meshless runs of the same cases (the JAX tests
hold its mesh runs to its meshless ones): the simulator of all three flow
types, the dense cylinder interaction, the fused cylinder and 2D rod
cases, a JAX carry converted onto a mesh, field IO and checkpoints of a 2D
mesh, and the collectives a step makes.

Inputs are made from a seed with numpy or by the cases themselves; float64
throughout. Tolerances: ``1e-9 max(1, |ref|max)`` for the steps (as the
single-device FSI tests'), ``1e-10`` absolute for the interaction (JAX
``test_immersed_body_interaction.py::test_interaction_sharded_matches_single``);
file round trips exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.models as jm
from sopht_mpi_tpu.ops import poisson as jax_poisson
from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu.utils import io as jax_io
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch import models as tm
from sopht_mpi_tpu_torch.convert import (
    flow_state_from_numpy,
    rigid_fsi_carry_from_numpy,
    rod_fsi_carry_from_numpy,
)
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.fft import unshard_fourier
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_scalar_field,
    shard_vector_field,
    unshard_scalar_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import CarryCheckpointer
from sopht_mpi_tpu_torch.utils.io import FieldBinding, FieldIO

TOL = 1e-9
MESHES = [(8, 1), (4, 2)]
GRID = (32, 64)
N_STEPS = 3


def _close(out, ref, tol, what, scaled=True):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0))) if scaled else 1.0
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _assembled(field, mesh):
    return (unshard_vector_field if field.ndim == 5
            else unshard_scalar_field)(field, mesh)


def _mesh(shape):
    return create_mesh(2, shape, device="cpu")


# -- the simulator -----------------------------------------------------------


FLOW_TYPES = ["passive_scalar", "navier_stokes", "navier_stokes_with_forcing"]


def _flow_inputs(flow_type):
    rng = np.random.default_rng(FLOW_TYPES.index(flow_type))
    y, x = np.meshgrid(np.linspace(0, 1, GRID[0]), np.linspace(0, 2, GRID[1]),
                       indexing="ij")
    blob = np.exp(-((x - 0.7) ** 2 + (y - 0.5) ** 2) / 0.02)
    fields = {
        "primary": blob + 0.01 * rng.standard_normal(GRID),
        "velocity": 0.5 + 0.1 * rng.standard_normal((2, *GRID)),
        "forcing": (rng.standard_normal((2, *GRID))
                    if flow_type == "navier_stokes_with_forcing" else None),
    }
    return fields, flow_type != "passive_scalar"


def _jax_flow(flow_type, dt=2e-3):
    fields, free_stream = _flow_inputs(flow_type)
    sim = jm.UnboundedFlowSimulator2D(
        GRID, 2.0, 1e-3, flow_type=flow_type, real_t=jnp.float64,
        with_free_stream_flow=free_stream)
    sim.primary_scalar_field = jnp.asarray(fields["primary"])
    sim.velocity_field = jnp.asarray(fields["velocity"])
    if fields["forcing"] is not None:
        sim.eul_grid_forcing_field = jnp.asarray(fields["forcing"])
    for _ in range(2):
        sim.time_step(dt, free_stream_velocity=(0.3, -0.2))
    return (np.asarray(sim.primary_scalar_field),
            np.asarray(sim.velocity_field), sim.compute_stable_timestep(
                precision="double"))


@pytest.fixture(scope="module")
def jax_flows():
    return {flow_type: _jax_flow(flow_type) for flow_type in FLOW_TYPES}


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("flow_type", FLOW_TYPES)
def test_simulator_on_a_mesh_matches_jax(jax_flows, flow_type, mesh_shape):
    """Two steps of ``UnboundedFlowSimulator2D(mesh=)`` from sharded seeded
    fields against the JAX simulator's meshless steps, and the stable
    timestep from the maximum over the shards."""
    mesh = _mesh(mesh_shape)
    fields, free_stream = _flow_inputs(flow_type)
    sim = tm.UnboundedFlowSimulator2D(
        GRID, 2.0, 1e-3, flow_type=flow_type, real_t=torch.float64,
        with_free_stream_flow=free_stream, device="cpu", mesh=mesh)
    assert sim.mesh is mesh
    assert sim.position_field.shape == (*mesh_shape, 2, GRID[0] //
                                        mesh_shape[0], GRID[1] // mesh_shape[1])
    sim.primary_scalar_field = shard_scalar_field(
        torch.tensor(fields["primary"]), mesh)
    sim.velocity_field = shard_vector_field(torch.tensor(fields["velocity"]),
                                            mesh)
    if fields["forcing"] is not None:
        sim.eul_grid_forcing_field = shard_vector_field(
            torch.tensor(fields["forcing"]), mesh)
    for _ in range(2):
        sim.time_step(2e-3, free_stream_velocity=(0.3, -0.2))
    primary, velocity, dt = jax_flows[flow_type]
    _close(_assembled(sim.primary_scalar_field, mesh), primary, TOL,
           "primary")
    _close(_assembled(sim.velocity_field, mesh), velocity, TOL, "velocity")
    assert sim.compute_stable_timestep(precision="double") == pytest.approx(
        float(dt), rel=1e-12)


def test_simulator_refuses_a_mesh_it_cannot_take():
    common = dict(grid_size=GRID, x_range=2.0, kinematic_viscosity=1e-3,
                  device="cpu")
    with pytest.raises(ValueError, match="create_mesh"):
        tm.UnboundedFlowSimulator2D(**common,
                                    mesh=create_mesh(3, (2, 1), device="cpu"))
    with pytest.raises(RuntimeError, match="divisible"):
        tm.UnboundedFlowSimulator2D(**common, mesh=_mesh((3, 1)))
    one = tm.UnboundedFlowSimulator2D(**common, mesh=_mesh((1, 1)))
    assert one.mesh is None and one.primary_scalar_field.shape == GRID


# -- the dense interaction ---------------------------------------------------


def _interaction_case(models, mesh=None, **kw):
    """JAX ``test_immersed_body_interaction.py``'s cylinder case at
    (32, 64)."""
    dtype = kw.pop("dtype")
    sim = models.UnboundedFlowSimulator2D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-4,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=dtype, mesh=mesh, **kw)
    cyl = models.Cylinder(center=(0.2, 0.25), radius=0.05, dtype=dtype, **kw)
    interactor = models.RigidBodyFlowInteraction(
        sim, cyl, models.CircularCylinderForcingGrid(cyl, 30),
        virtual_boundary_stiffness_coeff=-1e4,
        virtual_boundary_damping_coeff=-10.0)
    return sim, interactor


@pytest.fixture(scope="module")
def jax_interaction():
    sim, interactor = _interaction_case(jm, dtype=jnp.float64)
    sim.velocity_field = sim.velocity_field.at[0].set(1.0)
    for _ in range(5):
        interactor.time_step(dt=1e-4)
        interactor()
        sim.time_step(dt=1e-4, free_stream_velocity=(1.0, 0.0))
    return (np.asarray(sim.vorticity_field),
            np.asarray(interactor.global_lag_grid_forcing_field))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_dense_interaction_on_a_mesh_matches_jax(jax_interaction, mesh_shape):
    """The host loop's interaction on a mesh (interpolation and spreading on
    the assembled fields: one counted ``apply_assembled`` a call) against
    the JAX meshless run, 5 steps."""
    mesh = _mesh(mesh_shape)
    sim, interactor = _interaction_case(tm, mesh, dtype=torch.float64,
                                        device="cpu")
    velocity = unshard_vector_field(sim.velocity_field, mesh).clone()
    velocity[0] = 1.0
    sim.velocity_field = shard_vector_field(velocity, mesh)
    for _ in range(5):
        interactor.time_step(dt=1e-4)
        collectives.reset_counts()
        interactor()
        assert collectives.counts()["apply_assembled"] == 1
        sim.time_step(dt=1e-4, free_stream_velocity=(1.0, 0.0))
    vorticity, lag_forcing = jax_interaction
    _close(unshard_scalar_field(sim.vorticity_field, mesh), vorticity, 1e-10,
           "vorticity", scaled=False)
    _close(interactor.global_lag_grid_forcing_field, lag_forcing, 1e-10,
           "lag forcing", scaled=False)


# -- the fused cylinder case -------------------------------------------------


def _jax_cylinder(mesh=None):
    """The body of ``examples/2d/flow_past_cylinder.py``'s fused case up to
    its carry, float64, at (32, 64)."""
    real_t, radius = jnp.float64, 0.03
    sim = jm.UnboundedFlowSimulator2D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=radius / 200.0,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=real_t, mesh=mesh)
    cylinder = jm.Cylinder(center=(2.5 * radius, 0.5 * GRID[0] / GRID[1]),
                           radius=radius, dtype=real_t)
    interactor = jm.RigidBodyFlowInteraction(
        sim, cylinder, jm.CircularCylinderForcingGrid(cylinder, 60),
        virtual_boundary_stiffness_coeff=-5e4,
        virtual_boundary_damping_coeff=-20.0)
    step = jm.build_rigid_fsi_step(
        sim, interactor, dt_prefac=1.0,
        free_stream_fn=lambda t: jnp.asarray([1.0, 0.0], real_t))
    return step, jm.init_rigid_fsi_carry(sim, interactor)


@pytest.fixture(scope="module")
def jax_cylinder_run():
    """The JAX meshless carries after 3 and 6 steps, and the lag force sums
    of steps 4-6."""
    step, carry = _jax_cylinder()
    after_3, forces_3 = jm.scan_steps(step, carry, N_STEPS)
    after_6, forces_6 = jm.scan_steps(step, after_3, N_STEPS)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return as_np(after_3), np.asarray(forces_3), as_np(after_6), np.asarray(
        forces_6)


def _close_rigid(carry, forces, ref, ref_forces, mesh):
    flow = carry.flow_state
    _close(_assembled(flow.primary_scalar_field, mesh),
           ref.flow_state.primary_scalar_field, TOL, "vorticity")
    _close(_assembled(flow.velocity_field, mesh),
           ref.flow_state.velocity_field, TOL, "velocity")
    _close(forces, ref_forces, TOL, "lag_force_sum")
    _close(carry.time, ref.time, TOL, "time")
    _close(carry.velocity_l1_max, ref.velocity_l1_max, TOL, "l1")
    _close(carry.vb_state.position_mismatch, ref.vb_state.position_mismatch,
           TOL, "position_mismatch")


@pytest.mark.parametrize("mesh_shape", MESHES + [(2, 4)])
def test_fused_cylinder_on_a_mesh_matches_jax(jax_cylinder_run, mesh_shape):
    """3 fused steps of ``cases._build_cylinder_fsi_case(mesh=)`` from rest
    against the JAX case's meshless steps, with the collectives a step
    makes: the halo exchanges of the forcing curl, advection, diffusion and
    velocity curl (two ``ppermute`` a sharded axis each), the solve's
    transposes, one ``pmax`` and two ``apply_assembled`` (the interaction
    and the sponge)."""
    mesh = _mesh(mesh_shape)
    step, (carry,) = cases._build_cylinder_fsi_case(
        GRID, device="cpu", precision="double", mesh=mesh)
    py, px = mesh_shape
    assert carry.flow_state.primary_scalar_field.shape == (
        py, px, GRID[0] // py, GRID[1] // px)
    collectives.reset_counts()
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    assert collectives.counts() == {
        "ppermute": N_STEPS * 4 * 2 * ((py > 1) + (px > 1)),
        "all_to_all": N_STEPS * (2 * (py > 1) + 4 * (px > 1)),
        "pmax": N_STEPS, "psum": 0, "apply_assembled": 2 * N_STEPS}
    ref, ref_forces = jax_cylinder_run[:2]
    _close_rigid(final, forces, ref, ref_forces, mesh)


def test_converted_jax_carry_steps_on_a_mesh(jax_cylinder_run):
    """The JAX carry after 3 steps, its Green's function that of the JAX
    solver on the (4, 2) mesh (global, as ``np.asarray`` gives a mesh
    carry's arrays), converted onto the port's (4, 2) mesh with
    ``rigid_fsi_carry_from_numpy(mesh=)``: 3 more steps match the JAX
    meshless run's, and ``flow_state_from_numpy`` shards a 2D state."""
    mesh_shape = (4, 2)
    mesh = _mesh(mesh_shape)
    jsolver = jax_poisson.UnboundedPoissonSolver2D(
        *GRID, real_t=jnp.float64, mesh=jax_mesh.create_mesh(2, mesh_shape))
    start = jax_cylinder_run[0]._replace(
        greens=np.asarray(jsolver.fourier_greens_times_dx_pow_dim))
    carry = rigid_fsi_carry_from_numpy(start, device="cpu",
                                       dtype=torch.float64, mesh=mesh)
    step, (own,) = cases._build_cylinder_fsi_case(
        GRID, device="cpu", precision="double", mesh=mesh)
    _close(unshard_fourier(carry.greens, mesh), unshard_fourier(own.greens,
           mesh), 1e-12, "greens", scaled=False)
    assert carry.flow_state.velocity_field.shape == (4, 2, 2, 8, 32)
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    _close_rigid(final, forces, *jax_cylinder_run[2:], mesh)
    state = flow_state_from_numpy(
        {"primary_scalar_field": start.flow_state.primary_scalar_field,
         "velocity_field": start.flow_state.velocity_field,
         "eul_grid_forcing_field": None},
        device="cpu", dtype=torch.float64, mesh=mesh)
    assert state.primary_scalar_field.shape == (4, 2, 8, 32)
    assert state.eul_grid_forcing_field is None
    _close(unshard_scalar_field(state.primary_scalar_field, mesh),
           start.flow_state.primary_scalar_field, 0.0, "state")
    with pytest.raises(ValueError, match="3D mesh"):
        flow_state_from_numpy(start.flow_state, device="cpu",
                              dtype=torch.float64,
                              mesh=create_mesh(3, (2, 1), device="cpu"))


# -- the 2D rod case ---------------------------------------------------------


def _jax_rod_2d():
    """The fused branch of ``examples/2d/flow_past_rod.py`` at (32, 64),
    float64 flow and rod."""
    real_t = jnp.float64
    y_range = GRID[0] / GRID[1] * 6.0
    collection = jm.BaseSystemCollection()
    n_elem = GRID[1] // 8
    radius = 0.01
    youngs = 1.5e-3 / (np.pi / 4 * radius**4)
    rod = jm.CosseratRod.straight_rod(
        n_elem, np.array([1.0, 0.501 * y_range, 0.0]),
        np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0]), 1.0, radius,
        1.5 / (np.pi * radius**2), youngs_modulus=youngs,
        shear_modulus=youngs / 1.5)
    collection.append(rod)
    collection.constrain(rod).using(
        jm.OneEndFixedBC, constrained_position_idx=(0,),
        constrained_director_idx=(0,))
    collection.add_forcing_to(rod).using(
        jm.GravityForces, acc_gravity=np.array([0.5, 0.0, 0.0]))
    rod_dt = 0.01 / n_elem
    collection.dampen(rod).using(
        jm.AnalyticalLinearDamper, damping_constant=0.5e-3, time_step=rod_dt)
    sim = jm.UnboundedFlowSimulator2D(
        grid_size=GRID, x_range=6.0, kinematic_viscosity=1.0 / 200,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=real_t)
    interactor = jm.CosseratRodFlowInteraction(
        flow_sim=sim, cosserat_rod=rod, virtual_boundary_stiffness_coeff=-8e4,
        virtual_boundary_damping_coeff=-30.0,
        forcing_grid_cls=jm.CosseratRodElementCentricForcingGrid)
    collection.finalize()

    def free_stream(t):
        ramp = jnp.exp(-t)
        return jnp.asarray([1.0 - ramp, 0.5 * ramp], real_t)

    step = jm.build_rod_fsi_step(sim, interactor, collection, dt_prefac=0.5,
                                 free_stream_fn=free_stream, rod_dt=rod_dt)
    return step, jm.init_rod_fsi_carry(sim, interactor, rod)


@pytest.fixture(scope="module")
def jax_rod_run():
    step, carry = _jax_rod_2d()
    final, forces = jm.scan_steps(step, carry, 2)
    return jax.tree_util.tree_map(np.asarray, final), np.asarray(forces)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_rod_2d_on_a_mesh_matches_jax(jax_rod_run, mesh_shape):
    """2 fused steps of ``cases.flow_past_rod_2d_case(mesh=)`` (dynamic
    substeps, each substep's loads through one ``apply_assembled``) against
    the JAX case's meshless steps; the carry converts onto the mesh."""
    mesh = _mesh(mesh_shape)
    step, carry, _ = cases.flow_past_rod_2d_case(
        GRID, device="cpu", precision="double", mesh=mesh)
    collectives.reset_counts()
    final, forces = tm.scan_steps(step, carry, 2)
    assert collectives.counts()["apply_assembled"] == (
        step.stats["substeps"] + 2 * 2)
    ref, ref_forces = jax_rod_run
    _close(_assembled(final.flow_state.primary_scalar_field, mesh),
           ref.flow_state.primary_scalar_field, TOL, "vorticity")
    _close(_assembled(final.flow_state.velocity_field, mesh),
           ref.flow_state.velocity_field, TOL, "velocity")
    for what in ("position", "velocity", "omega"):
        _close(getattr(final.rod_state, what), getattr(ref.rod_state, what),
               TOL, f"rod {what}")
    _close(forces, ref_forces, TOL, "lag_force_sum")
    # the JAX carry with the mesh's Green's function in the global Fourier
    # layout converts onto the mesh: the port's own carry, field for field
    converted = rod_fsi_carry_from_numpy(
        ref._replace(greens=unshard_fourier(final.greens, mesh).numpy()),
        device="cpu", dtype=torch.float64, mesh=mesh)
    assert torch.equal(converted.greens, final.greens)
    _close(_assembled(converted.flow_state.velocity_field, mesh),
           ref.flow_state.velocity_field, 0.0, "converted velocity")
    assert converted.flow_state.velocity_field.shape == (
        final.flow_state.velocity_field.shape)


# -- IO and checkpoints ------------------------------------------------------


class Holder:
    pass


def _grid_io(io_cls):
    io = io_cls(dim=2, real_dtype=np.float64)
    io.define_eulerian_grid(origin=np.zeros(2), dx=np.full(2, 0.1),
                            grid_size=np.array(GRID))
    return io


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_field_io_on_a_2d_mesh(tmp_path, mesh_shape):
    """``FieldIO`` on a 2D mesh simulator's fields: the assembled save
    loads back sharded, and the per-shard dump (shard (i, j) of ("y", "x")
    as ``shard_d<i px + j>``) reads in the JAX package's ``FieldIO`` on the
    same mesh, and back."""
    pytest.importorskip("h5py")
    mesh = _mesh(mesh_shape)
    sim = tm.UnboundedFlowSimulator2D(
        GRID, 1.0, 1e-3, flow_type="navier_stokes", real_t=torch.float64,
        device="cpu", mesh=mesh)
    rng = np.random.default_rng(4)
    vorticity = rng.standard_normal(GRID)
    velocity = rng.standard_normal((2, *GRID))
    sim.vorticity_field = shard_scalar_field(torch.tensor(vorticity), mesh)
    sim.velocity_field = shard_vector_field(torch.tensor(velocity), mesh)
    kept = sim.vorticity_field.clone(), sim.velocity_field.clone()
    io = _grid_io(FieldIO)
    io.add_as_eulerian_fields_for_io(
        vorticity=FieldBinding(sim, "vorticity_field"),
        velocity=FieldBinding(sim, "velocity_field"))
    f = str(tmp_path / "flow.h5")
    io.save(f, time=1.0)
    sim.vorticity_field = torch.zeros_like(kept[0])
    sim.velocity_field = torch.zeros_like(kept[1])
    assert io.load(f) == 1.0
    assert torch.equal(sim.vorticity_field, kept[0])
    assert torch.equal(sim.velocity_field, kept[1])

    base = str(tmp_path / "port")
    io.save_eulerian_sharded(base, time=2.0)
    import h5py

    py, px = mesh_shape
    nyl, nxl = GRID[0] // py, GRID[1] // px
    with h5py.File(base + ".proc0.h5", "r") as h5:
        for i in range(py):
            for j in range(px):
                d = h5["vorticity"][f"shard_d{i * px + j}"]
                assert tuple(d.attrs["start"]) == (i * nyl, j * nxl)
    jmesh = jax_mesh.create_mesh(2, mesh_shape)
    jx = Holder()
    jx.vorticity = jax_mesh.shard_scalar_field(jnp.zeros(GRID), jmesh)
    jx.velocity = jax_mesh.shard_vector_field(jnp.zeros((2, *GRID)), jmesh)
    jio = _grid_io(jax_io.FieldIO)
    jio.add_as_eulerian_fields_for_io(
        vorticity=jax_io.FieldBinding(jx, "vorticity"),
        velocity=jax_io.FieldBinding(jx, "velocity"))
    assert jio.load_eulerian_sharded(base) == pytest.approx(2.0)
    np.testing.assert_array_equal(np.asarray(jx.vorticity), vorticity)
    np.testing.assert_array_equal(np.asarray(jx.velocity), velocity)
    jx.vorticity = jax_mesh.shard_scalar_field(jnp.asarray(-vorticity), jmesh)
    jio.save_eulerian_sharded(str(tmp_path / "jax"), time=3.0)
    assert io.load_eulerian_sharded(str(tmp_path / "jax")) == 3.0
    np.testing.assert_array_equal(
        unshard_scalar_field(sim.vorticity_field, mesh).numpy(), -vorticity)


def test_checkpoint_of_a_2d_mesh_carry_resumes_bit_equal(tmp_path):
    """2 cylinder steps on the (2, 2) mesh, a checkpoint, a restore into
    the structure of the carry, 2 more steps: bit-equal to 4 straight
    steps."""
    mesh = _mesh((2, 2))
    step, (carry0,) = cases._build_cylinder_fsi_case(
        GRID, device="cpu", precision="double", mesh=mesh)
    ref, _ = tm.scan_steps(step, carry0, 4)
    mid, _ = tm.scan_steps(step, carry0, 2)
    ckpt = CarryCheckpointer(str(tmp_path / "ckpts"))
    ckpt.save(2, mid, wait=True)
    restored = ckpt.restore(template=carry0)
    ckpt.close()
    assert (restored.flow_state.primary_scalar_field.shape
            == mid.flow_state.primary_scalar_field.shape)
    out, _ = tm.scan_steps(step, restored, 2)
    for name in ("primary_scalar_field", "velocity_field"):
        assert torch.equal(getattr(out.flow_state, name),
                           getattr(ref.flow_state, name))


def test_lamb_oseen_on_a_mesh_matches_one_device():
    """``cases.lamb_oseen_vortex_case(mesh=)`` on the slab and the pencil
    gives one device's errors (float64, 1e-12 relative)."""
    run = dict(grid_size=(32, 32), t_end=1.02, precision="double",
               device="cpu")
    ref = cases.lamb_oseen_vortex_case(**run)
    for shape in [(4, 1), (2, 2)]:
        out = cases.lamb_oseen_vortex_case(**run, mesh=_mesh(shape))
        assert out == pytest.approx(ref, rel=1e-12)
