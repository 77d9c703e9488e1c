"""The port's rigid, rod and multi-body FSI steps on an in-process mesh
against the JAX package's steps on the same mesh of its virtual CPU
devices, and against the port's own single-device steps.

The rigid case starts from a JAX carry taken on the mesh (its seeded
vorticity), converted with ``rigid_fsi_carry_from_numpy(mesh=...)``; the
rod and multi-body cases start from the same deterministic state in both
packages. The port's simulators run with ``use_kernels=True``: the sharded
wrappers exchange the halos and run their per-shard plain versions on the
CPU. Float64, 3 steps; tolerance ``1e-9 max(1, |ref|)`` against the JAX
package (the FSI tests' float64 gate), ``1e-12`` between the port's sparse
and dense paths on one mesh and between the mesh and one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.models as jm
import sopht_mpi_tpu_torch.models as tm
from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.convert import rigid_fsi_carry_from_numpy
from sopht_mpi_tpu_torch.models import fsi
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import create_mesh, unshard_vector_field

GRID = (24, 24, 32)
N_STEPS = 3
TOL_JAX = 1e-9
TOL_SELF = 1e-12


def _close(out, ref, tol, what):
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else out
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _meshes(shape):
    if shape is None:
        return None, None
    return jax_mesh.create_mesh(3, shape), create_mesh(3, shape, device="cpu")


def _sim(pkg, mesh):
    is_jax = pkg is jm
    kw = ({"real_t": jnp.float64} if is_jax else
          {"real_t": torch.float64, "device": "cpu", "use_kernels": True})
    return pkg.UnboundedFlowSimulator3D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        mesh=mesh, **kw)


def _fsv(pkg):
    if pkg is jm:
        return jnp.asarray([1.0, 0.0, 0.0], jnp.float64)
    return torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)


def _rod(pkg, flow_sim):
    dev = {} if pkg is jm else {"device": "cpu"}
    rod = pkg.CosseratRod.straight_rod(
        5, np.array([0.3, 0.4, 0.6]), np.array([0.0, 0.0, -1.0]),
        np.array([0.0, 1.0, 0.0]), base_length=0.25, base_radius=0.02,
        density=1e3, youngs_modulus=1e5, shear_modulus=1e5 / 1.5, **dev)
    collection = pkg.BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        pkg.OneEndFixedBC, constrained_position_idx=(0,),
        constrained_director_idx=(0,))
    collection.finalize()
    interactor = pkg.CosseratRodFlowInteraction(
        flow_sim=flow_sim, cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=pkg.CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=4)
    return rod, collection, interactor


def _sphere(pkg, flow_sim, center=(0.7, 0.45, 0.4), radius=0.1):
    is_jax = pkg is jm
    sphere = pkg.Sphere(
        center=np.array(center), radius=radius,
        dtype=jnp.float64 if is_jax else torch.float64,
        **({} if is_jax else {"device": "cpu"}))
    return pkg.RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=sphere,
        forcing_grid=pkg.SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=12),
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0)


def _rod_case(pkg, mesh, sparse, **step_kwargs):
    flow_sim = _sim(pkg, mesh)
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    rod, collection, interactor = _rod(pkg, flow_sim)
    window = (pkg.suggest_rod_forcing_window(interactor, rod, GRID)
              if sparse else None)
    step = pkg.build_rod_fsi_step(
        flow_sim, interactor, collection, rod_substeps=2, dt_prefac=0.5,
        free_stream_fn=lambda t, v=_fsv(pkg): v,
        sparse_forcing_window=window, **step_kwargs)
    return step, pkg.init_rod_fsi_carry(flow_sim, interactor, rod, step)


def _multibody_case(pkg, mesh, sparse):
    flow_sim = _sim(pkg, mesh)
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    _, collection, rod_interactor = _rod(pkg, flow_sim)
    bodies = (pkg.RodBody(rod_interactor, collection),
              pkg.FixedRigidBody(_sphere(pkg, flow_sim)))
    step = pkg.build_multi_body_fsi_step(
        flow_sim, bodies, dt_prefac=0.5,
        free_stream_fn=lambda t, v=_fsv(pkg): v, substeps=2,
        sparse_forcing=None if sparse else False)
    assert step.uses_sparse_forcing == sparse
    return step, pkg.init_multi_body_fsi_carry(flow_sim, bodies, step)


def _rigid_case(pkg, mesh, sparse):
    flow_sim = _sim(pkg, mesh)
    interactor = _sphere(pkg, flow_sim, center=(0.5, 0.375, 0.375))
    if pkg is jm:
        flow_sim.primary_field = flow_sim.primary_field + 0.1 * (
            jax.random.normal(jax.random.PRNGKey(7),
                              flow_sim.primary_field.shape, jnp.float64))
    step = pkg.build_rigid_fsi_step(
        flow_sim, interactor, dt_prefac=0.5,
        free_stream_fn=lambda t, v=_fsv(pkg): v,
        sparse_forcing=None if sparse else False)
    assert getattr(step, "uses_sparse_forcing", False) == sparse
    return step, pkg.init_rigid_fsi_carry(flow_sim, interactor, step)


def _fields(carry, mesh):
    fs = carry.flow_state
    return [unshard_vector_field(f, mesh)
            for f in (fs.primary_field, fs.velocity_field)]


def _forces(diag, sparse):
    return diag[0] if sparse else diag


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_rigid_steps_on_a_mesh_match_jax(sparse):
    """The sphere from a converted sharded JAX carry on (4, 2)."""
    jmesh, mesh = _meshes((4, 2))
    jstep, jcarry = _rigid_case(jm, jmesh, sparse)
    step, _ = _rigid_case(tm, mesh, sparse)
    carry = rigid_fsi_carry_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcarry), device="cpu",
        dtype=torch.float64, mesh=mesh)
    assert carry.flow_state.primary_field.shape == (4, 2, 3, 6, 12, 32)
    jfinal, jforces = jm.scan_steps(jstep, jcarry, N_STEPS)
    collectives.reset_counts()
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    counts = collectives.counts()
    for out, ref, what in zip(_fields(final, mesh),
                              (jfinal.flow_state.primary_field,
                               jfinal.flow_state.velocity_field),
                              ("vorticity", "velocity")):
        _close(out, ref, TOL_JAX, what)
    _close(forces, jforces, TOL_JAX, "lag force sums")
    _close(final.vb_state.position_mismatch,
           jfinal.vb_state.position_mismatch, TOL_JAX, "position mismatch")
    _close(final.velocity_l1_max, jfinal.velocity_l1_max, TOL_JAX, "l1")
    # the windowed E->L is one psum a step and nothing is assembled; the
    # dense interaction assembles the forcing and the velocity once a step
    assert counts["psum"] == (N_STEPS if sparse else 0)
    assert counts["apply_assembled"] == (0 if sparse else N_STEPS)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 2)])
def test_rod_steps_on_a_mesh_match_jax(mesh_shape):
    """The rod's moving sparse window and the dense path on one mesh, each
    against the JAX step on that mesh, and against each other."""
    jmesh, mesh = _meshes(mesh_shape)
    finals = {}
    for sparse in (True, False):
        jstep, jcarry = _rod_case(jm, jmesh, sparse)
        step, carry = _rod_case(tm, mesh, sparse)
        assert not step.gather_substeps
        jfinal, jdiag = jm.scan_steps(jstep, jcarry, N_STEPS)
        final, diag = tm.scan_steps(step, carry, N_STEPS)
        if sparse:
            assert bool(diag[1].all())
        w, u = _fields(final, mesh)
        _close(w, jfinal.flow_state.primary_field, TOL_JAX, "vorticity")
        _close(u, jfinal.flow_state.velocity_field, TOL_JAX, "velocity")
        _close(final.rod_state.position, jfinal.rod_state.position, TOL_JAX,
               "rod position")
        _close(_forces(diag, sparse), _forces(jdiag, sparse), TOL_JAX,
               "lag force sums")
        finals[sparse] = (w, final.rod_state.position)
    for a, b in zip(finals[True], finals[False]):
        _close(a, b, TOL_SELF, "sparse against dense")


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_multi_body_steps_on_a_mesh_match_jax(sparse):
    """A rod and a fixed sphere on (4, 2), against JAX and against the
    port's single-device step."""
    jmesh, mesh = _meshes((4, 2))
    jstep, jcarry = _multibody_case(jm, jmesh, sparse)
    step, carry = _multibody_case(tm, mesh, sparse)
    jfinal, jdiag = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, diag = tm.scan_steps(step, carry, N_STEPS)
    w, u = _fields(final, mesh)
    _close(w, jfinal.flow_state.primary_field, TOL_JAX, "vorticity")
    _close(u, jfinal.flow_state.velocity_field, TOL_JAX, "velocity")
    _close(final.body_states[0].position, jfinal.body_states[0].position,
           TOL_JAX, "rod position")
    for out, ref in zip(_forces(diag, sparse), _forces(jdiag, sparse)):
        _close(out, ref, TOL_JAX, "lag force sums")
    one_step, one_carry = _multibody_case(tm, None, sparse)
    one, _ = tm.scan_steps(one_step, one_carry, N_STEPS)
    _close(w, one.flow_state.primary_field, TOL_SELF, "against one device")
    # the carry's placeholder forcing leaf is sharded like a field
    if sparse:
        assert carry.flow_state.eul_grid_forcing_field.shape == (
            4, 2, 3, 0, 0, 0)


def test_sparse_step_collectives_on_a_mesh():
    """The sparse sphere step on (2, 2): its flow step's exchanges and
    transposes, one ``pmax``, one ``psum`` (the windowed E->L), no
    assembled-field call; the windowed add moves nothing."""
    mesh = create_mesh(3, (2, 2), device="cpu")
    step, (carry,) = cases._build_fsi_case(
        (32, 32, 32), device="cpu", precision="double", mesh=mesh,
        sim_kwargs={"use_kernels": True})
    assert step.uses_sparse_forcing
    collectives.reset_counts()
    tm.scan_steps(step, carry, 2)
    assert collectives.counts() == {
        "ppermute": 2 * 16, "all_to_all": 2 * 4, "pmax": 2, "psum": 2,
        "apply_assembled": 0}
    dense, (carry,) = cases._build_fsi_case(
        (32, 32, 32), device="cpu", precision="double", mesh=mesh,
        sparse_forcing=False, sim_kwargs={"use_kernels": True})
    collectives.reset_counts()
    tm.scan_steps(dense, carry, 2)
    # the forcing curl's 4 exchanges, and the interaction on the assembled
    # fields once a step
    assert collectives.counts() == {
        "ppermute": 2 * 20, "all_to_all": 2 * 4, "pmax": 2, "psum": 0,
        "apply_assembled": 2}


def test_substep_interp_rules_on_a_mesh():
    """``"gather"`` is refused on a mesh, as in the JAX package; ``"auto"``
    keeps the windowed matmul there whatever the window's size."""
    _, mesh = _meshes((2, 2))
    with pytest.raises(ValueError, match="unsharded simulator"):
        _rod_case(tm, mesh, True, substep_interp="gather")
    with pytest.raises(ValueError, match="unsharded simulator"):
        flow_sim = _sim(tm, mesh)
        _, collection, interactor = _rod(tm, flow_sim)
        tm.build_multi_body_fsi_step(
            flow_sim, (tm.RodBody(interactor, collection),), substeps=1,
            substep_interp="gather")
    cells = fsi._GATHER_SUBSTEP_WINDOW_CELLS
    try:
        fsi._GATHER_SUBSTEP_WINDOW_CELLS = 1
        step, _ = _rod_case(tm, mesh, True)
        assert not step.gather_substeps
        one, _ = _rod_case(tm, None, True)
        assert one.gather_substeps
    finally:
        fsi._GATHER_SUBSTEP_WINDOW_CELLS = cells


def test_dryrun_multichip_on_the_cpu():
    """All eight rows of the multi-device gate on an in-process (4, 2)
    mesh, at the JAX function's tolerances."""
    rows = cases.dryrun_multichip((4, 2), device="cpu")
    assert [r[0] for r in rows] == [
        "rigid-sphere FSI x3", "rod FSI x3 (vorticity)", "rod FSI x3 (tip)",
        "rod sparse-vs-dense (mesh)", "rod sparse-vs-dense (tip)",
        "multi-body FSI x2", "checkpoint-restart x(2+2)",
        "sharded kernel fork x1"]
    assert all(ok for *_, ok in rows)
    assert rows[6][1] == 0.0  # the restart is bit-exact
