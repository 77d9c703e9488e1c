"""The port's 3D flow step on an in-process (pz, py) mesh against the JAX
simulator on the same mesh of its eight virtual CPU devices
(``use_pallas=True``: the sharded Pallas stencils in interpret mode), and
against the port's own single-device simulator, with the halo exchanges,
transposes and assembled-field calls of a step pinned.

On the CPU the port's sharded wrappers exchange the halos and run the
per-shard computation in plain PyTorch. Tolerance: float32
``2e-5 max(1, |ref|max)`` after two steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.models import UnboundedFlowSimulator3D as JaxSim
from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.convert import flow_state_from_numpy
from sopht_mpi_tpu_torch.models import (
    ImmersedBodyFlowInteraction,
    Sphere,
    SphereForcingGrid,
    scan_steps,
)
from sopht_mpi_tpu_torch.models.flow.simulator_3d import (
    UnboundedFlowSimulator3D,
    compute_stable_timestep_3d,
)
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)

GRID = (16, 32, 128)
FSV = (1.0, 0.5, 0.0)
DT = 1e-3
TOL = 2e-5


def _close(out, ref, what, tol=TOL):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = ref.numpy() if torch.is_tensor(ref) else np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out.astype(np.float64) - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _state(grid=GRID, seed=11):
    rng = np.random.default_rng(seed)
    vort = (0.1 * rng.standard_normal((3, *grid))).astype(np.float32)
    forcing = (0.05 * rng.standard_normal((3, *grid))).astype(np.float32)
    return vort, forcing


def _common(flow_type, grid=GRID, **extra):
    return dict(grid_size=grid, x_range=1.0, kinematic_viscosity=1e-3,
                flow_type=flow_type, with_free_stream_flow=True, **extra)


def _port_run(flow_type, mesh_shape, vort, forcing, *, steps=2, grid=GRID,
              use_kernels=True, **extra):
    """``steps`` steps of the port's simulator on ``mesh_shape`` (None: one
    device); returns (vorticity, velocity) assembled, and the collectives
    counted over the steps."""
    mesh = (None if mesh_shape is None
            else create_mesh(3, mesh_shape, device="cpu"))
    sim = UnboundedFlowSimulator3D(
        **_common(flow_type, grid, **extra), real_t=torch.float32,
        device="cpu", mesh=mesh, use_kernels=use_kernels)
    with_forcing = flow_type == "navier_stokes_with_forcing"
    sim._set_state(flow_state_from_numpy(
        (vort, np.zeros_like(vort), forcing if with_forcing else None),
        device="cpu", dtype=torch.float32, mesh=mesh))
    collectives.reset_counts()
    for _ in range(steps):
        if with_forcing:
            sim.eul_grid_forcing_field = shard_vector_field(
                torch.tensor(forcing), mesh)
        sim.time_step(DT, free_stream_velocity=FSV)
    counts = collectives.counts()
    if with_forcing:
        assert not sim.eul_grid_forcing_field.any()  # cleared by the step
    return (unshard_vector_field(sim.vorticity_field, mesh),
            unshard_vector_field(sim.velocity_field, mesh)), counts


def _jax_run(flow_type, mesh_shape, vort, forcing, *, steps=2, **extra):
    jmesh = jax_mesh.create_mesh(3, mesh_shape)
    jsim = JaxSim(**_common(flow_type, **extra), real_t=jnp.float32,
                  mesh=jmesh, use_pallas=True)
    jsim.primary_field = jax_mesh.shard_vector_field(jnp.asarray(vort), jmesh)
    for _ in range(steps):
        if flow_type == "navier_stokes_with_forcing":
            jsim.eul_grid_forcing_field = jax_mesh.shard_vector_field(
                jnp.asarray(forcing), jmesh)
        jsim.time_step(DT, free_stream_velocity=FSV)
    return np.asarray(jsim.primary_field), np.asarray(jsim.velocity_field)


# halo exchanges (ppermute), transposes (all_to_all) and assembled-field
# calls of ONE step of navier_stokes_with_forcing without a filter. Each
# sharded stencil exchanges 2 halos a field along each mesh axis of more
# than one shard: curl of the forcing (1 field), rotational transport (2),
# diffusion (+ sponge) (1), curl of the stream function (1); the batched
# vector solve makes 2 transposes a sharded axis. On (8, 1) a shard holds
# 2 planes, fewer than twice the sponge width, so the sponge runs on the
# assembled field.
COUNTS = {
    (4, 2): {"ppermute": 20, "all_to_all": 4, "pmax": 0, "psum": 0,
             "apply_assembled": 0},
    (8, 1): {"ppermute": 10, "all_to_all": 2, "pmax": 0, "psum": 0,
             "apply_assembled": 1},
}


@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1)])
def test_sharded_forcing_steps_match_jax_and_single_device(mesh_shape):
    vort, forcing = _state()
    flow_type = "navier_stokes_with_forcing"
    (w, u), counts = _port_run(flow_type, mesh_shape, vort, forcing)
    assert counts == {k: 2 * v for k, v in COUNTS[mesh_shape].items()}
    assert not any(fn.launches for fn in sharded.KERNELS)  # CPU tensors
    w_ref, u_ref = _jax_run(flow_type, mesh_shape, vort, forcing)
    _close(w, w_ref, "vorticity against jax")
    _close(u, u_ref, "velocity against jax")
    (w1, u1), counts1 = _port_run(flow_type, None, vort, forcing)
    assert not any(counts1.values())
    _close(w, w1, "vorticity against the single device")
    _close(u, u1, "velocity against the single device")


def test_sharded_navier_stokes_steps_match_jax():
    vort, _ = _state(seed=12)
    (w, u), counts = _port_run("navier_stokes", (4, 2), vort, None)
    # no forcing curl: 4 exchanges a step fewer
    assert counts["ppermute"] == 2 * 16 and counts["all_to_all"] == 2 * 4
    w_ref, u_ref = _jax_run("navier_stokes", (4, 2), vort, None)
    _close(w, w_ref, "vorticity against jax")
    _close(u, u_ref, "velocity against jax")


@pytest.mark.parametrize("mesh_shape,use_kernels,filtered", [
    ((2, 4), True, False), ((2, 2), True, True), ((4, 2), False, False),
    ((2, 2), False, True), ((1, 8), True, False),
], ids=["pencil", "filtered", "plain", "plain-filtered", "y-slab"])
def test_sharded_steps_match_own_single_device(mesh_shape, use_kernels,
                                               filtered):
    """The branches of the mesh step against the port's own single-device
    step: the filter on the assembled field (with the sponge after it),
    and ``use_kernels`` off (the whole transport and the curl assembled)."""
    grid = (16, 32, 24)
    vort, forcing = _state(grid, seed=13)
    flow_type = "navier_stokes_with_forcing"
    extra = dict(filter_vorticity=filtered,
                 filter_setting_dict={"order": 1, "type": "multiplicative"})
    (w, u), counts = _port_run(flow_type, mesh_shape, vort, forcing,
                               grid=grid, use_kernels=use_kernels, **extra)
    (w1, u1), _ = _port_run(flow_type, None, vort, forcing, grid=grid,
                            use_kernels=use_kernels, **extra)
    _close(w, w1, "vorticity")
    _close(u, u1, "velocity")
    sharded_axes = sum(p > 1 for p in mesh_shape)
    assert counts["all_to_all"] == 2 * 2 * sharded_axes
    if use_kernels:
        # the filter and its sponge are one assembled-field call a step
        assert counts["apply_assembled"] == (2 if filtered else 0)
        assert counts["ppermute"] == 2 * 10 * sharded_axes
    else:
        # forcing update, transport, sponge, curl
        assert counts["apply_assembled"] == 2 * 4
        assert counts["ppermute"] == 0


def test_stable_timestep_on_a_sharded_velocity():
    vel = np.random.default_rng(14).standard_normal(
        (3, 8, 16, 12)).astype(np.float32)
    kw = dict(CFL=0.1, dx=1.0 / 12, nu=2e-3, tol=1e-6)
    ref = compute_stable_timestep_3d(torch.tensor(vel), **kw)
    mesh = create_mesh(3, (2, 4), device="cpu")
    collectives.reset_counts()
    out = compute_stable_timestep_3d(
        shard_vector_field(torch.tensor(vel), mesh), **kw, mesh=mesh)
    assert collectives.pmax.calls == 1
    assert out.ndim == 0 and float(out) == float(ref)
    sim = UnboundedFlowSimulator3D(
        grid_size=(8, 16, 12), x_range=1.0, kinematic_viscosity=2e-3,
        flow_type="navier_stokes", device="cpu", mesh=mesh)
    assert sim.mesh is mesh
    assert sim.velocity_field.shape == (2, 4, 3, 4, 4, 12)
    assert sim.position_field.shape == (2, 4, 3, 4, 4, 12)
    sim.velocity_field = shard_vector_field(torch.tensor(vel), mesh)
    # (the simulator's tolerance term differs from the 1e-6 above)
    assert sim.compute_stable_timestep() == pytest.approx(float(ref),
                                                          rel=1e-4)
    # a mesh of one shard is the single-device simulator
    one = UnboundedFlowSimulator3D(
        grid_size=(8, 16, 12), x_range=1.0, kinematic_viscosity=2e-3,
        flow_type="navier_stokes", device="cpu",
        mesh=create_mesh(3, (1, 1), device="cpu"))
    assert one.mesh is None and one.velocity_field.shape == (3, 8, 16, 12)


def test_sharded_flow_case_runs_and_matches_the_single_device_case():
    grid = (16, 16, 32)
    # on the CPU the kernels are off by default; on, the wrappers run their
    # per-shard plain computation on the exchanged halos
    kw = dict(device="cpu", precision="double",
              sim_kwargs={"use_kernels": True})
    step, (carry,) = cases.sharded_flow_case(grid, (2, 2), **kw)
    step1, (carry1,) = cases.sharded_flow_case(grid, None, **kw)
    mesh = step.flow_sim.mesh
    assert carry.flow_state.primary_field.shape == (2, 2, 3, 8, 8, 32)
    assert carry.greens.shape[:2] == (2, 2)
    assert float(carry.flow_state.primary_field.abs().max()) > 1.0
    _close(unshard_vector_field(carry.flow_state.velocity_field, mesh),
           carry1.flow_state.velocity_field, "initial velocity", 1e-10)
    collectives.reset_counts()
    carry, dts = scan_steps(step, carry, 3)
    # the carried max |u|_1 is reduced over the mesh once a step
    assert collectives.counts() == {
        "ppermute": 3 * 20, "all_to_all": 3 * 4, "pmax": 3, "psum": 0,
        "apply_assembled": 0}
    carry1, dts1 = scan_steps(step1, carry1, 3)
    assert dts.shape == (3,) and torch.allclose(dts, dts1, rtol=1e-12)
    for name in ("primary_field", "velocity_field"):
        out = unshard_vector_field(getattr(carry.flow_state, name), mesh)
        assert torch.isfinite(out).all()
        _close(out, getattr(carry1.flow_state, name), name, 1e-10)
    assert float(carry.time) == pytest.approx(float(dts.sum()))


def test_mesh_refusals():
    """An immersed body on a 3D mesh is taken (its interaction reads the
    assembled fields, one counted ``apply_assembled`` a call, and equals
    one device's); a 2D flow state shards over a 2D mesh."""
    vel = np.random.default_rng(15).standard_normal((3, 8, 8, 8))
    interactions = []
    for mesh in (create_mesh(3, (2, 2), device="cpu"), None):
        sim = UnboundedFlowSimulator3D(
            grid_size=(8, 8, 8), x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing", device="cpu", mesh=mesh,
            real_t=torch.float64)
        sim.velocity_field = shard_vector_field(torch.tensor(vel), mesh)
        sphere = Sphere(center=np.array([0.5, 0.5, 0.5]), radius=0.2,
                        device="cpu", dtype=torch.float64)
        interactor = ImmersedBodyFlowInteraction(
            sim, SphereForcingGrid(rigid_body=sphere,
                                   num_forcing_points_along_equator=8),
            -1e3, -1e0)
        collectives.reset_counts()
        interactor()
        assert collectives.counts()["apply_assembled"] == (
            0 if mesh is None else 1)
        interactions.append((
            interactor.global_lag_grid_forcing_field,
            unshard_vector_field(sim.eul_grid_forcing_field, mesh)))
    for out, ref in zip(*interactions):
        assert torch.allclose(out, ref, rtol=0, atol=1e-12)
    # a 2D state shards over a 2D mesh
    state = flow_state_from_numpy(
        {"primary_scalar_field": np.arange(16.0).reshape(4, 4),
         "velocity_field": np.zeros((2, 4, 4)),
         "eul_grid_forcing_field": None},
        device="cpu", dtype=torch.float32,
        mesh=create_mesh(2, (2, 1), device="cpu"))
    assert state.primary_scalar_field.shape == (2, 1, 2, 4)
    assert state.velocity_field.shape == (2, 1, 2, 2, 4)
    assert torch.equal(state.primary_scalar_field[1, 0],
                       torch.arange(8.0, 16.0).reshape(2, 4))


def test_scan_steps_accepts_and_ignores_donate():
    """``donate`` is the JAX package's buffer donation of the carry; the
    port takes the keyword, as the benchmark passes it, and changes
    nothing."""
    step, (carry,) = cases.sharded_flow_case((8, 8, 16), None, device="cpu")
    kept = carry.flow_state.primary_field.clone()
    final, dts = scan_steps(step, carry, 2, donate=True)
    ref, ref_dts = scan_steps(step, carry, 2)
    assert torch.equal(dts, ref_dts)
    assert torch.equal(final.flow_state.primary_field,
                       ref.flow_state.primary_field)
    # the donated carry is still whole
    assert torch.equal(carry.flow_state.primary_field, kept)
    with pytest.raises(TypeError):
        scan_steps(step, carry, 2, True)  # keyword only
