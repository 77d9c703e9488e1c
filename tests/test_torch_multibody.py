"""The port's multi-body FSI step (rods, fixed and dynamic rigid bodies
sharing the forcing) against the JAX package's, on the CPU.

Also holds :func:`write_jax_multibody_reference`, which computes the JAX
trajectory of the multi-body benchmark case that ``chip_smoke.py`` holds
the card's run to.

Tolerances: float64 ``1e-9 max(1, |ref|max)`` after 3 fused steps (as the
rod step's tests); the float32-flow case ``1e-4 max(1, |ref|max)`` (float32
rounding of two differently ordered FFTs through the Poisson solve).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import sopht_mpi_tpu.models as jm
import sopht_mpi_tpu_torch.models as tm
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.convert import multi_body_fsi_carry_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTIBODY_REFERENCE = os.path.join(
    REPO, "sopht_mpi_tpu_torch", "data", "multibody_reference.json"
)
MULTIBODY_REFERENCE_COMMAND = (
    "JAX_PLATFORMS=cpu python -c \"import sys; sys.path[:0] = ['.', 'tests']; "
    "import test_torch_multibody as t; t.write_jax_multibody_reference()\""
)


def jax_multibody_trajectory(grid_size, n_steps):
    """Times, rod tips (node n) and the sphere's summed Lagrangian x-forcing
    after each step of the JAX package's multi-body benchmark case
    (``_build_multibody_bench_case``: float32 flow, exact spectral tier,
    float64 rod, per-body sparse windows), one fused step per call."""
    from sopht_mpi_tpu.models import scan_steps

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    step, (carry,) = jax_entry._build_multibody_bench_case(tuple(grid_size))
    times = [float(carry.time)]
    tips = [np.asarray(carry.body_states[0].position[:, -1]).tolist()]
    forces = [None]
    for _ in range(n_steps):
        carry, (sums, ok) = scan_steps(step, carry, 1)
        assert bool(np.all(np.asarray(ok)))
        times.append(float(carry.time))
        tips.append(np.asarray(carry.body_states[0].position[:, -1]).tolist())
        forces.append(float(np.asarray(sums[1])[0, 0]))
    return times, tips, forces


def write_jax_multibody_reference(grid_size=(64, 64, 128), n_steps=320,
                                  path=MULTIBODY_REFERENCE):
    """Write the JAX trajectory of the multi-body benchmark case as JSON."""
    times, tips, forces = jax_multibody_trajectory(grid_size, n_steps)
    z_range = grid_size[0] / grid_size[2] * 1.8
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "case": "__graft_entry__._build_multibody_bench_case",
            "grid_size": list(grid_size),
            "n_steps": n_steps,
            "precision": "float32 flow, float64 rod (x64), exact tier, CPU",
            "jax_version": jax.__version__,
            "command": MULTIBODY_REFERENCE_COMMAND,
            "rod_length": 0.5 * z_range,
            "times": times,
            "tip": tips,
            "sphere_force_x": forces,
        }, f, indent=None)
        f.write("\n")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

STEP_TOL = {"double": 1e-9, "single": 1e-4}
N_STEPS = 3
GRID = (24, 24, 32)


def _close(out, ref, tol, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _close_carry(carry, jcarry, tol):
    ref = jax.tree_util.tree_map(np.asarray, jcarry)
    for what in ("primary_field", "velocity_field"):
        _close(getattr(carry.flow_state, what),
               getattr(ref.flow_state, what), tol, what)
    for i, (state, jstate) in enumerate(zip(carry.body_states,
                                            ref.body_states)):
        assert (state is None) == (jstate is None)
        if state is None:
            continue
        for what in ("position", "velocity", "director", "omega"):
            _close(getattr(state, what), getattr(jstate, what), tol,
                   f"body {i} {what}")
    for i, (vb, jvb) in enumerate(zip(carry.vb_states, ref.vb_states)):
        _close(vb.position_mismatch, jvb.position_mismatch, tol,
               f"body {i} position_mismatch")
    for i, (prev, jprev) in enumerate(zip(carry.prev_mismatches,
                                          ref.prev_mismatches)):
        assert prev.dtype == {"float64": torch.float64,
                              "float32": torch.float32}[str(jprev.dtype)]
        _close(prev, jprev, tol, f"body {i} prev_mismatch")
    _close(carry.time, ref.time, tol, "time")
    _close(carry.velocity_l1_max, ref.velocity_l1_max, tol, "l1")


def _case(pkg, *, bodies=("rod", "fixed"), **step_kwargs):
    """A float64 case on a (24, 24, 32) grid: a clamped 5-element rod
    hanging in a unit-velocity flow and/or a sphere in its wake, fixed or
    dynamic (density 2, a weak constant load). ``pkg`` is ``jm`` or
    ``tm``; returns (step, carry, bodies)."""
    is_jax = pkg is jm
    real_t = jnp.float64 if is_jax else torch.float64
    kw = {} if is_jax else {"device": "cpu", "use_kernels": True}
    dev = {} if is_jax else {"device": "cpu"}
    flow_sim = pkg.UnboundedFlowSimulator3D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=real_t, **kw,
    )
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    specs = []
    for kind in bodies:
        if kind == "rod":
            rod = pkg.CosseratRod.straight_rod(
                5, np.array([0.3, 0.4, 0.6]), np.array([0.0, 0.0, -1.0]),
                np.array([0.0, 1.0, 0.0]), base_length=0.25,
                base_radius=0.02, density=1e3, youngs_modulus=1e5,
                shear_modulus=1e5 / 1.5, **dev,
            )
            collection = pkg.BaseSystemCollection()
            collection.append(rod)
            collection.constrain(rod).using(
                pkg.OneEndFixedBC, constrained_position_idx=(0,),
                constrained_director_idx=(0,),
            )
            collection.finalize()
            interactor = pkg.CosseratRodFlowInteraction(
                flow_sim=flow_sim, cosserat_rod=rod,
                virtual_boundary_stiffness_coeff=-1e3,
                virtual_boundary_damping_coeff=-1e0,
                forcing_grid_cls=pkg.CosseratRodSurfaceForcingGrid,
                surface_grid_density_for_largest_element=4,
            )
            specs.append(pkg.RodBody(interactor, collection))
            continue
        sphere = pkg.Sphere(
            center=np.array([0.7, 0.45, 0.4]), radius=0.1, dtype=real_t,
            density=None if kind == "fixed" else 2.0, **dev,
        )
        interactor = pkg.RigidBodyFlowInteraction(
            flow_sim=flow_sim, rigid_body=sphere,
            forcing_grid=pkg.SphereForcingGrid(
                rigid_body=sphere, num_forcing_points_along_equator=12),
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
        )
        if kind == "fixed":
            specs.append(pkg.FixedRigidBody(interactor))
        else:
            load = np.array([0.0, 0.0, -0.02])
            spin = np.array([0.001, 0.0, 0.002])
            specs.append(pkg.DynamicRigidBody(
                interactor, sphere, lambda state, t: (load, spin)))
    fsv = (jnp.asarray([1.0, 0.0, 0.0], real_t) if is_jax
           else torch.tensor([1.0, 0.0, 0.0], dtype=real_t))
    step = pkg.build_multi_body_fsi_step(
        flow_sim, specs, dt_prefac=0.5, free_stream_fn=lambda t: fsv,
        **step_kwargs,
    )
    carry = pkg.init_multi_body_fsi_carry(flow_sim, specs, step)
    return step, carry, specs


def _run_both(**kwargs):
    jstep, jcarry, _ = _case(jm, **kwargs)
    step, carry, _ = _case(tm, **kwargs)
    assert step.uses_sparse_forcing == jstep.uses_sparse_forcing
    jfinal, jdiag = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, diag = tm.scan_steps(step, carry, N_STEPS)
    return (final, diag, step), (jfinal, jdiag, jstep)


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("dense-static", {"sparse_forcing": False, "substeps": 2}),
        ("sparse-static", {"substeps": 2}),
        ("dense-dynamic", {"sparse_forcing": False, "sub_dt": 2e-4,
                           "max_substeps": 8}),
        ("sparse-dynamic", {"sub_dt": 2e-4}),
        ("dense-flow-step", {"sparse_forcing": False, "substeps": 2,
                             "substep_load_refresh": "flow_step"}),
        ("sparse-flow-step", {"substeps": 2,
                              "substep_load_refresh": "flow_step"}),
        ("sparse-gather", {"substeps": 2, "substep_interp": "gather"}),
        ("dynamic-sphere-dense", {"bodies": ("dynamic",),
                                  "sparse_forcing": False, "substeps": 2}),
        ("rod-and-dynamic-sphere-sparse", {"bodies": ("rod", "dynamic"),
                                           "substeps": 2}),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_multi_body_steps_match_jax(name, kwargs):
    (final, diag, step), (jfinal, jdiag, _) = _run_both(**kwargs)
    tol = STEP_TOL["double"]
    _close_carry(final, jfinal, tol)
    sparse = kwargs.get("sparse_forcing", None) is not False
    assert step.uses_sparse_forcing == sparse
    if sparse:
        (forces, ok), (jforces, jok) = diag, jdiag
        assert ok.dtype == torch.bool and bool(ok.all())
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    else:
        forces, jforces = diag, jdiag
    assert len(forces) == len(jforces) == len(final.body_states)
    for i, (out, ref) in enumerate(zip(forces, jforces)):
        _close(out, ref, tol, f"body {i} lag_force_sum")
        assert float(out.abs().max()) > 0
    if kwargs.get("substep_load_refresh") == "flow_step":
        for loads, jloads in zip(final.frozen_loads, jfinal.frozen_loads):
            assert (loads is None) == (jloads is None)
            for out, ref in zip(loads or (), jloads or ()):
                _close(out, ref, tol, "frozen loads")
    dynamic = "sub_dt" in kwargs
    assert step.stats["steps"] == N_STEPS
    assert step.stats["host_syncs"] == (N_STEPS if dynamic else 0)
    if dynamic:
        assert step.stats["substeps"] > N_STEPS
    if "dynamic" in kwargs.get("bodies", ()):
        # the dynamic sphere moved under the flow and its loads
        i = kwargs["bodies"].index("dynamic")
        moved = final.body_states[i].position - torch.tensor(
            [0.7, 0.45, 0.4], dtype=torch.float64)
        assert float(moved.abs().max()) > 0


def test_gather_substeps_match_window_mm():
    """Each body's substep E->L through the full-field gather matches the
    windowed matmul to rounding, and ``"auto"`` keeps the matmul for the
    small windows of this case."""
    step, carry, _ = _case(tm, substeps=2, substep_interp="gather")
    assert step.gather_substeps == (True, True)
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    mm_step, mm_carry, _ = _case(tm, substeps=2)
    assert mm_step.gather_substeps == (False, False)
    mm_final, _ = tm.scan_steps(mm_step, mm_carry, N_STEPS)
    as_np = jax.tree_util.tree_map(
        lambda t: t.numpy() if torch.is_tensor(t) else t, mm_final)
    _close_carry(final, as_np, 1e-9)


def test_sparse_carry_drops_forcing_field():
    """``init_multi_body_fsi_carry(step=sparse)`` shrinks the never-read
    full-field forcing leaf to a zero-size placeholder, as the JAX package
    does; without the step the leaf stays full size."""
    jstep, jcarry, _ = _case(jm, substeps=1)
    step, carry, _ = _case(tm, substeps=1)
    assert step.uses_sparse_forcing and jstep.uses_sparse_forcing
    forcing = carry.flow_state.eul_grid_forcing_field
    assert tuple(forcing.shape) == jcarry.flow_state.eul_grid_forcing_field.shape
    assert forcing.numel() == 0
    final, (sums, ok) = tm.scan_steps(step, carry, 2)
    assert bool(ok.all())
    assert bool(torch.isfinite(final.flow_state.primary_field).all())
    assert float(sums[1].abs().max()) > 0


def test_window_sizes_match_jax():
    """Per-body windows: the rod's reach window and the sphere's
    rotation-safe window, as the JAX package sizes them."""
    _, _, jspecs = _case(jm, substeps=1)
    step, _, specs = _case(tm, substeps=1)
    jwindows = (
        jm.suggest_rod_forcing_window(
            jspecs[0].interactor, jspecs[0].rod_collection._systems[0], GRID),
        jm.suggest_rigid_forcing_window(jspecs[1].interactor, GRID),
    )
    assert step.body_windows == jwindows
    assert None not in jwindows
    assert tm.suggest_rigid_forcing_window(
        specs[1].interactor, (16, 16, 16)) is None


def test_argument_errors():
    _, _, specs = _case(tm, substeps=1)
    flow_sim = tm.UnboundedFlowSimulator3D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=torch.float64, device="cpu")
    build = lambda bodies=specs, **kw: tm.build_multi_body_fsi_step(
        flow_sim, bodies, **kw)
    with pytest.raises(ValueError, match="non-empty"):
        build(())
    with pytest.raises(ValueError, match="conflicts"):
        build(substeps=2, sub_dt=1e-4)
    with pytest.raises(ValueError, match="conflicts"):
        build(substeps=2, max_substeps=4)
    with pytest.raises(ValueError, match="substep_interp must be"):
        build(substep_interp="nearest")
    with pytest.raises(ValueError, match="substep_load_refresh"):
        build(substep_load_refresh="never")
    # inert in the JAX package on the dense path; the port refuses
    with pytest.raises(ValueError, match="needs sparse forcing"):
        build(sparse_forcing=False, substep_interp="window_mm")
    fixed_sphere = tm.Sphere(center=np.array([0.7, 0.45, 0.4]), radius=0.1,
                             device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="density"):
        build((tm.DynamicRigidBody(specs[1].interactor, fixed_sphere),))
    plain = tm.UnboundedFlowSimulator3D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes", real_t=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="sparse_forcing=True"):
        tm.build_multi_body_fsi_step(plain, specs, sparse_forcing=True)
    step = build(substeps=1, substep_load_refresh="flow_step")
    carry = tm.init_multi_body_fsi_carry(flow_sim, specs)  # no step
    with pytest.raises(ValueError, match="frozen-loads"):
        step(carry)


def test_multi_body_carry_from_numpy_round_trip():
    """A JAX carry (a rod, a dynamic sphere, frozen loads) carried across
    steps like the port's own: every leaf lands with its value, and one
    step from it matches the JAX step."""
    kw = dict(bodies=("rod", "dynamic"), substeps=2,
              substep_load_refresh="flow_step")
    jstep, jcarry, _ = _case(jm, **kw)
    jcarry, _ = jm.scan_steps(jstep, jcarry, 1)
    step, own, _ = _case(tm, **kw)
    tree = jax.tree_util.tree_map(np.asarray, jcarry)
    carry = multi_body_fsi_carry_from_numpy(tree, device="cpu",
                                            dtype=torch.float64)
    flat = jax.tree_util.tree_leaves(tree)
    ours = jax.tree_util.tree_leaves(
        carry, is_leaf=lambda x: torch.is_tensor(x))
    assert len(ours) == len(flat)
    for o, r in zip(ours, flat):
        assert tuple(o.shape) == r.shape
        _close(o, r, 0.0, "leaf")
    assert isinstance(carry.body_states[1], tm.RigidBodyState)
    assert [None if f is None else [t.dtype for t in f]
            for f in carry.frozen_loads] == [
        None if f is None else [t.dtype for t in f] for f in own.frozen_loads]
    jfinal, _ = jm.scan_steps(jstep, jcarry, 1)
    final, _ = tm.scan_steps(step, carry, 1)
    _close_carry(final, jfinal, STEP_TOL["double"])


def test_multibody_case_matches_jax():
    """The small rod + fixed sphere case (float32 flow, float64 rod, one
    substep a step): 3 steps of what the port builds against what the JAX
    package builds."""
    jstep, jcarry = jax_entry._build_multibody_case(GRID)
    step, carry = cases._build_multibody_case(GRID, device="cpu")
    assert step.uses_sparse_forcing == jstep.uses_sparse_forcing
    assert carry.body_states[0].position.dtype == torch.float64
    assert carry.flow_state.primary_field.dtype == torch.float32
    jfinal, jdiag = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, diag = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal, STEP_TOL["single"])
    if step.uses_sparse_forcing:
        (diag, ok), (jdiag, _) = diag, jdiag
        assert bool(ok.all())
    for out, ref in zip(diag, jdiag):
        _close(out, ref, STEP_TOL["single"], "lag_force_sum")
