"""The port's flexible-rod FSI step against the JAX package's.

Also holds :func:`write_jax_tip_reference`, which computes the JAX tip
trajectory that ``chip_smoke.py`` holds the card's run to.
"""

import json
import os

import numpy as np

import __graft_entry__ as jax_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIP_REFERENCE = os.path.join(
    REPO, "sopht_mpi_tpu_torch", "data", "rod_tip_reference.json"
)
TIP_REFERENCE_COMMAND = (
    "JAX_PLATFORMS=cpu python -c \"import sys; sys.path[:0] = ['.', 'tests']; "
    "import test_torch_rod_fsi as t; t.write_jax_tip_reference()\""
)


def jax_rod_tip_trajectory(grid_size, t_end):
    """Times and tip positions (node n) after each step of the JAX
    package's rod benchmark case (``_build_rod_bench_case``: float32 flow,
    exact spectral tier, float64 rod, sparse window) run to ``t_end``, one
    fused step per call."""
    import jax

    from sopht_mpi_tpu.models import scan_steps

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    step, (carry,) = jax_entry._build_rod_bench_case(tuple(grid_size))
    times = [float(carry.time)]
    tips = [np.asarray(carry.rod_state.position[:, -1]).tolist()]
    while times[-1] < t_end:
        carry, _ = scan_steps(step, carry, 1)
        times.append(float(carry.time))
        tips.append(np.asarray(carry.rod_state.position[:, -1]).tolist())
    return times, tips


def write_jax_tip_reference(grid_size=(128, 32, 128), t_end=0.2,
                            path=TIP_REFERENCE):
    """Write the JAX tip trajectory of the rod benchmark case as JSON."""
    import jax

    times, tips = jax_rod_tip_trajectory(grid_size, t_end)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "case": "__graft_entry__._build_rod_bench_case",
            "grid_size": list(grid_size),
            "t_end": t_end,
            "precision": "float32 flow, float64 rod (x64), exact tier, CPU",
            "jax_version": jax.__version__,
            "command": TIP_REFERENCE_COMMAND,
            "rod_length": 1.0,
            "times": times,
            "tip": tips,
        }, f, indent=None)
        f.write("\n")


# ---------------------------------------------------------------------------
# tests
#
# Tolerances: float64 ``1e-12 max(1, |ref|max)`` for one evaluation and
# ``1e-9 max(1, |ref|max)`` after 3 fused steps; the float32-flow benchmark
# case ``1e-4 max(1, |ref|max)`` after 3 steps (float32 rounding of two
# differently ordered FFTs through the Poisson solve and the penalty force).
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import sopht_mpi_tpu.models as jm  # noqa: E402
import sopht_mpi_tpu_torch.models as tm  # noqa: E402
from sopht_mpi_tpu_torch import cases  # noqa: E402
from sopht_mpi_tpu_torch.convert import (  # noqa: E402
    rod_fsi_carry_from_numpy,
    rod_state_from_numpy,
)
from sopht_mpi_tpu_torch.models import fsi  # noqa: E402

EVAL_TOL = 1e-12
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
    for what in ("position", "velocity", "director", "omega"):
        _close(getattr(carry.rod_state, what), getattr(ref.rod_state, what),
               tol, f"rod {what}")
    _close(carry.vb_state.position_mismatch, ref.vb_state.position_mismatch,
           tol, "position_mismatch")
    _close(carry.time, ref.time, tol, "time")
    _close(carry.velocity_l1_max, ref.velocity_l1_max, tol, "l1")


def _rod_args(pkg_is_jax, n_elem=6, base_radius=0.02):
    return dict(
        n_elements=n_elem, start=np.array([0.5, 0.4, 0.4]),
        direction=np.array([0.0, 1.0, 0.0]), normal=np.array([0.0, 0.0, 1.0]),
        base_length=0.3, base_radius=base_radius, density=1e3,
        youngs_modulus=1e5, shear_modulus=1e5 / 1.5,
        **({} if pkg_is_jax else {"device": "cpu"}),
    )


def _rod_case(pkg, *, sparse=False, flow_forces=False, **step_kwargs):
    """The JAX package's 3D rod-FSI test case (tests/test_models/
    test_fsi_scan.py, the sparse-window setup): float64, a clamped
    6-element rod across a unit-velocity flow on a (24, 24, 32) grid, the
    surface forcing grid. ``pkg`` is ``jm`` or ``tm``; returns (step,
    carry, parts)."""
    is_jax = pkg is jm
    real_t = jnp.float64 if is_jax else torch.float64
    kw = {} if is_jax else {"device": "cpu", "use_kernels": True}
    flow_sim = pkg.UnboundedFlowSimulator3D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=real_t, **kw,
    )
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    rod = pkg.CosseratRod.straight_rod(**_rod_args(is_jax))
    collection = pkg.BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        pkg.OneEndFixedBC, constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    interactor = pkg.CosseratRodFlowInteraction(
        flow_sim=flow_sim, cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=pkg.CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=4,
    )
    parts = (flow_sim, rod, collection, interactor)
    if flow_forces:
        collection.add_forcing_to(rod).using(pkg.FlowForces, interactor)
        collection.finalize()
        return None, None, parts
    collection.finalize()
    window = (pkg.suggest_rod_forcing_window(interactor, rod, GRID)
              if sparse else None)
    assert (window is not None) == sparse
    fsv = (jnp.asarray([1.0, 0.0, 0.0], real_t) if is_jax
           else torch.tensor([1.0, 0.0, 0.0], dtype=real_t))
    step_kwargs.setdefault("rod_substeps", 1)
    step = pkg.build_rod_fsi_step(
        flow_sim, interactor, collection, dt_prefac=0.5,
        free_stream_fn=lambda t: fsv, sparse_forcing_window=window,
        **step_kwargs,
    )
    carry = pkg.init_rod_fsi_carry(flow_sim, interactor, rod, step)
    return step, carry, parts


def _run_both(sparse=False, **step_kwargs):
    jstep, jcarry, _ = _rod_case(jm, sparse=sparse, **step_kwargs)
    step, carry, _ = _rod_case(tm, sparse=sparse, **step_kwargs)
    jfinal, jdiag = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, diag = tm.scan_steps(step, carry, N_STEPS)
    return (final, diag, step), (jfinal, jdiag, jstep)


@pytest.mark.parametrize(
    "name,sparse,step_kwargs",
    [
        ("dense-static", False, {}),
        ("dense-dynamic", False, {"rod_substeps": None, "rod_dt": 2e-4,
                                  "max_rod_substeps": 8}),
        ("sparse", True, {}),
        ("sparse-dynamic", True, {"rod_substeps": None, "rod_dt": 2e-4}),
        ("dense-flow-step", False, {"rod_substeps": 2,
                                    "substep_load_refresh": "flow_step"}),
        ("sparse-flow-step", True, {"rod_substeps": 2,
                                    "substep_load_refresh": "flow_step"}),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_rod_fsi_steps_match_jax(name, sparse, step_kwargs):
    (final, diag, step), (jfinal, jdiag, _) = _run_both(sparse, **step_kwargs)
    tol = STEP_TOL["double"]
    _close_carry(final, jfinal, tol)
    if sparse:
        (forces, ok), (jforces, jok) = diag, jdiag
        assert ok.dtype == torch.bool and bool(ok.all())
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    else:
        forces, jforces = diag, jdiag
    _close(forces, jforces, tol, "lag_force_sum")
    assert float(forces.abs().max()) > 0
    if step_kwargs.get("substep_load_refresh") == "flow_step":
        for out, ref in zip(final.frozen_loads, jfinal.frozen_loads):
            _close(out, ref, tol, "frozen loads")
    dynamic = step_kwargs.get("rod_substeps", 1) is None
    assert step.stats["steps"] == N_STEPS
    assert step.stats["host_syncs"] == (N_STEPS if dynamic else 0)
    if dynamic:
        assert step.stats["substeps"] > N_STEPS  # the case does substep


def _port_sparse_run(**step_kwargs):
    step, carry, _ = _rod_case(tm, sparse=True, **step_kwargs)
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    return step, final


def _as_numpy(carry):
    return jax.tree_util.tree_map(
        lambda t: t.numpy() if torch.is_tensor(t) else t, carry)


def test_substep_interp_gather_matches_window_mm():
    """The substeps' E->L through the full-field gather matches the JAX
    package's gather run, and the windowed-matmul run (the "sparse" case
    above) to rounding."""
    (final, _, step), (jfinal, _, _) = _run_both(True, substep_interp="gather")
    assert step.gather_substeps
    _close_carry(final, jfinal, STEP_TOL["double"])
    mm_step, mm_final = _port_sparse_run(substep_interp="window_mm")
    assert not mm_step.gather_substeps
    _close_carry(final, _as_numpy(mm_final), EVAL_TOL * 1e3)


@pytest.mark.parametrize("offset", [0, 1], ids=["at-crossover", "below"])
def test_substep_interp_auto_crossover(monkeypatch, offset):
    """``"auto"`` takes the gather from ``_GATHER_SUBSTEP_WINDOW_CELLS``
    window cells on (the JAX package's rule, which its tests never reach):
    with the crossover moved onto this case's window, "auto" steps exactly
    as the path it picked."""
    _, _, (flow_sim, rod, _, interactor) = _rod_case(tm, flow_forces=True)
    cells = int(np.prod(tm.suggest_rod_forcing_window(interactor, rod, GRID)))
    monkeypatch.setattr(fsi, "_GATHER_SUBSTEP_WINDOW_CELLS", cells + offset)
    step, final = _port_sparse_run()
    assert step.gather_substeps == (offset == 0)
    _, same = _port_sparse_run(
        substep_interp="gather" if offset == 0 else "window_mm")
    _close_carry(final, _as_numpy(same), 0.0)


def test_conflicting_arguments_raise():
    _, _, (flow_sim, rod, collection, interactor) = _rod_case(tm)
    build = lambda **kw: tm.build_rod_fsi_step(
        flow_sim, interactor, collection, **kw)
    with pytest.raises(ValueError, match="conflicts"):
        build(rod_substeps=2, rod_dt=1e-4, max_rod_substeps=4)
    with pytest.raises(ValueError, match="either rod_substeps"):
        build()
    with pytest.raises(ValueError, match="substep_interp must be"):
        build(rod_substeps=1, substep_interp="nearest")
    with pytest.raises(ValueError, match="substep_load_refresh"):
        build(rod_substeps=1, substep_load_refresh="never")
    # inert in the JAX package without a sparse window; the port refuses
    for interp in ("gather", "window_mm"):
        with pytest.raises(ValueError, match="needs sparse_forcing_window"):
            build(rod_substeps=1, substep_interp=interp)
    with pytest.raises(ValueError, match="exceeds the grid"):
        build(rod_substeps=1, sparse_forcing_window=(32, 24, 32))
    step = build(rod_substeps=1, substep_load_refresh="flow_step")
    carry = tm.init_rod_fsi_carry(flow_sim, interactor, rod)  # no step
    with pytest.raises(ValueError, match="frozen-loads"):
        step(carry)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_host_loop_matches_fused_step(dynamic):
    """The reference's host-driven loop (FlowForces in the rod substeps ->
    interactor.time_step -> interactor() -> flow step) reproduces the fused
    dense step."""
    rod_dt = 2e-4
    fsv = (1.0, 0.0, 0.0)
    _, _, (flow_sim, rod, collection, interactor) = _rod_case(
        tm, flow_forces=True)
    ts = tm.PositionVerlet()
    do_step, stages = tm.extend_stepper_interface(ts, collection)
    rod_time = 0.0
    for _ in range(N_STEPS):
        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)
        n_sub = int(flow_dt / min(flow_dt, rod_dt)) if dynamic else 1
        for _ in range(n_sub):
            rod_time = do_step(ts, stages, collection, rod_time, flow_dt / n_sub)
            interactor.time_step(dt=flow_dt / n_sub)
        interactor()
        flow_sim.time_step(flow_dt, free_stream_velocity=fsv)
    kw = {"rod_substeps": None, "rod_dt": rod_dt} if dynamic else {}
    step, carry, _ = _rod_case(tm, **kw)
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    # the host loop rounds its dt through a Python float
    tol = 1e-12
    _close(flow_sim.vorticity_field, final.flow_state.primary_field, tol,
           "vorticity")
    _close(rod.position_collection, final.rod_state.position, tol, "rod")
    _close(interactor.state.position_mismatch,
           final.vb_state.position_mismatch, tol, "mismatch")
    if dynamic:
        assert step.stats["substeps"] > N_STEPS


def _moving_rod_state(seed=0, n=6, base_radius=0.02):
    """A JAX rod bent, twisted and moving (seeded numpy noise): (JAX rod,
    numpy state)."""
    rng = np.random.default_rng(seed)
    rod = jm.CosseratRod.straight_rod(**_rod_args(True, n, base_radius))
    director = np.asarray(jm.elastica.exp_rotate(
        rod.state.director, jnp.asarray(0.3 * rng.standard_normal((3, n)))
    ))
    state = dict(
        position=np.asarray(rod.state.position)
        + 0.01 * rng.standard_normal((3, n + 1)),
        velocity=0.1 * rng.standard_normal((3, n + 1)),
        director=director,
        omega=rng.standard_normal((3, n)),
    )
    rod.state = jm.elastica.rod.CosseratRodState(
        **{k: jnp.asarray(v) for k, v in state.items()})
    return rod, state


@pytest.mark.parametrize(
    "grid_name", ["surface", "element-centric", "edge"]
)
@pytest.mark.parametrize("forcing_dtype", ["f64", "f32"])
def test_rod_forcing_grids_match_jax(grid_name, forcing_dtype):
    """Marker positions, velocities and body loads of a bent, moving rod
    (radius varying along it) from the same numpy state; float32 Lagrangian
    forcing exercises the mixed-dtype transfer."""
    jrod, state = _moving_rod_state(base_radius=np.linspace(0.02, 0.04, 6))
    rod = tm.CosseratRod.straight_rod(
        **_rod_args(False, 6, np.linspace(0.02, 0.04, 6)))
    rod.state = rod_state_from_numpy(state, device="cpu")
    kw = {"surface_grid_density_for_largest_element": 5}
    jcls, cls = {
        "surface": (jm.CosseratRodSurfaceForcingGrid,
                    tm.CosseratRodSurfaceForcingGrid),
        "element-centric": (jm.CosseratRodElementCentricForcingGrid,
                            tm.CosseratRodElementCentricForcingGrid),
        "edge": (jm.CosseratRodEdgeForcingGrid, tm.CosseratRodEdgeForcingGrid),
    }[grid_name]
    jgrid, grid = jcls(cosserat_rod=jrod, **kw), cls(cosserat_rod=rod, **kw)
    assert grid.num_lag_nodes == jgrid.num_lag_nodes
    assert grid.grid_dim == jgrid.grid_dim
    assert grid.get_maximum_lagrangian_grid_spacing() == pytest.approx(
        jgrid.get_maximum_lagrangian_grid_spacing(), rel=1e-12)
    _close(grid.compute_lag_grid_position_field(),
           jgrid.compute_lag_grid_position_field(), EVAL_TOL, "positions")
    _close(grid.compute_lag_grid_velocity_field(),
           jgrid.compute_lag_grid_velocity_field(), EVAL_TOL, "velocities")
    np_t = np.float64 if forcing_dtype == "f64" else np.float32
    lag = np.random.default_rng(4).standard_normal(
        (grid.grid_dim, grid.num_lag_nodes)).astype(np_t)
    out = grid.transfer_forcing_from_grid_to_body(torch.tensor(lag))
    ref = jgrid.transfer_forcing_from_grid_to_body(jnp.asarray(lag))
    tol = EVAL_TOL if forcing_dtype == "f64" else 1e-6
    for o, r, what in zip(out, ref, ("forces", "torques")):
        assert o.dtype == {"float64": torch.float64,
                           "float32": torch.float32}[str(np.asarray(r).dtype)]
        _close(o, r, tol, what)


def test_rod_fsi_carry_from_numpy_round_trip():
    """A JAX carry (frozen loads included) carried across steps like the
    port's own: every leaf lands with its dtype and value, and one step
    from it matches the JAX step."""
    jstep, jcarry, _ = _rod_case(jm, sparse=True, rod_substeps=2,
                                 substep_load_refresh="flow_step")
    jcarry, _ = jm.scan_steps(jstep, jcarry, 1)
    step, own, _ = _rod_case(tm, sparse=True, rod_substeps=2,
                             substep_load_refresh="flow_step")
    tree = jax.tree_util.tree_map(np.asarray, jcarry)
    carry = rod_fsi_carry_from_numpy(tree, device="cpu", dtype=torch.float64)
    flat, _ = jax.tree_util.tree_flatten(tree)
    ours = [t for t in jax.tree_util.tree_leaves(
        carry, is_leaf=lambda x: torch.is_tensor(x))]
    assert len(ours) == len(flat)
    for o, r in zip(ours, flat):
        assert o.shape == r.shape
        _close(o, r, 0.0, "leaf")
    assert [t.dtype for t in carry.frozen_loads] == [
        t.dtype for t in own.frozen_loads]
    jfinal, _ = jm.scan_steps(jstep, jcarry, 1)
    final, _ = tm.scan_steps(step, carry, 1)
    _close_carry(final, jfinal, STEP_TOL["double"])


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_rod_fsi_case_matches_jax(sparse):
    """The small rod case (float32 flow, float64 rod, one substep a step):
    3 steps of what the port builds against what the JAX package builds."""
    jstep, jcarry = jax_entry._build_rod_fsi_case(GRID, sparse_forcing=sparse)
    step, carry = cases._build_rod_fsi_case(GRID, device="cpu",
                                            sparse_forcing=sparse)
    assert (step.sparse_forcing_window is not None) == sparse
    assert carry.rod_state.position.dtype == torch.float64
    assert carry.flow_state.primary_field.dtype == torch.float32
    jfinal, jdiag = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, diag = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal, STEP_TOL["single"])
    if sparse:
        (diag, ok), (jdiag, _) = diag, jdiag
        assert bool(ok.all())
    _close(diag, jdiag, STEP_TOL["single"], "lag_force_sum")


def test_rod_bench_case_matches_jax():
    """The benchmark case (float32 flow, float64 rod, dynamic substeps,
    order-1 multiplicative filter) at (32, 8, 32), the port on its kernel
    branch: what the port builds agrees with what the JAX package builds,
    and 3 steps agree."""
    grid = (32, 8, 32)
    jstep, (jcarry,) = jax_entry._build_rod_bench_case(grid)
    step, (carry,) = cases._build_rod_bench_case(
        grid, device="cpu", sim_kwargs={"use_kernels": True})
    assert step.sparse_forcing_window is None  # 32^3-class: dense IBM
    start = jax.tree_util.tree_map(np.asarray, jcarry)
    _close(carry.greens, start.greens, 1e-5 * np.abs(start.greens).max(),
           "greens")
    for what in ("position", "director"):
        _close(getattr(carry.rod_state, what),
               getattr(start.rod_state, what), 0.0, what)
    assert carry.rod_state.position.dtype == torch.float64
    assert carry.flow_state.primary_field.dtype == torch.float32
    jfinal, jforces = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    _close_carry(final, jfinal, STEP_TOL["single"])
    _close(forces, jforces, STEP_TOL["single"], "lag_force_sum")
    assert step.stats["host_syncs"] == N_STEPS
    assert step.stats["substeps"] > 100 * N_STEPS  # the diffusion-limited start
