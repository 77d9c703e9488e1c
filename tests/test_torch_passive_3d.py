"""The port's 3D passive transport against the JAX package's: the scalar
stencils and elementwise ops it is built of, the ``passive_scalar`` and
``passive_vector`` flow steps (on one device and on an in-process mesh),
the simulator's API, the flow-only step and the point-source case
(``cases.point_source_advection_diffusion_case``, the case of
``examples/3d/point_source_advect_diffuse.py``).

Also holds :func:`write_jax_point_source_reference`, which computes the JAX
package's L2 and Linf errors of the 64^3 point source that
``chip_smoke.py`` holds the card's run to.

Tolerances: the ops ``2e-6 max(1, |ref|)`` in float32 and ``1e-12`` in
float64 (the same shifted-slice arithmetic, fused and rounded in another
order), as the 2D stencils' tests; the steps ``1e-5 max(1, |ref|max)`` in
float32 and ``1e-11`` in float64 after 3 steps (those roundings, compounded
over three ENO3 advections and diffusions); the mesh against one device
exactly, since both run the same ops on the same assembled field.
"""

import functools
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINT_SOURCE_REFERENCE = os.path.join(
    REPO, "sopht_mpi_tpu_torch", "data", "point_source_reference.json"
)
POINT_SOURCE_REFERENCE_COMMAND = (
    "JAX_PLATFORMS=cpu python -c \"import sys; sys.path[:0] = ['.', 'tests']; "
    "import test_torch_passive_3d as t; t.write_jax_point_source_reference()\""
)


def _point_source_example():
    """``examples/3d/point_source_advect_diffuse.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "point_source_advect_diffuse",
        os.path.join(REPO, "examples", "3d", "point_source_advect_diffuse.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_point_source_case(grid_size, precision="single"):
    """(step, carry) of the JAX package's point source, built as the fused
    branch of ``point_source_advection_diffusion_case`` builds them, with
    the example's own initial field."""
    import jax.numpy as jnp

    from sopht_mpi_tpu.models import (
        UnboundedFlowSimulator3D,
        build_flow_only_step,
        init_flow_only_carry,
    )
    from sopht_mpi_tpu.utils import get_real_t

    compute_diffused_point_source_field = (
        _point_source_example().compute_diffused_point_source_field)
    real_t = get_real_t(precision)
    nu, t_start = 1e-3, 5.0
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size, x_range=1.0, kinematic_viscosity=nu,
        flow_type="passive_vector", real_t=real_t, time=t_start,
    )
    x, y, z = (np.asarray(flow_sim.position_field[c]) for c in range(3))
    init = compute_diffused_point_source_field(
        x, y, z, np.array([0.3, 0.3, 0.3]), nu,
        4.0 * np.pi * nu * t_start**1.5, t_start)
    flow_sim.primary_vector_field = jnp.asarray(
        np.broadcast_to(init, (3, *grid_size)).copy(), real_t)
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    return build_flow_only_step(flow_sim), init_flow_only_carry(flow_sim)


def write_jax_point_source_reference(grid=64, path=POINT_SOURCE_REFERENCE):
    """Write the JAX package's errors of the point source at ``grid``^3,
    run by the example's own fused branch (float32, windows of 100
    steps), as JSON."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    l2, linf = _point_source_example().point_source_advection_diffusion_case(
        grid_size=(grid,) * 3, fused=True, window=100)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "case": "examples/3d/point_source_advect_diffuse.py, fused "
                    "branch",
            "grid_size": [grid] * 3,
            "window": 100,
            "t_start": 5.0,
            "t_end": 5.4,
            "precision": "float32, CPU",
            "jax_version": jax.__version__,
            "command": POINT_SOURCE_REFERENCE_COMMAND,
            "l2": float(l2),
            "linf": float(linf),
        }, f, indent=None)
        f.write("\n")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import sopht_mpi_tpu.models as jm  # noqa: E402
from sopht_mpi_tpu.ops import elementwise as jax_elementwise  # noqa: E402
from sopht_mpi_tpu.ops import stencils_3d as jax_ops  # noqa: E402
import sopht_mpi_tpu_torch.models as tm  # noqa: E402
from sopht_mpi_tpu_torch import cases  # noqa: E402
from sopht_mpi_tpu_torch.convert import flow_state_from_numpy  # noqa: E402
from sopht_mpi_tpu_torch.models.fsi import FlowOnlyCarry  # noqa: E402
from sopht_mpi_tpu_torch.ops import elementwise  # noqa: E402
from sopht_mpi_tpu_torch.ops import stencils_3d as ops  # noqa: E402
from sopht_mpi_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from sopht_mpi_tpu_torch.utils import get_real_t  # noqa: E402

DTYPES = {"single": (np.float32, 2e-6), "double": (np.float64, 1e-12)}
STEP_TOL = {"single": 1e-5, "double": 1e-11}
SHAPES = {"cube": (16, 16, 16), "odd": (9, 12, 17)}
GRID = (16, 16, 16)
N_STEPS = 3


def _fields(precision, shape, seed=0):
    dtype, _ = DTYPES[precision]
    rng = np.random.default_rng(seed)
    scalar = rng.standard_normal(shape).astype(dtype)
    vectors = [rng.standard_normal((3, *shape)).astype(dtype)
               for _ in range(2)]
    return scalar, *vectors


def _close(out, ref, tol, what="", scale=None):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out.astype(np.float64) - ref)
    bound = tol * (np.maximum(1.0, np.abs(ref)) if scale is None else scale)
    assert (err <= bound).all(), f"{what}: max|diff| {err.max()}"


def _close_max(out, ref, tol, what):
    """Within ``tol max(1, |ref|max)``."""
    ref = np.asarray(ref)
    _close(out, ref, tol, what, max(1.0, float(np.abs(ref).max(initial=0))))


OPS = {
    "diffusion_flux_3d": lambda m, f, v, w: m.diffusion_flux_3d(f, 0.1),
    "diffusion_timestep_3d":
        lambda m, f, v, w: m.diffusion_timestep_3d(f, 0.15),
    "advection_flux_conservative_eno3_3d":
        lambda m, f, v, w: m.advection_flux_conservative_eno3_3d(f, v, -0.3),
    "advection_timestep_eno3_3d":
        lambda m, f, v, w: m.advection_timestep_eno3_3d(f, v, 0.05),
    "advection_timestep_eno3_vector_3d":
        lambda m, f, v, w: m.advection_timestep_eno3_vector_3d(w, v, 0.05),
    "divergence_3d": lambda m, f, v, w: m.divergence_3d(v, 8.0),
    "update_vorticity_from_penalised_velocity_3d":
        lambda m, f, v, w: m.update_vorticity_from_penalised_velocity_3d(
            w, v, 0.5 * w, 0.4),
    "brinkmann_penalise_3d":
        lambda m, f, v, w: m.brinkmann_penalise_3d(v, 1e3, abs(f) / 4,
                                                   0.5 * w),
    "char_func_from_level_set_via_sine_heaviside_3d":
        lambda m, f, v, w: m.char_func_from_level_set_via_sine_heaviside_3d(
            f, 0.7),
}
ELEMENTWISE = {
    "set_fixed_val": lambda m, f, v, w: m.set_fixed_val(v, 0.375),
    "saxpby": lambda m, f, v, w: m.saxpby(v, 0.5, w, -1.25),
}


def _module_and_fn(name, jax_side):
    if name in OPS:
        return (jax_ops if jax_side else ops), OPS[name]
    return (jax_elementwise if jax_side else elementwise), ELEMENTWISE[name]


@functools.cache
def _jax_op_refs(precision, shape):
    """Every op's JAX result on one shape's seeded fields, from one jitted
    call (one compilation, not one for each op)."""
    def all_ops(*fields):
        return {name: fn(module, *fields) for name, (module, fn) in (
            (name, _module_and_fn(name, True))
            for name in (*OPS, *ELEMENTWISE))}

    fields = _fields(precision, SHAPES[shape])
    refs = jax.jit(all_ops)(*map(jnp.asarray, fields))
    return {name: np.asarray(ref) for name, ref in refs.items()}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(OPS) + sorted(ELEMENTWISE))
def test_op_matches_jax(name, shape, precision):
    fields = _fields(precision, SHAPES[shape])
    module, fn = _module_and_fn(name, False)
    ref = _jax_op_refs(precision, shape)[name]
    out = fn(module, *map(torch.tensor, fields))
    assert out.dtype == torch.tensor(fields[0]).dtype
    _close(out, ref, DTYPES[precision][1], name)


def _passive_state(flow_type, precision, seed=1, grid=GRID):
    """A smooth seeded primary field (a scalar or three components) and a
    seeded velocity of size about 1."""
    dtype, _ = DTYPES[precision]
    rng = np.random.default_rng(seed)
    shape = grid if flow_type == "passive_scalar" else (3, *grid)
    field = np.exp(rng.standard_normal(shape)).astype(dtype)
    velocity = (0.5 + 0.5 * rng.standard_normal((3, *grid))).astype(dtype)
    return field, velocity


def _sims(flow_type, precision, mesh=None):
    common = dict(grid_size=GRID, x_range=1.0, kinematic_viscosity=2e-3,
                  flow_type=flow_type)
    jsim = jm.UnboundedFlowSimulator3D(
        **common, real_t={"single": jnp.float32,
                          "double": jnp.float64}[precision])
    sim = tm.UnboundedFlowSimulator3D(
        **common, real_t=get_real_t(precision), device="cpu", mesh=mesh)
    return jsim, sim


@pytest.mark.parametrize("flow_type", ["passive_scalar", "passive_vector"])
def test_passive_steps_match_jax(flow_type, precision):
    jsim, sim = _sims(flow_type, precision)
    field, velocity = _passive_state(flow_type, precision)
    jsim.primary_field = jnp.asarray(field)
    jsim.velocity_field = jnp.asarray(velocity)
    sim._set_state(flow_state_from_numpy(
        (field, velocity, None), device="cpu",
        dtype=get_real_t(precision)))
    assert sim.eul_grid_forcing_field is None
    for _ in range(N_STEPS):
        dt = jsim.compute_stable_timestep(dt_prefac=0.5)
        assert sim.compute_stable_timestep(dt_prefac=0.5) == pytest.approx(
            dt, rel=1e-6)
        jsim.time_step(dt)
        sim.time_step(dt)
    _close_max(sim.primary_field, jsim.primary_field, STEP_TOL[precision],
               "primary field")
    # the velocity is not touched
    assert np.array_equal(sim.velocity_field.numpy(), velocity)
    assert sim.time == pytest.approx(jsim.time, rel=1e-15)


@pytest.mark.parametrize("flow_type", ["passive_scalar", "passive_vector"])
def test_passive_steps_on_a_mesh_match_one_device(flow_type):
    """Three steps on a (2, 2) mesh, the transport on the assembled fields
    once a step, against the same steps on one device."""
    mesh = mesh_mod.create_mesh(3, (2, 2), device="cpu")
    _, sim = _sims(flow_type, "double", mesh=mesh)
    _, one = _sims(flow_type, "double")
    field, velocity = _passive_state(flow_type, "double", seed=2)
    assert sim.primary_field.shape == (
        (2, 2, 8, 8, 16) if flow_type == "passive_scalar"
        else (2, 2, 3, 8, 8, 16))
    for s, m in ((sim, mesh), (one, None)):
        s._set_state(flow_state_from_numpy(
            (field, velocity, None), device="cpu", dtype=torch.float64,
            mesh=m))
    mesh_mod.apply_assembled.calls = 0
    for _ in range(N_STEPS):
        dt = one.compute_stable_timestep(dt_prefac=0.5)
        sim.time_step(dt)
        one.time_step(dt)
    assert mesh_mod.apply_assembled.calls == N_STEPS
    unshard = (mesh_mod.unshard_scalar_field if flow_type == "passive_scalar"
               else mesh_mod.unshard_vector_field)
    assert torch.equal(unshard(sim.primary_field, mesh), one.primary_field)


def test_simulator_api_matches_jax():
    """The default flow type, the constructor's errors, and the four
    methods the JAX simulator has: ``primary_vector_field``,
    ``get_max_vorticity``, ``compute_flow_velocity`` and
    ``get_vorticity_divergence_l2_norm``."""
    common = dict(grid_size=GRID, x_range=1.0, kinematic_viscosity=2e-3)
    jsim = jm.UnboundedFlowSimulator3D(**common, real_t=jnp.float64)
    sim = tm.UnboundedFlowSimulator3D(**common, real_t=torch.float64,
                                      device="cpu")
    assert sim.flow_type == jsim.flow_type == "passive_scalar"
    assert sim.primary_field.shape == jsim.primary_field.shape == GRID
    assert sim.SUPPORTED_FLOW_TYPES == jsim.SUPPORTED_FLOW_TYPES
    for kwargs in ({"flow_type": "passive_scalar",
                    "with_free_stream_flow": True},
                   {"flow_type": "passive_vector",
                    "with_free_stream_flow": True},
                   {"flow_type": "euler"}):
        with pytest.raises(ValueError) as jerr:
            jm.UnboundedFlowSimulator3D(**common, **kwargs)
        with pytest.raises(ValueError) as err:
            tm.UnboundedFlowSimulator3D(**common, **kwargs, device="cpu")
        assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="no Poisson solver"):
        sim.compute_flow_velocity()

    # the methods on a Navier-Stokes simulator from one seeded vorticity
    rng = np.random.default_rng(5)
    vort = rng.standard_normal((3, *GRID))
    common["flow_type"] = "navier_stokes"
    jsim = jm.UnboundedFlowSimulator3D(**common, real_t=jnp.float64)
    sim = tm.UnboundedFlowSimulator3D(**common, real_t=torch.float64,
                                      device="cpu")
    jsim.primary_vector_field = jnp.asarray(vort)
    sim.primary_vector_field = torch.tensor(vort)
    assert sim.vorticity_field is sim.primary_vector_field
    assert sim.get_max_vorticity() == jsim.get_max_vorticity()
    assert sim.get_vorticity_divergence_l2_norm() == pytest.approx(
        jsim.get_vorticity_divergence_l2_norm(), rel=1e-12)
    jsim.compute_flow_velocity()
    sim.compute_flow_velocity()
    _close_max(sim.vorticity_field, jsim.vorticity_field, 1e-12, "vorticity")
    _close_max(sim.velocity_field, jsim.velocity_field, 1e-9, "velocity")
    assert float(sim.velocity_field.abs().max()) > 0


def test_flow_only_step_matches_jax():
    """The passive flow-only step through ``scan_steps``: the carried
    ``max |u|_1`` stays as it was, and field, dt and time follow JAX's
    ``build_flow_only_step``."""
    jsim, sim = _sims("passive_scalar", "double")
    field, velocity = _passive_state("passive_scalar", "double", seed=3)
    jsim.primary_field = jnp.asarray(field)
    jsim.velocity_field = jnp.asarray(velocity)
    sim.primary_field = torch.tensor(field)
    sim.velocity_field = torch.tensor(velocity)
    jstep, jcarry = jm.build_flow_only_step(jsim), jm.init_flow_only_carry(jsim)
    step, carry = tm.build_flow_only_step(sim), tm.init_flow_only_carry(sim)
    assert isinstance(carry, FlowOnlyCarry) and carry.greens.ndim == 0
    l1 = carry.velocity_l1_max
    jfinal, jdts = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, dts = tm.scan_steps(step, carry, N_STEPS)
    assert final.velocity_l1_max is l1
    _close_max(final.velocity_l1_max, jfinal.velocity_l1_max, 1e-15, "l1")
    _close(dts, jdts, 1e-14, "dt")
    _close(final.time, jfinal.time, 1e-15, "time")
    _close_max(final.flow_state.primary_field, jfinal.flow_state.primary_field,
               STEP_TOL["double"], "primary field")


def test_point_source_case_matches_jax():
    """The port's point-source case against the JAX package's, built as
    the example builds it, over 3 steps; then run to its end at 16^3 with
    errors of the size the JAX example gives (1.82e-1 at 16^3, its slow
    test)."""
    jstep, jcarry = jax_point_source_case(GRID)
    step, carry = cases.point_source_advection_diffusion_case(GRID,
                                                              device="cpu")
    assert step.flow_sim.flow_type == "passive_vector"
    start = jax.tree_util.tree_map(np.asarray, jcarry)
    _close_max(carry.flow_state.primary_field, start.flow_state.primary_field,
               DTYPES["single"][1], "initial field")
    _close(carry.flow_state.velocity_field, start.flow_state.velocity_field,
           0.0, "velocity")
    jfinal, _ = jm.scan_steps(jstep, jcarry, N_STEPS)
    final, _ = tm.scan_steps(step, carry, N_STEPS)
    _close_max(final.flow_state.primary_field, jfinal.flow_state.primary_field,
               STEP_TOL["single"], "field after 3 steps")
    _close(final.time, jfinal.time, 1e-7, "time")
    final, l2, linf = cases.run_point_source_case(step, final, window=50)
    assert float(final.time) >= cases.POINT_SOURCE_T_END - 1e-6
    assert 0.15 < l2 < 0.22 and 0 < linf < 3.0, (l2, linf)
