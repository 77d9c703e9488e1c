"""The port's 2D flow simulator against the JAX package's: each flow type
stepped several times from one numpy-seeded state on both Poisson routes,
the timestep control, and the Lamb-Oseen case at 64^2.

Tolerances: float64 ``1e-10 max(1, |ref|max)``, float32
``2e-5 max(1, |ref|max)`` over 4 steps (float32 rounding of the two
frameworks' differently ordered FFTs compounding through the Poisson solve
and the curl, whose 0.5/dx prefactor is 32 here); the Lamb-Oseen errors
against the analytic vortex within 1e-6 of the JAX package's own.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.poisson as jax_poisson
from sopht_mpi_tpu.models import UnboundedFlowSimulator2D as JaxSim
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.convert import flow_state_from_numpy
from sopht_mpi_tpu_torch.models import UnboundedFlowSimulator2D
from sopht_mpi_tpu_torch.models.flow import FlowState2D, simulator_2d
from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.utils import get_real_t


def _jax_lamb_oseen_example():
    """``examples/2d/lamb_oseen_vortex.py`` loaded by path (the examples
    are no package, and ``sys.path`` stays as the other tests set it)."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "2d", "lamb_oseen_vortex.py")
    spec = importlib.util.spec_from_file_location("_lamb_oseen_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

GRID = (32, 64)
N_STEPS = 4
TOL = {"single": 2e-5, "double": 1e-10}
FLOW_TYPES = ["passive_scalar", "navier_stokes", "navier_stokes_with_forcing"]


def _close(out, ref, tol, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _sims(flow_type, precision):
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    free = flow_type != "passive_scalar"
    kw = dict(grid_size=GRID, x_range=1.0, kinematic_viscosity=2e-3,
              flow_type=flow_type, with_free_stream_flow=free)
    return (JaxSim(real_t=jax_t, **kw),
            UnboundedFlowSimulator2D(real_t=get_real_t(precision),
                                     device="cpu", **kw))


def _seed_fields(jax_sim, sim, precision):
    np_t = np.float32 if precision == "single" else np.float64
    rng = np.random.default_rng(4)
    y, x = np.meshgrid(np.linspace(0, 1, GRID[0]), np.linspace(0, 1, GRID[1]),
                       indexing="ij")
    blob = np.exp(-((x - 0.4) ** 2 + (y - 0.5) ** 2) / 0.02)
    scalar = (blob + 0.05 * rng.standard_normal(GRID)).astype(np_t)
    velocity = (0.5 * rng.standard_normal((2, *GRID))).astype(np_t)
    forcing = (10.0 * rng.standard_normal((2, *GRID))).astype(np_t)
    jax_sim.primary_scalar_field = jnp.asarray(scalar)
    jax_sim.velocity_field = jnp.asarray(velocity)
    sim.primary_scalar_field = torch.tensor(scalar)
    sim.velocity_field = torch.tensor(velocity)
    return forcing


@pytest.mark.parametrize("flow_type", FLOW_TYPES)
def test_flow_steps_match_jax(flow_type, precision):
    jax_sim, sim = _sims(flow_type, precision)
    forcing = _seed_fields(jax_sim, sim, precision)
    np.testing.assert_array_equal(sim.position_field.numpy(),
                                  np.asarray(jax_sim.position_field))
    fsv = (0.7, -0.2) if flow_type != "passive_scalar" else (0.0, 0.0)
    for _ in range(N_STEPS):
        if flow_type == "navier_stokes_with_forcing":
            jax_sim.eul_grid_forcing_field = jnp.asarray(forcing)
            sim.eul_grid_forcing_field = torch.tensor(forcing)
        dt_ref = jax_sim.compute_stable_timestep()
        dt = sim.compute_stable_timestep()
        assert abs(dt - dt_ref) <= 1e-6 * dt_ref
        jax_sim.time_step(dt_ref, free_stream_velocity=fsv)
        sim.time_step(dt_ref, free_stream_velocity=fsv)
    tol = TOL[precision]
    _close(sim.primary_scalar_field, jax_sim.primary_scalar_field, tol,
           "scalar")
    _close(sim.velocity_field, jax_sim.velocity_field, tol, "velocity")
    assert abs(sim.time - jax_sim.time) < 1e-12
    assert sim.primary_scalar_field.dtype == get_real_t(precision)
    if flow_type == "navier_stokes_with_forcing":
        assert float(sim.eul_grid_forcing_field.abs().max()) == 0.0
    else:
        assert sim.eul_grid_forcing_field is None
    assert abs(sim.get_max_vorticity() - jax_sim.get_max_vorticity()) \
        <= tol * max(1.0, abs(jax_sim.get_max_vorticity()))
    assert sim.diffusion_limited_timestep(0.5) == pytest.approx(
        jax_sim.diffusion_limited_timestep(0.5), rel=1e-12)
    if flow_type != "passive_scalar":
        jax_sim.compute_velocity_from_vorticity()
        sim.compute_velocity_from_vorticity()
        _close(sim.velocity_field, jax_sim.velocity_field, tol, "recomputed")


def test_kernel_route_steps_match_jax_pallas_route(monkeypatch):
    """Both packages on their split-spectrum Poisson route: the state
    converted from the JAX simulator's, the functional step and
    ``_step_l1_fn`` against the JAX ones."""
    monkeypatch.setattr(jax_poisson, "FORCE_PALLAS_CONVOLVE", True)
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    jax_sim, sim = _sims("navier_stokes", "single")
    _seed_fields(jax_sim, sim, "single")
    assert isinstance(sim._poisson_greens, tuple)
    assert isinstance(jax_sim._poisson_greens, tuple)
    state = flow_state_from_numpy(
        [np.asarray(v) if v is not None else None
         for v in jax_sim._get_state()], device="cpu", dtype=torch.float32)
    assert isinstance(state, FlowState2D)
    jax_state = jax_sim._get_state()
    dt, fsv = 1e-3, (0.3, 0.1)
    for _ in range(N_STEPS):
        jax_state, jax_l1 = jax_sim._step_l1_fn(
            jax_state, jnp.float32(dt), jnp.asarray(fsv, jnp.float32),
            jax_sim._poisson_greens)
        state, l1 = sim._step_l1_fn(
            state, torch.tensor(dt), torch.tensor(fsv), sim._poisson_greens)
    _close(state.primary_scalar_field, jax_state.primary_scalar_field,
           TOL["single"], "vorticity")
    _close(state.velocity_field, jax_state.velocity_field, TOL["single"],
           "velocity")
    assert l1.ndim == 0
    _close(l1, jax_l1, TOL["single"], "l1")


def test_simulator_refuses_bad_options():
    kw = dict(grid_size=(16, 16), x_range=1.0, kinematic_viscosity=1e-3,
              device="cpu")
    with pytest.raises(ValueError):
        UnboundedFlowSimulator2D(flow_type="euler", **kw)
    with pytest.raises(ValueError):
        UnboundedFlowSimulator2D(with_free_stream_flow=True, **kw)
    with pytest.raises(TypeError, match="penalty_zone_widht"):
        UnboundedFlowSimulator2D(penalty_zone_widht=3, **kw)
    with pytest.raises(NotImplementedError):
        UnboundedFlowSimulator2D(mesh=object(), **kw)
    with pytest.raises(TypeError):  # device is required
        UnboundedFlowSimulator2D((16, 16), 1.0, 1e-3)
    sim = UnboundedFlowSimulator2D(penalty_zone_width=3, fast_spectral=True,
                                   flow_type="navier_stokes", **kw)
    assert sim.penalty_zone_width == 3
    assert sim.unbounded_poisson_solver.fast_spectral


def test_stable_timestep_matches_jax(precision):
    from sopht_mpi_tpu.models.flow.simulator_2d import (
        compute_stable_timestep_2d as jax_dt,
    )

    np_t = np.float32 if precision == "single" else np.float64
    v = np.random.default_rng(9).standard_normal((2, 12, 20)).astype(np_t)
    for nu in (1e-3, 5.0):  # CFL-limited, diffusion-limited
        ref = jax_dt(jnp.asarray(v), CFL=0.1, dx=0.05, nu=nu, tol=1e-4)
        out = simulator_2d.compute_stable_timestep_2d(
            torch.tensor(v), CFL=0.1, dx=0.05, nu=nu, tol=1e-4)
        assert out.ndim == 0
        assert abs(float(out) - float(ref)) <= 1e-6 * float(ref)


def test_lamb_oseen_64_matches_jax_example():
    """The example's own acceptance run (t 1.0 -> 1.4 at 64^2) on both
    packages: the errors against the analytic vortex meet the example
    test's bounds and agree with the JAX package's to 1e-6."""
    ref_l2, ref_linf = _jax_lamb_oseen_example().lamb_oseen_vortex_flow_case(
        grid_size=(64, 64))
    l2, linf = cases.lamb_oseen_vortex_case((64, 64), device="cpu")
    assert l2 < 2e-2 and linf < 2e-1
    assert abs(l2 - ref_l2) < 1e-6 and abs(linf - ref_linf) < 1e-6


def test_lamb_oseen_kernel_route_matches_dense_route(monkeypatch):
    dense = cases.lamb_oseen_vortex_case((64, 64), t_end=1.1, device="cpu")
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    kernel = cases.lamb_oseen_vortex_case((64, 64), t_end=1.1, device="cpu")
    assert abs(kernel[0] - dense[0]) < 1e-6
    assert abs(kernel[1] - dense[1]) < 1e-6
