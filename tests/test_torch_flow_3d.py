"""The port's 3D flow simulator against the JAX package's
(``use_pallas=True``: Pallas stencils in interpret mode): two steps from
one seeded state, the CFL timestep, and the constructor's option checks.

Tolerances: float64 ``1e-9 max(1, |ref|max)``; float32
``1e-4 max(1, |ref|max)`` (float32 rounding through two Poisson solves).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.models import UnboundedFlowSimulator3D as JaxSim
from sopht_mpi_tpu.models.flow.simulator_3d import (
    compute_stable_timestep_3d as jax_stable_dt,
)
from sopht_mpi_tpu_torch.convert import flow_state_from_numpy
from sopht_mpi_tpu_torch.models.flow.simulator_3d import (
    UnboundedFlowSimulator3D,
    compute_stable_timestep_3d,
)
from sopht_mpi_tpu_torch.parallel.mesh import create_mesh
from sopht_mpi_tpu_torch.utils import get_real_t

GRID = (12, 16, 20)
TOL = {"single": 1e-4, "double": 1e-9}


def _close(out, ref, tol, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out.astype(np.float64) - ref).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _state(precision, seed=0):
    np_t = np.float32 if precision == "single" else np.float64
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3,) + GRID).astype(np_t) for _ in range(3)]


@pytest.mark.parametrize(
    "flow_type,use_kernels,filter_vorticity",
    [
        ("navier_stokes", True, False),
        ("navier_stokes_with_forcing", True, False),
        ("navier_stokes_with_forcing", False, False),
        ("navier_stokes", True, True),
    ],
    ids=["ns-kernels", "forcing-kernels", "forcing-plain", "ns-filtered"],
)
def test_flow_steps_match_jax(precision, flow_type, use_kernels,
                              filter_vorticity):
    vort, vel, forcing = _state(precision)
    forcing = 0.1 * forcing
    fsv = (1.0, -0.25, 0.5)
    common = dict(grid_size=GRID, x_range=1.0, kinematic_viscosity=2e-3,
                  flow_type=flow_type, with_free_stream_flow=True,
                  filter_vorticity=filter_vorticity)
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    jsim = JaxSim(**common, real_t=jax_t, use_pallas=use_kernels)
    sim = UnboundedFlowSimulator3D(**common, real_t=get_real_t(precision),
                                   device="cpu", use_kernels=use_kernels)
    with_forcing = flow_type == "navier_stokes_with_forcing"
    jsim.vorticity_field = jnp.asarray(vort)
    jsim.velocity_field = jnp.asarray(vel)
    state = flow_state_from_numpy(
        (vort, vel, forcing if with_forcing else None), device="cpu",
        dtype=get_real_t(precision),
    )
    sim._set_state(state)
    for _ in range(2):
        if with_forcing:
            jsim.eul_grid_forcing_field = jnp.asarray(forcing)
            sim.eul_grid_forcing_field = torch.tensor(forcing)
        dt = jsim.compute_stable_timestep(dt_prefac=0.5)
        assert sim.compute_stable_timestep(dt_prefac=0.5) == pytest.approx(
            dt, rel=TOL[precision])
        jsim.time_step(dt, free_stream_velocity=fsv)
        sim.time_step(dt, free_stream_velocity=fsv)
    tol = TOL[precision]
    _close(sim.vorticity_field, jsim.vorticity_field, tol, "vorticity")
    _close(sim.velocity_field, jsim.velocity_field, tol, "velocity")
    assert sim.time == pytest.approx(jsim.time)
    if with_forcing:
        assert not sim.eul_grid_forcing_field.any()


@pytest.mark.parametrize(
    "filter_setting,penalty_zone_width",
    [
        ({"order": 1, "type": "multiplicative"}, 2),
        ({"order": 2, "type": "convolution"}, 2),
        ({"order": 1, "type": "multiplicative"}, 0),
        (None, 0),
    ],
    ids=["rod-filter", "convolution", "filter-no-sponge", "no-sponge"],
)
def test_filtered_transport_steps_match_jax(precision, filter_setting,
                                            penalty_zone_width):
    """The filtered (or sponge-less) transport on the kernel branch - the
    diffusion, filter and sponge wrappers in turn - against the JAX
    ``use_pallas=True`` step, forcing on as in the rod cases."""
    vort, vel, forcing = _state(precision, seed=2)
    forcing = 0.1 * forcing
    fsv = (1.0, 0.0, 0.0)
    common = dict(grid_size=GRID, x_range=1.0, kinematic_viscosity=2e-3,
                  flow_type="navier_stokes_with_forcing",
                  with_free_stream_flow=True,
                  filter_vorticity=filter_setting is not None,
                  filter_setting_dict=filter_setting,
                  penalty_zone_width=penalty_zone_width)
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    jsim = JaxSim(**common, real_t=jax_t, use_pallas=True)
    sim = UnboundedFlowSimulator3D(**common, real_t=get_real_t(precision),
                                   device="cpu", use_kernels=True)
    jsim.vorticity_field = jnp.asarray(vort)
    jsim.velocity_field = jnp.asarray(vel)
    sim._set_state(flow_state_from_numpy(
        (vort, vel, forcing), device="cpu", dtype=get_real_t(precision)))
    for _ in range(2):
        jsim.eul_grid_forcing_field = jnp.asarray(forcing)
        sim.eul_grid_forcing_field = torch.tensor(forcing)
        dt = jsim.compute_stable_timestep(dt_prefac=0.5)
        jsim.time_step(dt, free_stream_velocity=fsv)
        sim.time_step(dt, free_stream_velocity=fsv)
    tol = TOL[precision]
    _close(sim.vorticity_field, jsim.vorticity_field, tol, "vorticity")
    _close(sim.velocity_field, jsim.velocity_field, tol, "velocity")
    assert sim.diffusion_limited_timestep(0.25) == pytest.approx(
        jsim.diffusion_limited_timestep(0.25), rel=1e-15)


def test_stable_timestep_matches_jax(precision):
    _, vel, _ = _state(precision, seed=4)
    kw = dict(CFL=0.1, dx=1.0 / 20, nu=2e-3, tol=1e-6)
    ref = jax_stable_dt(jnp.asarray(vel), **kw)
    out = compute_stable_timestep_3d(torch.tensor(vel), **kw)
    assert out.ndim == 0 and out.dtype == get_real_t(precision)
    _close(out, ref, 0.0, "dt (advection-limited)")
    slow = 1e-6 * vel
    _close(compute_stable_timestep_3d(torch.tensor(slow), **kw),
           jax_stable_dt(jnp.asarray(slow), **kw), 0.0, "dt (diffusion-limited)")


def test_constructor_option_checks():
    common = dict(grid_size=(8, 8, 8), x_range=1.0, kinematic_viscosity=1e-3,
                  device="cpu", flow_type="navier_stokes")
    with pytest.raises(TypeError, match="overlap_chunk"):
        UnboundedFlowSimulator3D(**common, overlap_chunk=1)
    # the passive flow types build: a scalar (nz, ny, nx) primary field for
    # passive_scalar, and no Poisson solver
    passive = UnboundedFlowSimulator3D(**{**common,
                                          "flow_type": "passive_scalar"})
    assert passive.primary_field.shape == (8, 8, 8)
    assert getattr(passive, "unbounded_poisson_solver", None) is None
    with pytest.raises(ValueError):
        UnboundedFlowSimulator3D(**{**common, "flow_type": "stokes"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UnboundedFlowSimulator3D(**common, comm_bf16=True)
    # a mesh is accepted where it divides the grid and lies on the device
    mesh = create_mesh(3, (2, 2), device="cpu")
    sim = UnboundedFlowSimulator3D(**common, mesh=mesh, overlap_chunks=4)
    assert sim.mesh is mesh
    assert sim.unbounded_poisson_solver.mesh is mesh
    assert sim.unbounded_poisson_solver.overlap_chunks == 4
    assert sim.primary_field.shape == (2, 2, 3, 4, 4, 8)
    with pytest.raises(RuntimeError, match="not divisible by 3 devices"):
        UnboundedFlowSimulator3D(
            **common, mesh=create_mesh(3, (3, 1), device="cpu"))
    with pytest.raises(ValueError, match="overlap_chunks"):
        UnboundedFlowSimulator3D(**common, mesh=mesh, overlap_chunks=0)
    for not_a_3d_mesh in (object(), create_mesh(2, (2, 1), device="cpu")):
        with pytest.raises(ValueError, match="create_mesh"):
            UnboundedFlowSimulator3D(**common, mesh=not_a_3d_mesh)
    with pytest.raises(ValueError, match="lies on"):
        UnboundedFlowSimulator3D(
            **common, mesh=create_mesh(3, (2, 2), device="meta"))
    # the fast tier is accepted either way
    for fast in (False, True):
        sim = UnboundedFlowSimulator3D(**common, fast_spectral=fast)
        assert sim.unbounded_poisson_solver.fast_spectral is fast
    sim = UnboundedFlowSimulator3D(**common, fast_spectral=False,
                                   overlap_chunks=None, comm_bf16=False)
    assert sim.use_kernels is False  # the default follows the device
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(TypeError):
        UnboundedFlowSimulator3D((8, 8, 8), 1.0, 1e-3)  # device is required
