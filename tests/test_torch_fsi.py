"""The port's fused flow-past-sphere FSI step against the JAX package's,
the slice as a whole: the JAX case (Pallas stencils in interpret mode,
exact spectral tier) and the port's case (kernel wrappers, which run their
plain versions on CPU tensors) step 3 times from one state.

Tolerances: float64 ``1e-9 max(1, |ref|max)``, float32
``1e-4 max(1, |ref|max)`` - over 3 strongly forced steps, float32 rounding
of the two frameworks' differently ordered FFTs and sums compounds through
the Poisson solve and the penalty force.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from sopht_mpi_tpu.models import scan_steps as jax_scan_steps
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.convert import rigid_fsi_carry_from_numpy
from sopht_mpi_tpu_torch.models import scan_steps
from sopht_mpi_tpu_torch.utils import get_real_t

N_STEPS = 3
TOL = {"single": 1e-4, "double": 1e-9}
SETUP_RTOL = {"single": 1e-5, "double": 1e-10}


def _close(out, ref, tol, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


@pytest.mark.parametrize(
    "precision,sparse_forcing,kernel_route",
    [("single", None, False), ("single", False, False),
     ("double", None, False), ("single", None, True)],
    ids=["single-sparse", "single-dense", "double-sparse",
         "single-sparse-kernel-route"],
)
def test_sphere_fsi_steps_match_jax(precision, sparse_forcing, kernel_route,
                                    monkeypatch):
    """``kernel_route`` forces both packages onto the split-spectrum Poisson
    route (the JAX Pallas convolve, the port's FFT passes): the carry then
    holds the (bulk, side) Green's pair, which the conversion carries
    over."""
    if kernel_route:
        import sopht_mpi_tpu.ops.poisson as jax_poisson
        from sopht_mpi_tpu_torch.ops import poisson

        monkeypatch.setattr(jax_poisson, "FORCE_PALLAS_CONVOLVE", True)
        monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    jax_step, (jax_carry,) = jax_entry._build_fsi_case(
        (32, 32, 32), precision=precision, sparse_forcing=sparse_forcing,
        sim_kwargs={"use_pallas": True},
    )
    step, (own_carry,) = cases._build_fsi_case(
        (32, 32, 32), device="cpu", precision=precision,
        sparse_forcing=sparse_forcing, sim_kwargs={"use_kernels": True},
    )
    assert step.uses_sparse_forcing == (sparse_forcing is None)
    assert bool(getattr(jax_step, "uses_sparse_forcing", False)) == (
        step.uses_sparse_forcing
    )
    start = jax.tree_util.tree_map(np.asarray, jax_carry)
    dtype = get_real_t(precision)
    carry = rigid_fsi_carry_from_numpy(start, device="cpu", dtype=dtype)

    # what the port builds on its own agrees with what JAX built
    rtol = SETUP_RTOL[precision]
    assert isinstance(start.greens, tuple) == kernel_route
    assert isinstance(own_carry.greens, tuple) == kernel_route
    assert isinstance(carry.greens, tuple) == kernel_route
    pairs = (zip(own_carry.greens, start.greens) if kernel_route
             else [(own_carry.greens, start.greens)])
    # the split pair is two slices of the dense spectrum, each held to the
    # dense spectrum's bound
    g_bulk = start.greens[0] if kernel_route else start.greens
    g_scale = np.abs(np.asarray(g_bulk)).max()
    for own_g, g_ref in pairs:
        _close(own_g, np.asarray(g_ref), rtol * g_scale, "greens")
    if step.uses_sparse_forcing:
        for a, b in zip(own_carry.ibm_mats, start.ibm_mats):
            _close(a, b, rtol * np.abs(b).max(), "ibm_mats")
    else:
        assert own_carry.ibm_mats is None and start.ibm_mats is None
    _close(own_carry.time, start.time, 0.0, "time")
    _close(own_carry.velocity_l1_max, start.velocity_l1_max, 0.0, "l1")

    jax_final, jax_forces = jax_scan_steps(jax_step, jax_carry, N_STEPS)
    final, forces = scan_steps(step, carry, N_STEPS)

    tol = TOL[precision]
    ref = jax.tree_util.tree_map(np.asarray, jax_final)
    _close(final.flow_state.primary_field, ref.flow_state.primary_field, tol,
           "vorticity")
    _close(final.flow_state.velocity_field, ref.flow_state.velocity_field, tol,
           "velocity")
    _close(forces, np.asarray(jax_forces), tol, "lag_force_sum")
    _close(final.time, ref.time, tol, "time")
    _close(final.velocity_l1_max, ref.velocity_l1_max, tol, "velocity_l1_max")
    _close(final.vb_state.position_mismatch, ref.vb_state.position_mismatch,
           tol, "position_mismatch")
    assert final.flow_state.primary_field.dtype == dtype


@pytest.mark.parametrize("grid", [32, 64])
def test_branch_and_window_match_jax(grid):
    """Same branch and window as JAX: the 32^3 benchmark case takes the
    sparse window, the 64^3 drag example (window touching the wall) the
    dense path."""
    from sopht_mpi_tpu.models import (
        RigidBodyFlowInteraction as JaxInteraction,
        Sphere as JaxSphere,
        SphereForcingGrid as JaxGrid,
        UnboundedFlowSimulator3D as JaxSim,
    )
    from sopht_mpi_tpu.models.fsi import (
        _static_rigid_forcing_window as jax_window,
    )
    from sopht_mpi_tpu_torch.models import (
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )
    from sopht_mpi_tpu_torch.models.fsi import _static_rigid_forcing_window

    shape = (grid, grid, grid)
    if grid == 32:  # the benchmark case
        center, diameter, n_eq, k = (0.5, 0.5, 0.5), 0.25, 15, (-1e4, -1e1)
    else:  # examples/3d/flow_past_sphere.py geometry
        center, diameter, n_eq, k = (0.25, 0.5, 0.5), 0.4, 48, (-1.5e5, -87.5)
    common = dict(grid_size=shape, x_range=1.0,
                  kinematic_viscosity=diameter / 100.0,
                  flow_type="navier_stokes_with_forcing",
                  with_free_stream_flow=True)
    windows = []
    for sim_cls, sphere_cls, grid_cls, inter_cls, kw in (
        (JaxSim, JaxSphere, JaxGrid, JaxInteraction, {}),
        (UnboundedFlowSimulator3D, Sphere, SphereForcingGrid,
         RigidBodyFlowInteraction, {"device": "cpu"}),
    ):
        sim = sim_cls(**common, **kw)
        sphere = sphere_cls(center=np.array(center), radius=diameter / 2, **kw)
        fgrid = grid_cls(rigid_body=sphere,
                         num_forcing_points_along_equator=n_eq)
        inter = inter_cls(flow_sim=sim, rigid_body=sphere, forcing_grid=fgrid,
                          virtual_boundary_stiffness_coeff=k[0],
                          virtual_boundary_damping_coeff=k[1])
        pos = fgrid.compute_lag_grid_position_field()
        windows.append((np.asarray(pos), inter.params, sim.grid_size))
    (jpos, jparams, jsize), (pos, params, size) = windows
    np.testing.assert_allclose(pos, jpos, rtol=1e-6)
    assert params == type(params)(**{
        f: getattr(jparams, f) for f in params.__dataclass_fields__
    })
    expected = jax_window(jpos, jparams, jsize)
    assert _static_rigid_forcing_window(torch.as_tensor(pos), params,
                                        size) == expected
    assert (expected is None) == (grid == 64)


def test_drag_case_matches_jax(tmp_path, monkeypatch):
    """The drag example's fused case (64^3-style geometry cut to 32^3, the
    dense IBM path, plain versions on both sides): t* and Cd at each
    window end agree with the JAX example's in float64."""
    import os
    import sys

    monkeypatch.chdir(tmp_path)  # the JAX example writes drag_vs_time.csv
    monkeypatch.syspath_prepend(
        os.path.join(os.path.dirname(jax_entry.__file__), "examples", "3d")
    )
    from flow_past_sphere import flow_past_sphere_fused_case as jax_case

    kw = dict(nondim_time=0.1, grid_size=(32, 32, 32), window=10,
              precision="double")
    jax_times, jax_cds = jax_case(**kw)
    times, cds = cases.flow_past_sphere_fused_case(**kw, device="cpu")
    sys.modules.pop("flow_past_sphere", None)
    np.testing.assert_allclose(times, jax_times, rtol=1e-12)
    _close(cds, jax_cds, 1e-9, "Cd")


def test_host_loop_matches_fused_step():
    """The interactor's host-driven loop (time_step -> interactor() ->
    flow step) reproduces the fused dense step in float64, and the body
    loads of the last interaction agree with the JAX sphere grid's."""
    import jax.numpy as jnp

    from sopht_mpi_tpu.models import (
        Sphere as JaxSphere,
        SphereForcingGrid as JaxGrid,
    )
    from sopht_mpi_tpu_torch.models import (
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
        build_rigid_fsi_step,
        init_rigid_fsi_carry,
    )

    fsv = (1.0, 0.0, 0.0)

    def case():
        sim = UnboundedFlowSimulator3D(
            (16, 16, 16), 1.0, 2.5e-3, device="cpu", real_t=torch.float64,
            flow_type="navier_stokes_with_forcing", with_free_stream_flow=True)
        sim.velocity_field = torch.ones_like(sim.velocity_field)
        sphere = Sphere(center=np.array([0.5, 0.5, 0.5]), radius=0.125,
                        device="cpu", dtype=torch.float64)
        grid = SphereForcingGrid(sphere, num_forcing_points_along_equator=8)
        inter = RigidBodyFlowInteraction(
            flow_sim=sim, rigid_body=sphere, forcing_grid=grid,
            virtual_boundary_stiffness_coeff=-1e4,
            virtual_boundary_damping_coeff=-1e1)
        return sim, inter

    sim, inter = case()
    step = build_rigid_fsi_step(
        sim, inter, free_stream_fn=lambda t: fsv, sparse_forcing=False)
    final, forces = scan_steps(step, init_rigid_fsi_carry(sim, inter, step),
                               N_STEPS)

    sim, inter = case()
    for _ in range(N_STEPS):
        dt = sim.compute_stable_timestep(dt_prefac=0.5)
        inter.time_step(dt)
        inter()
        sim.time_step(dt, free_stream_velocity=fsv)
    _close(sim.vorticity_field, final.flow_state.primary_field, 1e-12,
           "vorticity")
    _close(sim.velocity_field, final.flow_state.velocity_field, 1e-12,
           "velocity")
    _close(inter.global_lag_grid_forcing_field.sum(dim=1), forces[-1],
           1e-12, "lag forcing")

    inter.compute_flow_forces_and_torques()
    jsphere = JaxSphere(center=np.array([0.5, 0.5, 0.5]), radius=0.125,
                        dtype=jnp.float64)
    jgrid = JaxGrid(rigid_body=jsphere, num_forcing_points_along_equator=8)
    lag = inter.global_lag_grid_forcing_field.numpy()
    jforces, jtorques = jgrid.transfer_forcing_from_grid_to_body(lag)
    _close(inter.body_flow_forces, jforces, 1e-12, "body forces")
    _close(inter.body_flow_torques, jtorques, 1e-12, "body torques")
    assert inter.get_grid_deviation_error_l2_norm() > 0.0
