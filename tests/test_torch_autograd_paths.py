"""Gradients through whole steps of the port on the CPU, with the kernel
wrappers forced on (their forward the plain version, their backward the
JAX package's rule), against the JAX package's ``jax.grad`` or the port's
own single-device gradient.

- The sphere FSI set-up of ``test_fsi_scan_pallas_path_is_differentiable``
  (32^3, float32, 1 step, loss ``sum u^2``, gradient w.r.t. the initial
  vorticity) on the exact and the fast spectral tier: relative L2 <= 1e-4
  of JAX's gradient on its XLA path, whose value the Pallas VJPs reproduce.
- The 2D cylinder scan of ``test_fsi_scan_is_reverse_differentiable`` (2
  steps, float64): within 1e-10 of JAX's.
- The sign-descent assimilation of
  ``test_fsi_scan_gradient_assimilates_initial_condition``: the port
  recovers the amplitude 0.8 to 5e-3, as the JAX package does.
- The flow-only step on an in-process (2, 2) mesh (sharded stencils, the
  distributed convolve through the pass wrappers) against the same step on
  one device: 1e-4 of the largest value, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.models as jm
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch import models as tm
from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.parallel.mesh import unshard_vector_field


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these loops of small ops gain nothing from more
    on the CPU and stall on thread barriers beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def kernel_route(monkeypatch):
    """The port's solves take the kernel route's pass wrappers."""
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)


def _graph_nodes(t):
    """The type names of every node of ``t``'s autograd graph."""
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


def _rel_l2(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _sphere_case(lib, dtype, device_kw, sim_kw, fsv):
    flow_sim = lib.UnboundedFlowSimulator3D(
        grid_size=(32, 32, 32), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=dtype, **device_kw, **sim_kw)
    sphere = lib.Sphere(center=np.array([0.5, 0.5, 0.5]), radius=0.15,
                        dtype=dtype, **device_kw)
    grid = lib.SphereForcingGrid(rigid_body=sphere,
                                 num_forcing_points_along_equator=8)
    interactor = lib.RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=sphere, forcing_grid=grid,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0)
    step = lib.build_rigid_fsi_step(flow_sim, interactor, dt_prefac=0.5,
                                    free_stream_fn=lambda t: fsv)
    return flow_sim, step, lib.init_rigid_fsi_carry(flow_sim, interactor,
                                                    step)


@pytest.fixture(scope="module")
def jax_sphere_gradient():
    _, step, carry = _sphere_case(
        jm, jnp.float32, {}, {"use_pallas": False},
        jnp.asarray([1.0, 0.0, 0.0], jnp.float32))
    shape = carry.flow_state.primary_field.shape
    om0 = np.asarray(carry.flow_state.primary_field) + 0.1 * (
        np.random.default_rng(0).standard_normal(shape).astype(np.float32))

    def loss(omega0):
        c = carry._replace(
            flow_state=carry.flow_state._replace(primary_field=omega0))
        c2, _ = jm.scan_steps(step, c, 1)
        return jnp.sum(c2.flow_state.velocity_field ** 2)

    return om0, np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(om0)))


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_sphere_fsi_gradient_matches_jax(jax_sphere_gradient, fast):
    om0, want = jax_sphere_gradient
    flow_sim, step, carry = _sphere_case(
        tm, torch.float32, {"device": "cpu"},
        {"use_kernels": True, "fast_spectral": fast},
        torch.tensor([1.0, 0.0, 0.0]))
    assert isinstance(carry.greens, tuple)  # the kernel route's split pair
    if fast:
        assert flow_sim.unbounded_poisson_solver.fused_curl_supported(
            torch.float32, torch.device("cpu"))
    omega0 = torch.tensor(om0, requires_grad=True)
    c = carry._replace(
        flow_state=carry.flow_state._replace(primary_field=omega0))
    c2, _ = tm.scan_steps(step, c, 1)
    loss = (c2.flow_state.velocity_field ** 2).sum()
    nodes = _graph_nodes(loss)
    assert "PlainVJPBackward" in nodes  # the stencils
    exact = {"RfftPassPaddedSplitFnBackward", "FftPassPaddedFnBackward",
             "FftGreensIfftPassFnBackward", "IfftPassTruncatedFnBackward",
             "IrfftPassMergeFnBackward"}
    if fast:
        assert not nodes & {"FftGreensIfftPassFnBackward",
                            "IrfftPassMergeFnBackward"}
        assert "RfftPassPaddedSplitFnBackward" in nodes
    else:
        assert exact <= nodes
    (got,) = torch.autograd.grad(loss, omega0)
    assert torch.isfinite(got).all() and float(got.norm()) > 0.0
    assert _rel_l2(got, want) <= 1e-4


def _cylinder_case(lib, dtype, device_kw):
    flow_sim = lib.UnboundedFlowSimulator2D(
        grid_size=(32, 32), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=dtype, **device_kw)
    cyl = lib.Cylinder(center=(0.4, 0.5), radius=0.08, dtype=dtype,
                       **device_kw)
    grid = lib.CircularCylinderForcingGrid(rigid_body=cyl,
                                           num_forcing_points=16)
    interactor = lib.RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=cyl, forcing_grid=grid,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0)
    step = lib.build_rigid_fsi_step(flow_sim, interactor, dt_prefac=0.5)
    return step, lib.init_rigid_fsi_carry(flow_sim, interactor, step)


def test_cylinder_fsi_scan_gradient_matches_jax():
    jstep, jcarry = _cylinder_case(jm, jnp.float64, {})
    shape = jcarry.flow_state.primary_scalar_field.shape
    om0 = np.asarray(jcarry.flow_state.primary_scalar_field) + 0.1 * (
        np.random.default_rng(0).standard_normal(shape))

    def jloss(omega0):
        c = jcarry._replace(flow_state=jcarry.flow_state._replace(
            primary_scalar_field=omega0))
        c2, _ = jm.scan_steps(jstep, c, 2)
        return jnp.sum(c2.flow_state.velocity_field ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(om0)))
    step, carry = _cylinder_case(tm, torch.float64, {"device": "cpu"})
    omega0 = torch.tensor(om0, requires_grad=True)
    c = carry._replace(flow_state=carry.flow_state._replace(
        primary_scalar_field=omega0))
    c2, _ = tm.scan_steps(step, c, 2)
    (got,) = torch.autograd.grad((c2.flow_state.velocity_field ** 2).sum(),
                                 omega0)
    assert float(got.norm()) > 0.0
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-10 * max(1.0, float(np.abs(want).max())), err


def test_cylinder_gradient_assimilates_the_initial_amplitude():
    """Sign descent with geometric step decay on a scalar amplitude of the
    initial vorticity recovers 0.8 from the final vorticity alone."""
    torch.set_num_threads(1)
    step, carry = _cylinder_case(tm, torch.float64, {"device": "cpu"})
    shape = carry.flow_state.primary_scalar_field.shape
    base_omega = torch.tensor(np.random.default_rng(3).standard_normal(shape))
    base_u = carry.flow_state.velocity_field + 1.0

    def final_field(amplitude):
        c = carry._replace(flow_state=carry.flow_state._replace(
            primary_scalar_field=amplitude * base_omega,
            velocity_field=base_u))
        c2, _ = tm.scan_steps(step, c, 4)
        return c2.flow_state.primary_scalar_field

    with torch.no_grad():
        obs = final_field(torch.tensor(0.8, dtype=torch.float64))
    a, lr = torch.tensor(1.6, dtype=torch.float64), 0.4
    for _ in range(25):
        a.requires_grad_(True)
        (g,) = torch.autograd.grad(((final_field(a) - obs) ** 2).mean(), a)
        a = (a - lr * torch.sign(g)).detach()
        lr = max(lr * 0.7, 1e-3)
    assert abs(float(a) - 0.8) < 5e-3, float(a)


def test_sharded_flow_step_gradient_matches_one_device():
    """On the (2, 2) mesh the sharded stencil wrappers, the halo exchanges,
    the transposes and the per-shard pass wrappers carry the gradient."""
    kw = dict(device="cpu", precision="single",
              sim_kwargs={"use_kernels": True})
    grads = []
    for mesh_shape in ((2, 2), None):
        step, (carry,) = cases.sharded_flow_case((16, 16, 32), mesh_shape,
                                                 **kw)
        omega0 = carry.flow_state.primary_field.detach().clone() \
            .requires_grad_()
        c = carry._replace(
            flow_state=carry.flow_state._replace(primary_field=omega0))
        c2, _ = tm.scan_steps(step, c, 1)
        loss = (c2.flow_state.velocity_field ** 2).sum()
        if mesh_shape is not None:
            assert "PlainVJPBackward" in _graph_nodes(loss)
        (g,) = torch.autograd.grad(loss, omega0)
        if mesh_shape is not None:
            g = unshard_vector_field(g, step.flow_sim.mesh)
        grads.append(g.numpy())
    err = float(np.abs(grads[0] - grads[1]).max())
    assert float(np.abs(grads[1]).max()) > 0.0
    assert err <= 1e-4 * float(np.abs(grads[1]).max()), err
