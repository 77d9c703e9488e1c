"""The port's example drivers (``examples_torch/3d/``) against the JAX
package's (``examples/3d/``), at small sizes on the CPU.

- Flow past a sphere: the fused loop at 16^3 gives the JAX example's drags
  and its snapshots are the carry's fields; the host loop writes ``.h5`` /
  ``.xmf`` files that the JAX package's ``FieldIO`` loads. At 16^3 the case
  is unstable (Cd grows to ~1e4 in 30 steps) and the two packages' float32
  runs part after about 40 steps, so the drags are compared over the first
  three windows of 10 steps, at 1e-4 relative (float32 rounding of two
  differently ordered FFTs, grown by the instability).
- The freely rotating rod's checkpoint and restart: in
  ``test_torch_examples_rod.py``.
- The 32^3 point source: the L2 and Linf errors of both loops against the
  JAX example's, 1e-5 relative; on an in-process (2, 1) mesh against one
  device, 1e-6 relative (the saved fields 1e-6 absolute, float32).
- The sphere's command line: ``--n-devices 2`` runs on a (2, 1) mesh.
"""

import importlib.util
import os

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAG_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its drivers loop over many small
    ops, which gain nothing from more threads on the CPU and stall on
    thread barriers when other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(package_dir, name):
    """An example file as a module of its own name (``port_<name>`` or
    ``jax_<name>``), so it shadows no other test's import."""
    prefix = "port" if package_dir == "examples_torch" else "jax"
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{name}", os.path.join(REPO, package_dir, "3d", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_sphere():
    return _load("examples_torch", "flow_past_sphere")


# ---------------------------------------------------------------------------
# flow past a sphere
# ---------------------------------------------------------------------------


# three windows: t* = 0.2054, 0.2158, 0.2254
SPHERE_FUSED = dict(nondim_time=0.22, grid_size=(16, 16, 16), window=10)


def test_fused_sphere_matches_jax_and_snapshots_the_carry(
        tmp_path, monkeypatch, port_sphere):
    monkeypatch.chdir(tmp_path)
    carries = []
    scan = port_sphere.scan_steps

    def recording_scan(step, carry, n):
        carry, diag = scan(step, carry, n)
        carries.append(carry)
        return carry, diag

    monkeypatch.setattr(port_sphere, "scan_steps", recording_scan)
    times, cds = port_sphere.flow_past_sphere_fused_case(
        **SPHERE_FUSED, save_interval=1e-9, device="cpu")
    assert len(cds) == 3, cds

    jax_sphere = _load("examples", "flow_past_sphere")
    os.makedirs("jax")
    monkeypatch.chdir(tmp_path / "jax")
    jtimes, jcds = jax_sphere.flow_past_sphere_fused_case(**SPHERE_FUSED)
    monkeypatch.chdir(tmp_path)
    np.testing.assert_allclose(times, jtimes, rtol=DRAG_RTOL)
    np.testing.assert_allclose(cds, jcds, rtol=DRAG_RTOL)

    # a snapshot at every window end, each the carry's fields at that end
    manifest = np.loadtxt("snapshots/times.csv", delimiter=",", skiprows=1)
    assert manifest.shape == (3, 2)
    np.testing.assert_array_equal(manifest[:, 0], np.arange(3))
    for k, carry in enumerate(carries):
        assert manifest[k, 1] == float(carry.time)
        for name, field in (("vorticity", carry.flow_state.primary_field),
                            ("velocity", carry.flow_state.velocity_field)):
            np.testing.assert_array_equal(
                np.load(f"snapshots/{name}_{k:04d}.npy"), field.numpy())
    drag = np.loadtxt("drag_vs_time.csv", delimiter=",")
    np.testing.assert_array_equal(drag, np.c_[times, cds])


def test_host_loop_sphere_files_load_in_jax(tmp_path, monkeypatch,
                                           port_sphere):
    """The host loop's ``FieldIO`` saves (flow and the sphere's forcing
    grid) load in the JAX package's ``FieldIO``, built on the JAX case's
    own grid and forcing grid; the sidecars are the ones the JAX package
    writes for those files."""
    import jax.numpy as jnp

    import sopht_mpi_tpu.utils as jutils
    from sopht_mpi_tpu.models import (
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )

    monkeypatch.chdir(tmp_path)
    grid = (16, 16, 16)
    times, cds = port_sphere.flow_past_sphere_case(
        nondim_time=0.3, grid_size=grid, save_flow_data=True, device="cpu")
    assert len(times) == 3 and np.isfinite(cds).all()
    stamps = [f"{int(t * 100):04d}" for t in times]
    assert sorted(f for f in os.listdir() if f.endswith(".h5")) == sorted(
        [f"sopht_{s}.h5" for s in stamps] + [f"sphere_{s}.h5" for s in stamps])

    sim = UnboundedFlowSimulator3D(
        grid_size=grid, x_range=1.0, kinematic_viscosity=0.004,
        real_t=jnp.float32, flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True)
    sphere = Sphere(center=np.array([0.25, 0.5, 0.5]), radius=0.2,
                    dtype=jnp.float32)
    forcing_grid = SphereForcingGrid(rigid_body=sphere,
                                     num_forcing_points_along_equator=12)
    io = jutils.FieldIO(dim=3, real_dtype=jnp.float32)
    io.define_eulerian_grid(
        origin=np.array([float(sim.position_field[c].min())
                         for c in (2, 1, 0)]),
        dx=sim.dx * np.ones(3), grid_size=np.asarray(grid))
    io.add_as_eulerian_fields_for_io(
        vorticity=jutils.FieldBinding(sim, "vorticity_field"),
        velocity=jutils.FieldBinding(sim, "velocity_field"))
    sphere_io = jutils.FieldIO(dim=3, real_dtype=jnp.float32)

    class Holder:
        grid = jnp.zeros_like(forcing_grid.compute_lag_grid_position_field())

    sphere_io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=jutils.FieldBinding(Holder, "grid"),
        lagrangian_grid_name="sphere")
    for t, s in zip(times, stamps):
        assert io.load(f"sopht_{s}.h5") == t
        with h5py.File(f"sopht_{s}.h5", "r") as f:
            np.testing.assert_array_equal(
                np.asarray(sim.velocity_field[0]), f["Eulerian/Vector/velocity_0"])
        assert sphere_io.load(f"sphere_{s}.h5") == t
        np.testing.assert_allclose(
            np.asarray(Holder.grid),
            np.asarray(forcing_grid.compute_lag_grid_position_field()),
            rtol=0, atol=1e-6)
        port_xmf = {side: open(side).read() for side in
                    (f"sopht_{s}_eulerian.xmf", f"sphere_{s}_sphere.xmf")}
        io.generate_xdmf_eulerian(f"sopht_{s}.h5", time=t)
        sphere_io.generate_xdmf_lagrangian(f"sphere_{s}.h5", time=t)
        for side, text in port_xmf.items():
            assert open(side).read() == text, side


def test_sphere_command_line_needs_a_card_and_one_device(tmp_path):
    """``--device`` defaults to cuda and fails without a card; ``--n-devices
    2 --device cpu`` runs the fused loop on an in-process (2, 1) mesh at a
    tiny grid and writes its drags."""
    import subprocess
    import sys

    script = os.path.join(REPO, "examples_torch", "3d", "flow_past_sphere.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script, "--grid-size-x", "8"],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    proc = subprocess.run([sys.executable, script, "--device", "cpu",
                           "--n-devices", "2", "--grid-size-x", "16",
                           "--nondim-time", "0.01"],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    drags = np.loadtxt(tmp_path / "drag_vs_time.csv", delimiter=",",
                       ndmin=2)
    assert drags.shape == (1, 2) and np.isfinite(drags).all()


# ---------------------------------------------------------------------------
# the point source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
def test_point_source_errors_match_jax(tmp_path, monkeypatch, fused):
    monkeypatch.chdir(tmp_path)
    port = _load("examples_torch", "point_source_advect_diffuse")
    jax_ps = _load("examples", "point_source_advect_diffuse")
    grid = (32, 32, 32)
    l2, linf = port.point_source_advection_diffusion_case(
        grid_size=grid, fused=fused, save_data=not fused, device="cpu")
    jl2, jlinf = jax_ps.point_source_advection_diffusion_case(
        grid_size=grid, fused=fused)
    assert l2 == pytest.approx(float(jl2), rel=1e-5)
    assert linf == pytest.approx(float(jlinf), rel=1e-5)
    if not fused:
        saved = sorted(f for f in os.listdir() if f.endswith(".h5"))
        assert len(saved) >= 20
        with h5py.File(saved[0], "r") as f:
            assert f.attrs["time"] == 5.0
            assert f["Eulerian/Vector/vorticity_0"].shape == grid


def test_point_source_on_a_mesh(tmp_path, monkeypatch):
    """The driver on an in-process (2, 1) mesh gives one device's errors;
    its host loop's ``FieldIO`` saves on the mesh write the assembled
    field, the same files one device writes."""
    from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

    port = _load("examples_torch", "point_source_advect_diffuse")
    grid = (16, 16, 16)
    one = port.point_source_advection_diffusion_case(
        grid_size=grid, fused=True, device="cpu")
    mesh = create_mesh(3, (2, 1), device="cpu")
    sharded = port.point_source_advection_diffusion_case(
        grid_size=grid, fused=True, mesh=mesh, device="cpu")
    assert sharded == pytest.approx(one, rel=1e-6)
    saved = {}
    for name, m in (("one", None), ("mesh", mesh)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        errors = port.point_source_advection_diffusion_case(
            grid_size=grid, save_data=True, mesh=m, device="cpu")
        files = sorted(f for f in os.listdir() if f.endswith(".h5"))
        assert len(files) >= 20
        with h5py.File(files[-1], "r") as f:
            assert f["Eulerian/Vector/vorticity_0"].shape == grid
            saved[name] = (errors, files, np.stack(
                [np.asarray(f[f"Eulerian/Vector/vorticity_{c}"])
                 for c in range(3)]))
    assert saved["mesh"][0] == pytest.approx(saved["one"][0], rel=1e-6)
    assert saved["mesh"][1] == saved["one"][1]
    np.testing.assert_allclose(saved["mesh"][2], saved["one"][2], rtol=0,
                               atol=1e-6)
