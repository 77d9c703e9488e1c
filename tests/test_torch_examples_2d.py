"""The port's 2D drivers (``examples_torch/2d/``) against the JAX package's
(``examples/2d/``), at small sizes on the CPU, the same keywords through
both.

- Lamb-Oseen vortex at 32^2, both loops: the L2 and Linf errors to 1e-5
  relative; ``plot`` writes the host loop's frames and is refused with the
  fused loop, as in the JAX example.
- Flow past a cylinder at (32, 64), float64 (the flow at this size is
  violent, Cd in the hundreds, and float32 runs part at 4e-4 in ten
  steps): the fused loop's t* and Cd to 1e-9 relative (``TOL["double"]``
  of ``test_torch_cylinder_fsi.py``); the host loop's drag history the
  same, its ``drag_vs_time.csv`` the returned arrays, its frames assembled
  into a movie (a GIF without ffmpeg).
- Flow past a rod at (32, 64), float32 flow: the tip history of both loops
  to 1e-4 (``TOL`` of ``test_torch_rod_2d.py``, of the rod length); the
  host loop's ``--save-flow-data`` files: the flow files load in the JAX
  package's 2D ``FieldIO``, and the flow and rod files hold the JAX
  example's datasets, to 1e-4 of the largest value.
- The command lines: ``--device`` defaults to cuda and fails without a
  card; ``--n-devices 2`` runs the flow on an in-process (2, 1) mesh and
  matches one device.
"""

import importlib.util
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMB_OSEEN_RTOL = 1e-5
F32_TOL = 1e-4
F64_TOL = 1e-9


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
    """An example file as a module of its own name."""
    prefix = "port" if package_dir == "examples_torch" else "jax"
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_2d_{name}", os.path.join(REPO, package_dir, "2d",
                                            f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _both(name):
    return _load("examples_torch", name), _load("examples", name)


@pytest.mark.parametrize("fused", [True, False])
def test_lamb_oseen_errors_match_jax(fused):
    port, jax_lo = _both("lamb_oseen_vortex")
    run = dict(grid_size=(32, 32), fused=fused, window=20)
    l2, linf = port.lamb_oseen_vortex_flow_case(**run, device="cpu")
    jl2, jlinf = jax_lo.lamb_oseen_vortex_flow_case(**run)
    assert l2 == pytest.approx(float(jl2), rel=LAMB_OSEEN_RTOL)
    assert linf == pytest.approx(float(jlinf), rel=LAMB_OSEEN_RTOL)


def test_lamb_oseen_plot_writes_the_host_loop_frames(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port = _load("examples_torch", "lamb_oseen_vortex")
    with pytest.raises(ValueError, match="plot"):
        port.lamb_oseen_vortex_flow_case(grid_size=(16, 16), fused=True,
                                         plot=True, device="cpu")
    port.lamb_oseen_vortex_flow_case(grid_size=(16, 16), plot=True,
                                     device="cpu")
    frames = sorted(f for f in os.listdir() if f.startswith("snap_"))
    assert len(frames) >= 10 and all(f.endswith(".png") for f in frames)


CYLINDER = dict(grid_size=(32, 64), precision="double")


def test_cylinder_fused_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port, jax_cyl = _both("flow_past_cylinder")
    run = dict(CYLINDER, nondim_final_time=8.0, window=10)
    times, cds = port.flow_past_cylinder_fused_case(**run, device="cpu")
    np.testing.assert_array_equal(
        np.loadtxt("drag_vs_time.csv", delimiter=",", ndmin=2),
        np.c_[times, cds])
    jtimes, jcds = jax_cyl.flow_past_cylinder_fused_case(**run)
    assert len(times) >= 2
    np.testing.assert_allclose(times, jtimes, rtol=F64_TOL)
    np.testing.assert_allclose(cds, jcds, rtol=F64_TOL)


def test_cylinder_host_loop_matches_jax_and_makes_a_movie(tmp_path,
                                                          monkeypatch):
    port, jax_cyl = _both("flow_past_cylinder")
    run = dict(CYLINDER, nondim_final_time=8.0, save_diagnostic=True)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "port")
    times, cds = port.flow_past_cylinder_boundary_forcing_case(
        **run, plot=True, device="cpu")
    np.testing.assert_array_equal(
        np.loadtxt("drag_vs_time.csv", delimiter=",", ndmin=2),
        np.c_[times, cds])
    frames = [f for f in os.listdir() if f.startswith("snap_")]
    movies = [f for f in os.listdir() if f.startswith("flow.")]
    assert len(frames) >= 2 and len(movies) == 1
    monkeypatch.chdir(tmp_path / "jax")
    jtimes, jcds = jax_cyl.flow_past_cylinder_boundary_forcing_case(**run)
    assert len(times) >= 3
    np.testing.assert_allclose(times, jtimes, rtol=F64_TOL)
    np.testing.assert_allclose(cds, jcds, rtol=F64_TOL, atol=F64_TOL)


ROD = dict(grid_size=(32, 64))


def test_rod_fused_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port, jax_rod = _both("flow_past_rod")
    run = dict(ROD, nondim_final_time=0.3, fused=True, window=10)
    times, tips = port.flow_past_rod_case(**run, device="cpu")
    saved = np.loadtxt("rod_tip_position_vs_time.csv", delimiter=",",
                       ndmin=2)
    np.testing.assert_allclose(saved, np.c_[times, tips], rtol=1e-15)
    jtimes, jtips = jax_rod.flow_past_rod_case(**run)
    assert len(times) >= 3 and np.isfinite(tips).all()
    np.testing.assert_allclose(times, jtimes, rtol=F32_TOL)
    assert np.abs(tips - jtips).max() <= F32_TOL


def test_rod_host_loop_files_load_in_jax(tmp_path, monkeypatch):
    import jax.numpy as jnp

    import sopht_mpi_tpu.utils as jutils
    from sopht_mpi_tpu.models import UnboundedFlowSimulator2D

    port, jax_rod = _both("flow_past_rod")
    run = dict(ROD, nondim_final_time=0.2, fused=False, save_flow_data=True)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "port")
    times, tips = port.flow_past_rod_case(**run, device="cpu")
    monkeypatch.chdir(tmp_path / "jax")
    jtimes, jtips = jax_rod.flow_past_rod_case(**run)
    monkeypatch.chdir(tmp_path)
    assert len(times) >= 2
    np.testing.assert_allclose(times, jtimes, rtol=F32_TOL)
    assert np.abs(tips - jtips).max() <= F32_TOL
    with pytest.raises(ValueError, match="save_flow_data"):
        port.flow_past_rod_case(**dict(run, fused=True), device="cpu")

    files = sorted(os.listdir("port"))
    assert files == sorted(os.listdir("jax"))
    h5 = [f for f in files if f.endswith(".h5")]
    assert any(f.startswith("sopht_") for f in h5)
    assert any(f.startswith("rod_") for f in h5)
    grid = ROD["grid_size"]
    sim = UnboundedFlowSimulator2D(
        grid_size=grid, x_range=6.0, kinematic_viscosity=5e-3,
        real_t=jnp.float32, flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True)
    io = jutils.FieldIO(dim=2, real_dtype=jnp.float32)
    io.define_eulerian_grid(
        origin=np.array([float(sim.position_field[c].min()) for c in (1, 0)]),
        dx=sim.dx * np.ones(2), grid_size=np.asarray(grid))
    io.add_as_eulerian_fields_for_io(
        vorticity=jutils.FieldBinding(sim, "vorticity_field"),
        velocity=jutils.FieldBinding(sim, "velocity_field"))
    for name in h5:
        if name.startswith("sopht_"):
            time = io.load(os.path.join("port", name))
            assert time == pytest.approx(io.load(os.path.join("jax", name)),
                                         rel=F32_TOL)
        with h5py.File(os.path.join("port", name), "r") as pf, \
                h5py.File(os.path.join("jax", name), "r") as jf:
            pkeys, jkeys = [], []
            pf.visit(pkeys.append)
            jf.visit(jkeys.append)
            assert pkeys == jkeys, name
            for key in jkeys:
                if isinstance(jf[key], h5py.Dataset):
                    ref = np.asarray(jf[key])
                    out = np.asarray(pf[key])
                    assert out.shape == ref.shape and out.dtype == ref.dtype
                    assert np.abs(out - ref).max() <= F32_TOL * max(
                        1.0, np.abs(ref).max()), (name, key)


#: small host-loop runs of each driver's command line, and what a run leaves
#: to compare: the L2 error it logs, or the CSV it writes
CLI_RUNS = {
    "lamb_oseen_vortex": (["--grid-size", "16", "--host-loop",
                           "--precision", "double"], None),
    "flow_past_cylinder": (["--grid-size-x", "32", "--final-time", "1",
                            "--reynolds", "2", "--host-loop"],
                           "drag_vs_time.csv"),
    "flow_past_rod": (["--grid-size-x", "32", "--final-time", "0.8",
                       "--host-loop", "--precision", "double"],
                      "rod_tip_position_vs_time.csv"),
}


@pytest.mark.parametrize("name", ["lamb_oseen_vortex", "flow_past_cylinder",
                                  "flow_past_rod"])
def test_command_line_needs_a_card_and_one_device(name, tmp_path):
    """Without ``--device cpu`` the example needs a card; with it,
    ``--n-devices 2`` runs the flow on an in-process (2, 1) mesh and gives
    one device's result (the logged L2 error, or the CSV; float64 to
    1e-9, the float32 cylinder to ``F32_TOL``, relative)."""
    script = os.path.join(REPO, "examples_torch", "2d", f"{name}.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    args, csv = CLI_RUNS[name]
    dirs = [tmp_path / "card", tmp_path / "one", tmp_path / "two"]
    argvs = [[sys.executable, script]] + [
        [sys.executable, script, "--device", "cpu", *args, "--n-devices", n]
        for n in ("1", "2")]
    procs = []
    for d, argv in zip(dirs, argvs):
        d.mkdir()
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env, cwd=d))
    errs = [p.communicate(timeout=180)[1] for p in procs]
    assert procs[0].returncode != 0 and "no CUDA device" in errs[0]
    assert procs[1].returncode == 0, errs[1]
    assert procs[2].returncode == 0, errs[2]
    if csv is None:
        one, two = (float(e.split("vorticity L2 error:")[1].split()[0])
                    for e in errs[1:])
        assert two == pytest.approx(one, rel=F64_TOL)
        return
    one, two = (np.loadtxt(d / csv, delimiter=",") for d in dirs[1:])
    assert one.shape == two.shape and one.shape[0] >= 2
    tol = F32_TOL if name == "flow_past_cylinder" else F64_TOL
    np.testing.assert_allclose(two, one, rtol=tol, atol=0)
