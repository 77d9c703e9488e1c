"""The port's 3D flow-past-rod, rod-and-sphere and sedimenting-sphere
drivers (``examples_torch/3d/``) against the JAX package's
(``examples/3d/``), at small sizes on the CPU, the same keywords through
both, float64 flow.

- Flow past a rod at (64, 16, 64), n_elem 10, Cauchy number 10 (a soft
  rod: 29 rod substeps in the first flow step instead of 290, so the JAX
  host loop stays cheap). The fused loop starts from a sparse window too
  small for the rod (``suggest_rod_forcing_window`` wrapped in both
  packages: margin 0.5 at the first call, the default 1.1 after), trips in
  its first scan window, regrows and replays: times to 1e-9 relative, rod
  tips to 2e-5 of the rod length (1) against the JAX example's replayed
  run, and bit-equal to the port's run built with the grown window from
  the start. The host loop's tips the same against JAX; its ``FieldIO``
  files load in the JAX package's ``FieldIO`` and its ``CosseratRodIO``
  files hold the JAX example's datasets, to 1e-9 of the largest value.
- Rod and sphere at (16, 16, 32), n_elem 4: times, tips and the sphere's Cd
  to 1e-9 relative (the float64 step tolerance of ``test_torch_multibody.py``).
- Sedimenting sphere at 16^3 to 1.2 tau (two windows): times and v_z to 1e-9 relative,
  as ``test_torch_sedimenting_sphere.py``.
- No port step writes into the carry it is given (the rod driver replays a
  window from that carry).
- The sedimenting sphere on an in-process (2, 1) mesh against one device,
  1e-9 relative.
- The command lines: ``--device`` defaults to cuda and fails without a
  card; ``--n-devices 2`` runs a tiny case on an in-process (2, 1) mesh.
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
TIP_TOL = 2e-5
F64_RTOL = 1e-9


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
        f"{prefix}_3d_{name}", os.path.join(REPO, package_dir, "3d",
                                            f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# flow past a rod
# ---------------------------------------------------------------------------

ROD = dict(n_elem=10, grid_size=(64, 16, 64),
           surface_grid_density_for_largest_element=8, cauchy_number=10.0,
           precision="double")


def _small_first(suggest, calls):
    """``suggest_rod_forcing_window`` giving a window too small for the rod
    at its first call and the default one after."""
    def wrapped(interactor, rod, grid_size, margin=1.1, **kwargs):
        calls.append(margin)
        return suggest(interactor, rod, grid_size,
                       margin=0.5 if len(calls) == 1 else 1.1, **kwargs)
    return wrapped


def test_rod_forced_trip_replays_like_jax(tmp_path, monkeypatch):
    import sopht_mpi_tpu.models as jax_models

    monkeypatch.chdir(tmp_path)
    run = dict(ROD, final_time=0.035, window=5, fused=True)
    port = _load("examples_torch", "flow_past_rod")
    suggest = port.suggest_rod_forcing_window
    calls, jcalls = [], []
    monkeypatch.setattr(port, "suggest_rod_forcing_window",
                        _small_first(suggest, calls))
    times, tips = port.flow_past_rod_case(**run, device="cpu")
    monkeypatch.setattr(jax_models, "suggest_rod_forcing_window",
                        _small_first(jax_models.suggest_rod_forcing_window,
                                     jcalls))
    jtimes, jtips = _load("examples", "flow_past_rod").flow_past_rod_case(
        **run)
    # one trip and one regrow (margin 1.1 x 1.3) in each package
    assert calls == jcalls == [1.1, pytest.approx(1.43)]
    assert len(times) >= 3 and np.isfinite(tips).all()
    np.testing.assert_allclose(times, jtimes, rtol=F64_RTOL, atol=0)
    assert np.abs(tips - jtips).max() <= TIP_TOL * 1.0

    # the replayed run is the run built with the grown window from the start
    monkeypatch.setattr(port, "suggest_rod_forcing_window", suggest)
    gtimes, gtips = port.flow_past_rod_case(**run, device="cpu")
    np.testing.assert_array_equal(times, gtimes)
    np.testing.assert_array_equal(tips, gtips)


def test_rod_host_loop_matches_jax_and_files_load_in_jax(tmp_path,
                                                         monkeypatch):
    import jax.numpy as jnp

    import sopht_mpi_tpu.utils as jutils
    from sopht_mpi_tpu.models import UnboundedFlowSimulator3D

    run = dict(ROD, final_time=0.0305, fused=False, save_data=True)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
    monkeypatch.chdir(tmp_path / "port")
    times, tips = _load("examples_torch", "flow_past_rod").flow_past_rod_case(
        **run, device="cpu")
    monkeypatch.chdir(tmp_path / "jax")
    jtimes, jtips = _load("examples", "flow_past_rod").flow_past_rod_case(
        **run)
    monkeypatch.chdir(tmp_path)
    assert len(times) >= 2
    np.testing.assert_allclose(times, jtimes, rtol=F64_RTOL, atol=0)
    assert np.abs(tips - jtips).max() <= TIP_TOL * 1.0

    files = sorted(os.listdir("port"))
    assert files == sorted(os.listdir("jax"))
    assert any(f.startswith("sopht_") for f in files)
    assert any(f.startswith("rod_") for f in files)
    grid = ROD["grid_size"]
    sim = UnboundedFlowSimulator3D(
        grid_size=grid, x_range=1.8, kinematic_viscosity=1e-3,
        real_t=jnp.float64, flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True)
    io = jutils.FieldIO(dim=3, real_dtype=jnp.float64)
    io.define_eulerian_grid(
        origin=np.array([float(sim.position_field[c].min())
                         for c in (2, 1, 0)]),
        dx=sim.dx * np.ones(3), grid_size=np.asarray(grid))
    io.add_as_eulerian_fields_for_io(
        vorticity=jutils.FieldBinding(sim, "vorticity_field"))
    for name in files:
        if not name.endswith(".h5"):
            continue
        if name.startswith("sopht_"):
            time = io.load(os.path.join("port", name))
            ours = np.asarray(sim.vorticity_field)
            assert time == pytest.approx(io.load(os.path.join("jax", name)),
                                         rel=F64_RTOL)
            ref = np.asarray(sim.vorticity_field)
            assert np.abs(ours - ref).max() <= F64_RTOL * max(
                1.0, np.abs(ref).max())
            continue
        with h5py.File(os.path.join("port", name), "r") as pf, \
                h5py.File(os.path.join("jax", name), "r") as jf:
            pkeys, jkeys = [], []
            pf.visit(pkeys.append)
            jf.visit(jkeys.append)
            assert pkeys == jkeys, name
            for key in jkeys:
                if isinstance(jf[key], h5py.Dataset):
                    ref = np.asarray(jf[key])
                    assert np.abs(np.asarray(pf[key]) - ref).max() <= (
                        F64_RTOL * max(1.0, np.abs(ref).max())), key


def _carry_tensors(carry):
    from sopht_mpi_tpu_torch.utils.checkpoint import _flatten

    return {k: v.clone() for k, v in _flatten(carry).items()}


@pytest.mark.parametrize("sparse", [False, True])
def test_rod_step_leaves_its_input_carry(sparse):
    from sopht_mpi_tpu_torch import cases
    from sopht_mpi_tpu_torch.models import scan_steps

    step, carry = cases._build_rod_fsi_case((32, 32, 32), device="cpu",
                                            sparse_forcing=sparse)
    before = _carry_tensors(carry)
    scan_steps(step, carry, 2)
    after = _carry_tensors(carry)
    assert before.keys() == after.keys()
    for key, value in before.items():
        assert torch.equal(value, after[key]), key


# ---------------------------------------------------------------------------
# rod and sphere, sedimenting sphere
# ---------------------------------------------------------------------------


def test_rod_and_sphere_matches_jax():
    run = dict(grid_size=(16, 16, 32), n_elem=4,
               surface_grid_density_for_largest_element=4,
               precision="double", final_time=0.125, window=5)
    times, tips, cds = _load("examples_torch", "rod_and_sphere"
                             ).rod_and_sphere_case(**run, device="cpu")
    jtimes, jtips, jcds = _load("examples", "rod_and_sphere"
                                ).rod_and_sphere_case(**run)
    assert len(times) >= 2 and np.isfinite(cds).all()
    np.testing.assert_allclose(times, jtimes, rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(tips, jtips, rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(cds, jcds, rtol=F64_RTOL, atol=0)


def test_sedimenting_sphere_matches_jax():
    run = dict(grid_size=(16, 16, 16), n_tau=1.2, window=5)
    times, vz, v_t = _load("examples_torch", "sedimenting_sphere"
                           ).sedimenting_sphere_case(**run, device="cpu")
    jtimes, jvz, jv_t = _load("examples", "sedimenting_sphere"
                              ).sedimenting_sphere_case(**run)
    assert len(times) >= 2 and v_t == jv_t
    np.testing.assert_allclose(times, jtimes, rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(vz, jvz, rtol=F64_RTOL, atol=0)
    # the same run on an in-process (2, 1) mesh gives one device's
    from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

    mtimes, mvz, mv_t = _load("examples_torch", "sedimenting_sphere"
                              ).sedimenting_sphere_case(
        **run, mesh=create_mesh(3, (2, 1), device="cpu"), device="cpu")
    assert mv_t == v_t
    np.testing.assert_allclose(mtimes, times, rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(mvz, vz, rtol=F64_RTOL, atol=0)


# ---------------------------------------------------------------------------
# command lines
# ---------------------------------------------------------------------------


# a tiny run of each driver on the CPU: grid, final time
TINY_RUN = {
    "flow_past_rod": ["--grid-size-x", "32", "--final-time", "0.005"],
    "rod_and_sphere": ["--grid-size-x", "16", "--final-time", "0.01"],
}


def _command_line_refusals(script, mesh_args, cwd):
    """Run the script without a card (``--device`` left at cuda), which
    must fail, and, where ``mesh_args`` is given, on the CPU with them at a
    tiny grid, which must run."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    argv = [[sys.executable, script]]
    if mesh_args:
        name = os.path.splitext(os.path.basename(script))[0]
        argv.append([sys.executable, script, "--device", "cpu", *mesh_args,
                     *TINY_RUN[name]])
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=cwd)
             for a in argv]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert procs[0].returncode != 0 and "no CUDA device" in errs[0]
    if mesh_args:
        assert procs[1].returncode == 0, errs[1][-2000:]
        assert "time:" in errs[1]  # a window's log line


@pytest.mark.parametrize("name, mesh_args", [
    ("flow_past_rod", ["--n-devices", "2"]),
    ("rod_and_sphere", ["--n-devices", "2"]),
    ("sedimenting_sphere", None),
])
def test_command_line_needs_a_card_and_one_device(name, mesh_args, tmp_path):
    _command_line_refusals(
        os.path.join(REPO, "examples_torch", "3d", f"{name}.py"), mesh_args,
        tmp_path)
