"""The port's freely rotating rod driver
(``examples_torch/3d/flow_past_freely_rotating_rod.py``) against the JAX
package's (``examples/3d/flow_past_freely_rotating_rod.py``), fused branch,
at (32, 32, 64) on the CPU.

Run to 0.02, restart in fresh objects, run to 0.04: the ``carry`` backend
is bit-equal to the unbroken run; the ``h5`` backend to the float32
rounding of the saved fields (1e-5 max(1, |ref|)). The rod is held against
the JAX example's after the first window (5 steps) to 2e-5 of its length,
the tip tolerance of the freely rotating rod's card gate: at this size the
flow blows up at step 7 (max vorticity 40 -> 640) and the two packages'
float32 runs part there.
"""

import importlib.util
import os

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIP_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its drivers loop over many small
    ops, which gain nothing from more threads on the CPU and stall on
    thread barriers when other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(package_dir):
    """The driver of ``package_dir`` as a module of its own name."""
    name = "flow_past_freely_rotating_rod"
    spec = importlib.util.spec_from_file_location(
        f"{package_dir}_{name}",
        os.path.join(REPO, package_dir, "3d", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# the freely rotating rod, checkpoint and restart
# ---------------------------------------------------------------------------


ROD = dict(grid_size=(32, 32, 64), surface_grid_density_for_largest_element=4,
           save_interval=0.01, fused=True, window=5)


@pytest.fixture(scope="module")
def port_rod():
    return _load("examples_torch")


@pytest.fixture(scope="module")
def unbroken_rod(port_rod, tmp_path_factory):
    rod, sim = port_rod.flow_past_freely_rotating_rod_case(
        **ROD, final_time=0.04, checkpoint_backend="carry",
        restart_dir=str(tmp_path_factory.mktemp("unbroken")), device="cpu")
    return rod, sim


def _restarted(port_rod, backend, restart_dir):
    kwargs = dict(ROD, checkpoint_backend=backend, restart_dir=restart_dir,
                  device="cpu")
    _, sim1 = port_rod.flow_past_freely_rotating_rod_case(
        **kwargs, final_time=0.02)
    assert 0.04 > sim1.time >= 0.02
    return port_rod.flow_past_freely_rotating_rod_case(
        **kwargs, final_time=0.04, restart_simulation=True)


def _fields(rod, sim):
    return {"vorticity": sim.vorticity_field, "velocity": sim.velocity_field,
            **{f"rod {k}": v for k, v in rod.state._asdict().items()}}


def test_carry_restart_is_bit_equal(port_rod, unbroken_rod, tmp_path):
    rod, sim = _restarted(port_rod, "carry", str(tmp_path / "rs"))
    ref_rod, ref_sim = unbroken_rod
    assert sim.time == ref_sim.time >= 0.04
    ref = _fields(ref_rod, ref_sim)
    for name, value in _fields(rod, sim).items():
        assert torch.equal(value, ref[name]), name
    steps = sorted(os.listdir(tmp_path / "rs" / "carry"))
    assert steps and all(f.endswith(".pt") for f in steps)


def test_h5_restart_matches_to_rounding(port_rod, unbroken_rod, tmp_path):
    """The h5 backend saves the float32 flow and mismatch, the float64 rod
    and the time; the restart rebuilds the carry from them (the carried
    max |u|_1 recomputed from the velocity)."""
    rod, sim = _restarted(port_rod, "h5", str(tmp_path / "rs"))
    ref_rod, ref_sim = unbroken_rod
    assert sim.time == pytest.approx(ref_sim.time, rel=1e-6)
    ref = _fields(ref_rod, ref_sim)
    for name, value in _fields(rod, sim).items():
        tol = 1e-5 * max(1.0, float(ref[name].abs().max()))
        assert float((value - ref[name]).abs().max()) <= tol, name
    assert os.path.exists(tmp_path / "rs" / "flow_00001_eulerian.xmf")
    assert os.path.exists(tmp_path / "rs" / "forcing_grid_00001_forcing_grid.xmf")


def test_first_window_matches_the_jax_example(port_rod, tmp_path,
                                              monkeypatch):
    jax_rod = _load("examples")
    monkeypatch.chdir(tmp_path)
    kwargs = dict(ROD, final_time=0.005, checkpoint_backend="h5")
    jrod, jsim = jax_rod.flow_past_freely_rotating_rod_case(
        **kwargs, restart_dir="jax")
    rod, sim = port_rod.flow_past_freely_rotating_rod_case(
        **kwargs, restart_dir="port", device="cpu")
    assert sim.time == pytest.approx(jsim.time, rel=1e-6)
    dev = np.abs(rod.position_collection.numpy()
                 - np.asarray(jrod.position_collection)).max()
    assert dev <= TIP_TOL * 1.0, dev
    # the two packages' rod checkpoint files hold the same state arrays,
    # the same positions
    with h5py.File("jax/rod_00002.h5", "r") as jf, \
            h5py.File("port/rod_00002.h5", "r") as pf:
        assert sorted(jf) == sorted(pf)
        assert jf.attrs["time"] == pytest.approx(pf.attrs["time"], rel=1e-6)
        assert np.abs(np.asarray(jf["position"])
                      - np.asarray(pf["position"])).max() <= TIP_TOL
