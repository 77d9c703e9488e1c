"""The port's field IO (``sopht_mpi_tpu_torch.utils.io``) against the JAX
package's (``sopht_mpi_tpu.utils.io``).

The JAX package's own IO cases (``tests/test_utils/test_io.py``), on
tensors; the per-shard dumps of a mesh's fields are in
``test_torch_mesh_io.py``. Files
written by either package load in the other with equal arrays and time, and
the XDMF sidecars' text is identical. The arrays go through the file
unchanged, so every comparison is exact.
"""

import os
import subprocess
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.utils as jutils
import sopht_mpi_tpu_torch.utils as tutils
from sopht_mpi_tpu.models import CosseratRod as JaxCosseratRod
from sopht_mpi_tpu_torch.models import CosseratRod
from sopht_mpi_tpu_torch.utils import (
    CosseratRodIO,
    FieldBinding,
    FieldIO,
    get_real_t,
    load_rod_state,
    save_rod_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Holder:
    pass


def _io(dim, real_t, grid_size, origin=None, dx=0.1, package=None, **fields):
    """A FieldIO of ``package`` (the port's by default) on a grid of
    ``grid_size`` with Eulerian ``fields`` registered."""
    io = (package or tutils).FieldIO(dim=dim, real_dtype=real_t)
    io.define_eulerian_grid(
        origin=np.zeros(dim) if origin is None else origin,
        dx=np.full(dim, dx), grid_size=np.array(grid_size))
    io.add_as_eulerian_fields_for_io(**fields)
    return io


@pytest.mark.parametrize("dim", [2, 3])
def test_eulerian_scalar_and_vector_roundtrip(tmp_path, dim, precision):
    real_t = get_real_t(precision)
    rng = np.random.default_rng(5)
    grid_size = (8,) * dim
    holder = Holder()
    holder.scalar = torch.tensor(rng.standard_normal(grid_size), dtype=real_t)
    holder.vector = torch.tensor(rng.standard_normal((dim, *grid_size)),
                                 dtype=real_t)
    io = _io(dim, real_t, grid_size, scalar=FieldBinding(holder, "scalar"),
             vector=FieldBinding(holder, "vector"))
    f = str(tmp_path / "flow.h5")
    io.save(f, time=1.5)
    assert os.path.exists(f)
    assert os.path.exists(str(tmp_path / "flow_eulerian.xmf"))

    saved = {k: getattr(holder, k).clone() for k in ("scalar", "vector")}
    holder.scalar = torch.zeros_like(holder.scalar)
    holder.vector = torch.zeros_like(holder.vector)
    assert io.load(f) == pytest.approx(1.5)
    for k, want in saved.items():
        got = getattr(holder, k)
        assert got.dtype == real_t and got.device == want.device
        assert torch.equal(got, want)


def test_load_validates_grid_parameters(tmp_path, precision):
    real_t = get_real_t(precision)
    holder = Holder()
    holder.scalar = torch.zeros((8, 8), dtype=real_t)
    f = str(tmp_path / "flow.h5")
    _io(2, real_t, (8, 8), scalar=FieldBinding(holder, "scalar")).save(f)
    io2 = _io(2, real_t, (8, 8), origin=np.ones(2),
              scalar=FieldBinding(holder, "scalar"))
    with pytest.raises(AssertionError):
        io2.load(f)


@pytest.mark.parametrize("mismatch", ["origin", "dx", "grid_size"])
def test_load_rejects_each_mismatched_grid_parameter(tmp_path, mismatch):
    real_t = get_real_t("single")
    holder = Holder()
    holder.scalar = torch.zeros((8, 8), dtype=real_t)
    f = str(tmp_path / "flow.h5")
    _io(2, real_t, (8, 8), scalar=FieldBinding(holder, "scalar")).save(f)
    kwargs = dict(origin=np.zeros(2), dx=0.1, grid_size=(8, 8))
    if mismatch == "origin":
        kwargs["origin"] = np.full(2, 0.3)
    elif mismatch == "dx":
        kwargs["dx"] = 0.2
    else:
        kwargs["grid_size"] = (16, 16)
        holder.scalar = torch.zeros((16, 16), dtype=real_t)
    io2 = _io(2, real_t, scalar=FieldBinding(holder, "scalar"), **kwargs)
    with pytest.raises(AssertionError):
        io2.load(f)


def test_lagrangian_fields_roundtrip(tmp_path, precision):
    real_t = get_real_t(precision)
    rng = np.random.default_rng(7)
    holder = Holder()
    holder.grid = torch.tensor(rng.standard_normal((2, 12)), dtype=real_t)
    holder.force = torch.tensor(rng.standard_normal((2, 12)), dtype=real_t)
    holder.radius = torch.tensor(rng.random(12), dtype=real_t)
    io = FieldIO(dim=2, real_dtype=real_t)
    io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=FieldBinding(holder, "grid"),
        lagrangian_grid_name="markers",
        lagrangian_grid_connect=True,
        force=FieldBinding(holder, "force"),
        radius=FieldBinding(holder, "radius"),
    )
    f = str(tmp_path / "lag.h5")
    io.save(f, time=0.25)
    assert os.path.exists(str(tmp_path / "lag_markers.xmf"))
    saved = {k: getattr(holder, k).clone() for k in ("grid", "force", "radius")}
    for k in saved:
        setattr(holder, k, torch.zeros_like(getattr(holder, k)))
    assert io.load(f) == pytest.approx(0.25)
    for k, want in saved.items():
        assert torch.equal(getattr(holder, k), want)


@pytest.mark.parametrize("dim", [2, 3])
def test_multiple_fields_anisotropic_grid_roundtrip(tmp_path, dim, precision):
    real_t = get_real_t(precision)
    rng = np.random.default_rng(11)
    grid_size = (4, 8) if dim == 2 else (4, 6, 8)
    holder = Holder()
    holder.vort = torch.tensor(rng.standard_normal(grid_size), dtype=real_t)
    holder.press = torch.tensor(rng.standard_normal(grid_size), dtype=real_t)
    holder.vel = torch.tensor(rng.standard_normal((dim, *grid_size)),
                              dtype=real_t)
    io = _io(dim, real_t, grid_size, origin=np.arange(dim, dtype=float),
             dx=0.05, vort=FieldBinding(holder, "vort"),
             press=FieldBinding(holder, "press"),
             vel=FieldBinding(holder, "vel"))
    f = str(tmp_path / "multi.h5")
    io.save(f, time=4.25)
    saved = {k: getattr(holder, k).clone() for k in ("vort", "press", "vel")}
    for k in saved:
        setattr(holder, k, torch.zeros_like(getattr(holder, k)))
    assert io.load(f) == pytest.approx(4.25)
    for k, want in saved.items():
        assert torch.equal(getattr(holder, k), want)


def test_multiple_lagrangian_grids_roundtrip(tmp_path, precision):
    real_t = get_real_t(precision)
    rng = np.random.default_rng(13)
    holder = Holder()
    holder.rod_pos = torch.tensor(rng.standard_normal((3, 9)), dtype=real_t)
    holder.rod_radius = torch.tensor(rng.random(9), dtype=real_t)
    holder.sph_pos = torch.tensor(rng.standard_normal((3, 5)), dtype=real_t)
    holder.sph_force = torch.tensor(rng.standard_normal((3, 5)), dtype=real_t)
    io = FieldIO(dim=3, real_dtype=real_t)
    io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=FieldBinding(holder, "rod_pos"),
        lagrangian_grid_name="rod",
        lagrangian_grid_connect=True,
        radius=FieldBinding(holder, "rod_radius"),
    )
    io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=FieldBinding(holder, "sph_pos"),
        lagrangian_grid_name="sphere",
        force=FieldBinding(holder, "sph_force"),
    )
    f = str(tmp_path / "two_grids.h5")
    io.save(f, time=0.5)
    assert os.path.exists(str(tmp_path / "two_grids_rod.xmf"))
    assert os.path.exists(str(tmp_path / "two_grids_sphere.xmf"))
    saved = {k: getattr(holder, k).clone()
             for k in ("rod_pos", "rod_radius", "sph_pos", "sph_force")}
    for k in saved:
        setattr(holder, k, torch.zeros_like(getattr(holder, k)))
    assert io.load(f) == pytest.approx(0.5)
    for k, want in saved.items():
        assert torch.equal(getattr(holder, k), want)


def test_load_missing_field_raises(tmp_path):
    real_t = get_real_t("single")
    holder = Holder()
    holder.a = torch.zeros((4, 4), dtype=real_t)
    holder.b = torch.zeros((4, 4), dtype=real_t)
    f = str(tmp_path / "one.h5")
    _io(2, real_t, (4, 4), a=FieldBinding(holder, "a")).save(f)
    io2 = _io(2, real_t, (4, 4), a=FieldBinding(holder, "a"),
              b=FieldBinding(holder, "b"))
    with pytest.raises(KeyError):
        io2.load(f)


@pytest.mark.parametrize("real_t", [torch.float32, torch.float64, np.float32])
def test_on_disk_dtype_matches_real_dtype(tmp_path, real_t):
    """The declared dtype (torch or numpy) is the datasets' dtype, whatever
    the field's, and sets the sidecars' precision."""
    holder = Holder()
    holder.s = torch.ones((4, 4), dtype=torch.float64)
    io = _io(2, real_t, (4, 4), s=FieldBinding(holder, "s"))
    f = str(tmp_path / "dtype.h5")
    io.save(f)
    want = torch.empty((), dtype=real_t).numpy().dtype if isinstance(
        real_t, torch.dtype) else np.dtype(real_t)
    with h5py.File(f, "r") as h:
        assert h["Eulerian/Scalar/s"].dtype == want
    assert io.precision == (8 if want == np.float64 else 4)


def test_binding_set_keeps_the_bound_tensor_s_dtype(tmp_path):
    """A load puts the array back in the bound tensor's dtype (float64 on
    disk, float32 in memory) and as a tensor; a numpy attribute stays
    numpy."""
    holder = Holder()
    holder.t = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    holder.a = np.arange(16, dtype=np.float32).reshape(4, 4)
    io = _io(2, np.float64, (4, 4), t=FieldBinding(holder, "t"),
             a=FieldBinding(holder, "a"))
    f = str(tmp_path / "b.h5")
    io.save(f)
    holder.t = torch.zeros((4, 4), dtype=torch.float32)
    holder.a = np.zeros((4, 4), dtype=np.float32)
    io.load(f)
    assert holder.t.dtype == torch.float32
    assert torch.equal(holder.t, torch.arange(16.0).reshape(4, 4))
    assert isinstance(holder.a, np.ndarray) and holder.a.dtype == np.float32
    assert io.loaded_fields["t"].dtype == np.float64


def test_snapshot_and_getter_bindings(tmp_path):
    """A raw tensor saves as it was registered (load fills
    ``loaded_fields``); a callable is save-only."""
    calls = []
    live = torch.ones((4, 4))

    def getter():
        calls.append(1)
        return live * 2

    io = _io(2, torch.float32, (4, 4), snap=torch.full((4, 4), 3.0),
             live=getter)
    f = str(tmp_path / "s.h5")
    io.save(f, time=torch.tensor(2.0))
    io.load(f)
    np.testing.assert_array_equal(io.loaded_fields["snap"], 3.0)
    np.testing.assert_array_equal(io.loaded_fields["live"], 2.0)
    assert calls  # read at registration and at the save
    with h5py.File(f, "r") as h:
        assert h.attrs["time"] == 2.0


def test_cosserat_rod_io_and_state_checkpoint(tmp_path):
    def rod(start, direction, normal):
        return CosseratRod.straight_rod(
            10, start, direction, normal, base_length=1.0, base_radius=0.02,
            density=1e3, youngs_modulus=1e6, shear_modulus=1e4, device="cpu")

    rod1 = rod(np.zeros(3), np.array([0.0, 0.0, 1.0]),
               np.array([0.0, 1.0, 0.0]))
    rod_io = CosseratRodIO(cosserat_rod=rod1, real_dtype=np.float64)
    f = str(tmp_path / "rod.h5")
    rod_io.save(f, time=2.0)
    assert os.path.exists(str(tmp_path / "rod_rod.xmf"))
    with h5py.File(f, "r") as h:
        pos = rod1.position_collection.numpy()
        np.testing.assert_array_equal(h["rod/position"],
                                      0.5 * (pos[:, 1:] + pos[:, :-1]))
        np.testing.assert_array_equal(h["rod/Connection"], np.arange(10))

    rod1.velocity_collection = torch.tensor(
        np.random.default_rng(1).standard_normal((3, 11)))
    sf = str(tmp_path / "rod_state.h5")
    save_rod_state(rod1, sf, time=3.0)
    rod2 = rod(np.ones(3), np.array([0.0, 1.0, 0.0]),
               np.array([1.0, 0.0, 0.0]))
    assert load_rod_state(rod2, sf) == pytest.approx(3.0)
    for name in ("position", "velocity", "director", "omega"):
        got, want = getattr(rod2.state, name), getattr(rod1.state, name)
        assert got.dtype == torch.float64 and torch.equal(got, want), name


def test_xdmf_sidecars_reference_h5_and_dims(tmp_path):
    holder = Holder()
    holder.s = torch.zeros((4, 6, 8))
    holder.markers = torch.zeros((3, 7))
    io = _io(3, torch.float32, (4, 6, 8), s=FieldBinding(holder, "s"))
    io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=FieldBinding(holder, "markers"),
        lagrangian_grid_name="markers",
    )
    f = str(tmp_path / "viz.h5")
    io.save(f, time=1.0)
    eul = (tmp_path / "viz_eulerian.xmf").read_text()
    assert "viz.h5" in eul
    assert 'Dimensions="4    6    8"' in eul
    assert "3DCORECTMesh" in eul and "ORIGIN_DXDYDZ" in eul
    lag = (tmp_path / "viz_markers.xmf").read_text()
    assert "viz.h5" in lag and "7" in lag


def test_sharded_io_waits_for_the_mesh(tmp_path):
    """The per-shard dumps of a field that is not sharded write one block
    at the origin and load it back, in a file the JAX package reads; a
    mesh simulator's fields save and load through ``FieldIO`` and the
    per-shard dumps (one dataset a shard)."""
    from sopht_mpi_tpu_torch.models import UnboundedFlowSimulator3D
    from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

    holder = Holder()
    field = torch.tensor(np.random.default_rng(3).standard_normal((4, 4, 4)),
                         dtype=torch.float32)
    holder.s = field.clone()
    io = _io(3, torch.float32, (4, 4, 4), s=FieldBinding(holder, "s"))
    io.save_eulerian_sharded(str(tmp_path / "x"), time=0.5)
    with h5py.File(str(tmp_path / "x") + ".proc0.h5", "r") as f:
        assert list(f["s"]) == ["shard_d0"]
        assert list(f["s/shard_d0"].attrs["start"]) == [0, 0, 0]
        assert list(f["s"].attrs["global_shape"]) == [4, 4, 4]
    holder.s = torch.zeros_like(field)
    assert io.load_eulerian_sharded(str(tmp_path / "x")) == 0.5
    assert torch.equal(holder.s, field)
    jholder = Holder()
    jholder.s = jnp.zeros((4, 4, 4), jnp.float32)
    jio = jutils.FieldIO(dim=3, real_dtype=np.float32)
    jio.define_eulerian_grid(origin=np.zeros(3), dx=np.full(3, 0.1),
                             grid_size=np.array((4, 4, 4)))
    jio.add_as_eulerian_fields_for_io(s=jutils.FieldBinding(jholder, "s"))
    assert jio.load_eulerian_sharded(str(tmp_path / "x")) == 0.5
    np.testing.assert_array_equal(np.asarray(jholder.s), field.numpy())

    mesh = create_mesh(3, (2, 1), device="cpu")
    sim = UnboundedFlowSimulator3D(
        (8, 8, 8), 1.0, 1e-3, flow_type="navier_stokes", device="cpu",
        mesh=mesh)
    sim.vorticity_field = torch.randn(sim.vorticity_field.shape)
    kept = sim.vorticity_field.clone()
    vio = _io(3, torch.float32, (8, 8, 8),
              vorticity=FieldBinding(sim, "vorticity_field"))
    vio.save(str(tmp_path / "v.h5"), time=1.0)
    vio.save_eulerian_sharded(str(tmp_path / "v"), time=1.0)
    with h5py.File(str(tmp_path / "v") + ".proc0.h5", "r") as f:
        assert sorted(f["vorticity"]) == ["shard_d0", "shard_d1"]
        assert list(f["vorticity/shard_d1"].attrs["start"]) == [0, 4, 0, 0]
    for load, name in ((vio.load, "v.h5"), (vio.load_eulerian_sharded, "v")):
        sim.vorticity_field = torch.zeros_like(kept)
        assert load(str(tmp_path / name)) == 1.0
        assert torch.equal(sim.vorticity_field, kept)


# ---------------------------------------------------------------------------
# files across the two packages
# ---------------------------------------------------------------------------


def _cross_fields(dim, rng):
    grid_size = (4, 6, 8)[-dim:]
    return grid_size, {
        "scalar": rng.standard_normal(grid_size),
        "vector": rng.standard_normal((dim, *grid_size)),
        "grid": rng.standard_normal((dim, 7)),
        "force": rng.standard_normal((dim, 7)),
        "radius": rng.random(7),
    }


def _write(package, dim, real_t, grid_size, arrays, name, time):
    """Save ``arrays`` through ``package``'s FieldIO (bound as the package's
    arrays: jnp for the JAX package, tensors for the port) to ``name``."""
    holder = Holder()
    to = ((lambda a: jnp.asarray(a, real_t)) if package is jutils
          else (lambda a: torch.tensor(a, dtype=real_t)))
    for k, v in arrays.items():
        setattr(holder, k, to(v))
    binding = package.FieldBinding
    io = _io(dim, real_t, grid_size, origin=np.arange(dim, dtype=float),
             dx=0.125, package=package,
             scalar=binding(holder, "scalar"),
             vector=binding(holder, "vector"))
    io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=binding(holder, "grid"), lagrangian_grid_name="body",
        lagrangian_grid_connect=True, force=binding(holder, "force"),
        radius=binding(holder, "radius"))
    io.save(name, time=time)
    return io, holder


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_load_across_packages(tmp_path, monkeypatch, dim, writer,
                                    precision):
    """A FieldIO file written by one package loads in the other with equal
    arrays and time; the sidecars both packages write for the same fields
    are the same text."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(21 + dim)
    grid_size, arrays = _cross_fields(dim, rng)
    jax_t = {"single": jnp.float32, "double": jnp.float64}[precision]
    port_t = get_real_t(precision)
    packages = {"jax": (jutils, jax_t), "port": (tutils, port_t)}
    for who in ("jax", "port"):
        os.makedirs(who)
    # each package writes the same arrays into its own directory under the
    # same relative name (the sidecars name the .h5 file)
    for who, (package, real_t) in packages.items():
        os.chdir(tmp_path / who)
        _write(package, dim, real_t, grid_size, arrays, "flow.h5", 1.25)
        os.chdir(tmp_path)
    for side in ("flow_eulerian.xmf", "flow_body.xmf"):
        assert ((tmp_path / "jax" / side).read_text()
                == (tmp_path / "port" / side).read_text()), side

    reader = "port" if writer == "jax" else "jax"
    package, real_t = packages[reader]
    os.chdir(tmp_path / reader)
    zeros = {k: np.zeros_like(v) for k, v in arrays.items()}
    io, holder = _write(package, dim, real_t, grid_size, zeros, "blank.h5",
                        0.0)
    time = io.load(str(tmp_path / writer / "flow.h5"))
    assert time == 1.25
    np_t = np.float32 if precision == "single" else np.float64
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(holder, k)),
                                      v.astype(np_t), err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rod_state_files_load_across_packages(tmp_path, writer):
    """``save_rod_state`` of one package, ``load_rod_state`` of the other:
    equal state arrays and time."""
    rng = np.random.default_rng(8)
    args = (6, np.zeros(3), np.array([0.0, 0.0, 1.0]),
            np.array([0.0, 1.0, 0.0]), 1.0, 0.02, 1e3)
    kwargs = dict(youngs_modulus=1e6, shear_modulus=1e4)
    jrod = JaxCosseratRod.straight_rod(*args, **kwargs)
    rod = CosseratRod.straight_rod(*args, **kwargs, device="cpu")
    state = {k: v + rng.standard_normal(v.shape)
             for k, v in rod.get_state_arrays().items()}
    f = str(tmp_path / "rod.h5")
    if writer == "jax":
        jrod.set_state_arrays(state)
        jutils.save_rod_state(jrod, f, time=0.75)
        time = load_rod_state(rod, f)
        got = rod.get_state_arrays()
    else:
        rod.set_state_arrays(state)
        save_rod_state(rod, f, time=0.75)
        time = jutils.load_rod_state(jrod, f)
        got = jrod.get_state_arrays()
    assert time == 0.75
    for k, v in state.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert rod.state.position.dtype == torch.float64


def test_rod_state_arrays_land_on_the_rod_s_dtype():
    """``set_state_arrays`` converts to the rod's own dtype and device."""
    rod = CosseratRod.straight_rod(
        4, np.zeros(3), np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]),
        1.0, 0.05, 1e3, youngs_modulus=1e6, device="cpu",
        dtype=torch.float32)
    arrays = {k: v.astype(np.float64) + 1.0
              for k, v in rod.get_state_arrays().items()}
    rod.set_state_arrays(arrays)
    for name in ("position", "velocity", "director", "omega"):
        t = getattr(rod.state, name)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(),
                                      arrays[name].astype(np.float32))


def test_utils_import_without_optional_packages():
    """The utilities import with h5py and matplotlib made unimportable, and
    importing them loads neither; FieldIO then refuses to build and
    ``lab_cmap`` is None."""
    code = (
        "import sys\n"
        "import sopht_mpi_tpu_torch.utils as u\n"
        "assert 'h5py' not in sys.modules and 'matplotlib' not in sys.modules\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "for name in [m for m in sys.modules if m.startswith("
        "'sopht_mpi_tpu_torch')]:\n"
        "    del sys.modules[name]\n"
        "import sopht_mpi_tpu_torch.utils as u\n"
        "assert len(u.__all__) == 18, u.__all__\n"
        "assert not u.io.HAS_H5PY\n"
        "assert u.lab_cmap is None\n"
        "try:\n"
        "    u.FieldIO(3)\n"
        "except RuntimeError as e:\n"
        "    assert 'h5py' in str(e)\n"
        "else:\n"
        "    raise AssertionError('FieldIO built without h5py')\n"
        "import sopht_mpi_tpu_torch.cases\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_utils_export_the_jax_package_s_names():
    names = {n for n in jutils.__dict__ if not n.startswith("_")
             and not isinstance(jutils.__dict__[n], type(sys))}
    assert names == set(tutils.__all__)
    for name in names:
        assert getattr(tutils, name) is not None or name == "lab_cmap"
