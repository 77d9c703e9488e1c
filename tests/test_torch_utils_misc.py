"""The port's logging, native async dumper, snapshots, profiling and
plotting utilities against the JAX package's (``sopht_mpi_tpu.utils``).

The JAX package's own cases (``tests/test_utils/test_logging.py``,
``test_native_io.py``, ``test_profiling.py``, ``test_plotting.py``) on
tensors, and each port utility beside its JAX counterpart on the same
inputs: the same .npy bytes, the same snapshot files and manifest, the same
colormap, the same log line format.
"""

import logging
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.utils as jutils
import sopht_mpi_tpu.utils.native_io as jnative
from sopht_mpi_tpu_torch import _build
from sopht_mpi_tpu_torch.utils import (
    AsyncFieldDumper,
    FlowLogger,
    Plotter2D,
    SnapshotWriter,
    block_timer,
    compile_video,
    get_dtype_eps,
    logger,
    measure_op_time,
)
from sopht_mpi_tpu_torch.utils import native_io
from sopht_mpi_tpu_torch.utils.profiling import trace_to

NAME = "sopht_mpi_tpu_torch"


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16"])
def test_get_dtype_eps(dtype):
    want = jutils.get_dtype_eps(getattr(jnp, dtype))
    assert get_dtype_eps(getattr(torch, dtype)) == want
    assert get_dtype_eps(getattr(np, dtype)) == want


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------


def _file_handlers(name=NAME):
    return [h for h in logging.getLogger(name).handlers
            if isinstance(h, logging.FileHandler)]


def test_singleton_and_level_filtering(caplog):
    assert FlowLogger()._logger is logger._logger
    assert logger._logger.name == NAME
    with caplog.at_level(logging.WARNING, logger=NAME):
        logger.info("info-not-captured")
        logger.warning("warn-captured")
    assert "warn-captured" in caplog.text
    assert "info-not-captured" not in caplog.text


def test_package_modules_log_through_the_package_logger(caplog):
    """The interactor's grid-spacing warning (``models/immersed_body``) and
    the sparse-window note (``models/fsi.py``) reach the package logger."""
    from sopht_mpi_tpu_torch import cases

    with caplog.at_level(logging.INFO, logger=NAME):
        cases._build_fsi_case((16, 16, 16), device="cpu")
    names = {r.name for r in caplog.records}
    assert names == {NAME}, names
    assert any("sparse" in r.getMessage() for r in caplog.records)
    caplog.clear()
    from sopht_mpi_tpu_torch.models import (
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )

    sim = UnboundedFlowSimulator3D((16, 16, 16), 1.0, 1e-3,
                                   flow_type="navier_stokes_with_forcing",
                                   device="cpu")
    sphere = Sphere(center=np.full(3, 0.5), radius=0.3, device="cpu",
                    dtype=torch.float32)
    with caplog.at_level(logging.WARNING, logger=NAME):
        RigidBodyFlowInteraction(
            sim, sphere, SphereForcingGrid(sphere, 4),
            virtual_boundary_stiffness_coeff=-1.0,
            virtual_boundary_damping_coeff=-1.0)
    assert any("too coarse" in r.getMessage() for r in caplog.records)
    assert {r.name for r in caplog.records} == {NAME}


@pytest.mark.parametrize("timestamp", [False, True])
def test_logfile_output_matches_the_jax_logger(tmp_path, monkeypatch,
                                               timestamp):
    """Both packages' loggers write a logfile of the same line format, with
    the same (optionally timestamped) name pattern."""
    monkeypatch.chdir(tmp_path)
    texts = {}
    for pkg_logger, name in ((logger, NAME), (jutils.logger, "sopht_mpi_tpu")):
        before = set(_file_handlers(name))
        pkg_logger.enable_write_to_logfile(f"run_{name}", timestamp=timestamp)
        try:
            pkg_logger.info("hello-logfile")
            added = set(_file_handlers(name)) - before
            assert len(added) == 1
            (handler,) = added
            handler.flush()
            base = os.path.basename(handler.baseFilename)
            pattern = rf"run_{name}_\d{{8}}_\d{{6}}\.log" if timestamp \
                else rf"run_{name}\.log"
            assert re.fullmatch(pattern, base), base
            texts[name] = open(handler.baseFilename).read()
        finally:
            for h in set(_file_handlers(name)) - before:
                logging.getLogger(name).removeHandler(h)
                h.close()
    strip = [re.sub(r"^\S+ \S+ ", "", t) for t in texts.values()]
    assert strip[0] == strip[1] == "INFO: hello-logfile\n"


# ---------------------------------------------------------------------------
# native async dumper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 4), np.float32), ((10,), np.float64), ((2, 3), np.int32),
    ((3, 17, 33, 65), np.float32), ((), np.float64)])
def test_npy_header_matches_jax_and_loads(tmp_path, shape, dtype):
    arr = np.arange(int(np.prod(shape)), dtype=dtype).reshape(shape)
    header = native_io._npy_header(arr)
    assert header == jnative._npy_header(arr)
    path = tmp_path / "x.npy"
    path.write_bytes(header + arr.tobytes())
    np.testing.assert_array_equal(np.load(path), arr)


def test_dumper_is_built_with_gxx_into_build():
    """The native writer is the g++ build of the port's own source, under a
    content-hashed name in ``build/sopht_mpi_tpu_torch/``."""
    dumper = AsyncFieldDumper()
    assert dumper.is_native
    dumper.close()
    assert not dumper.is_native
    lib = native_io.library()
    path = os.path.realpath(lib.path)
    assert os.path.dirname(path) == os.path.realpath(_build.BUILD_DIR)
    assert re.fullmatch(r"libasyncdump-[0-9a-f]{16}\.so",
                        os.path.basename(path))
    assert (_build.CSRC_DIR / "async_dump.cpp").is_file()


def _jax_npy_bytes(arr):
    """The bytes of the .npy file the JAX package's dumper writes for
    ``arr``: its header and the raw data."""
    arr = np.ascontiguousarray(arr)
    return jnative._npy_header(arr) + arr.tobytes()


def test_async_dump_roundtrip_same_bytes_as_jax(tmp_path):
    """Tensors (contiguous or not) and arrays dump to the bytes the JAX
    package's dumper writes for the same arrays."""
    rng = np.random.default_rng(0)
    arrays = {f"f{i}.npy": rng.standard_normal((16, 8, 4)).astype(np.float32)
              for i in range(6)}
    arrays["a.npy"] = np.arange(10, dtype=np.float64)
    arrays["b.npy"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    fields = {name: (torch.from_numpy(a.T.copy()).permute(
                  *reversed(range(a.ndim))) if i % 2 else a)
              for i, (name, a) in enumerate(arrays.items())}
    dumper = AsyncFieldDumper()
    for name, field in fields.items():
        dumper.dump(str(tmp_path / name), field)
    dumper.flush()
    assert dumper.failed() == 0 and dumper.pending() == 0
    for name, arr in arrays.items():
        np.testing.assert_array_equal(np.load(tmp_path / name), arr)
        assert (tmp_path / name).read_bytes() == _jax_npy_bytes(arr), name
    dumper.close()
    with pytest.raises(ValueError, match="closed"):
        dumper.dump(str(tmp_path / "late.npy"), arrays["a.npy"])


def test_failed_writes_are_counted(tmp_path):
    dumper = AsyncFieldDumper()
    dumper.dump(str(tmp_path / "missing_dir" / "x.npy"), np.ones(3))
    dumper.flush()
    assert dumper.failed() == 1
    dumper.close()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source g++ cannot compile raises with its diagnostics; no dumper
    is made (there is no synchronous fallback)."""
    (tmp_path / "async_dump.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    native_io.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
            AsyncFieldDumper()
        assert "error" in str(err.value)
    finally:
        monkeypatch.undo()
        native_io.library.cache_clear()
    assert AsyncFieldDumper().is_native


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------


class _NpyWriter:
    """Stands in for the JAX package's native dumper (built into the JAX
    package's own tree, which these tests leave alone): writes the bytes it
    would write."""

    is_native = True

    def dump(self, path, array):
        with open(path, "wb") as f:
            f.write(_jax_npy_bytes(np.asarray(array)))

    def flush(self):
        pass

    close = flush

    def failed(self):
        return 0


def _jax_snapshot_writer(interval, out_dir):
    """The JAX package's SnapshotWriter (its schedule and manifest code)
    around :class:`_NpyWriter`."""
    writer = object.__new__(jutils.SnapshotWriter)
    writer.interval, writer.out_dir = float(interval), out_dir
    writer._next_time, writer._index, writer._times = 0.0, 0, []
    writer._dumper = _NpyWriter()
    os.makedirs(out_dir)
    return writer


def test_snapshot_writer_matches_the_jax_writer(tmp_path):
    """The same maybe_save calls (tensors to the port, arrays to the JAX
    package's writer) write the same files and the same times.csv, after
    every snapshot."""
    rng = np.random.default_rng(3)
    port = SnapshotWriter(interval=0.25, out_dir=str(tmp_path / "port"))
    jax_w = _jax_snapshot_writer(0.25, str(tmp_path / "jax"))
    assert port.is_native
    written = []
    for time in (0.0, 0.1, 0.3, 0.31, 0.5, 0.9):
        w = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
        s = rng.standard_normal((4, 5, 6))
        saved = port.maybe_save(time, vorticity=torch.from_numpy(w),
                                pressure=torch.from_numpy(s))
        assert saved == jax_w.maybe_save(time, vorticity=w, pressure=s)
        written.append(saved)
        if saved:
            # the manifest is current after every snapshot
            rows = np.loadtxt(tmp_path / "port" / "times.csv",
                              delimiter=",", skiprows=1).reshape(-1, 2)
            assert rows.shape[0] == port.n_saved
            assert rows[-1, 1] == time
    assert written == [True, False, True, False, True, True]
    port.flush()
    jax_w.flush()
    assert port.failed() == 0
    port.close()
    jax_w.close()
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 2 * 4 + 1
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_snapshot_interval_must_be_positive(tmp_path):
    with pytest.raises(ValueError):
        SnapshotWriter(interval=0.0, out_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_block_timer_records_elapsed():
    results, jresults, lines = {}, {}, []
    with block_timer("t", results=results, echo=lines.append):
        results["x"] = torch.ones((8, 8)) * 2
        results["tree"] = (torch.ones(2), {"y": torch.zeros(3)})
    with jutils.block_timer("t", results=jresults, echo=lines.append):
        jresults["x"] = jnp.ones((8, 8)) * 2
    assert results["elapsed_s"] > 0 and jresults["elapsed_s"] > 0
    assert all(re.fullmatch(r"t: \d+\.\d\d ms", ln) for ln in lines), lines


def test_measure_op_time_chains_the_output():
    """Positive seconds a call, like the JAX helper's on the same function;
    the function is called on its own output (iters calls a chain, a warm-up
    chain and ``repeats`` timed ones)."""
    seen = []

    def fn(x):
        seen.append(float(x[0, 0]))
        return x * 1.0001 + 1e-6

    t = measure_op_time(fn, torch.ones((64, 64)), iters=4, repeats=2)
    jt = jutils.measure_op_time(lambda x: x * 1.0001 + 1e-6,
                                jnp.ones((64, 64)), iters=4, repeats=1)
    assert t > 0 and jt > 0
    assert len(seen) == 12
    assert all(b > a for a, b in zip(seen, seen[1:]))
    pair = measure_op_time(lambda p: (p[1], p[0]),
                           (torch.ones(3), torch.zeros(3)), iters=2)
    assert pair > 0
    with pytest.raises(TypeError):
        measure_op_time(lambda x: x, 1.0)


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    text = (tmp_path / "trace" / files[0]).read_text()
    assert "traceEvents" in text and "aten::mm" in text


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------


def _field():
    x, y = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
    return x, y, np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)


def test_plotter2d_renders_tensors_and_reuses_the_figure(tmp_path):
    x, y, f = _field()
    plotter = Plotter2D(fig_size=(4, 4), title="t")
    sizes = []
    for i in range(3):  # contourf + colorbar every frame, as the examples
        plotter.contourf(torch.tensor(x), torch.tensor(y),
                         torch.tensor(f, dtype=torch.float32))
        plotter.plot([0.2, 0.8], [0.5, 0.5], color="k")
        plotter.scatter(torch.tensor([0.5]), torch.tensor([0.5]), s=4)
        out = str(tmp_path / f"frame_{i}.png")
        plotter.savefig(out)
        sizes.append(os.path.getsize(out))
        plotter.clearfig()
    assert all(s > 1000 for s in sizes)


def test_clearfig_before_any_contourf_is_safe():
    plotter = Plotter2D(fig_size=(2, 2))
    plotter.clearfig()
    plotter.plot([0, 1], [0, 1])
    plotter.clearfig()


def test_lab_cmap_is_the_jax_package_s():
    from sopht_mpi_tpu_torch.utils import lab_cmap

    points = np.linspace(0.0, 1.0, 11)
    np.testing.assert_array_equal(lab_cmap(points), jutils.lab_cmap(points))
    lo, mid, hi = (np.asarray(lab_cmap(v)) for v in (0.0, 0.5, 1.0))
    assert lo[2] > lo[0]
    np.testing.assert_allclose(mid[:3], 1.0, atol=0.02)
    assert hi[0] > hi[2]


def test_compile_video_assembles_frames(tmp_path, monkeypatch):
    """Both packages assemble the same frames into an artifact of the same
    name (an mp4 with ffmpeg, else an animated GIF)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    monkeypatch.chdir(tmp_path)
    for i in range(3):
        fig = plt.figure()
        plt.plot([0, 1], [0, i])
        fig.savefig(f"snap_{i:04d}.png")
        plt.close(fig)
    out = compile_video("snap_*.png", output="flow.mp4", fps=5)
    assert out is not None and os.path.getsize(out) > 0
    os.rename(out, "port_" + out)
    jout = jutils.compile_video("snap_*.png", output="flow.mp4", fps=5)
    assert jout == out
    assert compile_video("nomatch_*.png") is None
