"""The port's distributed mesh (one shard a process, collectives through
``torch.distributed``) in real gloo worlds on the CPU: 2 processes on a
(2, 1) mesh and 4 on (2, 2), each world started once for the module.

The processes run ``tests/torch_dist_worker.py`` (which imports neither
``jax`` nor the JAX package) and write their own blocks; this process
computes the references meanwhile: the port's in-process mesh and the JAX
package's mesh functions on its virtual CPU devices. Float64 throughout.
Tolerances: the collectives bit-equal to the in-process backend; the
transforms and the convolve ``1e-12 max|ref|`` of the JAX package's; the
sphere and flow-only steps ``1e-9 max(1, |ref|)`` of the JAX package's
steps (the FSI tests' float64 gate) and ``1e-12`` of the in-process port;
the pod driver's drag ``1e-12`` of the sphere driver's ``--n-devices n``.
"""

import os
import runpy
import subprocess
import sys
import time
from types import SimpleNamespace

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.models as jm
import torch_dist_worker as worker
from sopht_mpi_tpu.parallel import fft as jax_fft
from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch import models as tm
from sopht_mpi_tpu_torch.convert import rigid_fsi_carry_from_numpy
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel import distributed
from sopht_mpi_tpu_torch.parallel import fft as dist_fft
from sopht_mpi_tpu_torch.parallel.distributed import (
    DIST_ENV_HINTS,
    auto_mesh,
    initialize_distributed,
)
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_scalar_field,
    shard_vector_field,
)
from sopht_mpi_tpu_torch.utils import FieldBinding, FieldIO

JOIN_TIMEOUT_S = 240
TOL_JAX = 1e-9
TOL_SELF = 1e-12
TOL_FFT = 1e-12
REPO = worker.REPO


def _close(out, ref, tol, what):
    out = out.detach().cpu().numpy() if torch.is_tensor(out) else out
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else ref
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _plain(tree):
    """A JAX carry as numpy tuples (no JAX type left to unpickle)."""
    if isinstance(tree, (tuple, list)):
        return tuple(_plain(v) for v in tree)
    return None if tree is None else np.asarray(tree)


def _jax_sphere(jmesh, sparse):
    flow_sim = jm.UnboundedFlowSimulator3D(
        grid_size=worker.GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=jnp.float64, mesh=jmesh)
    interactor = worker.sphere_interactor(jm, flow_sim, dtype=jnp.float64)
    flow_sim.primary_field = flow_sim.primary_field + 0.1 * (
        jax.random.normal(jax.random.PRNGKey(7), flow_sim.primary_field.shape,
                          jnp.float64))
    fsv = jnp.asarray([1.0, 0.0, 0.0], jnp.float64)
    step = jm.build_rigid_fsi_step(
        flow_sim, interactor, dt_prefac=0.5, free_stream_fn=lambda t: fsv,
        sparse_forcing=None if sparse else False)
    return step, jm.init_rigid_fsi_carry(flow_sim, interactor, step)


def _jax_flow(jmesh, carry):
    """The JAX flow-only step from the port's initial flow-only carry."""
    jsim = jm.UnboundedFlowSimulator3D(
        grid_size=worker.GRID, x_range=1.0, kinematic_viscosity=0.0025,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=jnp.float64, mesh=jmesh)
    fs = carry.flow_state
    jsim.primary_field = jax_mesh.shard_vector_field(
        jnp.asarray(fs.primary_field.numpy()), jmesh)
    jsim.velocity_field = jax_mesh.shard_vector_field(
        jnp.asarray(fs.velocity_field.numpy()), jmesh)
    fsv = jnp.asarray([1.0, 0.0, 0.0], jnp.float64)
    step = jm.build_flow_only_step(jsim, dt_prefac=0.5,
                                   free_stream_fn=lambda t: fsv)
    final, dts = jm.scan_steps(step, jm.init_flow_only_carry(jsim),
                               worker.N_STEPS)
    return {"vorticity": np.asarray(final.flow_state.primary_field),
            "velocity": np.asarray(final.flow_state.velocity_field),
            "dts": np.asarray(dts)}


def _jax_fft(jmesh, mesh):
    field, rhs, greens = worker.fft_data(mesh)
    jit = jax.jit
    fhat = jit(lambda f: jax_fft.distributed_rfftn(f, jmesh))(
        jax_mesh.shard_scalar_field(jnp.asarray(field), jmesh))
    back = jit(lambda f: jax_fft.distributed_irfftn(
        f, worker.FFT_GRID[2], jmesh))(fhat)

    convolve = jit(lambda r, g: jax_fft.distributed_free_space_convolve(
        r, g, jmesh))

    def conv(r):
        return np.asarray(convolve(r, jnp.asarray(greens)))

    return {"rfftn": np.asarray(fhat), "irfftn": np.asarray(back),
            "convolve": conv(jax_mesh.shard_vector_field(jnp.asarray(rhs),
                                                         jmesh)),
            "convolve scalar": conv(jax_mesh.shard_scalar_field(
                jnp.asarray(rhs[1]), jmesh))}


def _in_process(mesh, carries):
    """The port's in-process runs of the worker's cases (whole layouts)."""
    out = {}
    x = shard_vector_field(torch.tensor(worker.collective_data()), mesh)
    out["collectives"] = {name: fn(x, mesh)
                          for name, fn in worker.COLLECTIVE_CASES}
    for sparse in (True, False):
        name = "sparse" if sparse else "dense"
        step = worker.sphere_step(mesh, sparse)
        carry = rigid_fsi_carry_from_numpy(carries[name], device="cpu",
                                           dtype=torch.float64, mesh=mesh)
        collectives.reset_counts()
        final, forces = tm.scan_steps(step, carry, worker.N_STEPS)
        fs = final.flow_state
        out[f"sphere {name}"] = {
            "vorticity": fs.primary_field, "velocity": fs.velocity_field,
            "forces": forces, "counts": collectives.counts()}
    res = {}
    for sparse in (True, False):
        step, (carry,) = cases._build_fsi_case(
            worker.GRID, mesh=mesh, sparse_forcing=None if sparse else False,
            **worker.FLOW_CASE)
        final, forces = tm.scan_steps(step, carry, 3)
        res[sparse] = {"vorticity": final.flow_state.primary_field,
                       "velocity": final.flow_state.velocity_field,
                       "forces": forces}
    out["fsi case"] = res
    step, (carry,) = cases.sharded_flow_case(worker.GRID, mesh=mesh,
                                             **worker.FLOW_CASE)
    collectives.reset_counts()
    final, dts = tm.scan_steps(step, carry, worker.N_STEPS)
    out["flow"] = {"vorticity": final.flow_state.primary_field,
                   "velocity": final.flow_state.velocity_field, "dts": dts,
                   "counts": collectives.counts()}
    return out


def _sphere_driver_csv(where, n_devices):
    """``examples_torch/3d/flow_past_sphere.py --n-devices N`` with the pod
    comparison's arguments, run in ``where``; its CSV."""
    script = os.path.join(REPO, "examples_torch", "3d", "flow_past_sphere.py")
    argv, cwd = sys.argv, os.getcwd()
    sys.argv = [script, "--n-devices", str(n_devices), *worker.POD_ARGS]
    os.makedirs(where, exist_ok=True)
    os.chdir(where)
    try:
        with pytest.raises(SystemExit) as stop:
            runpy.run_path(script, run_name="__main__")
        assert stop.value.code in (0, None)
        return np.loadtxt("drag_vs_time.csv", delimiter=",", ndmin=2)
    finally:
        os.chdir(cwd)
        sys.argv = argv


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def world(request, tmp_path_factory):
    n = request.param
    shape = (2, 1) if n == 2 else (2, 2)
    tmp = tmp_path_factory.mktemp(f"world{n}")
    jmesh = jax_mesh.create_mesh(3, shape)
    carries = {("sparse" if s else "dense"): _jax_sphere(jmesh, s)
               for s in (True, False)}
    np_carries = {k: _plain(jax.tree_util.tree_map(np.asarray, c))
                  for k, (_, c) in carries.items()}
    torch.save({"mesh_shape": shape, "cases": list(worker.CASES),
                **np_carries}, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
         str(r), str(n), str(tmp / "store"), str(tmp / "inputs.pt"),
         str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    try:
        # the references, while the world runs
        mesh = create_mesh(3, shape, device="cpu")
        ref = {"port": _in_process(mesh, np_carries)}
        for k, (step, carry) in carries.items():
            final, forces = jm.scan_steps(step, carry, worker.N_STEPS)
            ref[f"jax sphere {k}"] = {
                "vorticity": np.asarray(final.flow_state.primary_field),
                "velocity": np.asarray(final.flow_state.velocity_field),
                "forces": np.asarray(forces)}
        _, (first,) = cases.sharded_flow_case(worker.GRID, None,
                                              **worker.FLOW_CASE)
        ref["jax flow"] = _jax_flow(jmesh, first)
        ref["jax fft"] = _jax_fft(jmesh, mesh)
        ref["driver"] = _sphere_driver_csv(str(tmp / "driver"), n)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(n)]
    return SimpleNamespace(n=n, shape=shape, mesh=mesh, tmp=tmp, ranks=ranks,
                           ref=ref)


def _case(world, r, name):
    res = world.ranks[r][name]
    assert "error" not in res, f"rank {r}, {name}:\n{res['error']}"
    return res


def _ranks(world):
    return range(world.n)


def test_ranks_hold_their_mesh_coordinates(world):
    p1 = world.shape[1]
    assert [w["coords"] for w in world.ranks] == [
        divmod(r, p1) for r in range(world.n)]


def test_collectives_equal_the_in_process_backend(world):
    ref = world.ref["port"]["collectives"]
    for r in _ranks(world):
        res = _case(world, r, "collectives")
        i, j = world.ranks[r]["coords"]
        counts = dict.fromkeys(res["counts"], 0)
        for name, fn in worker.COLLECTIVE_CASES:
            out, full = res["out"][name], ref[name]
            kind = name.split()[0]
            if kind in ("pmax", "psum") and name.split()[1] != "None":
                # one axis reduced: the other keeps this rank's place
                full = full[j:j + 1] if name.endswith("z") else full[i:i + 1]
            elif kind in ("ppermute", "all_to_all"):
                full = full[i:i + 1, j:j + 1]
            assert out.shape == full.shape, (name, out.shape, full.shape)
            assert torch.equal(out, full), f"rank {r}: {name}"
            counts[kind] += 1
        assert res["counts"] == counts
        assert res["transfers"]["staged_bytes"] == 0  # CPU tensors


def test_transforms_and_convolve_match_jax(world):
    ref = world.ref["jax fft"]
    for r in _ranks(world):
        res = _case(world, r, "fft")["out"]
        i, j = world.ranks[r]["coords"]
        for name, glob in ref.items():
            if name == "rfftn":
                full = dist_fft.shard_fourier(torch.tensor(glob), world.mesh)
            elif name == "convolve":
                full = shard_vector_field(torch.tensor(glob), world.mesh)
            else:
                full = shard_scalar_field(torch.tensor(glob), world.mesh)
            scale = float(np.abs(glob).max())
            err = float((res[name] - full[i:i + 1, j:j + 1]).abs().max())
            assert err <= TOL_FFT * scale, f"rank {r}: {name} {err}"
        transposes = 2 * sum(p > 1 for p in world.shape)
        # rfftn + irfftn, then each convolve
        assert _case(world, r, "fft")["counts"]["all_to_all"] == 3 * transposes


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_sphere_step_matches_jax_and_the_in_process_port(world, sparse):
    name = "sphere sparse" if sparse else "sphere dense"
    jref = world.ref[f"jax {name}"]
    port = world.ref["port"][name]
    for r in _ranks(world):
        res = _case(world, r, name)
        out = res["out"]
        i, j = world.ranks[r]["coords"]
        for what in ("vorticity", "velocity"):
            glob = shard_vector_field(torch.tensor(jref[what]), world.mesh)
            _close(out[what], glob[i, j], TOL_JAX, f"rank {r} {what} (JAX)")
            _close(out[what], port[what][i, j], TOL_SELF,
                   f"rank {r} {what} (port)")
        _close(out["forces"], jref["forces"], TOL_JAX, f"rank {r} forces")
        _close(out["forces"], port["forces"], TOL_SELF, f"rank {r} forces")
        # each rank makes the in-process run's collectives, and on the CPU
        # launches no kernel
        assert res["counts"] == port["counts"]
        assert res["counts"]["psum"] == (worker.N_STEPS if sparse else 0)
        assert res["counts"]["apply_assembled"] == (
            0 if sparse else worker.N_STEPS)
        assert not any(res["launches"].values())


def test_fsi_case_matches_the_in_process_case(world):
    port = world.ref["port"]["fsi case"]
    for r in _ranks(world):
        out = _case(world, r, "fsi case")["out"]
        i, j = world.ranks[r]["coords"]
        for sparse in (True, False):
            for what in ("vorticity", "velocity"):
                _close(out[sparse][what], port[sparse][what][i, j], TOL_SELF,
                       f"rank {r} sparse={sparse} {what}")
            _close(out[sparse]["forces"], port[sparse]["forces"], TOL_SELF,
                   f"rank {r} sparse={sparse} forces")


def test_flow_only_step_matches_jax_and_the_in_process_port(world):
    jref = world.ref["jax flow"]
    port = world.ref["port"]["flow"]
    for r in _ranks(world):
        res = _case(world, r, "flow")
        out = res["out"]
        i, j = world.ranks[r]["coords"]
        for what in ("vorticity", "velocity"):
            glob = shard_vector_field(torch.tensor(jref[what]), world.mesh)
            _close(out[what], glob[i, j], TOL_JAX, f"rank {r} {what} (JAX)")
            _close(out[what], port[what][i, j], TOL_SELF,
                   f"rank {r} {what} (port)")
        # every rank reads the same dt from the mesh's max |u|_1
        _close(out["dts"], jref["dts"], TOL_JAX, f"rank {r} dts")
        _close(out["dts"], port["dts"], TOL_SELF, f"rank {r} dts (port)")
        assert res["counts"] == port["counts"]
        assert res["counts"]["pmax"] == worker.N_STEPS


def test_per_process_h5_files_and_restore(world):
    field = np.random.default_rng(8).standard_normal((3, *worker.GRID))
    p1 = world.shape[1]
    blocks = shard_vector_field(torch.tensor(field), world.mesh)
    for r in _ranks(world):
        out = _case(world, r, "io")["out"]
        i, j = world.ranks[r]["coords"]
        assert torch.equal(out["written"], blocks[i, j])
        assert torch.equal(out["restored"], out["written"])
        assert out["time"] == 0.25
        with h5py.File(world.tmp / "io" / f"dump.proc{r}.h5", "r") as f:
            assert f.attrs["process"] == r
            assert f.attrs["n_processes"] == world.n
            assert ("Parameters" in f) == (r == 0)
            (key, d), = f["vorticity"].items()
            assert key == f"shard_d{i * p1 + j}"
            start = tuple(int(v) for v in d.attrs["start"])
            assert start == (0, i * d.shape[1], j * d.shape[2], 0)
            assert np.array_equal(np.asarray(d), blocks[i, j].numpy())
    # the in-process mesh restores the per-process files; rank 0's gathered
    # save holds the whole field
    sim = worker.sphere_sim(world.mesh)
    io = FieldIO(dim=3, real_dtype=torch.float64)
    io.define_eulerian_grid(origin=np.zeros(3), dx=np.full(3, sim.dx),
                            grid_size=np.asarray(worker.GRID))
    io.add_as_eulerian_fields_for_io(
        vorticity=FieldBinding(sim, "vorticity_field"))
    assert io.load_eulerian_sharded(str(world.tmp / "io" / "dump")) == 0.25
    assert torch.equal(sim.vorticity_field, blocks)
    with h5py.File(world.tmp / "io" / "gathered.h5", "r") as f:
        assert f.attrs["time"] == 0.5
        got = np.stack([np.asarray(f[f"Eulerian/Vector/vorticity_{c}"])
                        for c in range(3)])
    assert np.array_equal(got, field)


def test_checkpoint_round_trip_one_file_a_rank(world):
    for r in _ranks(world):
        out = _case(world, r, "checkpoint")["out"]
        # listed after the all-reduce that rank 0 joins once its step 2
        # is written
        assert out["files"] == sorted(
            [f"1.rank{k}.pt" for k in _ranks(world)] + ["2.rank0.pt"])
        # rank 0 alone has step 2: every rank resumes from step 1
        assert out["latest"] == 1
        assert torch.equal(out["restored"], out["field"])
        assert torch.equal(out["stepped restored"], out["stepped"])


def test_rod_multi_body_and_2d_refuse_a_distributed_mesh(world):
    for r in _ranks(world):
        out = _case(world, r, "refusals")["out"]
        assert set(out) == {"rod", "multi-body", "2d simulator", "2d solver"}
        for what, msg in out.items():
            assert "queue A #11e" in msg, f"rank {r} {what}: {msg}"


def test_pod_driver_matches_the_sphere_driver(world):
    """The pod driver on the world (auto_mesh: an (n, 1) slab) against the
    sphere driver's ``--n-devices n``; rank 0 alone writes the CSV."""
    ref = world.ref["driver"]
    assert len(ref) >= 2
    for r in _ranks(world):
        out = _case(world, r, "pod")["out"]
        assert out["files"] == (["drag_vs_time.csv"] if r == 0 else [])
        _close(np.c_[out["times"], out["cds"]], ref, TOL_SELF,
               f"rank {r} drag")
    pod = np.loadtxt(world.tmp / "pod0" / "drag_vs_time.csv", delimiter=",",
                     ndmin=2)
    _close(pod, ref, TOL_SELF, "pod driver CSV")


def test_initialize_distributed_no_op_env_and_double_init(monkeypatch,
                                                          tmp_path):
    monkeypatch.setitem(distributed._state, "device", None)
    for key in (*DIST_ENV_HINTS, "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    # a shell's MASTER_ADDR or LOCAL_RANK alone announces no launched job
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert initialize_distributed(device="cpu") is False
    monkeypatch.delenv("MASTER_ADDR")
    # a launcher's world of one that cannot initialise runs as one process
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.warns(UserWarning, match="world of one"):
        assert initialize_distributed(device="cpu") is False
    monkeypatch.delenv("LOCAL_RANK")
    # one mesh of the world without it: the single shard
    assert auto_mesh(3, (8, 8, 8), device="cpu").size == 1
    # a launcher's world of two that cannot initialise raises
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError):
        initialize_distributed(device="cpu")
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    import torch.distributed as dist

    assert initialize_distributed(
        init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0,
        device="cpu") is True
    try:
        assert initialize_distributed() is True
        with pytest.raises(RuntimeError, match="already initialized"):
            initialize_distributed(init_method="env://")
        mesh = auto_mesh(3, (8, 8, 8))
        assert mesh.distributed and mesh.size == 1
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="4 shards"):
            create_mesh(3, (2, 2), device="cpu", distributed=True)
    finally:
        dist.destroy_process_group()


def test_transport_counts_the_bytes_it_stages():
    """A tensor staged through the host counts its bytes each way, one
    that is not counts none; ``reset_counts`` zeroes the count."""
    from sopht_mpi_tpu_torch.parallel import transport

    collectives.reset_counts()
    t = torch.zeros((3, 5), dtype=torch.float64)
    assert transport.stage(t, False) is t
    assert collectives.transfer_counts()["staged_bytes"] == 0
    host = transport.stage(t, True)
    back = transport.unstage(host, t.device, True)
    assert torch.equal(back, t)
    assert collectives.transfer_counts() == {"gathers": 0,
                                             "staged_bytes": 2 * 15 * 8}
    collectives.reset_counts()
    assert collectives.transfer_counts()["staged_bytes"] == 0
