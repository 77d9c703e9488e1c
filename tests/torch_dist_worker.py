"""One process of a gloo world for ``tests/test_torch_distributed.py``: it
runs the port's distributed mesh (one shard a process) through every case
of that test and writes what it computed, its own blocks, to
``<out>/rank<r>.pt``. It imports neither ``jax`` nor the JAX package: the
test computes the references in its own process.

    python tests/torch_dist_worker.py RANK WORLD INIT_FILE INPUTS OUT

``INIT_FILE`` is the file store of ``init_process_group`` (one a world, so
concurrent worlds never share a port), ``INPUTS`` a ``torch.save`` file of
the test's inputs (the mesh shape, the JAX carries as numpy tuples). A case
that raises records its traceback in place of its results and the process
goes on to the next.
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sopht_mpi_tpu_torch import cases  # noqa: E402
from sopht_mpi_tpu_torch import models as tm  # noqa: E402
from sopht_mpi_tpu_torch.convert import rigid_fsi_carry_from_numpy  # noqa
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded  # noqa: E402
from sopht_mpi_tpu_torch.parallel import collectives, cuda_fft  # noqa: E402
from sopht_mpi_tpu_torch.parallel import fft as dist_fft  # noqa: E402
from sopht_mpi_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed,
)
from sopht_mpi_tpu_torch.parallel.mesh import (  # noqa: E402
    create_mesh,
    shard_scalar_field,
    shard_vector_field,
)

GRID = (32, 32, 32)  # the sphere and flow-only cases
FFT_GRID = (16, 16, 12)
COLLECTIVE_SHAPE = (3, 8, 8, 6)
N_STEPS = 5
FLOW_CASE = dict(device="cpu", precision="double",
                 sim_kwargs={"use_kernels": True})
# the sphere driver's arguments of the pod-driver comparison
POD_ARGS = ["--grid-size-x", "32", "--nondim-time", "0.07", "--window", "4",
            "--precision", "double", "--device", "cpu"]


def collective_data():
    return np.random.default_rng(21).standard_normal(COLLECTIVE_SHAPE)


def fft_data(mesh):
    """(field (nz, ny, nx), rhs (3, nz, ny, nx), a real multiplier in the
    global Fourier layout of the doubled grid)."""
    rng = np.random.default_rng(5)
    field = rng.standard_normal(FFT_GRID)
    rhs = rng.standard_normal((3, *FFT_GRID))
    nz, ny, nx = FFT_GRID
    fxp = dist_fft.padded_rfft_size(2 * nx, mesh)
    greens = rng.standard_normal((2 * nz, 2 * ny, fxp))
    greens[..., nx + 1:] = 0.0  # the padded columns of a real transform
    return field, rhs, greens


# the collectives' cases: (name, fn(x, mesh)) on a sharded vector field x
COLLECTIVE_CASES = (
    [(f"ppermute {a} {s:+d}",
      lambda x, m, a=a, s=s: collectives.ppermute(x, m, a, s))
     for a in ("z", "y") for s in (1, -1)]
    + [(f"all_to_all {a} {sa}->{ca}",
        lambda x, m, a=a, sa=sa, ca=ca: collectives.all_to_all(x, m, a, sa,
                                                               ca))
       for a in ("z", "y") for sa, ca in ((1, 2), (2, 1), (1, 0), (3, 1))]
    + [("all_to_all complex",
        lambda x, m: collectives.all_to_all(
            torch.complex(x, 2 * x), m, "z", 3, 1))]
    + [(f"pmax {axes}", lambda x, m, axes=axes: collectives.pmax(
        x.abs().amax(dim=(2, 3, 4, 5)), m, axes))
       for axes in (None, "z", "y")]
    + [(f"psum {axes}", lambda x, m, axes=axes: collectives.psum(x, m, axes))
       for axes in (None, "z", "y")]
)


def sphere_sim(mesh):
    return tm.UnboundedFlowSimulator3D(
        grid_size=GRID, x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", with_free_stream_flow=True,
        real_t=torch.float64, device="cpu", mesh=mesh, use_kernels=True)


def sphere_interactor(pkg, flow_sim, **kw):
    """The sphere of the rigid step in either package (``pkg`` the port's
    or the JAX package's ``models``; ``kw`` the JAX dtype or the port's
    device and dtype)."""
    sphere = pkg.Sphere(center=np.array([0.5, 0.45, 0.55]), radius=0.1, **kw)
    return pkg.RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=sphere,
        forcing_grid=pkg.SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=12),
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0)


def sphere_step(mesh, sparse):
    """The port's rigid sphere step on ``mesh`` (the test builds its JAX
    twin)."""
    flow_sim = sphere_sim(mesh)
    interactor = sphere_interactor(tm, flow_sim, device="cpu",
                                   dtype=torch.float64)
    fsv = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    step = tm.build_rigid_fsi_step(
        flow_sim, interactor, dt_prefac=0.5, free_stream_fn=lambda t: fsv,
        sparse_forcing=None if sparse else False)
    assert getattr(step, "uses_sparse_forcing", False) == sparse
    return step


def launches() -> dict:
    return {fn.__name__: fn.launches
            for fn in (*cuda_stencils_3d_sharded.KERNELS, *cuda_fft.KERNELS)}


def reset():
    collectives.reset_counts()
    for fn in (*cuda_stencils_3d_sharded.KERNELS, *cuda_fft.KERNELS):
        fn.launches = 0


def counted(fn):
    """``fn()``'s results with the collectives' calls, the transfer counts
    and the kernel launches it made."""
    reset()
    out = fn()
    out.update(counts=collectives.counts(),
               transfers=collectives.transfer_counts(), launches=launches())
    return out


def _fields(carry):
    fs = carry.flow_state
    return {"vorticity": fs.primary_field[0, 0].clone(),
            "velocity": fs.velocity_field[0, 0].clone()}


def case_collectives(mesh, inputs, out):
    x = shard_vector_field(torch.tensor(collective_data()), mesh)
    return {name: fn(x, mesh) for name, fn in COLLECTIVE_CASES}


def case_fft(mesh, inputs, out):
    field, rhs, greens = fft_data(mesh)
    fhat = dist_fft.distributed_rfftn(
        shard_scalar_field(torch.tensor(field), mesh), mesh)
    back = dist_fft.distributed_irfftn(fhat, FFT_GRID[2], mesh)
    g = dist_fft.shard_fourier(torch.tensor(greens), mesh)
    vec = dist_fft.distributed_free_space_convolve(
        shard_vector_field(torch.tensor(rhs), mesh), g, mesh)
    one = dist_fft.distributed_free_space_convolve(
        shard_scalar_field(torch.tensor(rhs[1]), mesh), g, mesh)
    return {"rfftn": fhat, "irfftn": back, "convolve": vec,
            "convolve scalar": one}


def _sphere(mesh, inputs, sparse):
    step = sphere_step(mesh, sparse)
    carry = rigid_fsi_carry_from_numpy(
        inputs["sparse" if sparse else "dense"], device="cpu",
        dtype=torch.float64, mesh=mesh)
    reset()  # count the steps alone
    final, forces = tm.scan_steps(step, carry, N_STEPS)
    return dict(_fields(final), forces=forces,
                mismatch=final.vb_state.position_mismatch,
                l1=final.velocity_l1_max)


def case_sphere_sparse(mesh, inputs, out):
    return _sphere(mesh, inputs, True)


def case_sphere_dense(mesh, inputs, out):
    return _sphere(mesh, inputs, False)


def case_fsi_case(mesh, inputs, out):
    """``cases._build_fsi_case`` on the mesh, sparse and dense."""
    res = {}
    for sparse in (True, False):
        step, (carry,) = cases._build_fsi_case(
            GRID, mesh=mesh, sparse_forcing=None if sparse else False,
            **FLOW_CASE)
        final, forces = tm.scan_steps(step, carry, 3)
        res[sparse] = dict(_fields(final), forces=forces)
    return res


def case_flow(mesh, inputs, out):
    step, (carry,) = cases.sharded_flow_case(GRID, mesh=mesh, **FLOW_CASE)
    first = _fields(carry)
    reset()  # count the steps alone
    final, dts = tm.scan_steps(step, carry, N_STEPS)
    return dict(_fields(final), dts=dts, initial=first,
                time=final.time)


def case_io(mesh, inputs, out):
    """The per-process sharded dump and its restore, and the gathered
    save, of a simulator's fields (``out/io``)."""
    import torch.distributed as dist

    from sopht_mpi_tpu_torch.utils import FieldBinding, FieldIO

    flow_sim = sphere_sim(mesh)
    rng = np.random.default_rng(8)
    flow_sim.vorticity_field = shard_vector_field(
        torch.tensor(rng.standard_normal((3, *GRID))), mesh)
    written = flow_sim.vorticity_field.clone()
    io = FieldIO(dim=3, real_dtype=torch.float64)
    io.define_eulerian_grid(origin=np.zeros(3), dx=np.full(3, flow_sim.dx),
                            grid_size=np.asarray(GRID))
    io.add_as_eulerian_fields_for_io(
        vorticity=FieldBinding(flow_sim, "vorticity_field"))
    base = os.path.join(out, "io")
    if mesh.rank == 0:
        os.makedirs(base, exist_ok=True)
    dist.barrier()
    io.save_eulerian_sharded(os.path.join(base, "dump"), time=0.25)
    flow_sim.vorticity_field = torch.zeros_like(written)
    time = io.load_eulerian_sharded(os.path.join(base, "dump"))
    restored = flow_sim.vorticity_field
    io.save(os.path.join(base, "gathered.h5"), time=0.5)
    return {"time": float(time), "written": written[0, 0],
            "restored": restored[0, 0]}


def case_checkpoint(mesh, inputs, out):
    from sopht_mpi_tpu_torch.utils import CarryCheckpointer

    step = sphere_step(mesh, True)
    carry = rigid_fsi_carry_from_numpy(inputs["sparse"], device="cpu",
                                       dtype=torch.float64, mesh=mesh)
    carry, _ = tm.scan_steps(step, carry, 1)
    import torch.distributed as dist

    ckpt = CarryCheckpointer(os.path.join(out, "ckpt"), mesh=mesh)
    ckpt.save(1, carry, wait=True)
    dist.barrier()  # every rank's file is written
    again, _ = tm.scan_steps(step, carry, 1)
    if mesh.rank == 0:
        # rank 0 alone finishes step 2, as a job cut between two ranks'
        # renames leaves it: every rank resumes from step 1
        ckpt.save(2, again, wait=True)
    latest = ckpt.latest_step()
    back = ckpt.restore(template=carry)
    ckpt.close()
    after, _ = tm.scan_steps(step, back, 1)
    return {"field": carry.flow_state.primary_field[0, 0],
            "restored": back.flow_state.primary_field[0, 0],
            "stepped": again.flow_state.primary_field[0, 0],
            "stepped restored": after.flow_state.primary_field[0, 0],
            "latest": latest,
            "files": sorted(os.listdir(os.path.join(out, "ckpt")))}


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return "no error"


def case_refusals(mesh, inputs, out):
    from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver2D

    def rod():
        flow_sim = sphere_sim(mesh)
        rod = tm.CosseratRod.straight_rod(
            5, np.array([0.3, 0.4, 0.6]), np.array([0.0, 0.0, -1.0]),
            np.array([0.0, 1.0, 0.0]), base_length=0.25, base_radius=0.02,
            density=1e3, youngs_modulus=1e5, shear_modulus=1e5 / 1.5,
            device="cpu")
        collection = tm.BaseSystemCollection()
        collection.append(rod)
        collection.finalize()
        interactor = tm.CosseratRodFlowInteraction(
            flow_sim=flow_sim, cosserat_rod=rod,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
            forcing_grid_cls=tm.CosseratRodSurfaceForcingGrid,
            surface_grid_density_for_largest_element=4)
        return flow_sim, rod, collection, interactor

    def rod_step():
        flow_sim, _, collection, interactor = rod()
        tm.build_rod_fsi_step(flow_sim, interactor, collection,
                              rod_substeps=1)

    def multi_body_step():
        flow_sim, _, collection, interactor = rod()
        tm.build_multi_body_fsi_step(
            flow_sim, (tm.RodBody(interactor, collection),), substeps=1)

    mesh_2d = create_mesh(2, (mesh.size, 1), device="cpu", distributed=True)
    return {
        "rod": _refusal(rod_step),
        "multi-body": _refusal(multi_body_step),
        "2d simulator": _refusal(lambda: tm.UnboundedFlowSimulator2D(
            grid_size=(16, 16), x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes", device="cpu", mesh=mesh_2d)),
        "2d solver": _refusal(lambda: UnboundedPoissonSolver2D(
            16, 16, device="cpu", mesh=mesh_2d)),
    }


def case_pod(mesh, inputs, out):
    """The pod driver on the whole world, each process in a directory of
    its own, ``out/pod<r>`` (rank 0 alone writes the CSV)."""
    import importlib.util

    import torch.distributed as dist

    path = os.path.join(REPO, "examples_torch", "3d",
                        "pod_flow_past_sphere.py")
    spec = importlib.util.spec_from_file_location("pod_driver", path)
    pod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pod)
    where = os.path.join(out, f"pod{mesh.rank}")
    os.makedirs(where, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(where)
    try:
        times, cds = pod.main(POD_ARGS)
    finally:
        os.chdir(cwd)
    dist.barrier()
    return {"times": list(times), "cds": list(cds),
            "files": sorted(os.listdir(where))}


CASES = {
    "collectives": case_collectives,
    "fft": case_fft,
    "sphere sparse": case_sphere_sparse,
    "sphere dense": case_sphere_dense,
    "fsi case": case_fsi_case,
    "flow": case_flow,
    "io": case_io,
    "checkpoint": case_checkpoint,
    "refusals": case_refusals,
    "pod": case_pod,
}


def main(argv):
    rank, world = int(argv[0]), int(argv[1])
    init_file, inputs_file, out = argv[2:5]
    torch.set_num_threads(1)
    initialize_distributed(
        init_method=f"file://{init_file}", world_size=world, rank=rank,
        device="cpu", timeout=datetime.timedelta(seconds=180))
    inputs = torch.load(inputs_file, weights_only=False)
    mesh = create_mesh(3, inputs["mesh_shape"], device="cpu",
                       distributed=True)
    results = {"coords": mesh.coords}
    for name in inputs["cases"]:
        try:
            results[name] = counted(
                lambda: {"out": CASES[name](mesh, inputs, out)})
        except Exception:
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
