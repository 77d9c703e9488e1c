"""Flow past a fixed sphere at Re=100 (drag benchmark), on the PyTorch port.

Counterpart of ``examples/3d/flow_past_sphere.py`` (same physics: sphere
diameter 0.4*min(z,y)-extent, centered at (0.25, 0.5, 0.5) of the domain,
unit free stream in x, coupling stiffness -1.5e5 / damping -87.5, drag +
divergence diagnostics), built once by ``sopht_mpi_tpu_torch.cases``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/3d/flow_past_sphere.py --grid-size-x 128 --nondim-time 5
    python examples_torch/3d/flow_past_sphere.py --save-interval 0.5
    python examples_torch/3d/flow_past_sphere.py --device cpu --grid-size-x 32 \\
        --nondim-time 0.5 --host-loop --save-flow-data
    python examples_torch/3d/flow_past_sphere.py --n-devices 2  # (2, 1) mesh

``--n-devices N`` shards the flow over an in-process (N, 1) mesh on the one
device.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.models import scan_steps
from sopht_mpi_tpu_torch.parallel.mesh import (
    is_distributed,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import (
    FieldBinding,
    FieldIO,
    SnapshotWriter,
    logger,
)


def flow_past_sphere_case(
    nondim_time=10.0,
    grid_size=(128, 128, 128),
    reynolds=100.0,
    coupling_stiffness=-6e5 / 4,
    coupling_damping=-3.5e2 / 4,
    precision="single",
    save_flow_data=False,
    mesh=None,
    *,
    device,
):
    """The host-driven loop: one interaction and one flow step at a time,
    every t*/10 a drag read and log line (and, with ``save_flow_data``,
    ``FieldIO`` saves of the flow and of the sphere's forcing grid).
    Returns (times, Cd), also written to ``drag_vs_time.csv``. ``mesh``
    (``create_mesh(3, (pz, py), device=...)``) shards the flow over an
    in-process mesh; the saves write the assembled fields."""
    case = cases._build_sphere_drag_case(
        grid_size, reynolds, coupling_stiffness, coupling_damping, precision,
        device=device, mesh=mesh)
    flow_sim, interactor = case.flow_sim, case.interactor

    if save_flow_data:
        io = FieldIO(dim=3, real_dtype=flow_sim.real_t)
        position = unshard_vector_field(flow_sim.position_field,
                                        flow_sim.mesh)
        io.define_eulerian_grid(
            origin=np.array(
                [
                    float(position[2].min()),
                    float(position[1].min()),
                    float(position[0].min()),
                ]
            ),
            dx=flow_sim.dx * np.ones(3),
            grid_size=np.asarray(grid_size),
        )
        io.add_as_eulerian_fields_for_io(
            vorticity=FieldBinding(flow_sim, "vorticity_field"),
            velocity=FieldBinding(flow_sim, "velocity_field"),
        )
        sphere_io = FieldIO(dim=3, real_dtype=flow_sim.real_t)
        sphere_io.add_as_lagrangian_fields_for_io(
            lagrangian_grid=interactor.forcing_grid.compute_lag_grid_position_field,
            lagrangian_grid_name="sphere",
        )

    t_end = nondim_time * case.timescale
    foto_timer = 0.0
    foto_timer_limit = case.timescale / 10
    times, drag_coeffs = [], []

    while flow_sim.time < t_end:
        if foto_timer > foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            drag_force = float(
                interactor.global_lag_grid_forcing_field[0].sum().abs())
            drag_coeff = drag_force / case.drag_scale
            times.append(flow_sim.time)
            drag_coeffs.append(drag_coeff)
            if save_flow_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
                sphere_io.save(
                    h5_file_name=f"sphere_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / t_end * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                f"drag coeff: {drag_coeff:.4f}, "
                f"vort divg. L2 norm: "
                f"{flow_sim.get_vorticity_divergence_l2_norm():.4f} "
                "grid deviation L2 error: "
                f"{interactor.get_grid_deviation_error_l2_norm():.6f}"
            )

        dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)
        interactor.time_step(dt=dt)
        interactor()
        flow_sim.time_step(dt=dt, free_stream_velocity=case.free_stream)
        foto_timer += dt

    np.savetxt(
        "drag_vs_time.csv",
        np.c_[np.array(times), np.array(drag_coeffs)],
        delimiter=",",
        header="time, drag_coeff",
    )
    return np.array(times), np.array(drag_coeffs)


def flow_past_sphere_fused_case(
    nondim_time=10.0,
    grid_size=(128, 128, 128),
    reynolds=100.0,
    coupling_stiffness=-6e5 / 4,
    coupling_damping=-3.5e2 / 4,
    precision="single",
    window=100,
    save_interval=None,
    mesh=None,
    overlap_chunks=None,
    *,
    device,
):
    """Same physics, the fused coupled step run ``window`` steps between
    host reads of the drag. Returns (t* at each window end, Cd at the
    window's last step), rewritten to ``drag_vs_time.csv`` after every
    window (a long run can be stopped).

    ``save_interval`` (in t*) snapshots the vorticity and velocity fields
    at window ends through the native async writer (``SnapshotWriter``,
    ``snapshots/``): each field is copied to the host once and written on
    the writer's own thread (assembled on a ``mesh``, which shards the flow
    over an in-process or a distributed mesh). On a distributed mesh every
    process runs the loop and only rank 0 logs and writes the CSV and the
    snapshots. ``overlap_chunks`` is the simulator's option."""
    case = cases._build_sphere_drag_case(
        grid_size, reynolds, coupling_stiffness, coupling_damping, precision,
        device=device, mesh=mesh, overlap_chunks=overlap_chunks)
    step, carry = cases.build_sphere_drag_step(case)
    t_end = nondim_time * case.timescale
    writes = not is_distributed(mesh) or mesh.rank == 0
    snaps = None
    if save_interval is not None and writes:
        snaps = SnapshotWriter(
            interval=save_interval * case.timescale, out_dir="snapshots"
        )
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window)
        cd = cases.sphere_drag_coefficient(case, lag_forces)
        times.append(float(carry.time) / case.timescale)
        drag_coeffs.append(cd)
        if save_interval is not None:
            # every process joins the gathers; rank 0 writes
            fields = dict(
                vorticity=unshard_vector_field(
                    carry.flow_state.primary_field, mesh),
                velocity=unshard_vector_field(
                    carry.flow_state.velocity_field, mesh),
            )
        if not writes:
            continue
        logger.info(f"t*={times[-1]:.2f} Cd={cd:.4f}")
        if snaps is not None:
            snaps.maybe_save(float(carry.time), **fields)
        np.savetxt(
            "drag_vs_time.csv", np.c_[times, drag_coeffs], delimiter=","
        )
    if snaps is not None:
        snaps.flush()
        logger.info(
            f"wrote {snaps.n_saved} snapshots to snapshots/ "
            f"(native={snaps.is_native}, failed={snaps.failed()})"
        )
        snaps.close()
    return times, drag_coeffs


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--nondim-time", type=float, default=10.0)
    parser.add_argument("--grid-size-x", type=int, default=128)
    parser.add_argument(
        "--n-devices", type=int, default=1,
        help="z shards of an in-process mesh on the one device",
    )
    parser.add_argument("--precision", default="single")
    parser.add_argument(
        "--window", type=int, default=100,
        help="fused steps between host reads of the drag",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which needs a card; cpu runs on "
        "the CPU)",
    )
    parser.add_argument("--save-flow-data", action="store_true")
    parser.add_argument(
        "--save-interval", type=float, default=None,
        help="snapshot vorticity+velocity every this many t* through the "
        "native async dump writer (fused loop)",
    )
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="run the fused coupled step in windows (the default)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven loop, one interaction and flow step at a time",
    )
    parser.add_argument(
        "--fast", action="store_true",
        help="fast spectral tier (sopht_mpi_tpu_torch.enable_fast_spectral): "
        "the velocity through the fused-curl route",
    )
    parser.add_argument(
        "--no-fast", dest="no_fast", action="store_true",
        help="the exact spectral tier (the default)",
    )
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; run with --device cpu for the CPU")
    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(3, (args.n_devices, 1), device=device)
    if args.no_fast:
        import sopht_mpi_tpu_torch

        sopht_mpi_tpu_torch.enable_fast_spectral(False)
    elif args.fast:
        import sopht_mpi_tpu_torch

        sopht_mpi_tpu_torch.enable_fast_spectral()

    n = args.grid_size_x
    if args.fused:
        flow_past_sphere_fused_case(
            nondim_time=args.nondim_time,
            grid_size=(n, n, n),
            precision=args.precision,
            window=args.window,
            save_interval=args.save_interval,
            mesh=mesh,
            device=device,
        )
        raise SystemExit(0)
    flow_past_sphere_case(
        nondim_time=args.nondim_time,
        grid_size=(n, n, n),
        precision=args.precision,
        save_flow_data=args.save_flow_data,
        mesh=mesh,
        device=device,
    )
