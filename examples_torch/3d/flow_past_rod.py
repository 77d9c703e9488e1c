"""Flow past a 3D flexible rod (filament bent by a free stream), on the
PyTorch port.

Counterpart of ``examples/3d/flow_past_rod.py`` (rod hanging into the
flow, surface forcing grid, Laplacian vorticity filtering {"order": 1,
"type": "multiplicative"}, Cauchy / mass-ratio / Froude / stretch-bending
nondimensional setup). The fused loop takes the moving sparse IBM window
of ``suggest_rod_forcing_window`` by default and heals itself when the rod
outgrows it: it grows the margin 1.3 times, rebuilds the step and replays
the scan window from the last good carry (no step writes into the carry
it is given, so that carry survives the window). The case is built by
``sopht_mpi_tpu_torch.cases._build_flow_past_rod_objects``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/3d/flow_past_rod.py --grid-size-x 64 --final-time 1
    python examples_torch/3d/flow_past_rod.py --host-loop --save-data
    python examples_torch/3d/flow_past_rod.py --n-devices 2

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
from sopht_mpi_tpu_torch.models import (
    PositionVerlet,
    build_rod_fsi_step,
    extend_stepper_interface,
    init_rod_fsi_carry,
    scan_steps,
    suggest_rod_forcing_window,
)
from sopht_mpi_tpu_torch.parallel.mesh import unshard_vector_field
from sopht_mpi_tpu_torch.utils import (
    CosseratRodIO,
    FieldBinding,
    FieldIO,
    SnapshotWriter,
    logger,
)


def flow_past_rod_case(
    n_elem=40,
    grid_size=(128, 32, 128),
    surface_grid_density_for_largest_element=16,
    cauchy_number=0.1,
    mass_ratio=100.0,
    froude_number=0.5,
    stretch_bending_ratio=None,
    poisson_ratio=0.5,
    reynolds=100.0,
    coupling_stiffness=-2e5,
    coupling_damping=-1e2,
    rod_start_incline_angle=0.0,
    precision="single",
    mesh=None,
    final_time=2.0,
    save_data=False,
    fused=False,
    window=50,
    sparse_forcing=None,
    *,
    device,
):
    """Run to ``final_time``; returns (times, rod tip positions (n, 3)).

    ``fused`` runs the coupled step in scan windows of ``window`` steps,
    reading the tip (and, on the sparse window, whether the window covered
    the rod's support) once a window; ``sparse_forcing`` None takes the
    sparse window where it fits, True requires it, False keeps the dense
    path. Otherwise the host loop runs the rod's substeps and the flow step
    one at a time and logs every ``final_time / 50``. ``save_data`` writes
    ``FieldIO`` vorticity and ``CosseratRodIO`` files in the host loop and
    ``SnapshotWriter`` snapshots in the fused loop, the assembled fields
    on a ``mesh`` (``create_mesh(3, (pz, py), device=...)``, which shards
    the flow over an in-process mesh)."""
    case = cases._build_flow_past_rod_objects(
        grid_size, device=device, n_elem=n_elem,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
        cauchy_number=cauchy_number, mass_ratio=mass_ratio,
        froude_number=froude_number,
        stretch_bending_ratio=stretch_bending_ratio,
        poisson_ratio=poisson_ratio, reynolds=reynolds,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping,
        rod_start_incline_angle=rod_start_incline_angle,
        precision=precision,
        # the fused step computes the flow forces itself
        flow_forces=not fused,
        mesh=mesh,
    )
    flow_sim, flow_past_rod = case.flow_sim, case.rod
    flow_past_sim = case.collection
    cosserat_rod_flow_interactor = case.interactor
    real_t = flow_sim.real_t

    if save_data and not fused:
        io = FieldIO(dim=3, real_dtype=real_t)
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
            vorticity=FieldBinding(flow_sim, "vorticity_field")
        )
        rod_io = CosseratRodIO(cosserat_rod=flow_past_rod, real_dtype=real_t)

    # ---- time loop ----
    if fused:
        sparse_window = None
        if sparse_forcing is not False:
            sparse_window = suggest_rod_forcing_window(
                cosserat_rod_flow_interactor, flow_past_rod, grid_size
            )
            if sparse_window is None:
                msg = (
                    "sparse forcing window would cover most of the grid "
                    "(rod reach ~ domain size); keeping the dense path"
                )
                if sparse_forcing is True:
                    raise ValueError(msg)
                logger.warning(msg)
            else:
                logger.info(
                    f"sparse forcing window (Wz, Wy, Wx): {sparse_window}"
                )

        def build_step(win):
            return build_rod_fsi_step(
                flow_sim,
                cosserat_rod_flow_interactor,
                flow_past_sim,
                dt_prefac=0.25,
                free_stream_fn=lambda t: case.free_stream,
                rod_dt=case.rod_dt,
                sparse_forcing_window=win,
            )

        step = build_step(sparse_window)
        carry = init_rod_fsi_carry(
            flow_sim, cosserat_rod_flow_interactor, flow_past_rod
        )
        snaps = None
        if save_data:
            logger.warning(
                "fused save_data writes async .npy snapshots "
                "(vorticity + rod positions) to snapshots/, NOT the host "
                "loop's FieldIO h5+XDMF set; use --host-loop for h5 output"
            )
            snaps = SnapshotWriter(
                interval=final_time / 50, out_dir="snapshots"
            )
        tip_times, tip_positions = [], []
        window_margin, regrow_attempts = 1.1, 0
        while float(carry.time) < final_time:
            # the steps build new tensors, so `carry` survives the scan and
            # a tripped window can be replayed from it
            new_carry, diag = scan_steps(step, carry, window)
            if sparse_window is not None and not bool(diag[1].all()):
                # the tripped window's physics is tainted from the trip step
                # on: grow the forcing window (the dense path where it would
                # cover most of the grid), rebuild the step and replay this
                # scan window from the last good carry
                regrow_attempts += 1
                if regrow_attempts > 3:
                    # consecutive trips despite regrowing: window coverage
                    # is not the cause (likely a substep-count overflow)
                    raise RuntimeError(
                        "sparse forcing window still tripping after 3 "
                        "consecutive regrows - likely a substep-count "
                        "overflow, not window coverage; disable "
                        "sparse_forcing or raise max_rod_substeps"
                    )
                window_margin *= 1.3
                prev_window = sparse_window
                sparse_window = suggest_rod_forcing_window(
                    cosserat_rod_flow_interactor, flow_past_rod, grid_size,
                    margin=window_margin,
                )
                if sparse_window is None and sparse_forcing is True:
                    raise RuntimeError(
                        "sparse forcing was REQUIRED (sparse_forcing=True) "
                        "but the regrown window would cover most of the "
                        "grid; rerun without --sparse-forcing to allow the "
                        "dense fallback"
                    )
                if sparse_window == prev_window:
                    # the grown margin gave the same (wall-clamped) window:
                    # a replay would trip the same way, so fall back to the
                    # dense path now
                    if sparse_forcing is True:
                        raise RuntimeError(
                            "sparse forcing window is wall-clamped and "
                            "cannot grow further (window "
                            f"{sparse_window} unchanged at margin "
                            f"{window_margin:.2f}) yet the rod outran it; "
                            "sparse_forcing=True forbids the dense "
                            "fallback - rerun without --sparse-forcing"
                        )
                    logger.warning(
                        "regrown sparse window unchanged (wall-clamped); "
                        "falling back to the dense forcing path"
                    )
                    sparse_window = None
                logger.warning(
                    "sparse forcing window outgrown mid-run; rebuilding "
                    f"with margin {window_margin:.2f} -> window "
                    f"{sparse_window} (None = dense) and replaying from "
                    f"t={float(carry.time):.4f}"
                )
                step = build_step(sparse_window)
                continue
            regrow_attempts = 0  # this window completed: heals succeeded
            carry = new_carry
            if snaps is not None:
                snaps.maybe_save(
                    float(carry.time),
                    vorticity=unshard_vector_field(
                        carry.flow_state.primary_field, flow_sim.mesh),
                    rod_position=carry.rod_state.position,
                )
            tip_times.append(float(carry.time))
            tip_positions.append(carry.rod_state.position[:, -1].cpu().numpy())
            logger.info(
                f"time: {tip_times[-1]:.2f} "
                f"({tip_times[-1] / final_time * 100:2.1f}%), "
                f"tip: {tip_positions[-1]}"
            )
        if snaps is not None:
            snaps.close()
        return np.asarray(tip_times), np.asarray(tip_positions)

    if sparse_forcing is True:
        raise ValueError("sparse_forcing=True needs the fused loop")
    timestepper = PositionVerlet()
    do_step, stages_and_updates = extend_stepper_interface(
        timestepper, flow_past_sim
    )
    foto_timer = 0.0
    foto_timer_limit = final_time / 50
    tip_times, tip_positions = [], []

    while flow_sim.time < final_time:
        if foto_timer >= foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            tip_times.append(flow_sim.time)
            tip_positions.append(
                flow_past_rod.position_collection[:, -1].cpu().numpy().copy()
            )
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                f"vort divg. L2: "
                f"{flow_sim.get_vorticity_divergence_l2_norm():.4f}, "
                "grid dev error: "
                f"{cosserat_rod_flow_interactor.get_grid_deviation_error_l2_norm():.6f}"
            )
            if save_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
                rod_io.save(
                    h5_file_name=f"rod_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )

        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.25)
        rod_time_steps = int(flow_dt / min(flow_dt, case.rod_dt))
        local_rod_dt = flow_dt / rod_time_steps
        rod_time = flow_sim.time
        for _ in range(rod_time_steps):
            rod_time = do_step(
                timestepper, stages_and_updates, flow_past_sim,
                rod_time, local_rod_dt,
            )
            cosserat_rod_flow_interactor.time_step(dt=local_rod_dt)
        cosserat_rod_flow_interactor()
        flow_sim.time_step(dt=flow_dt, free_stream_velocity=case.free_stream)
        foto_timer += flow_dt

    return np.asarray(tip_times), np.asarray(tip_positions)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=2.0)
    parser.add_argument("--grid-size-x", type=int, default=128)
    parser.add_argument("--n-elem", type=int, default=None)
    parser.add_argument(
        "--n-devices", type=int, default=1,
        help="z shards of an in-process mesh on the one device",
    )
    parser.add_argument("--precision", default="single")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which needs a card; cpu runs on "
        "the CPU)",
    )
    parser.add_argument("--save-data", action="store_true")
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="run the fused coupled step in windows (the default)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven loop, the rod's substeps and the flow step one at "
        "a time",
    )
    parser.add_argument(
        "--sparse-forcing", dest="sparse_forcing", action="store_true",
        default=None,
        help="require the moving sparse IBM window (fused loop): the spread "
        "and the forcing curl act on a window tracking the rod's marker "
        "support (suggest_rod_forcing_window); a window the support outgrows "
        "is regrown and replayed, and the run fails only where the window "
        "would have to go dense. Default: sparse where the window fits, "
        "dense otherwise",
    )
    parser.add_argument(
        "--dense-forcing", dest="sparse_forcing", action="store_false",
        help="the dense IBM forcing path",
    )
    parser.add_argument(
        "--fast", action="store_true",
        help="fast spectral tier (sopht_mpi_tpu_torch.enable_fast_spectral)",
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

    nx = args.grid_size_x
    # the reference grid aspect and rod discretization: nz = nx, ny = nx/4
    # (the z extent must hold the whole unit-length rod)
    flow_past_rod_case(
        n_elem=args.n_elem or 5 * nx // 16,
        grid_size=(nx, nx // 4, nx),
        surface_grid_density_for_largest_element=nx // 8,
        final_time=args.final_time,
        precision=args.precision,
        save_data=args.save_data,
        fused=args.fused,
        sparse_forcing=args.sparse_forcing,
        mesh=mesh,
        device=device,
    )
