"""Flow past a flexible rod in 2D: the flapping-filament benchmark, on the
PyTorch port.

Counterpart of ``examples/2d/flow_past_rod.py`` (Re = 200, bending stiffness
1.5e-3, mass ratio 1.5, Froude 0.5; the rod clamped at one end in a free
stream that ramps up, with a decaying cross-stream perturbation). The case
is built by ``sopht_mpi_tpu_torch.cases._build_flow_past_rod_2d_objects``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/2d/flow_past_rod.py --final-time 5 --grid-size-x 256
    python examples_torch/2d/flow_past_rod.py --host-loop --save-flow-data
    python examples_torch/2d/flow_past_rod.py --n-devices 4  # (4, 1) mesh

``--n-devices N`` shards the flow over an in-process (N, 1) mesh on the one
device, as the JAX example's flag builds a mesh of N devices.
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
)
from sopht_mpi_tpu_torch.parallel.mesh import unshard_vector_field
from sopht_mpi_tpu_torch.utils import (
    CosseratRodIO,
    FieldBinding,
    FieldIO,
    logger,
)


def flow_past_rod_case(
    nondim_final_time=20.0,
    grid_size=(256, 512),
    reynolds=200.0,
    nondim_bending_stiffness=1.5e-3,
    nondim_mass_ratio=1.5,
    froude=0.5,
    rod_start_incline_angle=0.0,
    coupling_stiffness=-8e4,
    coupling_damping=-30.0,
    precision="single",
    mesh=None,
    save_flow_data=False,
    fused=False,
    window=100,
    *,
    device,
):
    """Run to ``nondim_final_time`` rod lengths over the free stream;
    returns (t*, tip displacement (x, y) / L), also written to
    ``rod_tip_position_vs_time.csv``.

    ``fused`` runs the coupled step in scan windows of ``window`` steps,
    reading the tip once a window; otherwise the host loop runs the rod's
    substeps and the flow step one at a time, reads the tip every 0.1 time
    scales and logs every 1/60 of the run, and with ``save_flow_data``
    writes ``FieldIO`` flow and ``CosseratRodIO`` rod files there (the
    assembled fields on a ``mesh``, ``create_mesh(2, (py, px),
    device=...)``, which shards the flow over an in-process mesh)."""
    if fused and save_flow_data:
        raise ValueError("save_flow_data is not supported with fused=True")
    case = cases._build_flow_past_rod_2d_objects(
        grid_size, device=device, reynolds=reynolds,
        nondim_bending_stiffness=nondim_bending_stiffness,
        nondim_mass_ratio=nondim_mass_ratio, froude=froude,
        rod_start_incline_angle=rod_start_incline_angle,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, precision=precision,
        # the fused step computes the flow forces itself
        flow_forces=not fused, mesh=mesh,
    )
    flow_sim, flow_past_rod = case.flow_sim, case.rod
    flow_past_sim = case.collection
    cosserat_rod_flow_interactor = case.interactor
    real_t = flow_sim.real_t
    tip_start_position = case.tip_start
    velocity_free_stream = 1.0
    base_length = 1.0

    if save_flow_data:
        io = FieldIO(dim=2, real_dtype=real_t)
        position = unshard_vector_field(flow_sim.position_field,
                                        flow_sim.mesh)
        origin = np.asarray(
            [float(position[1].min()), float(position[0].min())]
        )
        io.define_eulerian_grid(
            origin=origin,
            dx=flow_sim.dx * np.ones(2),
            grid_size=np.asarray(grid_size),
        )
        io.add_as_eulerian_fields_for_io(
            vorticity=FieldBinding(flow_sim, "vorticity_field"),
            velocity=FieldBinding(flow_sim, "velocity_field"),
        )
        rod_io = CosseratRodIO(
            cosserat_rod=flow_past_rod, real_dtype=real_t, dim=2
        )

    # ---- time loop ----
    timescale = base_length / velocity_free_stream
    final_time = nondim_final_time * timescale

    def save_tip_history(tip_time, tip_position):
        np.savetxt(
            "rod_tip_position_vs_time.csv",
            np.column_stack((np.asarray(tip_time), np.asarray(tip_position))),
            delimiter=",",
            header="time, tip_x, tip_y",
        )

    if fused:
        step = build_rod_fsi_step(
            flow_sim,
            cosserat_rod_flow_interactor,
            flow_past_sim,
            dt_prefac=0.5,
            free_stream_fn=case.free_stream_fn,
            rod_dt=case.rod_dt,
        )
        carry = init_rod_fsi_carry(
            flow_sim, cosserat_rod_flow_interactor, flow_past_rod
        )
        tip_time, tip_position = [], []
        while float(carry.time) < final_time:
            carry, _ = scan_steps(step, carry, window)
            tip = (
                carry.rod_state.position[:2, -1].cpu().numpy()
                - tip_start_position
            ) / base_length
            tip_time.append(float(carry.time) / timescale)
            tip_position.append(tip)
            logger.info(
                f"t*={tip_time[-1]:.2f} tip=({tip[0]:+.3f}, {tip[1]:+.3f}) L"
            )
        save_tip_history(tip_time, tip_position)
        return np.asarray(tip_time), np.asarray(tip_position)

    timestepper = PositionVerlet()
    do_step, stages_and_updates = extend_stepper_interface(
        timestepper, flow_past_sim
    )
    ramp_timescale = timescale
    velocity_free_stream_perturb = 0.5 * velocity_free_stream

    foto_timer = 0.0
    foto_timer_limit = final_time / 60
    data_timer = 0.0
    data_timer_limit = 0.1 * timescale
    tip_time, tip_position = [], []

    while flow_sim.time < final_time:
        if foto_timer >= foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                f"grid dev error: "
                f"{cosserat_rod_flow_interactor.get_grid_deviation_error_l2_norm():.8f}"
            )
            if save_flow_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
                rod_io.save(
                    h5_file_name=f"rod_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
        if data_timer >= data_timer_limit or data_timer == 0:
            data_timer = 0.0
            tip_time.append(flow_sim.time / timescale)
            tip_position.append(
                (
                    flow_past_rod.position_collection[:2, -1].cpu().numpy()
                    - tip_start_position
                )
                / base_length
            )

        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)

        # substep the rod through the flow timestep
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

        ramp_factor = np.exp(-flow_sim.time / ramp_timescale)
        flow_sim.time_step(
            dt=flow_dt,
            free_stream_velocity=[
                velocity_free_stream * (1.0 - ramp_factor),
                velocity_free_stream_perturb * ramp_factor,
            ],
        )
        foto_timer += flow_dt
        data_timer += flow_dt

    save_tip_history(tip_time, tip_position)
    return np.asarray(tip_time), np.asarray(tip_position)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=20.0)
    parser.add_argument("--grid-size-x", type=int, default=512)
    parser.add_argument(
        "--n-devices", type=int, default=1,
        help="y shards of an in-process mesh on the one device",
    )
    parser.add_argument("--precision", default="single")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which needs a card; cpu runs on "
        "the CPU)",
    )
    parser.add_argument("--save-flow-data", action="store_true")
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="run the fused coupled step in windows (the default)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven loop, the rod's substeps and the flow step one at "
        "a time",
    )
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; run with --device cpu for the CPU")
    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(2, (args.n_devices, 1), device=device)
    flow_past_rod_case(
        nondim_final_time=args.final_time,
        grid_size=(args.grid_size_x // 2, args.grid_size_x),
        precision=args.precision,
        mesh=mesh,
        save_flow_data=args.save_flow_data,
        fused=args.fused,
        device=device,
    )
