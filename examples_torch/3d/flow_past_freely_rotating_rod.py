"""Flow past a freely-rotating rod, with full checkpoint/restart, on the
PyTorch port.

Counterpart of ``examples/3d/flow_past_freely_rotating_rod.py``: rod
clamped in translation but free to rotate about its axis
(GeneralConstraint), strong convolution vorticity filtering
{"order": 5, "type": "convolution"}, and a complete FSI restart: flow
fields + rod dynamic state + IBM position-mismatch field, with a
time-consistency check on load. The case is built by
``sopht_mpi_tpu_torch.cases._build_freely_rotating_rod_objects``.

Two checkpoint backends for the fused loop: ``h5`` (``FieldIO`` + XDMF +
``save_rod_state``, the reference's on-disk layout; needs h5py) and
``carry`` (``CarryCheckpointer``: the whole carry, for a bit-exact
restart). The host loop checkpoints through ``h5``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/3d/flow_past_freely_rotating_rod.py --final-time 0.5
    python examples_torch/3d/flow_past_freely_rotating_rod.py --final-time 1.0 --restart
    python examples_torch/3d/flow_past_freely_rotating_rod.py --checkpoint-backend carry
    python examples_torch/3d/flow_past_freely_rotating_rod.py --n-devices 2

``--n-devices N`` shards the flow over an in-process (N, 1) mesh on the one
device; both checkpoint backends then hold the sharded state (the h5 files
the assembled fields).
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.models import (
    PositionVerlet,
    extend_stepper_interface,
    scan_steps,
)
from sopht_mpi_tpu_torch.parallel.mesh import unshard_vector_field
from sopht_mpi_tpu_torch.utils import (
    CarryCheckpointer,
    FieldBinding,
    FieldIO,
    load_rod_state,
    logger,
    save_rod_state,
)


def flow_past_freely_rotating_rod_case(
    n_elem=16,
    grid_size=(64, 64, 128),
    surface_grid_density_for_largest_element=12,
    cauchy_number=0.2,
    mass_ratio=10.0,
    aspect_ratio=10.0,
    base_length=1.0,
    poisson_ratio=0.5,
    reynolds=100.0,
    coupling_stiffness=-2e5,
    coupling_damping=-1e2,
    rod_start_incline_angle=np.pi / 2,
    precision="single",
    final_time=1.0,
    restart_dir="restart_data",
    save_interval=0.25,
    restart_simulation=False,
    fused=False,
    window=50,
    checkpoint_backend="h5",
    mesh=None,
    *,
    device,
):
    """Run to ``final_time`` (from the latest checkpoint in ``restart_dir``
    with ``restart_simulation``), checkpointing every ``save_interval`` and
    at the end. ``fused`` runs the fused coupled step in windows of
    ``window`` steps, checkpointing at window ends through
    ``checkpoint_backend`` ("h5" or "carry"); otherwise the host loop runs
    the rod's substeps and the flow step one at a time. ``mesh``
    (``create_mesh(3, (pz, py), device=...)``) shards the flow over an
    in-process mesh. Returns (rod, flow simulator) in the final state."""
    if checkpoint_backend not in ("h5", "carry"):
        raise ValueError(f"checkpoint_backend {checkpoint_backend!r}: h5 or "
                         "carry")
    use_carry = fused and checkpoint_backend == "carry"
    case = cases._build_freely_rotating_rod_objects(
        grid_size, device=device, n_elem=n_elem,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
        cauchy_number=cauchy_number, mass_ratio=mass_ratio,
        aspect_ratio=aspect_ratio, base_length=base_length,
        poisson_ratio=poisson_ratio, reynolds=reynolds,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping,
        rod_start_incline_angle=rod_start_incline_angle,
        precision=precision,
        # the fused step computes the flow forces itself
        flow_forces=not fused,
        mesh=mesh,
    )
    flow_sim, rod, interactor = case.flow_sim, case.rod, case.interactor

    # ---- checkpoint IO: flow fields + IBM mismatch + rod state ----
    os.makedirs(restart_dir, exist_ok=True)
    if not use_carry:
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
        forcing_grid_io = FieldIO(dim=3, real_dtype=flow_sim.real_t)
        forcing_grid_io.add_as_lagrangian_fields_for_io(
            lagrangian_grid=interactor.forcing_grid.compute_lag_grid_position_field,
            lagrangian_grid_name="forcing_grid",
            position_mismatch=FieldBinding(interactor, "position_mismatch"),
        )

    def save_checkpoint(index):
        io.save(
            h5_file_name=f"{restart_dir}/flow_{index:05d}.h5",
            time=flow_sim.time,
        )
        forcing_grid_io.save(
            h5_file_name=f"{restart_dir}/forcing_grid_{index:05d}.h5",
            time=flow_sim.time,
        )
        save_rod_state(rod, f"{restart_dir}/rod_{index:05d}.h5",
                       time=flow_sim.time)

    def load_latest_checkpoint():
        flow_files = sorted(glob.glob(f"{restart_dir}/flow_*.h5"))
        if not flow_files:
            raise FileNotFoundError(f"no checkpoint in {restart_dir}")
        latest = int(flow_files[-1].split("_")[-1].split(".")[0])
        flow_time = io.load(h5_file_name=f"{restart_dir}/flow_{latest:05d}.h5")
        grid_time = forcing_grid_io.load(
            h5_file_name=f"{restart_dir}/forcing_grid_{latest:05d}.h5"
        )
        rod_time = load_rod_state(rod, f"{restart_dir}/rod_{latest:05d}.h5")
        # restart consistency (reference :225-229)
        if not flow_time == grid_time == rod_time:
            raise ValueError(
                f"inconsistent checkpoint times: {flow_time}, {grid_time}, "
                f"{rod_time}"
            )
        flow_sim.time = float(flow_time)
        logger.info(f"restarted from checkpoint {latest} at t={flow_time}")
        return latest

    if fused:
        # the coupled step in windows; the host objects are synced from the
        # carry at h5 checkpoints and at the end
        carry_ckpt = None
        if use_carry:
            carry_ckpt = CarryCheckpointer(os.path.join(restart_dir, "carry"))
        checkpoint_index = 0
        if restart_simulation and not use_carry:
            checkpoint_index = load_latest_checkpoint()
        step, carry = cases.build_freely_rotating_rod_step(case)
        if restart_simulation and use_carry:
            checkpoint_index = carry_ckpt.latest_step()
            if checkpoint_index is None:
                raise FileNotFoundError(
                    f"no carry checkpoint in {carry_ckpt.directory}")
            carry = carry_ckpt.restore(template=carry)
            logger.info(
                f"restarted from carry checkpoint {checkpoint_index} "
                f"at t={float(carry.time):.6f}"
            )

        def sync_from(c):
            flow_sim._set_state(c.flow_state)
            flow_sim.time = float(c.time)
            rod.state = c.rod_state
            interactor.state = c.vb_state

        def checkpoint(index, c):
            if use_carry:
                # copies the carry to the host now, writes it in the
                # background
                carry_ckpt.save(index, c)
            else:
                sync_from(c)
                save_checkpoint(index)

        if not restart_simulation:
            checkpoint_index += 1
            checkpoint(checkpoint_index, carry)
        save_timer = 0.0
        while float(carry.time) < final_time:
            t_before = float(carry.time)
            carry, _ = scan_steps(step, carry, window)
            save_timer += float(carry.time) - t_before
            if save_timer >= save_interval:
                save_timer = 0.0
                checkpoint_index += 1
                checkpoint(checkpoint_index, carry)
                logger.info(
                    f"time: {float(carry.time):.3f} "
                    f"({float(carry.time) / final_time * 100:2.1f}%)"
                )
        checkpoint_index += 1
        checkpoint(checkpoint_index, carry)
        sync_from(carry)
        if use_carry:
            carry_ckpt.close()
        return rod, flow_sim

    timestepper = PositionVerlet()
    do_step, stages_and_updates = extend_stepper_interface(
        timestepper, case.collection
    )

    checkpoint_index = 0
    if restart_simulation:
        checkpoint_index = load_latest_checkpoint()
    save_timer = 0.0

    while flow_sim.time < final_time:
        if save_timer >= save_interval or (
            save_timer == 0 and not restart_simulation
        ):
            save_timer = 0.0
            checkpoint_index += 1
            save_checkpoint(checkpoint_index)
            logger.info(
                f"time: {flow_sim.time:.3f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                "grid dev error: "
                f"{interactor.get_grid_deviation_error_l2_norm():.6f}"
            )

        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.25)
        rod_time_steps = int(flow_dt / min(flow_dt, case.rod_dt))
        local_rod_dt = flow_dt / rod_time_steps
        rod_time = flow_sim.time
        for _ in range(rod_time_steps):
            rod_time = do_step(
                timestepper, stages_and_updates, case.collection,
                rod_time, local_rod_dt,
            )
            interactor.time_step(dt=local_rod_dt)
        interactor()
        flow_sim.time_step(dt=flow_dt, free_stream_velocity=case.free_stream)
        save_timer += flow_dt

    checkpoint_index += 1
    save_checkpoint(checkpoint_index)
    return rod, flow_sim


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=1.0)
    parser.add_argument("--grid-size-x", type=int, default=128)
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
    parser.add_argument("--restart", action="store_true")
    parser.add_argument(
        "--checkpoint-backend", choices=("h5", "carry"), default="h5",
        help="h5: reference-layout FieldIO+XDMF and rod-state files; carry: "
        "the fused loop's whole carry (CarryCheckpointer, bit-exact restart; "
        "fused loop only)",
    )
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
    flow_past_freely_rotating_rod_case(
        n_elem=nx // 8,
        grid_size=(nx // 2, nx // 2, nx),
        surface_grid_density_for_largest_element=max(8, nx // 10),
        final_time=args.final_time,
        precision=args.precision,
        restart_simulation=args.restart,
        fused=args.fused,
        checkpoint_backend=args.checkpoint_backend,
        mesh=mesh,
        device=device,
    )
