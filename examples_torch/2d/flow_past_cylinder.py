"""Flow past a fixed circular cylinder at Re = 200 (vortex shedding and
drag), on the PyTorch port.

Counterpart of ``examples/2d/flow_past_cylinder.py`` (velocity scale 1,
cylinder radius 0.03, x range 1, coupling stiffness -5e4 and damping -20,
60 forcing points). ``flow_past_cylinder_boundary_forcing_case`` is the
host loop, with the drag log, vorticity frames and a movie of them;
``flow_past_cylinder_fused_case`` runs the coupled step in scan windows.
Both build the case with ``sopht_mpi_tpu_torch.cases._build_cylinder_objects``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/2d/flow_past_cylinder.py --grid-size-x 512 --final-time 200
    python examples_torch/2d/flow_past_cylinder.py --host-loop --plot --final-time 5
    python examples_torch/2d/flow_past_cylinder.py --n-devices 4  # (4, 1) mesh

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
from sopht_mpi_tpu_torch.models import scan_steps
from sopht_mpi_tpu_torch.parallel.mesh import (
    unshard_scalar_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import compile_video, logger


def flow_past_cylinder_boundary_forcing_case(
    nondim_final_time=200.0,
    grid_size=(256, 512),
    reynolds=200.0,
    coupling_stiffness=-5e4,
    coupling_damping=-20.0,
    mesh=None,
    precision="single",
    save_diagnostic=False,
    plot=False,
    *,
    device,
):
    """The host loop: one interaction and one flow step at a time, a log
    line (and with ``plot`` a vorticity frame) every 1/50 of the run, the
    drag every 0.25 time scales; with ``save_diagnostic`` the drag history
    goes to ``drag_vs_time.csv``, with ``plot`` the frames to a movie
    (``compile_video``: ffmpeg, else a GIF). Returns (t*, Cd) lists.
    ``mesh`` (``create_mesh(2, (py, px), device=...)``) shards the flow over
    an in-process mesh; the frames take the assembled field."""
    case = cases._build_cylinder_objects(
        grid_size, device=device, reynolds=reynolds,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, precision=precision, mesh=mesh)
    flow_sim = case.flow_sim
    cylinder_flow_interactor = case.interactor
    velocity_scale = 1.0
    velocity_free_stream = (velocity_scale, 0.0)
    cyl_radius = 0.03

    timescale = cyl_radius / velocity_scale
    final_time = nondim_final_time * timescale
    data_timer = 0.0
    data_timer_limit = 0.25 * timescale
    drag_coeffs_time, drag_coeffs = [], []
    foto_timer = 0.0
    foto_timer_limit = final_time / 50

    while flow_sim.time < final_time:
        if foto_timer >= foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                "grid deviation L2 error: "
                f"{cylinder_flow_interactor.get_grid_deviation_error_l2_norm():.8f}"
            )
            if plot:
                _plot_fields(flow_sim, cylinder_flow_interactor, timescale)

        if data_timer >= data_timer_limit or data_timer == 0:
            data_timer = 0.0
            drag_coeffs_time.append(flow_sim.time / timescale)
            drag = float(
                cylinder_flow_interactor.global_lag_grid_forcing_field[0].sum())
            drag_coeff = abs(drag) / velocity_scale / velocity_scale / cyl_radius
            drag_coeffs.append(drag_coeff)

        dt = flow_sim.compute_stable_timestep()
        cylinder_flow_interactor.time_step(dt=dt)
        cylinder_flow_interactor()
        flow_sim.time_step(dt=dt, free_stream_velocity=velocity_free_stream)

        foto_timer += dt
        data_timer += dt

    if save_diagnostic:
        np.savetxt(
            "drag_vs_time.csv",
            np.c_[np.array(drag_coeffs_time), np.array(drag_coeffs)],
            delimiter=",",
        )
    if plot:
        # the frames as a movie (GIF where ffmpeg is missing)
        out = compile_video("snap_*.png", output="flow.mp4", fps=10)
        if out:
            logger.info(f"wrote {out}")
    return drag_coeffs_time, drag_coeffs


def _plot_fields(flow_sim, interactor, timescale):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from sopht_mpi_tpu_torch.utils import lab_cmap

    fig, ax = plt.subplots(figsize=(8, 4))
    position = unshard_vector_field(flow_sim.position_field, flow_sim.mesh)
    x = position[0].cpu().numpy()
    y = position[1].cpu().numpy()
    ax.contourf(
        x, y,
        unshard_scalar_field(flow_sim.vorticity_field,
                             flow_sim.mesh).cpu().numpy(),
        levels=np.linspace(-25, 25, 100), extend="both", cmap=lab_cmap,
    )
    pos = interactor.forcing_grid.compute_lag_grid_position_field().cpu().numpy()
    ax.scatter(pos[0], pos[1], s=4, color="k")
    ax.set_title(f"Vorticity, time: {flow_sim.time / timescale:.2f}")
    ax.set_aspect("equal")
    fig.savefig(f"snap_{int(flow_sim.time * 100):04d}.png")
    plt.close(fig)


def flow_past_cylinder_fused_case(
    nondim_final_time=200.0,
    grid_size=(256, 512),
    reynolds=200.0,
    coupling_stiffness=-5e4,
    coupling_damping=-20.0,
    precision="single",
    window=500,
    mesh=None,
    *,
    device,
):
    """The same physics, the coupled step (CFL dt, IBM, flow step) run in
    scan windows of ``window`` steps (``cases._build_cylinder_fsi_case``);
    the drag of each window's last step is logged and written to
    ``drag_vs_time.csv``. Returns (t*, Cd) lists. ``mesh`` shards the flow
    over an in-process mesh."""
    step, (carry,) = cases._build_cylinder_fsi_case(
        grid_size, device=device, reynolds=reynolds,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, precision=precision, mesh=mesh)
    velocity_scale, cyl_radius = 1.0, 0.03
    timescale = cyl_radius / velocity_scale
    t_end = nondim_final_time * timescale
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window)
        cd = float(lag_forces[-1, 0].abs()) / (velocity_scale**2 * cyl_radius)
        times.append(float(carry.time) / timescale)
        drag_coeffs.append(cd)
        logger.info(f"t*={times[-1]:.1f} Cd={cd:.3f}")
    np.savetxt(
        "drag_vs_time.csv", np.c_[times, drag_coeffs], delimiter=","
    )
    return times, drag_coeffs


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--grid-size-x", type=int, default=512)
    p.add_argument("--final-time", type=float, default=200.0)
    p.add_argument("--reynolds", type=float, default=200.0)
    p.add_argument(
        "--n-devices", type=int, default=1,
        help="y shards of an in-process mesh on the one device",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which needs a card; cpu runs on "
        "the CPU)",
    )
    p.add_argument("--plot", action="store_true")
    p.add_argument(
        "--fused", action="store_true", default=True,
        help="run the coupled step in scan windows (the default)",
    )
    p.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven loop, one interaction and flow step at a time",
    )
    args = p.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device; run with --device cpu for the CPU")
    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(2, (args.n_devices, 1), device=device)
    grid = (args.grid_size_x // 2, args.grid_size_x)
    if args.fused:
        flow_past_cylinder_fused_case(
            nondim_final_time=args.final_time,
            grid_size=grid,
            reynolds=args.reynolds,
            mesh=mesh,
            device=device,
        )
        raise SystemExit(0)
    flow_past_cylinder_boundary_forcing_case(
        nondim_final_time=args.final_time,
        grid_size=grid,
        reynolds=args.reynolds,
        mesh=mesh,
        save_diagnostic=True,
        plot=args.plot,
        device=device,
    )
