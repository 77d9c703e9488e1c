"""Lamb-Oseen vortex: an advected, diffusing vortex against the analytic
solution, on the PyTorch port.

Counterpart of ``examples/2d/lamb_oseen_vortex.py`` (circulation
``4 pi nu t0`` so that the largest vorticity is 1, the vortex at (0.3,
0.3), a unit free stream in x and y, t from 1.0 to 1.4). The simulator and
its initial state are ``cases._build_lamb_oseen_sim``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/2d/lamb_oseen_vortex.py
    python examples_torch/2d/lamb_oseen_vortex.py --host-loop --plot
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.models import (
    build_flow_only_step,
    init_flow_only_carry,
    scan_steps,
)
from sopht_mpi_tpu_torch.utils import Plotter2D, logger


def lamb_oseen_vortex_flow_case(
    grid_size=(256, 256), precision="single", mesh=None, plot=False,
    fused=False, window=100, *, device,
):
    """Run from t = 1.0 to 1.4; returns the vorticity's (L2, Linf) errors
    against the analytic vortex at the final time, L2 = ||err||_2 dx.

    ``fused`` runs the flow-only step in scan windows of ``window`` steps
    (the windows overshoot t = 1.4 by less than a window); otherwise the
    host loop takes the stable timestep capped at the time left, and with
    ``plot`` saves a vorticity frame every 1/25 of the run. ``mesh`` is
    refused (the 2D mesh: ROADMAP.md queue A #11f)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the 2D mesh is not ported yet (ROADMAP.md queue A #11f)")
    if fused and plot:
        raise ValueError(
            "plot is not supported with fused=True (snapshots live in the "
            "host loop)"
        )
    t_start, t_end = 1.0, 1.4
    flow_sim, velocity_free_stream, analytic_vorticity = (
        cases._build_lamb_oseen_sim(grid_size, device=device,
                                    precision=precision, t_start=t_start))
    x = flow_sim.position_field[0].cpu().numpy()
    y = flow_sim.position_field[1].cpu().numpy()
    if plot:
        plotter = Plotter2D()

    if fused:
        free_stream = torch.as_tensor(velocity_free_stream,
                                      dtype=flow_sim.real_t,
                                      device=flow_sim.device)
        step = build_flow_only_step(flow_sim,
                                    free_stream_fn=lambda t: free_stream)
        carry = init_flow_only_carry(flow_sim)
        while float(carry.time) < t_end - 1e-10:
            carry, _ = scan_steps(step, carry, window)
            logger.info(f"time: {float(carry.time):.3f}")
        flow_sim._set_state(carry.flow_state)
        flow_sim.time = float(carry.time)

    foto_timer = 0.0
    foto_timer_limit = (t_end - t_start) / 25
    while flow_sim.time < t_end - 1e-10:
        if plot and (foto_timer >= foto_timer_limit or foto_timer == 0):
            foto_timer = 0.0
            plotter.contourf(x, y, flow_sim.vorticity_field)
            plotter.savefig(f"snap_{int(flow_sim.time * 100):04d}.png")
            plotter.clearfig()
        if int(flow_sim.time * 100) % 10 == 0:
            logger.info(
                f"time: {flow_sim.time:.2f}, "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}"
            )
        dt = min(flow_sim.compute_stable_timestep(), t_end - flow_sim.time)
        flow_sim.time_step(dt=dt, free_stream_velocity=velocity_free_stream)
        foto_timer += dt

    # the final error against the advected, diffused analytic vortex
    error = np.abs(
        flow_sim.vorticity_field.cpu().numpy().astype(np.float64)
        - analytic_vorticity(flow_sim.time)
    )
    l2 = np.linalg.norm(error) * flow_sim.dx
    linf = error.max()
    logger.info(f"vorticity L2 error: {l2}")
    logger.info(f"vorticity Linf error: {linf}")
    return l2, linf


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=256)
    parser.add_argument(
        "--n-devices", type=int, default=1,
        help="shards of a mesh; only 1 is ported (ROADMAP.md queue A #11f)",
    )
    parser.add_argument("--precision", default="single")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which needs a card; cpu runs on "
        "the CPU)",
    )
    parser.add_argument("--plot", action="store_true")
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="run the flow-only step in scan windows (the default)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven loop, one flow step at a time",
    )
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; run with --device cpu for the CPU")
    if args.n_devices > 1:
        raise NotImplementedError(
            "--n-devices > 1: the 2D mesh is not ported yet (ROADMAP.md "
            "queue A #11f)")
    lamb_oseen_vortex_flow_case(
        grid_size=(args.grid_size, args.grid_size),
        precision=args.precision,
        plot=args.plot,
        fused=args.fused,
        device=device,
    )
