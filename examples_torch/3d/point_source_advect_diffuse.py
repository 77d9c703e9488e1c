"""Point source advecting and diffusing in 3D (passive vector transport), on
the PyTorch port.

Counterpart of ``examples/3d/point_source_advect_diffuse.py``
(passive_vector flow type, diffused-point-source analytical oracle,
source at (0.3, 0.3, 0.3), unit velocity in x/y/z, t: 5.0 -> 5.4), built
by ``sopht_mpi_tpu_torch.cases.point_source_advection_diffusion_case``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/3d/point_source_advect_diffuse.py --grid-size 64
    python examples_torch/3d/point_source_advect_diffuse.py --device cpu \\
        --grid-size 32 --host-loop --save-data
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.utils import FieldBinding, FieldIO, logger


def point_source_advection_diffusion_case(
    grid_size=(64, 64, 64), precision="single", mesh=None, save_data=False,
    fused=False, window=100, *, device,
):
    """Advect and diffuse the point source from t = 5.0 to 5.4 and return
    the (L2, Linf) errors of the field against the analytic one. The host
    loop steps to exactly t = 5.4, logging every 1/20 of the run (and, with
    ``save_data``, saving the field through ``FieldIO``); ``fused`` runs
    the flow-only step in windows of ``window`` steps, ending up to
    ``window - 1`` steps past 5.4. ``mesh`` (``create_mesh(3, (pz, py),
    device=...)``) shards the fields over an in-process mesh; ``save_data``
    then writes the assembled field."""
    step, carry = cases.point_source_advection_diffusion_case(
        grid_size, device=device, precision=precision, mesh=mesh)
    flow_sim = step.flow_sim
    t_start, t_end = cases.POINT_SOURCE_T_START, cases.POINT_SOURCE_T_END

    if fused and save_data:
        raise ValueError(
            "save_data is not supported with fused=True (snapshot writes "
            "live in the host loop)"
        )
    if save_data:
        x, y, z = cases._grid_positions(flow_sim)
        io = FieldIO(dim=3, real_dtype=flow_sim.real_t)
        io.define_eulerian_grid(
            origin=np.array([z.min(), y.min(), x.min()]),
            dx=flow_sim.dx * np.ones(3),
            grid_size=np.asarray(grid_size),
        )
        io.add_as_eulerian_fields_for_io(
            vorticity=FieldBinding(flow_sim, "primary_vector_field")
        )

    if fused:
        carry, l2, linf = cases.run_point_source_case(step, carry,
                                                      window=window)
        logger.info(f"time: {float(carry.time):.3f}")
    else:
        foto_timer = 0.0
        foto_timer_limit = (t_end - t_start) / 20
        while flow_sim.time < t_end - 1e-10:
            if foto_timer > foto_timer_limit or foto_timer == 0:
                foto_timer = 0.0
                max_vort = float(flow_sim.primary_vector_field.max())
                logger.info(
                    f"time: {flow_sim.time:.2f} "
                    f"({(flow_sim.time - t_start) / (t_end - t_start) * 100:2.1f}%), "
                    f"max_vort: {max_vort:.4f}"
                )
                if save_data:
                    io.save(
                        h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                        time=flow_sim.time,
                    )
            dt = min(flow_sim.compute_stable_timestep(), t_end - flow_sim.time)
            flow_sim.time_step(dt=dt)
            foto_timer += dt
        l2, linf = cases.point_source_errors(
            flow_sim, flow_sim.primary_vector_field, flow_sim.time)

    logger.info(f"vorticity L2 error: {l2}")
    logger.info(f"vorticity Linf error: {linf}")
    return l2, linf


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=128)
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
        help="run the flow-only step in windows (the default)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven loop, one step at a time",
    )
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; run with --device cpu for the CPU")
    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(3, (args.n_devices, 1), device=device)
    point_source_advection_diffusion_case(
        grid_size=(args.grid_size,) * 3,
        precision=args.precision,
        mesh=mesh,
        save_data=args.save_data,
        fused=args.fused,
        device=device,
    )
