"""3D mixed soft / rigid FSI: a flexible rod and a fixed rigid sphere in the
same viscous stream, on the PyTorch port.

Counterpart of ``examples/3d/rod_and_sphere.py``: a Cosserat rod hanging
across the stream and a sphere downstream of it in its wake; the rod's
position-Verlet substeps with the flow loads, the sphere's penalty
interaction, both spreads and the flow step are one fused step
(``models.fsi.build_multi_body_fsi_step``), run in scan windows. The
sphere's drag comes from the summed Lagrangian forcing. The case is built
by ``sopht_mpi_tpu_torch.cases._build_rod_and_sphere_objects``.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/3d/rod_and_sphere.py --grid-size-x 64 --final-time 1
    python examples_torch/3d/rod_and_sphere.py --n-devices 2

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
    build_multi_body_fsi_step,
    init_multi_body_fsi_carry,
    scan_steps,
)
from sopht_mpi_tpu_torch.utils import logger


def rod_and_sphere_case(
    n_elem=8,
    grid_size=(32, 32, 64),
    surface_grid_density_for_largest_element=8,
    cauchy_number=0.1,
    mass_ratio=100.0,
    reynolds=100.0,
    coupling_stiffness=-2e5,
    coupling_damping=-1e2,
    precision="single",
    mesh=None,
    final_time=1.0,
    window=20,
    *,
    device,
):
    """Returns (times, rod tip positions, sphere drag coefficients), one of
    each a scan window of ``window`` steps. Raises where a body's sparse
    window failed to cover its support. ``mesh``
    (``create_mesh(3, (pz, py), device=...)``) shards the flow over an
    in-process mesh."""
    case = cases._build_rod_and_sphere_objects(
        grid_size, device=device, n_elem=n_elem,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element),
        cauchy_number=cauchy_number, mass_ratio=mass_ratio,
        reynolds=reynolds, coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, precision=precision,
        mesh=mesh,
    )
    rho_f, u_free_stream = 1.0, 1.0

    # ---- the fused step in scan windows ----
    step = build_multi_body_fsi_step(
        case.flow_sim,
        case.bodies,
        dt_prefac=0.25,
        free_stream_fn=lambda t: case.free_stream,
        sub_dt=case.rod_dt,
    )
    carry = init_multi_body_fsi_carry(case.flow_sim, case.bodies, step)
    sparse = step.uses_sparse_forcing
    if sparse:
        logger.info("per-body sparse IBM forcing windows engaged")

    drag_scale = (
        0.5 * rho_f * u_free_stream**2 * 0.25 * np.pi
        * case.sphere_diameter**2
    )
    times, tips, drags = [], [], []
    while float(carry.time) < final_time:
        carry, diag = scan_steps(step, carry, window)
        if sparse:
            lag_sums, windows_ok = diag
            if not bool(windows_ok.all()):
                raise RuntimeError(
                    "a body's sparse forcing window failed to cover its "
                    "support; rerun with "
                    "build_multi_body_fsi_step(..., sparse_forcing=False)"
                )
        else:
            lag_sums = diag
        t = float(carry.time)
        tip = carry.body_states[0].position[:, -1].cpu().numpy()
        # the sphere's drag from the summed Lagrangian forcing (the force on
        # the body is minus the forcing's sum)
        drag = -float(lag_sums[1][-1, 0]) / drag_scale
        times.append(t)
        tips.append(tip)
        drags.append(drag)
        logger.info(
            f"time: {t:.3f}, rod tip: {tip.round(4)}, sphere Cd: {drag:.3f}"
        )
    return np.asarray(times), np.asarray(tips), np.asarray(drags)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=1.0)
    parser.add_argument("--grid-size-x", type=int, default=64)
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
    rod_and_sphere_case(
        n_elem=args.n_elem or nx // 8,
        grid_size=(nx // 2, nx // 2, nx),
        surface_grid_density_for_largest_element=nx // 8,
        final_time=args.final_time,
        precision=args.precision,
        mesh=mesh,
        device=device,
    )
