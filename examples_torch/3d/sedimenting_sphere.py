"""Sedimenting rigid sphere: two-way coupled rigid-body dynamics against the
analytical Stokes terminal velocity, on the PyTorch port.

Counterpart of ``examples/3d/sedimenting_sphere.py``. A dense sphere falls
under its net weight ``(rho_s - rho_f) V g``; at Re << 1 the viscous drag
balances it at

    v_t = 2 (rho_s - rho_f) g R^2 / (9 mu)        (Stokes, unbounded)

``g`` is chosen so that ``v_t`` is the target velocity, and the run lasts
``n_tau`` relaxation times ``tau = 2 rho_s R^2 / (9 mu)``. The step is
``cases.sedimenting_sphere_case`` (one ``DynamicRigidBody``, its sparse
window where it fits). In float64, the default, the Poisson solve takes the
dense ``torch.fft`` route.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/3d/sedimenting_sphere.py --grid-size 64
    python examples_torch/3d/sedimenting_sphere.py --n-devices 2

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
from sopht_mpi_tpu_torch.utils import logger


def sedimenting_sphere_case(
    grid_size=(64, 64, 64),
    sphere_radius=0.06,
    density_ratio=2.0,
    kinematic_viscosity=1.0,
    terminal_velocity_target=0.05,
    coupling_stiffness=-5e5,
    coupling_damping=-2e2,
    precision="double",
    mesh=None,
    n_tau=6.0,
    window=10,
    substeps=1,
    *,
    device,
):
    """Returns (times, z velocities, Stokes terminal velocity), one time and
    velocity a scan window of ``window`` steps, to ``n_tau * tau``. Raises
    where the sphere's sparse window failed to cover its support. ``mesh``
    (``create_mesh(3, (pz, py), device=...)``) shards the flow over an
    in-process mesh."""
    step, carry, v_t, tau = cases.sedimenting_sphere_case(
        grid_size, device=device, precision=precision,
        sphere_radius=sphere_radius, density_ratio=density_ratio,
        kinematic_viscosity=kinematic_viscosity,
        terminal_velocity_target=terminal_velocity_target,
        coupling_stiffness=coupling_stiffness,
        coupling_damping=coupling_damping, substeps=substeps, mesh=mesh)
    sparse = step.uses_sparse_forcing

    final_time = n_tau * tau
    times, vels = [], []
    while float(carry.time) < final_time:
        carry, diag = scan_steps(step, carry, window)
        if sparse and not bool(diag[1].all()):
            raise RuntimeError(
                "the sphere's sparse forcing window failed to cover its "
                "support; rerun with "
                "build_multi_body_fsi_step(..., sparse_forcing=False)"
            )
        t = float(carry.time)
        vz = float(carry.body_states[0].velocity[2])
        times.append(t)
        vels.append(vz)
        logger.info(f"t/tau: {t / tau:.2f}, v_z/v_t: {vz / (-v_t):.4f}")
    return np.asarray(times), np.asarray(vels), v_t


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=64)
    parser.add_argument("--precision", default="double")
    parser.add_argument("--n-tau", type=float, default=6.0)
    parser.add_argument(
        "--n-devices", type=int, default=1,
        help="z shards of an in-process mesh on the one device",
    )
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
    if args.no_fast:
        import sopht_mpi_tpu_torch

        sopht_mpi_tpu_torch.enable_fast_spectral(False)
    elif args.fast:
        import sopht_mpi_tpu_torch

        sopht_mpi_tpu_torch.enable_fast_spectral()
    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(3, (args.n_devices, 1), device=device)
    times, vels, v_t = sedimenting_sphere_case(
        grid_size=(args.grid_size,) * 3,
        precision=args.precision,
        n_tau=args.n_tau,
        mesh=mesh,
        device=device,
    )
    print(
        f"terminal: measured v_z = {vels[-1]:.5f}, Stokes v_t = {-v_t:.5f} "
        f"(ratio {vels[-1] / (-v_t):.3f})"
    )
