"""Adjoint-based parameter inversion through the flow solver, on the PyTorch
port: recover the kinematic viscosity of a Lamb-Oseen vortex from one
observed late-time vorticity field by gradient descent on the solver itself.

Counterpart of ``examples/2d/adjoint_viscosity_inversion.py``. The
"measurement" is the vorticity after evolving the analytic Lamb-Oseen
initial condition (``nu_true``) for ``n_steps`` of the solver. From a wrong
guess (default 2x off), Adam on log(nu) against ``mean((omega_sim(nu) -
omega_obs)^2)`` recovers ``nu_true``. The gradient is torch autograd through
the rollout: ENO3 advection, diffusion and the wall sponge in plain
PyTorch, and on a CUDA device in float32 the Poisson solve's three FFT-pass
kernels, each a ``torch.autograd.Function`` with the JAX package's rule.

``precision="double"`` runs float64 on the given device, where the Poisson
solve takes the dense ``torch.fft`` route (the JAX example moves its
process to the CPU for float64 instead); ``precision="single"`` on a card
takes the kernel route.

Run (on the card; ``--device cpu`` runs on the CPU):
    python examples_torch/2d/adjoint_viscosity_inversion.py
    python examples_torch/2d/adjoint_viscosity_inversion.py --precision single
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import torch

from sopht_mpi_tpu_torch.cases import (
    compute_lamb_oseen_velocity,
    compute_lamb_oseen_vorticity,
)
from sopht_mpi_tpu_torch.models import UnboundedFlowSimulator2D
from sopht_mpi_tpu_torch.models.flow.simulator_2d import (
    FlowState2D,
    flow_step_2d,
)
from sopht_mpi_tpu_torch.utils import get_real_t, logger


def cosine_decay(iters):
    """optax's ``cosine_decay_schedule`` factor at update ``t``:
    ``0.5 (1 + cos(pi min(t, iters) / iters))`` (``CosineAnnealingLR``'s
    recursive form is not this formula)."""
    return lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, iters) / iters))


def build_inversion(grid_size=(64, 64), nu_true=1e-3, n_steps=160,
                    precision="double", *, device):
    """The inversion's pieces: ``(loss_fn, real_t)``, where ``loss_fn(
    log_nu)`` is the misfit of a rollout at ``exp(log_nu)`` (``log_nu`` a
    0-d tensor) against the observed field of a rollout at ``nu_true``, and
    ``real_t`` the precision's dtype."""
    real_t = get_real_t(precision)
    x_range = 1.0
    t_start = 1.0
    x_cm = y_cm = 0.5  # centred: the vortex must stay away from the walls
    gamma = 4 * np.pi * nu_true * t_start  # maximum vorticity 1 at t_start

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu_true,
        flow_type="navier_stokes",
        with_free_stream_flow=False,
        real_t=real_t,
        time=t_start,
        device=device,
    )
    x = flow_sim.position_field[0].cpu().numpy()
    y = flow_sim.position_field[1].cpu().numpy()
    # the observed initial state, shared by truth and inversion: only the
    # dynamics' nu is unknown
    omega0 = torch.as_tensor(
        compute_lamb_oseen_vorticity(x, y, x_cm, y_cm, nu_true, gamma,
                                     t_start),
        dtype=real_t, device=flow_sim.device)
    u0 = torch.as_tensor(
        compute_lamb_oseen_velocity(x, y, x_cm, y_cm, nu_true, gamma, t_start),
        dtype=real_t, device=flow_sim.device)
    state0 = FlowState2D(omega0, u0, None)
    # a fixed dt, stable for the largest nu the optimizer visits (the
    # velocity-dependent CFL control would add a noisy dt term to the
    # gradient)
    dt = torch.tensor(0.25 * flow_sim.compute_stable_timestep(),
                      dtype=real_t, device=flow_sim.device)
    greens = flow_sim._poisson_greens
    zero_fsv = torch.zeros(2, dtype=real_t, device=flow_sim.device)

    def rollout(nu):
        state = state0
        for _ in range(n_steps):
            state = flow_step_2d(
                state, dt, zero_fsv,
                dx=flow_sim.dx, nu=nu, flow_type="navier_stokes",
                with_free_stream=False,
                penalty_zone_width=flow_sim.penalty_zone_width,
                poisson_solver=flow_sim.unbounded_poisson_solver,
                poisson_greens=greens,
            )
        return state.primary_scalar_field

    with torch.no_grad():
        omega_obs = rollout(torch.tensor(nu_true, dtype=real_t,
                                         device=flow_sim.device))

    def loss_fn(log_nu):
        return torch.mean((rollout(torch.exp(log_nu)) - omega_obs) ** 2)

    return loss_fn, real_t


def adjoint_viscosity_inversion_case(
    grid_size=(64, 64),
    nu_true=1e-3,
    nu_guess_factor=2.0,
    n_steps=160,
    iters=70,
    learning_rate=0.15,
    precision="double",
    *,
    device,
):
    """Returns (nu_recovered, nu_true, relative_error, loss_history)."""
    device = torch.device(device)
    loss_fn, real_t = build_inversion(grid_size, nu_true, n_steps, precision,
                                      device=device)
    log_nu = torch.tensor(np.log(nu_guess_factor * nu_true), dtype=real_t,
                          device=device, requires_grad=True)
    # cosine-decayed Adam: the misfit valley is narrow in log(nu), so a
    # constant step oscillates around the optimum instead of settling
    opt = torch.optim.Adam([log_nu], lr=learning_rate)
    schedule = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(iters))
    history = []
    best = (np.inf, float(log_nu.detach()))
    for it in range(iters):
        opt.zero_grad()
        val = loss_fn(log_nu)
        val.backward()
        history.append(float(val.detach()))
        at = float(log_nu.detach())
        if history[-1] < best[0]:
            best = (history[-1], at)
        if it % 5 == 0 or it == iters - 1:
            logger.info(
                f"iter {it:3d}: loss {history[-1]:.3e} at "
                f"nu {math.exp(at):.6e} (true {nu_true:.6e})"
            )
        opt.step()
        schedule.step()
    # score the point after the final update too (under a decayed schedule
    # it is often the closest), then report the best iterate: Adam rings
    # around the (exactly-zero-loss) optimum, and the lowest-misfit nu is
    # the estimator
    with torch.no_grad():
        final_val = float(loss_fn(log_nu))
    history.append(final_val)
    if final_val < best[0]:
        best = (final_val, float(log_nu.detach()))
    nu_rec = float(np.exp(best[1]))
    rel_err = abs(nu_rec - nu_true) / nu_true
    logger.info(
        f"recovered nu = {nu_rec:.6e}, true = {nu_true:.6e}, "
        f"relative error = {rel_err:.2%}"
    )
    return nu_rec, nu_true, rel_err, history


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=64)
    parser.add_argument("--n-steps", type=int, default=160)
    parser.add_argument("--iters", type=int, default=70)
    parser.add_argument("--nu-guess-factor", type=float, default=2.0)
    parser.add_argument("--precision", default="double")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which needs a card; cpu runs on "
        "the CPU)",
    )
    args = parser.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; run with --device cpu for the CPU")
    adjoint_viscosity_inversion_case(
        grid_size=(args.grid_size, args.grid_size),
        n_steps=args.n_steps,
        iters=args.iters,
        nu_guess_factor=args.nu_guess_factor,
        precision=args.precision,
        device=device,
    )
