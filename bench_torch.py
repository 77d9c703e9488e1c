"""Benchmark of the PyTorch port: FSI step throughput on one CUDA GPU.

    BENCH_CASE=sphere BENCH_GRID=256 BENCH_STEPS=10 python3 bench_torch.py

Prints ONE JSON line, the keys of ``bench.py`` (the JAX package's
benchmark) and a few more:

    {"metric": ..., "value": N, "unit": "Mcells/s", "vs_baseline": null,
     "sec_per_step": N, "grid": [...], "steps": N, "case": ...,
     "fast_spectral": bool, "solve_rel_err_class": ..., "backend": "torch",
     "device": "<name>, <power limit>", "device_ms_per_step": N,
     "kernels_per_step": N}

Metric: million Eulerian cell-updates per second of the full coupled step
(CFL dt control + immersed-boundary interaction + flow step with the
unbounded Poisson velocity recovery), ``BENCH_STEPS`` steps timed on the
host clock between two device synchronisations after as many warm-up
steps. ``device_ms_per_step`` (the device's busy time) and
``kernels_per_step`` (CUDA kernels launched) come from a
``torch.profiler`` window of 3 further steps; both are null on the CPU.
``vs_baseline`` is null: the JAX benchmark's baseline is a proxy measured
for that package and is not restated for this one.

Environment:

- ``BENCH_CASE``: ``sphere`` (rigid sphere at (G, G, G)), ``rod`` (flexible
  rod at (G, G/4, G)), ``multibody`` (rod + sphere at (G/2, G/2, G)) or
  ``cylinder`` (2D cylinder at (G, 2G));
- ``BENCH_GRID`` (G, default 256), ``BENCH_STEPS`` (default 10);
- ``BENCH_FAST=1`` / ``BENCH_NO_FAST=1``: the fast spectral tier (the
  fused-curl velocity recovery) on / off for the solvers the case builds;
  unset, the package default (off). ``fast_spectral`` in the output says
  whether the fused route really ran;
- ``BENCH_ROD_REFRESH``: ``substep_load_refresh`` of the rod cases;
- ``BENCH_DEVICE=cpu``: run on the CPU (for the schema, not for numbers).
  Without it and without a CUDA device the script exits with code 2.
"""

import json
import os
import subprocess
import sys
import time

GRID = int(os.environ.get("BENCH_GRID", "256"))
STEPS = int(os.environ.get("BENCH_STEPS", "10"))
CASE = os.environ.get("BENCH_CASE", "sphere")
CASES = ("sphere", "rod", "multibody", "cylinder")
PROFILED_STEPS = 3


def _case_grid(case: str, g: int) -> tuple[int, ...]:
    if case == "rod":
        return (g, max(8, g // 4), g)
    if case == "multibody":
        return (max(8, g // 2), max(8, g // 2), g)
    if case == "cylinder":
        return (g, 2 * g)
    return (g, g, g)


def _device_tag(torch, device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not readable"


def _build(cases, case, grid_size, device):
    refresh = os.environ.get("BENCH_ROD_REFRESH", "every")
    if case == "rod":
        return cases._build_rod_bench_case(
            grid_size, device=device, substep_load_refresh=refresh)
    if case == "multibody":
        return cases._build_multibody_bench_case(
            grid_size, device=device, substep_load_refresh=refresh)
    if case == "cylinder":
        return cases._build_cylinder_fsi_case(grid_size, device=device)
    return cases._build_fsi_case(grid_size, device=device)


def _profiled(torch, scan_steps, step, carry, n):
    """(device busy ms a step, CUDA kernels a step) over ``n`` steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan_steps(step, carry, n)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return busy_ms / n, sum(e.count for e in events) / n


def main():
    import torch

    if CASE not in CASES:
        raise ValueError(f"BENCH_CASE must be {'|'.join(CASES)}, got {CASE}")
    if os.environ.get("BENCH_DEVICE", "").lower() == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("bench_torch: no CUDA device (set BENCH_DEVICE=cpu to run the "
              "schema on the CPU)", file=sys.stderr)
        return 2

    import numpy as np

    import sopht_mpi_tpu_torch
    from sopht_mpi_tpu_torch import cases
    from sopht_mpi_tpu_torch.models import scan_steps
    from sopht_mpi_tpu_torch.ops.poisson import resolve_fast_spectral
    from sopht_mpi_tpu_torch.parallel import cuda_fft

    if os.environ.get("BENCH_NO_FAST"):
        sopht_mpi_tpu_torch.enable_fast_spectral(False)
    elif os.environ.get("BENCH_FAST"):
        sopht_mpi_tpu_torch.enable_fast_spectral(True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    grid_size = _case_grid(CASE, GRID)
    step, (carry,) = _build(cases, CASE, grid_size, device)

    carry, _ = scan_steps(step, carry, STEPS, donate=True)  # warm-up, build
    sync()
    cuda_fft.fft_greens_curl_ifft_pass.launches = 0
    t0 = time.perf_counter()
    carry, diag = scan_steps(step, carry, STEPS, donate=True)
    sync()
    t1 = time.perf_counter()

    # sparse-window cases carry a per-step window_ok flag: a tripped window
    # means clipped forcing, so the number would not be honest
    if isinstance(diag, tuple) and len(diag) == 2 and torch.is_tensor(
            diag[1]) and diag[1].dtype == torch.bool:
        assert bool(diag[1].all()), "forcing window tripped"

    # the fused-curl route ran if its z pass was launched in the timed steps
    # (never on the CPU, in 2D, or where the solver does not support it)
    fast = bool(resolve_fast_spectral(None)
                and cuda_fft.fft_greens_curl_ifft_pass.launches > 0)
    device_ms, kernels = None, None
    if device.type == "cuda":
        device_ms, kernels = _profiled(torch, scan_steps, step, carry,
                                       PROFILED_STEPS)

    n_cells = int(np.prod(grid_size))
    sec_per_step = (t1 - t0) / STEPS
    dim = len(grid_size)
    grid_tag = (f"{GRID}cubed" if CASE == "sphere"
                else "x".join(str(g) for g in grid_size))
    print(json.dumps({
        "metric": f"{dim}d_fsi_{CASE}_{grid_tag}_step_throughput",
        "value": round(n_cells / sec_per_step / 1e6, 3),
        "unit": "Mcells/s",
        "vs_baseline": None,
        "sec_per_step": round(sec_per_step, 6),
        "grid": list(grid_size),
        "steps": STEPS,
        "case": CASE,
        "fast_spectral": fast,
        # both tiers of the port are plain float32 arithmetic: the fast
        # tier fuses the curl into the solve's passes
        "solve_rel_err_class": "float32 on both tiers",
        "backend": "torch",
        "device": _device_tag(torch, device),
        "device_ms_per_step": (None if device_ms is None
                               else round(device_ms, 4)),
        "kernels_per_step": None if kernels is None else round(kernels, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
