"""Run-to-run determinism of the rod steps on one CUDA card, and the time
of four coupled steps.

    python3 -m sopht_mpi_tpu_torch.tools.probe_determinism [--json PATH]

Prints one JSON object (also written to ``PATH`` with ``--json``):

- ``runs``: the freely rotating rod (``cases._build_freely_rotating_rod_case``,
  (64, 64, 128), dense IBM path) for 200 steps and the flexible rod on its
  sparse window (``cases._build_rod_bench_case``, (128, 32, 128)) for 50,
  each twice from states built the same way, with and without
  ``torch.use_deterministic_algorithms(True)``: whether the two carries are
  bit-equal, their largest difference and the tensors that differ;
- ``ops``: on the freely rotating rod's markers and forcing after its runs,
  the package's dense spread (``ops.ibm.lagrangian_to_eulerian_spread``)
  and surface-grid marker sums (``body_loads``), and the two torch
  scatter-adds they can be written with (``index_put_`` with
  ``accumulate=True``, ``index_add_``), each called 20 times on the same
  inputs: the number of distinct results;
- ``time``: s/step (host clock between two synchronisations, the median of
  three windows of 10 steps after 3 warm-up steps) and device busy ms a
  step (``torch.profiler`` over 3 steps) of the freely rotating rod
  (64, 64, 128), the rod (256, 64, 256), the multi-body case
  (128, 128, 256) and the 2D rod (256, 512), with the card's name and
  power limit.

To compare two trees, run the file with ``PYTHONPATH`` set to each in
turns: it imports whichever ``sopht_mpi_tpu_torch`` comes first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

# cuBLAS is deterministic under use_deterministic_algorithms only with a
# fixed workspace, which must be set before its first handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from sopht_mpi_tpu_torch import cases  # noqa: E402
from sopht_mpi_tpu_torch.models import scan_steps  # noqa: E402
from sopht_mpi_tpu_torch.ops import ibm  # noqa: E402
from sopht_mpi_tpu_torch.utils.checkpoint import _flatten  # noqa: E402

FREE_ROD_GRID, FREE_ROD_STEPS = (64, 64, 128), 200
SPARSE_ROD_GRID, SPARSE_ROD_STEPS = (128, 32, 128), 50
OP_REPEATS = 20


def card_tag():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def compare(a, b):
    fa, fb = _flatten(a), _flatten(b)
    differ = sorted(k for k in fa if not torch.equal(fa[k], fb[k]))
    gap = max((float((fa[k].double() - fb[k].double()).abs().max())
               for k in differ), default=0.0)
    return {"bit_equal": not differ, "max_abs_diff": gap, "differ": differ}


def twice(build, n_steps):
    finals = []
    for _ in range(2):
        step, carry = build()
        carry, _ = scan_steps(step, carry, n_steps)
        torch.cuda.synchronize()
        finals.append(carry)
    return compare(*finals), step, finals[0]


def free_rod(dev):
    return cases._build_freely_rotating_rod_case(FREE_ROD_GRID, device=dev)


def sparse_rod(dev):
    step, (carry,) = cases._build_rod_bench_case(SPARSE_ROD_GRID, device=dev)
    return step, carry


def runs(dev):
    out = {}
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            key = "deterministic" if deterministic else "default"
            free, _, carry = twice(lambda: free_rod(dev), FREE_ROD_STEPS)
            sparse, sstep, _ = twice(lambda: sparse_rod(dev), SPARSE_ROD_STEPS)
        check_sparse = sstep.sparse_forcing_window is not None
        out[key] = {
            "free_rod": free, "sparse_rod": sparse,
            "sparse_rod_window": list(sstep.sparse_forcing_window)
            if check_sparse else None,
            "warnings": sorted({str(w.message)[:200] for w in caught}),
        }
    torch.use_deterministic_algorithms(False)
    return out, carry


def distinct(fn):
    results = [fn() for _ in range(OP_REPEATS)]
    torch.cuda.synchronize()
    uniq = []
    for r in results:
        if not any(torch.equal(r, u) for u in uniq):
            uniq.append(r)
    spread = max(float((r.double() - results[0].double()).abs().max())
                 for r in results)
    return {"distinct": len(uniq), "max_abs_diff": spread}


def ops(carry, dev):
    """Repeat the transfers of the dense rod step on the markers of its
    final carry."""
    interactor = cases._build_freely_rotating_rod_objects(
        FREE_ROD_GRID, device=dev).interactor
    grid, params = interactor.forcing_grid, interactor.params
    flow = carry.flow_state.velocity_field
    lagp = grid.lag_positions(carry.rod_state)
    _, support_idx, support_disp = ibm.nearest_grid_index_and_support(
        lagp, params.dx, params.eul_grid_coord_shift)
    weights = ibm.interpolation_weights(support_disp, params.dx)
    gen = torch.Generator(device="cpu").manual_seed(0)
    lag_force = torch.randn(lagp.shape, generator=gen,
                            dtype=lagp.dtype).to(dev)
    field = torch.zeros_like(flow)
    idx = ibm._support_gather_indices(support_idx, field.shape[1:])
    upd = (weights[None] * lag_force.reshape(3, 1, 1, 1, -1)).to(flow.dtype)
    comp = torch.arange(3, device=dev).reshape(3, 1, 1, 1, 1).expand(
        upd.shape)
    bidx = (comp,) + tuple(i[None].expand(upd.shape) for i in idx)
    elem_idx = grid._elem_idx
    n_elem = carry.rod_state.omega.shape[1]
    return {
        "markers": int(lagp.shape[1]),
        "spread": distinct(lambda: ibm.lagrangian_to_eulerian_spread(
            field, lag_force, weights, support_idx)),
        "body_loads": distinct(lambda: torch.cat([t.reshape(-1) for t in (
            grid.body_loads(carry.rod_state, lag_force))])),
        "index_put_accumulate": distinct(lambda: field.clone().index_put_(
            bidx, upd, accumulate=True)),
        "index_add_": distinct(lambda: lag_force.new_zeros(
            (3, n_elem)).index_add_(1, elem_idx, lag_force)),
    }


def timed(step, carry, n=10, windows=3):
    carry, _ = scan_steps(step, carry, 3)
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        carry, _ = scan_steps(step, carry, n)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / n)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry, _ = scan_steps(step, carry, 3)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / 3
    kernels = sum(e.count for e in events) / 3
    return {"s_per_step": sorted(per)[1], "s_per_step_windows": per,
            "device_ms_per_step": busy, "kernels_per_step": kernels}


def times(dev):
    builds = {
        "free_rod_64x64x128": lambda: free_rod(dev),
        "rod_256x64x256": lambda: (lambda s, c: (s, c[0]))(
            *cases._build_rod_bench_case((256, 64, 256), device=dev)),
        "multibody_128x128x256": lambda: (lambda s, c: (s, c[0]))(
            *cases._build_multibody_bench_case((128, 128, 256), device=dev)),
        "rod_2d_256x512": lambda: cases.flow_past_rod_2d_case(
            (256, 512), device=dev)[:2],
    }
    out = {}
    for name, build in builds.items():
        step, carry = build()
        out[name] = timed(step, carry)
        del step, carry
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_determinism: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    result = {"card": card_tag(), "package": os.path.dirname(cases.__file__)}

    def write():
        if args.json:
            os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                        exist_ok=True)
            with open(args.json, "w") as f:
                f.write(json.dumps(result) + "\n")

    result["runs"], carry = runs(dev)
    write()
    result["ops"] = ops(carry, dev)
    write()
    result["time"] = times(dev)
    write()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
