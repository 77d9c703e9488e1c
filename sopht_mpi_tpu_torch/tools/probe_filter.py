"""Device times of the single-device filtered-transport trio on one CUDA
device, the multiplicative filter first:

    python3 sopht_mpi_tpu_torch/tools/probe_filter.py --json [tag] [--steps]
    python3 -m sopht_mpi_tpu_torch.tools.probe_filter --sweep

``--json`` prints the card (name and power limit) and one JSON line, all
float32: ``laplacian_filter_vector_3d(..., "multiplicative")`` at the rod
path's (3, 256, 64, 256) (orders 1 and 2) and at 256^3 (order 1), and the
diffusion step and the wall sponge (width 2) at the rod's shape, each as
its device time (``torch.profiler`` over 20 calls: the kernels' own time),
its time a call in a batch of 20 back-to-back calls (CUDA events: the
device's time where the host keeps ahead) and its largest difference from
the plain version; the filter's plan where the package has one. With
``--steps`` also the device time a step (5 profiled steps after 5 warm-up
steps) of the (256, 64, 256) rod case and of the sharded 256^3 flow case's
filtered arm on a (2, 2) mesh, with the filter's launches a step. It runs
against the package it imports, so run this file with ``PYTHONPATH`` at
each of two trees in turns (parent, change, change, parent) to compare
them on one card.

``--sweep`` times the z-marching filter kernel alone (device time and
batch) under every tile, ring depth and z chunk count its launcher takes,
at the rod's shape and at 256^3, beside the plan's choice, each plan's
output held against the plain version.
"""

from __future__ import annotations

import json
import sys

import torch

from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as kernels
from sopht_mpi_tpu_torch.tools.probe_sharded import (
    FILTERED,
    batched_ms,
    card,
    device_ms,
    step_times,
)

ROD = (3, 256, 64, 256)
CUBE = (3, 256, 256, 256)


def _max_err(out, ref):
    return float((out - ref).abs().max())


def trio_calls(shape, gen):
    """name -> (kernel wrapper thunk, plain thunk) at ``shape``."""
    dev = torch.device("cuda", 0)
    w = torch.randn(shape, device=dev, generator=gen)
    p = torch.tensor(0.13, device=dev)
    calls = {}
    for order in (1, 2):
        calls[f"filter {order}"] = (
            lambda o=order: kernels.laplacian_filter_vector_3d(
                w, o, "multiplicative"),
            lambda o=order: kernels.laplacian_filter_vector_3d_ref(
                w, o, "multiplicative"))
    calls["diffusion"] = (
        lambda: kernels.diffusion_timestep_vector_3d(w, p),
        lambda: kernels.diffusion_timestep_vector_3d_ref(w, p))
    calls["sponge"] = (
        lambda: kernels.penalise_field_boundary_vector_3d(w, 2),
        lambda: kernels.penalise_field_boundary_vector_3d_ref(w, 2))
    return w, calls


def rod_step_ms(dev):
    """(device ms a step over 5 profiled steps, filter launches a step) of
    the (256, 64, 256) rod case after 5 warm-up steps."""
    from torch.profiler import ProfilerActivity, profile

    from sopht_mpi_tpu_torch import cases
    from sopht_mpi_tpu_torch.models import scan_steps

    step, (carry,) = cases._build_rod_bench_case((256, 64, 256), device=dev)
    carry, _ = scan_steps(step, carry, 5)
    torch.cuda.synchronize()
    before = kernels.laplacian_filter_vector_3d.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 5 / 1e3
    return busy, (kernels.laplacian_filter_vector_3d.launches - before) / 5


def timing(tag, dev, steps):
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tag": tag, "module": kernels.__file__, "card": card(),
           "device_ms": {}, "batch_ms": {}, "max_abs_err": {}, "plans": {}}
    for shape, names in ((ROD, ("filter 1", "filter 2", "diffusion",
                                "sponge")),
                         (CUBE, ("filter 1",))):
        w, calls = trio_calls(shape, gen)
        where = "rod" if shape == ROD else "256^3"
        for name in names:
            fn, ref_fn = calls[name]
            key = f"{name} {where}"
            out["max_abs_err"][key] = _max_err(fn(), ref_fn())
            out["device_ms"][key] = device_ms(fn)
            out["batch_ms"][key] = batched_ms(fn)
        if hasattr(kernels, "filter_plan"):
            out["plans"][where] = kernels.filter_plan(w)._asdict()
        del w, calls
        torch.cuda.empty_cache()
    if steps:
        out["rod_step_device_ms"], out["rod_filter_launches"] = rod_step_ms(
            dev)
        torch.cuda.empty_cache()
        out["filtered_step_device_ms"], out["filtered_s_per_step"] = \
            step_times(256, (2, 2), dev, FILTERED)
    return out


def sweep(dev):
    """Device time of ``mult_filter_zmarch_kernel`` alone under every plan
    at the rod's shape and 256^3 (order 1: orig the field), each plan's
    output against the plain version."""
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded

    gen = torch.Generator(device=dev).manual_seed(0)
    lib = kernels.library()
    for shape in (ROD, CUBE):
        _, nz, ny, nx = shape
        w = torch.randn(shape, device=dev, generator=gen)
        out = torch.empty_like(w)
        ref = kernels.laplacian_filter_vector_3d_ref(w, 1, "multiplicative")
        chosen = kernels.filter_plan(w)
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for tile in sharded.ZMARCH_TILES:
            for stages in range(2 + sharded.ZMARCH_KEEP["filter"],
                                sharded.ZMARCH_STAGE_RANGE[1] + 1):
                for chunks in (1, 2, 4, 8, 16):
                    plan = sharded.sharded_stencil_plan_of(
                        "filter", 1, nz, ny, nx, 4, True, tile, stages,
                        -(-nz // chunks))

                    def fn(plan=plan):
                        err = lib.sopht_mult_filter_3d_zmarch_f32(
                            w.data_ptr(), w.data_ptr(), out.data_ptr(), nz,
                            ny, nx, *plan.args(), stream)
                        if err:
                            raise RuntimeError(f"{plan}: CUDA error {err}")

                    out.fill_(float("nan"))
                    fn()
                    rows.append((device_ms(fn), batched_ms(fn), plan,
                                 _max_err(out, ref)))
        rows.sort(key=lambda r: r[0])
        print(f"mult_filter_zmarch_kernel {shape}: plan {tuple(chosen)}",
              flush=True)
        for ms, batch, plan, err in rows:
            mark = " <- plan" if plan == chosen else ""
            print(f"  {ms:.4f} ms (batch {batch:.4f}) tile {plan.tx}x"
                  f"{plan.ty} stages {plan.stages} zchunk {plan.zchunk} "
                  f"blocks {plan.blocks} ({plan.blocks_per_sm} an SM), max"
                  f"|diff| {err:.3g}{mark}", flush=True)
        del w, out, ref
        torch.cuda.empty_cache()


def main(argv):
    if not torch.cuda.is_available():
        print("probe_filter: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(card(), flush=True)
    if argv and argv[0] == "--sweep":
        sweep(dev)
        return 0
    if not argv or argv[0] != "--json":
        print(__doc__, file=sys.stderr)
        return 2
    rest = [a for a in argv[1:] if a != "--steps"]
    tag = rest[0] if rest else kernels.__file__
    print(json.dumps(timing(tag, dev, "--steps" in argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
