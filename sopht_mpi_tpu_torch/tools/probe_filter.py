"""Device times of the single-device filtered-transport trio on one CUDA
device, the two filter types first:

    python3 sopht_mpi_tpu_torch/tools/probe_filter.py --json [tag] [--steps]
    python3 -m sopht_mpi_tpu_torch.tools.probe_filter --sweep [conv]

``--json`` prints the card (name and power limit) and one JSON line, all
float32: ``laplacian_filter_vector_3d`` at the rod path's (3, 256, 64, 256)
(multiplicative orders 1 and 2, convolution orders 1, 2 and 5), at 256^3
(multiplicative order 1, convolution orders 1, 2 and 5) and at the freely
rotating rod's (3, 64, 64, 128) (convolution order 5), and the diffusion
step and the wall sponge (width 2) at the rod's shape, each as its device
time (``torch.profiler`` over 20 calls: the kernels' own time), its time a
call in a batch of 20 back-to-back calls (CUDA events: the device's time
where the host keeps ahead), its launches a call and its largest
difference from the plain version; the filters' plans where the package
has them. With ``--steps`` also the device time a step (5 profiled steps
after 5 warm-up steps) of the (256, 64, 256) rod case, of the sharded 256^3
flow case's filtered arm on a (2, 2) mesh and, where the package has it, of
the freely rotating rod case at (64, 64, 128) (twice), with the filter's
launches and the CUDA kernels a step and the filter's device time a
step. It runs
against the package it imports, so run this file with ``PYTHONPATH`` at
each of two trees in turns (parent, change, change, parent) to compare
them on one card.

``--sweep`` times the z-marching multiplicative filter kernel alone
(device time and batch) under every tile, ring depth and z chunk count its
launcher takes, at the rod's shape and at 256^3, beside the plan's choice,
each plan's output held against the plain version; ``--sweep conv`` the
convolution filter's kernel the same way at orders 1 and 5, also at the
freely rotating rod's shape, and under the same plans a second design of
it whose in-plane stages go level by level through shared memory
(``tools/conv_filter_pingpong.cu``, built on its own).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

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
FREE_ROD = (3, 64, 64, 128)


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
    for order in (1, 2, 5):
        calls[f"conv {order}"] = (
            lambda o=order: kernels.laplacian_filter_vector_3d(
                w, o, "convolution"),
            lambda o=order: kernels.laplacian_filter_vector_3d_ref(
                w, o, "convolution"))
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


def free_rod_step(dev):
    """{device ms, CUDA kernels, filter launches, filter device ms} a step
    over 5 profiled steps of the freely rotating rod case at its default
    (64, 64, 128) after 5 warm-up steps."""
    from torch.profiler import ProfilerActivity, profile

    from sopht_mpi_tpu_torch import cases
    from sopht_mpi_tpu_torch.models import scan_steps

    step, carry = cases._build_freely_rotating_rod_case(device=dev)
    carry, _ = scan_steps(step, carry, 5)
    torch.cuda.synchronize()
    before = kernels.laplacian_filter_vector_3d.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return {
        "device_ms": sum(e.self_device_time_total for e in events) / 5e3,
        "kernels": sum(e.count for e in events) / 5,
        "filter_launches":
            (kernels.laplacian_filter_vector_3d.launches - before) / 5,
        "filter_device_ms": sum(e.self_device_time_total for e in events
                                if "conv_filter" in e.key) / 5e3,
    }


def timing(tag, dev, steps):
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"tag": tag, "module": kernels.__file__, "card": card(),
           "device_ms": {}, "batch_ms": {}, "launches": {},
           "max_abs_err": {}, "plans": {}}
    for shape, names in ((ROD, ("filter 1", "filter 2", "conv 1", "conv 2",
                                "conv 5", "diffusion", "sponge")),
                         (CUBE, ("filter 1", "conv 1", "conv 2", "conv 5")),
                         (FREE_ROD, ("conv 5",))):
        w, calls = trio_calls(shape, gen)
        where = {ROD: "rod", CUBE: "256^3", FREE_ROD: "free rod"}[shape]
        for name in names:
            fn, ref_fn = calls[name]
            key = f"{name} {where}"
            before = kernels.laplacian_filter_vector_3d.launches
            out["max_abs_err"][key] = _max_err(fn(), ref_fn())
            out["launches"][key] = (kernels.laplacian_filter_vector_3d.launches
                                    - before)
            out["device_ms"][key] = device_ms(fn)
            out["batch_ms"][key] = batched_ms(fn)
        if hasattr(kernels, "filter_plan"):
            out["plans"][where] = kernels.filter_plan(w)._asdict()
        if hasattr(kernels, "conv_filter_plan"):
            for order in (1, 2, 5):
                out["plans"][f"{where} conv {order}"] = \
                    kernels.conv_filter_plan(w, order)._asdict()
        del w, calls
        torch.cuda.empty_cache()
    if steps:
        out["rod_step_device_ms"], out["rod_filter_launches"] = rod_step_ms(
            dev)
        torch.cuda.empty_cache()
        out["filtered_step_device_ms"], out["filtered_s_per_step"] = \
            step_times(256, (2, 2), dev, FILTERED)
        from sopht_mpi_tpu_torch import cases

        if hasattr(cases, "_build_freely_rotating_rod_case"):
            for _ in range(2):
                torch.cuda.empty_cache()
                out.setdefault("free_rod_step", []).append(free_rod_step(dev))
    return out


PINGPONG_SOURCE = Path(__file__).resolve().parent / "conv_filter_pingpong.cu"


def pingpong_library():
    """Build (at first use) and load ``tools/conv_filter_pingpong.cu``, the
    convolution filter with its in-plane stages ping-ponged in shared
    memory (its entry point takes orders 1 and 5, float32)."""
    import ctypes

    from sopht_mpi_tpu_torch._build import load_library

    lib = load_library("conv_filter_pingpong", (str(PINGPONG_SOURCE),),
                       includes=("stencils_3d.cu",))
    fn = lib.sopht_conv_filter_3d_pingpong_f32
    fn.argtypes = kernels._SIGNATURES["sopht_conv_filter_3d_zmarch"]
    fn.restype = ctypes.c_int
    return lib


def pingpong_smem(order, tx, ty, stages, itemsize=4):
    """Dynamic shared bytes of a ``conv_filter_pingpong_kernel`` block: the
    ring and the x-staged rows as ``conv_filter_zmarch_kernel``'s, and
    beside them none (order 1), one (order 2) or two buffers of the ring's
    tile for the levels, in place of the y-staged cells."""
    v = 16 // itemsize
    pad, rows = -(-order // v) * v, ty + 2 * order
    tile = 3 * rows * (tx + 2 * pad)
    buffers = 0 if order == 1 else 1 if order == 2 else 2
    return itemsize * ((stages + buffers) * tile + 3 * rows * tx)


def sweep_conv(dev):
    """Device time of ``conv_filter_zmarch_kernel`` alone under every plan
    at the rod's shape, 256^3 and the freely rotating rod's shape, orders 1
    and 5, each plan's output against the plain version; beside it, under
    the same plans, ``conv_filter_pingpong_kernel`` (the in-plane stages
    level by level in shared memory, ``tools/conv_filter_pingpong.cu``).
    Prints the fastest plan of each design a line as JSON at the end (a
    plan whose profiled time is under half its batch time, where the
    profile lost launches, is not counted)."""
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded

    gen = torch.Generator(device=dev).manual_seed(0)
    designs = {
        "registers": (kernels.library().sopht_conv_filter_3d_zmarch_f32,
                      lambda plan, order: plan),
        "shared": (pingpong_library().sopht_conv_filter_3d_pingpong_f32,
                   lambda plan, order: plan._replace(smem=pingpong_smem(
                       order, plan.tx, plan.ty, plan.stages))),
    }
    best = {}
    for shape in (ROD, CUBE, FREE_ROD):
        _, nz, ny, nx = shape
        w = torch.randn(shape, device=dev, generator=gen)
        out = torch.empty_like(w)
        stream = torch.cuda.current_stream().cuda_stream
        for order in (1, 5):
            ref = kernels.laplacian_filter_vector_3d_ref(w, order,
                                                         "convolution")
            chosen = kernels.conv_filter_plan(w, order)
            rows = []
            for tile in sharded.ZMARCH_TILES:
                for stages in range(sharded.ZMARCH_STAGE_RANGE[0],
                                    sharded.ZMARCH_STAGE_RANGE[1] + 1):
                    for chunks in (1, 2, 4, 8, 16):
                        try:
                            plan = kernels.conv_filter_plan_of(
                                order, nz, ny, nx, 4, True, tile, stages,
                                -(-nz // chunks))
                        except ValueError:  # too many shared bytes
                            continue
                        for design, (entry, plan_of) in designs.items():
                            dplan = plan_of(plan, order)

                            def fn(entry=entry, plan=dplan, order=order):
                                err = entry(w.data_ptr(), out.data_ptr(), nz,
                                            ny, nx, order, *plan.args(),
                                            stream)
                                if err:
                                    raise RuntimeError(f"{plan}: CUDA error "
                                                       f"{err}")

                            out.fill_(float("nan"))
                            fn()
                            rows.append((device_ms(fn), batched_ms(fn),
                                         design, plan,
                                         _max_err(out, ref)))
            rows.sort(key=lambda r: r[0])
            print(f"convolution filter {shape} order {order}: plan "
                  f"{tuple(chosen)}", flush=True)
            for ms, batch, design, plan, err in rows:
                mark = (" <- plan" if plan == chosen
                        and design == "registers" else "")
                # a profile that lost launches reads far below the batch
                missed = ms < 0.5 * batch
                if missed:
                    mark += " (the profile missed launches)"
                print(f"  {ms:.4f} ms (batch {batch:.4f}) {design} tile "
                      f"{plan.tx}x{plan.ty} stages {plan.stages} zchunk "
                      f"{plan.zchunk} blocks {plan.blocks}, max|diff| "
                      f"{err:.3g}{mark}", flush=True)
                key = f"{design} {order} {shape}"
                if key not in best and not missed:
                    best[key] = [ms, batch, plan.tx, plan.ty, plan.stages,
                                 plan.zchunk, err]
                if plan == chosen and design == "registers":
                    best[f"plan {order} {shape}"] = [ms, batch]
            del ref
        del w, out
        torch.cuda.empty_cache()
    print(json.dumps(best), flush=True)


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
        if argv[1:] == ["conv"]:
            sweep_conv(dev)
        else:
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
