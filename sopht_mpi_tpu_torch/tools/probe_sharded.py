"""Build ``csrc/stencils_3d.cu`` and hold the sharded stencils, the
distributed convolve and the sharded flow step against their single-device
counterparts on one CUDA device, with times:

    python3 -m sopht_mpi_tpu_torch.tools.probe_sharded [n]
    python3 sopht_mpi_tpu_torch/tools/probe_sharded.py --json [tag]
    python3 -m sopht_mpi_tpu_torch.tools.probe_sharded --sweep

``--json`` prints the card (name and power limit) and one JSON line: at
256^3 on a (2, 2) mesh, float32, each sharded wrapper's device time
(``torch.profiler``: the exchange's copies and the launch), its time in a
batch of 20 back-to-back calls (CUDA events) and its CUDA-event median of
single calls (host enqueue included), the curl's and the transport's
kernel alone on halos made beforehand (profiler and batch), one field's exchange as the wrappers make it and as a ghosted
copy, each single-device twin, the z-marching kernels' plans, and the
sharded flow step's device time (5 profiled steps) and s/step (10 steps).
It runs against the package it imports, so run this file with
``PYTHONPATH`` at each of two trees in turns (parent, change, change,
parent) to compare them on one card; a parent without the z-marching
kernels is timed through its ghosted entry points.

``--sweep`` times the curl's and the transport's kernel alone (device
time) under every tile, ring depth and z chunk count the launcher takes,
at 256^3 on (2, 2) and (8, 1), beside the plan's choice.

The first form is a short first run for a changed kernel: it prints the
card, the build time, ptxas' lines of the stencil kernels, then

- each sharded stencil on a small odd grid, on one-plane shards and on an
  ``n``^3 grid (default 256) over a few meshes: max |diff| against its plain version and against
  the single-device kernel on the assembled field, and the median of 10
  timed calls (CUDA events) of the wrapper, the single-device twin and the
  plain version;
- the ``n``^3 vector Poisson solve on a (2, 2) mesh against the
  single-device solve: relative error, times, launches, transposes;
- ``cases.sharded_flow_case`` at ``n``^3 on (2, 2) against the same case on
  one device: 3 steps compared, then 10 timed steps of each.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.models import scan_steps
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as single
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver3D
from sopht_mpi_tpu_torch.parallel import collectives, cuda_fft
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)


def median_ms(fn, n=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def stencil_calls(w, u, mesh, dtype):
    """name -> (sharded wrapper, its plain version, the single-device
    kernel), each a thunk."""
    dev = w.device
    ws, us = shard_vector_field(w, mesh), shard_vector_field(u, mesh)
    p = torch.tensor(0.05, dtype=dtype, device=dev)
    add = torch.tensor([1.0, -0.5, 0.25], dtype=dtype, device=dev)
    calls = {
        "diffusion_timestep_vector_3d_sharded": (
            lambda: sharded.diffusion_timestep_vector_3d_sharded(ws, p, mesh),
            lambda: sharded.diffusion_timestep_vector_3d_sharded_ref(
                ws, p, mesh),
            lambda: single.diffusion_timestep_vector_3d(w, p)),
        "curl_3d_sharded": (
            lambda: sharded.curl_3d_sharded(ws, p, mesh, add,
                                            compute_l1_max=True),
            lambda: sharded.curl_3d_sharded_ref(ws, p, mesh, add, True),
            lambda: single.curl_3d(w, p, add, True)),
        "rotational_curl_add_3d_sharded": (
            lambda: sharded.rotational_curl_add_3d_sharded(ws, us, p, mesh),
            lambda: sharded.rotational_curl_add_3d_sharded_ref(
                ws, us, p, mesh),
            lambda: single.rotational_curl_add_3d(w, u, p)),
    }
    if sharded.diffusion_penalise_sharded_supported(w.shape, mesh, 2):
        calls["diffusion_penalise_vector_3d_sharded"] = (
            lambda: sharded.diffusion_penalise_vector_3d_sharded(
                ws, p, 2, mesh),
            lambda: sharded.diffusion_penalise_vector_3d_sharded_ref(
                ws, p, 2, mesh),
            lambda: single.diffusion_penalise_vector_3d(w, p, 2))
    return calls


def probe_stencils(shape, mesh_shape, dtype, dev, gen, timed):
    mesh = create_mesh(3, mesh_shape, device=dev)
    w = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
    u = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
    for name, (fn, ref_fn, twin_fn) in stencil_calls(w, u, mesh,
                                                     dtype).items():
        out, ref, twin = fn(), ref_fn(), twin_fn()
        extra = ""
        if name == "curl_3d_sharded":
            (out, l1), (ref, l1_ref), (twin, l1_twin) = out, ref, twin
            extra = (f", l1 {float(l1):.7g} vs plain {float(l1_ref):.7g} vs "
                     f"single {float(l1_twin):.7g}")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        err_twin = float((unshard_vector_field(out, mesh) - twin).abs().max())
        line = (f"  {name} {shape} {mesh_shape} {dtype}: vs plain {err:.3g}, "
                f"vs single-device kernel {err_twin:.3g}{extra}")
        if timed:
            line += (f"; {median_ms(fn):.4f} ms, single-device "
                     f"{median_ms(twin_fn):.4f} ms, plain "
                     f"{median_ms(ref_fn):.4f} ms")
        print(line, flush=True)


def probe_solve(n, dev, gen):
    mesh = create_mesh(3, (2, 2), device=dev)
    one = UnboundedPoissonSolver3D(n, n, n, device=dev)
    many = UnboundedPoissonSolver3D(n, n, n, device=dev, mesh=mesh)
    rhs = torch.randn((3, n, n, n), device=dev, generator=gen)
    rhs_s = shard_vector_field(rhs, mesh)
    ref = one.vector_field_solve(rhs)
    for fn in cuda_fft.KERNELS:
        fn.launches = 0
    collectives.reset_counts()
    out = unshard_vector_field(many.vector_field_solve(rhs_s), mesh)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in cuda_fft.KERNELS
                if fn.launches}
    rel = float((out - ref).abs().max()) / float(ref.abs().max())
    print(f"  {n}^3 vector solve on (2, 2): relative max|diff| {rel:.3g} vs "
          f"the single-device solve; launches {launches}, collectives "
          f"{collectives.counts()}; "
          f"{median_ms(lambda: many.vector_field_solve(rhs_s)):.4f} ms vs "
          f"single-device {median_ms(lambda: one.vector_field_solve(rhs)):.4f}"
          " ms", flush=True)


def probe_step(n, dev):
    runs = {}
    for mesh_shape in (None, (2, 2)):
        step, (carry,) = cases.sharded_flow_case((n, n, n), mesh_shape,
                                                 device=dev)
        carry, _ = scan_steps(step, carry, 3)
        runs[mesh_shape] = (step, carry)
    (s1, c1), (s4, c4) = runs[None], runs[(2, 2)]
    for what in ("primary_field", "velocity_field"):
        ref = getattr(c1.flow_state, what)
        out = unshard_vector_field(getattr(c4.flow_state, what),
                                   s4.flow_sim.mesh)
        print(f"  {what} after 3 steps: max|diff| "
              f"{float((out - ref).abs().max()):.3g} (|ref| max "
              f"{float(ref.abs().max()):.3g})", flush=True)
    for mesh_shape, (step, carry) in runs.items():
        torch.cuda.synchronize()
        collectives.reset_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry, _ = scan_steps(step, carry, 10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  {n}^3 flow step, mesh {mesh_shape}: "
              f"{(time.perf_counter() - t0) / 10 * 1e3:.3f} ms/step, no host "
              f"sync, collectives over 10 steps {collectives.counts()}",
              flush=True)


def device_ms(fn, n=20):
    """Device time of one call, from ``torch.profiler`` over ``n`` calls:
    the kernels' and copies' own time, without the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / n / 1e3


def batched_ms(fn, n=20):
    """Time of one call from CUDA events around ``n`` calls issued back to
    back after a warm-up: the device's time where the host keeps ahead of
    it (a cross-check of :func:`device_ms`, whose profiler can lose kernel
    records)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def _launch_raw(entry, field, *args):
    fn = getattr(single.library(), f"{entry}_{single._SUFFIX[field.dtype]}")
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def kernel_alone(ws, us, mesh, plans=None, out=None):
    """name -> a thunk that launches the curl's and the transport's kernel
    alone on halo buffers made beforehand, into ``out`` (a new tensor by
    default), with prefactor 0.05 and the curl's add vector (1, -0.5,
    0.25): the z-marching kernels (under ``plans``: name -> plan, default
    the wrapper's; each thunk's ``plan``) where the package has them, else
    its ghosted entry points."""
    dev = ws.device
    p = torch.tensor(0.05, device=dev)
    add = torch.tensor([1.0, -0.5, 0.25], device=dev)
    coords = sharded._coords(ws)
    geo = sharded._geometry(ws)
    out = torch.empty_like(ws) if out is None else out
    l1 = torch.zeros(mesh.axis_sizes, device=dev)
    if hasattr(sharded, "sharded_stencil_plan"):
        wh, uh = sharded._halos(ws, mesh), sharded._halos(us, mesh)
        plans = plans or {
            "curl_3d_sharded": sharded._zmarch_plan("curl", [(ws, *wh)]),
            "rotational_curl_add_3d_sharded": sharded._zmarch_plan(
                "rotational", [(ws, *wh), (us, *uh)])}
        ptrs = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
        calls = {
            "curl_3d_sharded": lambda: _launch_raw(
                "sopht_curl_3d_sharded_zmarch", ws, *ptrs(ws, *wh, coords, p,
                                                          add, out, l1),
                *geo, *plans["curl_3d_sharded"].args()),
            "rotational_curl_add_3d_sharded": lambda: _launch_raw(
                "sopht_rotational_curl_add_3d_sharded_zmarch", ws,
                *ptrs(ws, *wh, us, *uh, coords, p, out), *geo,
                *plans["rotational_curl_add_3d_sharded"].args()),
        }
        for name, fn in calls.items():
            fn.plan = plans.get(name)
        return calls
    wg, ug = sharded._ghost_z(ws, mesh), sharded._ghost_z(us, mesh)
    wy, uy = sharded._halo_y_rows(ws, mesh), sharded._halo_y_rows(us, mesh)
    return {
        "curl_3d_sharded": lambda: _launch_raw(
            "sopht_curl_3d_sharded", ws, wg.data_ptr(), wy[0].data_ptr(),
            wy[1].data_ptr(), coords.data_ptr(), p.data_ptr(), add.data_ptr(),
            out.data_ptr(), l1.data_ptr(), *geo),
        "rotational_curl_add_3d_sharded": lambda: _launch_raw(
            "sopht_rotational_curl_add_3d_sharded", ws, wg.data_ptr(),
            wy[0].data_ptr(), wy[1].data_ptr(), ug.data_ptr(),
            uy[0].data_ptr(), uy[1].data_ptr(), coords.data_ptr(),
            p.data_ptr(), out.data_ptr(), *geo),
    }


def exchange(ws, mesh):
    """One field's exchange as the curl's wrapper makes it: the four halo
    buffers, or a ghosted copy and the y rows where the package has no
    z-plane buffers."""
    if hasattr(sharded, "_halo_z_planes"):
        return lambda: (sharded._halo_z_planes(ws, mesh),
                        sharded._halo_y_rows(ws, mesh))
    return ghosted_exchange(ws, mesh)


def ghosted_exchange(ws, mesh):
    return lambda: (sharded._ghost_z(ws, mesh),
                    sharded._halo_y_rows(ws, mesh))


def step_times(n, mesh_shape, dev):
    """(device ms a step over 5 profiled steps, s/step over 10 steps) of
    the sharded flow case at n^3."""
    from torch.profiler import ProfilerActivity, profile

    step, (carry,) = cases.sharded_flow_case((n, n, n), mesh_shape,
                                             device=dev)
    carry, _ = scan_steps(step, carry, 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = scan_steps(step, carry, 10)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 5 / 1e3
    return busy, s_step


def timing(tag, dev):
    """The ``--json`` line at 256^3 on (2, 2), float32."""
    n, mesh_shape = 256, (2, 2)
    mesh = create_mesh(3, mesh_shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((3, n, n, n), device=dev, generator=gen)
    u = torch.randn((3, n, n, n), device=dev, generator=gen)
    ws, us = shard_vector_field(w, mesh), shard_vector_field(u, mesh)
    calls = stencil_calls(w, u, mesh, torch.float32)
    out = {"tag": tag, "module": sharded.__file__, "card": card(),
           "grid": n, "mesh": list(mesh_shape), "device_ms": {},
           "batch_ms": {}, "event_ms": {}, "kernel_ms": {},
           "kernel_batch_ms": {}, "twin_device_ms": {}, "rel_err": {},
           "plans": {}}
    for name, (fn, ref_fn, twin_fn) in calls.items():
        res, ref = fn(), ref_fn()
        if name == "curl_3d_sharded":
            res, ref = res[0], ref[0]
        out["rel_err"][name] = float((res - ref).abs().max()) / float(
            ref.abs().max())
        del res, ref
        out["device_ms"][name] = device_ms(fn)
        out["batch_ms"][name] = batched_ms(fn)
        out["event_ms"][name] = median_ms(fn, n=20)
        out["twin_device_ms"][name] = device_ms(twin_fn)
    for name, fn in kernel_alone(ws, us, mesh).items():
        out["kernel_ms"][name] = device_ms(fn)
        out["kernel_batch_ms"][name] = batched_ms(fn)
    if hasattr(sharded, "sharded_stencil_plan"):
        wh, uh = sharded._halos(ws, mesh), sharded._halos(us, mesh)
        out["plans"] = {
            "curl_3d_sharded": sharded._zmarch_plan(
                "curl", [(ws, *wh)])._asdict(),
            "rotational_curl_add_3d_sharded": sharded._zmarch_plan(
                "rotational", [(ws, *wh), (us, *uh)])._asdict()}
    out["exchange_device_ms"] = device_ms(exchange(ws, mesh))
    out["ghosted_exchange_device_ms"] = device_ms(ghosted_exchange(ws, mesh))
    del calls, w, u, ws, us
    torch.cuda.empty_cache()
    out["step_device_ms"], out["s_per_step"] = step_times(n, mesh_shape, dev)
    return out


def sweep(dev):
    """Device time of the kernels alone under every plan at 256^3, each
    plan's output held against the plain version (relative max |diff|)."""
    n = 256
    gen = torch.Generator(device=dev).manual_seed(0)
    for mesh_shape in ((2, 2), (8, 1)):
        mesh = create_mesh(3, mesh_shape, device=dev)
        ws = shard_vector_field(
            torch.randn((3, n, n, n), device=dev, generator=gen), mesh)
        us = shard_vector_field(
            torch.randn((3, n, n, n), device=dev, generator=gen), mesh)
        pz, py, _, nzl, nyl, nx = ws.shape
        out = torch.empty_like(ws)
        p = torch.tensor(0.05, device=dev)
        add = torch.tensor([1.0, -0.5, 0.25], device=dev)
        for kind, name in (("curl", "curl_3d_sharded"),
                           ("rotational", "rotational_curl_add_3d_sharded")):
            chosen = sharded.sharded_stencil_plan(kind, pz * py, nzl, nyl, nx,
                                                  4)
            ref = (sharded.curl_3d_sharded_ref(ws, p, mesh, add)
                   if kind == "curl" else
                   sharded.rotational_curl_add_3d_sharded_ref(ws, us, p, mesh))
            scale = float(ref.abs().max())
            rows = []
            lo, hi = sharded.ZMARCH_STAGE_RANGE
            for tile in sharded.ZMARCH_TILES:
                for stages in range(lo, hi + 1):
                    for chunks in (1, 2, 4, 8, 16):
                        plan = sharded.sharded_stencil_plan_of(
                            kind, pz * py, nzl, nyl, nx, 4, True, tile,
                            stages, -(-nzl // chunks))
                        fn = kernel_alone(ws, us, mesh, {name: plan},
                                          out)[name]
                        out.fill_(float("nan"))
                        fn()
                        err = float((out - ref).abs().max()) / scale
                        rows.append((device_ms(fn), plan, err))
            del ref
            rows.sort(key=lambda r: r[0])
            print(f"{name} 256^3 on {mesh_shape}: plan {tuple(chosen)}",
                  flush=True)
            for ms, plan, err in rows:
                mark = " <- plan" if plan == chosen else ""
                print(f"  {ms:.4f} ms tile {plan.tx}x{plan.ty} stages "
                      f"{plan.stages} zchunk {plan.zchunk} blocks "
                      f"{plan.blocks} ({plan.blocks_per_sm} an SM), "
                      f"relative max|diff| {err:.3g}{mark}", flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("probe_sharded: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if argv and argv[0] == "--json":
        print(card(), flush=True)
        print(json.dumps(timing(argv[1] if len(argv) > 1 else sharded.__file__,
                                dev)))
        return 0
    if argv and argv[0] == "--sweep":
        print(card(), flush=True)
        sweep(dev)
        return 0
    n = int(argv[0]) if argv else 256
    print(card(), flush=True)
    t0 = time.perf_counter()
    lib = single.library()
    print(f"built stencils_3d.cu in {time.perf_counter() - t0:.1f} s")
    for ln in lib.build_log.splitlines():
        if "Compiling entry" in ln or "registers" in ln or "warning" in ln:
            print("  " + ln.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    for mesh_shape in ((2, 2), (2, 3), (17, 1)):
        for dtype in (torch.float32, torch.float64):
            probe_stencils((3, 34, 66, 65), mesh_shape, dtype, dev, gen, False)
    for mesh_shape in ((2, 2), (4, 2), (8, 1)):
        probe_stencils((3, n, n, n), mesh_shape, torch.float32, dev, gen,
                       mesh_shape == (2, 2))
    probe_stencils((3, 64, 64, 64), (2, 2), torch.float64, dev, gen, False)
    # one-plane shards: both z neighbours from the halo buffers
    probe_stencils((3, 64, 64, 64), (64, 1), torch.float32, dev, gen, False)
    probe_solve(n, dev, gen)
    probe_step(n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
