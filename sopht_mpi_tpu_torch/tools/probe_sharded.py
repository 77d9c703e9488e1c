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
single calls (host enqueue included), each z-marching kernel alone on
halos made beforehand (profiler and batch), one field's exchange as the
wrappers make it, each single-device twin, the z-marching kernels' plans,
and the sharded flow step's device time (5 profiled steps) and s/step (10
steps), with the fused sponge and on the filtered arm (``FILTERED``). It
runs against the package it imports, so run this file with ``PYTHONPATH``
at each of two trees in turns (parent, change, change, parent) to compare
them on one card; a parent whose diffusion pair still reads a ghosted copy
is timed through its ghosted entry points (and the copy's time is
reported).

``--sweep [kind ...]`` times the z-marching kernels alone (device time;
default all four kinds, ``curl rotational diffusion sponge``) under every
tile, ring depth and z chunk count the launcher takes, at 256^3 on (2, 2)
and (8, 1), beside the plan's choice, each plan's output held against the
plain version.

The first form is a short first run for a changed kernel: it prints the
card, the build time, ptxas' lines of the stencil kernels, then

- each sharded stencil on a small odd grid, on one-plane shards and on an
  ``n``^3 grid (default 256) over a few meshes: max |diff| against its
  plain version and against the single-device kernel on the assembled
  field, and the median of 10
  timed calls (CUDA events) of the wrapper, the single-device twin and the
  plain version;
- the ``n``^3 vector Poisson solve on a (2, 2) mesh against the
  single-device solve: relative error, times, launches, transposes;
- ``cases.sharded_flow_case`` at ``n``^3 on (2, 2) against the same case on
  one device: 3 steps compared, then 10 timed steps of each.
"""

from __future__ import annotations

import functools
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


def stencil_calls(w, u, mesh, dtype, width=2):
    """name -> (sharded wrapper, its plain version, the single-device
    kernel), each a thunk; the fused sponge (at ``width``) only where its
    gate holds."""
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
    if sharded.diffusion_penalise_sharded_supported(w.shape, mesh, width):
        calls["diffusion_penalise_vector_3d_sharded"] = (
            lambda: sharded.diffusion_penalise_vector_3d_sharded(
                ws, p, width, mesh),
            lambda: sharded.diffusion_penalise_vector_3d_sharded_ref(
                ws, p, width, mesh),
            lambda: single.diffusion_penalise_vector_3d(w, p, width))
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


#: the z-marching kinds and the wrappers they serve
ZMARCH_KINDS = {"curl": "curl_3d_sharded",
                "rotational": "rotational_curl_add_3d_sharded",
                "diffusion": "diffusion_timestep_vector_3d_sharded",
                "sponge": "diffusion_penalise_vector_3d_sharded"}


def kernel_alone(ws, us, mesh, plans=None, out=None, width=2):
    """name -> a thunk that launches each z-marching kernel alone on halo
    buffers made beforehand, into ``out`` (a new tensor by default), with
    prefactor 0.05, the curl's add vector (1, -0.5, 0.25) and the sponge's
    ``width``, under ``plans`` (name -> plan, default the wrapper's; each
    thunk's ``plan``). A package whose diffusion pair has no z-marching
    kernel (the parent of its redesign) gets its ghosted entry points for
    those two (``plan`` None)."""
    dev = ws.device
    p = torch.tensor(0.05, device=dev)
    add = torch.tensor([1.0, -0.5, 0.25], device=dev)
    coords = sharded._coords(ws)
    geo = sharded._geometry(ws)
    out = torch.empty_like(ws) if out is None else out
    l1 = torch.zeros(mesh.axis_sizes, device=dev)
    ramp = single._sponge_ramp(width, ws.dtype, dev)
    wh, uh = sharded._halos(ws, mesh), sharded._halos(us, mesh)
    kinds = [k for k in ZMARCH_KINDS if k in sharded.ZMARCH_FIELDS]
    plans = plans or {
        ZMARCH_KINDS[k]: sharded._zmarch_plan(
            k, [(ws, *wh), (us, *uh)] if k == "rotational" else [(ws, *wh)])
        for k in kinds}
    ptrs = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    entries = {
        "curl_3d_sharded": lambda pl: _launch_raw(
            "sopht_curl_3d_sharded_zmarch", ws,
            *ptrs(ws, *wh, coords, p, add, out, l1), *geo, *pl.args()),
        "rotational_curl_add_3d_sharded": lambda pl: _launch_raw(
            "sopht_rotational_curl_add_3d_sharded_zmarch", ws,
            *ptrs(ws, *wh, us, *uh, coords, p, out), *geo, *pl.args()),
        "diffusion_timestep_vector_3d_sharded": lambda pl: _launch_raw(
            "sopht_diffusion_vector_3d_sharded_zmarch", ws,
            *ptrs(ws, *wh, coords, p, out), *geo, *pl.args()),
        "diffusion_penalise_vector_3d_sharded": lambda pl: _launch_raw(
            "sopht_diffusion_penalise_vector_3d_sharded_zmarch", ws,
            *ptrs(ws, *wh, coords, p, ramp, out), *geo, width, *pl.args()),
    }
    calls = {}
    for name, plan in plans.items():
        calls[name] = functools.partial(entries[name], plan)
        calls[name].plan = plan
    if "diffusion" not in kinds:
        # the parent's diffusion pair: a ghosted copy and its y rows
        wg, wy = sharded._ghost_z(ws, mesh), sharded._halo_y_rows(ws, mesh)
        ghosted = (wg.data_ptr(), wy[0].data_ptr(), wy[1].data_ptr(),
                   coords.data_ptr(), p.data_ptr(), out.data_ptr())
        calls["diffusion_timestep_vector_3d_sharded"] = lambda: _launch_raw(
            "sopht_diffusion_vector_3d_sharded", ws, *ghosted, *geo)
        calls["diffusion_penalise_vector_3d_sharded"] = lambda: _launch_raw(
            "sopht_diffusion_penalise_vector_3d_sharded", ws, *ghosted, *geo,
            width)
        for name in ("diffusion_timestep_vector_3d_sharded",
                     "diffusion_penalise_vector_3d_sharded"):
            calls[name].plan = None
    return calls


def exchange(ws, mesh):
    """One field's exchange as the wrappers make it: the four halo
    buffers."""
    return lambda: (sharded._halo_z_planes(ws, mesh),
                    sharded._halo_y_rows(ws, mesh))


#: the flow case's filtered arm: the order-1 multiplicative filter, which
#: runs the sharded diffusion once a step in place of the fused sponge
FILTERED = {"filter_vorticity": True,
            "filter_setting_dict": {"order": 1, "type": "multiplicative"}}


def step_times(n, mesh_shape, dev, sim_kwargs=None):
    """(device ms a step over 5 profiled steps, s/step over 10 steps) of
    the sharded flow case at n^3."""
    from torch.profiler import ProfilerActivity, profile

    step, (carry,) = cases.sharded_flow_case((n, n, n), mesh_shape,
                                             device=dev,
                                             sim_kwargs=sim_kwargs)
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
        if fn.plan is not None:
            out["plans"][name] = fn.plan._asdict()
    out["exchange_device_ms"] = device_ms(exchange(ws, mesh))
    if hasattr(sharded, "_ghost_z"):
        # the parent's ghosted copy (and y rows), which its diffusion pair
        # made
        out["ghosted_exchange_device_ms"] = device_ms(
            lambda: (sharded._ghost_z(ws, mesh),
                     sharded._halo_y_rows(ws, mesh)))
    del calls, w, u, ws, us
    torch.cuda.empty_cache()
    out["step_device_ms"], out["s_per_step"] = step_times(n, mesh_shape, dev)
    out["filtered_step_device_ms"], out["filtered_s_per_step"] = step_times(
        n, mesh_shape, dev, FILTERED)
    return out


def sweep(dev, kinds=tuple(ZMARCH_KINDS)):
    """Device time of the z-marching ``kinds`` alone under every plan at
    256^3, each plan's output held against the plain version (relative max
    |diff|); the sponge at width 2."""
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
        refs = {
            "curl": lambda: sharded.curl_3d_sharded_ref(ws, p, mesh, add),
            "rotational": lambda: sharded.rotational_curl_add_3d_sharded_ref(
                ws, us, p, mesh),
            "diffusion": lambda: (
                sharded.diffusion_timestep_vector_3d_sharded_ref(ws, p,
                                                                 mesh)),
            "sponge": lambda: (
                sharded.diffusion_penalise_vector_3d_sharded_ref(ws, p, 2,
                                                                 mesh))}
        for kind in kinds:
            name = ZMARCH_KINDS[kind]
            chosen = sharded.sharded_stencil_plan(kind, pz * py, nzl, nyl, nx,
                                                  4)
            ref = refs[kind]()
            scale = float(ref.abs().max())
            rows = []
            lo, hi = sharded.ZMARCH_STAGE_RANGE
            lo = max(lo, 2 + sharded.ZMARCH_KEEP[kind])
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
                        rows.append((device_ms(fn), batched_ms(fn), plan,
                                     err))
            del ref
            rows.sort(key=lambda r: r[0])
            print(f"{name} 256^3 on {mesh_shape}: plan {tuple(chosen)}",
                  flush=True)
            for ms, batch, plan, err in rows:
                mark = " <- plan" if plan == chosen else ""
                print(f"  {ms:.4f} ms (batch {batch:.4f}) tile "
                      f"{plan.tx}x{plan.ty} stages {plan.stages} zchunk "
                      f"{plan.zchunk} blocks {plan.blocks} "
                      f"({plan.blocks_per_sm} an SM), relative max|diff| "
                      f"{err:.3g}{mark}", flush=True)


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
        sweep(dev, tuple(argv[1:]) or tuple(ZMARCH_KINDS))
        return 0
    n = int(argv[0]) if argv else 256
    print(card(), flush=True)
    t0 = time.perf_counter()
    lib = single.library()
    print(f"built stencils_3d.cu in {time.perf_counter() - t0:.1f} s")
    for ln in lib.build_log.splitlines():
        if ("Compiling entry" in ln or "registers" in ln or "spill" in ln
                or "warning" in ln):
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
