"""Build ``csrc/stencils_3d.cu`` and hold the sharded stencils, the
distributed convolve and the sharded flow step against their single-device
counterparts on one CUDA device, with times:

    python3 -m sopht_mpi_tpu_torch.tools.probe_sharded [n]

A short first run for a changed kernel: it prints the card, the build time,
ptxas' lines of the stencil kernels, then

- each sharded stencil on a small odd grid and on an ``n``^3 grid (default
  256) over a few meshes: max |diff| against its plain version and against
  the single-device kernel on the assembled field, and the median of 10
  timed calls (CUDA events) of the wrapper, the single-device twin and the
  plain version;
- the ``n``^3 vector Poisson solve on a (2, 2) mesh against the
  single-device solve: relative error, times, launches, transposes;
- ``cases.sharded_flow_case`` at ``n``^3 on (2, 2) against the same case on
  one device: 3 steps compared, then 10 timed steps of each.
"""

from __future__ import annotations

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


def main(argv):
    if not torch.cuda.is_available():
        print("probe_sharded: no CUDA device", file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else 256
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
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
    probe_solve(n, dev, gen)
    probe_step(n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
