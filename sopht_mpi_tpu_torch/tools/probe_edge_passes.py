"""Build ``csrc/fft_passes.cu`` and hold the x-edge passes (split, unsplit
and fused) against their plain versions on one CUDA device, with times:

    python3 -m sopht_mpi_tpu_torch.tools.probe_edge_passes [nz ny nx ...]

A short first run for a changed kernel: it prints the card, the build time,
ptxas' register and spill lines of the fused kernels, then for each grid
(default: an odd-factor grid, the (256, 512) cylinder grid as one slab a
component, a 17 x 32 factor grid and 256^3) each pass's relative error
against ``*_ref`` and the median of 10 timed calls of both (CUDA events).
"""

from __future__ import annotations

import re
import subprocess
import sys
import time

import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

DEFAULT_GRIDS = ((48, 32, 64), (1, 256, 512), (16, 272, 80), (256, 256, 256))


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


def pass_args(grid, rand, components=3):
    nz, ny, nx = grid
    rows, a, my, mx = components * nz * ny, components * nz, 2 * ny, 2 * nx
    return {
        "rfft_pass_padded": (rand(rows, nx), mx),
        "irfft_pass_truncated": (rand(rows, nx + 1), rand(rows, nx + 1), mx, nx),
        "rfft_fft_pass_fused": (rand(a, ny, nx), mx, my),
        "ifft_irfft_pass_fused": (rand(a, my, nx), rand(a, my, nx),
                                  rand(a, ny, 1), rand(a, ny, 1), mx, nx),
        "rfft_pass_padded_split": (rand(rows, nx), mx),
        "irfft_pass_merge": (rand(rows, nx), rand(rows, nx), rand(rows, 1),
                             rand(rows, 1), mx, nx),
    }


def main(argv):
    if not torch.cuda.is_available():
        print("probe_edge_passes: no CUDA device", file=sys.stderr)
        return 2
    grids = DEFAULT_GRIDS
    if argv:
        if len(argv) % 3:
            print("usage: probe_edge_passes [nz ny nx ...]", file=sys.stderr)
            return 2
        vals = [int(v) for v in argv]
        grids = tuple(tuple(vals[i:i + 3]) for i in range(0, len(vals), 3))
    print(torch.__version__, torch.version.cuda)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    lib = cuda_fft.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    lines = lib.build_log.splitlines()
    for i, ln in enumerate(lines[:-2]):
        name = re.search(r"(\w+_fused_kernel)ILi(\d+)ELi(\d+)", ln)
        if "Function properties" in ln and name:
            print(name.group(1)[-28:], name.group(2), name.group(3), "|",
                  lines[i + 1].strip(), "|", lines[i + 2].strip()[:60])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    for grid in grids:
        if not all(cuda_fft.kernel_fft_supported(2 * n) for n in grid[1:]):
            print(f"{grid}: unsupported lengths")
            continue
        for name, args in pass_args(grid, rand).items():
            fn, ref_fn = getattr(cuda_fft, name), getattr(cuda_fft, name + "_ref")
            out, ref = fn(*args), ref_fn(*args)
            torch.cuda.synchronize()
            out = out if isinstance(out, tuple) else (out,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max(float((o - q).abs().max()) for o, q in zip(out, ref))
            scale = max(float(q.abs().max()) for q in ref)
            print(f"{grid} {name}: relative err {err / scale:.3g}, "
                  f"{median_ms(lambda: fn(*args)):.4f} ms, plain "
                  f"{median_ms(lambda: ref_fn(*args), 3):.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
