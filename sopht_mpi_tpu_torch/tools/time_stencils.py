"""Time the six single-device 3D stencil kernels on one CUDA device:

    python3 sopht_mpi_tpu_torch/tools/time_stencils.py [n] [tag]

Prints the card (name and power limit) and one JSON line: for each kernel
the median of 20 calls (CUDA events, after 3 warm-up calls) on a float32
(3, n, n, n) field (default n = 256), three such medians in a row.

The script imports the package from ``sys.path`` and uses only the
wrappers' public names, so it compares two trees on one card within one
job: unpack the other tree into a directory and run this file once with
``PYTHONPATH`` set to each, in turns (a, b, b, a).
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as kernels


def median_ms(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
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


def main(argv):
    if not torch.cuda.is_available():
        print("time_stencils: no CUDA device", file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else 256
    tag = argv[1] if len(argv) > 1 else kernels.__file__
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((3, n, n, n), device=dev, generator=gen)
    u = torch.randn((3, n, n, n), device=dev, generator=gen)
    p = torch.tensor(0.05, device=dev)
    add = torch.tensor([1.0, -0.5, 0.25], device=dev)
    calls = {
        "rotational_curl_add_3d":
            lambda: kernels.rotational_curl_add_3d(w, u, p),
        "diffusion_penalise_vector_3d":
            lambda: kernels.diffusion_penalise_vector_3d(w, p, 2),
        "curl_3d": lambda: kernels.curl_3d(w, p, add, True),
        "diffusion_timestep_vector_3d":
            lambda: kernels.diffusion_timestep_vector_3d(w, p),
        "laplacian_filter_vector_3d":
            lambda: kernels.laplacian_filter_vector_3d(w, 1, "multiplicative"),
        "penalise_field_boundary_vector_3d":
            lambda: kernels.penalise_field_boundary_vector_3d(w, 2),
    }
    times = {name: [round(median_ms(fn), 4) for _ in range(3)]
             for name, fn in calls.items()}
    print(card)
    print(json.dumps({"tag": tag, "n": n, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
