"""Whether the library calls of the 3D mesh path give each shard's block
the same bits when they work the whole in-process batch of shards, (pz,
py, ...), as when they work that shard alone, (1, 1, ...), the layout a
process of a distributed mesh holds.

    python3 -m sopht_mpi_tpu_torch.tools.probe_shard_batch [--grid 256] \\
        [--mesh 2 1] [--window 72] [--markers 4586] [--device cuda:0] \\
        [--json PATH]

The calls, at the shapes the mesh path gives them for a (grid)^3 domain:

- the Green's spectrum (``ops/poisson.py``, ``_init_greens_of``, through
  ``parallel/fft.py``'s ``_rfft3_local``), float64 on the doubled grid: the
  x rfft, the y fft (axis 3) and the z fft (axis 2);
- the step's convolve (``_convolve3_local_batched``), float32 on the
  vector field: the x rfft of the doubled rows and the x irfft back (the y
  and z passes there are the package's own kernels on the card);
- the sparse window's E->L (``parallel/windows.py``,
  ``windowed_e2l_mm_sharded``), float32 with TF32 off as the simulator
  runs it: the (z, y) contraction of each shard's block, batched over the
  shards, and the x contraction with the replicated x weights. The
  defaults are the 256^3 sphere's window and markers.

Each input is drawn from a seeded generator on the device. For each call
the tool prints one JSON line: the call, its first input's shape, the
largest difference between a shard's block of the batched result and the
same shard worked alone, and the batched result's largest magnitude. The
last line is the card's name and power limit where there is a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from sopht_mpi_tpu_torch.parallel.fft import padded_rfft_size
from sopht_mpi_tpu_torch.parallel.mesh import create_mesh


def calls(n: int, pz: int, py: int, window: int, markers: int, mesh):
    """(name, [(shape, dtype, sharded)], fn) of each call for a (n, n, n)
    grid: ``sharded`` inputs carry the leading (pz, py) shard axes, the
    others are replicated."""
    d = 2 * n  # the Green's kernel lives on the doubled grid
    fxp_g = padded_rfft_size(d, mesh)
    fxp = padded_rfft_size(2 * n, mesh)
    lz, ly, lx = min(window, n // pz), min(window, n // py), min(window, n)
    f64, c128, f32, c64 = (torch.float64, torch.complex128, torch.float32,
                           torch.complex64)
    return [
        ("greens x rfft", [((pz, py, d // pz, d // py, d), f64, True)],
         lambda x: torch.fft.rfft(x, dim=-1)),
        ("greens y fft", [((pz, py, d // pz, d, fxp_g // py), c128, True)],
         lambda x: torch.fft.fft(x, dim=3)),
        ("greens z fft", [((pz, py, d, d // pz, fxp_g // py), c128, True)],
         lambda x: torch.fft.fft(x, dim=2)),
        ("convolve x rfft", [((pz, py, 3 * n // pz, n // py, n), f32, True)],
         lambda x: torch.fft.rfft(x, n=2 * n, dim=-1)),
        # the irfft reads the first n + 1 of the padded frequencies
        ("convolve x irfft",
         [((pz, py, 3 * n // pz, n // py, fxp), c64, True)],
         lambda x: torch.fft.irfft(x[..., :n + 1], n=2 * n, dim=-1)),
        ("window e2l zy einsum",
         [((pz, py, markers, lz * ly), f32, True),
          ((pz, py, lz * ly, lx, 3), f32, True)],
         lambda a, b: torch.einsum("pqns,pqsxc->pqcnx", a, b)),
        ("window e2l x einsum",
         [((pz, py, 3, markers, lx), f32, True),
          ((markers, lx), f32, False)],
         lambda u, a: torch.einsum("pqcnx,nx->pqcn", u, a)),
    ]


def probe(n: int, mesh_shape, window: int, markers: int,
          device) -> list[dict]:
    pz, py = mesh_shape
    mesh = create_mesh(3, mesh_shape, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for name, specs, fn in calls(n, pz, py, window, markers, mesh):
        xs = [(torch.randn(shape, dtype=dtype, device=device, generator=gen),
               sharded) for shape, dtype, sharded in specs]
        full = fn(*(x for x, _ in xs))
        err = 0.0
        for i in range(pz):
            for j in range(py):
                alone = fn(*(x[i:i + 1, j:j + 1].contiguous() if sharded
                             else x for x, sharded in xs))
                err = max(err, float((alone[0, 0] - full[i, j]).abs().max()))
        rows.append({"call": name, "shape": list(specs[0][0]),
                     "dtype": str(specs[0][1]).removeprefix("torch."),
                     "max_abs_diff": err,
                     "max_abs": float(full.abs().max())})
        del xs, full
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=256)
    parser.add_argument("--mesh", type=int, nargs=2, default=(2, 1))
    parser.add_argument("--window", type=int, default=72)
    parser.add_argument("--markers", type=int, default=4586)
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--json")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    # the simulator's matmul setting (ops/ibm.py)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = probe(args.grid, tuple(args.mesh), args.window, args.markers,
                 device)
    for row in rows:
        print(json.dumps(row))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
