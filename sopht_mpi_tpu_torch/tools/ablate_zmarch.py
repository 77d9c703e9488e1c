"""Time the z-marching kernels (the sharded ``curl_zmarch_kernel``,
``rotational_zmarch_kernel``, ``diffusion_zmarch_kernel`` with and without
the sponge, and the single-device filter pass
``mult_filter_zmarch_kernel``, in ``csrc/stencils_3d.cu``) with one part of
their walk cut out at a time, on one CUDA device:

    python3 -m sopht_mpi_tpu_torch.tools.ablate_zmarch [name ...]

Each variant is a copy of the package under ``build/ablate_zmarch/<name>``
whose walk has one edit (the names below; default: all of them), built in
parallel by ``nvcc``. Then each runs, in its own process, the four kernels
alone under their plans at 256^3 on a (2, 2) mesh on halo buffers made
beforehand, and the filter (order 1) at the rod's (3, 256, 64, 256) and at
256^3, and prints their device time (``torch.profiler``) and their time a
launch in a batch of 20 (CUDA events); the unedited kernels run first and
last. A cut variant's output is wrong: only its time is read.
What a part costs is the kernel's time less the time without it, where
the rest does not take its place.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent / "build" / "ablate_zmarch"

# name -> edits (old, new) inside the walk and the kernels' text, each
# found once
VARIANTS = {
    "kernel": [],
    # no plane arrives: the arithmetic and stores run on whatever the ring
    # holds
    "no_copies": [
        ("    if (k < L) copies.issue(ring + k * stage_size, a, b, w.za - 1 + k, g);",
         ""),
        ("      copies.issue(ring + back * stage_size, a, b, w.za - 1 + kn, g);",
         "")],
    # no barrier a plane (the walk races; the copies and the arithmetic
    # stay)
    "no_barrier": [("    cp_async_wait_ring(ahead - 1);\n    __syncthreads();",
                    "    cp_async_wait_ring(ahead - 1);")],
    # no output stores, and so no arithmetic that only they need
    "no_stores": [
        ("          if (w.valid) {\n            T* d = dst + z * plane;\n"
         "            d[0] = c0;",
         "          if (w.valid && z < 0) {\n            T* d = dst + z * plane;\n"
         "            d[0] = c0;"),
        ("          if (w.valid) {\n            T* d = dst + z * plane;\n"
         "            d[0] = o0;",
         "          if (w.valid && z < 0) {\n            T* d = dst + z * plane;\n"
         "            d[0] = o0;")],
    # the transport forms q at its own cells only, not at the tile's halo
    "no_halo_q": [("        if (k >= 1 && k <= L - 2) {  // a plane that is",
                   "        if (k < 0) {  // a plane that is")],
    # the sponge stores the diffusion it forms at its cell's clamp source
    # as the diffusion does: no ramps, no wall band planes from the source
    # plane
    "no_sponge_store": [("        if (SPONGE == 1) {\n",
                         "        if (false) {\n")],
    # the filter: no barrier between its H_x tile and the H_y reads (the
    # step races), no H_x tile (H_y reads whatever the tile holds), no
    # output stores
    "filter_no_hx_barrier": [
        ("          __syncthreads();\n          if (inner) {",
         "          if (inner) {")],
    "filter_no_hx": [("          for (int h = threadIdx.x; h < HT; h += Z::NT) {",
                      "          for (int h = HT; h < HT; h += Z::NT) {")],
    "filter_no_stores": [("        if (k >= 2 && w.valid) {",
                          "        if (k >= 2 && w.valid && z < 0) {")],
}
# no output stores of the diffusion pair either
VARIANTS["no_stores"].append(
    ("        if (!w.valid) return;\n        if (SPONGE == 1) {",
     "        if (!w.valid || z >= 0) return;\n        if (SPONGE == 1) {"))

TIME = """
import torch
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
from sopht_mpi_tpu_torch.parallel.mesh import create_mesh, shard_vector_field
from sopht_mpi_tpu_torch.tools.probe_sharded import (
    batched_ms, device_ms, kernel_alone)
gen = torch.Generator(device="cuda").manual_seed(0)
mesh = create_mesh(3, (2, 2), device="cuda")
ws, us = (shard_vector_field(torch.randn((3, 256, 256, 256), device="cuda",
                                         generator=gen), mesh)
          for _ in range(2))
out = []
for name, fn in kernel_alone(ws, us, mesh).items():
    out.append(f"{{name}} {{device_ms(fn):.4f}} / {{batched_ms(fn):.4f}} ms")
del ws, us
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as single
for shape in ((3, 256, 64, 256), (3, 256, 256, 256)):
    w = torch.randn(shape, device="cuda", generator=gen)
    fn = lambda: single.laplacian_filter_vector_3d(w, 1, "multiplicative")
    out.append(f"filter {{shape}} {{device_ms(fn):.4f}} / "
               f"{{batched_ms(fn):.4f}} ms")
print("; ".join(out))
"""


def variant_tree(name: str) -> Path:
    """A copy of the package with the variant's edits in the walk."""
    root = ROOT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / PACKAGE.name / "csrc" / "stencils_3d.cu"
    src = cu.read_text()
    start = src.index("// The walk the z-marching kernels share.")
    end = src.index("// A z-marching launch's plan")
    body = src[start:end]
    for old, new in VARIANTS[name]:
        if body.count(old) != 1:
            raise SystemExit(f"{name}: edit not found once: {old!r}")
        body = body.replace(old, new)
    cu.write_text(src[:start] + body + src[end:])
    return root


def run(root: Path, code: str, **kw):
    # from the tree's root: ``python -c`` puts the working directory first
    # on the import path
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=root,
                            **kw)


def main(argv):
    names = argv or list(VARIANTS)
    trees = {name: variant_tree(name) for name in names}
    build = "from sopht_mpi_tpu_torch.ops import cuda_stencils_3d; " \
            "cuda_stencils_3d.library()"
    procs = [run(tree, build) for tree in trees.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("a variant failed to build")
    order = names + (["kernel"] if "kernel" in names else [])
    for name in order:
        proc = run(trees[name], TIME.format(), stdout=subprocess.PIPE,
                   text=True)
        line = proc.communicate()[0].strip()
        print(f"ablate zmarch {name}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
