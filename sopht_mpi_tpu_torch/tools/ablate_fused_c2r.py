"""Time the fused inverse edge pass's cluster kernel
(``ifft_irfft_cluster_kernel`` in ``csrc/fft_passes.cu``) with one of its
phases cut out at a time, on one CUDA device:

    python3 -m sopht_mpi_tpu_torch.tools.ablate_fused_c2r [name ...]

Each variant is a copy of the package under ``build/ablate/<name>`` whose
kernel has one edit (the names below; default: all of them), built in
parallel by ``nvcc``. Then each runs, in its own process, the wrapper
``ifft_irfft_pass_fused`` under ``fused_c2r_cluster_plan``'s plan at the
256^3 solve's (768, 512, 256) pairs and the rod grid's (768, 128, 256), and
prints its device time (``torch.profiler``, the probe's ``device_ms``); the
unedited kernel runs first and last. A cut variant's output is wrong: only
its time is read. What a phase costs is the kernel's time less the time
without it, where the rest does not take its place.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent / "build" / "ablate"

# name -> edits (old, new) inside the kernel's text, each found once
_LOCAL = [("S::pad(kx), owner)", "S::pad(kx), rank)")]
VARIANTS = {
    "kernel": [],
    "no_tile_copies": [("    if (a >= A) return;\n    const int width",
                        "    if (a >= 0) return;\n    const int width")],
    "no_y_phase": [  # neither factor, so no pushes either
        ("for (int k2 = ty; k2 < m2;", "for (int k2 = m2; k2 < m2;"),
        ("      inverse_second_of(", "      if (0) inverse_second_of("),
        ("        if (n2 >= h2) break;", "        break;")],
    "local_pushes": _LOCAL,
    # pushes stay in the block (no block may exit while a peer writes to
    # it), so the cluster barriers can go
    "local_no_cluster_barriers": _LOCAL + [
        ("  cluster_arrive();\n\n  const float inv_mx", "\n  const float inv_mx"),
        ("      if (!peers_free) cluster_wait();\n", ""),
        ("    if (!peers_free) cluster_wait();\n", ""),
        ("    cluster_arrive();\n    cluster_wait();  // the slab's rows",
         "    __syncthreads();  // the slab's rows"),
        ("    if (cid + (long long)(it + 1) * ncl < A) cluster_arrive();\n",
         "")],
    "no_c2r_phase": [("for (int r0 = 0; r0 < rows; r0 += groups)",
                      "for (int r0 = rows; r0 < rows; r0 += groups)")],
    "no_row_stores": [("      if (q == 0) {\n        bulk_store",
                       "      if (q == 0 && y < 0) {\n        bulk_store")],
}
SLABS = (("256^3", (768, 256, 256)), ("rod", (768, 64, 256)))

TIME = """
import torch
from sopht_mpi_tpu_torch.parallel import cuda_fft
from sopht_mpi_tpu_torch.tools.probe_edge_passes import device_ms
gen = torch.Generator(device="cuda").manual_seed(0)
out = []
for shape, (a, ny, nx) in {slabs}:
    my, mx = 2 * ny, 2 * nx
    args = [torch.randn(s, device="cuda", generator=gen) for s in
            ((a, my, nx), (a, my, nx), (a, ny, 1), (a, ny, 1))]
    ms = device_ms(lambda: cuda_fft.ifft_irfft_pass_fused(*args, mx, nx))
    out.append(f"{{shape}} {{ms:.4f}} ms")
print("; ".join(out))
"""


def variant_tree(name: str) -> Path:
    """A copy of the package with the variant's edits in the kernel."""
    root = ROOT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / PACKAGE.name / "csrc" / "fft_passes.cu"
    src = cu.read_text()
    start = src.index("    ifft_irfft_cluster_kernel(const float*")
    end = src.index("\n}\n", start)
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
    build = "from sopht_mpi_tpu_torch.parallel import cuda_fft; " \
            "cuda_fft.library()"
    procs = [run(tree, build) for tree in trees.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("a variant failed to build")
    order = names + (["kernel"] if "kernel" in names else [])
    code = TIME.format(slabs=SLABS)
    for name in order:
        proc = run(trees[name], code, stdout=subprocess.PIPE, text=True)
        line = proc.communicate()[0].strip()
        print(f"ablate fused_c2r {name}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
