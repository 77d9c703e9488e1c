"""Build the package's native sources into shared libraries at first use.

Each CUDA library is compiled by ``nvcc`` for Hopper (``sm_90a``), the
host-side async dump writer by ``g++``, into
``<checkout>/build/sopht_mpi_tpu_torch/`` under a name keyed on a hash of
its sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. The libraries export a plain C interface and are loaded
with :mod:`ctypes`; nothing here imports PyTorch's C++ headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sopht_mpi_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on the ``PATH``."""
    candidates = [
        os.path.join(home, "bin", "nvcc")
        for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda")
        if home
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and on PATH): the CUDA kernels cannot be built"
        )
    return found


def build_library(name: str, sources: tuple[str, ...],
                  includes: tuple[str, ...] = (), *,
                  host: bool = False) -> tuple[Path, str]:
    """Compile ``sources`` (file names under ``csrc/``, or absolute paths)
    into ``lib<name>-<hash>.so`` unless it exists, with ``nvcc``, or with
    ``g++`` when ``host``; the hash also covers the ``includes`` the
    sources include. Returns (path, compiler log, empty when the library
    was already built). A failed build raises with the compiler's
    output."""
    flags = GXX_FLAGS if host else NVCC_FLAGS
    paths = [CSRC_DIR / s for s in sources]
    digest = hashlib.sha256()
    for flag in flags:
        digest.update(flag.encode())
    for p in paths + [CSRC_DIR / s for s in includes]:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    compiler = "g++" if host else find_nvcc()
    cmd = [compiler, *flags, "-o", tmp, *map(str, paths)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load_library(name: str, sources: tuple[str, ...],
                 includes: tuple[str, ...] = (), *,
                 host: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load a library; the compiler log is kept as
    ``lib.build_log`` and the file as ``lib.path``."""
    path, log = build_library(name, sources, includes, host=host)
    lib = ctypes.CDLL(str(path))
    lib.build_log = log
    lib.path = path
    return lib
