"""Async field dumps through the native C++ writer
(counterpart of ``sopht_mpi_tpu/utils/native_io.py``).

Snapshot and checkpoint output must not hold the step loop on host
filesystem latency. :class:`AsyncFieldDumper` copies a field to the host
once (one device-to-host copy for a CUDA tensor), hands the bytes to the
native writer's queue and returns; a C++ worker thread
(``sopht_mpi_tpu_torch/csrc/async_dump.cpp``) writes the file. Files are
standard ``.npy`` (the header is built here), so numpy and ParaView tooling
read them directly.

The library is compiled with ``g++`` at first use into
``<checkout>/build/sopht_mpi_tpu_torch/`` under a content-hashed name
(``_build.load_library``). A failed build raises with the compiler's
output; there is no synchronous fallback.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/async_dump.cpp``."""
    from sopht_mpi_tpu_torch._build import load_library

    lib = load_library("asyncdump", ("async_dump.cpp",), host=True)
    lib.adw_create.argtypes = []
    lib.adw_create.restype = ctypes.c_void_p
    lib.adw_submit.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_uint64,
    ]
    lib.adw_submit.restype = ctypes.c_int
    lib.adw_pending.argtypes = [ctypes.c_void_p]
    lib.adw_pending.restype = ctypes.c_uint64
    lib.adw_failed.argtypes = [ctypes.c_void_p]
    lib.adw_failed.restype = ctypes.c_uint64
    lib.adw_flush.argtypes = [ctypes.c_void_p]
    lib.adw_flush.restype = None
    lib.adw_destroy.argtypes = [ctypes.c_void_p]
    lib.adw_destroy.restype = None
    return lib


def to_host(field) -> np.ndarray:
    """A C-contiguous numpy array of ``field`` (a tensor on any device, or
    anything numpy takes); one device-to-host copy for a CUDA tensor."""
    if isinstance(field, torch.Tensor):
        field = field.detach().cpu().numpy()
    return np.ascontiguousarray(field)


def _npy_header(array: np.ndarray) -> bytes:
    """Minimal .npy v1.0 header for a C-contiguous array."""
    descr = np.lib.format.dtype_to_descr(array.dtype)
    shape = array.shape
    d = f"{{'descr': {descr!r}, 'fortran_order': False, 'shape': {shape!r}, }}"
    prefix = b"\x93NUMPY\x01\x00"
    unpadded = len(prefix) + 2 + len(d) + 1
    pad = (64 - unpadded % 64) % 64
    header = d + " " * pad + "\n"
    return prefix + struct.pack("<H", len(header)) + header.encode("latin1")


class AsyncFieldDumper:
    """Queue-based async .npy writer (native worker thread).

    >>> dumper = AsyncFieldDumper()
    >>> dumper.dump("snap_0001.npy", vorticity_field)   # returns after the copy
    >>> ...
    >>> dumper.flush()                                   # barrier
    """

    def __init__(self):
        self._lib = library()
        self._handle = self._lib.adw_create()

    @property
    def is_native(self) -> bool:
        """True while the native writer is open (always, until
        :meth:`close`: there is no fallback writer)."""
        return self._handle is not None

    def dump(self, path: str, field) -> None:
        """Queue ``field`` (a tensor or an array) for writing to ``path``;
        returns once the writer holds its own copy of the bytes."""
        handle = self._open()
        arr = to_host(field)
        header = _npy_header(arr)
        self._lib.adw_submit(
            handle,
            path.encode(),
            header,
            len(header),
            arr.ctypes.data_as(ctypes.c_void_p),
            arr.nbytes,
        )

    def _open(self):
        if self._handle is None:
            raise ValueError("the dumper is closed")
        return self._handle

    def pending(self) -> int:
        return int(self._lib.adw_pending(self._open()))

    def failed(self) -> int:
        return int(self._lib.adw_failed(self._open()))

    def flush(self) -> None:
        """Block until every queued write has reached the filesystem."""
        self._lib.adw_flush(self._open())

    def close(self) -> None:
        if self._handle is not None:
            self._lib.adw_flush(self._handle)
            self._lib.adw_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
