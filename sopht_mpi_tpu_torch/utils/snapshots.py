"""Field snapshots for windowed step loops
(counterpart of ``sopht_mpi_tpu/utils/snapshots.py``).

The windowed loops read the device only at window ends, so a snapshot must
not hold the step loop on file writes: :class:`SnapshotWriter` copies each
field to the host once and hands the bytes to the native async writer
(``csrc/async_dump.cpp``), which does the file IO on its own thread.
"""

from __future__ import annotations

import os

import numpy as np

from sopht_mpi_tpu_torch.utils.native_io import AsyncFieldDumper


class SnapshotWriter:
    """Time-triggered .npy snapshots of named fields.

    >>> snaps = SnapshotWriter(interval=0.5, out_dir="snapshots")
    >>> while running:
    ...     carry, _ = scan_steps(step, carry, window)
    ...     snaps.maybe_save(float(carry.time), vorticity=carry.flow_state...)
    >>> snaps.close()

    Files: ``<out_dir>/<name>_<index:04d>.npy`` plus a ``times.csv``
    (index, time) manifest rewritten after every snapshot, so a run that
    stops early never leaves snapshots without their times.
    """

    def __init__(self, interval: float, out_dir: str = "snapshots"):
        if interval <= 0:
            raise ValueError("snapshot interval must be positive")
        self.interval = float(interval)
        self.out_dir = out_dir
        self._next_time = 0.0
        self._index = 0
        self._times: list[tuple[int, float]] = []
        self._dumper = AsyncFieldDumper()
        os.makedirs(out_dir, exist_ok=True)

    @property
    def is_native(self) -> bool:
        return self._dumper.is_native

    @property
    def n_saved(self) -> int:
        return self._index

    def maybe_save(self, time: float, **fields) -> bool:
        """Write one snapshot of every field (tensors or arrays) if
        ``time`` has reached the next save point (call at window ends; the
        window length is the granularity). Returns whether a snapshot was
        written."""
        if time < self._next_time:
            return False
        for name, field in fields.items():
            path = os.path.join(self.out_dir, f"{name}_{self._index:04d}.npy")
            # the dumper makes the one device-to-host copy and queues it
            self._dumper.dump(path, field)
        self._times.append((self._index, time))
        self._index += 1
        self._write_manifest()
        # schedule strictly after `time` (robust to interval << window dt)
        self._next_time = max(self._next_time + self.interval, time + 1e-12)
        return True

    def _write_manifest(self) -> None:
        if self._times:
            np.savetxt(
                os.path.join(self.out_dir, "times.csv"),
                np.asarray(self._times),
                delimiter=",",
                header="index,time",
                comments="",
            )

    def flush(self) -> None:
        """Barrier: block until all queued writes hit the filesystem."""
        self._write_manifest()
        self._dumper.flush()

    def failed(self) -> int:
        return self._dumper.failed()

    def close(self) -> None:
        self._write_manifest()
        self._dumper.close()
