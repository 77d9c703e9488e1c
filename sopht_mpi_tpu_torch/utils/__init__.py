"""Utilities: precision, logging, IO, checkpoints, snapshots, profiling and
plotting (counterpart of ``sopht_mpi_tpu/utils/``, the same 18 names).

Importing this package loads neither ``h5py`` nor ``matplotlib``: ``FieldIO``
imports h5py when it is built, ``Plotter2D`` matplotlib, and ``lab_cmap`` is
made at its first read.
"""

from sopht_mpi_tpu_torch.utils.types import get_dtype_eps, get_real_t, get_test_tol
from sopht_mpi_tpu_torch.utils.logging_utils import FlowLogger, logger
from sopht_mpi_tpu_torch.utils.plotting import Plotter2D, compile_video
from sopht_mpi_tpu_torch.utils.io import (
    CosseratRodIO,
    FieldBinding,
    FieldIO,
    load_rod_state,
    save_rod_state,
)
from sopht_mpi_tpu_torch.utils.native_io import AsyncFieldDumper
from sopht_mpi_tpu_torch.utils.snapshots import SnapshotWriter
from sopht_mpi_tpu_torch.utils.profiling import block_timer, measure_op_time
from sopht_mpi_tpu_torch.utils.checkpoint import CarryCheckpointer

__all__ = [
    "get_dtype_eps", "get_real_t", "get_test_tol", "FlowLogger", "logger",
    "Plotter2D", "compile_video", "lab_cmap", "CosseratRodIO",
    "FieldBinding", "FieldIO", "load_rod_state", "save_rod_state",
    "AsyncFieldDumper", "SnapshotWriter", "block_timer", "measure_op_time",
    "CarryCheckpointer",
]


def __getattr__(name):
    if name == "lab_cmap":
        from sopht_mpi_tpu_torch.utils import plotting

        return plotting.lab_cmap
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
