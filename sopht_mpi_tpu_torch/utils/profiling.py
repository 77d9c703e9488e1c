"""Profiling and timing helpers
(counterpart of ``sopht_mpi_tpu/utils/profiling.py``).

CUDA launches return before the device has run them, so a host clock
around a call measures the enqueue. Everything here waits for the device:
``block_timer`` synchronises on the CUDA tensors a block yields,
``measure_op_time`` times a chain of calls with CUDA events on a card (the
host clock on the CPU), and ``trace_to`` records a ``torch.profiler``
trace.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _first_tensor(tree):
    """The first tensor leaf of a tensor, tuple, list or dict tree."""
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for value in values:
        found = _first_tensor(value)
        if found is not None:
            return found
    return None


def _synchronize(results) -> None:
    """Wait for every CUDA device that holds one of ``results``' tensors."""
    devices = set()
    for value in results.values():
        leaf = _first_tensor(value)
        if leaf is not None and leaf.is_cuda:
            devices.add(leaf.device)
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def block_timer(label: str = "", results: dict | None = None, echo=print):
    """Context manager timing a block; before it reads the clock it waits
    for the devices that hold the tensors the block stores in ``results``
    (mapping name -> tensor or tree of tensors), where it stores
    ``elapsed_s`` too."""
    t0 = time.perf_counter()
    yield
    if results:
        _synchronize(results)
    elapsed = time.perf_counter() - t0
    if echo is not None:
        echo(f"{label or 'block'}: {elapsed * 1e3:.2f} ms")
    if results is not None:
        results["elapsed_s"] = elapsed


def measure_op_time(fn, example_arg, *, iters: int = 10, repeats: int = 2):
    """Seconds a call of ``fn`` (a shape-preserving function of one tensor
    or tree of tensors) takes, over a chain of ``iters`` calls that feeds
    each output back in as the next input; CUDA events on a card, the host
    clock on the CPU. One warm-up chain runs first.

    :returns: the best of ``repeats`` chains, seconds per call.
    """
    leaf = _first_tensor(example_arg)
    if leaf is None:
        raise TypeError("measure_op_time needs a tensor argument")
    cuda = leaf.is_cuda

    def chain(x):
        for _ in range(iters):
            x = fn(x)
        return x

    out = chain(example_arg)
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(leaf.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = chain(out)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = chain(out)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best


def trace_to(log_dir: str):
    """Context manager recording a ``torch.profiler`` trace of the block
    (CPU, and CUDA where a card is present) and writing it as a Chrome trace
    (``*.pt.trace.json``) into ``log_dir``."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
