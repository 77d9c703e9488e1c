"""Checkpoints of a step loop's carry
(counterpart of ``sopht_mpi_tpu/utils/checkpoint.py``).

The HDF5 ``FieldIO`` path (``utils/io.py``) keeps the reference's on-disk
layout for visualization; this module checkpoints the carry of a fused
loop (any ``models.fsi`` carry NamedTuple, or any tree of NamedTuples,
tuples, lists and dicts of tensors) for an exact restart. The JAX package
writes orbax checkpoints; here a checkpoint is one ``torch.save`` file of
the carry's tensors keyed by their path in the tree
(``"flow_state.primary_field"``, ``"greens.0"``), ``<dir>/<step>.pt``. These
files are not orbax files.

``save`` copies every tensor to the host before it returns: the next eager
step may write into the carry's tensors, the port's form of the JAX
package's donation hazard. The file is then written on a background thread
to ``<dir>/<step>.tmp`` and renamed into place with ``os.replace``, so a
checkpoint file is whole or absent.

On a distributed mesh (``CarryCheckpointer(dir, mesh=mesh)``) every process
writes its own file, ``<dir>/<step>.rank<r>.pt``, holding its blocks of the
sharded fields and its copy of the replicated leaves, with the mesh shape
and its coordinates; a restore reads the process's own file and refuses
one written at another place of another mesh. The ranks rename their files
each on its own, so a job cut between two renames leaves ranks whose newest
files differ: the latest step of a distributed checkpointer is the newest
that every process has finished (an all-reduce over the world), and a
restart resumes all ranks from the same step. (The JAX package writes one
collective orbax checkpoint.)
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from sopht_mpi_tpu_torch.parallel.mesh import is_distributed

_MESH_KEY = "__mesh__"


def _flatten(tree, prefix="", out=None) -> dict:
    """``{path: tensor}`` of every tensor leaf of ``tree``; None leaves
    hold nothing."""
    if out is None:
        out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, value in zip(tree._fields, tree):
            _flatten(value, f"{prefix}.{name}" if prefix else name, out)
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}.{i}" if prefix else str(i), out)
    elif isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}.{key}" if prefix else str(key), out)
    elif tree is not None:
        raise TypeError(f"checkpoint leaf {prefix!r}: a tensor or None, got "
                        f"{type(tree).__name__}")
    return out


def _rebuild(template, saved, prefix=""):
    """``template`` with each tensor leaf replaced by its saved value on the
    template leaf's device; zero-size leaves stay the template's."""
    if isinstance(template, torch.Tensor):
        if template.numel() == 0:
            return template
        if prefix not in saved:
            raise KeyError(f"checkpoint has no leaf {prefix!r}")
        value = saved[prefix]
        if value.shape != template.shape or value.dtype != template.dtype:
            raise ValueError(
                f"checkpoint leaf {prefix!r} is {tuple(value.shape)} "
                f"{value.dtype}, the template's {tuple(template.shape)} "
                f"{template.dtype}")
        return value.to(template.device)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _rebuild(v, saved, f"{prefix}.{n}" if prefix else n)
            for n, v in zip(template._fields, template)))
    if isinstance(template, (tuple, list)):
        return type(template)(
            _rebuild(v, saved, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(template))
    if isinstance(template, dict):
        return {k: _rebuild(v, saved, f"{prefix}.{k}" if prefix else str(k))
                for k, v in template.items()}
    return template


class CarryCheckpointer:
    """Save and restore step-loop carries (or any tree of tensors).

    >>> ckpt = CarryCheckpointer("ckpts")
    >>> ckpt.save(step_index, carry)            # host copy, then async write
    >>> carry = ckpt.restore(template=carry0)   # devices from the template

    :param mesh: the carry's mesh; a distributed one gives each process a
        file of its own.
    """

    def __init__(self, directory: str, mesh=None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending = []
        self._mesh = mesh if is_distributed(mesh) else None
        suffix = "" if self._mesh is None else rf"\.rank{self._mesh.rank}"
        self._pattern = re.compile(rf"^(\d+){suffix}\.pt$")

    @property
    def directory(self) -> str:
        return self._dir

    def _mesh_tag(self):
        mesh = self._mesh
        return torch.tensor([*mesh.axis_sizes, *mesh.coords])

    def _path(self, step: int, ext: str = "pt") -> str:
        rank = "" if self._mesh is None else f".rank{self._mesh.rank}"
        return os.path.join(self._dir, f"{int(step)}{rank}.{ext}")

    def save(self, step: int, carry, wait: bool = False) -> None:
        """Checkpoint ``step``: every tensor of ``carry`` is copied to the
        host before this returns; the file is written on a background
        thread unless ``wait``."""
        host = {path: t.detach().to("cpu", copy=True)
                for path, t in _flatten(carry).items()}
        if self._mesh is not None:
            host[_MESH_KEY] = self._mesh_tag()
        final = self._path(step)
        tmp = self._path(step, "tmp")

        def write():
            torch.save(host, tmp)
            os.replace(tmp, final)

        self._pending.append(self._writer.submit(write))
        if wait:
            self.wait_until_finished()

    def latest_step(self) -> int | None:
        """The largest step with a finished checkpoint file (``.tmp`` files
        of writes still under way are not counted). On a distributed mesh
        every process calls it together, and it is the smallest of the
        processes' latest steps (None if any process has none)."""
        steps = [int(m.group(1)) for m in map(self._pattern.match,
                                              os.listdir(self._dir)) if m]
        latest = max(steps, default=None)
        if self._mesh is None:
            return latest
        from sopht_mpi_tpu_torch.parallel import transport

        # the maximum of -step is minus the minimum; -1 stands for none
        mine = torch.tensor([-(-1 if latest is None else latest)],
                            dtype=torch.int64, device=self._mesh.device)
        common = -int(transport.all_reduce_max(mine, self._mesh.group)[0])
        return None if common < 0 else common

    def restore(self, template, step: int | None = None):
        """The checkpoint ``step`` (default: :meth:`latest_step`, on a
        distributed mesh the newest every process has) in the structure of
        ``template`` (typically the freshly initialised carry), each tensor
        on its template leaf's device. Refuses a missing leaf, a leaf of
        another shape or dtype, and a leaf the template lacks."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        saved = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if self._mesh is not None:
            tag = saved.pop(_MESH_KEY, None)
            if tag is None or not torch.equal(tag, self._mesh_tag()):
                raise ValueError(
                    f"checkpoint {self._path(step)} was written on mesh "
                    f"(shape, place) {None if tag is None else tag.tolist()}"
                    f", this process is {self._mesh_tag().tolist()}")
        extra = set(saved) - set(_flatten(template))
        if extra:
            raise KeyError(f"checkpoint leaves {sorted(extra)} are not in the "
                           "template")
        return _rebuild(template, saved)

    def wait_until_finished(self) -> None:
        """Block until every queued write is on disk; raises the first
        write's error."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self) -> None:
        self.wait_until_finished()
        self._writer.shutdown()
