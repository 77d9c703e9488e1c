"""Field IO: HDF5 files and XDMF sidecars for ParaView
(counterpart of ``sopht_mpi_tpu/utils/io.py``).

The on-disk layout is the JAX package's, so a file written by either
package loads in the other: ``Eulerian/Scalar|Vector/<name>``, the
``Eulerian/Parameters`` attributes, one group a Lagrangian grid with an
optional polyline ``Connection``, the ``time`` attribute, the declared
on-disk dtype and the text of the ``*_eulerian.xmf`` / ``*_<grid>.xmf``
sidecars.

Fields are registered as *bindings*:

- ``FieldBinding(obj, "attr")``  - full save/load binding (recommended),
- a zero-arg callable           - save-only binding,
- a raw tensor or array         - snapshot (saved as-is; load fills
  ``io.loaded_fields[name]``).

A save copies each field to the host once (``detach().cpu()``); a load
puts each array back on the bound tensor's device and dtype. ``load``
validates origin, dx and grid size against the defined grid (restart
consistency, mpi_io.py:483-494) and returns the saved time.

A binding to a field of a mesh (an object with a ``mesh``, as a 2D or 3D
simulator built with one) reads and writes the sharded layout of
:mod:`sopht_mpi_tpu_torch.parallel.mesh`: ``save`` writes the assembled
field, ``load`` shards it again, and
:meth:`FieldIO.save_eulerian_sharded` / :meth:`FieldIO.load_eulerian_sharded`
write and read one block a shard in the JAX package's per-shard layout.
On a distributed mesh every process calls ``save`` (the fields are
gathered) and rank 0 writes the file; ``save_eulerian_sharded`` writes one
file a process, as the JAX package does.

``h5py`` is imported at first use, so the package imports without it
(``HAS_H5PY`` says whether it is there).
"""

from __future__ import annotations

import glob
import importlib.util

import numpy as np
import torch

from sopht_mpi_tpu_torch.parallel.mesh import (
    is_distributed,
    shard_scalar_field,
    shard_vector_field,
    unshard_scalar_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils.native_io import to_host

HAS_H5PY = importlib.util.find_spec("h5py") is not None


def _h5py():
    if not HAS_H5PY:
        raise RuntimeError("h5py unavailable; FieldIO disabled")
    import h5py

    return h5py


def _host_scalar(value):
    """A 0-d tensor as a Python number; anything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.item()
    return value


def _numpy_dtype(dtype) -> np.dtype:
    """A torch or numpy dtype as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class FieldBinding:
    """Binds a field to ``getattr(obj, attr)`` for save and load.

    Where ``obj`` has a ``mesh`` (a mesh simulator, or any object given
    one), a bound field may be sharded over it: ``get`` then assembles it
    and ``set`` shards the global value."""

    def __init__(self, obj, attr: str):
        self.obj = obj
        self.attr = attr

    @property
    def mesh(self):
        return getattr(self.obj, "mesh", None)

    def get_raw(self):
        """The bound value as it is (sharded on a mesh), no host copy."""
        return getattr(self.obj, self.attr)

    def sharded_kind(self):
        """``"Scalar"`` or ``"Vector"`` for a field sharded over the
        binding's mesh, else None."""
        current = self.get_raw()
        mesh = self.mesh
        if (mesh is None or mesh.size == 1
                or not isinstance(current, torch.Tensor)):
            return None
        extra = current.ndim - mesh.grid_dim - len(mesh.axis_names)
        return {0: "Scalar", 1: "Vector"}.get(extra)

    def get(self) -> np.ndarray:
        current = self.get_raw()
        kind = self.sharded_kind()
        if kind is not None:
            current = (unshard_scalar_field if kind == "Scalar"
                       else unshard_vector_field)(current, self.mesh)
        return to_host(current)

    def set(self, value):
        """Set the attribute to ``value``, on the current tensor's device
        and in its dtype, sharded where the current field is (a numpy
        attribute stays numpy, in its dtype)."""
        current = self.get_raw()
        if isinstance(current, torch.Tensor):
            kind = self.sharded_kind()
            value = torch.tensor(np.asarray(value), dtype=current.dtype,
                                 device=current.device)
            if kind is not None:
                value = (shard_scalar_field if kind == "Scalar"
                         else shard_vector_field)(value, self.mesh)
        else:
            value = np.asarray(value, dtype=np.asarray(current).dtype)
        setattr(self.obj, self.attr, value)


class _Snapshot:
    def __init__(self, array):
        self.array = to_host(array)

    def get(self):
        return self.array

    def set(self, value):
        self.array = np.asarray(value)


class _Getter:
    def __init__(self, fn):
        self.fn = fn

    def get(self):
        return to_host(self.fn())

    def set(self, value):
        pass  # save-only binding


def _as_binding(value):
    if isinstance(value, FieldBinding):
        return value
    if callable(value):
        return _Getter(value)
    return _Snapshot(value)


class FieldIO:
    """HDF5 + XDMF IO for Eulerian and Lagrangian fields.

    :param dim: grid dimension (2 or 3).
    :param real_dtype: on-disk float dtype (torch or numpy).
    """

    def __init__(self, dim: int, real_dtype=np.float64):
        _h5py()
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.dim = dim
        self.real_dtype = _numpy_dtype(real_dtype)
        self.precision = 8 if self.real_dtype == np.float64 else 4
        self.eulerian_grid_defined = False
        self.eulerian_fields: dict[str, object] = {}
        self.eulerian_fields_type: dict[str, str] = {}
        self.lagrangian_grids: dict[str, object] = {}
        self.lagrangian_grid_connection: dict[str, np.ndarray] = {}
        self.lagrangian_fields: dict[str, object] = {}
        self.lagrangian_fields_type: dict[str, str] = {}
        self.lagrangian_fields_with_grid_name: dict[str, list] = {}
        self.lagrangian_grid_count = 0
        self.loaded_fields: dict[str, np.ndarray] = {}

    # -- registration ---------------------------------------------------------

    def define_eulerian_grid(self, origin, dx, grid_size, ghost_size=0):
        """Define the global Eulerian grid (z-y-x ordered arrays). The
        ``ghost_size`` argument is accepted for API parity and must be 0 -
        fields here are ghost-free."""
        if ghost_size != 0:
            raise ValueError("fields are ghost-free: ghost_size must be 0")
        self.eulerian_origin = np.asarray(origin, dtype=np.float64)
        self.eulerian_dx = np.asarray(dx, dtype=np.float64)
        self.eulerian_grid_size = np.asarray(grid_size, dtype=np.int64)
        self.eulerian_grid_defined = True

    def add_as_eulerian_fields_for_io(self, **fields_for_io):
        for name, value in fields_for_io.items():
            binding = _as_binding(value)
            field = binding.get()
            if field.ndim == self.dim:
                ftype = "Scalar"
            elif field.ndim == self.dim + 1 and field.shape[0] == self.dim:
                ftype = "Vector"
            else:
                raise ValueError(
                    f"Unable to identify eulerian field type for shape "
                    f"{field.shape}"
                )
            self.eulerian_fields[name] = binding
            self.eulerian_fields_type[name] = ftype

    def add_as_lagrangian_fields_for_io(
        self,
        lagrangian_grid,
        lagrangian_grid_name=None,
        lagrangian_grid_connect=False,
        lagrangian_grid_master_rank=0,  # accepted for API parity; unused
        **fields_for_io,
    ):
        """Register a Lagrangian grid (positions binding, (dim, N)) and
        fields living on it."""
        grid_binding = _as_binding(lagrangian_grid)
        grid = grid_binding.get()
        if grid.ndim != 2 or grid.shape[0] != self.dim:
            raise ValueError(
                f"a Lagrangian grid is ({self.dim}, N), got {grid.shape}")
        if lagrangian_grid_name is None:
            lagrangian_grid_name = f"Lagrangian_grid_{self.lagrangian_grid_count}"
            self.lagrangian_grid_count += 1
        num_nodes = grid.shape[1]
        self.lagrangian_grids[lagrangian_grid_name] = grid_binding
        if lagrangian_grid_connect:
            self.lagrangian_grid_connection[lagrangian_grid_name] = np.arange(
                num_nodes, dtype=np.int64
            )
        self.lagrangian_fields_with_grid_name[lagrangian_grid_name] = []
        for name, value in fields_for_io.items():
            binding = _as_binding(value)
            field = binding.get()
            if field.shape == (num_nodes,):
                ftype = "Scalar"
            elif field.shape == grid.shape:
                ftype = "Vector"
            else:
                raise ValueError(
                    f"Unable to identify lagrangian field type for shape "
                    f"{field.shape}"
                )
            self.lagrangian_fields[name] = binding
            self.lagrangian_fields_type[name] = ftype
            self.lagrangian_fields_with_grid_name[lagrangian_grid_name].append(
                name
            )

    # -- save -------------------------------------------------------------------

    def _mesh(self):
        """The distributed mesh of a bound Eulerian field, or None."""
        for binding in self.eulerian_fields.values():
            mesh = getattr(binding, "mesh", None)
            if is_distributed(mesh):
                return mesh
        return None

    def save(self, h5_file_name: str, time=0.0):
        """Write every registered field (one host copy each) and the XDMF
        sidecars. On a distributed mesh every process gathers the fields,
        rank 0 writes, and no process returns before the file is whole."""
        mesh = self._mesh()
        if mesh is None:
            self._save(h5_file_name, time)
            return
        if mesh.rank == 0:
            self._save(h5_file_name, time)
        else:
            for binding in self.eulerian_fields.values():
                binding.get()  # join the gathers
        _barrier(mesh)

    def _save(self, h5_file_name: str, time):
        h5py = _h5py()
        time = _host_scalar(time)
        with h5py.File(h5_file_name, "w") as f:
            f.attrs["time"] = time
            if self.eulerian_grid_defined and self.eulerian_fields:
                grp = f.create_group("Eulerian")
                sgrp = grp.create_group("Scalar")
                vgrp = grp.create_group("Vector")
                for name, binding in self.eulerian_fields.items():
                    field = np.asarray(binding.get(), dtype=self.real_dtype)
                    if self.eulerian_fields_type[name] == "Scalar":
                        # 2D fields stored as a z=1 slab (ParaView
                        # 2DCORECTMesh workaround, mpi_io.py:303-310)
                        sgrp.create_dataset(
                            name, data=field.reshape(self._disk_shape())
                        )
                    else:
                        for c in range(self.dim):
                            vgrp.create_dataset(
                                f"{name}_{c}",
                                data=field[c].reshape(self._disk_shape()),
                            )
                pgrp = grp.create_group("Parameters")
                pgrp.attrs["origin"] = self.eulerian_origin
                pgrp.attrs["dx"] = self.eulerian_dx
                pgrp.attrs["grid_size"] = self.eulerian_grid_size
            for grid_name, grid_binding in self.lagrangian_grids.items():
                ggrp = f.create_group(grid_name)
                ggrp.create_dataset(
                    "position",
                    data=np.asarray(grid_binding.get(), dtype=self.real_dtype),
                )
                if grid_name in self.lagrangian_grid_connection:
                    ggrp.create_dataset(
                        "Connection",
                        data=self.lagrangian_grid_connection[grid_name],
                    )
                sgrp = ggrp.create_group("Scalar")
                vgrp = ggrp.create_group("Vector")
                for name in self.lagrangian_fields_with_grid_name[grid_name]:
                    field = np.asarray(
                        self.lagrangian_fields[name].get(),
                        dtype=self.real_dtype,
                    )
                    target = (
                        sgrp
                        if self.lagrangian_fields_type[name] == "Scalar"
                        else vgrp
                    )
                    target.create_dataset(name, data=field)
        if self.eulerian_fields:
            self.generate_xdmf_eulerian(h5_file_name, time=time)
        if self.lagrangian_grids:
            self.generate_xdmf_lagrangian(h5_file_name, time=time)

    def _disk_shape(self):
        gs = tuple(int(s) for s in self.eulerian_grid_size)
        return (1, *gs) if self.dim == 2 else gs

    # -- per-shard Eulerian dumps -----------------------------------------
    #
    # The JAX package's layout: every process writes one file,
    # ``<name>.proc<rank>.h5``, holding the shards it addresses, one block
    # at a time (a host copy of one block, never the global field), each
    # with its global offsets; process 0's ``Parameters`` group holds the
    # grid. On an in-process mesh the port is one process and writes
    # ``.proc0.h5`` with every shard; on a distributed mesh process r
    # writes ``.proc<r>.h5`` with its own. Shard (i, j) is
    # ``shard_d<i p1 + j>`` (p1 the size of the mesh's second axis: py of a
    # 3D mesh ("z", "y"), px of a 2D mesh ("y", "x")), the name of the
    # device at that place of a JAX mesh.

    def save_eulerian_sharded(self, h5_file_name: str, time=0.0):
        """Per-shard Eulerian dump to ``<h5_file_name>.proc<r>.h5``, r this
        process's rank (0 without a distributed mesh): one dataset a shard
        with its global ``start``, and the field's ``ftype`` and
        ``global_shape`` on its group. A field that is not sharded is one
        block at the origin. Only Eulerian fields are written (Lagrangian
        state is marker-sized; :meth:`save` has it)."""
        h5py = _h5py()
        mesh = self._mesh()
        rank, n_processes = (0, 1) if mesh is None else (mesh.rank,
                                                         mesh.size)
        with h5py.File(f"{h5_file_name}.proc{rank}.h5", "w") as f:
            f.attrs["time"] = _host_scalar(time)
            f.attrs["process"] = rank
            f.attrs["n_processes"] = n_processes
            if rank == 0:
                pgrp = f.create_group("Parameters")
                pgrp.attrs["origin"] = self.eulerian_origin
                pgrp.attrs["dx"] = self.eulerian_dx
                pgrp.attrs["grid_size"] = self.eulerian_grid_size
            for name, binding in self.eulerian_fields.items():
                grp = f.create_group(name)
                grp.attrs["ftype"] = self.eulerian_fields_type[name]
                for key, start, block in _blocks(binding):
                    d = grp.create_dataset(
                        key, data=np.asarray(block, dtype=self.real_dtype))
                    d.attrs["start"] = np.asarray(start, np.int64)
                grp.attrs["global_shape"] = np.asarray(
                    _global_shape(binding), np.int64)
        if mesh is not None:
            _barrier(mesh)  # every process's file is whole on return

    def load_eulerian_sharded(self, h5_file_name: str):
        """Restore from per-shard files (the port's or the JAX package's,
        every ``<h5_file_name>.proc*.h5``, read by every process). A field
        sharded over the same mesh takes each stored block straight into
        its shard (a process's own shard on a distributed mesh); a block
        missing at a shard's offsets (files written under another layout)
        raises. A field that is not sharded is assembled from the blocks.
        Validates the grid parameters; returns the saved time."""
        h5py = _h5py()
        files = sorted(glob.glob(f"{h5_file_name}.proc*.h5"))
        if not files:
            raise FileNotFoundError(f"{h5_file_name}.proc*.h5")
        blocks: dict[str, dict[tuple, np.ndarray]] = {}
        time = None
        for path in files:
            with h5py.File(path, "r") as f:
                if "Parameters" in f:
                    time = f.attrs["time"]
                    params = f["Parameters"].attrs
                    np.testing.assert_allclose(self.eulerian_origin,
                                               params["origin"])
                    np.testing.assert_allclose(self.eulerian_dx,
                                               params["dx"])
                    np.testing.assert_allclose(self.eulerian_grid_size,
                                               params["grid_size"])
                for name in self.eulerian_fields:
                    if name not in f:
                        continue
                    for d in f[name].values():
                        blocks.setdefault(name, {})[
                            tuple(int(v) for v in d.attrs["start"])
                        ] = np.asarray(d)
        if time is None:
            raise ValueError("no Parameters group in any shard file")
        for name, binding in self.eulerian_fields.items():
            stored = blocks[name]
            current = _raw(binding)
            if _kind(binding) is None:
                out = np.zeros(np.shape(current), self.real_dtype)
                for start, blk in stored.items():
                    out[tuple(slice(s, s + n)
                              for s, n in zip(start, blk.shape))] = blk
                binding.set(out)
                self.loaded_fields[name] = out
                continue
            parts = np.empty(tuple(current.shape), dtype=self.real_dtype)
            for key, start, shard in _blocks(binding, read=False):
                if start not in stored:
                    raise ValueError(
                        f"sharded restart of '{name}': no stored block at "
                        f"offsets {start} - the files were written under a "
                        "different mesh/layout (reload via the gathered "
                        "FieldIO.save/load path instead)")
                if stored[start].shape != parts[shard].shape:
                    raise ValueError(
                        f"sharded restart of '{name}': the block at {start} "
                        f"is {stored[start].shape}, the shard "
                        f"{parts[shard].shape} - the files were written "
                        "under a different mesh/layout")
                parts[shard] = stored[start]
            value = torch.tensor(parts, dtype=current.dtype,
                                 device=current.device)
            setattr(binding.obj, binding.attr, value)
            self.loaded_fields[name] = value
        return time

    # -- load ---------------------------------------------------------------

    def load(self, h5_file_name: str):
        """Load registered fields back through their bindings; returns the
        saved time. Validates grid parameters (restart consistency,
        mpi_io.py:483-494)."""
        h5py = _h5py()
        with h5py.File(h5_file_name, "r") as f:
            time = f.attrs["time"]
            if self.eulerian_fields:
                assert self.eulerian_grid_defined, "Eulerian grid undefined"
                np.testing.assert_allclose(
                    self.eulerian_origin,
                    f["Eulerian/Parameters"].attrs["origin"],
                )
                np.testing.assert_allclose(
                    self.eulerian_dx, f["Eulerian/Parameters"].attrs["dx"]
                )
                np.testing.assert_allclose(
                    self.eulerian_grid_size,
                    f["Eulerian/Parameters"].attrs["grid_size"],
                )
                gs = tuple(int(s) for s in self.eulerian_grid_size)
                for name, binding in self.eulerian_fields.items():
                    if self.eulerian_fields_type[name] == "Scalar":
                        data = np.asarray(f[f"Eulerian/Scalar/{name}"]).reshape(
                            gs
                        )
                    else:
                        data = np.stack(
                            [
                                np.asarray(
                                    f[f"Eulerian/Vector/{name}_{c}"]
                                ).reshape(gs)
                                for c in range(self.dim)
                            ]
                        )
                    binding.set(data)
                    self.loaded_fields[name] = data
            for grid_name, grid_binding in self.lagrangian_grids.items():
                data = np.asarray(f[f"{grid_name}/position"])
                grid_binding.set(data)
                self.loaded_fields[f"{grid_name}/position"] = data
                for name in self.lagrangian_fields_with_grid_name[grid_name]:
                    sub = (
                        "Scalar"
                        if self.lagrangian_fields_type[name] == "Scalar"
                        else "Vector"
                    )
                    data = np.asarray(f[f"{grid_name}/{sub}/{name}"])
                    self.lagrangian_fields[name].set(data)
                    self.loaded_fields[name] = data
        return time

    # -- XDMF -----------------------------------------------------------------

    def generate_xdmf_eulerian(self, h5_file_name: str, time=0.0):
        """XDMF sidecar (3DCORECTMesh + ORIGIN_DXDYDZ; 2D embedded as a
        z=1 slab, mpi_io.py:556-650)."""
        gs = self.eulerian_grid_size
        origin = self.eulerian_origin
        dx = self.eulerian_dx
        if self.dim == 2:
            gs = np.insert(gs, 0, 1)
            origin = np.insert(origin, 0, 0.0)
            dx = np.insert(dx, 0, 0.0)
        gs_s = "    ".join(str(int(v)) for v in gs)
        origin_s = "    ".join(f"{v:.{self.precision}g}" for v in origin)
        dx_s = "    ".join(f"{v:.{self.precision}g}" for v in dx)

        entries = []
        for name, ftype in self.eulerian_fields_type.items():
            names = (
                [name]
                if ftype == "Scalar"
                else [f"{name}_{c}" for c in range(self.dim)]
            )
            for nm in names:
                entries.append(
                    f'<Attribute Name="{nm}" Active="1" '
                    f'AttributeType="Scalar" Center="Node">\n'
                    f'  <DataItem Dimensions="{gs_s}" NumberType="Float" '
                    f'Precision="{self.precision}" Format="HDF">\n'
                    f"    {h5_file_name}:/Eulerian/{ftype}/{nm}\n"
                    f"  </DataItem>\n</Attribute>"
                )
        body = "\n".join(entries)
        xmf = f"""<?xml version="1.0" ?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf xmlns:xi="http://www.w3.org/2003/XInclude" Version="2.2">
  <Domain>
    <Grid GridType="Uniform">
      <Time Value="{time}"/>
      <Topology TopologyType="3DCORECTMesh" Dimensions="{gs_s}"/>
      <Geometry GeometryType="ORIGIN_DXDYDZ">
        <DataItem Name="Origin" Dimensions="3" NumberType="Float" Format="XML">
          {origin_s if self.dim == 3 else origin_s}
        </DataItem>
        <DataItem Name="Spacing" Dimensions="3" NumberType="Float" Format="XML">
          {dx_s}
        </DataItem>
      </Geometry>
{body}
    </Grid>
  </Domain>
</Xdmf>
"""
        with open(h5_file_name.replace(".h5", "_eulerian.xmf"), "w") as f:
            f.write(xmf)

    def generate_xdmf_lagrangian(self, h5_file_name: str, time=0.0):
        """Per-grid XDMF sidecars (Polyvertex, or Polyline when a
        Connection was registered; mpi_io.py:652-749)."""
        for grid_name, grid_binding in self.lagrangian_grids.items():
            grid = grid_binding.get()
            n = grid.shape[1]
            connected = grid_name in self.lagrangian_grid_connection
            topo = (
                f'<Topology TopologyType="Polyline" NodesPerElement="{n}">'
                f'\n  <DataItem Dimensions="1 {n}" NumberType="Int" '
                f'Format="HDF">\n    {h5_file_name}:/{grid_name}/Connection'
                f"\n  </DataItem>\n</Topology>"
                if connected
                else f'<Topology TopologyType="Polyvertex" '
                f'NumberOfElements="{n}"/>'
            )
            geom_type = "XY" if self.dim == 2 else "XYZ"
            entries = []
            for name in self.lagrangian_fields_with_grid_name[grid_name]:
                ftype = self.lagrangian_fields_type[name]
                dims = f"{n}" if ftype == "Scalar" else f"{self.dim} {n}"
                entries.append(
                    f'<Attribute Name="{name}" Active="1" '
                    f'AttributeType="{ftype}" Center="Node">\n'
                    f'  <DataItem Dimensions="{dims}" NumberType="Float" '
                    f'Precision="{self.precision}" Format="HDF">\n'
                    f"    {h5_file_name}:/{grid_name}/{ftype}/{name}\n"
                    f"  </DataItem>\n</Attribute>"
                )
            body = "\n".join(entries)
            xmf = f"""<?xml version="1.0" ?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf xmlns:xi="http://www.w3.org/2003/XInclude" Version="2.2">
  <Domain>
    <Grid GridType="Uniform">
      <Time Value="{time}"/>
      {topo}
      <Geometry GeometryType="{geom_type}">
        <DataItem Dimensions="{grid.shape[1]} {self.dim}" NumberType="Float"
        Precision="{self.precision}" Format="HDF">
          {h5_file_name}:/{grid_name}/position
        </DataItem>
      </Geometry>
{body}
    </Grid>
  </Domain>
</Xdmf>
"""
            with open(
                h5_file_name.replace(".h5", f"_{grid_name}.xmf"), "w"
            ) as f:
                f.write(xmf)


def _barrier(mesh):
    import torch.distributed as dist

    dist.barrier(group=mesh.group)


def _raw(binding):
    """The bound value as it is: sharded for a mesh's field; the host
    array of a snapshot or save-only binding."""
    return getattr(binding, "get_raw", binding.get)()


def _kind(binding):
    """``"Scalar"`` / ``"Vector"`` for a field sharded over its binding's
    mesh, else None."""
    return getattr(binding, "sharded_kind", lambda: None)()


def _global_shape(binding) -> tuple:
    current = _raw(binding)
    kind = _kind(binding)
    if kind is None:
        return tuple(np.shape(current))
    p0, p1 = binding.mesh.axis_sizes
    local = list(current.shape[2:])
    lead = 1 if kind == "Vector" else 0
    local[lead] *= p0
    local[lead + 1] *= p1
    return tuple(local)


def _blocks(binding, read=True):
    """``(dataset name, global start, block)`` for each shard of a bound
    field in this process (one host copy of one block at a time); with
    ``read=False`` the shard's index into the sharded tensor in place of
    the block. A field that is not sharded is one block at the origin."""
    current = _raw(binding)
    kind = _kind(binding)
    if kind is None:
        yield "shard_d0", (0,) * np.ndim(current), (
            binding.get() if read else ...)
        return
    mesh = binding.mesh
    p1 = mesh.axis_sizes[1]
    lead = 1 if kind == "Vector" else 0
    n0, n1 = current.shape[2 + lead:4 + lead]
    for i in range(current.shape[0]):
        for j in range(current.shape[1]):
            gi, gj = mesh.first_shard(0) + i, mesh.first_shard(1) + j
            start = [0] * (current.ndim - 2)
            start[lead], start[lead + 1] = gi * n0, gj * n1
            yield (f"shard_d{gi * p1 + gj}", tuple(start),
                   to_host(current[i, j]) if read else (i, j))


class CosseratRodIO(FieldIO):
    """Rod-specific IO (counterpart of ``CosseratRodMPIIO``,
    mpi_io.py:752-792): element-center positions as the Lagrangian grid
    with a polyline connection and the radius as a scalar field."""

    def __init__(self, cosserat_rod, real_dtype=np.float64, dim: int = 3):
        super().__init__(dim=dim, real_dtype=real_dtype)
        self.cosserat_rod = cosserat_rod

        def element_positions():
            pos = to_host(cosserat_rod.position_collection)
            return 0.5 * (pos[:dim, 1:] + pos[:dim, :-1])

        self.add_as_lagrangian_fields_for_io(
            lagrangian_grid=element_positions,
            lagrangian_grid_name="rod",
            lagrangian_grid_connect=True,
            radius=lambda: to_host(cosserat_rod.radius),
        )


def save_rod_state(cosserat_rod, h5_file_name: str, time=0.0):
    """Full rod dynamic-state checkpoint (counterpart of PyElastica's
    ``ea.save_state`` used for restarts,
    flow_past_freely_rotating_rod_case.py:199-246)."""
    h5py = _h5py()
    with h5py.File(h5_file_name, "w") as f:
        f.attrs["time"] = _host_scalar(time)
        for name, arr in cosserat_rod.get_state_arrays().items():
            f.create_dataset(name, data=arr)


def load_rod_state(cosserat_rod, h5_file_name: str):
    """Restore a rod state checkpoint onto the rod's device and dtype;
    returns the saved time."""
    h5py = _h5py()
    with h5py.File(h5_file_name, "r") as f:
        arrays = {name: np.asarray(f[name]) for name in f.keys()}
        time = f.attrs["time"]
    cosserat_rod.set_state_arrays(arrays)
    return time
