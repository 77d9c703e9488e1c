"""Field IO and checkpoints of a mesh's sharded fields: the per-shard h5
dumps (``FieldIO.save_eulerian_sharded`` / ``load_eulerian_sharded``) read
across with the JAX package's on the same (4, 2) mesh, both ways;
``FieldIO`` on a mesh simulator's fields; a sharded carry's checkpoint
resumed bit-exact. Float64 and float32; the files hold the values
exactly, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu.utils import io as jax_io
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.models import UnboundedFlowSimulator3D, scan_steps
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_scalar_field,
    shard_vector_field,
    unshard_scalar_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.utils import CarryCheckpointer
from sopht_mpi_tpu_torch.utils.io import FieldBinding, FieldIO

pytest.importorskip("h5py")

GRID = (8, 8, 16)
MESH = (4, 2)


class Holder:
    pass


def _grid_io(io_cls, real_dtype):
    io = io_cls(dim=3, real_dtype=real_dtype)
    io.define_eulerian_grid(origin=np.zeros(3), dx=np.full(3, 0.1),
                            grid_size=np.array(GRID))
    return io


def _arrays(seed, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(GRID).astype(dtype),
            rng.standard_normal((3, *GRID)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_dumps_read_across_both_ways(tmp_path, dtype):
    scalar, vector = _arrays(7, dtype)
    mesh = create_mesh(3, MESH, device="cpu")
    jmesh = jax_mesh.create_mesh(3, MESH)

    # port -> JAX
    port = Holder()
    port.mesh = mesh
    port.scalar = shard_scalar_field(torch.tensor(scalar), mesh)
    port.vector = shard_vector_field(torch.tensor(vector), mesh)
    pio = _grid_io(FieldIO, dtype)
    pio.add_as_eulerian_fields_for_io(
        scalar=FieldBinding(port, "scalar"),
        vector=FieldBinding(port, "vector"))
    base = str(tmp_path / "port")
    pio.save_eulerian_sharded(base, time=2.5)
    jx = Holder()
    jx.scalar = jax_mesh.shard_scalar_field(jnp.zeros(GRID, dtype), jmesh)
    jx.vector = jax_mesh.shard_vector_field(jnp.zeros((3, *GRID), dtype),
                                            jmesh)
    jio = _grid_io(jax_io.FieldIO, dtype)
    jio.add_as_eulerian_fields_for_io(
        scalar=jax_io.FieldBinding(jx, "scalar"),
        vector=jax_io.FieldBinding(jx, "vector"))
    assert jio.load_eulerian_sharded(base) == pytest.approx(2.5)
    np.testing.assert_array_equal(np.asarray(jx.scalar), scalar)
    np.testing.assert_array_equal(np.asarray(jx.vector), vector)

    # JAX -> port
    scalar2, vector2 = _arrays(8, dtype)
    jx.scalar = jax_mesh.shard_scalar_field(jnp.asarray(scalar2), jmesh)
    jx.vector = jax_mesh.shard_vector_field(jnp.asarray(vector2), jmesh)
    base = str(tmp_path / "jax")
    jio.save_eulerian_sharded(base, time=3.5)
    port.scalar = torch.zeros_like(port.scalar)
    port.vector = torch.zeros_like(port.vector)
    assert pio.load_eulerian_sharded(base) == pytest.approx(3.5)
    assert port.vector.shape == (*MESH, 3, 2, 4, 16)
    np.testing.assert_array_equal(
        unshard_scalar_field(port.scalar, mesh).numpy(), scalar2)
    np.testing.assert_array_equal(
        unshard_vector_field(port.vector, mesh).numpy(), vector2)

    # a restart onto another layout raises, as the JAX package's does
    other = create_mesh(3, (8, 1), device="cpu")
    port.mesh = other
    port.scalar = shard_scalar_field(
        torch.zeros(GRID, dtype=port.scalar.dtype), other)
    port.vector = shard_vector_field(
        torch.zeros((3, *GRID), dtype=port.vector.dtype), other)
    oio = _grid_io(FieldIO, dtype)
    oio.add_as_eulerian_fields_for_io(
        scalar=FieldBinding(port, "scalar"),
        vector=FieldBinding(port, "vector"))
    with pytest.raises(ValueError, match="different mesh/layout"):
        oio.load_eulerian_sharded(base)


def test_field_io_on_a_mesh_simulator(tmp_path):
    """``FieldIO`` bound to a mesh simulator's fields writes the assembled
    fields (the JAX package reads them) and loads them back sharded; the
    per-shard dump of the same bindings restores the shards."""
    mesh = create_mesh(3, (2, 2), device="cpu")
    sim = UnboundedFlowSimulator3D(
        GRID, 1.0, 1e-3, flow_type="navier_stokes", device="cpu",
        real_t=torch.float64, mesh=mesh)
    _, vector = _arrays(9, np.float64)
    sim.vorticity_field = shard_vector_field(torch.tensor(vector), mesh)
    io = _grid_io(FieldIO, np.float64)
    io.add_as_eulerian_fields_for_io(
        vorticity=FieldBinding(sim, "vorticity_field"))
    assert io.eulerian_fields_type["vorticity"] == "Vector"
    f = str(tmp_path / "flow.h5")
    io.save(f, time=1.0)
    holder = Holder()
    holder.vorticity = jnp.zeros((3, *GRID))
    jio = _grid_io(jax_io.FieldIO, np.float64)
    jio.add_as_eulerian_fields_for_io(
        vorticity=jax_io.FieldBinding(holder, "vorticity"))
    assert jio.load(f) == 1.0
    np.testing.assert_array_equal(np.asarray(holder.vorticity), vector)
    kept = sim.vorticity_field.clone()
    sim.vorticity_field = torch.zeros_like(kept)
    assert io.load(f) == 1.0
    assert torch.equal(sim.vorticity_field, kept)
    base = str(tmp_path / "flow_sharded")
    io.save_eulerian_sharded(base, time=2.0)
    sim.vorticity_field = torch.zeros_like(kept)
    assert io.load_eulerian_sharded(base) == 2.0
    assert torch.equal(sim.vorticity_field, kept)


def test_sharded_carry_checkpoint_resume(tmp_path):
    """2 steps on the (4, 2) mesh, a checkpoint, a restore into the
    structure of the carry, 2 more steps: bit-equal to 4 straight steps,
    the restored leaves sharded as they were saved."""
    mesh = create_mesh(3, MESH, device="cpu")
    step, (carry0,) = cases._build_fsi_case((16, 16, 16), device="cpu",
                                            mesh=mesh)
    ref, _ = scan_steps(step, carry0, 4)
    mid, _ = scan_steps(step, carry0, 2)
    ckpt = CarryCheckpointer(str(tmp_path / "ckpts"))
    ckpt.save(2, mid, wait=True)
    assert ckpt.latest_step() == 2
    restored = ckpt.restore(template=carry0)
    ckpt.close()
    for name in ("primary_field", "velocity_field"):
        assert (getattr(restored.flow_state, name).shape
                == getattr(mid.flow_state, name).shape)
        assert torch.equal(getattr(restored.flow_state, name),
                           getattr(mid.flow_state, name))
    out, _ = scan_steps(step, restored, 2)
    assert torch.equal(out.flow_state.primary_field,
                       ref.flow_state.primary_field)
    assert torch.equal(out.flow_state.velocity_field,
                       ref.flow_state.velocity_field)
