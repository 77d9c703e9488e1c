"""The port's carry checkpoints (``sopht_mpi_tpu_torch.utils.checkpoint``)
against the JAX package's orbax ``CarryCheckpointer``.

Save, restore into a freshly built case's carry and step: bit-equal on the
CPU to the run that was not broken off, for each of the four carries. The
JAX package's own checkpoint cases (``tests/test_utils/test_checkpoint.py``,
but the sharded ones) and a JAX carry converted to the port's round-trip
through both checkpointers unchanged.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import sopht_mpi_tpu.utils as jutils
from sopht_mpi_tpu_torch import cases
from sopht_mpi_tpu_torch.convert import rigid_fsi_carry_from_numpy
from sopht_mpi_tpu_torch.models import (
    FlowOnlyCarry,
    MultiBodyFSICarry,
    RigidFSICarry,
    RodFSICarry,
    scan_steps,
)
from sopht_mpi_tpu_torch.utils import CarryCheckpointer
from sopht_mpi_tpu_torch.utils.checkpoint import _flatten

CASES = {
    "rigid": (RigidFSICarry,
              lambda: cases._build_fsi_case((16, 16, 16), device="cpu")),
    "rod": (RodFSICarry,
            lambda: cases._build_rod_fsi_case((16, 16, 24), device="cpu")),
    "multibody": (MultiBodyFSICarry,
                  lambda: cases._build_multibody_case((16, 16, 24),
                                                      device="cpu")),
    "flow_only": (FlowOnlyCarry,
                  lambda: cases.sharded_flow_case((16, 16, 16), None,
                                                  device="cpu")),
}


def _build(name):
    step, carry = CASES[name][1]()
    if isinstance(carry, tuple) and not hasattr(carry, "_fields"):
        (carry,) = carry
    return step, carry


def _assert_equal_trees(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, path
        assert torch.equal(fa[path], fb[path]), path


@pytest.mark.parametrize("name", list(CASES))
def test_save_restore_step_is_bit_equal(tmp_path, name):
    """2 steps, save, restore into a fresh case's carry, 2 more steps: the
    carry and the step diagnostics equal 4 unbroken steps bit for bit."""
    cls, _ = CASES[name]
    step, carry0 = _build(name)
    assert isinstance(carry0, cls)
    ref, _ = scan_steps(step, carry0, 4)
    mid, _ = scan_steps(step, carry0, 2)
    _, ref_diag = scan_steps(step, mid, 2)

    ckpt = CarryCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(2, mid)
    assert ckpt.latest_step() in (None, 2)  # the write may still run
    fresh_step, template = _build(name)
    restored = ckpt.restore(template=template)
    ckpt.close()
    assert ckpt.latest_step() == 2
    assert isinstance(restored, cls)
    _assert_equal_trees(restored, mid)
    out, diag = scan_steps(fresh_step, restored, 2)
    _assert_equal_trees(out, ref)
    _assert_equal_trees(diag, ref_diag)


def test_zero_size_leaf_comes_from_the_template(tmp_path):
    """The sparse sphere carry holds a zero-size forcing placeholder: it is
    kept from the template, whatever the file holds."""
    step, carry = _build("rigid")
    placeholder = carry.flow_state.eul_grid_forcing_field
    assert step.uses_sparse_forcing and placeholder.numel() == 0
    ckpt = CarryCheckpointer(str(tmp_path / "z"))
    ckpt.save(0, carry, wait=True)
    template = carry._replace(flow_state=carry.flow_state._replace(
        eul_grid_forcing_field=torch.zeros((3, 0, 0, 0))))
    out = ckpt.restore(template=template)
    ckpt.close()
    assert out.flow_state.eul_grid_forcing_field is \
        template.flow_state.eul_grid_forcing_field
    assert torch.equal(out.flow_state.primary_field,
                       carry.flow_state.primary_field)

    # the JAX package's case: a (3, 0, 0, 0) leaf beside a field
    tree = {"field": torch.ones((3, 8, 8, 8)),
            "dropped": torch.zeros((3, 0, 0, 0))}
    ckpt = CarryCheckpointer(str(tmp_path / "z2"))
    ckpt.save(0, tree, wait=True)
    out = ckpt.restore(template=tree)
    ckpt.close()
    assert out["dropped"].shape == (3, 0, 0, 0)
    assert torch.equal(out["field"], tree["field"])


def test_restore_refuses_a_mismatched_template(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": (torch.tensor(3.5), torch.ones((2, 2), dtype=torch.float64))}
    ckpt = CarryCheckpointer(str(tmp_path / "m"))
    ckpt.save(1, tree, wait=True)
    with pytest.raises(ValueError, match="'a'"):
        ckpt.restore({**tree, "a": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="'b.1'"):
        ckpt.restore({**tree, "b": (tree["b"][0], torch.ones(2, 2))})
    with pytest.raises(KeyError, match="'c'"):
        ckpt.restore({**tree, "c": torch.ones(1)})
    with pytest.raises(KeyError, match="'a'"):
        ckpt.restore({"b": tree["b"]})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tree, step=7)
    with pytest.raises(TypeError):
        ckpt.save(2, {"a": 1.0})
    ckpt.close()
    empty = CarryCheckpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        empty.restore(tree)
    empty.close()


def test_async_save_then_eager_step_restores_the_saved_carry(tmp_path):
    """``save`` copies the carry to the host before it returns: a step and
    an in-place write into the carry's tensors before the write finishes do
    not reach the checkpoint."""
    step, carry = _build("rod")
    carry, _ = scan_steps(step, carry, 1)
    want = {p: t.clone() for p, t in _flatten(carry).items()}
    ckpt = CarryCheckpointer(str(tmp_path / "a"))
    ckpt.save(1, carry)
    nxt, _ = step(carry)
    for t in _flatten(carry).values():
        t.add_(1.0)
    ckpt.wait_until_finished()
    assert ckpt.latest_step() == 1
    restored = ckpt.restore(template=nxt)
    ckpt.close()
    got = _flatten(restored)
    assert got.keys() == want.keys()
    for p in want:
        assert torch.equal(got[p], want[p]), p


def test_latest_step_ignores_unfinished_writes(tmp_path):
    ckpt = CarryCheckpointer(str(tmp_path / "l"))
    tree = {"a": torch.ones(3)}
    for step in (3, 10):
        ckpt.save(step, tree)
    ckpt.wait_until_finished()
    (tmp_path / "l" / "12.tmp").write_bytes(b"")
    assert ckpt.latest_step() == 10
    assert sorted(os.listdir(tmp_path / "l")) == ["10.pt", "12.tmp", "3.pt"]
    ckpt.close()


def test_pytree_roundtrip_matches_the_jax_checkpointer(tmp_path):
    """The JAX package's pytree case through both checkpointers: equal
    leaves, dtypes kept."""
    rng = np.random.default_rng(4)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": (np.asarray(3.5, np.float32), rng.standard_normal((2, 2)))}
    jtree = jax.tree_util.tree_map(jnp.asarray, arrays)
    jckpt = jutils.CarryCheckpointer(str(tmp_path / "jax"))
    jckpt.save(0, jtree, wait=True)
    jout = jckpt.restore(template=jtree)
    jckpt.close()
    ttree = {"a": torch.tensor(arrays["a"]),
             "b": tuple(torch.tensor(v) for v in arrays["b"])}
    ckpt = CarryCheckpointer(str(tmp_path / "port"))
    ckpt.save(0, ttree, wait=True)
    out = ckpt.restore(template=ttree)
    ckpt.close()
    for j, t in zip(jax.tree_util.tree_leaves(jout),
                    [out["a"], *out["b"]]):
        assert np.dtype(j.dtype) == t.numpy().dtype
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_converted_jax_carry_roundtrips(tmp_path):
    """A JAX sphere carry, through ``rigid_fsi_carry_from_numpy``, saves and
    restores into the port's own carry of the same case unchanged."""
    jstep, (jcarry,) = jax_entry._build_fsi_case(grid_size=(16, 16, 16))
    tree = jax.tree_util.tree_map(np.asarray, jcarry)
    carry = rigid_fsi_carry_from_numpy(tree, device="cpu",
                                       dtype=torch.float32)
    _, template = _build("rigid")
    ckpt = CarryCheckpointer(str(tmp_path / "c"))
    ckpt.save(0, carry, wait=True)
    out = ckpt.restore(template=template)
    ckpt.close()
    flat, want = _flatten(out), _flatten(carry)
    for path, t in want.items():
        if t.numel():
            assert torch.equal(flat[path], t), path
            np.testing.assert_array_equal(
                flat[path].numpy(), np.asarray(_leaf(tree, path)))


def _leaf(tree, path):
    node = tree
    for part in path.split("."):
        node = node[int(part)] if part.isdigit() else getattr(node, part)
    return node
