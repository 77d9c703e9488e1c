"""State carried across from the JAX package: numpy trees -> the port's
NamedTuples.

A JAX carry becomes numpy with ``jax.tree_util.tree_map(np.asarray,
carry)`` (done by the caller; this module never sees a JAX array). Each
node may be a tuple/NamedTuple (read by position, in the JAX package's
field order, which the port keeps) or a dict (read by field name).

With a ``mesh`` the global arrays are sharded over it: every shard on an
in-process mesh, this process's block on a distributed one (every process
converts the same global carry).
"""

from __future__ import annotations

import numpy as np
import torch

from sopht_mpi_tpu_torch.models.elastica.rod import (
    CosseratRodParams,
    CosseratRodState,
)
from sopht_mpi_tpu_torch.models.flow.simulator_2d import FlowState2D
from sopht_mpi_tpu_torch.models.flow.simulator_3d import FlowState3D
from sopht_mpi_tpu_torch.models.fsi import (
    MultiBodyFSICarry,
    RigidFSICarry,
    RodFSICarry,
)
from sopht_mpi_tpu_torch.models.rigid_body import RigidBodyState
from sopht_mpi_tpu_torch.ops.virtual_boundary import VirtualBoundaryState
from sopht_mpi_tpu_torch.parallel.fft import shard_fourier
from sopht_mpi_tpu_torch.parallel.mesh import (
    shard_scalar_field,
    shard_vector_field,
)


def _fields(node, names):
    if isinstance(node, dict):
        return [node.get(name) for name in names]
    values = list(node)
    if len(values) > len(names):
        raise ValueError(f"expected at most {len(names)} fields {names}, "
                         f"got {len(values)}")
    return values + [None] * (len(names) - len(values))


def _tensor(leaf, device, dtype):
    if leaf is None:
        return None
    return torch.tensor(np.asarray(leaf), dtype=dtype, device=device)


def _greens(leaf, device, dtype, mesh=None):
    """The dense Green's spectrum, or the (bulk, side) pair a JAX solver
    stores when it takes the Pallas route; on a ``mesh`` of more than one
    shard the dense spectrum in the sharded Fourier layout."""
    if isinstance(leaf, (tuple, list)):
        return tuple(_tensor(v, device, dtype) for v in leaf)
    if _sharded(mesh):
        return sharded_greens_from_numpy(leaf, mesh, device=device,
                                         dtype=dtype)
    return _tensor(leaf, device, dtype)


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def flow_state_from_numpy(tree, *, device, dtype, mesh=None):
    """(primary field, velocity_field, eul_grid_forcing_field) numpy arrays
    -> :class:`FlowState3D`, or :class:`FlowState2D` when the primary field
    is a 2D scalar (a dict names it ``primary_scalar_field``), on ``device``
    in ``dtype``. A 3D primary field is the vorticity or passive vector
    (3, nz, ny, nx), or a passive scalar (nz, ny, nx); the forcing field may
    be None. With a ``mesh`` of the state's dimension and more than one
    shard the global arrays are sharded over it, as a simulator on that mesh
    holds them."""
    if isinstance(tree, dict):
        two_d = "primary_scalar_field" in tree
    else:
        two_d = np.asarray(list(tree)[0]).ndim == 2
    cls = FlowState2D if two_d else FlowState3D
    leaves = [_tensor(v, device, dtype) for v in _fields(tree, cls._fields)]
    if _sharded(mesh):
        if mesh.grid_dim != (2 if two_d else 3):
            raise ValueError(
                f"a {2 if two_d else 3}D flow state on a {mesh.grid_dim}D "
                "mesh")
        vector_ndim = mesh.grid_dim + 1
        leaves = [None if v is None
                  else (shard_vector_field if v.ndim == vector_ndim
                        else shard_scalar_field)(v, mesh)
                  for v in leaves]
    return cls(*leaves)


def sharded_greens_from_numpy(greens, mesh, *, device, dtype):
    """A JAX solver's dense Fourier-layout Green's function on a mesh, as
    one global numpy array ((2 nz, 2 ny, fxp) in 3D, (2 ny, fxp) in 2D),
    -> the port's sharded one (:func:`~sopht_mpi_tpu_torch.parallel.fft.
    shard_fourier`: (pz, py, 2 nz, 2 ny/pz, fxp/py), or (py, px, 2 ny,
    fxp/(py px)) with the 2D pencil's x-major chunk order), on ``device``
    in ``dtype``."""
    return shard_fourier(_tensor(greens, device, dtype), mesh)


def rigid_fsi_carry_from_numpy(tree, *, device, dtype, mesh=None
                               ) -> RigidFSICarry:
    """A JAX ``RigidFSICarry`` (2D or 3D) as numpy arrays -> the port's
    :class:`RigidFSICarry`: the flow state, ``vb_state``, the velocity
    mismatch, time, the Fourier Green's function (dense, or the split
    (bulk, side) pair), ``velocity_l1_max`` and
    ``ibm_mats`` (None on the dense path). A carry taken on a ``mesh`` (its
    arrays global, as ``np.asarray`` gives them) converts onto the port's
    ``mesh`` of the same shape: the flow state and the Green's
    function sharded as :func:`flow_state_from_numpy` and
    :func:`sharded_greens_from_numpy` shard them."""
    (flow, vb, mismatch, time, greens, l1_max, mats) = _fields(
        tree, RigidFSICarry._fields
    )
    return RigidFSICarry(
        flow_state=flow_state_from_numpy(flow, device=device, dtype=dtype,
                                         mesh=mesh),
        vb_state=_vb_state(vb, device, dtype),
        velocity_mismatch=_tensor(mismatch, device, dtype),
        time=_tensor(time, device, dtype),
        greens=_greens(greens, device, dtype, mesh),
        velocity_l1_max=_tensor(l1_max, device, dtype),
        ibm_mats=(
            None if mats is None
            else tuple(_tensor(m, device, dtype) for m in mats)
        ),
    )


def _vb_state(tree, device, dtype) -> VirtualBoundaryState:
    return VirtualBoundaryState(
        *(_tensor(v, device, dtype)
          for v in _fields(tree, VirtualBoundaryState._fields))
    )


def rod_state_from_numpy(tree, *, device, dtype=torch.float64
                         ) -> CosseratRodState:
    """(position, velocity, director, omega) numpy arrays ->
    :class:`CosseratRodState` on ``device`` in ``dtype``."""
    return CosseratRodState(
        *(_tensor(v, device, dtype)
          for v in _fields(tree, CosseratRodState._fields))
    )


def rod_params_from_numpy(tree, *, device, dtype=torch.float64
                          ) -> CosseratRodParams:
    """A JAX rod's ``CosseratRodParams`` as numpy arrays ->
    :class:`CosseratRodParams` on ``device`` in ``dtype``."""
    return CosseratRodParams(
        *(_tensor(v, device, dtype)
          for v in _fields(tree, CosseratRodParams._fields))
    )


def rod_fsi_carry_from_numpy(tree, *, device, dtype, rod_dtype=torch.float64,
                             mesh=None) -> RodFSICarry:
    """A JAX ``RodFSICarry`` as numpy arrays -> the port's
    :class:`RodFSICarry`: the flow state, ``vb_state``, time, the Green's
    function (dense, or the split (bulk, side) pair) and
    ``velocity_l1_max`` in the flow's ``dtype``; the rod state in
    ``rod_dtype``; the frozen loads (None unless the step freezes them) in
    the promotion of the two, the dtype the markers' math runs in. On a
    ``mesh`` as :func:`rigid_fsi_carry_from_numpy`."""
    (flow, vb, rod, time, greens, l1_max, frozen) = _fields(
        tree, RodFSICarry._fields
    )
    marker_dtype = torch.promote_types(dtype, rod_dtype)
    return RodFSICarry(
        flow_state=flow_state_from_numpy(flow, device=device, dtype=dtype,
                                         mesh=mesh),
        vb_state=_vb_state(vb, device, dtype),
        rod_state=rod_state_from_numpy(rod, device=device, dtype=rod_dtype),
        time=_tensor(time, device, dtype),
        greens=_greens(greens, device, dtype, mesh),
        velocity_l1_max=_tensor(l1_max, device, dtype),
        frozen_loads=(
            None if frozen is None
            else tuple(_tensor(v, device, marker_dtype) for v in frozen)
        ),
    )


def rigid_body_state_from_numpy(tree, *, device, dtype) -> RigidBodyState:
    """(position, velocity, omega, director) numpy arrays ->
    :class:`RigidBodyState` on ``device`` in ``dtype``."""
    return RigidBodyState(
        *(_tensor(v, device, dtype)
          for v in _fields(tree, RigidBodyState._fields))
    )


def _is_rigid_state(tree) -> bool:
    """A rigid body's position is a (3,) vector, a rod's (3, n + 1)."""
    position = tree["position"] if isinstance(tree, dict) else list(tree)[0]
    return np.ndim(position) == 1


def multi_body_fsi_carry_from_numpy(tree, *, device, dtype,
                                    rod_dtype=torch.float64, mesh=None
                                    ) -> MultiBodyFSICarry:
    """A JAX ``MultiBodyFSICarry`` as numpy arrays -> the port's
    :class:`MultiBodyFSICarry`. Per body: a rod state in ``rod_dtype``, a
    rigid-body state in ``dtype``, None for a fixed body; the flow state,
    the virtual-boundary states, the previous mismatches, time, the Green's
    function and ``velocity_l1_max`` in ``dtype``; the frozen loads (None
    unless the step freezes them; None entries for fixed bodies) in the
    promotion of ``dtype`` and the body's dtype. On a ``mesh`` as
    :func:`rigid_fsi_carry_from_numpy`."""
    (flow, bodies, vbs, prev, time, greens, l1_max, frozen) = _fields(
        tree, MultiBodyFSICarry._fields
    )
    states, body_dtypes = [], []
    for body in bodies:
        if body is None:
            states.append(None)
            body_dtypes.append(dtype)
        elif _is_rigid_state(body):
            states.append(rigid_body_state_from_numpy(
                body, device=device, dtype=dtype))
            body_dtypes.append(dtype)
        else:
            states.append(rod_state_from_numpy(
                body, device=device, dtype=rod_dtype))
            body_dtypes.append(rod_dtype)
    if frozen is not None:
        frozen = tuple(
            None if loads is None else tuple(
                _tensor(v, device, torch.promote_types(dtype, body_dtype))
                for v in loads)
            for loads, body_dtype in zip(frozen, body_dtypes)
        )
    return MultiBodyFSICarry(
        flow_state=flow_state_from_numpy(flow, device=device, dtype=dtype,
                                         mesh=mesh),
        body_states=tuple(states),
        vb_states=tuple(_vb_state(vb, device, dtype) for vb in vbs),
        prev_mismatches=tuple(_tensor(v, device, dtype) for v in prev),
        time=_tensor(time, device, dtype),
        greens=_greens(greens, device, dtype, mesh),
        velocity_l1_max=_tensor(l1_max, device, dtype),
        frozen_loads=frozen,
    )
