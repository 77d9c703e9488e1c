"""The port's immersed-boundary transfers and penalty forcing against the
JAX package's ``ops/ibm.py`` and ``ops/virtual_boundary.py``, on seeded
numpy markers and fields.

Tolerances: float64 ``1e-12 max(1, |ref|max)``; float32
``1e-5 max(1, |ref|max)`` (float32 rounding of differently ordered sums);
integer support indices exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.ops import ibm as jax_ibm
from sopht_mpi_tpu.ops import virtual_boundary as jax_vb
from sopht_mpi_tpu_torch.ops import ibm, virtual_boundary as vb

GRID = (12, 16, 20)  # (nz, ny, nx)
DX = 1.0 / GRID[-1]
SHIFT = DX / 2
N_MARKERS = 40
DTYPES = {"single": (np.float32, torch.float32),
          "double": (np.float64, torch.float64)}


def _check(out, ref):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(out, ref)
        return
    tol = 1e-12 if ref.dtype == np.float64 else 1e-5
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * scale)


def _inputs(precision, seed=0):
    np_t, _ = DTYPES[precision]
    rng = np.random.default_rng(seed)
    extent = np.array([GRID[2], GRID[1], GRID[0]]) * DX  # (x, y, z)
    pos = (rng.uniform(0.25, 0.75, (3, N_MARKERS)) * extent[:, None]).astype(np_t)
    field = rng.standard_normal((3,) + GRID).astype(np_t)
    lag = rng.standard_normal((3, N_MARKERS)).astype(np_t)
    return pos, field, lag


def _t(a, precision):
    return torch.tensor(a, dtype=DTYPES[precision][1])


@pytest.mark.parametrize("kind", ["cosine", "peskin"])
def test_support_and_weights_match_jax(precision, kind):
    pos, _, _ = _inputs(precision)
    ref = jax_ibm.nearest_grid_index_and_support(jnp.asarray(pos), DX, SHIFT)
    out = ibm.nearest_grid_index_and_support(_t(pos, precision), DX, SHIFT)
    for o, r in zip(out, ref):
        _check(o, r)
    _check(ibm.interpolation_weights(out[2], DX, kind),
           jax_ibm.interpolation_weights(ref[2], DX, kind))


@pytest.mark.parametrize("kind", ["cosine", "peskin"])
def test_transfers_match_jax(precision, kind):
    """E->L gather and L->E scatter on the whole grid, and the separable
    matmul form on a window around the markers, against JAX."""
    pos, field, lag = _inputs(precision, seed=1)
    _, jidx, jdisp = jax_ibm.nearest_grid_index_and_support(
        jnp.asarray(pos), DX, SHIFT)
    _, idx, disp = ibm.nearest_grid_index_and_support(
        _t(pos, precision), DX, SHIFT)
    jw = jax_ibm.interpolation_weights(jdisp, DX, kind)
    w = ibm.interpolation_weights(disp, DX, kind)
    jfield, tfield = jnp.asarray(field), _t(field, precision)
    _check(ibm.eulerian_to_lagrangian_interpolation(tfield, w, idx, DX),
           jax_ibm.eulerian_to_lagrangian_interpolation(jfield, jw, jidx, DX))
    _check(ibm.eulerian_to_lagrangian_interpolation(tfield[0], w, idx, DX),
           jax_ibm.eulerian_to_lagrangian_interpolation(jfield[0], jw, jidx,
                                                        DX))
    _check(ibm.lagrangian_to_eulerian_spread(tfield, _t(lag, precision), w,
                                             idx),
           jax_ibm.lagrangian_to_eulerian_spread(jfield, jnp.asarray(lag), jw,
                                                 jidx))
    _check(ibm.lagrangian_to_eulerian_spread(tfield[1], _t(lag[1], precision),
                                             w, idx),
           jax_ibm.lagrangian_to_eulerian_spread(jfield[1],
                                                 jnp.asarray(lag[1]), jw, jidx))

    # separable matmul form on a window (start, shape in grid order z, y, x)
    idx_np = np.asarray(jidx)
    lo = idx_np.min(axis=(1, 2)) - 1  # (x, y, z)
    hi = idx_np.max(axis=(1, 2)) + 2
    start_xyz = lo
    wshape = tuple(int(v) for v in (hi - lo)[::-1])
    z0, y0, x0 = start_xyz[::-1]
    win = field[:, z0:z0 + wshape[0], y0:y0 + wshape[1], x0:x0 + wshape[2]]
    jshift = jidx - jnp.asarray(start_xyz, jidx.dtype).reshape(3, 1, 1)
    shift = idx - torch.tensor(start_xyz, dtype=idx.dtype).reshape(3, 1, 1)
    jmats = jax_ibm.axis_delta_weight_matrices(jshift, jdisp, DX, wshape, kind)
    mats = ibm.axis_delta_weight_matrices(shift, disp, DX, wshape, kind)
    for m, jm in zip(mats, jmats):
        _check(m, jm)
    twin = _t(np.ascontiguousarray(win), precision)
    _check(ibm.eulerian_to_lagrangian_interpolation_mm(twin, mats, DX),
           jax_ibm.eulerian_to_lagrangian_interpolation_mm(jnp.asarray(win),
                                                           jmats, DX))
    _check(ibm.eulerian_to_lagrangian_interpolation_mm(twin[2], mats, DX),
           jax_ibm.eulerian_to_lagrangian_interpolation_mm(jnp.asarray(win[2]),
                                                           jmats, DX))
    _check(ibm.lagrangian_to_eulerian_spread_mm(twin, _t(lag, precision), mats),
           jax_ibm.lagrangian_to_eulerian_spread_mm(jnp.asarray(win),
                                                    jnp.asarray(lag), jmats))
    # the matmul form agrees with the gather form on the same window
    _check(ibm.eulerian_to_lagrangian_interpolation_mm(twin, mats, DX),
           ibm.eulerian_to_lagrangian_interpolation(tfield, w, idx, DX).numpy())


def test_penalty_force_and_time_step_match_jax(precision):
    pos, field, lag = _inputs(precision, seed=2)
    np_t = DTYPES[precision][0]
    rng = np.random.default_rng(3)
    mismatch = (1e-3 * rng.standard_normal((3, N_MARKERS))).astype(np_t)
    body_vel = rng.standard_normal((3, N_MARKERS)).astype(np_t)
    kw = dict(virtual_boundary_stiffness_coeff=-1e4,
              virtual_boundary_damping_coeff=-10.0, grid_dim=3, dx=DX)
    jparams = jax_vb.VirtualBoundaryForcingParams(**kw)
    params = vb.VirtualBoundaryForcingParams(**kw)
    assert params.eul_grid_coord_shift == jparams.eul_grid_coord_shift
    jstate = jax_vb.VirtualBoundaryState(jnp.asarray(mismatch),
                                         jnp.asarray(np_t(0.25)))
    state = vb.VirtualBoundaryState(_t(mismatch, precision),
                                    _t(np_t(0.25), precision))
    _check(vb.compute_penalty_force(state.position_mismatch,
                                    _t(body_vel, precision), params),
           jax_vb.compute_penalty_force(jstate.position_mismatch,
                                        jnp.asarray(body_vel), jparams))
    jeul, jinter = jax_vb.compute_interaction_force_on_eul_and_lag_grid(
        jstate, jnp.asarray(field), jnp.asarray(field), jnp.asarray(pos),
        jnp.asarray(body_vel), jparams, reset_eul_grid_forcing_field=True)
    eul, inter = vb.compute_interaction_force_on_eul_and_lag_grid(
        state, _t(field, precision), _t(field, precision), _t(pos, precision),
        _t(body_vel, precision), params, reset_eul_grid_forcing_field=True)
    _check(eul, jeul)
    for o, r in zip(inter, jinter):
        _check(o, r)
    lag_only = vb.compute_interaction_force_on_lag_grid(
        state, _t(field, precision), _t(pos, precision),
        _t(body_vel, precision), params)
    for o, r in zip(lag_only, jinter):
        _check(o, r)
    dt = np_t(3e-3)
    jnext = jax_vb.virtual_boundary_time_step(jstate, jinter.velocity_mismatch,
                                              jnp.asarray(dt))
    nxt = vb.virtual_boundary_time_step(state, inter.velocity_mismatch,
                                        _t(dt, precision))
    _check(nxt.position_mismatch, jnext.position_mismatch)
    _check(nxt.time, jnext.time)
