"""The port's moving-window primitives on an in-process mesh
(``sopht_mpi_tpu_torch.parallel.windows``) against the JAX package's
``parallel/windows.py`` on the same mesh of its virtual CPU devices, and
against the meshless ``field[window]`` / indexed-add pair.

Float64. The gather and the add are exact: they must equal the JAX
functions and the meshless pair bit for bit. The E->L contraction sums in
another order: ``get_test_tol("double")`` (1e-12) of max(1, |ref|). The
gradients of all three against ``jax.vjp`` of the JAX functions, to the
same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.parallel import mesh as jax_mesh
from sopht_mpi_tpu.parallel import windows as jax_windows
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)
from sopht_mpi_tpu_torch.parallel.windows import (
    add_window_into_field,
    gather_window_replicated,
    windowed_e2l_mm_sharded,
)
from sopht_mpi_tpu_torch.utils.types import get_test_tol

TOL = get_test_tol("double")
GRID = (16, 24, 20)  # (nz, ny, nx)
WSHAPE = (7, 9, 5)  # (Wz, Wy, Wx)
DX = 0.05
N_MARKERS = 13
# window starts (x, y, z): the origin, interior, flush with the far walls,
# crossing one, two and four shard edges of the meshes below
STARTS = [(0, 0, 0), (3, 5, 2), (15, 15, 9), (8, 11, 6), (0, 9, 3)]
MESHES = [(4, 2), (8, 1), (1, 8), (2, 4)]


def _close(out, ref, scale=None):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if scale is None else scale
    assert float(np.abs(out - ref).max()) <= TOL * scale


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    field = rng.standard_normal((3, *GRID))
    window = rng.standard_normal((3, *WSHAPE))
    mats = tuple(rng.standard_normal((N_MARKERS, w)) for w in WSHAPE)
    return field, window, mats


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX functions, jitted once a mesh shape (an eager shard_map
    lowers every primitive on its own)."""
    fns = {}
    for shape in MESHES:
        mesh = jax_mesh.create_mesh(3, shape)
        fns[shape] = (mesh, (
            jax.jit(lambda f, s, m=mesh: jax_windows.gather_window_replicated(
                f, s, WSHAPE, m)),
            jax.jit(lambda f, w, s, m=mesh: jax_windows.add_window_into_field(
                f, w, s, m)),
            jax.jit(lambda f, a, s, m=mesh:
                    jax_windows.windowed_e2l_mm_sharded(
                        f, a, s, WSHAPE, DX, m)),
        ))
    return fns


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_windows_match_jax_and_the_meshless_pair(mesh_shape, jax_fns):
    field, window, mats = _inputs()
    jmesh, (j_gather, j_add, j_e2l) = jax_fns[mesh_shape]
    jfield = jax_mesh.shard_vector_field(jnp.asarray(field), jmesh)
    jmats = tuple(jnp.asarray(m) for m in mats)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    tfield = shard_vector_field(torch.tensor(field), mesh)
    tmats = tuple(torch.tensor(m) for m in mats)
    twindow = torch.tensor(window)
    for s in STARTS:
        start = torch.tensor(s, dtype=torch.int32)
        jstart = jnp.asarray(s, jnp.int32)
        sl = (slice(None), slice(s[2], s[2] + WSHAPE[0]),
              slice(s[1], s[1] + WSHAPE[1]), slice(s[0], s[0] + WSHAPE[2]))
        collectives.reset_counts()
        win = gather_window_replicated(tfield, start, WSHAPE, mesh)
        assert collectives.counts()["psum"] == 1
        np.testing.assert_array_equal(win.numpy(), field[sl])
        np.testing.assert_array_equal(
            win.numpy(), np.asarray(j_gather(jfield, jstart)))

        collectives.reset_counts()
        out = add_window_into_field(tfield, twindow, start, mesh)
        assert not any(collectives.counts().values())
        ref = field.copy()
        ref[sl] += window
        np.testing.assert_array_equal(
            unshard_vector_field(out, mesh).numpy(), ref)
        np.testing.assert_array_equal(
            unshard_vector_field(out, mesh).numpy(),
            np.asarray(j_add(jfield, jnp.asarray(window), jstart)))
        # the input field is left as it was
        np.testing.assert_array_equal(
            unshard_vector_field(tfield, mesh).numpy(), field)

        collectives.reset_counts()
        lag = windowed_e2l_mm_sharded(tfield, tmats, start, WSHAPE, DX, mesh)
        assert collectives.counts() == {
            "ppermute": 0, "all_to_all": 0, "pmax": 0, "psum": 1,
            "apply_assembled": 0}
        assert lag.shape == (3, N_MARKERS)
        _close(lag, np.asarray(j_e2l(jfield, jmats, jstart)))
        meshless = np.einsum("czyx,nz,ny,nx->cn", field[sl], *mats) * DX**3
        _close(lag, meshless)


def test_window_gradients_match_jax_vjp():
    """All three are linear in the field (the E->L also in the matrices):
    their vector-Jacobian products against ``jax.vjp`` of the JAX
    functions on the same (4, 2) mesh."""
    field, window, mats = _inputs(seed=1)
    s = (3, 10, 5)
    rng = np.random.default_rng(2)
    ct_win = rng.standard_normal((3, *WSHAPE))
    ct_field = rng.standard_normal((3, *GRID))
    ct_lag = rng.standard_normal((3, N_MARKERS))
    jmesh = jax_mesh.create_mesh(3, (4, 2))
    jstart = jnp.asarray(s, jnp.int32)

    def jax_loss(f, w, az, ay, ax):
        fs = jax_mesh.shard_vector_field(f, jmesh)
        win = jax_windows.gather_window_replicated(fs, jstart, WSHAPE, jmesh)
        out = jax_windows.add_window_into_field(fs, w, jstart, jmesh)
        lag = jax_windows.windowed_e2l_mm_sharded(
            fs, (az, ay, ax), jstart, WSHAPE, DX, jmesh)
        return (jnp.sum(win * ct_win) + jnp.sum(out * ct_field)
                + jnp.sum(lag * ct_lag))

    jgrads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)))(
        jnp.asarray(field), jnp.asarray(window), *map(jnp.asarray, mats))

    mesh = create_mesh(3, (4, 2), device="cpu")
    f = torch.tensor(field, requires_grad=True)
    w = torch.tensor(window, requires_grad=True)
    tmats = [torch.tensor(m, requires_grad=True) for m in mats]
    start = torch.tensor(s, dtype=torch.int32)
    fs = shard_vector_field(f, mesh)
    win = gather_window_replicated(fs, start, WSHAPE, mesh)
    out = unshard_vector_field(add_window_into_field(fs, w, start, mesh), mesh)
    lag = windowed_e2l_mm_sharded(fs, tmats, start, WSHAPE, DX, mesh)
    loss = ((win * torch.tensor(ct_win)).sum()
            + (out * torch.tensor(ct_field)).sum()
            + (lag * torch.tensor(ct_lag)).sum())
    loss.backward()
    for t, g in zip([f, w, *tmats], jgrads):
        _close(t.grad, np.asarray(g))


def test_window_outside_the_domain_adds_nothing_there():
    """The masked forms take any start: cells of a window that leave the
    domain are dropped by the add and read as zero by the gather, as in
    the JAX functions."""
    field, window, _ = _inputs(seed=3)
    mesh = create_mesh(3, (4, 2), device="cpu")
    jmesh = jax_mesh.create_mesh(3, (4, 2))
    tfield = shard_vector_field(torch.tensor(field), mesh)
    jfield = jax_mesh.shard_vector_field(jnp.asarray(field), jmesh)
    for s in [(-2, 20, 12), (17, -3, -4)]:
        start = torch.tensor(s, dtype=torch.int32)
        jstart = jnp.asarray(s, jnp.int32)
        np.testing.assert_array_equal(
            gather_window_replicated(tfield, start, WSHAPE, mesh).numpy(),
            np.asarray(jax.jit(lambda f, st: jax_windows.
                               gather_window_replicated(
                                   f, st, WSHAPE, jmesh))(jfield, jstart)))
        np.testing.assert_array_equal(
            unshard_vector_field(add_window_into_field(
                tfield, torch.tensor(window), start, mesh), mesh).numpy(),
            np.asarray(jax.jit(lambda f, w, st: jax_windows.
                               add_window_into_field(f, w, st, jmesh))(
                jfield, jnp.asarray(window), jstart)))
