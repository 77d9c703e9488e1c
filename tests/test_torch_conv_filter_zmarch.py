"""The port's single-device z-marching convolution filter
(``conv_filter_zmarch_kernel`` in ``csrc/stencils_3d.cu``, one launch a
call of ``laplacian_filter_vector_3d(..., "convolution")`` at orders 1 ...
5): its walk, its launch plan and, on the card, the kernel.

- A numpy model of the kernel's walk: a block a (tile, z chunk), the
  chunk's planes and ``order`` planes beyond each end loaded copy item by
  copy item as the plan cuts them (runs of 16 bytes or single values of the
  tile's ``ty + 2 order`` rows, an ``order``-cell halo rounded up to 16
  bytes on each side), rows and planes beyond the field never loaded, into
  a ring of plane tiles that are NaN until written, each copy landing at its
  issue or only at the wait for its group; on each plane inside the z walls
  the x stage's ``order`` levels on the tile rows, the y stage's on the
  tile columns, each level clearing the ring; the z stage's levels rolled
  through registers one level a plane; each output cell written once. Held
  against the port's plain ``laplacian_filter_vector_3d_ref`` at every tile
  and ring depth of the plan and several z chunks, at odd shapes ((3, 17,
  33, 65), (3, 3, 3, 3), axes of fewer than ``2 order + 1`` cells, ragged
  tiles), float32 and float64, orders 1 ... 5.
- The port's plain version against the JAX package's
  ``laplacian_filter_vector_3d_pallas`` (convolution, interpret mode) on
  the same numpy-seeded fields.
- The plan (:func:`conv_filter_plan`, a z-marching plan on one shard
  whose walk keeps the newest plane alone): its invariants, its choice at the
  rod's (3, 256, 64, 256), at 256^3 and at the freely rotating rod's (3,
  64, 64, 128), and what it refuses.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  version under every plan and order, the wrapper's one launch a call (the
  line route's ``2 + order`` above order 5), and the launcher's refusal of
  another plan. On the card, without JAX installed: ``python -m pytest
  tests/test_torch_conv_filter_zmarch.py -m cuda --noconftest``.

Tolerances, as the card's gates: float32 ``1e-5 max(1, |ref|max)``,
float64 ``1e-12``. The model and the kernel repeat the plain version's
operations in its order, so both come out exact at float32 too.
"""

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as kernels
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded

SMS = sharded.H100_SMS
ROD = (3, 256, 64, 256)
CUBE = (3, 256, 256, 256)
FREE_ROD = (3, 64, 64, 128)
ODD = (3, 17, 33, 65)
ORDERS = list(kernels.CONV_FILTER_ORDERS)


def _tol(ref, dtype):
    if dtype == torch.float64:
        return 1e-12
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape), dtype=dtype)


def _plan(shape, dtype, order, tile, stages, zchunk, aligned=True):
    _, nz, ny, nx = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return kernels.conv_filter_plan_of(order, nz, ny, nx, itemsize, aligned,
                                       tile, stages, min(zchunk, nz))


def _geometry(plan, itemsize, order):
    """(P, W, R): the tile's x pad (the order rounded up to 16 bytes'
    values), its row length and its rows."""
    v = 16 // itemsize
    pad = -(-order // v) * v
    return pad, plan.tx + 2 * pad, plan.ty + 2 * order


# ---------------------------------------------------------------------------
# the numpy model of the walk
# ---------------------------------------------------------------------------


def copy_items(plan, order, x0, y0, shape, itemsize):
    """The copy items of the tile at (x0, y0) as the kernel cuts them:
    (component, tile row, tile column, values), runs of 16 bytes with
    ``vec`` else single values, over the tile's rows and its whole width
    (the x pad included), those inside the field."""
    _, nz, ny, nx = shape
    pad, width, rows = _geometry(plan, itemsize, order)
    run = 16 // itemsize if plan.vec else 1
    items = []
    for item in range(3 * rows * (width // run)):
        q, rest = item % (width // run), item // (width // run)
        r, j = rest % rows, rest // rows
        x, ly = x0 - pad + q * run, y0 - order + r
        if x < 0 or x >= nx or ly < 0 or ly >= ny:
            continue
        assert x + run <= nx, "a 16-byte run past the row's end"
        items.append((j, r, q * run, run))
    return items


class _Ring:
    """The block's ring of plane tiles (stages, 3, R, W), NaN until
    written; a plane's copies form one group, landing at their issue
    (``late=False``) or when a wait retires the group (``late=True``)."""

    def __init__(self, stages, rows, width, dtype, late):
        self.t = np.full((stages, 3, rows, width), np.nan, dtype)
        self.late = late
        self.groups, self.open = [], []

    def load(self, slot, f, z, y0, xa, order, items):
        if z < 0 or z >= f.shape[1]:
            return  # no z plane buffers on one device
        for j, r, col, n in items:
            vals = f[j, z, y0 - order + r, xa + col:xa + col + n]
            if self.late:
                self.open.append((slot, j, r, col, np.copy(vals)))
            else:
                self.t[slot, j, r, col:col + n] = vals

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait(self, pending):
        while len(self.groups) > pending:
            for slot, j, r, col, vals in self.groups.pop(0):
                self.t[slot, j, r, col:col + len(vals)] = vals


def _hp(c, p, m, dt):
    """The directional high-pass in the plain version's order."""
    return dt(0.25) * ((dt(2) * c - p) - m)


def _levels(vals, order, axis, lo, n, inside, dt):
    """``order`` levels of the clamped high-pass along ``axis`` of
    ``vals`` whose outputs are indices [lo, lo + n): level l on [lo - (order
    - l), lo + n + (order - l)); ``inside(idx)`` masks the cells inside the
    walls (0 elsewhere)."""
    vals = np.moveaxis(vals.copy(), axis, -1)
    for lev in range(1, order + 1):
        a, b = lo - (order - lev), lo + n + (order - lev)
        idx = np.arange(a, b)
        new = _hp(vals[..., a:b], vals[..., a + 1:b + 1], vals[..., a - 1:b - 1],
                  dt)
        vals[..., a:b] = np.where(inside(idx), new, dt(0))
    return np.moveaxis(vals, -1, axis)


def conv_walk_model(f, order, plan, late=False):
    """One launch of the kernel under ``plan`` on a numpy field. Asserts
    that every output cell is written once."""
    _, nz, ny, nx = f.shape
    dt = f.dtype.type
    tx, ty, zc_, stages = plan.tx, plan.ty, plan.zchunk, plan.stages
    pad, width, rows = _geometry(plan, f.itemsize, order)
    tiles_x, tiles_y = -(-nx // tx), -(-ny // ty)
    chunks = -(-nz // zc_)
    assert plan.blocks == tiles_x * tiles_y * chunks
    assert plan.smem == kernels.conv_filter_smem(order, tx, ty, stages,
                                                 f.itemsize)
    out = np.full_like(f, np.nan)
    written = np.zeros(f.shape[1:], int)
    ahead = stages - 1  # the walk keeps the newest plane alone
    zd_n, zl_n = max(order, 2), max(order - 1, 1)
    for ti in range(tiles_x * tiles_y):
        x0, y0 = (ti % tiles_x) * tx, (ti // tiles_x) * ty
        xs = x0 + np.arange(tx)[None, :]
        ys = y0 + np.arange(ty)[:, None]
        valid = (xs < nx) & (ys < ny)
        inner = (xs >= 1) & (xs <= nx - 2) & (ys >= 1) & (ys <= ny - 2)
        tile_y = y0 - order + np.arange(rows)
        col_in = (xs[0] >= 1) & (xs[0] <= nx - 2)
        items = copy_items(plan, order, x0, y0, f.shape, f.itemsize)
        for ci in range(chunks):
            za, zb = ci * zc_, min(ci * zc_ + zc_, nz)
            L = zb - za + 2 * order
            ring = _Ring(stages, rows, width, f.dtype, late)
            for k in range(ahead):
                if k < L:
                    ring.load(k, f, za - order + k, y0, x0 - pad, order,
                              items)
                ring.commit()
            zd = np.zeros((zd_n, 3, ty, tx), f.dtype)
            zla = np.zeros((zl_n, 3, ty, tx), f.dtype)
            zlb = np.zeros((zl_n, 3, ty, tx), f.dtype)
            for k in range(L):
                ring.wait(ahead - 1)
                kn = k + ahead
                if kn < L:
                    ring.load(kn % stages, f, za - order + kn, y0, x0 - pad,
                              order, items)
                ring.commit()
                t = ring.t[k % stages]
                p = za - order + k
                g2 = np.zeros((3, ty, tx), f.dtype)
                with np.errstate(invalid="ignore", over="ignore"):
                    if 1 <= p <= nz - 2:
                        # the x stage on every tile row, then the y stage
                        row_in = (tile_y >= 1) & (tile_y <= ny - 2)
                        xv = _levels(
                            t, order, 2, pad, tx,
                            lambda i: row_in[:, None] & (x0 - pad + i >= 1)
                            & (x0 - pad + i <= nx - 2), dt)
                        g1 = t[:, :, pad:pad + tx] - xv[:, :, pad:pad + tx]
                        yv = _levels(
                            g1, order, 1, order, ty,
                            lambda i: col_in[:, None]
                            & ((tile_y[i] >= 1) & (tile_y[i] <= ny - 2)), dt)
                        g2 = (g1[:, order:order + ty]
                              - yv[:, order:order + ty])
                    elif p in (0, nz - 1):
                        g2 = t[:, order:order + ty, pad:pad + tx].copy()
                    # the z stage: L_i(p - i), i = 1 ... order
                    lv, lm, lmm = g2, zd[0], zd[1]
                    for i in range(1, order + 1):
                        sel = inner & (1 <= p - i <= nz - 2)
                        li = np.where(sel, _hp(lm, lv, lmm, dt), dt(0))
                        if i < order:
                            lm, lmm = zla[i - 1].copy(), zlb[i - 1].copy()
                            zlb[i - 1] = zla[i - 1]
                            zla[i - 1] = li
                        lv = li
                    if k >= 2 * order:
                        q = p - order
                        ysv, xsv = np.nonzero(valid)
                        res = zd[order - 1] - lv
                        out[:, q, ys[ysv, 0], xs[0, xsv]] = res[:, ysv, xsv]
                        np.add.at(written, (q, ys[ysv, 0], xs[0, xsv]), 1)
                zd = np.concatenate([g2[None], zd[:-1]])
    assert (written == 1).all(), "an output cell written twice or never"
    return out


def _check_model(shape, dtype, order, plan, late, seed=0):
    f = _field(shape, dtype, seed)
    out = conv_walk_model(f.numpy(), order, plan, late)
    assert not np.isnan(out).any()
    ref = kernels.laplacian_filter_vector_3d_ref(f, order, "convolution")
    err = float(np.abs(out - ref.numpy()).max())
    assert err <= _tol(ref, dtype), f"{shape} {plan} order {order}: {err}"
    return err


# every tile and ring depth the launcher takes, three z chunks, eager and
# late copies, on the odd grid (ragged x and y tiles), at orders 1, 2, 5
WALK_CASES = [(tile, stages, zchunk, late, order)
              for tile in sharded.ZMARCH_TILES
              for stages in range(sharded.ZMARCH_STAGE_RANGE[0],
                                  sharded.ZMARCH_STAGE_RANGE[1] + 1)
              for zchunk, late, order in ((1, True, 1), (4, False, 5),
                                          (17, True, 2))]


@pytest.mark.parametrize("tile,stages,zchunk,late,order", WALK_CASES)
def test_walk_of_every_plan_matches_plain(tile, stages, zchunk, late, order):
    plan = _plan(ODD, torch.float32, order, tile, stages, zchunk)
    # the plain version's arithmetic in its order: exact at float32
    assert _check_model(ODD, torch.float32, order, plan, late,
                        seed=stages + zchunk) == 0.0


# (shape, dtype): a single interior cell, axes of fewer than 2 order + 1
# cells, nx a multiple of 16 bytes' values (16-byte copies), ragged x and y
# tiles, one-plane and two-row fields
SHAPE_CASES = [((3, 3, 3, 3), torch.float32), ((3, 3, 3, 3), torch.float64),
               ((3, 5, 7, 9), torch.float32), ((3, 4, 10, 64), torch.float64),
               ((3, 6, 20, 36), torch.float32), ((3, 12, 2, 40), torch.float64),
               ((3, 1, 5, 8), torch.float32)]


@pytest.mark.parametrize("shape,dtype", SHAPE_CASES)
@pytest.mark.parametrize("order", ORDERS)
def test_walk_of_the_chosen_plan_at_odd_shapes(shape, dtype, order):
    _, nz, ny, nx = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = kernels.conv_filter_launch_plan(order, nz, ny, nx, itemsize)
    assert plan.vec == (nx % (16 // itemsize) == 0)
    _check_model(shape, dtype, order, plan, late=True, seed=order)
    # one-plane chunks and another tile and ring depth, copies eager
    plan = _plan(shape, dtype, order, (32, 16), 5, 1)
    _check_model(shape, dtype, order, plan, late=False, seed=order)


def test_copy_items_cover_the_tile_once():
    """Every tile cell inside the field is the target of exactly one copy
    item, the x pad's included; no item reaches beyond the field."""
    for shape, tile, order, vec in ((ODD, (64, 8), 5, False),
                                    ((3, 4, 20, 64), (32, 8), 3, True),
                                    ((3, 4, 20, 64), (64, 4), 1, True)):
        plan = _plan(shape, torch.float32, order, tile, 4, 2)
        assert plan.vec == vec
        _, nz, ny, nx = shape
        pad, width, rows = _geometry(plan, 4, order)
        tiles_x = -(-nx // plan.tx)
        for ti in range(tiles_x * -(-ny // plan.ty)):
            x0, y0 = (ti % tiles_x) * plan.tx, (ti // tiles_x) * plan.ty
            hits = np.zeros((3, rows, width), int)
            for j, r, col, n in copy_items(plan, order, x0, y0, shape, 4):
                hits[j, r, col:col + n] += 1
            ly = y0 - order + np.arange(rows)[:, None]
            x = x0 - pad + np.arange(width)[None, :]
            inside = (ly >= 0) & (ly < ny) & (x >= 0) & (x < nx)
            assert (hits == inside[None]).all()


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [ODD, (3, 3, 3, 3), (3, 5, 7, 9)])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_plain_matches_jax_pallas(shape, order, np_dtype):
    import jax.numpy as jnp

    from sopht_mpi_tpu.ops.pallas_stencils_3d import (
        laplacian_filter_vector_3d_pallas,
    )

    f = np.random.default_rng(order).standard_normal(shape).astype(np_dtype)
    ref = np.asarray(laplacian_filter_vector_3d_pallas(
        jnp.asarray(f), order, "convolution", interpret=True))
    out = kernels.laplacian_filter_vector_3d_ref(torch.tensor(f), order,
                                                 "convolution").numpy()
    assert out.dtype == ref.dtype
    err = float(np.abs(out - ref).max())
    tol = (1e-12 if np_dtype == np.float64
           else 1e-5 * max(1.0, float(np.abs(ref).max())))
    assert err <= tol
    # the wrapper's CPU route is the plain version, and counts no launch
    before = kernels.laplacian_filter_vector_3d.launches
    assert torch.equal(
        kernels.laplacian_filter_vector_3d(torch.tensor(f), order,
                                           "convolution"),
        torch.tensor(out))
    assert kernels.laplacian_filter_vector_3d.launches == before


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 1, 1), (3, 3, 3), (17, 33, 65), (4, 9, 12),
               (256, 64, 256), (256, 256, 256), (64, 64, 128),
               (512, 8, 1024)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims", PLAN_SHAPES)
@pytest.mark.parametrize("order", ORDERS)
def test_plan_invariants(itemsize, dims, order):
    nz, ny, nx = dims
    plan = kernels.conv_filter_launch_plan(order, nz, ny, nx, itemsize,
                                           True, SMS)
    assert (plan.tx, plan.ty) == ((64, 8) if order <= 2 else (32, 16))
    assert (plan.tx, plan.ty) == kernels.CONV_FILTER_TILES[order]
    assert plan.stages == kernels.CONV_FILTER_STAGES
    pad, width, rows = _geometry(plan, itemsize, order)
    assert pad >= order and pad * itemsize % 16 == 0
    assert plan.smem == itemsize * (
        3 * plan.stages * rows * width + 3 * rows * plan.tx
        + (3 * plan.ty * plan.tx if order > 2 else 0))
    assert plan.smem <= sharded.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + sharded.BLOCK_SHARED_RESERVE) \
        <= sharded.SM_SHARED_BYTES
    threads = kernels.conv_filter_sm_threads(order)
    assert threads == (1024 if order <= 2 else 512)
    assert plan.blocks_per_sm * plan.tx * plan.ty <= threads
    assert 1 <= plan.zchunk <= nz
    tiles = -(-nx // plan.tx) * -(-ny // plan.ty)
    assert plan.blocks == tiles * -(-nz // plan.zchunk)
    resident = plan.blocks_per_sm * SMS
    assert plan.zchunk == -(-nz // max(1, min(nz, resident // tiles)))
    assert plan.vec == (nx % (16 // itemsize) == 0)
    assert len(plan.args()) == 7


def test_plan_choice_at_the_rod_shapes_and_256_cubed():
    got = {}
    for shape in (ROD, CUBE, FREE_ROD):
        f = torch.empty(shape)
        for order in (1, 2, 5):
            plan = kernels.conv_filter_plan(f, order)
            assert plan == kernels.conv_filter_launch_plan(order,
                                                           *shape[1:], 4)
            got[shape, order] = (plan.tx, plan.ty, plan.stages, plan.zchunk,
                                 plan.blocks, plan.blocks_per_sm, plan.vec)
    # 4 stages; 64 x 8 tiles at two blocks an SM up to order 2 (1,024
    # threads), 32 x 16 at one above (512 threads at 128 registers); the
    # one-wave chunks
    assert got[ROD, 1] == (64, 8, 4, 32, 256, 2, True)
    assert got[ROD, 2] == (64, 8, 4, 32, 256, 2, True)
    assert got[ROD, 5] == (32, 16, 4, 64, 128, 1, True)
    assert got[CUBE, 1] == (64, 8, 4, 128, 256, 2, True)
    assert got[CUBE, 5] == (32, 16, 4, 256, 128, 1, True)
    assert got[FREE_ROD, 5] == (32, 16, 4, 8, 128, 1, True)
    # order 5 at float32: an 8-value x pad, 26 rows of 48 in the ring, the
    # x-staged rows and the y-staged cells
    assert kernels.conv_filter_plan(torch.empty(ROD), 5).smem == 4 * (
        3 * 4 * 26 * 48 + 3 * 26 * 32 + 3 * 16 * 32)
    # a field 4 bytes off 16-byte alignment copies single values
    flat = torch.empty(3 * 16 * 16 * 16 + 1)
    assert not kernels.conv_filter_plan(flat[1:].view(3, 16, 16, 16), 5).vec


def test_plan_refuses_what_no_kernel_takes():
    plan_of = kernels.conv_filter_plan_of
    for order in (0, 6, -1):
        with pytest.raises(ValueError):
            kernels.conv_filter_launch_plan(order, 8, 8, 8, 4)
    with pytest.raises(ValueError):  # not a kind of the sharded planner
        sharded.sharded_stencil_plan("conv_filter", 1, 8, 8, 8, 4)
    with pytest.raises(ValueError):
        kernels.conv_filter_launch_plan(1, 8, 8, 8, 2)
    for dims in ((0, 8, 8), (8, 0, 8), (8, 8, 0)):
        with pytest.raises(ValueError):
            kernels.conv_filter_launch_plan(2, *dims, 4)
    with pytest.raises(ValueError):  # no instance
        plan_of(1, 8, 8, 64, 4, True, (16, 8), 3, 8)
    for stages, zchunk in ((2, 8), (6, 8), (3, 0), (3, 9)):
        with pytest.raises(ValueError):
            plan_of(3, 8, 8, 64, 4, True, (32, 8), stages, zchunk)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_field(shape, dtype, seed):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, dtype=dtype, device=dev, generator=g)


def _launch(f, order, plan):
    """One launch of the kernel under ``plan``: (CUDA error, out)."""
    out = torch.full_like(f, float("nan"))
    _, nz, ny, nx = f.shape
    fn = getattr(kernels.library(),
                 f"sopht_conv_filter_3d_zmarch_{kernels._SUFFIX[f.dtype]}")
    err = fn(f.data_ptr(), out.data_ptr(), nz, ny, nx, order, *plan.args(),
             torch.cuda.current_stream().cuda_stream)
    return err, out


CARD_PLANS = [(tile, stages, zchunk)
              for tile in sharded.ZMARCH_TILES
              for stages in range(sharded.ZMARCH_STAGE_RANGE[0],
                                  sharded.ZMARCH_STAGE_RANGE[1] + 1)
              for zchunk in (1, 3, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,stages,zchunk", CARD_PLANS)
def test_every_plan_matches_plain_on_card(tile, stages, zchunk):
    for shape, dtype in ((ODD, torch.float32), ((3, 34, 66, 64),
                                                torch.float64),
                         ((3, 9, 5, 24), torch.float32)):
        f = _card_field(shape, dtype, zchunk)
        flat = torch.empty(f.numel() + 1, dtype=dtype, device=f.device)
        off = flat[1:].view(shape)
        off.copy_(f)
        for order in ORDERS:
            ref = kernels.laplacian_filter_vector_3d_ref(f, order,
                                                         "convolution")
            for field in (f, off):  # 16-byte copies where they fit, and not
                plan = _plan(shape, dtype, order, tile, stages, zchunk,
                             field.data_ptr() % 16 == 0)
                err, out = _launch(field, order, plan)
                assert err == 0, (plan, order, err)
                torch.cuda.synchronize()
                assert float((out - ref).abs().max()) <= _tol(ref.cpu(),
                                                              dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    (ODD, torch.float32), ((3, 3, 3, 3), torch.float32),
    ((3, 5, 7, 9), torch.float64), ((3, 64, 64, 64), torch.float64),
    (FREE_ROD, torch.float32), (ROD, torch.float32)])
def test_wrapper_matches_plain_and_counts_on_card(shape, dtype):
    f = _card_field(shape, dtype, 1)
    fn = kernels.laplacian_filter_vector_3d
    # one launch of the z-marching kernel up to order 5; the line route's
    # two in-plane launches and one z pass an order above
    for order, launches in ((1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (6, 8)):
        before = fn.launches
        out = fn(f, order, "convolution")
        torch.cuda.synchronize()
        assert fn.launches == before + launches
        ref = kernels.laplacian_filter_vector_3d_ref(f, order, "convolution")
        assert float((out - ref).abs().max()) <= _tol(ref.cpu(), dtype)


@pytest.mark.cuda
def test_launcher_refuses_another_plan_on_card():
    shape = (3, 32, 32, 64)
    f = _card_field(shape, torch.float32, 5)
    plan = _plan(shape, torch.float32, 3, (32, 8), 3, 4)
    assert plan.vec
    assert _launch(f, 3, plan)[0] == 0
    wrongs = [plan._replace(smem=plan.smem + 16), plan._replace(stages=6),
              plan._replace(blocks=plan.blocks + 1),
              plan._replace(zchunk=0), plan._replace(zchunk=33),
              # the order-2 plan's shared bytes at order 3
              _plan(shape, torch.float32, 2, (32, 8), 3, 4)]
    # a tile with no instance, its blocks and shared bytes consistent
    wrongs.append(plan._replace(
        ty=4, blocks=2 * 8 * 8,
        smem=kernels.conv_filter_smem(3, 32, 4, plan.stages, 4)))
    for wrong in wrongs:
        assert _launch(f, 3, wrong)[0] != 0, wrong
    # no instance above order 5, or below 1
    for order in (0, 6):
        assert _launch(f, order, plan)[0] != 0
    # 16-byte copies of an x extent off 16 bytes, and of a field off
    # 16-byte alignment
    f66 = _card_field((3, 32, 32, 66), torch.float32, 5)
    plan66 = _plan(f66.shape, torch.float32, 3, (32, 8), 3, 4)
    assert not plan66.vec
    assert _launch(f66, 3, plan66._replace(vec=True))[0] != 0
    assert _launch(f66, 3, plan66)[0] == 0
    flat = torch.zeros(f.numel() + 1, device=f.device)
    off = flat[1:].view(shape)
    assert _launch(off, 3, plan)[0] != 0
    assert _launch(off, 3, plan._replace(vec=False))[0] == 0
    torch.cuda.synchronize()
