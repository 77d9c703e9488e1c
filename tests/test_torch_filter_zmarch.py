"""The port's single-device z-marching filter pass
(``mult_filter_zmarch_kernel`` in ``csrc/stencils_3d.cu``, one launch per
application of ``laplacian_filter_vector_3d(..., "multiplicative")``): its
walk, its launch plan and, on the card, the kernel.

- A numpy model of the kernel's walk: a block a (tile, z chunk), the
  chunk's planes and the two beyond it loaded copy item by copy item as the
  plan cuts them (rows in 16-byte runs or single values, then the x halo
  columns of every tile row, the corners included), rows -1 and ny and
  planes -1 and nz never loaded (no halo buffers on one device), into a
  ring of plane tiles that are NaN until written, each copy landing at its
  issue or only at the wait for its group; clear . H_x of each plane's tile
  rows into a scratch tile, clear . H_y at each cell rolled through three
  registers, and the plane below written as res, buf - res (orig the field
  itself, its centre value read from the ring) or orig - res (another
  field), every output cell once. Held against the port's plain
  ``laplacian_filter_vector_3d_ref`` at every tile and ring depth of the
  plan and several z chunks, at odd shapes ((3, 17, 33, 65), (3, 3, 3, 3),
  nz = 4 with one-plane chunks, ragged x and y tiles), float32 and float64,
  orders 1, 2 and 3.
- The port's plain version against the JAX package's
  ``laplacian_filter_vector_3d_pallas`` (multiplicative, interpret mode)
  on the same numpy-seeded fields.
- The plan (:func:`filter_plan`, kind ``"filter"`` of
  ``sharded_stencil_plan`` on one shard): its invariants, its choice at the
  rod's (3, 256, 64, 256) and at 256^3, and what it refuses.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  version under every plan, the wrapper's launch count, and the launcher's
  refusal of another plan. On the card, without JAX installed: ``python -m
  pytest tests/test_torch_filter_zmarch.py -m cuda --noconftest``.

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


def _tol(ref, dtype):
    if dtype == torch.float64:
        return 1e-12
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _fields(shape, dtype, seed, n=2):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype)
            for _ in range(n)]


def _plan(shape, dtype, tile, stages, zchunk, aligned=True):
    _, nz, ny, nx = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    return sharded.sharded_stencil_plan_of(
        "filter", 1, nz, ny, nx, itemsize, aligned, tile, stages,
        min(zchunk, nz))


# ---------------------------------------------------------------------------
# the numpy model of the walk
# ---------------------------------------------------------------------------


def copy_items(plan, x0, y0, shape, itemsize):
    """The copy items of the tile at (x0, y0) as the kernel's TileCopies
    cut them: (component, tile row, tile column, values). The rows first
    (16-byte runs with ``vec``, else single values), then the x halo
    columns of rows 0 ... TY + 1, the corners included; nothing on rows -1
    and ny, which a single device has no buffer for."""
    _, nz, ny, nx = shape
    tx, ty = plan.tx, plan.ty
    v, rows = 16 // itemsize, ty + 2
    run = v if plan.vec else 1
    items = []
    for halo in (False, True):
        per_row = 2 if halo else tx // run
        for item in range(3 * rows * per_row):
            q, rest = item % per_row, item // per_row
            r, j = rest % rows, rest // rows
            x = (x0 + tx if q else x0 - 1) if halo else x0 + q * run
            ly = y0 - 1 + r
            if x < 0 or x >= nx or ly < 0 or ly >= ny:
                continue
            n = 1 if halo else run
            assert x + n <= nx, "a 16-byte run past the row's end"
            items.append((j, r, v + x - x0, n))
    return items


class _Ring:
    """The block's ring of plane tiles (stages, 3, TY + 2, TX + 2 V), NaN
    until written; a plane's copies form one group, landing at their issue
    (``late=False``) or when a wait retires the group (``late=True``)."""

    def __init__(self, plan, v, dtype, late):
        self.t = np.full((plan.stages, 3, plan.ty + 2, plan.tx + 2 * v),
                         np.nan, dtype)
        self.v, self.late = v, late
        self.groups, self.open = [], []

    def load(self, slot, buf, z, y0, x0, items):
        if z < 0 or z >= buf.shape[1]:
            return  # no z plane buffers on one device
        for j, r, col, n in items:
            x = x0 + col - self.v
            vals = buf[j, z, y0 - 1 + r, x:x + n]
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


def filter_pass_model(buf, orig, plan, late=False):
    """One launch of the kernel under ``plan`` on numpy fields: res, or
    ``buf - res`` where ``orig is buf``, or ``orig - res``. Asserts that
    every output cell is written once."""
    _, nz, ny, nx = buf.shape
    dt = buf.dtype.type
    tx, ty, zc_, stages = plan.tx, plan.ty, plan.zchunk, plan.stages
    v = 16 // buf.itemsize
    tiles_x, tiles_y = -(-nx // tx), -(-ny // ty)
    chunks = -(-nz // zc_)
    assert plan.blocks == tiles_x * tiles_y * chunks
    assert plan.smem == buf.itemsize * (
        3 * stages * (ty + 2) * (tx + 2 * v) + 3 * (ty + 2) * tx)
    out = np.full_like(buf, np.nan)
    written = np.zeros(buf.shape[1:], int)
    mode = 0 if orig is None else (1 if orig is buf else 2)
    ahead = stages - 1 - sharded.ZMARCH_KEEP["filter"]
    for ti in range(tiles_x * tiles_y):
        x0, y0 = (ti % tiles_x) * tx, (ti // tiles_x) * ty
        xs = x0 + np.arange(tx)[None, :]
        ys = y0 + np.arange(ty)[:, None]
        valid = (xs < nx) & (ys < ny)
        inner = (xs >= 1) & (xs <= nx - 2) & (ys >= 1) & (ys <= ny - 2)
        lys = y0 - 1 + np.arange(ty + 2)[:, None]
        in_hx = (xs >= 1) & (xs <= nx - 2) & (lys >= 1) & (lys <= ny - 2)
        items = copy_items(plan, x0, y0, buf.shape, buf.itemsize)
        for ci in range(chunks):
            za, zb = ci * zc_, min(ci * zc_ + zc_, nz)
            L = zb - za + 2
            ring = _Ring(plan, v, buf.dtype, late)
            for k in range(ahead):
                if k < L:
                    ring.load(k, buf, za - 1 + k, y0, x0, items)
                ring.commit()
            tm = tc = np.zeros((3, ty, tx), buf.dtype)
            for k in range(L):
                ring.wait(ahead - 1)
                kn = k + ahead
                if kn < L:
                    ring.load(kn % stages, buf, za - 1 + kn, y0, x0, items)
                ring.commit()
                t = ring.t[k % stages]
                z = za - 1 + k
                tn = np.zeros((3, ty, tx), buf.dtype)
                with np.errstate(invalid="ignore", over="ignore"):
                    if 1 <= z <= nz - 2:
                        # clear . H_x of the tile rows and the halo rows
                        hx = np.where(in_hx, _hp(t[:, :, v:v + tx],
                                                 t[:, :, v + 1:v + tx + 1],
                                                 t[:, :, v - 1:v + tx - 1],
                                                 dt), dt(0))
                        # then clear . H_y at each cell
                        tn = np.where(inner, _hp(hx[:, 1:ty + 1],
                                                 hx[:, 2:ty + 2],
                                                 hx[:, 0:ty], dt), dt(0))
                    if k >= 2:
                        zc = z - 1
                        interior = inner & (1 <= zc <= nz - 2)
                        res = np.where(interior, _hp(tc, tn, tm, dt), dt(0))
                        if mode == 1:
                            c = ring.t[(k - 1) % stages]
                            res = c[:, 1:ty + 1, v:v + tx] - res
                        ysv, xsv = np.nonzero(valid)
                        gy, gx = ys[ysv, 0], xs[0, xsv]
                        vals = res[:, ysv, xsv]
                        if mode == 2:
                            vals = orig[:, zc, gy, gx] - vals
                        out[:, zc, gy, gx] = vals
                        np.add.at(written, (zc, gy, gx), 1)
                tm, tc = tc, tn
    assert (written == 1).all(), "an output cell written twice or never"
    return out


def filter_model(f, order, plan, late=False):
    """``laplacian_filter_vector_3d(f, order, "multiplicative")`` as the
    wrapper launches it: ``order`` passes, the last subtracting from ``f``
    (the field itself at order 1)."""
    buf = f
    for it in range(order):
        buf = filter_pass_model(buf, f if it == order - 1 else None, plan,
                                late)
    return buf


def _check_model(shape, dtype, plan, order, late, seed=0):
    f, _ = _fields(shape, dtype, seed)
    out = filter_model(f.numpy(), order, plan, late)
    assert not np.isnan(out).any()
    ref = kernels.laplacian_filter_vector_3d_ref(f, order, "multiplicative")
    err = float(np.abs(out - ref.numpy()).max())
    assert err <= _tol(ref, dtype), f"{shape} {plan} order {order}: {err}"
    return err


ODD = (3, 17, 33, 65)
# every tile and ring depth the launcher takes, three z chunks, eager and
# late copies, on the odd grid (ragged x and y tiles)
WALK_CASES = [(tile, stages, zchunk, late)
              for tile in sharded.ZMARCH_TILES
              for stages in range(2 + sharded.ZMARCH_KEEP["filter"],
                                  sharded.ZMARCH_STAGE_RANGE[1] + 1)
              for zchunk, late in ((1, True), (4, False), (17, True))]


@pytest.mark.parametrize("tile,stages,zchunk,late", WALK_CASES)
def test_walk_of_every_plan_matches_plain(tile, stages, zchunk, late):
    plan = _plan(ODD, torch.float32, tile, stages, zchunk)
    # the plain version's arithmetic in its order: exact at float32
    assert _check_model(ODD, torch.float32, plan, 1, late,
                        seed=stages + zchunk) == 0.0


# (shape, dtype, order): a single interior cell, nz = 4 (one-plane chunks
# below), nx a multiple of 16 bytes' values (16-byte copies), ragged x and
# y tiles, thin axes
SHAPE_CASES = [
    ((3, 3, 3, 3), torch.float32, 1), ((3, 3, 3, 3), torch.float64, 2),
    ((3, 4, 9, 12), torch.float64, 1), ((3, 4, 10, 64), torch.float32, 3),
    (ODD, torch.float64, 2), ((3, 6, 20, 36), torch.float32, 2),
    ((3, 5, 7, 9), torch.float32, 3), ((3, 9, 2, 40), torch.float64, 1),
    ((3, 1, 5, 8), torch.float32, 1),
]


@pytest.mark.parametrize("shape,dtype,order", SHAPE_CASES)
def test_walk_of_the_chosen_plan_at_odd_shapes(shape, dtype, order):
    _, nz, ny, nx = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = sharded.sharded_stencil_plan("filter", 1, nz, ny, nx, itemsize)
    assert plan.vec == (nx % (16 // itemsize) == 0)
    _check_model(shape, dtype, plan, order, late=True)
    # one-plane chunks and another tile and ring depth, copies eager
    plan = _plan(shape, dtype, (32, 16), 5, 1)
    _check_model(shape, dtype, plan, order, late=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_orig_is_the_field_or_another(dtype):
    """A pass with no orig (res), with orig the buffer itself (buf - res,
    the centre value from the ring) and with another field (orig - res),
    against the plain passes."""
    buf, other = _fields(ODD, dtype, 5)
    plan = _plan(ODD, dtype, (64, 8), 4, 3)
    res = kernels.mult_filter_pass_ref(buf)
    for orig, ref in ((None, res), ("buf", buf - res), (other, other - res)):
        b = buf.numpy()
        o = b if orig == "buf" else (None if orig is None
                                      else orig.numpy())
        out = filter_pass_model(b, o, plan, late=True)
        err = float(np.abs(out - ref.numpy()).max())
        assert err <= _tol(ref, dtype)


def test_copy_items_cover_the_tile_once():
    """Every tile cell of a plane inside the field, the corners included,
    is the target of exactly one copy item; no item reaches a row or plane
    beyond the field."""
    for shape, tile, vec in ((ODD, (64, 8), False), ((3, 4, 20, 64),
                                                     (32, 8), True)):
        plan = _plan(shape, torch.float32, tile, 4, 2)
        assert plan.vec == vec
        _, nz, ny, nx = shape
        tiles_x = -(-nx // plan.tx)
        for ti in range(tiles_x * -(-ny // plan.ty)):
            x0, y0 = (ti % tiles_x) * plan.tx, (ti // tiles_x) * plan.ty
            hits = np.zeros((3, plan.ty + 2, plan.tx + 8), int)
            for j, r, col, n in copy_items(plan, x0, y0, shape, 4):
                hits[j, r, col:col + n] += 1
            ly = y0 - 1 + np.arange(plan.ty + 2)[:, None]
            x = x0 - 4 + np.arange(plan.tx + 8)[None, :]
            inside = ((ly >= 0) & (ly < ny) & (x >= x0 - 1)
                      & (x <= x0 + plan.tx) & (x >= 0) & (x < nx))
            assert (hits == inside[None]).all()


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [ODD, (3, 3, 3, 3), (3, 4, 16, 24)])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_plain_matches_jax_pallas(shape, order, np_dtype):
    import jax.numpy as jnp

    from sopht_mpi_tpu.ops.pallas_stencils_3d import (
        laplacian_filter_vector_3d_pallas,
    )

    f = np.random.default_rng(order).standard_normal(shape).astype(np_dtype)
    ref = np.asarray(laplacian_filter_vector_3d_pallas(
        jnp.asarray(f), order, "multiplicative", interpret=True))
    out = kernels.laplacian_filter_vector_3d_ref(torch.tensor(f), order,
                                                 "multiplicative").numpy()
    assert out.dtype == ref.dtype
    err = float(np.abs(out - ref).max())
    tol = (1e-12 if np_dtype == np.float64
           else 1e-5 * max(1.0, float(np.abs(ref).max())))
    assert err <= tol
    # the wrapper's CPU route is the plain version
    assert torch.equal(
        kernels.laplacian_filter_vector_3d(torch.tensor(f), order,
                                           "multiplicative"),
        torch.tensor(out))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 1, 1), (3, 3, 3), (17, 33, 65), (4, 9, 12), (256, 64, 256),
               (256, 256, 256), (128, 32, 128), (64, 64, 64), (512, 8, 1024)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims", PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_invariants(itemsize, dims, aligned):
    nz, ny, nx = dims
    plan = sharded.sharded_stencil_plan("filter", 1, nz, ny, nx, itemsize,
                                        aligned, SMS)
    assert (plan.tx, plan.ty) == sharded.ZMARCH_TILE
    assert plan.stages == sharded.ZMARCH_STAGES["filter"]
    v = 16 // itemsize
    tile = (plan.ty + 2) * (plan.tx + 2 * v)
    assert plan.smem == itemsize * (3 * plan.stages * tile
                                    + 3 * (plan.ty + 2) * plan.tx)
    assert plan.smem == sharded.zmarch_smem("filter", plan.tx, plan.ty,
                                            plan.stages, itemsize)
    assert plan.smem <= sharded.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + sharded.BLOCK_SHARED_RESERVE) \
        <= sharded.SM_SHARED_BYTES
    assert plan.blocks_per_sm * plan.tx * plan.ty <= sharded.ZMARCH_SM_THREADS
    assert 1 <= plan.zchunk <= nz
    tiles = -(-nx // plan.tx) * -(-ny // plan.ty)
    chunks = -(-nz // plan.zchunk)
    assert plan.blocks == tiles * chunks
    # one wave: as many chunks as the resident blocks hold, at least one,
    # at most nz
    resident = plan.blocks_per_sm * SMS
    assert plan.zchunk == -(-nz // max(1, min(nz, resident // tiles)))
    assert plan.vec == (aligned and nx % v == 0)
    assert len(plan.args()) == 7


def test_plan_choice_at_the_rod_shape_and_256_cubed():
    got = {}
    for shape in (ROD, (3, 256, 256, 256)):
        f = torch.empty(shape)
        plan = kernels.filter_plan(f)
        assert plan == sharded.sharded_stencil_plan("filter", 1, *shape[1:],
                                                    4)
        got[shape] = (plan.tx, plan.ty, plan.stages, plan.zchunk,
                      plan.blocks, plan.blocks_per_sm, plan.smem, plan.vec)
    # 64 x 8 tiles, two blocks an SM (the launch bound's 1,024 threads), 264
    # on the card: the rod's 32 tiles march 8 chunks of 32 planes, 256^3's
    # 128 tiles two chunks of 128
    smem = 4 * (3 * 4 * 10 * 72 + 3 * 10 * 64)
    assert got[ROD] == (64, 8, 4, 32, 256, 2, smem, True)
    assert got[(3, 256, 256, 256)] == (64, 8, 4, 128, 256, 2, smem, True)
    # a field 4 bytes off 16-byte alignment copies single values
    flat = torch.empty(3 * 16 * 16 * 16 + 1)
    assert not kernels.filter_plan(flat[1:].view(3, 16, 16, 16)).vec


def test_plan_refuses_what_no_kernel_takes():
    plan_of = sharded.sharded_stencil_plan_of
    with pytest.raises(ValueError):
        sharded.sharded_stencil_plan("filter", 1, 8, 8, 8, 2)  # half
    for dims in ((0, 8, 8), (8, 0, 8), (8, 8, 0)):
        with pytest.raises(ValueError):
            sharded.sharded_stencil_plan("filter", 1, *dims, 4)
    with pytest.raises(ValueError):
        plan_of("filter", 1, 8, 8, 64, 4, True, (16, 8), 3, 8)  # no instance
    for stages, zchunk in ((2, 8), (6, 8), (3, 0), (3, 9)):
        with pytest.raises(ValueError):
            plan_of("filter", 1, 8, 8, 64, 4, True, (32, 8), stages, zchunk)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_fields(shape, dtype, seed):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, dtype=dtype, device=dev, generator=g)
            for _ in range(2)]


def _launch(buf, orig, plan):
    """One launch of the kernel under ``plan``: (CUDA error, out)."""
    out = torch.empty_like(buf)
    _, nz, ny, nx = buf.shape
    fn = getattr(kernels.library(),
                 f"sopht_mult_filter_3d_zmarch_{kernels._SUFFIX[buf.dtype]}")
    err = fn(buf.data_ptr(), None if orig is None else orig.data_ptr(),
             out.data_ptr(), nz, ny, nx, *plan.args(),
             torch.cuda.current_stream().cuda_stream)
    return err, out


CARD_PLANS = [(tile, stages, zchunk)
              for tile in sharded.ZMARCH_TILES
              for stages in range(2 + sharded.ZMARCH_KEEP["filter"],
                                  sharded.ZMARCH_STAGE_RANGE[1] + 1)
              for zchunk in (1, 3, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,stages,zchunk", CARD_PLANS)
def test_every_plan_matches_plain_on_card(tile, stages, zchunk):
    for shape, dtype in ((ODD, torch.float32), ((3, 34, 66, 64),
                                                torch.float64)):
        buf, other = _card_fields(shape, dtype, zchunk)
        res = kernels.mult_filter_pass_ref(buf)
        for aligned in (True, False):
            plan = _plan(shape, dtype, tile, stages, zchunk, aligned)
            for orig, ref in ((None, res), (buf, buf - res),
                              (other, other - res)):
                err, out = _launch(buf, orig, plan)
                assert err == 0, (plan, err)
                torch.cuda.synchronize()
                assert float((out - ref).abs().max()) <= _tol(ref.cpu(),
                                                              dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    (ODD, torch.float32), ((3, 3, 3, 3), torch.float32),
    ((3, 64, 64, 64), torch.float64), (ROD, torch.float32),
    ((3, 256, 256, 256), torch.float32)])
def test_wrapper_matches_plain_and_counts_on_card(shape, dtype):
    f, _ = _card_fields(shape, dtype, 1)
    fn = kernels.laplacian_filter_vector_3d
    for order in (1, 2, 3):
        before = fn.launches
        out = fn(f, order, "multiplicative")
        torch.cuda.synchronize()
        assert fn.launches == before + order
        ref = kernels.laplacian_filter_vector_3d_ref(f, order,
                                                     "multiplicative")
        assert float((out - ref).abs().max()) <= _tol(ref.cpu(), dtype)


@pytest.mark.cuda
def test_launcher_refuses_another_plan_on_card():
    shape = (3, 32, 32, 64)
    buf, _ = _card_fields(shape, torch.float32, 5)
    plan = _plan(shape, torch.float32, (32, 8), 3, 4)
    assert plan.vec
    wrongs = [plan._replace(smem=plan.smem + 16), plan._replace(stages=6),
              plan._replace(stages=2), plan._replace(blocks=plan.blocks + 1),
              plan._replace(zchunk=0), plan._replace(zchunk=33),
              # the sharded kernels' shared bytes (no H_x tile)
              plan._replace(smem=4 * 3 * 3 * 10 * 40)]
    # a tile with no instance, its blocks and shared bytes consistent
    wrongs.append(plan._replace(
        ty=4, blocks=2 * 8 * 8,
        smem=sharded.zmarch_smem("filter", 32, 4, plan.stages, 4)))
    for wrong in wrongs:
        assert _launch(buf, buf, wrong)[0] != 0, wrong
    # 16-byte copies of an x extent off 16 bytes, and of a field off
    # 16-byte alignment
    buf66, _ = _card_fields((3, 32, 32, 66), torch.float32, 5)
    plan66 = _plan(buf66.shape, torch.float32, (32, 8), 3, 4)
    assert not plan66.vec
    assert _launch(buf66, None, plan66._replace(vec=True))[0] != 0
    assert _launch(buf66, None, plan66)[0] == 0
    flat = torch.zeros(buf.numel() + 1, device=buf.device)
    off = flat[1:].view(shape)
    assert _launch(off, None, plan)[0] != 0
    assert _launch(off, None, plan._replace(vec=False))[0] == 0
    torch.cuda.synchronize()
