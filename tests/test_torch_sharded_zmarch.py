"""The port's z-marching sharded stencils (``curl_zmarch_kernel``,
``rotational_zmarch_kernel`` and ``diffusion_zmarch_kernel``, the last
with and without the wall sponge, in ``csrc/stencils_3d.cu``): their walk,
their halo interface, their launch plan and, on the card, the kernels.

- A numpy model of the kernels' walk: a block a (tile, z chunk, shard),
  the chunk's planes and the two beyond it loaded row by row from the
  shard's block and the exchange's four halo buffers (``zlo``/``zhi``
  planes, ``ylo``/``yhi`` rows) into a ring of plane tiles that are NaN
  until written, each copy landing at its issue or only at the wait for
  its group; the z neighbours rolled in registers; ``q = u x w`` formed
  once per cell of a plane's tile into two alternating q tiles; the
  diffusion pair's ring keeping the plane below the centre; the sponge
  formed at each cell's in-plane clamp source where the launcher gathers,
  else scattered from each clamp source, each output cell written once;
  masks by global index. Held against the
  plain ``*_sharded_ref`` (the single-device plain ops on the assembled
  field) at every tile, ring depth and z chunk of the plan, on odd shapes
  and meshes, one-plane and one-row shards, float32 and float64, sponge
  widths 1 to 4, clamp sources in another tile and z chunk than their
  cells, with the wraparound halos at the physical walls poisoned; and
  against the JAX package's sharded functions.
- ``_halo_z_planes``, the z half of the exchange: its planes, its
  ``ppermute`` count, the concatenation of the shards between their
  planes, and each wrapper's exchange count.
- :func:`sharded_stencil_plan`, the plan the C launcher checks: its
  invariants, its choice at 256^3 on (2, 2), (4, 2) and (8, 1), and what
  it refuses.
- ``cuda`` marker (skipped without a card): each kernel against its plain
  version under every plan, the launch counter, no ghosted copy on the
  card's route, and the launcher's refusal of other plans. On the card,
  without JAX installed: ``python -m pytest
  tests/test_torch_sharded_zmarch.py -m cuda --noconftest``.

Tolerances, as the card's gates: float32 ``1e-5 max(1, |ref|max)``,
float64 ``1e-12`` (the same sums, in the plain version's order); the
curl's l1 max within ``1e-6`` relative.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
from sopht_mpi_tpu_torch.parallel import collectives
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)

FSV = [1.0, -0.5, 0.25]
SMS = sharded.H100_SMS


def _tol(ref, dtype):
    if dtype == torch.float64:
        return 1e-12
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


# ---------------------------------------------------------------------------
# the numpy model of the walk
# ---------------------------------------------------------------------------


def _row(src, s, c, z, ly, nz, ny):
    """Row ly (-1 ... ny) of plane z (-1 ... nz) of component c of shard s,
    or None where no stencil reads one (the kernel's ``halo_row``)."""
    f, zlo, zhi, ylo, yhi = src
    if ly < -1 or ly > ny:
        return None
    if z < 0 or z >= nz:
        if ly < 0 or ly == ny:
            return None
        return (zlo if z < 0 else zhi)[s, c, 0, ly]
    if ly < 0:
        return ylo[s, c, z, 0]
    if ly == ny:
        return yhi[s, c, z, 0]
    return f[s, c, z, ly]


class _Ring:
    """The block's ring of plane tiles (stages, 3 NF, TY + 2, TX + 2 V),
    NaN until written; each thread's copies of a plane form one group, and
    land at their issue (``late=False``) or when a wait retires the group
    (``late=True``)."""

    def __init__(self, stages, nc, tx, ty, v, dtype, late):
        self.t = np.full((stages, nc, ty + 2, tx + 2 * v), np.nan, dtype)
        self.tx, self.ty, self.v, self.late = tx, ty, v, late
        self.groups, self.open = [], []

    def load(self, slot, srcs, s, z, y0, x0, g):
        nz, ny, nx = g
        tx, ty, v = self.tx, self.ty, self.v
        x1 = min(x0 + tx, nx)
        for j in range(3 * len(srcs)):
            for r in range(ty + 2):
                row = _row(srcs[j // 3], s, j % 3, z, y0 - 1 + r, nz, ny)
                if row is None:
                    continue
                self._copy(slot, j, r, slice(v, v + x1 - x0), row[x0:x1])
                if 1 <= r <= ty:  # the x halo columns, no corners
                    if x0 >= 1:
                        self._copy(slot, j, r, v - 1, row[x0 - 1])
                    if x0 + tx < nx:
                        self._copy(slot, j, r, v + tx, row[x0 + tx])

    def _copy(self, slot, j, r, cols, vals):
        if self.late:
            self.open.append((slot, j, r, cols, np.copy(vals)))
        else:
            self.t[slot, j, r, cols] = vals

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait(self, pending):
        while len(self.groups) > pending:
            for slot, j, r, cols, vals in self.groups.pop(0):
                self.t[slot, j, r, cols] = vals


def _on_ring(gz, gy, x, NZ, NY, nx):
    return ((gz == 0) | (gz == NZ - 1) | (gy == 0) | (gy == NY - 1)
            | (x == 0) | (x == nx - 1))


def _clamped_to(i, n, w):
    """(lo, count): the cells [lo, lo + count) of an n-cell axis whose
    sponge clamp source is cell i (the kernel's ``clamped_to``)."""
    lo = np.where(i == w - 1, 0, np.where(i == n - w, n - w, i))
    count = np.where((i == w - 1) | (i == n - w), w,
                     np.where((i < w - 1) | (i > n - w), 0, 1))
    return lo, count


def _ramp(i, n, w, dt):
    """The sponge ramp at cell i: sin(pi/2 k / w) at distance k < w from a
    wall (computed in double, as the kernel's table), 1 inside (the
    kernel's ``ramp_at``)."""
    k = np.where(i < w, i, np.where(i > n - 1 - w, n - 1 - i, -1))
    table = np.sin(0.5 * math.pi * np.arange(w) / w).astype(dt)
    return np.where(k < 0, dt(1), table[np.maximum(k, 0)]).astype(dt)


def _in_band(i, n, w):
    return (i < w) | (i > n - 1 - w)


def zmarch_model(kind, srcs, coords, pref, plan, geom, add=None,
                 l1=False, late=False, width=0):
    """The kernel ``kind`` under ``plan`` on numpy sources (each a (f, zlo,
    zhi, ylo, yhi) tuple of (S, 3, ...) arrays): (out, per-shard l1 max or
    None). Asserts that each cell of a plane's tile forms its q once, and
    that the sponge writes each output cell once."""
    f = srcs[0][0]
    S, _, nz, ny, nx = f.shape
    NZ, NY = geom
    dt = f.dtype.type
    p = dt(pref)
    tx, ty, zc, stages = plan.tx, plan.ty, plan.zchunk, plan.stages
    v = 16 // f.itemsize
    W = tx + 2 * v
    out = np.full_like(f, np.nan)
    written = np.zeros((S, nz, ny, nx), int)
    smax = np.zeros(S, f.dtype)
    tiles_x, tiles_y = -(-nx // tx), -(-ny // ty)
    chunks = -(-nz // zc)
    assert plan.blocks == tiles_x * tiles_y * chunks * S
    c = (slice(1, ty + 1), slice(v, v + tx))  # the tile's cells

    def sh(dy, dx):
        return (slice(1 + dy, ty + 1 + dy), slice(v + dx, v + tx + dx))

    for s in range(S):
        for ti in range(tiles_x * tiles_y):
            x0, y0 = (ti % tiles_x) * tx, (ti // tiles_x) * ty
            xs = x0 + np.arange(tx)[None, :]
            ys = y0 + np.arange(ty)[:, None]
            valid = (xs < nx) & (ys < ny)
            gy = coords[s, 1] + ys
            for ci in range(chunks):
                za, zb = ci * zc, min(ci * zc + zc, nz)
                L = zb - za + 2
                ring = _Ring(stages, 3 * len(srcs), tx, ty, v, f.dtype, late)
                # the ring keeps the centre plane (and the one below it
                # with keep 2): stages - 1 - keep planes are in flight
                ahead = stages - 1 - sharded.ZMARCH_KEEP[kind]
                for k in range(ahead):
                    if k < L:
                        ring.load(k, srcs, s, za - 1 + k, y0, x0,
                                  (nz, ny, nx))
                    ring.commit()
                qt = np.full((2, 3, ty + 2, W), np.nan, f.dtype)
                formed = np.zeros((L, ty + 2, W), int)
                regs = {}
                l1_blk = dt(0)
                for k in range(L):
                    # the refill takes the stage of plane k - 1 - keep
                    ring.wait(ahead - 1)
                    kn = k + ahead
                    if kn < L:
                        ring.load(kn % stages, srcs, s, za - 1 + kn, y0, x0,
                                  (nz, ny, nx))
                    ring.commit()
                    t = ring.t[k % stages]
                    ctr = ring.t[(k - 1) % stages]
                    with np.errstate(invalid="ignore", over="ignore"):
                        if kind in ("diffusion", "sponge"):
                            if k >= 2:
                                _diffusion_step(
                                    kind, t, ctr, ring.t[(k - 2) % stages], p,
                                    s, za + k - 2, coords[s], (y0, x0),
                                    (ty, tx), valid, geom, width, out,
                                    written)
                            continue
                        if kind == "curl":
                            own = (t[0][c].copy(), t[1][c].copy())
                        else:
                            qn = qt[k & 1]
                            cells = [c]
                            if 1 <= k <= L - 2:
                                cells += [
                                    (0, slice(v, v + tx)),
                                    (ty + 1, slice(v, v + tx)),
                                    (slice(1, ty + 1), v - 1),
                                    (slice(1, ty + 1), v + tx)]
                            for cell in cells:
                                w0, w1, w2 = t[0][cell], t[1][cell], t[2][cell]
                                u0, u1, u2 = t[3][cell], t[4][cell], t[5][cell]
                                qn[0][cell] = u1 * w2 - u2 * w1
                                qn[1][cell] = u2 * w0 - u0 * w2
                                qn[2][cell] = u0 * w1 - u1 * w0
                                formed[k][cell] += 1
                            own = (qn[0][c].copy(), qn[1][c].copy())
                        if k >= 2:
                            z = za + k - 2
                            mask = _on_ring(coords[s, 0] + z, gy, xs, NZ, NY,
                                            nx)
                            am, bm = regs["m"]
                            a, b = own
                            if kind == "curl":
                                n = ctr
                                r = [p * ((n[2][sh(1, 0)] - n[2][sh(-1, 0)])
                                          - (b - bm)),
                                     p * ((a - am)
                                          - (n[2][sh(0, 1)] - n[2][sh(0, -1)])),
                                     p * ((n[1][sh(0, 1)] - n[1][sh(0, -1)])
                                          - (n[0][sh(1, 0)] - n[0][sh(-1, 0)]))]
                                r = [np.where(mask, dt(0), x) for x in r]
                                if add is not None:
                                    r = [x + dt(av) for x, av in zip(r, add)]
                                m = (np.abs(r[0]) + np.abs(r[1])) + np.abs(r[2])
                                l1_blk = max(l1_blk, m[valid].max(initial=0))
                            else:
                                qc = qt[(k - 1) & 1]
                                wc = [ctr[comp][c] for comp in range(3)]
                                r = [wc[0] + p * ((qc[2][sh(1, 0)]
                                                   - qc[2][sh(-1, 0)])
                                                  - (b - bm)),
                                     wc[1] + p * ((a - am)
                                                  - (qc[2][sh(0, 1)]
                                                     - qc[2][sh(0, -1)])),
                                     wc[2] + p * ((qc[1][sh(0, 1)]
                                                   - qc[1][sh(0, -1)])
                                                  - (qc[0][sh(1, 0)]
                                                     - qc[0][sh(-1, 0)]))]
                                r = [np.where(mask, w, x)
                                     for w, x in zip(wc, r)]
                            for comp in range(3):
                                blk = out[s, comp, z, y0:y0 + ty, x0:x0 + tx]
                                blk[...] = r[comp][:blk.shape[0], :blk.shape[1]]
                    regs["m"] = regs.get("c", own)
                    regs["c"] = own
                if kind == "rotational":
                    # each cell of a plane's tile formed its q once: the
                    # cells and halo cells of every plane that is some
                    # cell's centre, the cells alone of the two end planes
                    inner = np.zeros((ty + 2, W), int)
                    inner[c] = 1
                    halo = inner.copy()
                    halo[0, v:v + tx] = halo[ty + 1, v:v + tx] = 1
                    halo[1:ty + 1, v - 1] = halo[1:ty + 1, v + tx] = 1
                    assert (formed[0] == inner).all()
                    assert (formed[-1] == inner).all()
                    assert all((formed[k] == halo).all()
                               for k in range(1, L - 1))
                smax[s] = max(smax[s], l1_blk)
    if kind in ("diffusion", "sponge"):
        assert (written == 1).all(), "an output cell written twice or never"
    return out, (smax if l1 else None)


def sponge_gathers(nx, nyl, tx, ty, width):
    """Whether every in-plane clamp source lies in its cells' tile, so the
    sponge's kernel gathers (the launcher's ``sponge_gathers``): the low x
    and y wall bands in the first tile's columns and rows, the high ones
    with their source in the last tile's."""
    return (width <= min(tx, ty) and nx - width >= (nx - 1) // tx * tx
            and nyl - width >= (nyl - 1) // ty * ty)


def _diffusion_step(kind, t, ctr, below, p, s, z, coord, corner, tile,
                    valid, geom, width, out, written):
    """Plane z's output of a tile at ``corner`` (y0, x0): the diffusion of
    the centre plane ``ctr`` (z + 1 values from ``t``, z - 1 values from
    ``below``), stored at the cells. The sponge gathers where the launcher
    does (:func:`sponge_gathers`): each cell's diffusion formed at its
    in-plane clamp source's place in the tiles, times its ramps, and the
    source plane writes the wall band's planes; otherwise each cell's own
    diffusion is scattered from the clamp sources to the cells that clamp
    to them."""
    dt = ctr.dtype.type
    (y0, x0), (ty, tx) = corner, tile
    NZ, NY = geom
    _, _, nz, ny, nx = out.shape
    v16 = (ctr.shape[-1] - tx) // 2
    xs = x0 + np.arange(tx)[None, :]
    ys = y0 + np.arange(ty)[:, None]
    gz, gy = coord[0] + z, coord[1] + ys
    gather = kind == "sponge" and sponge_gathers(nx, ny, tx, ty, width)
    # the cell whose diffusion each thread forms: its in-plane clamp source
    # when the sponge gathers, else its own
    sx = np.clip(xs, width - 1, nx - width) if gather else xs
    sy = np.clip(gy, width - 1, NY - width) if gather else gy
    r = 1 + (sy - coord[1]) - y0 + 0 * sx
    q = v16 + (sx - x0) + 0 * sy
    mask = _on_ring(gz, sy, sx, NZ, NY, nx)
    v = []
    for comp in range(3):
        n = ctr[comp]
        centre = n[r, q]
        # the plain version's order: -6 f, then the z, y and x pairs
        lap = dt(-6) * centre
        lap = (lap + t[comp][r, q]) + below[comp][r, q]
        lap = (lap + n[r + 1, q]) + n[r - 1, q]
        lap = (lap + n[r, q + 1]) + n[r, q - 1]
        v.append(np.where(mask, centre, centre + p * lap))
    full = np.broadcast_to(valid, v[0].shape)
    zl, zn = _clamped_to(np.asarray(gz), NZ, width)
    if gather:
        rx = _ramp(xs, nx, width, dt)
        ry = _ramp(gy, NY, width, dt)
        # the source plane writes the band's planes, the planes that clamp
        # to it nothing (the whole block alike)
        for a in range(int(zn)):
            rz = _ramp(np.asarray(int(zl) + a), NZ, width, dt)
            _store(out, written, s, [((vc * rx) * ry) * rz for vc in v],
                   full, int(zl) + a - coord[0], ys, xs)
        return
    direct = full
    if kind == "sponge":
        band = (_in_band(gz, NZ, width) | _in_band(gy, NY, width)
                | _in_band(xs, nx, width))
        direct = full & ~band
        yl, yn = _clamped_to(gy, NY, width)
        xl, xn = _clamped_to(xs, nx, width)
        for a in range(width):
            for b in range(width):
                for e in range(width):
                    m = full & band & (a < zn) & (b < yn) & (e < xn)
                    if not m.any():
                        continue
                    tz = int(zl) + a
                    tyy = np.broadcast_to(yl + b, m.shape)[m]
                    txx = np.broadcast_to(xl + e, m.shape)[m]
                    rx = _ramp(txx, nx, width, dt)
                    ry = _ramp(tyy, NY, width, dt)
                    rz = _ramp(np.asarray(tz), NZ, width, dt)
                    idx = (tz - coord[0], tyy - coord[1], txx)
                    for comp in range(3):
                        # the plain version ramps along x, then y, then z
                        out[s, comp][idx] = ((v[comp][m] * rx) * ry) * rz
                    np.add.at(written[s], idx, 1)
    _store(out, written, s, v, direct, z, ys, xs)


def _store(out, written, s, vals, m, z, ys, xs):
    """vals at the cells in m of plane z."""
    idx = (np.broadcast_to(z, m.shape)[m], np.broadcast_to(ys, m.shape)[m],
           np.broadcast_to(xs, m.shape)[m])
    for comp in range(3):
        out[s, comp][idx] = vals[comp][m]
    np.add.at(written[s], idx, 1)


def _wall_poisoned(halos, mesh):
    """The four halo buffers with the wraparound ones at the physical walls
    large and wrong (never NaN): no unmasked cell may read them."""
    zlo, zhi, ylo, yhi = (h.clone() for h in halos)
    zlo[0].fill_(1e30)
    zhi[-1].fill_(1e30)
    ylo[:, 0].fill_(1e30)
    yhi[:, -1].fill_(1e30)
    return zlo, zhi, ylo, yhi


def _sharded_inputs(shape, mesh_shape, dtype, seed):
    mesh = create_mesh(3, mesh_shape, device="cpu")
    rng = np.random.default_rng(seed)
    w, u = (torch.tensor(rng.standard_normal(shape), dtype=dtype)
            for _ in range(2))
    return mesh, shard_vector_field(w, mesh), shard_vector_field(u, mesh)


def _np_srcs(fields, mesh):
    """Each field with its four (poisoned) halo buffers, as numpy arrays
    with the shard axes flattened."""
    out = []
    for f in fields:
        pz, py = f.shape[:2]
        ts = (f, *_wall_poisoned(sharded._halos(f, mesh), mesh))
        out.append(tuple(t.reshape(pz * py, *t.shape[2:]).numpy() for t in ts))
    return out


def run_model(kind, mesh, ws, us, plan, add=None, l1=False, late=False,
              pref=0.05, width=0):
    """The model's output (sharded as the wrappers return it) and the
    global l1 max."""
    pz, py, _, nzl, nyl, nx = ws.shape
    srcs = _np_srcs([ws, us] if kind == "rotational" else [ws], mesh)
    coords = sharded._coords(ws).reshape(pz * py, 2).numpy()
    out, smax = zmarch_model(kind, srcs, coords, pref, plan,
                             (pz * nzl, py * nyl), add, l1, late, width)
    out = torch.from_numpy(out).reshape(ws.shape)
    return out, (None if smax is None else float(smax.max()))


def _ref(kind, mesh, ws, us, pref, add=None, width=0):
    """The plain version of ``kind`` (and the curl's l1 max)."""
    if kind == "curl":
        addt = None if add is None else torch.tensor(add, dtype=ws.dtype)
        return sharded.curl_3d_sharded_ref(ws, pref, mesh, addt, True)
    if kind == "rotational":
        return sharded.rotational_curl_add_3d_sharded_ref(ws, us, pref,
                                                          mesh), None
    if kind == "diffusion":
        return sharded.diffusion_timestep_vector_3d_sharded_ref(
            ws, pref, mesh), None
    return sharded.diffusion_penalise_vector_3d_sharded_ref(
        ws, pref, width, mesh), None


def _check_model(kind, mesh, ws, us, plan, add, l1, late, pref=0.05,
                 width=0):
    out, l1_max = run_model(kind, mesh, ws, us, plan, add, l1, late, pref,
                            width)
    assert not torch.isnan(out).any()
    ref, l1_ref = _ref(kind, mesh, ws, us, pref, add, width)
    if l1 and l1_ref is not None:
        assert abs(l1_max - float(l1_ref)) <= 1e-6 * float(l1_ref)
    err = float((out - ref).abs().max())
    assert err <= _tol(ref, ws.dtype), f"{kind} {plan} width {width}: {err}"
    return out


def sponge_widths(shape, mesh_shape):
    """The sponge widths 1 ... 4 the launcher takes on (3, ``shape``) over
    ``mesh_shape``: each clamp source and the cells that clamp to it in one
    shard (width <= nzl, nyl), the wall bands apart (2 width < every global
    extent). The wrapper's gate is narrower (nzl, nyl >= 2 width)."""
    _, nz, ny, nx = shape
    nzl, nyl = nz // mesh_shape[0], ny // mesh_shape[1]
    return [w for w in range(1, 5)
            if w <= min(nzl, nyl) and 2 * w < min(nz, ny, nx)]


def _plan(kind, ws, tile, stages, zchunk, aligned=True):
    pz, py, _, nzl, nyl, nx = ws.shape
    return sharded.sharded_stencil_plan_of(
        kind, pz * py, nzl, nyl, nx, ws.element_size(), aligned, tile,
        stages, min(zchunk, nzl))


KINDS = ("curl", "rotational", "diffusion", "sponge")
# every tile, ring depth and z chunk the launcher takes, on a small grid
# whose tiles are ragged in x and y, eager and late copies
WALK_CASES = [(kind, tile, stages, zchunk, late)
              for kind in KINDS
              for tile in sharded.ZMARCH_TILES
              for stages in range(2 + sharded.ZMARCH_KEEP[kind], 6)
              for zchunk, late in ((1, False), (2, True), (5, False))]


@pytest.mark.parametrize("kind,tile,stages,zchunk,late", WALK_CASES)
def test_walk_of_every_plan_matches_plain(kind, tile, stages, zchunk, late):
    mesh, ws, us = _sharded_inputs((3, 10, 26, 70), (2, 2), torch.float32,
                                   seed=stages + zchunk)
    plan = _plan(kind, ws, tile, stages, zchunk)
    # the sponge at widths 2, 1, 2 (nzl = 5: the gate takes 1 and 2)
    _check_model(kind, mesh, ws, us, plan, add=FSV, l1=True, late=late,
                 width=1 + zchunk % 2)


ODD = (3, 34, 66, 65)
# (shape, mesh, dtype): the card phase's odd grid on three meshes, a
# one-plane shard (nzl = 1), a one-row shard (nyl = 1), x a multiple of
# 16 bytes' values (the 16-byte copies' case) and the single shard
SHAPE_CASES = [
    (ODD, (2, 2), torch.float32), (ODD, (2, 3), torch.float64),
    (ODD, (17, 1), torch.float32), ((3, 4, 12, 40), (4, 2), torch.float64),
    ((3, 8, 4, 36), (2, 4), torch.float32), ((3, 6, 9, 64), (1, 1),
                                              torch.float64),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,mesh_shape,dtype", SHAPE_CASES)
def test_walk_of_the_chosen_plan_at_odd_shapes(kind, shape, mesh_shape,
                                               dtype):
    mesh, ws, us = _sharded_inputs(shape, mesh_shape, dtype, seed=3)
    pz, py, _, nzl, nyl, nx = ws.shape
    plan = sharded.sharded_stencil_plan(kind, pz * py, nzl, nyl, nx,
                                        ws.element_size())
    assert plan.vec == (nx % (16 // ws.element_size()) == 0)
    # the sponge at every width 1 ... 4 the launcher takes (one-plane and
    # one-row shards: width 1, where the wrapper's gate sends the sponge to
    # the assembled field instead)
    widths = sponge_widths(shape, mesh_shape) if kind == "sponge" else [0]
    assert widths
    for width in widths:
        _check_model(kind, mesh, ws, us, plan, add=FSV, l1=True, late=True,
                     width=width)
    # one whole-shard chunk, and another tile and ring depth, copies eager
    plan = _plan(kind, ws, (64, 4), 4, nzl)
    _check_model(kind, mesh, ws, us, plan, add=FSV, l1=True, late=False,
                 width=widths[-1])


def test_sponge_scatter_crosses_tiles_and_chunks():
    """At (3, 34, 66, 65) on (2, 2), nyl = 33: the shard's last row
    (global 65) sits alone in its 8-row tile and, from width 2, clamps to a
    row of the tile before it, and the last x column (64) clamps to a
    column of the tile before its own; with z chunks of 1 and 2 planes the
    wall band's planes and their source plane lie in different chunks. The
    sources write across all three."""
    mesh, ws, us = _sharded_inputs(ODD, (2, 2), torch.float32, seed=8)
    pz, py, _, nzl, nyl, nx = ws.shape
    for zchunk in (1, 2):
        plan = _plan("sponge", ws, (64, 8), 4, zchunk)
        for width in (2, 3, 4):
            assert sharded.diffusion_penalise_sharded_supported(
                ODD, mesh, width)
            # the last row's source lies in another y tile, a plane of a
            # wall band in another z chunk than its source
            src = (2 * nyl - width) - nyl
            assert src // plan.ty != (nyl - 1) // plan.ty
            assert ((width - 1) // zchunk != 0
                    or (nzl - width) // zchunk != (nzl - 1) // zchunk)
            # so the launcher takes the scattering instance
            assert not sponge_gathers(nx, nyl, plan.tx, plan.ty, width)
            _check_model("sponge", mesh, ws, us, plan, None, False,
                         late=True, width=width)


@pytest.mark.parametrize("add,l1", [(None, False), (FSV, False),
                                    (None, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_curl_walk_with_and_without_add_and_l1(add, l1, dtype):
    mesh, ws, us = _sharded_inputs(ODD, (2, 3), dtype, seed=11)
    plan = _plan("curl", ws, (32, 8), 3, 4)
    out = _check_model("curl", mesh, ws, us, plan, add, l1, late=True,
                       pref=8.0)
    # the CPU route of the wrapper, on the same buffers, agrees
    res = sharded.curl_3d_sharded(ws, 8.0, mesh, add, compute_l1_max=l1)
    res = res[0] if l1 else res
    assert float((res - out).abs().max()) <= _tol(out, dtype)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_shape,precision", [
    ((4, 2), "single"), ((2, 4), "double"), ((8, 1), "single")])
def test_model_matches_jax_sharded(kind, mesh_shape, precision):
    import jax.numpy as jnp

    import sopht_mpi_tpu.ops.pallas_stencils_sharded as pss
    from sopht_mpi_tpu.parallel import create_mesh as jax_create_mesh
    from sopht_mpi_tpu.parallel import shard_vector_field as jax_shard

    shape = (3, 16, 32, 128)
    dtype = torch.float32 if precision == "single" else torch.float64
    rng = np.random.default_rng(21)
    w, u = (rng.standard_normal(shape).astype(
        np.float32 if precision == "single" else np.float64)
        for _ in range(2))
    jmesh = jax_create_mesh(3, mesh_shape)
    jw, ju = jax_shard(jnp.asarray(w), jmesh), jax_shard(jnp.asarray(u),
                                                         jmesh)
    mesh = create_mesh(3, mesh_shape, device="cpu")
    ws, us = (shard_vector_field(torch.tensor(a), mesh) for a in (w, u))
    pz, py, _, nzl, nyl, nx = ws.shape
    plan = sharded.sharded_stencil_plan(kind, pz * py, nzl, nyl, nx,
                                        ws.element_size())
    if kind == "curl":
        ref, l1_ref = pss.curl_3d_sharded(
            jw, jnp.asarray(8.0, w.dtype), jmesh,
            add_vector=jnp.asarray(FSV, w.dtype), compute_l1_max=True)
        out, l1 = run_model(kind, mesh, ws, us, plan, FSV, True, True, 8.0)
        assert abs(l1 - float(l1_ref)) <= 1e-6 * float(l1_ref)
    elif kind == "rotational":
        ref = pss.rotational_curl_add_3d_sharded(
            jw, ju, jnp.asarray(0.05, w.dtype), jmesh)
        out, _ = run_model(kind, mesh, ws, us, plan, late=True)
    elif kind == "diffusion":
        ref = pss.diffusion_timestep_vector_3d_sharded(
            jw, jnp.asarray(0.37, w.dtype), jmesh)
        out, _ = run_model(kind, mesh, ws, us, plan, late=True, pref=0.37)
    else:
        # the widths of the JAX comparison in test_torch_stencils_3d_sharded
        # where both gates are open
        width = {(4, 2): 2, (2, 4): 3, (8, 1): 1}[mesh_shape]
        assert sharded.diffusion_penalise_sharded_supported(shape, mesh,
                                                            width)
        ref = pss.diffusion_penalise_vector_3d_sharded(
            jw, jnp.asarray(0.37, w.dtype), width, jmesh)
        out, _ = run_model(kind, mesh, ws, us, plan, late=True, pref=0.37,
                           width=width)
    ref = np.asarray(ref)
    err = float(np.abs(unshard_vector_field(out, mesh).numpy() - ref).max())
    assert err <= (1e-13 if precision == "double"
                   else 1e-5 * max(1.0, float(np.abs(ref).max())))


# ---------------------------------------------------------------------------
# the halo interface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 3), (1, 3), (4, 1)])
def test_halo_z_planes(mesh_shape):
    pz, py = mesh_shape
    mesh = create_mesh(3, mesh_shape, device="cpu")
    f = torch.arange(3 * 4 * pz * 2 * py * 5, dtype=torch.float64).reshape(
        3, 4 * pz, 2 * py, 5)
    fs = shard_vector_field(f, mesh)
    collectives.reset_counts()
    zlo, zhi = sharded._halo_z_planes(fs, mesh)
    assert collectives.ppermute.calls == (2 if pz > 1 else 0)
    assert zlo.shape == zhi.shape == (pz, py, 3, 1, 2, 5)
    assert zlo.is_contiguous() and zhi.is_contiguous()
    for i in range(pz):
        for j in range(py):
            rows = slice(2 * j, 2 * j + 2)
            # the previous shard's last plane, the next shard's first
            # (wrapping around at the walls)
            assert torch.equal(zlo[i, j][:, 0], f[:, (4 * i - 1) % (4 * pz),
                                                  rows])
            assert torch.equal(zhi[i, j][:, 0], f[:, (4 * i + 4) % (4 * pz),
                                                  rows])
    # the shards between their z halo planes: planes -1 ... nzl of each
    # shard, the previous and next shards' planes at the ends
    fg = torch.cat([zlo, fs, zhi], dim=3)
    nzl = 4
    for i in range(pz):
        for j in range(py):
            rows = slice(2 * j, 2 * j + 2)
            planes = [(4 * i - 1 + k) % (4 * pz) for k in range(nzl + 2)]
            assert torch.equal(fg[i, j], f[:, planes, rows])
    # the wrappers exchange each field's four buffers once
    collectives.reset_counts()
    sharded.curl_3d_sharded(fs, 0.5, mesh)
    n_field = (2 if pz > 1 else 0) + (2 if py > 1 else 0)
    assert collectives.ppermute.calls == n_field
    collectives.reset_counts()
    sharded.rotational_curl_add_3d_sharded(fs, fs, 0.5, mesh)
    assert collectives.ppermute.calls == 2 * n_field
    collectives.reset_counts()
    sharded.diffusion_timestep_vector_3d_sharded(fs, 0.1, mesh)
    assert collectives.ppermute.calls == n_field
    collectives.reset_counts()
    sharded.diffusion_penalise_vector_3d_sharded(fs, 0.1, 1, mesh)
    assert collectives.ppermute.calls == n_field


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 1, 1, 1), (4, 17, 33, 65), (4, 1, 33, 64), (4, 33, 1, 64),
               (6, 17, 22, 65), (17, 2, 66, 65), (4, 128, 128, 256),
               (8, 64, 128, 256), (8, 32, 256, 256), (64, 512, 8, 1024)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims", PLAN_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_invariants(kind, itemsize, dims, aligned):
    s, nzl, nyl, nx = dims
    plan = sharded.sharded_stencil_plan(kind, s, nzl, nyl, nx, itemsize,
                                        aligned, SMS)
    assert (plan.tx, plan.ty) == sharded.ZMARCH_TILE
    assert plan.stages == sharded.ZMARCH_STAGES[kind]
    assert plan.smem == sharded.zmarch_smem(kind, plan.tx, plan.ty,
                                            plan.stages, itemsize)
    assert plan.smem <= sharded.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + sharded.BLOCK_SHARED_RESERVE) \
        <= sharded.SM_SHARED_BYTES
    assert plan.blocks_per_sm * plan.tx * plan.ty \
        <= sharded.ZMARCH_SM_THREADS
    assert 1 <= plan.zchunk <= nzl
    tiles = -(-nx // plan.tx) * -(-nyl // plan.ty) * s
    chunks = -(-nzl // plan.zchunk)
    assert plan.blocks == tiles * chunks
    # one wave: as many chunks as the resident blocks hold, at least one,
    # at most nzl
    resident = plan.blocks_per_sm * SMS
    wanted = max(1, min(nzl, resident // tiles))
    assert plan.zchunk == -(-nzl // wanted)
    assert plan.blocks <= max(resident, tiles)
    assert plan.vec == (aligned and nx % (16 // itemsize) == 0)
    assert len(plan.args()) == 7


def test_plan_choice_at_256_cubed():
    n = 256
    got = {}
    for mesh in ((2, 2), (4, 2), (8, 1)):
        for kind in ("curl", "rotational"):
            plan = sharded.sharded_stencil_plan(
                kind, mesh[0] * mesh[1], n // mesh[0], n // mesh[1], n, 4)
            got[mesh, kind] = (plan.zchunk, plan.blocks, plan.blocks_per_sm,
                               plan.smem, plan.vec)
    # 64 x 8 tiles: 64 a shard at (2, 2); the launch bound's 1,024 threads
    # an SM hold two blocks, 264 on the card, so every tile marches its
    # shard's 128 planes in one wave; on (4, 2) and (8, 1) the tiles alone
    # exceed a wave: one chunk too
    assert got[(2, 2), "curl"] == (128, 256, 2, 34560, True)
    assert got[(2, 2), "rotational"] == (128, 256, 2, 69120, True)
    assert got[(4, 2), "curl"] == (64, 512, 2, 34560, True)
    assert got[(4, 2), "rotational"] == (64, 512, 2, 69120, True)
    assert got[(8, 1), "curl"] == (32, 1024, 2, 34560, True)
    assert got[(8, 1), "rotational"] == (32, 1024, 2, 69120, True)
    # the diffusion pair: the same tile and waves, five ring stages (the
    # walk keeps two planes); the sponge's in-plane sources lie in their
    # cells' tiles at width 2, so its launcher gathers
    for mesh in ((2, 2), (4, 2), (8, 1)):
        nzl, nyl = n // mesh[0], n // mesh[1]
        for kind in ("diffusion", "sponge"):
            plan = sharded.sharded_stencil_plan(
                kind, mesh[0] * mesh[1], nzl, nyl, n, 4)
            assert (plan.tx, plan.ty, plan.stages) == (64, 8, 5)
            assert (plan.zchunk, plan.blocks, plan.blocks_per_sm, plan.smem,
                    plan.vec) == (got[mesh, "curl"][0],
                                  got[mesh, "curl"][1], 2, 43200, True)
        assert sponge_gathers(n, nyl, plan.tx, plan.ty, 2)


def test_plan_refuses_what_no_kernel_takes():
    plan_of = sharded.sharded_stencil_plan_of
    with pytest.raises(ValueError):
        sharded.sharded_stencil_plan("laplacian_filter", 4, 8, 8, 8, 4)
    for kind in KINDS:
        with pytest.raises(ValueError):
            sharded.sharded_stencil_plan(kind, 4, 8, 8, 8, 2)  # half
        for dims in ((0, 8, 8, 8), (4, 0, 8, 8), (4, 8, 0, 8), (4, 8, 8, 0)):
            with pytest.raises(ValueError):
                sharded.sharded_stencil_plan(kind, *dims, 4)
        with pytest.raises(ValueError):
            plan_of(kind, 4, 8, 8, 64, 4, True, (16, 8), 3, 8)  # no instance
        for stages, zchunk in ((2, 8), (6, 8), (3, 0), (3, 9)):
            with pytest.raises(ValueError):
                plan_of(kind, 4, 8, 8, 64, 4, True, (32, 8), stages, zchunk)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(shape, mesh_shape, dtype, seed):
    dev = _card()
    mesh = create_mesh(3, mesh_shape, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    w, u = (torch.randn(shape, dtype=dtype, device=dev, generator=g)
            for _ in range(2))
    return mesh, shard_vector_field(w, mesh), shard_vector_field(u, mesh)


def _launch(kind, mesh, ws, us, plan, pref, add=None, l1=None, width=0):
    """One launch of the kernel under ``plan``: (CUDA error, out)."""
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as single

    out = torch.empty_like(ws)
    geo = sharded._geometry(ws)
    stream = torch.cuda.current_stream().cuda_stream
    lib, suffix = single.library(), single._SUFFIX[ws.dtype]
    coords = sharded._coords(ws).data_ptr()
    if kind == "curl":
        halos = sharded._halos(ws, mesh)
        err = getattr(lib, f"sopht_curl_3d_sharded_zmarch_{suffix}")(
            ws.data_ptr(), *(t.data_ptr() for t in halos), coords,
            pref.data_ptr(), None if add is None else add.data_ptr(),
            out.data_ptr(), None if l1 is None else l1.data_ptr(), *geo,
            *plan.args(), stream)
    elif kind == "rotational":
        fields = (ws, *sharded._halos(ws, mesh), us, *sharded._halos(us, mesh))
        err = getattr(lib,
                      f"sopht_rotational_curl_add_3d_sharded_zmarch_{suffix}")(
            *(t.data_ptr() for t in fields), coords,
            pref.data_ptr(), out.data_ptr(), *geo, *plan.args(), stream)
    elif kind == "diffusion":
        fields = (ws, *sharded._halos(ws, mesh))
        err = getattr(lib,
                      f"sopht_diffusion_vector_3d_sharded_zmarch_{suffix}")(
            *(t.data_ptr() for t in fields), coords, pref.data_ptr(),
            out.data_ptr(), *geo, *plan.args(), stream)
    else:
        fields = (ws, *sharded._halos(ws, mesh))
        ramp = single._sponge_ramp(max(width, 1), ws.dtype, ws.device)
        err = getattr(
            lib, f"sopht_diffusion_penalise_vector_3d_sharded_zmarch_{suffix}")(
            *(t.data_ptr() for t in fields), coords, pref.data_ptr(),
            ramp.data_ptr(), out.data_ptr(), *geo, width, *plan.args(),
            stream)
    return err, out


CARD_PLANS = [(kind, tile, stages, zchunk) for kind in KINDS
              for tile in sharded.ZMARCH_TILES
              for stages in range(2 + sharded.ZMARCH_KEEP[kind], 6)
              for zchunk in (1, 3, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tile,stages,zchunk", CARD_PLANS)
def test_every_plan_matches_plain_on_card(kind, tile, stages, zchunk):
    for shape, mesh_shape, dtype in ((ODD, (2, 2), torch.float32),
                                     ((3, 34, 66, 64), (2, 3), torch.float64)):
        mesh, ws, us = _card_inputs(shape, mesh_shape, dtype, seed=zchunk)
        pref = torch.tensor(0.05, dtype=dtype, device=ws.device)
        add = torch.tensor(FSV, dtype=dtype, device=ws.device)
        # the sponge at widths 1 ... 4 (the gate is open at all four)
        widths = range(1, 5) if kind == "sponge" else [0]
        for aligned, width in itertools.product((True, False), widths):
            assert kind != "sponge" or \
                sharded.diffusion_penalise_sharded_supported(shape, mesh,
                                                             width)
            plan = _plan(kind, ws, tile, stages, zchunk, aligned)
            l1 = torch.zeros(mesh.axis_sizes, dtype=dtype, device=ws.device)
            err, out = _launch(kind, mesh, ws, us, plan, pref, add, l1, width)
            assert err == 0, (plan, err)
            torch.cuda.synchronize()
            ref, l1_ref = _ref(kind, mesh, ws, us, pref, add, width)
            if kind == "curl":
                assert abs(float(l1.max()) - float(l1_ref)) \
                    <= 1e-6 * float(l1_ref)
            assert float((out - ref).abs().max()) <= _tol(ref.cpu(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mesh_shape,dtype", SHAPE_CASES + [
    ((3, 256, 256, 256), (2, 2), torch.float32),
    ((3, 256, 256, 256), (4, 2), torch.float32),
    ((3, 256, 256, 256), (8, 1), torch.float32),
    ((3, 64, 64, 64), (64, 1), torch.float32)])
def test_wrappers_match_plain_and_count_on_card(shape, mesh_shape, dtype,
                                                monkeypatch):
    mesh, ws, us = _card_inputs(shape, mesh_shape, dtype, seed=1)
    widths = [w for w in range(1, 5)
              if sharded.diffusion_penalise_sharded_supported(shape, mesh, w)]
    wrappers = (sharded.curl_3d_sharded,
                sharded.rotational_curl_add_3d_sharded,
                sharded.diffusion_timestep_vector_3d_sharded,
                sharded.diffusion_penalise_vector_3d_sharded)
    before = [fn.launches for fn in wrappers]

    def no_cat(*args, **kwargs):
        raise AssertionError("a ghosted copy on the card's route")

    # no wrapper concatenates its field with its halos on the card
    monkeypatch.setattr(torch, "cat", no_cat)
    out, l1 = sharded.curl_3d_sharded(ws, 0.05, mesh, FSV,
                                      compute_l1_max=True)
    rot = sharded.rotational_curl_add_3d_sharded(ws, us, 0.05, mesh)
    dif = sharded.diffusion_timestep_vector_3d_sharded(ws, 0.37, mesh)
    spo = [sharded.diffusion_penalise_vector_3d_sharded(ws, 0.37, w, mesh)
           for w in widths]
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(wrappers, before)] == \
        [1, 1, 1, len(widths)]
    add = torch.tensor(FSV, dtype=dtype)
    ref, l1_ref = sharded.curl_3d_sharded_ref(ws, 0.05, mesh,
                                              add.to(ws.device), True)
    assert l1.ndim == 0 and l1.device == ws.device
    assert abs(float(l1) - float(l1_ref)) <= 1e-6 * float(l1_ref)
    assert float((out - ref).abs().max()) <= _tol(ref.cpu(), dtype)
    ref = sharded.rotational_curl_add_3d_sharded_ref(ws, us, 0.05, mesh)
    assert float((rot - ref).abs().max()) <= _tol(ref.cpu(), dtype)
    ref = sharded.diffusion_timestep_vector_3d_sharded_ref(ws, 0.37, mesh)
    assert float((dif - ref).abs().max()) <= _tol(ref.cpu(), dtype)
    for w, res in zip(widths, spo):
        ref = sharded.diffusion_penalise_vector_3d_sharded_ref(ws, 0.37, w,
                                                               mesh)
        assert float((res - ref).abs().max()) <= _tol(ref.cpu(), dtype), w
    if not widths:
        # the closed gate (one-plane and one-row shards): the sharded
        # diffusion, then the sponge on the assembled field
        res = sharded.diffusion_penalise_vector_3d_sharded(ws, 0.37, 2, mesh)
        ref = sharded.diffusion_penalise_vector_3d_sharded_ref(ws, 0.37, 2,
                                                               mesh)
        assert float((res - ref).abs().max()) <= _tol(ref.cpu(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_launcher_refuses_another_plan_on_card(kind):
    mesh, ws, us = _card_inputs((3, 32, 32, 64), (2, 2), torch.float32, 5)
    pref = torch.tensor(0.05, device=ws.device)
    width = 2 if kind == "sponge" else 0
    low = 2 + sharded.ZMARCH_KEEP[kind]  # the fewest ring stages it takes
    plan = _plan(kind, ws, (32, 8), low, 4)
    assert plan.vec
    wrongs = [plan._replace(smem=plan.smem + 16), plan._replace(stages=6),
              plan._replace(stages=low - 1),
              plan._replace(blocks=plan.blocks + 1),
              plan._replace(zchunk=0), plan._replace(zchunk=17)]
    # a tile with no instance, its blocks and shared bytes consistent
    pz, py, _, nzl, nyl, nx = ws.shape
    wrongs.append(plan._replace(
        ty=4, blocks=-(-nx // 32) * -(-nyl // 4) * -(-nzl // plan.zchunk)
        * pz * py, smem=sharded.zmarch_smem(kind, 32, 4, plan.stages, 4)))
    for wrong in wrongs:
        assert _launch(kind, mesh, ws, us, wrong, pref,
                       width=width)[0] != 0, wrong
    if kind == "sponge":
        # widths whose scatter would leave the shard or join the wall bands
        for wrong in (0, -1, nzl + 1, 16):
            assert _launch(kind, mesh, ws, us, plan, pref,
                           width=wrong)[0] != 0, wrong
    # 16-byte copies of an x extent off 16 bytes
    mesh, ws, us = _card_inputs((3, 32, 32, 66), (2, 2), torch.float32, 5)
    plan = _plan(kind, ws, (32, 8), low, 4)
    assert not plan.vec
    assert _launch(kind, mesh, ws, us, plan._replace(vec=True), pref,
                   width=width)[0] != 0
    assert _launch(kind, mesh, ws, us, plan, pref, width=width)[0] == 0
    torch.cuda.synchronize()
