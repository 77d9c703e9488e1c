"""The fast tier's x-edge c2r of the port (``irfft_pass_merge_velocity``,
``csrc/fft_passes.cu``): its arithmetic, its launch plan and walk and, on
the card, the kernel.

- A plain-torch model of the ring kernel (``irfft_edge_kernel<H, true>``):
  the persistent walk over (row tile, component) units, each unit's merge
  step with W_m^k rounded to float32, the m/2-point inverse as
  conj(FFT(conj Z)), the interleave and 1/m, then the epilogue in the emit
  sink's order (the row's wall test and x against 0 and n_out - 1, the free
  stream added) and, at c = 2, (|u_0| + |u_1|) + |u_2| of each live cell
  folded into the maximum. Against numpy's float64 result at every ring
  length and, at m = 64 and 128, against the JAX package's
  ``irfft_pass_merge_velocity`` (Pallas in interpret mode; on grids whose
  row count the Pallas kernel does not tile, its jnp oracle
  ``_merge_velocity_ref``), with tiles that span z planes and end ragged, a
  negative free-stream component and Im X[0], Im X[m/2] not zero.
- :func:`cuda_fft.c2r_velocity_tile_plan`, the plan the C launcher checks:
  its invariants at every length class the gate takes, row counts from 1 to
  the 256^3 sphere's 65,536, aligned and storage-offset pointers, odd
  ``n_out``; the walk covering every (tile, component) unit once for 1 to
  ``blocks_per_sm * 132`` blocks, with its ring parities and staging
  buffers; what the plan refuses.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  version at every ring length and at m = 96 and 544 (the kept four-step
  kernel), rows up to 65,536, with the launch counter; a storage-offset
  input; the launcher refusing other plans; an all-wall grid (nz = 2),
  where ``l1_max`` is sum |fsv|; the largest |u|_1 in the ragged last tile
  of component 2. On the card, without JAX installed:
  ``python -m pytest tests/test_torch_edge_c2r_velocity.py -m cuda
  --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|`` for ``u`` and ``5e-6`` relative for
``l1_max``, as ``chip_smoke.py`` holds the kernel: float32 rounding of two
differently factored DFTs of length <= 1024, whose error grows like log m
(the model sits near 1e-7 of numpy's float64).
"""

import math

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

FFT_TOL = 5e-6
RING_LENGTHS = [64, 128, 256, 512, 1024]
LENGTHS = [64, 96, 100, 128, 256, 512, 544, 1024]
ROWS = [1, 3, 4, 35, 256, 16384, 65536]
SMS = cuda_fft.H100_SMS
FSV = (1.0, -0.5, 0.25)


def _inputs(m, nz, ny, seed, fsv=FSV):
    """(3, R, m/2) bulk and (3, R, 1) Nyquist pairs, R = nz ny, and the free
    stream, as numpy float32; Im X[0] and Im X[m/2] not zero."""
    rng = np.random.default_rng(seed)
    rows, h = nz * ny, m // 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    br, bi, sr, si = f(3, rows, h), f(3, rows, h), f(3, rows, 1), \
        f(3, rows, 1)
    assert np.all(bi[..., 0] != 0) and np.all(si != 0)
    return br, bi, sr, si, np.array(fsv, np.float32)


def _walk(blocks, ntiles):
    """The kernel's walk: each block's units (it, tile, component), the
    component inner."""
    for b in range(blocks):
        units, it = [], 0
        while b + (it // 3) * blocks < ntiles:
            units.append((it, b + (it // 3) * blocks, it % 3))
            it += 1
        yield units


def _c2r_rows(re, im, xh, m):
    """One unit's c2r of (T, m/2) rows and their Nyquist values, the kernel's
    arithmetic: Im X[0] and Im X[h] taken as 0, Xe = X[k] + conj X[h-k], Xo =
    (X[k] - conj X[h-k]) conj W, W = W_m^k rounded to float32, Z = Xe + i Xo,
    F = FFT_h(conj Z), y[2n] = Re F[n] / m, y[2n+1] = -Im F[n] / m."""
    h = m // 2
    k = torch.arange(h)
    ar, ai = re, im.clone()
    ai[:, 0] = 0.0
    hk = (h - k) % h
    cr = torch.where(k == 0, xh[:, None], re[:, hk])
    ci = torch.where(k == 0, 0.0, ai[:, hk])
    ang = -2.0 * math.pi * k.double() / m
    wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
    er, ei = ar + cr, ai - ci
    dr, di = ar - cr, ai + ci
    odr, odi = dr * wr + di * wi, di * wr - dr * wi
    f = torch.fft.fft(torch.complex(er - odi, -(ei + odr)), dim=1)
    inv_m = torch.tensor(1.0 / m, dtype=torch.float32)
    return torch.stack([f.real * inv_m, -f.imag * inv_m], dim=2) \
        .reshape(re.shape[0], m)


def velocity_model(br, bi, sr, fsv, m, n_out, ny, nz, plan):
    """The ring kernel in plain torch, unit by unit along ``plan``'s walk:
    ``(u (3, R, n_out), l1_max)``."""
    rows = br.shape[1]
    t = plan.rows
    out = torch.full((3, rows, n_out), float("nan"))
    best = torch.tensor(0.0)
    x = torch.arange(n_out)
    for units in _walk(plan.blocks, -(-rows // t)):
        for _, tile, c in units:
            r = torch.arange(tile * t, min(rows, tile * t + t))
            z, y = r // ny, r % ny
            wall = ((z == 0) | (z == nz - 1) | (y == 0) | (y == ny - 1))[:, None] \
                | (x == 0)[None] | (x == n_out - 1)[None]
            v = _c2r_rows(br[c, r], bi[c, r], sr[c, r, 0], m)[:, :n_out]
            v = torch.where(wall, fsv[c], v + fsv[c])
            out[c, r] = v
            if c == 2:
                s = out[0, r].abs() + out[1, r].abs() + v.abs()
                best = torch.maximum(best, s.max())
    return out, best


def _np_velocity(br, bi, sr, fsv, m, n_out, ny, nz):
    """float64 numpy: the c2r (Im X[0], Im X[m/2] dropped), the ring zeroed,
    the free stream added, max of sum_c |u_c|."""
    h = m // 2
    re = np.concatenate([br, sr], axis=2).astype(np.float64)
    im = np.concatenate([bi, np.zeros_like(sr)], axis=2).astype(np.float64)
    im[..., 0] = 0.0
    u = np.fft.irfft(re + 1j * im, n=m, axis=2)[..., :n_out]
    assert u.shape[2] == n_out and re.shape[2] == h + 1
    u = u.reshape(3, nz, ny, n_out)
    ring = lambda n: (np.arange(n) > 0) & (np.arange(n) < n - 1)
    mask = ring(nz)[:, None, None] & ring(ny)[None, :, None] \
        & ring(n_out)[None, None, :]
    u = np.where(mask, u, 0.0) + fsv.astype(np.float64).reshape(3, 1, 1, 1)
    return u.reshape(3, nz * ny, n_out), np.abs(u).sum(axis=0).max()


def _close(u, l1, ref_u, ref_l1):
    u = u.cpu().numpy() if torch.is_tensor(u) else np.asarray(u)
    ref_u = np.asarray(ref_u)
    assert u.shape == ref_u.shape and np.isfinite(u).all()
    scale = float(np.abs(ref_u).max())
    err = float(np.abs(u.astype(np.float64) - ref_u).max())
    assert err <= FFT_TOL * scale, f"u: max|diff| {err} > {FFT_TOL} * {scale}"
    l1, ref_l1 = float(l1), float(ref_l1)
    rel = abs(l1 - ref_l1) / ref_l1
    assert rel <= FFT_TOL, f"l1_max: relative {rel} > {FFT_TOL}"


# (nz, ny, sms): tiles that span z planes and end ragged, several tiles a
# block, one tile a block
GRIDS = [(5, 7, SMS), (9, 12, 2), (4, 16, 1)]


@pytest.mark.parametrize("n_out", ["half", "half-1", "3"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_model_matches_numpy(m, grid, n_out):
    nz, ny, sms = grid
    n = {"half": m // 2, "half-1": m // 2 - 1, "3": 3}[n_out]
    br, bi, sr, si, fsv = _inputs(m, nz, ny, m + nz)
    plan = cuda_fft.c2r_velocity_tile_plan(nz * ny, n, m, 0, sms)
    assert plan.rows % 4 == 0 and plan.blocks >= 1
    u, l1 = velocity_model(*(torch.tensor(a) for a in (br, bi, sr, fsv)),
                           m, n, ny, nz, plan)
    _close(u, l1, *_np_velocity(br, bi, sr, fsv, m, n, ny, nz))


def _jax_velocity(args, m, n_out, ny, nz):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    rows = nz * ny
    jargs = [jnp.asarray(a) for a in args]
    if jax_fft.merge_velocity_epilogue_ok(rows, m // 2, n_out):
        u, l1 = jax_fft.irfft_pass_merge_velocity(*jargs, m, n_out, ny, nz)
    else:  # no row tile of the Pallas kernel: its jnp oracle
        u, l1 = jax_fft._merge_velocity_ref(*jargs, m, n_out, ny, nz)
    return np.asarray(u), float(l1)


# (nz, ny, Pallas kernel or not): 192 rows in tiles of 8 that span z planes
# (the Pallas kernel's rows are a multiple of 64); 35 rows, ragged
JAX_GRIDS = [(16, 12, True), (5, 7, False)]


@pytest.mark.parametrize("fsv", [FSV, (-2.0, 0.0, 3.5)], ids=["fsv", "fsv2"])
@pytest.mark.parametrize("n_out", ["half", "half-1"])
@pytest.mark.parametrize("grid", JAX_GRIDS, ids=["pallas", "ragged"])
@pytest.mark.parametrize("m", [64, 128])
def test_model_matches_jax(m, grid, n_out, fsv):
    nz, ny, pallas = grid
    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    n = {"half": m // 2, "half-1": m // 2 - 1}[n_out]
    assert jax_fft.merge_velocity_epilogue_ok(nz * ny, m // 2, n) == pallas
    args = _inputs(m, nz, ny, 7 * m + nz, fsv)
    ref_u, ref_l1 = _jax_velocity(args, m, n, ny, nz)
    plan = cuda_fft.c2r_velocity_tile_plan(nz * ny, n, m, 0)
    # tiles span z planes: some tile holds rows of two planes
    assert any((t * plan.rows) // ny != (t * plan.rows + plan.rows - 1) // ny
               for t in range(-(-nz * ny // plan.rows)))
    br, bi, sr, si, f = (torch.tensor(a) for a in args)
    u, l1 = velocity_model(br, bi, sr, f, m, n, ny, nz, plan)
    _close(u, l1, ref_u, ref_l1)
    # and the wrapper on CPU tensors (its plain version) agrees, launching
    # nothing
    before = cuda_fft.irfft_pass_merge_velocity.launches
    u, l1 = cuda_fft.irfft_pass_merge_velocity(br, bi, sr, si, f, m, n, ny,
                                               nz)
    assert cuda_fft.irfft_pass_merge_velocity.launches == before
    _close(u, l1, ref_u, ref_l1)


def _spans_aligned(plan, rows, n_out, m):
    """Every span a bulk copy or store moves, for every component and tile,
    starts 16-byte aligned and is a multiple of 16 bytes (base pointers
    aligned)."""
    t, h = plan.rows, m // 2
    for c in range(3):
        for row0 in range(0, rows - t + 1, t):  # full tiles only
            for floats, length in ((c * rows * h + row0 * h, t * h),
                                   (c * rows + row0, t),
                                   (c * rows * n_out + row0 * n_out,
                                    t * n_out)):
                if (4 * floats) % 16 or (4 * length) % 16:
                    return False
    return True


@pytest.mark.parametrize("n_out", ["half", "odd"])
@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "offset4"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("m", LENGTHS)
def test_velocity_plan_invariants(m, rows, offset, n_out):
    n = m // 2 if n_out == "half" else m // 2 - 1
    ptr = 1 << 20 | offset
    plan = cuda_fft.c2r_velocity_tile_plan(rows, n, m, ptr, SMS)
    if m & (m - 1):  # the four-step kernel plans its own launch
        assert plan == cuda_fft.FOUR_STEP_VELOCITY_PLAN
        assert plan.args() == (0,) * 6
        return
    # the c2r ring kernel's plan for the same rows (its shared memory)
    c2r = cuda_fft.c2r_tile_plan(rows, n, m, False, ptr, SMS)
    assert plan._replace(bulk=c2r.bulk) == c2r
    tiles = -(-rows // plan.rows)
    assert plan.rows % 4 == 0 and 1 <= plan.blocks <= tiles
    assert plan.blocks <= plan.blocks_per_sm * SMS
    assert plan.smem == cuda_fft._c2r_smem(m // 2, plan.rows, n, plan.stages,
                                           False)
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + cuda_fft.BLOCK_SHARED_RESERVE) \
        <= cuda_fft.SM_SHARED_BYTES
    assert 2 <= plan.stages <= 4
    assert plan.bulk == (offset == 0 and rows % 4 == 0)
    if plan.bulk:
        assert _spans_aligned(plan, min(rows, 4096), n, m)


@pytest.mark.parametrize("m,grid", [(512, (256, 256)), (512, (128, 128)),
                                    (128, (64, 64))],
                         ids=["sphere256", "multibody", "drag64"])
def test_velocity_plan_on_the_main_paths(m, grid):
    nz, ny = grid
    plan = cuda_fft.c2r_velocity_tile_plan(nz * ny, m // 2, m, 0, SMS)
    tiles = -(-nz * ny // plan.rows)
    assert plan.bulk and plan.rows == 8
    assert plan.blocks == min(tiles, plan.blocks_per_sm * SMS)
    if m == 512:  # three blocks of four warps an SM, a two-stage ring
        assert (plan.threads, plan.blocks_per_sm, plan.stages) == (128, 3, 2)


@pytest.mark.parametrize("rows,m", [(1000, 64), (35, 512), (16384, 512),
                                    (4097, 128)])
def test_walk_covers_every_unit_once(rows, m):
    plan = cuda_fft.c2r_velocity_tile_plan(rows, m // 2, m, 0, SMS)
    ntiles = -(-rows // plan.rows)
    for blocks in range(1, plan.blocks_per_sm * SMS + 1):
        seen = {}
        for units in _walk(blocks, ntiles):
            for i, (it, tile, c) in enumerate(units):
                assert (tile, c) not in seen
                seen[tile, c] = it
            # a tile's three units are consecutive, the component inner
            assert [c for _, _, c in units] == [0, 1, 2] * (len(units) // 3)
            # the ragged tile, if any, is the block's last
            ragged = [i for i, (_, t, _) in enumerate(units)
                      if (t + 1) * plan.rows > rows]
            assert not ragged or ragged == list(range(len(units) - 3,
                                                      len(units)))
        assert len(seen) == 3 * ntiles


def test_walk_ring_parities_and_staging_buffers():
    """Along a block's walk, stage it % S is armed once a use, so the parity
    the kernel waits for, (it / S) & 1, is its phase count mod 2; at c = 2
    the staging buffer it & 1 is c = 0's and the other one c = 1's."""
    for stages in (2, 3, 4):
        for units in _walk(3, 20):
            phases = [0] * stages
            for it, _, c in units:
                assert (it // stages) & 1 == phases[it % stages] & 1
                phases[it % stages] += 1
                if c == 2:
                    assert (it & 1) == ((it - 2) & 1) != ((it - 1) & 1)


def test_velocity_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        cuda_fft.c2r_velocity_tile_plan(4, 33, 64, 0)  # outputs past m/2
    with pytest.raises(ValueError):
        cuda_fft.c2r_velocity_tile_plan(4, 0, 64, 0)
    with pytest.raises(ValueError):
        cuda_fft.c2r_velocity_tile_plan(0, 32, 64, 0)
    with pytest.raises(ValueError):
        cuda_fft.c2r_velocity_tile_plan(4, 16, 30, 0)  # unsupported length


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_args(m, nz, ny, seed, dev, fsv=FSV):
    return [torch.tensor(a, device=dev) for a in _inputs(m, nz, ny, seed, fsv)]


def _card_close(args, m, n_out, ny, nz):
    fn = cuda_fft.irfft_pass_merge_velocity
    before = fn.launches
    u, l1 = fn(*args, m, n_out, ny, nz)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref_u, ref_l1 = cuda_fft.irfft_pass_merge_velocity_ref(*args, m, n_out,
                                                           ny, nz)
    _close(u, l1, ref_u.cpu().numpy(), ref_l1)
    return l1


# (nz, ny): ragged and z-spanning tiles, R not a multiple of 4, the 256^3
# sphere's rows
CARD_GRIDS = [(1, 1), (5, 7), (4, 16), (61, 67), (256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", CARD_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("m", RING_LENGTHS + [96, 544])
def test_kernel_matches_plain_on_card(m, grid):
    dev = _card()
    nz, ny = grid
    args = _card_args(m, nz, ny, m + nz, dev)
    for n_out in (m // 2, m // 2 - 1, 3):
        _card_close(args, m, n_out, ny, nz)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 128, 512])
def test_kernel_takes_a_storage_offset_on_card(m):
    dev = _card()
    nz, ny, h = 9, 12, m // 2
    rows = nz * ny
    flat = [torch.tensor(np.random.default_rng(s).standard_normal(
        3 * rows * n + 1).astype(np.float32), device=dev)
        for s, n in ((5, h), (6, h), (7, 1))]
    br, bi, sr = (f[1:].view(3, rows, -1) for f in flat)  # 4 bytes off
    assert br.data_ptr() % 16 == 4 and br.is_contiguous()
    si = torch.randn(3, rows, 1, device=dev)
    fsv = torch.tensor(FSV, device=dev)
    ptr = br.data_ptr() | bi.data_ptr() | sr.data_ptr()
    assert not cuda_fft.c2r_velocity_tile_plan(rows, h, m, ptr).bulk
    _card_close([br, bi, sr, si, fsv], m, h, ny, nz)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 512])
def test_all_wall_grid_on_card(m):
    dev = _card()
    fsv = (0.5, -2.0, 0.25)
    args = _card_args(m, 2, 9, 3, dev, fsv)
    l1 = _card_close(args, m, m // 2, 9, 2)
    assert float(l1) == np.float32(np.float32(0.5 + 2.0) + np.float32(0.25))


def _ragged_interior_row(m, ny):
    """(nz, row): a grid of ``ny`` rows a plane whose plan ends in a ragged
    tile holding a row off the walls."""
    for nz in range(3, 10000):
        rows = nz * ny
        t = cuda_fft.c2r_velocity_tile_plan(rows, m // 2, m, 0).rows
        if rows % t:
            for r in range(rows - rows % t, rows):
                if 0 < r // ny < nz - 1 and 0 < r % ny < ny - 1:
                    return nz, r
    raise AssertionError("no such grid")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 512])
def test_largest_l1_in_the_ragged_tile_of_component_2_on_card(m):
    dev = _card()
    ny = 3
    nz, row = _ragged_interior_row(m, ny)
    args = _card_args(m, nz, ny, 11, dev)
    for a in args[:3]:
        a[2, row] *= 1000.0
    l1 = _card_close(args, m, m // 2, ny, nz)
    ref_u, _ = cuda_fft.irfft_pass_merge_velocity_ref(*args, m, m // 2, ny,
                                                      nz)
    sums = ref_u.abs().sum(dim=0)
    assert int(sums.max(dim=1).values.argmax()) == row
    assert float(l1) > 10 * float(sums[:row].max())


def _launch(args, out, l1, m, n_out, ny, nz, plan):
    lib = cuda_fft.library()
    br, bi, sr, _, fsv = args
    return lib.sopht_irfft_pass_merge_velocity_f32(
        br.data_ptr(), bi.data_ptr(), sr.data_ptr(), fsv.data_ptr(),
        out.data_ptr(), l1.data_ptr(), cuda_fft._table(m, br.device)
        .data_ptr(), nz * ny, m, n_out, ny, nz, *plan.args(),
        torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 512, 1024])
def test_launcher_refuses_another_plan_on_card(m):
    dev = _card()
    nz, ny, n_out = 8, 8, m // 2
    args = _card_args(m, nz, ny, 7, dev)
    out = torch.empty(3, nz * ny, n_out, device=dev)
    l1 = torch.zeros((), device=dev)
    plan = cuda_fft.c2r_velocity_tile_plan(nz * ny, n_out, m, 0)
    assert _launch(args, out, l1, m, n_out, ny, nz, plan) == 0
    torch.cuda.synchronize()
    if plan.stages:  # the ring kernel
        wrongs = [plan._replace(rows=plan.rows + 4),
                  plan._replace(smem=plan.smem + 8),
                  plan._replace(threads=2 * plan.threads),
                  plan._replace(stages=5), plan._replace(blocks=0),
                  plan._replace(blocks=plan.blocks + 1),
                  cuda_fft.FOUR_STEP_VELOCITY_PLAN]
    else:  # the four-step kernel takes its own (all-zero) plan only
        wrongs = [cuda_fft.c2r_velocity_tile_plan(nz * ny, 256, 512, 0)]
    for wrong in wrongs:
        assert _launch(args, out, l1, m, n_out, ny, nz, wrong) != 0, wrong
    # bulk copies where R is not a multiple of 4: refused
    nz, ny = 5, 7
    args = _card_args(m, nz, ny, 8, dev)
    out = torch.empty(3, nz * ny, n_out, device=dev)
    plan = cuda_fft.c2r_velocity_tile_plan(nz * ny, n_out, m, 0)
    if plan.stages:
        assert not plan.bulk
        assert _launch(args, out, l1, m, n_out, ny, nz,
                       plan._replace(bulk=True)) != 0
