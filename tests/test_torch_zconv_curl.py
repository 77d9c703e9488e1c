"""The fast tier's z pass of the port (``fft_greens_curl_ifft_pass``,
``csrc/fft_passes.cu``): its arithmetic, its launch plan and, on the card,
the kernel.

- A plain-torch model of the ring kernel's arithmetic (m = 64 ... 512): the
  four-step factorisation m = m1 m2 of ``best_factors``, the zero-padded
  length-m2 first factor of each n1, the W_m^(n1 k2) twiddles rounded to
  float32, the length-m1 middle factor, the Green's product and the curl
  u = i s x psi at k = k2 + m2 k1, the inverse middle factor, the conjugate
  twiddles, the inverse length-m2 factor keeping n2 < m2/2, and 1/m;
  against numpy's float64 result at every ring length and, at m <= 128,
  against the JAX package's ``fft_greens_curl_ifft_pass`` (Pallas in
  interpret mode).
- The kernel's shared memory (three components' slot regions, each the
  ring stage of its component's input: a bijection, conflict-free in every
  phase, the stage inside its region and 16-byte aligned) and
  :func:`cuda_fft.zconv_curl_tile_plan`, the plan the C launcher checks:
  its invariants at every length class the gate takes, column counts from
  1 to the 256^3 solve's 131,072, aligned and storage-offset pointers, and
  what it refuses; no plan for the four-step kernel's lengths.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  ``torch.fft`` version at those lengths and column counts (the four-step
  kernel at m = 96, 100, 544, 1024), each instance, a storage-offset input,
  the launcher's refusal of other plans, and the launch counter. On the
  card, without JAX installed:
  ``python -m pytest tests/test_torch_zconv_curl.py -m cuda --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|``, as for every FFT pass: float32
rounding of two differently factored length-m DFTs (forward and inverse)
and the curl's products against float64, whose error grows like log m (the
model and the kernel sit near 2e-7).
"""

import math

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

FFT_TOL = 5e-6
LENGTHS = [64, 96, 100, 128, 256, 512, 544, 1024]
RING_LENGTHS = [64, 128, 256, 512]
COLUMNS = [1, 3, 4, 17, 512, 131072]
SMS = cuda_fft.H100_SMS


def zconv_curl_model(xr, xi, g, sym_z, sym_yx):
    """The ring kernel's arithmetic in plain torch on (3, m/2, B) float32
    pairs, the (1, m, B) Green's spectrum and the symbols, n = n1 + m1 n2
    and k = k2 + m2 k1."""
    _, h, b = xr.shape
    m = 2 * h
    m1, m2 = cuda_fft.best_factors(m)
    x = torch.complex(xr, xi).reshape(3, m2 // 2, m1, b)  # [a, n2, n1, b]
    v = torch.zeros(3, m2, m1, b, dtype=torch.complex64)
    v[:, : m2 // 2] = x  # the zero-padded half
    ang = -2.0 * math.pi * torch.outer(torch.arange(m2), torch.arange(m1)) \
        .double() / m  # [k2, n1]
    tw = torch.complex(torch.cos(ang).float(), torch.sin(ang).float())
    y = torch.fft.fft(v, dim=1) * tw[None, :, :, None]  # first factor
    spec = torch.fft.fft(y, dim=2)  # [a, k2, k1, b]
    psi = spec * g.reshape(1, m1, m2, b).transpose(1, 2)
    sz = sym_z.reshape(m1, m2).t()[:, :, None]  # [k2, k1, 1]
    sy, sx = sym_yx[0], sym_yx[1]
    u = 1j * torch.stack([sy * psi[2] - sz * psi[1],
                          sz * psi[0] - sx * psi[2],
                          sx * psi[1] - sy * psi[0]])
    z = torch.fft.ifft(u, dim=2) * m1 * tw.conj()[None, :, :, None]
    out = torch.fft.ifft(z, dim=1)[:, : m2 // 2] * m2 / m  # [a, n2, n1, b]
    out = out.reshape(3, h, b)
    return out.real.contiguous(), out.imag.contiguous()


def _np_curl(xr, xi, g, sym_z, sym_yx):
    h = xr.shape[1]
    psi = np.fft.fft(xr.astype(np.float64) + 1j * xi, n=2 * h, axis=1) * g
    sz, sy, sx = sym_z[:, None], sym_yx[0], sym_yx[1]
    u = 1j * np.stack([sy * psi[2] - sz * psi[1], sz * psi[0] - sx * psi[2],
                       sx * psi[1] - sy * psi[0]])
    out = np.fft.ifft(u, axis=1)[:, :h]
    return out.real, out.imag


def _close(outs, refs):
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        assert out.shape == np.asarray(ref).shape
        err = float(np.abs(out.astype(np.float64) - np.asarray(ref)).max())
        assert err <= FFT_TOL * scale, f"max|diff| {err} > {FFT_TOL} * {scale}"


def _sym(n, dx):
    return np.sin(2 * np.pi * np.arange(n) / n) / dx


def _inputs(m, my, bx, seed):
    """(3, m/2, B) spectra, the Green's spectrum and the curl symbols of a
    z length m and B = my * bx columns (the y axis B-major)."""
    rng = np.random.default_rng(seed)
    b, dx = my * bx, 0.02
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    sym_yx = np.stack([np.repeat(_sym(my, dx), bx),
                       np.tile(_sym(2 * bx, dx)[:bx], my)]).astype(np.float32)
    return (f32(3, m // 2, b), f32(3, m // 2, b), f32(1, m, b),
            _sym(m, dx).astype(np.float32), sym_yx)


@pytest.mark.parametrize("m", RING_LENGTHS)
def test_model_matches_numpy(m):
    args = _inputs(m, 4, 3, m)
    out = zconv_curl_model(*(torch.tensor(a) for a in args))
    _close(out, _np_curl(*args))


@pytest.mark.parametrize("m", [64, 128])
def test_model_matches_jax_pallas(m):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    args = _inputs(m, 16, 8, 100 + m)  # one lane tile of 128 columns
    assert jax_fft.conv_curl_pass_tile_ok(args[0].shape[2], m)
    ref = tuple(np.asarray(r) for r in jax_fft.fft_greens_curl_ifft_pass(
        *(jnp.asarray(a) for a in args), fast=False))
    targs = tuple(torch.tensor(a) for a in args)
    _close(zconv_curl_model(*targs), ref)
    # and the wrapper on a CPU tensor (its plain version) agrees
    _close(cuda_fft.fft_greens_curl_ifft_pass(*targs), ref)


def _slot(a, k2, n1, c, t, m1, m2):
    """The kernel's slot of component a's (k2, n1) in column c, in float2
    units."""
    rs = m1 * t + (t if t < 16 else 0)
    return a * m2 * rs + k2 * rs + n1 * t + c


def _banks(addrs, width=2):
    """Shared-memory wavefronts of one warp's accesses of ``width`` words
    (float2: 2, float: 1), addresses in those units: each request of 128
    bytes (a half-warp of float2, the warp of floats) counts its distinct
    addresses in the busiest bank."""
    per = 32 // width
    waves = 0
    for lo in range(0, 32, per):
        groups = {}
        for a in set(addrs[lo:lo + per]):
            groups.setdefault(a % per, set()).add(a)
        waves += max(len(v) for v in groups.values())
    return waves


# the kernel's instances: T columns x m1 threads
INSTANCES = [(m, t) for m in RING_LENGTHS for t in cuda_fft.ZCONV_COLUMNS]


@pytest.mark.parametrize("m,t", INSTANCES)
def test_slot_regions_are_a_conflict_free_bijection(m, t):
    m1, m2 = cuda_fft.best_factors(m)
    h, rs = m // 2, m1 * t + (t if t < 16 else 0)
    region = m2 * rs
    slots = {_slot(a, k2, n1, c, t, m1, m2) for a in range(3)
             for k2 in range(m2) for n1 in range(m1) for c in range(t)}
    assert len(slots) == 3 * m * t and max(slots) < 3 * region
    # the shared bytes the plan counts: the regions and the twiddles
    assert cuda_fft._zconv_curl_smem(m, t) == 8 * 3 * region \
        + 8 * m1 * (m2 + 1)
    # a component's input stage (h rows of t floats of re, then of im) fits
    # its region, which starts 16-byte aligned for the 16-byte copies
    assert 4 * m * t <= 8 * region and (8 * region) % 16 == 0
    lanes = [(tid % t, tid // t) for tid in range(32)]  # (c, j) of a warp
    for a in range(3):
        base = a * 2 * region  # in floats
        for n2 in range(m2 // 2):  # first factor's input: row j + m1 n2
            for im in (0, 1):
                assert _banks([base + im * h * t + (j + m1 * n2) * t + c
                               for c, j in lanes], width=1) == 1
        for k2 in range(m2):  # first and last factors: n1 = j
            assert _banks([_slot(a, k2, j, c, t, m1, m2)
                           for c, j in lanes]) == 2
        for s in range(m2 // m1):  # middle factor: k2 = j + m1 s
            for n1 in range(m1):
                assert _banks([_slot(a, j + m1 * s, n1, c, t, m1, m2)
                               for c, j in lanes]) == 2


@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "offset4"])
@pytest.mark.parametrize("b", COLUMNS)
@pytest.mark.parametrize("m", LENGTHS)
def test_zconv_curl_tile_plan_invariants(m, b, offset):
    plan = cuda_fft.zconv_curl_tile_plan(b, m, 1 << 20 | offset, SMS)
    if m not in cuda_fft.ZCONV_LENGTHS:  # the four-step kernel plans itself
        assert plan == cuda_fft.FOUR_STEP_ZCONV_PLAN
        assert plan.args() == (0,) * 6
        return
    tiles = -(-b // plan.cols)
    m1, _ = cuda_fft.best_factors(m)
    assert plan.cols in cuda_fft.ZCONV_COLUMNS
    assert plan.threads == plan.cols * m1 and plan.threads % 32 == 0
    assert 1 <= plan.blocks <= tiles
    assert plan.stages == cuda_fft.ZCONV_CURL_STAGES == 3
    assert plan.smem == cuda_fft._zconv_curl_smem(m, plan.cols)
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + cuda_fft.BLOCK_SHARED_RESERVE) \
        <= cuda_fft.SM_SHARED_BYTES
    assert plan.threads * plan.blocks_per_sm <= (256 if m >= 256 else 512)
    assert plan.blocks == min(tiles, plan.blocks_per_sm * SMS)
    assert plan.bulk == (offset == 0 and b % 4 == 0)
    if b == 131072:  # the 256^3 solve's columns fill every SM
        assert plan.blocks == plan.blocks_per_sm * SMS >= SMS


@pytest.mark.parametrize("cols", cuda_fft.ZCONV_COLUMNS)
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_zconv_curl_tile_plan_of_every_instance(m, cols):
    # each instance a sweep may ask for fills the card at 256^3's columns
    m1, _ = cuda_fft.best_factors(m)
    plan = cuda_fft.zconv_curl_columns_plan(131072, m, True, SMS, cols)
    assert (plan.cols, plan.threads, plan.stages) == (cols, cols * m1, 3)
    assert plan.blocks == plan.blocks_per_sm * SMS
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX


def test_zconv_curl_tile_plan_of_the_main_paths():
    # the 256^3 sphere's: one block of eight warps on every SM, tiles of 16
    # columns (64-byte row segments), the three regions 192 KB
    plan = cuda_fft.zconv_curl_tile_plan(131072, 512, 0, SMS)
    assert (plan.cols, plan.blocks, plan.stages, plan.threads,
            plan.smem) == (16, SMS, 3, 256, 200832)
    # the multi-body case's (128, 128, 256): the same tile at m = 256
    plan = cuda_fft.zconv_curl_tile_plan(65536, 256, 0, SMS)
    assert (plan.cols, plan.blocks, plan.threads) == (16, SMS, 256)
    # the 64^3 drag run's 8,192 columns at m = 128: 512 tiles of 16
    # columns, four blocks on most SMs
    plan = cuda_fft.zconv_curl_tile_plan(8192, 128, 0, SMS)
    assert (plan.cols, plan.blocks, plan.threads) == (16, 512, 128)
    # 1,024 columns: 64 tiles of 16 would leave SMs idle, 128 of 8 fewer
    plan = cuda_fft.zconv_curl_tile_plan(1024, 512, 0, SMS)
    assert (plan.cols, plan.blocks) == (8, 128)


@pytest.mark.parametrize("b", COLUMNS)
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_zconv_curl_tile_plan_takes_the_first_shape_that_reaches_every_sm(
        m, b):
    plan = cuda_fft.zconv_curl_tile_plan(b, m, 0, SMS)
    plans = [cuda_fft.zconv_curl_columns_plan(b, m, True, SMS, t)
             for t in cuda_fft.ZCONV_COLUMNS]
    assert plan in plans
    wide = [p for p in plans if -(-b // p.cols) >= SMS]
    if wide:
        assert plan == wide[0]
    else:
        assert plan.blocks == max(p.blocks for p in plans)


@pytest.mark.parametrize("b,m,sms", [(131072, 512, SMS), (65536, 256, SMS),
                                     (8192, 128, SMS), (1001, 256, 4),
                                     (17, 64, 4)])
def test_ring_walk_refills_each_region_for_the_next_tile(b, m, sms):
    # the persistent blocks' walk as the kernel runs it: block k takes tiles
    # k, k + blocks, ...; the input of component a of its (i + 1)-th tile is
    # asked for right after its i-th tile's last factor read region a, and
    # the three regions get three copy groups a tile, the last ones empty
    plan = cuda_fft.zconv_curl_tile_plan(b, m, 0, sms)
    tiles = -(-b // plan.cols)
    seen = []
    for blk in range(plan.blocks):
        iters = (tiles - blk + plan.blocks - 1) // plan.blocks
        groups = [(0, a) for a in range(3)]  # the prologue's copies
        for it in range(iters):
            # first factor a waits until at most 2 - a groups are pending:
            # the groups of this tile are the last three committed
            assert groups[-3:] == [(it, a) for a in range(3)]
            seen += [(blk + it * plan.blocks, a) for a in range(3)]
            groups += [(it + 1, a) for a in range(3)]  # empty past the last
        assert iters >= 1
    assert sorted(seen) == [(t, a) for t in range(tiles) for a in range(3)]


def test_zconv_curl_tile_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        cuda_fft.zconv_curl_tile_plan(0, 64, 0)
    with pytest.raises(ValueError):
        cuda_fft.zconv_curl_tile_plan(8, 30, 0)  # unsupported length
    with pytest.raises(ValueError):
        cuda_fft.zconv_curl_tile_plan(8, 2048, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(m, my, bx, seed, dev, offset=0):
    """``_inputs`` on the card, the spectra ``offset`` floats into their
    storage."""
    xr, xi, g, sz, syx = _inputs(m, my, bx, seed)

    def spectrum(v):
        flat = np.concatenate([np.zeros(offset, np.float32), v.ravel()])
        return torch.tensor(flat, device=dev)[offset:].view(v.shape)

    return (spectrum(xr), spectrum(xi),
            *(torch.tensor(v, device=dev) for v in (g, sz, syx)))


def _launch(args, out, b, m, plan):
    return cuda_fft.library().sopht_fft_greens_curl_ifft_pass_f32(
        *(t.data_ptr() for t in args + out),
        cuda_fft._table(m, args[0].device).data_ptr(), b, m, *plan.args(),
        torch.cuda.current_stream().cuda_stream)


def _ref(args):
    return [r.cpu().numpy() for r in
            cuda_fft.fft_greens_curl_ifft_pass_ref(*args)]


# (m, my, bx): B = my bx columns, 1 to 512, and the 256^3 solve's 131,072
CARD_CASES = [(m, my, bx) for m in LENGTHS
              for my, bx in ((1, 1), (1, 3), (2, 2), (17, 1), (32, 16))] \
    + [(512, 512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,my,bx", CARD_CASES)
def test_kernel_matches_plain_on_card(m, my, bx):
    dev = _card()
    args = _card_inputs(m, my, bx, m + my + bx, dev)
    before = cuda_fft.fft_greens_curl_ifft_pass.launches
    out = cuda_fft.fft_greens_curl_ifft_pass(*args)
    torch.cuda.synchronize()
    assert cuda_fft.fft_greens_curl_ifft_pass.launches == before + 1
    _close(out, _ref(args))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", cuda_fft.ZCONV_COLUMNS)
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_every_instance_matches_plain_on_card(m, cols):
    dev = _card()
    args = _card_inputs(m, 7, 143, m, dev)  # ragged: 1,001 columns
    b = 1001
    plan = cuda_fft.zconv_curl_columns_plan(b, m, False, 4, cols)  # 4 SMs'
    out = [torch.empty_like(args[0]) for _ in range(2)]
    assert _launch(list(args), out, b, m, plan) == 0
    torch.cuda.synchronize()
    _close(out, _ref(args))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 512, 1024])
def test_launcher_refuses_another_plan_on_card(m):
    dev = _card()
    b = 64
    args = list(_card_inputs(m, 8, 8, m, dev))
    out = [torch.empty_like(args[0]) for _ in range(2)]
    plan = cuda_fft.zconv_curl_tile_plan(b, m, 0)
    if m in cuda_fft.ZCONV_LENGTHS:
        wrongs = [plan._replace(stages=2), plan._replace(cols=32),
                  plan._replace(smem=plan.smem + 8),
                  plan._replace(blocks=plan.blocks + 1),
                  cuda_fft.zconv_tile_plan(3, b, m, 0),
                  cuda_fft.FOUR_STEP_ZCONV_PLAN]
    else:  # the four-step kernel takes no plan
        wrongs = [cuda_fft.zconv_curl_tile_plan(b, 512, 0)]
    for wrong in wrongs:
        assert _launch(args, out, b, m, wrong) != 0, wrong


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 256, 512, 1024])
def test_kernel_takes_a_storage_offset_on_card(m):
    dev = _card()
    args = _card_inputs(m, 7, 29, 5, dev, offset=1)  # 203 columns
    assert args[0].data_ptr() % 16 == 4
    ptr = args[0].data_ptr() | args[1].data_ptr()
    assert not cuda_fft.zconv_curl_tile_plan(203, m, ptr).bulk
    _close(cuda_fft.fft_greens_curl_ifft_pass(*args), _ref(args))
