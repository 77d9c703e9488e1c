"""The z conv of the port (``fft_greens_ifft_pass``, ``csrc/fft_passes.cu``):
its arithmetic, its launch plan and, on the card, the kernel.

- A plain-torch model of the ring kernel's arithmetic (m = 64 ... 512): the
  four-step factorisation m = m1 m2 of ``best_factors``, the zero-padded
  length-m2 first factor of each n1, the W_m^(n1 k2) twiddles rounded to
  float32, the length-m1 middle factor with the Green's product and its
  inverse, the conjugate twiddles, the inverse length-m2 factor keeping
  n2 < m2/2, and 1/m; against numpy's float64 result and, at m <= 128,
  against the JAX package's ``fft_greens_ifft_pass`` (Pallas in interpret
  mode), A = 1 and 3.
- The kernel's slot layout (a bijection, and conflict-free in every phase)
  and :func:`cuda_fft.zconv_tile_plan`, the plan the C launcher checks: its
  invariants at every length class the gate takes, A = 1 and 3, column
  counts from 1 to the 256^3 solve's 131,072, aligned and storage-offset
  pointers, and what it refuses; no plan for the four-step kernel's
  lengths.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  ``torch.fft`` version at those lengths and column counts (the four-step
  kernel at m = 96, 100, 544, 1024), each instance, a storage-offset input,
  the launcher's refusal of other plans, and the launch counter. On the card, without JAX installed:
  ``python -m pytest tests/test_torch_zconv.py -m cuda --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|``, as for every FFT pass: float32
rounding of two differently factored length-m DFTs (forward and inverse)
against float64, whose error grows like log m (the model and the kernel sit
near 2e-7; the JAX package holds its own passes to 2e-6 of numpy's at
m <= 128).
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


def zconv_model(xr, xi, g):
    """The ring kernel's arithmetic in plain torch on (A, m/2, B) float32
    pairs and the (1, m, B) Green's spectrum, n = n1 + m1 n2 and
    k = k2 + m2 k1."""
    a, h, b = xr.shape
    m = 2 * h
    m1, m2 = cuda_fft.best_factors(m)
    x = torch.complex(xr, xi).reshape(a, m2 // 2, m1, b)  # [a, n2, n1, b]
    v = torch.zeros(a, m2, m1, b, dtype=torch.complex64)
    v[:, : m2 // 2] = x  # the zero-padded half
    ang = -2.0 * math.pi * torch.outer(torch.arange(m2), torch.arange(m1)) \
        .double() / m  # [k2, n1]
    tw = torch.complex(torch.cos(ang).float(), torch.sin(ang).float())
    y = torch.fft.fft(v, dim=1) * tw[None, :, :, None]  # first factor
    spec = torch.fft.fft(y, dim=2)  # [a, k2, k1, b]
    spec = spec * g.reshape(1, m1, m2, b).transpose(1, 2)
    z = torch.fft.ifft(spec, dim=2) * m1 * tw.conj()[None, :, :, None]
    out = torch.fft.ifft(z, dim=1)[:, : m2 // 2] * m2 / m  # [a, n2, n1, b]
    out = out.reshape(a, h, b)
    return out.real.contiguous(), out.imag.contiguous()


def _np_zconv(xr, xi, g):
    h = xr.shape[1]
    f = np.fft.fft(xr.astype(np.float64) + 1j * xi, n=2 * h, axis=1)
    out = np.fft.ifft(f * g, axis=1)[:, :h]
    return out.real, out.imag


def _close(outs, refs):
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        assert out.shape == np.asarray(ref).shape
        err = float(np.abs(out.astype(np.float64) - np.asarray(ref)).max())
        assert err <= FFT_TOL * scale, f"max|diff| {err} > {FFT_TOL} * {scale}"


def _inputs(a, m, b, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f32(a, m // 2, b), f32(a, m // 2, b), f32(1, m, b)


@pytest.mark.parametrize("a", [1, 3])
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_model_matches_numpy(m, a):
    xr, xi, g = _inputs(a, m, 7, m + a)
    out = zconv_model(torch.tensor(xr), torch.tensor(xi), torch.tensor(g))
    _close(out, _np_zconv(xr, xi, g))


@pytest.mark.parametrize("a", [1, 3])
@pytest.mark.parametrize("m", [64, 128])
def test_model_matches_jax_pallas(m, a):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    xr, xi, g = _inputs(a, m, 12, 100 + m + a)
    ref = tuple(np.asarray(r) for r in jax_fft.fft_greens_ifft_pass(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(g)))
    args = (torch.tensor(xr), torch.tensor(xi), torch.tensor(g))
    _close(zconv_model(*args), ref)
    # and the wrapper on a CPU tensor (its plain version) agrees
    _close(cuda_fft.fft_greens_ifft_pass(*args), ref)


def _slot(k2, n1, c, t, m1):
    """The kernel's slot of (k2, n1) in column c, in float2 units."""
    return k2 * (m1 * t + (t if t < 16 else 0)) + n1 * t + c


def _banks(addrs):
    """Shared-memory wavefronts of one warp's float2 accesses: each
    half-warp is one request; its distinct addresses per 16-slot bank group
    beyond one are conflicts."""
    waves = 0
    for half in (addrs[:16], addrs[16:]):
        groups = {}
        for a in set(half):
            groups.setdefault(a % 16, set()).add(a)
        waves += max(len(v) for v in groups.values())
    return waves


# the kernel's instances: T columns x m1 threads
INSTANCES = [(m, t) for m in RING_LENGTHS for t in cuda_fft.ZCONV_COLUMNS]


@pytest.mark.parametrize("m,t", INSTANCES)
def test_slot_layout_is_a_conflict_free_bijection(m, t):
    m1, m2 = cuda_fft.best_factors(m)
    slots = {_slot(k2, n1, c, t, m1) for k2 in range(m2) for n1 in range(m1)
             for c in range(t)}
    assert len(slots) == m * t
    per_k2 = m1 * t + (t if t < 16 else 0)
    assert max(slots) < m2 * per_k2  # within the kernel's SLOTS
    lanes = [(tid % t, tid // t) for tid in range(32)]  # (c, j) of a warp
    for k2 in range(m2):  # first and last factors: n1 = j
        assert _banks([_slot(k2, j, c, t, m1) for c, j in lanes]) == 2
    for s in range(m2 // m1):  # middle factor: k2 = j + m1 s
        for n1 in range(m1):
            assert _banks([_slot(j + m1 * s, n1, c, t, m1)
                           for c, j in lanes]) == 2


@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "offset4"])
@pytest.mark.parametrize("b", COLUMNS)
@pytest.mark.parametrize("a", [1, 3])
@pytest.mark.parametrize("m", LENGTHS)
def test_zconv_tile_plan_invariants(m, a, b, offset):
    ptr = 1 << 20 | offset
    plan = cuda_fft.zconv_tile_plan(a, b, m, ptr, SMS)
    if m not in cuda_fft.ZCONV_LENGTHS:  # the four-step kernel plans itself
        assert plan == cuda_fft.FOUR_STEP_ZCONV_PLAN
        assert plan.args() == (0,) * 6
        return
    tiles = -(-b // plan.cols)
    m1, _ = cuda_fft.best_factors(m)
    assert plan.cols in cuda_fft.ZCONV_COLUMNS
    assert plan.threads == plan.cols * m1 and plan.threads % 32 == 0
    assert 1 <= plan.blocks <= tiles
    assert plan.stages == cuda_fft.ZCONV_STAGES == 2
    assert plan.smem == cuda_fft._zconv_smem(m, plan.cols)
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + cuda_fft.BLOCK_SHARED_RESERVE) \
        <= cuda_fft.SM_SHARED_BYTES
    assert plan.threads * plan.blocks_per_sm <= (256 if m == 512 else 512)
    assert plan.blocks == min(tiles, plan.blocks_per_sm * SMS)
    assert plan.bulk == (offset == 0 and b % 4 == 0)
    if b == 131072:  # the 256^3 solve's columns fill every SM
        assert plan.blocks == plan.blocks_per_sm * SMS >= SMS


@pytest.mark.parametrize("cols", cuda_fft.ZCONV_COLUMNS)
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_zconv_tile_plan_of_every_instance(m, cols):
    # each instance a sweep may ask for fills the card at 256^3's columns
    m1, _ = cuda_fft.best_factors(m)
    plan = cuda_fft.zconv_columns_plan(131072, m, True, SMS, cols)
    assert (plan.cols, plan.threads, plan.stages) == (cols, cols * m1, 2)
    assert plan.blocks == plan.blocks_per_sm * SMS
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX


def test_zconv_tile_plan_of_the_main_paths():
    # the 256^3 sphere's: one block of eight warps on every SM, tiles of 16
    # columns (64-byte row segments)
    plan = cuda_fft.zconv_tile_plan(3, 131072, 512, 0, SMS)
    assert (plan.cols, plan.blocks, plan.stages, plan.threads) == \
        (16, SMS, 2, 256)
    # the multi-body case's (128, 128, 256): the same tile, two blocks an SM
    plan = cuda_fft.zconv_tile_plan(3, 65536, 256, 0, SMS)
    assert (plan.cols, plan.blocks, plan.threads) == (16, 2 * SMS, 256)
    # the 2D route's y pass, (1, 256, 512) at m = 512: neither tile fills
    # the card, the most blocks are 64 tiles of 8
    plan = cuda_fft.zconv_tile_plan(1, 512, 512, 0, SMS)
    assert (plan.cols, plan.blocks, plan.threads) == (8, 64, 128)


@pytest.mark.parametrize("b", COLUMNS)
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_zconv_tile_plan_takes_the_first_shape_that_fills_the_card(m, b):
    plan = cuda_fft.zconv_tile_plan(3, b, m, 0, SMS)
    plans = [cuda_fft.zconv_columns_plan(b, m, True, SMS, t)
             for t in cuda_fft.ZCONV_COLUMNS]
    assert plan in plans
    full = [p for p in plans if p.blocks == p.blocks_per_sm * SMS]
    if full:
        assert plan == full[0]
    else:
        assert plan.blocks == max(p.blocks for p in plans)


@pytest.mark.parametrize("a,b,m,sms", [(3, 131072, 512, SMS),
                                       (3, 65536, 256, SMS),
                                       (1, 512, 512, SMS), (3, 1001, 256, 4),
                                       (2, 17, 64, 4)])
def test_ring_walk_covers_every_tile_and_component_once(a, b, m, sms):
    # the persistent blocks' walk as the kernel runs it: block k takes tiles
    # k, k + blocks, ..., each with its A components in turn
    plan = cuda_fft.zconv_tile_plan(a, b, m, 0, sms)
    tiles = -(-b // plan.cols)
    seen = []
    for blk in range(plan.blocks):
        iters = (tiles - blk + plan.blocks - 1) // plan.blocks * a
        seen += [(blk + (it // a) * plan.blocks, it % a) for it in range(iters)]
    assert sorted(seen) == [(t, c) for t in range(tiles) for c in range(a)]


def test_zconv_tile_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        cuda_fft.zconv_tile_plan(0, 8, 64, 0)
    with pytest.raises(ValueError):
        cuda_fft.zconv_tile_plan(3, 0, 64, 0)
    with pytest.raises(ValueError):
        cuda_fft.zconv_tile_plan(3, 8, 30, 0)  # unsupported length
    with pytest.raises(ValueError):
        cuda_fft.zconv_tile_plan(3, 8, 2048, 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


CARD_CASES = [(m, a, b) for m in LENGTHS for a in (1, 3)
              for b in COLUMNS[:5]] + [(512, 3, 131072)]


def _launch(args, out, a, b, m, plan):
    return cuda_fft.library().sopht_fft_greens_ifft_pass_f32(
        *(t.data_ptr() for t in args + out),
        cuda_fft._table(m, args[0].device).data_ptr(), a, b, m, *plan.args(),
        torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", cuda_fft.ZCONV_COLUMNS)
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_every_instance_matches_plain_on_card(m, cols):
    dev = _card()
    a, b = 3, 1001  # ragged, with more tiles than blocks below
    args = [torch.tensor(v, device=dev) for v in _inputs(a, m, b, m)]
    plan = cuda_fft.zconv_columns_plan(b, m, False, 4, cols)  # 4 SMs' blocks
    out = [torch.empty_like(args[0]) for _ in range(2)]
    assert _launch(args, out, a, b, m, plan) == 0
    torch.cuda.synchronize()
    _close(out, [r.cpu().numpy()
                 for r in cuda_fft.fft_greens_ifft_pass_ref(*args)])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 512, 1024])
def test_launcher_refuses_another_plan_on_card(m):
    dev = _card()
    a, b = 3, 64
    args = [torch.tensor(v, device=dev) for v in _inputs(a, m, b, m)]
    out = [torch.empty_like(args[0]) for _ in range(2)]
    plan = cuda_fft.zconv_tile_plan(a, b, m, 0)
    if m in cuda_fft.ZCONV_LENGTHS:
        wrongs = [plan._replace(stages=3), plan._replace(cols=32),
                  plan._replace(smem=plan.smem + 8),
                  cuda_fft.FOUR_STEP_ZCONV_PLAN]
    else:  # the four-step kernel takes no plan
        wrongs = [cuda_fft.zconv_columns_plan(b, 512, True, SMS, 16)]
    for wrong in wrongs:
        assert _launch(args, out, a, b, m, wrong) != 0, wrong


@pytest.mark.cuda
@pytest.mark.parametrize("m,a,b", CARD_CASES)
def test_kernel_matches_plain_on_card(m, a, b):
    dev = _card()
    args = [torch.tensor(v, device=dev) for v in _inputs(a, m, b, m + a + b)]
    before = cuda_fft.fft_greens_ifft_pass.launches
    out = cuda_fft.fft_greens_ifft_pass(*args)
    torch.cuda.synchronize()
    assert cuda_fft.fft_greens_ifft_pass.launches == before + 1
    _close(out, [r.cpu().numpy()
                 for r in cuda_fft.fft_greens_ifft_pass_ref(*args)])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 256, 512, 1024])
def test_kernel_takes_a_storage_offset_on_card(m):
    dev = _card()
    a, h, b = 3, m // 2, 203
    xr, xi, g = _inputs(a, m, b + 1, 5)
    flat_r = torch.tensor(xr.ravel()[: a * h * b + 1], device=dev)
    flat_i = torch.tensor(xi.ravel()[: a * h * b + 1], device=dev)
    xr_v, xi_v = flat_r[1:].view(a, h, b), flat_i[1:].view(a, h, b)
    assert xr_v.data_ptr() % 16 == 4
    gt = torch.tensor(g[..., :b].copy(), device=dev)
    ptr = xr_v.data_ptr() | xi_v.data_ptr()
    assert not cuda_fft.zconv_tile_plan(a, b, m, ptr).bulk
    _close(cuda_fft.fft_greens_ifft_pass(xr_v, xi_v, gt),
           [r.cpu().numpy()
            for r in cuda_fft.fft_greens_ifft_pass_ref(xr_v, xi_v, gt)])
