"""The forward x-edge r2c of the port (``rfft_pass_padded_split`` and
``rfft_pass_padded``, ``csrc/fft_passes.cu``): its arithmetic, its launch
plan and, on the card, the kernel.

- A plain-torch model of the power-of-two kernel's arithmetic (even/odd
  packing into m/2 complex points, one m/2-point FFT, the split step in the
  kernel's order and rounding) against numpy's float64 ``rfft`` and, at
  m <= 128, against the JAX package's passes (Pallas in interpret mode).
- :func:`cuda_fft.edge_tile_plan`, the plan the C launcher checks: its
  invariants at every length class the gate takes, row counts from one row
  to the 256^3 solve's 196,608, aligned and storage-offset pointers.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  ``torch.fft`` versions at those lengths and row counts, a storage-offset
  input, and the launch counters. On the card, without JAX installed:
  ``python -m pytest tests/test_torch_edge_r2c.py -m cuda --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|``, as for every FFT pass: float32
rounding of two differently factored DFTs of length <= 1024, whose error
grows like log m (the model and the kernel sit near 3e-7, the JAX package
holds its own passes to 2e-6 of numpy's at m <= 128).
"""

import math

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

FFT_TOL = 5e-6
LENGTHS = [64, 96, 100, 128, 256, 512, 544, 1024]
ROWS = [1, 3, 4, 256, 196608]
SMS = cuda_fft.H100_SMS


def _n_in(m, case):
    return {"half": m // 2, "half-1": m // 2 - 1, "3": 3}[case]


def r2c_model(x, m, unsplit):
    """The power-of-two kernel's arithmetic in plain torch: z[n] = x[2n] +
    i x[2n+1] zero-padded to h = m/2 points, Z = FFT_h(z), then for each
    k <= h/2 from Z[k] and conj Z[h-k] (Z[h] = Z[0]):
    X[k] = E - i W O and X[h-k] = conj(E) - i conj(W O), E and O the half
    sum and difference, W = W_m^k rounded to float32. The split layout's
    bulk pair (R, h) and side pair (R, 1), or the unsplit (R, h + 1) pair."""
    rows, n_in = x.shape
    h = m // 2
    z = torch.zeros(rows, h, dtype=torch.complex64)
    z.real[:, : (n_in + 1) // 2] = x[:, 0::2]
    z.imag[:, : n_in // 2] = x[:, 1::2]
    zf = torch.fft.fft(z, dim=1)
    k = torch.arange(h // 2 + 1)
    a, c = zf[:, k], zf[:, (h - k) % h]
    er, ei = 0.5 * (a.real + c.real), 0.5 * (a.imag - c.imag)
    odr, odi = 0.5 * (a.real - c.real), 0.5 * (a.imag + c.imag)
    ang = -2.0 * math.pi * k.double() / m
    wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
    pr, pi = wr * odr - wi * odi, wr * odi + wi * odr
    re = torch.empty(rows, h + 1)
    im = torch.empty(rows, h + 1)
    re[:, h - k], im[:, h - k] = er - pi, -ei - pr  # X[h - k]
    re[:, k], im[:, k] = er + pi, ei - pr  # X[k], k = h/2 last
    if unsplit:
        return re, im
    return (re[:, :h].contiguous(), im[:, :h].contiguous(),
            re[:, h:].contiguous(), im[:, h:].contiguous())


def _np_r2c(x, m, unsplit):
    ref = np.fft.rfft(x.astype(np.float64), n=m, axis=1)
    if unsplit:
        return ref.real, ref.imag
    h = m // 2
    return ref.real[:, :h], ref.imag[:, :h], ref.real[:, h:], ref.imag[:, h:]


def _close(outs, refs):
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        assert out.shape == np.asarray(ref).shape
        err = float(np.abs(out.astype(np.float64) - np.asarray(ref)).max())
        assert err <= FFT_TOL * scale, f"max|diff| {err} > {FFT_TOL} * {scale}"


def _rows(m, n_in, seed, rows=7):
    return np.random.default_rng(seed).standard_normal((rows, n_in)) \
        .astype(np.float32)


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("n_in", ["half", "half-1", "3"])
@pytest.mark.parametrize("m", LENGTHS)
def test_model_matches_numpy(m, n_in, unsplit):
    x = _rows(m, _n_in(m, n_in), m)
    out = r2c_model(torch.tensor(x), m, unsplit)
    _close(out, _np_r2c(x, m, unsplit))
    # X[0] and X[m/2] come out real, as the plain version's
    im = out[1] if unsplit else torch.cat([out[1], out[3]], dim=1)
    assert torch.all(im[:, 0] == 0) and torch.all(im[:, -1] == 0)


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("n_in", ["half", "half-1"])
@pytest.mark.parametrize("m", [64, 96, 128])
def test_model_matches_jax_pallas(m, n_in, unsplit):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    x = _rows(m, _n_in(m, n_in), 100 + m)
    fn = jax_fft.rfft_pass_padded if unsplit else jax_fft.rfft_pass_padded_split
    ref = tuple(np.asarray(r) for r in fn(jnp.asarray(x), m))
    _close(r2c_model(torch.tensor(x), m, unsplit), ref)
    # and the wrapper on a CPU tensor (its plain version) agrees
    wrapper = cuda_fft.rfft_pass_padded if unsplit \
        else cuda_fft.rfft_pass_padded_split
    _close(wrapper(torch.tensor(x), m), ref)


def _spans_ok(plan, n_in, m, unsplit):
    """Every span a bulk copy moves starts 16-byte aligned and is a multiple
    of 16 bytes: a tile's input, its bulk or unsplit rows, its side column."""
    t, ld = plan.rows, m // 2 + 1 if unsplit else m // 2
    return all(b % 16 == 0 for b in (4 * t * n_in, 4 * t * ld, 4 * t))


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "offset4"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("m", LENGTHS)
def test_edge_tile_plan_invariants(m, rows, offset, unsplit):
    n_in = m // 2
    ptr = 1 << 20 | offset
    plan = cuda_fft.edge_tile_plan(rows, n_in, m, unsplit, ptr, SMS)
    tiles = -(-rows // plan.rows)
    assert plan.rows % 4 == 0
    assert 1 <= plan.blocks <= tiles
    assert plan.blocks <= plan.blocks_per_sm * SMS or plan.stages == 0
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + cuda_fft.BLOCK_SHARED_RESERVE) \
        <= cuda_fft.SM_SHARED_BYTES
    if plan.bulk:
        assert ptr % 16 == 0 and _spans_ok(plan, n_in, m, unsplit)
    if m & (m - 1):  # the four-step kernel: one tile a block, no ring
        assert (plan.stages, plan.bulk, plan.threads) == (0, False, 256)
        assert plan.blocks == tiles
        return
    h = m // 2
    lanes = cuda_fft._edge_shape(h)[1]
    assert plan.threads == plan.rows * lanes and plan.threads % 32 == 0
    assert plan.threads <= 256 and plan.threads * plan.blocks_per_sm <= 512
    assert 2 <= plan.stages <= 4
    assert plan.smem == cuda_fft._edge_smem(h, plan.rows, n_in, plan.stages,
                                            unsplit)
    assert plan.bulk == (offset == 0)
    if rows == 196608:  # the 256^3 solve's rows fill every SM
        assert plan.blocks == plan.blocks_per_sm * SMS >= 2 * SMS


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
def test_edge_tile_plan_spreads_the_2d_shape(unsplit):
    # the 2D route's (256, 512) field doubled to m = 1024: 256 rows only
    plan = cuda_fft.edge_tile_plan(256, 512, 1024, unsplit, 0, SMS)
    assert plan.rows == 4 and plan.blocks >= 64


def test_edge_tile_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        cuda_fft.edge_tile_plan(4, 33, 64, False, 0)  # rows past m/2
    with pytest.raises(ValueError):
        cuda_fft.edge_tile_plan(0, 32, 64, False, 0)
    with pytest.raises(ValueError):
        cuda_fft.edge_tile_plan(4, 16, 30, False, 0)  # unsupported length


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


CARD_CASES = [(m, rows) for m in LENGTHS for rows in ROWS[:4]] + [(512, 196608)]


@pytest.mark.cuda
@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("m,rows", CARD_CASES)
def test_kernel_matches_plain_on_card(m, rows, unsplit):
    dev = _card()
    fn = cuda_fft.rfft_pass_padded if unsplit else cuda_fft.rfft_pass_padded_split
    plain = cuda_fft.rfft_pass_padded_ref if unsplit \
        else cuda_fft.rfft_pass_padded_split_ref
    for n_in in (m // 2, m // 2 - 1, 3):
        x = torch.tensor(_rows(m, n_in, rows + m, rows), device=dev)
        before = fn.launches
        out = fn(x, m)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _close(out, [r.cpu().numpy() for r in plain(x, m)])


@pytest.mark.cuda
@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("m", [96, 512, 1024])
def test_kernel_takes_a_storage_offset_on_card(m, unsplit):
    dev = _card()
    fn = cuda_fft.rfft_pass_padded if unsplit else cuda_fft.rfft_pass_padded_split
    plain = cuda_fft.rfft_pass_padded_ref if unsplit \
        else cuda_fft.rfft_pass_padded_split_ref
    rows, n_in = 203, m // 2
    flat = torch.tensor(_rows(m, rows * n_in + 1, 5, 1)[0], device=dev)
    x = flat[1:].view(rows, n_in)  # 4 bytes past an aligned allocation
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert not cuda_fft.edge_tile_plan(rows, n_in, m, unsplit, x.data_ptr()).bulk
    _close(fn(x, m), [r.cpu().numpy() for r in plain(x, m)])
