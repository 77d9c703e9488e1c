"""The x-edge c2r of the port (``irfft_pass_merge`` and
``irfft_pass_truncated``, ``csrc/fft_passes.cu``): its arithmetic, its
launch plan and, on the card, the kernel.

- A plain-torch model of the power-of-two kernel's arithmetic (the merge
  step in the kernel's order with W_m^k rounded to float32, one m/2-point
  inverse as conj(FFT(conj Z)), the interleave, n_out kept, 1/m) against
  numpy's float64 ``irfft`` and, at m <= 128, against the JAX package's
  passes (Pallas in interpret mode), with inputs whose Im X[0] and
  Im X[m/2] are not zero.
- :func:`cuda_fft.c2r_tile_plan`, the plan the C launcher checks: its
  invariants at every length class the gate takes, row counts from one row
  to the 256^3 solve's 196,608, aligned and storage-offset pointers.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  ``torch.fft`` versions at those lengths and row counts, a storage-offset
  input, the four-step kernel's lengths, the launcher refusing other plans,
  and the launch counters. On the card, without JAX installed:
  ``python -m pytest tests/test_torch_edge_c2r.py -m cuda --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|``, as for every FFT pass: float32
rounding of two differently factored DFTs of length <= 1024, whose error
grows like log m (the JAX package holds its own passes to 2e-6 of numpy's
at m <= 128).
"""

import math

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

FFT_TOL = 5e-6
RING_LENGTHS = [64, 128, 256, 512, 1024]
LENGTHS = [64, 96, 100, 128, 256, 512, 544, 1024]
ROWS = [1, 3, 4, 256, 196608]
SMS = cuda_fft.H100_SMS


def _n_out(m, case):
    return {"half": m // 2, "half-1": m // 2 - 1, "3": 3}[case]


def c2r_model(re, im, m, n_out):
    """The power-of-two kernel's arithmetic in plain torch on the (R, h + 1)
    half spectrum, h = m/2: for each k < h from X[k] and X[h-k] (Im X[0]
    and Im X[h] taken as 0), Xe = X[k] + conj X[h-k] and Xo = (X[k] -
    conj X[h-k]) conj W, W = W_m^k rounded to float32; Z = Xe + i Xo;
    F = FFT_h(conj Z); y[2n] = Re F[n] / m, y[2n+1] = -Im F[n] / m, the
    first n_out kept."""
    rows, h = re.shape[0], m // 2
    im = im.clone()
    im[:, 0] = 0.0
    im[:, h] = 0.0
    k = torch.arange(h)
    ar, ai = re[:, k], im[:, k]
    cr, ci = re[:, h - k], im[:, h - k]
    ang = -2.0 * math.pi * k.double() / m
    wr, wi = torch.cos(ang).float(), torch.sin(ang).float()
    er, ei = ar + cr, ai - ci
    dr, di = ar - cr, ai + ci
    odr, odi = dr * wr + di * wi, di * wr - dr * wi
    f = torch.fft.fft(torch.complex(er - odi, -(ei + odr)), dim=1)
    y = torch.stack([f.real / m, -f.imag / m], dim=2).reshape(rows, m)
    return y[:, :n_out].contiguous()


def _spectrum(m, seed, rows=7):
    """(R, m/2 + 1) re and im, Im X[0] and Im X[m/2] not zero."""
    rng = np.random.default_rng(seed)
    re, im = (rng.standard_normal((rows, m // 2 + 1)).astype(np.float32)
              for _ in range(2))
    assert np.all(im[:, 0] != 0) and np.all(im[:, -1] != 0)
    return re, im


def _np_c2r(re, im, m, n_out):
    im = im.astype(np.float64)
    im[:, 0] = im[:, -1] = 0.0  # the JAX weights: the two do not enter
    return np.fft.irfft(re.astype(np.float64) + 1j * im, n=m, axis=1)[:, :n_out]


def _split(a):
    h = a.shape[1] - 1
    return np.ascontiguousarray(a[:, :h]), np.ascontiguousarray(a[:, h:])


def _close(outs, refs):
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    refs = refs if isinstance(refs, (tuple, list)) else (refs,)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        assert out.shape == np.asarray(ref).shape
        err = float(np.abs(out.astype(np.float64) - np.asarray(ref)).max())
        assert err <= FFT_TOL * scale, f"max|diff| {err} > {FFT_TOL} * {scale}"


@pytest.mark.parametrize("n_out", ["half", "half-1", "3"])
@pytest.mark.parametrize("m", RING_LENGTHS)
def test_model_matches_numpy(m, n_out):
    re, im = _spectrum(m, m)
    n = _n_out(m, n_out)
    out = c2r_model(torch.tensor(re), torch.tensor(im), m, n)
    _close(out, _np_c2r(re, im, m, n))


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("n_out", ["half", "half-1"])
@pytest.mark.parametrize("m", [64, 128])
def test_model_matches_jax_pallas(m, n_out, unsplit):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    re, im = _spectrum(m, 100 + m)
    n = _n_out(m, n_out)
    if unsplit:
        args = (re, im)
        ref = np.asarray(jax_fft.irfft_pass_truncated(
            jnp.asarray(re), jnp.asarray(im), m, n))
        wrapper = cuda_fft.irfft_pass_truncated
    else:
        (br, sr), (bi, si) = _split(re), _split(im)
        args = (br, bi, sr, si)
        ref = np.asarray(jax_fft.irfft_pass_merge(
            *(jnp.asarray(a) for a in args), m, n))
        wrapper = cuda_fft.irfft_pass_merge
    _close(c2r_model(torch.tensor(re), torch.tensor(im), m, n), ref)
    # and the wrapper on CPU tensors (its plain version) agrees
    _close(wrapper(*(torch.tensor(a) for a in args), m, n), ref)


def _spans_ok(plan, n_out, m, unsplit):
    """Every span a bulk copy moves starts 16-byte aligned and is a multiple
    of 16 bytes: a tile's re and im rows, its side column, its outputs."""
    t, ld = plan.rows, m // 2 + 1 if unsplit else m // 2
    return all(b % 16 == 0 for b in (4 * t * ld, 4 * t, 4 * t * n_out))


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("offset", [0, 4], ids=["aligned", "offset4"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("m", LENGTHS)
def test_c2r_tile_plan_invariants(m, rows, offset, unsplit):
    n_out = m // 2 - 1  # odd: the output span holds whatever n_out is
    ptr = 1 << 20 | offset
    plan = cuda_fft.c2r_tile_plan(rows, n_out, m, unsplit, ptr, SMS)
    tiles = -(-rows // plan.rows)
    assert plan.rows % 4 == 0
    assert 1 <= plan.blocks <= tiles
    assert plan.blocks <= plan.blocks_per_sm * SMS or plan.stages == 0
    assert plan.smem <= cuda_fft.BLOCK_SHARED_MAX
    assert plan.blocks_per_sm * (plan.smem + cuda_fft.BLOCK_SHARED_RESERVE) \
        <= cuda_fft.SM_SHARED_BYTES
    if plan.bulk:
        assert ptr % 16 == 0 and _spans_ok(plan, n_out, m, unsplit)
    if m & (m - 1):  # the four-step kernel: one tile a block, no ring
        assert (plan.stages, plan.bulk, plan.threads) == (0, False, 256)
        assert plan.blocks == tiles
        return
    h = m // 2
    lanes = cuda_fft._edge_shape(h)[1]
    assert plan.threads == plan.rows * lanes and plan.threads % 32 == 0
    assert plan.threads <= 256 and plan.threads * plan.blocks_per_sm <= 512
    assert 2 <= plan.stages <= 4
    assert plan.smem == cuda_fft._c2r_smem(h, plan.rows, n_out, plan.stages,
                                           unsplit)
    assert plan.bulk == (offset == 0)
    # the tile shape is the forward r2c's at the same rows
    assert plan.rows == cuda_fft.edge_tile_plan(rows, h, m, unsplit, ptr,
                                                SMS).rows
    if rows == 196608:  # the 256^3 solve's rows fill every SM
        assert plan.blocks == plan.blocks_per_sm * SMS >= 2 * SMS


@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
def test_c2r_tile_plan_spreads_the_2d_shape(unsplit):
    # the 2D route's (256, 512) field doubled to m = 1024: 256 rows only
    plan = cuda_fft.c2r_tile_plan(256, 512, 1024, unsplit, 0, SMS)
    assert plan.rows == 4 and plan.blocks >= 64


def test_c2r_tile_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        cuda_fft.c2r_tile_plan(4, 33, 64, False, 0)  # outputs past m/2
    with pytest.raises(ValueError):
        cuda_fft.c2r_tile_plan(4, 0, 64, False, 0)
    with pytest.raises(ValueError):
        cuda_fft.c2r_tile_plan(0, 32, 64, False, 0)
    with pytest.raises(ValueError):
        cuda_fft.c2r_tile_plan(4, 16, 30, False, 0)  # unsupported length


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_args(m, rows, unsplit, seed, dev):
    re, im = _spectrum(m, seed, rows)
    if unsplit:
        return [torch.tensor(a, device=dev) for a in (re, im)]
    (br, sr), (bi, si) = _split(re), _split(im)
    return [torch.tensor(a, device=dev) for a in (br, bi, sr, si)]


def _pair(unsplit):
    if unsplit:
        return cuda_fft.irfft_pass_truncated, cuda_fft.irfft_pass_truncated_ref
    return cuda_fft.irfft_pass_merge, cuda_fft.irfft_pass_merge_ref


CARD_CASES = [(m, rows) for m in LENGTHS for rows in ROWS[:4]] + [(512, 196608)]


@pytest.mark.cuda
@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("m,rows", CARD_CASES)
def test_kernel_matches_plain_on_card(m, rows, unsplit):
    dev = _card()
    fn, plain = _pair(unsplit)
    args = _card_args(m, rows, unsplit, rows + m, dev)
    for n_out in (m // 2, m // 2 - 1, 3):
        before = fn.launches
        out = fn(*args, m, n_out)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _close(out, plain(*args, m, n_out).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("m", [96, 512, 1024])
def test_kernel_takes_a_storage_offset_on_card(m, unsplit):
    dev = _card()
    fn, plain = _pair(unsplit)
    rows, ld = 203, m // 2 + 1 if unsplit else m // 2
    flat = [torch.tensor(np.random.default_rng(s).standard_normal(
        rows * ld + 1).astype(np.float32), device=dev) for s in (5, 6)]
    x = [f[1:].view(rows, ld) for f in flat]  # 4 bytes past an allocation
    assert all(v.is_contiguous() and v.data_ptr() % 16 == 4 for v in x)
    args = x if unsplit else x + [torch.randn(rows, 1, device=dev)
                                  for _ in range(2)]
    ptr = x[0].data_ptr() | x[1].data_ptr()
    assert not cuda_fft.c2r_tile_plan(rows, m // 2, m, unsplit, ptr).bulk
    _close(fn(*args, m, m // 2), plain(*args, m, m // 2).cpu().numpy())


def _launch(args, out, m, n_out, plan, unsplit):
    lib, dev = cuda_fft.library(), args[0].device
    name = "sopht_irfft_pass_truncated_f32" if unsplit \
        else "sopht_irfft_pass_merge_f32"
    ins = args[:2] if unsplit else args[:3]  # si does not enter
    return getattr(lib, name)(
        *(t.data_ptr() for t in ins), out.data_ptr(),
        cuda_fft._table(m, dev).data_ptr(), args[0].shape[0], m, n_out,
        *plan.args(), torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("unsplit", [False, True], ids=["split", "unsplit"])
@pytest.mark.parametrize("m", [96, 512, 1024])
def test_launcher_refuses_another_plan_on_card(m, unsplit):
    dev = _card()
    rows, n_out = 64, m // 2
    args = _card_args(m, rows, unsplit, 7, dev)
    out = torch.empty(rows, n_out, device=dev)
    plan = cuda_fft.c2r_tile_plan(rows, n_out, m, unsplit, 0)
    assert _launch(args, out, m, n_out, plan, unsplit) == 0
    torch.cuda.synchronize()
    wrongs = [plan._replace(rows=plan.rows + 4),
              plan._replace(smem=plan.smem + 8),
              plan._replace(threads=2 * plan.threads)]
    if plan.stages:  # the ring kernel
        wrongs += [plan._replace(stages=5), plan._replace(blocks=0),
                   cuda_fft.c2r_tile_plan(rows, 48, 96, unsplit, 0)]
    else:  # the four-step kernel takes its own plan only
        wrongs += [cuda_fft.c2r_tile_plan(rows, 256, 512, unsplit, 0)]
    for wrong in wrongs:
        assert _launch(args, out, m, n_out, wrong, unsplit) != 0, wrong
