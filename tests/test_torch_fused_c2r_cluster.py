"""The fused inverse edge pass's thread-block-cluster kernel
(``ifft_irfft_cluster_kernel`` behind ``ifft_irfft_pass_fused``,
``csrc/fft_passes.cu``): its arithmetic and walk, its tile layout, its
launch plan and, on the card, the kernel.

- A numpy model of the cluster walk: persistent clusters taking slabs
  a = cluster + k clusters (a ragged last round where the clusters do not
  divide A); in each slab, block r's column tile [r t, (r+1) t), t = nx / C,
  a row of padding after each run of m2 rows, through the four-step y
  inverse in place (the
  first factor reads rows k2 + m2 k1 and writes slots k2 + m2 n1, the
  second factor reads slots m2 n1 + k2; W_my rounded to float32), each kept
  row y = n1 + m1 n2 < ny pushed, times 1 / (my mx), to its owner (rank
  y / (ny / C)) at row y of its receive buffer, whose untouched cells start
  as NaN; the owner's merge step (Nyquist value sr / mx, W_mx^k rounded to
  float32) and half-length inverse of each row. Against numpy's float64
  result at every cluster size and my = 64 ... 1024, and against the JAX
  package's ``ifft_irfft_pass_fused`` (Pallas in interpret mode).
- The tile layout: the rows a warp covers in either factor fall on
  distinct shared-memory banks.
- :func:`cuda_fft.fused_c2r_cluster_plan`, the plan the C launcher checks:
  its invariants at every power-of-two shape the gate takes, its plans at
  the 256^3 solve's, the rod's and the 64^3 run's shapes, the all-zero
  (dense-x kernel) plan where mx or my is not a power of two and at
  512 x 512 slabs, and what it refuses.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  version at every cluster size the plan can give, with 16-byte and 4-byte
  tile copies, and under the dense-x kernel's plans, with the launch
  counter; an input with a storage offset; the launcher refusing any other
  plan. On the card, without JAX installed: ``python -m pytest
  tests/test_torch_fused_c2r_cluster.py -m cuda --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|``, as ``chip_smoke.py`` holds the
kernel: float32 rounding of an inverse FFT of length <= 1024 and a c2r,
whose error grows like log m (the model sits near 1e-7 of numpy's
float64).
"""

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

FFT_TOL = 5e-6
POW2 = [32, 64, 128, 256, 512]  # ny, nx: doubled lengths 64 ... 1024
SMS = cuda_fft.H100_SMS


def _spectra(a, ny, nx, seed):
    """The bulk (A, my, nx) pair and the Nyquist column's (A, ny, 1) pair."""
    rng = np.random.default_rng(seed)
    my = 2 * ny
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (a, my, nx), (a, my, nx), (a, ny, 1), (a, ny, 1)))


def _np_fused(br, bi, sr, si, mx, nx):
    """numpy's float64 inverse along y, then the c2r along x (the imaginary
    parts at kx = 0 and mx / 2 do not enter): (A, ny, nx) reals."""
    my = br.shape[1]
    bulk = np.fft.ifft(br.astype(np.float64) + 1j * bi, axis=1)[:, : my // 2]
    z = np.concatenate([bulk, sr + 1j * si.astype(np.float64)], axis=2)
    return np.fft.irfft(z, n=mx, axis=2)[..., :nx]


def tile_row(row, m2):
    """The kernel's tile row of input (or slot) row ``row``: a row of
    padding after each run of m2 rows."""
    return row + row // m2


def _c2r_row(x, xh, mx):
    """The c2r phase of one received row x (nx pairs, already times
    1 / (my mx)) with X[h] = xh (times 1 / mx): the merge step
    Z[k] = Xe + i Xo and the h-point inverse, unscaled; the interleaved
    reals y[2n], y[2n + 1] of z[n], n < nx / 2."""
    h = x.shape[0]
    k = np.arange(h)
    xk = x.real + 1j * np.where(k > 0, x.imag, 0.0)
    xc = np.where(k > 0, x[(h - k) % h], xh)
    w = np.exp(-2j * np.pi * k / mx).astype(np.complex64)
    xe = xk + np.conj(xc)
    xo = (xk - np.conj(xc)) * np.conj(w)
    z = h * np.fft.ifft(xe + 1j * xo)
    return np.stack([z.real, z.imag], axis=1).reshape(-1)[:h]


def _walk(a, clusters):
    """Each cluster's slabs in the order it takes them."""
    return [list(range(c, a, clusters)) for c in range(clusters)]


def cluster_model(br, bi, sr, mx, c, clusters):
    """The kernel's walk and arithmetic in numpy (see the module note)."""
    a, my, nx = br.shape
    ny, t = my // 2, nx // c
    rows = ny // c
    m1, m2 = cuda_fft.best_factors(my)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m2)) / my) \
        .astype(np.complex64)
    scale = 1.0 / (my * mx)
    out = np.full((a, ny, nx), np.nan)
    spec = br.astype(np.float64) + 1j * bi.astype(np.float64)
    for slabs in _walk(a, clusters):
        for s in slabs:
            recv = np.full((c, rows, nx), np.nan, complex)
            for r in range(c):
                tile = np.full((my + m1, t), np.nan, complex)
                ky = np.arange(my)
                tile[tile_row(ky, m2)] = spec[s, :, r * t:(r + 1) * t]
                for k2 in range(m2):  # the first factor, in place
                    idx = tile_row(k2 + m2 * np.arange(m1), m2)
                    v = tile[idx]
                    assert not np.isnan(v).any()
                    f = m1 * np.fft.ifft(v, axis=0)  # sum_k1 conj(W^(n1 k1))
                    tile[idx] = np.conj(tw[:, k2])[:, None] * f
                for n1 in range(m1):  # the second factor, then the pushes
                    v = tile[tile_row(m2 * n1 + np.arange(m2), m2)]
                    acc = m2 * np.fft.ifft(v, axis=0)[: m2 // 2]
                    for n2 in range(m2 // 2):
                        y = n1 + m1 * n2
                        recv[y // rows, y % rows, r * t:(r + 1) * t] = \
                            acc[n2] * scale
            for r in range(c):
                for yl in range(rows):
                    assert not np.isnan(recv[r, yl]).any()
                    y = r * rows + yl
                    out[s, y] = _c2r_row(recv[r, yl], sr[s, y, 0] / mx, mx)
    return out


def _close(out, ref, tol=FFT_TOL):
    out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(out.astype(np.float64) - ref).max())
    assert err <= tol * scale, f"max|diff| {err} > {tol} * {scale}"


# (ny, nx): my = 64 ... 1024, nx / C down to 2 columns a block
MODEL_SHAPES = [(32, 32), (64, 32), (32, 64), (128, 64), (512, 32),
                (32, 256)]


@pytest.mark.parametrize("clusters", ["all", 2], ids=["one-round", "ragged"])
@pytest.mark.parametrize("c", cuda_fft.FUSED_R2C_CLUSTERS)
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_matches_numpy(shape, c, clusters):
    ny, nx = shape
    a = 5
    br, bi, sr, si = _spectra(a, ny, nx, ny + nx + c)
    out = cluster_model(br, bi, sr, 2 * nx, c, a if clusters == "all" else 2)
    _close(out, _np_fused(br, bi, sr, si, 2 * nx, nx))


JAX_SHAPES = [(32, 32), (64, 32), (32, 64)]


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_matches_jax(shape):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    assert jax_fft._use_interpret()  # the Pallas kernel, in interpret mode
    ny, nx = shape
    a, mx = 5, 2 * nx
    spectra = _spectra(a, ny, nx, 3 * ny + nx)
    ref = np.asarray(jax_fft.ifft_irfft_pass_fused(
        *map(jnp.asarray, spectra), mx, nx))
    br, bi, sr, _ = spectra
    for c in cuda_fft.FUSED_R2C_CLUSTERS:  # every cluster size, ragged
        _close(cluster_model(br, bi, sr, mx, c, 2), ref)
    # the wrapper on a CPU tensor (its plain version), launching nothing
    before = cuda_fft.ifft_irfft_pass_fused.launches
    _close(cuda_fft.ifft_irfft_pass_fused(
        *map(torch.tensor, spectra), mx, nx), ref)
    assert cuda_fft.ifft_irfft_pass_fused.launches == before


@pytest.mark.parametrize("t", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("my", [64, 128, 256, 512, 1024])
def test_tile_rows_spread_over_the_banks(my, t):
    m1, m2 = cuda_fft.best_factors(my)
    rows = np.arange(my)
    assert np.unique(tile_row(rows, m2)).size == my
    assert tile_row(rows, m2).max() < my + m1
    span = max(1, 32 // t)  # rows a warp covers, t columns each
    lanes = np.arange(min(32, t))

    def banks(tile_rows):
        cells = (tile_rows[:, None] * t + lanes[None, :]).reshape(-1)
        return np.unique(cells % 32).size == min(32, span * t)

    for base in range(0, max(m1, m2), span):
        warp = base + np.arange(span)
        for k1 in range(m1):  # first factor: rows k2 + m2 k1
            if warp[-1] < m2:
                assert banks(tile_row(warp + m2 * k1, m2))
        for k2 in range(m2):  # second factor: rows m2 n1 + k2
            if warp[-1] < m1:
                assert banks(tile_row(m2 * warp + k2, m2))


def _instance_exists(ny, nx):
    """The C dispatch instantiates the kernel at my nx <= 256 Ki."""
    return 2 * ny * nx <= 256 * 1024


@pytest.mark.parametrize("nx", POW2)
@pytest.mark.parametrize("ny", POW2)
def test_cluster_plan_invariants(ny, nx):
    my, mx = 2 * ny, 2 * nx
    shapes = cuda_fft.fused_c2r_cluster_shapes(ny, nx, my, mx)
    _, g, _ = cuda_fft._edge_shape(nx)
    keys = []
    for c, threads, smem, per_sm in shapes:
        t, rows = nx // c, ny // c
        assert c in cuda_fft.FUSED_R2C_CLUSTERS and nx % c == 0
        assert threads in cuda_fft.FUSED_R2C_THREADS and threads % t == 0
        assert t >= 4  # 16-byte copies of a tile row
        assert rows % max(1, 32 // g) == 0  # whole warps of c2r rows
        assert smem == cuda_fft._c2r_cluster_smem(ny, nx, my, c)
        assert smem <= cuda_fft.BLOCK_SHARED_MAX
        # the tile (my rows of t pairs) and the rows are inside the bytes
        assert 8 * my * t + 8 * rows * nx < smem
        assert 1 <= per_sm <= 512 // threads
        assert per_sm * (smem + cuda_fft.BLOCK_SHARED_RESERVE) \
            <= cuda_fft.SM_SHARED_BYTES
        assert _instance_exists(ny, nx)
        keys.append((-threads * per_sm, -per_sm, c))
    assert keys == sorted(keys)
    for a in (1, 7, 768):
        plan = cuda_fft.fused_c2r_cluster_plan(a, ny, nx, my, mx)
        if not shapes:
            assert plan == cuda_fft.FUSED_R2C_DENSE_PLAN
            assert not any(plan.args())
            continue
        c, threads, smem, per_sm = shapes[0]
        assert (plan.cluster, plan.threads, plan.smem, plan.blocks_per_sm) \
            == (c, threads, smem, per_sm)
        assert plan.bulk
        assert plan.clusters == min(a, SMS * per_sm // c)
        assert cuda_fft.fused_c2r_cluster_plan(
            a, ny, nx, my, mx, data_ptr=1 << 20 | 4).bulk is False


# (A, ny, nx) -> (C, threads, blocks an SM): the 256^3 vector solve's
# slabs, the rod's (256, 64, 256) and the 64^3 run's
MAIN_PLANS = {
    (768, 256, 256): (16, 256, 2),
    (768, 64, 256): (4, 256, 2),
    (192, 64, 64): (1, 256, 2),
}


@pytest.mark.parametrize("shape", MAIN_PLANS, ids=["256^3", "rod", "64^3"])
def test_cluster_plan_on_the_main_paths(shape):
    a, ny, nx = shape
    plan = cuda_fft.fused_c2r_cluster_plan(a, ny, nx, 2 * ny, 2 * nx, "cpu")
    assert (plan.cluster, plan.threads, plan.blocks_per_sm) \
        == MAIN_PLANS[shape]
    assert plan.clusters == min(a, SMS * plan.blocks_per_sm // plan.cluster)
    # a block's column tile: at 256^3 my x 16 pairs, 64 KB
    assert 8 * 2 * ny * nx // plan.cluster < plan.smem


# (ny, nx): mx or my not a power of two, and 512 x 512 slabs (a column
# tile of a cluster of 16: 1024 x 32 pairs, 256 KB)
DENSE_SHAPES = [(48, 32), (32, 48), (272, 64), (50, 64), (512, 512)]


@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_plan_where_no_cluster_holds_a_slab(shape):
    ny, nx = shape
    assert not cuda_fft.fused_c2r_cluster_shapes(ny, nx, 2 * ny, 2 * nx)
    assert cuda_fft.fused_c2r_cluster_plan(3, ny, nx, 2 * ny, 2 * nx) \
        == cuda_fft.FUSED_R2C_DENSE_PLAN


def test_cluster_plan_refuses_what_no_kernel_takes():
    plan = cuda_fft.fused_c2r_cluster_plan
    with pytest.raises(ValueError):
        plan(3, 32, 32, 96, 64)  # my != 2 ny
    with pytest.raises(ValueError):
        plan(3, 32, 30, 64, 60)  # unsupported length, nx not 4 k
    with pytest.raises(ValueError):
        plan(3, 1024, 32, 2048, 64)  # my above 1024
    with pytest.raises(ValueError):
        plan(0, 32, 32, 64, 64)  # no slab


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _launch(ins, out, plan, mx, nx):
    br, bi, sr = ins[:3]
    a, my, _ = br.shape
    xw = cuda_fft._x_table(mx, br.device).data_ptr() if not plan.cluster \
        else None
    return cuda_fft.library().sopht_ifft_irfft_pass_fused_f32(
        br.data_ptr(), bi.data_ptr(), sr.data_ptr(), out.data_ptr(),
        cuda_fft._table(my, br.device).data_ptr(),
        cuda_fft._table(mx, br.device).data_ptr(), xw, a, nx, mx, my,
        *plan.args(), torch.cuda.current_stream().cuda_stream)


def _card_spectra(a, ny, nx, dev, seed):
    return [torch.tensor(v, device=dev) for v in _spectra(a, ny, nx, seed)]


def _nan_out(a, ny, nx, dev):
    return torch.full((a, ny, nx), float("nan"), device=dev)


# (A, ny, nx): a ragged last round, the rod's and 256^3 solve's slabs, my
# up to 1024, nx up to 512, slabs only a cluster of 16 holds
CARD_SHAPES = [(7, 32, 32), (5, 32, 512), (3, 512, 128), (9, 128, 512),
               (768, 64, 256), (768, 256, 256), (3, 256, 512), (2, 512, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_at_every_cluster_on_card(shape):
    dev = _card()
    a, ny, nx = shape
    my, mx = 2 * ny, 2 * nx
    ins = _card_spectra(a, ny, nx, dev, a + ny + nx)
    ref = cuda_fft.ifft_irfft_pass_fused_ref(*ins, mx, nx).cpu().numpy()
    shapes = cuda_fft.fused_c2r_cluster_shapes(ny, nx, my, mx)
    assert shapes
    for c, threads, smem, per_sm in shapes:
        plan = cuda_fft.fused_c2r_plan_of(a, nx, my, c, threads, smem,
                                          per_sm, dev, ins[0].data_ptr())
        for p in {plan, plan._replace(clusters=min(2, a)),
                  plan._replace(bulk=False)}:
            out = _nan_out(a, ny, nx, dev)
            assert _launch(ins, out, p, mx, nx) == 0, p
            torch.cuda.synchronize()
            _close(out, ref)
    # the wrapper launches the planned kernel once
    before = cuda_fft.ifft_irfft_pass_fused.launches
    out = cuda_fft.ifft_irfft_pass_fused(*ins, mx, nx)
    torch.cuda.synchronize()
    assert cuda_fft.ifft_irfft_pass_fused.launches == before + 1
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 48, 32), (3, 32, 48), (2, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_kernel_at_the_dense_shapes_on_card(shape):
    dev = _card()
    a, ny, nx = shape
    my, mx = 2 * ny, 2 * nx
    ins = _card_spectra(a, ny, nx, dev, 5 + ny)
    assert cuda_fft.fused_c2r_cluster_plan(a, ny, nx, my, mx, dev) \
        == cuda_fft.FUSED_R2C_DENSE_PLAN
    before = cuda_fft.ifft_irfft_pass_fused.launches
    out = cuda_fft.ifft_irfft_pass_fused(*ins, mx, nx)
    torch.cuda.synchronize()
    assert cuda_fft.ifft_irfft_pass_fused.launches == before + 1
    _close(out, cuda_fft.ifft_irfft_pass_fused_ref(*ins, mx, nx).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_kernel_takes_a_storage_offset_on_card(offset):
    dev = _card()
    a, ny, nx = 5, 64, 64
    my, mx = 2 * ny, 2 * nx
    flat = torch.randn(2, a * my * nx + offset, device=dev)
    br, bi = (f[offset:].view(a, my, nx) for f in flat)
    sr, si = torch.randn(2, a, ny, 1, device=dev)
    plan = cuda_fft.fused_c2r_cluster_plan(a, ny, nx, my, mx, dev,
                                           br.data_ptr() | bi.data_ptr())
    assert plan.cluster and plan.bulk == (offset % 4 == 0)
    out = cuda_fft.ifft_irfft_pass_fused(br, bi, sr, si, mx, nx)
    torch.cuda.synchronize()
    _close(out, cuda_fft.ifft_irfft_pass_fused_ref(br, bi, sr, si, mx, nx)
           .cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(768, 256, 256), (768, 64, 256),
                                   (7, 32, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_launcher_refuses_another_plan_on_card(shape):
    dev = _card()
    a, ny, nx = shape
    my, mx = 2 * ny, 2 * nx
    ins = [torch.randn(s, device=dev) for s in ((a, my, nx), (a, my, nx),
                                                (a, ny, 1))]
    out = _nan_out(a, ny, nx, dev)
    plan = cuda_fft.fused_c2r_cluster_plan(a, ny, nx, my, mx, dev,
                                           ins[0].data_ptr())
    assert _launch(ins, out, plan, mx, nx) == 0
    torch.cuda.synchronize()
    other = 2 if plan.cluster != 2 else 4
    wrongs = [cuda_fft.FUSED_R2C_DENSE_PLAN,  # no quiet dense fallback
              plan._replace(smem=plan.smem + 8),
              plan._replace(cluster=other),
              plan._replace(cluster=32),  # above Hopper's 16
              plan._replace(threads=128),
              plan._replace(clusters=0),
              plan._replace(clusters=a + 1)]
    if plan.clusters < a:
        wrongs.append(plan._replace(clusters=plan.clusters + 1))
    for wrong in wrongs:
        assert _launch(ins, out, wrong, mx, nx) != 0, wrong
    # 16-byte copies from a pointer off 16 bytes, an output off 16 bytes
    off = torch.randn(a * my * nx + 1, device=dev)[1:].view(a, my, nx)
    assert _launch([off, *ins[1:]], out, plan, mx, nx) != 0
    out1 = torch.empty(a * ny * nx + 1, device=dev)[1:].view(a, ny, nx)
    assert _launch(ins, out1, plan, mx, nx) != 0
    # the dense plan at a dense shape runs, a cluster plan there is refused
    dense_ins = [torch.randn(s, device=dev) for s in ((3, 96, 32),
                                                      (3, 96, 32), (3, 48, 1))]
    od = _nan_out(3, 48, 32, dev)
    dense = cuda_fft.FUSED_R2C_DENSE_PLAN
    assert _launch(dense_ins, od, dense, 64, 32) == 0
    assert _launch(dense_ins, od, plan._replace(clusters=3), 64, 32) != 0
    torch.cuda.synchronize()
