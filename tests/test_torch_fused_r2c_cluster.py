"""The fused forward edge pass's thread-block-cluster kernel
(``rfft_fft_cluster_kernel`` behind ``rfft_fft_pass_fused``,
``csrc/fft_passes.cu``): its arithmetic and walk, its launch plan and, on
the card, the kernel.

- A numpy model of the cluster walk: persistent clusters taking slabs
  a = cluster + k clusters (a ragged last round where the clusters do not
  divide A); in each slab, block r's rows [r ny/C, (r+1) ny/C) through the
  packed nx-point FFT and the split step (W_mx^k rounded to float32), each
  bulk X[y, kx] pushed to the owner of column kx (rank kx / t, t = nx / C)
  at row y of its [y][kx local] buffer of my rows; the owner's y phase in
  place (the first factor reads rows n1 + m1 n2 and writes slots
  k2 m1 + n1, the upper rows starting as NaN), then the second factor into
  the output columns r t .. r t + t. Against numpy's float64 result at
  every cluster size and my = 64 ... 1024, and against the JAX package's
  ``rfft_fft_pass_fused`` (Pallas in interpret mode).
- :func:`cuda_fft.fused_r2c_cluster_plan`, the plan the C launcher checks:
  its invariants at every power-of-two shape the gate takes, its plans at
  the 256^3 solve's, the rod's and the 64^3 run's shapes, the all-zero
  (dense-x kernel) plan where mx or my is not a power of two and at
  512 x 512 slabs, and what it refuses.
- ``cuda`` marker (skipped without a card): the kernel against the plain
  version at every cluster size the plan can give and under the dense-x
  kernel's plans, with the launch counter; an input with a storage offset;
  the launcher refusing any other plan. On the card, without JAX installed:
  ``python -m pytest tests/test_torch_fused_r2c_cluster.py -m cuda
  --noconftest``.

Tolerance: ``FFT_TOL = 5e-6 max|ref|``, as ``chip_smoke.py`` holds the
kernel: float32 rounding of an r2c and an FFT of length <= 1024, whose
error grows like log m (the model sits near 1e-7 of numpy's float64).
"""

import itertools

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.parallel import cuda_fft

FFT_TOL = 5e-6
POW2 = [32, 64, 128, 256, 512]  # ny, nx: doubled lengths 64 ... 1024
SMS = cuda_fft.H100_SMS


def _slabs(a, ny, nx, seed):
    return np.random.default_rng(seed).standard_normal((a, ny, nx)) \
        .astype(np.float32)


def _np_fused(x, mx, my):
    """numpy's float64 r2c along x and FFT along y: bulk (A, my, mx/2) and
    Nyquist (A, ny, 1)."""
    z = np.fft.rfft(x.astype(np.float64), n=mx, axis=2)
    bulk = np.fft.fft(z[..., : mx // 2], n=my, axis=1)
    return bulk.real, bulk.imag, z[..., mx // 2:].real, z[..., mx // 2:].imag


def _r2c_rows(rows, mx):
    """The x phase of one block: the packed nx-point FFT of
    z[n] = x[2n] + i x[2n+1] and the split step, as the kernel orders it
    (X[k] and X[h - k] from the pair (k, h - k), X[h] at k = 0)."""
    n, nx = rows.shape
    h = nx
    z = np.zeros((n, h), complex)
    z[:, : nx // 2] = rows[:, 0::2] + 1j * rows[:, 1::2]
    zf = np.fft.fft(z, axis=1)
    out = np.empty((n, h + 1), complex)
    w = np.exp(-2j * np.pi * np.arange(h) / mx).astype(np.complex64)
    for k in range(h // 2 + 1):
        a, c = zf[:, k], np.conj(zf[:, (h - k) % h])
        e, o = (a + c) / 2, w[k] * (a - c) / 2
        out[:, k] = e - 1j * o
        if k < h // 2:
            out[:, h - k] = np.conj(e) - 1j * np.conj(o)
    return out


def _walk(a, clusters):
    """Each cluster's slabs in the order it takes them."""
    return [list(range(c, a, clusters)) for c in range(clusters)]


def cluster_model(x, mx, my, c, clusters):
    """The kernel's walk and arithmetic in numpy (see the module note)."""
    a, ny, nx = x.shape
    t, rows = nx // c, ny // c
    m1, m2 = cuda_fft.best_factors(my)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m2)) / my) \
        .astype(np.complex64)
    br = np.full((a, my, nx), np.nan)
    bi, sr, si = br.copy(), np.full((a, ny, 1), np.nan), np.full((a, ny, 1),
                                                                  np.nan)
    for slabs in _walk(a, clusters):
        for s in slabs:
            # the owners' slot buffers: the spectrum's ny rows, then slots
            bufs = np.full((c, my, t), np.nan, complex)
            for r in range(c):
                spec = _r2c_rows(x[s, r * rows:(r + 1) * rows].astype(
                    np.float64), mx)
                y = np.arange(r * rows, (r + 1) * rows)
                sr[s, y, 0], si[s, y, 0] = spec[:, nx].real, spec[:, nx].imag
                for kx in range(nx):  # the pushes
                    bufs[kx // t, y, kx % t] = spec[:, kx]
            for r in range(c):
                buf = bufs[r]
                for n1 in range(m1):  # the first factor, in place
                    v = buf[n1 + m1 * np.arange(m2 // 2)]
                    assert not np.isnan(v).any()
                    f = np.fft.fft(v, n=m2, axis=0)
                    buf[np.arange(m2) * m1 + n1] = f * tw[n1][:, None]
                out = np.empty((my, t), complex)
                for k2 in range(m2):  # the second factor
                    f = np.fft.fft(buf[k2 * m1:(k2 + 1) * m1], axis=0)
                    out[k2 + m2 * np.arange(m1)] = f
                br[s, :, r * t:(r + 1) * t] = out.real
                bi[s, :, r * t:(r + 1) * t] = out.imag
    return br, bi, sr, si


def _close(outs, refs, tol=FFT_TOL):
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        assert out.shape == np.shape(ref), (out.shape, np.shape(ref))
        err = float(np.abs(out.astype(np.float64) - ref).max())
        assert err <= tol * scale, f"max|diff| {err} > {tol} * {scale}"


# (ny, nx): my = 64 ... 1024, nx / C down to 4 columns a block
MODEL_SHAPES = [(32, 32), (64, 32), (32, 64), (128, 64), (512, 32),
                (32, 256)]


@pytest.mark.parametrize("clusters", ["all", 2], ids=["one-round", "ragged"])
@pytest.mark.parametrize("c", cuda_fft.FUSED_R2C_CLUSTERS)
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_matches_numpy(shape, c, clusters):
    ny, nx = shape
    a = 5
    x = _slabs(a, ny, nx, ny + nx + c)
    out = cluster_model(x, 2 * nx, 2 * ny, c, a if clusters == "all" else 2)
    _close(out, _np_fused(x, 2 * nx, 2 * ny))


JAX_SHAPES = [(32, 32), (64, 32), (32, 64)]


@pytest.mark.parametrize("shape", JAX_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_matches_jax(shape):
    import jax.numpy as jnp

    from sopht_mpi_tpu.parallel import pallas_fft as jax_fft

    assert jax_fft._use_interpret()  # the Pallas kernel, in interpret mode
    ny, nx = shape
    a, mx, my = 5, 2 * nx, 2 * ny
    x = _slabs(a, ny, nx, 3 * ny + nx)
    ref = [np.asarray(v) for v in jax_fft.rfft_fft_pass_fused(
        jnp.asarray(x), mx, my)]
    for c in cuda_fft.FUSED_R2C_CLUSTERS:  # every cluster size, ragged
        _close(cluster_model(x, mx, my, c, 2), ref)
    # the wrapper on a CPU tensor (its plain version), launching nothing
    before = cuda_fft.rfft_fft_pass_fused.launches
    _close(cuda_fft.rfft_fft_pass_fused(torch.tensor(x), mx, my), ref)
    assert cuda_fft.rfft_fft_pass_fused.launches == before


@pytest.mark.parametrize("clusters", [1, 3, 7, 16])
def test_walk_covers_every_slab_once(clusters):
    a = 48
    walks = _walk(a, clusters)
    assert sorted(itertools.chain(*walks)) == list(range(a))
    # a ragged last round: clusters differ by at most one slab, and every
    # block of a cluster walks its cluster's slabs (the same barriers)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


def _instance_exists(ny, nx):
    """The C dispatch instantiates the kernel where a cluster of 16 can
    hold the slots: my nx <= 256 Ki."""
    return 2 * ny * nx <= 256 * 1024


@pytest.mark.parametrize("nx", POW2)
@pytest.mark.parametrize("ny", POW2)
def test_cluster_plan_invariants(ny, nx):
    my, mx = 2 * ny, 2 * nx
    shapes = cuda_fft.fused_r2c_cluster_shapes(ny, nx, my, mx)
    if not _instance_exists(ny, nx):
        assert not shapes
    keys = []
    for c, threads, smem, per_sm in shapes:
        t = nx // c
        assert c in cuda_fft.FUSED_R2C_CLUSTERS and nx % c == 0
        assert threads in cuda_fft.FUSED_R2C_THREADS and threads % t == 0
        assert ny % c == 0 and (ny // c) * nx * 4 % 16 == 0  # bulk span
        assert smem == cuda_fft._cluster_smem(ny, nx, my, c, threads)
        assert smem <= cuda_fft.BLOCK_SHARED_MAX
        # the slots (my rows of t pairs) are inside the block's bytes
        assert 8 * my * t < smem
        assert 1 <= per_sm <= 512 // threads
        assert per_sm * (smem + cuda_fft.BLOCK_SHARED_RESERVE) \
            <= cuda_fft.SM_SHARED_BYTES
        assert _instance_exists(ny, nx)
        keys.append((-threads * per_sm, -per_sm, c))
    assert keys == sorted(keys)
    for a in (1, 7, 768):
        plan = cuda_fft.fused_r2c_cluster_plan(a, ny, nx, my, mx)
        if not shapes:
            assert plan == cuda_fft.FUSED_R2C_DENSE_PLAN
            assert not any(plan.args())
            continue
        c, threads, smem, per_sm = shapes[0]
        assert (plan.cluster, plan.threads, plan.smem, plan.blocks_per_sm) \
            == (c, threads, smem, per_sm)
        assert plan.bulk
        assert plan.clusters == min(a, SMS * per_sm // c)
        assert cuda_fft.fused_r2c_cluster_plan(
            a, ny, nx, my, mx, data_ptr=1 << 20 | 4).bulk is False


# (A, ny, nx) -> (C, threads, clusters a block an SM): the 256^3 vector
# solve's slabs, the rod's (256, 64, 256) and the 64^3 run's
MAIN_PLANS = {
    (768, 256, 256): (16, 256, 2),
    (768, 64, 256): (4, 256, 2),
    (192, 64, 64): (1, 256, 2),
}


@pytest.mark.parametrize("shape", MAIN_PLANS, ids=["256^3", "rod", "64^3"])
def test_cluster_plan_on_the_main_paths(shape):
    a, ny, nx = shape
    plan = cuda_fft.fused_r2c_cluster_plan(a, ny, nx, 2 * ny, 2 * nx, "cpu")
    assert (plan.cluster, plan.threads, plan.blocks_per_sm) \
        == MAIN_PLANS[shape]
    assert plan.clusters == min(a, SMS * plan.blocks_per_sm // plan.cluster)
    # the slab's spectrum is spread over the cluster: at 256^3 512 KB over
    # 16 blocks, 32 KB of spectrum and 32 KB of slots a block
    assert 8 * 2 * ny * nx // plan.cluster < plan.smem


# (ny, nx): mx or my not a power of two, and 512 x 512 slabs (slots 4 MB)
DENSE_SHAPES = [(48, 32), (32, 48), (272, 64), (50, 64), (512, 512)]


@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dense_plan_where_no_cluster_holds_a_slab(shape):
    ny, nx = shape
    assert not cuda_fft.fused_r2c_cluster_shapes(ny, nx, 2 * ny, 2 * nx)
    assert cuda_fft.fused_r2c_cluster_plan(3, ny, nx, 2 * ny, 2 * nx) \
        == cuda_fft.FUSED_R2C_DENSE_PLAN


def test_cluster_plan_refuses_what_no_kernel_takes():
    plan = cuda_fft.fused_r2c_cluster_plan
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


def _launch(x, plan, outs, mx, my):
    a, ny, nx = x.shape
    xw = cuda_fft._x_table(mx, x.device).data_ptr() if not plan.cluster \
        else None
    return cuda_fft.library().sopht_rfft_fft_pass_fused_f32(
        x.data_ptr(), *(o.data_ptr() for o in outs),
        cuda_fft._table(my, x.device).data_ptr(),
        cuda_fft._table(mx, x.device).data_ptr(), xw, a, nx, mx, my,
        *plan.args(), torch.cuda.current_stream().cuda_stream)


def _outs(a, ny, nx, dev):
    return [torch.full((a, 2 * ny, nx), float("nan"), device=dev)
            for _ in range(2)] + [torch.full((a, ny, 1), float("nan"),
                                             device=dev) for _ in range(2)]


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
    x = torch.tensor(_slabs(a, ny, nx, a + ny + nx), device=dev)
    ref = cuda_fft.rfft_fft_pass_fused_ref(x, mx, my)
    shapes = cuda_fft.fused_r2c_cluster_shapes(ny, nx, my, mx)
    assert shapes
    for c, threads, smem, per_sm in shapes:
        plan = cuda_fft.fused_r2c_plan_of(a, nx, my, c, threads, smem,
                                          per_sm, dev, x.data_ptr())
        for p in {plan, plan._replace(clusters=min(2, a))}:
            outs = _outs(a, ny, nx, dev)
            assert _launch(x, p, outs, mx, my) == 0, p
            torch.cuda.synchronize()
            _close(outs, [r.cpu().numpy() for r in ref])
    # the wrapper launches the planned kernel once
    before = cuda_fft.rfft_fft_pass_fused.launches
    out = cuda_fft.rfft_fft_pass_fused(x, mx, my)
    torch.cuda.synchronize()
    assert cuda_fft.rfft_fft_pass_fused.launches == before + 1
    _close(out, [r.cpu().numpy() for r in ref])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 48, 32), (3, 32, 48), (2, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_kernel_at_the_dense_shapes_on_card(shape):
    dev = _card()
    a, ny, nx = shape
    my, mx = 2 * ny, 2 * nx
    x = torch.tensor(_slabs(a, ny, nx, 5 + ny), device=dev)
    assert cuda_fft.fused_r2c_cluster_plan(a, ny, nx, my, mx, dev) \
        == cuda_fft.FUSED_R2C_DENSE_PLAN
    before = cuda_fft.rfft_fft_pass_fused.launches
    out = cuda_fft.rfft_fft_pass_fused(x, mx, my)
    torch.cuda.synchronize()
    assert cuda_fft.rfft_fft_pass_fused.launches == before + 1
    _close(out, [r.cpu().numpy()
                 for r in cuda_fft.rfft_fft_pass_fused_ref(x, mx, my)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_kernel_takes_a_storage_offset_on_card(offset):
    dev = _card()
    a, ny, nx = 5, 64, 64
    flat = torch.randn(a * ny * nx + offset, device=dev)
    x = flat[offset:].view(a, ny, nx)
    plan = cuda_fft.fused_r2c_cluster_plan(a, ny, nx, 2 * ny, 2 * nx, dev,
                                           x.data_ptr())
    assert plan.cluster and plan.bulk == (offset % 4 == 0)
    out = cuda_fft.rfft_fft_pass_fused(x, 2 * nx, 2 * ny)
    torch.cuda.synchronize()
    _close(out, [r.cpu().numpy() for r in
                 cuda_fft.rfft_fft_pass_fused_ref(x, 2 * nx, 2 * ny)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(768, 256, 256), (768, 64, 256),
                                   (7, 32, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_launcher_refuses_another_plan_on_card(shape):
    dev = _card()
    a, ny, nx = shape
    my, mx = 2 * ny, 2 * nx
    x = torch.randn(a, ny, nx, device=dev)
    outs = _outs(a, ny, nx, dev)
    plan = cuda_fft.fused_r2c_cluster_plan(a, ny, nx, my, mx, dev,
                                           x.data_ptr())
    assert _launch(x, plan, outs, mx, my) == 0
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
        assert _launch(x, wrong, outs, mx, my) != 0, wrong
    # bulk copies from a pointer off 16 bytes: refused
    x1 = torch.randn(a * ny * nx + 1, device=dev)[1:].view(a, ny, nx)
    assert _launch(x1, plan, outs, mx, my) != 0
    # the dense plan at a dense shape runs, a cluster plan there is refused
    xd = torch.randn(3, 48, 32, device=dev)
    od = _outs(3, 48, 32, dev)
    dense = cuda_fft.FUSED_R2C_DENSE_PLAN
    assert _launch(xd, dense, od, 64, 96) == 0
    assert _launch(xd, plan._replace(clusters=3), od, 64, 96) != 0
    torch.cuda.synchronize()
