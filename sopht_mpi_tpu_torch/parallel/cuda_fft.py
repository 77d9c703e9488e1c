"""Hopper CUDA kernels for the FFT passes of the free-space Poisson
convolution (the five exact-tier passes, the fast tier's fused-curl pair,
the unsplit x passes and the fused edge passes), with their plain
``torch.fft`` versions.

The passes keep the JAX package's layout at their signatures: spectra are
split real/imag float32 pairs; the middle-axis passes take (A, L, B) arrays
with the transform along L; the x-edge passes take (R, n) rows with the
transform along the last axis and the kx Nyquist column split off. Each
wrapper:

- on a CUDA tensor launches its kernel from ``csrc/fft_passes.cu`` on the
  current stream, without synchronising, and adds one to its ``launches``
  count (or raises: there is no fallback);
- on a CPU tensor returns its plain version (``*_ref``): ``torch.fft`` with
  the padding and truncation written out, as the JAX package writes each
  pass's VJP reference.

Every pass takes float32 only, and lengths ``m`` with
:func:`kernel_fft_supported`.

Reverse mode: where autograd records a call (an input requires a gradient)
the wrapper goes through a ``torch.autograd.Function`` whose backward is the
JAX package's rule in ``torch.fft``: the analytic adjoint for the five
exact-tier passes and the unsplit x passes (``*Fn`` classes below; they
save only what the rule reads, the Green's multiplier and, where the
Green's multiplier needs a gradient, the input), and the VJP of the plain
version for the fast tier's pair and the fused edge passes
(``_autograd.PlainVJP``). The backward launches no kernel: ``launches``
counts forward launches.

Replaced TPU kernels (``sopht_mpi_tpu/parallel/pallas_fft.py``):
:func:`rfft_pass_padded_split` <- ``_rfft_pass_padded_split_impl``,
:func:`fft_pass_padded` <- ``_fft_pass_padded_impl``,
:func:`fft_greens_ifft_pass` <- ``_fft_greens_ifft_pass_impl``,
:func:`ifft_pass_truncated` <- ``_ifft_pass_truncated_impl``,
:func:`irfft_pass_merge` <- ``_irfft_pass_merge_impl``,
:func:`fft_greens_curl_ifft_pass` <- ``_fft_greens_curl_ifft_pass_impl``,
:func:`irfft_pass_merge_velocity` <- ``_irfft_pass_merge_velocity_impl``,
:func:`rfft_pass_padded` <- ``_rfft_pass_padded_impl``,
:func:`irfft_pass_truncated` <- ``_irfft_pass_truncated_impl``,
:func:`rfft_fft_pass_fused` <- ``_rfft_fft_pass_fused_impl``,
:func:`ifft_irfft_pass_fused` <- ``_ifft_irfft_pass_fused_impl``.

The forward x-edge r2c pair (split and unsplit) launches with the plan
:func:`edge_tile_plan` gives (rows a tile, persistent blocks, ring stages,
shared bytes, bulk copies), the c2r pair with that of
:func:`c2r_tile_plan`, the fast tier's c2r :func:`irfft_pass_merge_velocity`
with that of :func:`c2r_velocity_tile_plan`, the z conv
:func:`fft_greens_ifft_pass` with
the plan of :func:`zconv_tile_plan` (columns a tile, persistent blocks,
ring stages, shared bytes, 16-byte copies; none at the lengths of the
four-step kernel, which plans its own launch), the fast tier's z pass
:func:`fft_greens_curl_ifft_pass` with that of
:func:`zconv_curl_tile_plan`, the fused forward edge
:func:`rfft_fft_pass_fused` with that of :func:`fused_r2c_cluster_plan`
(cluster size, threads, clusters, shared bytes, bulk copies) and the fused
inverse :func:`ifft_irfft_pass_fused` with that of
:func:`fused_c2r_cluster_plan`; the C launchers refuse any other.

The unsplit x passes keep the kx Nyquist column in the row ((R, m/2 + 1)
pairs); no solver route calls them, they are the public pass API. The fused
edge passes fold the x r2c into the y forward pass and the y inverse into
the x c2r, so the (A, ny, mx/2) spectrum between them never reaches device
memory; the 3D convolve takes them where :func:`fused_edge_pass_ok`, which
the module flag ``USE_FUSED_EDGE_PASSES`` keeps off by default.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from sopht_mpi_tpu_torch.ops._autograd import kernel_or_plain_vjp, needs_grad

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sopht_fft_pass_padded_f32": (_P, _P, _P, _P, _P, _I, _L, _I, _P),
    "sopht_ifft_pass_truncated_f32": (_P, _P, _P, _I, _P, _P, _P, _I, _L, _I,
                                      _P),
    "sopht_fft_greens_ifft_pass_f32": (_P, _P, _P, _P, _P, _P, _I, _L, _I,
                                       *(_I,) * 6, _P),
    "sopht_rfft_pass_padded_split_f32": (_P, _P, _P, _P, _P, _P, _L, _I, _I,
                                         *(_I,) * 6, _P),
    "sopht_irfft_pass_merge_f32": (_P, _P, _P, _P, _P, _L, _I, _I,
                                   *(_I,) * 6, _P),
    "sopht_fft_greens_curl_ifft_pass_f32": (_P, _P, _P, _P, _P, _P, _P, _P,
                                            _L, _I, *(_I,) * 6, _P),
    "sopht_irfft_pass_merge_velocity_f32": (_P, _P, _P, _P, _P, _P, _P, _L,
                                            _I, _I, _I, _I, *(_I,) * 6, _P),
    "sopht_rfft_pass_padded_f32": (_P, _P, _P, _P, _L, _I, _I, *(_I,) * 6, _P),
    "sopht_irfft_pass_truncated_f32": (_P, _P, _P, _P, _L, _I, _I,
                                       *(_I,) * 6, _P),
    "sopht_rfft_fft_pass_fused_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, *(_I,) * 5, _P),
    "sopht_ifft_irfft_pass_fused_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, *(_I,) * 5, _P),
}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/fft_passes.cu``."""
    from sopht_mpi_tpu_torch._build import load_library

    return _bind(load_library("fft_passes", ("fft_passes.cu",)))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sopht_fft_table_floats.argtypes = (_I,)
    lib.sopht_fft_table_floats.restype = ctypes.c_int
    lib.sopht_fft_fill_table.argtypes = (_I, _P)
    lib.sopht_fft_fill_table.restype = ctypes.c_int
    lib.sopht_fused_cluster_capacity.argtypes = (_I,) * 6
    lib.sopht_fused_cluster_capacity.restype = ctypes.c_int
    lib.sopht_fft_error_string.argtypes = (_I,)
    lib.sopht_fft_error_string.restype = ctypes.c_char_p
    return lib


def best_factors(m: int) -> tuple[int, int]:
    """``m = m1 * m2`` with ``m1`` the largest divisor ``<= sqrt(m)`` (the
    JAX package's ``mxu_fft._best_factors``)."""
    for m1 in range(math.isqrt(m), 0, -1):
        if m % m1 == 0:
            return m1, m // m1
    raise ValueError(f"no factors of {m}")


def kernel_fft_supported(m: int) -> bool:
    """Transform lengths the kernels take: ``64 <= m <= 1024`` with
    ``m1 >= 4`` and ``m2`` even (the JAX package's
    ``pallas_fft_supported``)."""
    if not 64 <= m <= 1024:
        return False
    m1, m2 = best_factors(m)
    return m1 >= 4 and m2 % 2 == 0


# Shared memory of one H100 SM and the most one block may take (228 KB and
# 227 KB), the 1 KB the runtime reserves for each resident block, and the
# card's SM count (the plan's default where no CUDA device is asked).
SM_SHARED_BYTES = 233472
BLOCK_SHARED_MAX = 232448
BLOCK_SHARED_RESERVE = 1024
H100_SMS = 132


class EdgeTilePlan(NamedTuple):
    """How an x-edge kernel (the r2c or the c2r) covers its (R, .) rows:
    ``rows`` a tile (T, a multiple of 4), ``blocks`` (persistent, at most
    the tiles), ``stages`` of the input ring (0: the four-step kernel, one
    tile a block), ``smem`` bytes a block, ``bulk`` input copies,
    ``threads`` a block and the ``blocks_per_sm`` the plan counts on being
    resident."""

    rows: int
    blocks: int
    stages: int
    smem: int
    bulk: bool
    threads: int
    blocks_per_sm: int

    def args(self):
        """The plan as the C entry points take it."""
        return (self.rows, self.blocks, self.stages, self.smem,
                int(self.bulk), self.threads)


def _edge_shape(h: int):
    """(values a lane holds, lanes a row, pad shift) at h = m/2: the
    ``EdgeShape`` of ``csrc/fft_passes.cu``."""
    p = 16 if h >= 64 else 8
    return p, h // p, 4 if h in (32, 512) else 5


def _edge_twiddles(h: int) -> int:
    """float2 twiddles of the r2c / c2r design at h = m/2: the W_m line
    (h entries) and the Stockham pass tables (``EdgeShape::TW``)."""
    p, _, _ = _edge_shape(h)
    tw, ns = h, p
    while ns < h:
        r = min(p, h // ns)
        tw, ns = tw + ns * r, ns * r
    return tw


def _edge_twiddles_and_work(h: int, t: int) -> int:
    """Shared bytes both ring kernels hold whatever their data: the
    twiddles (the W_m line, the pass tables) and the work buffers of ``t``
    rows."""
    _, _, sh = _edge_shape(h)
    return 8 * _edge_twiddles(h) + 8 * t * (h + (h >> sh))


def _edge_smem(h: int, t: int, n_in: int, stages: int, unsplit: bool) -> int:
    """Shared bytes of the r2c ring kernel: twiddles and work buffers, the
    input ring, two output staging buffers and the stages' barriers."""
    ld = h + 1 if unsplit else h
    out = 2 * t * ld + (0 if unsplit else 2 * t)
    return (_edge_twiddles_and_work(h, t) + 4 * stages * t * n_in + 8 * out
            + 8 * stages)


def _c2r_smem(h: int, t: int, n_out: int, stages: int, unsplit: bool) -> int:
    """Shared bytes of the c2r ring kernel: twiddles and work buffers, the
    input ring (re and im rows, the side column when split), two output
    staging buffers and the stages' barriers."""
    ld = h + 1 if unsplit else h
    stage = 2 * t * ld + (0 if unsplit else t)
    return (_edge_twiddles_and_work(h, t) + 4 * stages * stage + 8 * t * n_out
            + 8 * stages)


def _register_classes(m: int):
    """(m1, m2, M1, H2): the four-step factors of ``m`` and the register
    classes the kernels are instantiated for (``Plan::m1c``, ``h2c``)."""
    m1, m2 = best_factors(m)
    return (m1, m2, 8 if m1 <= 8 else 16 if m1 <= 16 else 32,
            8 if m2 // 2 <= 8 else 16 if m2 // 2 <= 16 else 24)


def _four_step_edge_plan(rows: int, m: int, data) -> EdgeTilePlan:
    """The plan of a four-step x-edge kernel, which lengths with a factor
    that is not a power of two take: its ``pick_tile`` (the largest of 32,
    16, 8, 4 rows whose ``data(t)`` bytes fit 96 KB), one tile a block, no
    ring."""
    m1, m2, m1c, h2c = _register_classes(m)
    t = next(t for t in (32, 16, 8, 4) if data(t) <= 96 * 1024)
    smem = 8 * (m1 * m1c + m2 * h2c + m) + data(t)
    per_sm = min(3, SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVE))
    return EdgeTilePlan(t, -(-rows // t), 0, smem, False, 256, per_sm)


def edge_tile_plan(rows: int, n_in: int, m: int, unsplit: bool,
                   data_ptr: int, sms: int = H100_SMS) -> EdgeTilePlan:
    """The launch plan of :func:`rfft_pass_padded_split` (``unsplit``
    False) or :func:`rfft_pass_padded` (True) on (``rows``, ``n_in``) rows
    at ``data_ptr``, zero-padded to ``m``, on a card of ``sms`` SMs. The C
    entry points refuse any other plan.

    Power-of-two ``m``: the ring kernel. A row takes ``G = h / P`` lanes
    of ``P`` values (h = m/2, P = 16, 8 at m = 64: G = 4 at m <= 128, 8, 16,
    32 at m = 256, 512, 1024), a tile one row per lane group of four warps,
    halved while the tiles would not give two blocks an SM and T stays a
    multiple of 4 (the 2D route's 256 rows at m = 1024: 64 tiles of 4).
    As many blocks an SM as fit with a 3-stage ring (128 registers a thread,
    the kernel's bound), then as many stages (up to 4) as still fit; the
    input moves by bulk copies when its pointer is 16-byte aligned. Other
    lengths: the four-step kernel's plan."""
    _check_length(m)
    if not 0 < n_in <= m // 2 or rows <= 0:
        raise ValueError(f"no plan for {rows} rows of {n_in} at m = {m}")
    return _edge_tile_plan(rows, n_in, m, unsplit, data_ptr % 16 == 0, sms)


@functools.lru_cache(maxsize=64)
def _edge_tile_plan(rows, n_in, m, unsplit, aligned, sms):
    h = m // 2
    if m & (m - 1):
        return _four_step_edge_plan(rows, m, lambda t: 8 * m * t + max(
            8 * (h + 1) * (t + 1), 4 * n_in * (t + 1)))
    return _ring_plan(rows, h, aligned, sms,
                      lambda t, s: _edge_smem(h, t, n_in, s, unsplit), 3)


def c2r_tile_plan(rows: int, n_out: int, m: int, unsplit: bool,
                  data_ptr: int, sms: int = H100_SMS) -> EdgeTilePlan:
    """The launch plan of :func:`irfft_pass_merge` (``unsplit`` False) or
    :func:`irfft_pass_truncated` (True) on ``rows`` rows of the half
    spectrum at length ``m`` into ``n_out`` reals, the input pointers (bulk
    and side column), or-ed together, ``data_ptr``, on a card of ``sms``
    SMs. The C entry points refuse any other plan.

    Power-of-two ``m``: the c2r ring kernel, tiles as
    :func:`edge_tile_plan` chooses them (one row a lane group of G = h / P
    lanes), as many blocks an SM as fit with a 2-stage ring, then as many
    stages as still fit, the input moving by bulk copies when ``data_ptr``
    is 16-byte aligned. A c2r stage holds twice the r2c's input, so the
    r2c's 3-stage rule would cost it a block an SM: at 256^3 three blocks
    of two stages take 0.213 ms of device time on an H100, two of four
    0.233 (``tools/probe_edge_passes.py --sweep``). Other lengths: the
    four-step kernel's plan."""
    _check_length(m)
    if not 0 < n_out <= m // 2 or rows <= 0:
        raise ValueError(f"no plan for {rows} rows into {n_out} at m = {m}")
    return _c2r_tile_plan(rows, n_out, m, unsplit, data_ptr % 16 == 0, sms)


@functools.lru_cache(maxsize=64)
def _c2r_tile_plan(rows, n_out, m, unsplit, aligned, sms):
    h = m // 2
    if m & (m - 1):
        return _four_step_edge_plan(
            rows, m, lambda t: 8 * m * t + 8 * (h + 1) * (t + 1))
    return _ring_plan(rows, h, aligned, sms,
                      lambda t, s: _c2r_smem(h, t, n_out, s, unsplit), 2)


#: the plan of the four-step velocity kernel (every field 0): it plans its
#: own launch
FOUR_STEP_VELOCITY_PLAN = EdgeTilePlan(0, 0, 0, 0, False, 0, 0)


def c2r_velocity_tile_plan(rows: int, n_out: int, m: int, data_ptr: int,
                           sms: int = H100_SMS) -> EdgeTilePlan:
    """The launch plan of :func:`irfft_pass_merge_velocity` on three
    components of ``rows`` (nz ny) rows of the half spectrum at length
    ``m`` into ``n_out`` reals, the input pointers (bulk and side column),
    or-ed together, ``data_ptr``, on a card of ``sms`` SMs. The C entry
    point refuses any other plan.

    Power-of-two ``m``: the c2r ring kernel's plan for ``rows`` split rows
    (:func:`c2r_tile_plan`; the kernel's shared memory is the c2r's). A
    block takes its tiles' three (tile, component) units in turn, so the
    blocks are counted in tiles. Copies and stores are bulk where every
    component's spans are 16-byte aligned: ``data_ptr`` aligned and
    ``rows`` a multiple of 4 (else component 1's side column and output
    start off 16 bytes); otherwise ordinary loads and stores. Other
    lengths: :data:`FOUR_STEP_VELOCITY_PLAN`."""
    _check_length(m)
    if not 0 < n_out <= m // 2 or rows <= 0:
        raise ValueError(f"no plan for {rows} rows into {n_out} at m = {m}")
    if m & (m - 1):
        return FOUR_STEP_VELOCITY_PLAN
    return _c2r_tile_plan(rows, n_out, m, False,
                          data_ptr % 16 == 0 and rows % 4 == 0, sms)


def _ring_plan(rows, h, aligned, sms, smem, ring) -> EdgeTilePlan:
    """The ring kernels' plan at h = m/2 for ``rows`` rows, ``smem(t,
    stages)`` the kernel's shared bytes: a row a lane group, a tile one row
    per lane group of four warps, halved while the tiles would not give two
    blocks an SM and T stays a multiple of 4; as many blocks an SM as fit
    with a ``ring``-stage ring (at most 512 threads: 128 registers a thread,
    the kernels' bound), then as many stages (up to 4) as still fit."""
    _, g, _ = _edge_shape(h)
    per_warp = 32 // g
    warps = 4
    while (warps > 1 and -(-rows // (warps * per_warp)) < 2 * sms
           and (warps // 2 * per_warp) % 4 == 0):
        warps //= 2
    t, threads = warps * per_warp, warps * 32

    def fits(per_sm, stages):
        return smem(t, stages) <= BLOCK_SHARED_MAX and \
            per_sm * (smem(t, stages) + BLOCK_SHARED_RESERVE) \
            <= SM_SHARED_BYTES

    per_sm = next((b for b in range(512 // threads, 0, -1)
                   if fits(b, ring)), 1)
    stages = max(s for s in (2, 3, 4) if fits(per_sm, s))
    return EdgeTilePlan(t, min(-(-rows // t), per_sm * sms), stages,
                        smem(t, stages), aligned, threads, per_sm)


class ZconvTilePlan(NamedTuple):
    """How the z conv kernel covers (A, m/2, B) pairs: ``cols`` a tile,
    ``blocks`` (persistent, at most the tiles), ``stages`` of the input ring,
    ``smem`` bytes a block, ``bulk`` (16-byte input copies), ``threads`` a
    block (``cols`` x m1) and the ``blocks_per_sm`` the plan counts on being
    resident. :data:`FOUR_STEP_ZCONV_PLAN` (every field 0) for the lengths
    the four-step kernel takes: it plans its own launch."""

    cols: int
    blocks: int
    stages: int
    smem: int
    bulk: bool
    threads: int
    blocks_per_sm: int

    def args(self):
        """The plan as the C entry point takes it."""
        return (self.cols, self.blocks, self.stages, self.smem,
                int(self.bulk), self.threads)


#: the lengths of the z conv's ring kernel; the others take the four-step one
ZCONV_LENGTHS = (64, 128, 256, 512)
#: the ring kernel's instances, columns a tile: 16 (64-byte row segments)
#: where its tiles give every SM its blocks, else 8 (``tools/
#: probe_edge_passes.py --sweep``: the longer a tile's row segments, the
#: fewer DRAM pages a byte costs)
ZCONV_COLUMNS = (16, 8)
#: the ring's depth (3 and 4 stages measured within 2% of 2)
ZCONV_STAGES = 2
FOUR_STEP_ZCONV_PLAN = ZconvTilePlan(0, 0, 0, 0, False, 0, 0)


def _zconv_smem(m: int, cols: int) -> int:
    """Shared bytes of the z conv ring kernel with tiles of ``cols``
    columns: the input ring (re and im of m/2 x cols floats a stage), the
    slots (m x cols complex, each k2's m1 cols padded by cols below 16) and
    the W_m^(n1 k2) twiddles in rows of m2 + 1."""
    m1, m2 = best_factors(m)
    slots = m2 * (m1 * cols + (cols if cols < 16 else 0))
    return 4 * ZCONV_STAGES * m * cols + 8 * slots + 8 * m1 * (m2 + 1)


def zconv_tile_plan(a: int, b: int, m: int, data_ptr: int,
                    sms: int = H100_SMS) -> ZconvTilePlan:
    """The launch plan of :func:`fft_greens_ifft_pass` on (``a``, m/2,
    ``b``) pairs whose pointers, or-ed together, are ``data_ptr``, on a card
    of ``sms`` SMs. The C entry point refuses any other plan.

    m = 64 ... 512 (:data:`ZCONV_LENGTHS`): the ring kernel, a block of
    T columns x m1 threads (m = m1 m2 as :func:`best_factors`), T the first
    of :data:`ZCONV_COLUMNS` whose tiles fill every SM, else the one with
    the most blocks (the 2D route's 512 columns: 64 tiles of 8); as many
    blocks an SM as fit, up to 256 threads an SM at m = 512 (its radix-32
    factors take up to 255 registers) and 512 below. The input moves by
    16-byte copies when the pointers are 16-byte aligned and ``b`` is a
    multiple of 4. Other lengths: :data:`FOUR_STEP_ZCONV_PLAN`."""
    _check_length(m)
    if a <= 0 or b <= 0:
        raise ValueError(f"no plan for ({a}, {m // 2}, {b})")
    if m not in ZCONV_LENGTHS:
        return FOUR_STEP_ZCONV_PLAN
    return _zconv_tile_plan(b, m, data_ptr % 16 == 0, sms)


@functools.lru_cache(maxsize=64)
def _zconv_tile_plan(b, m, aligned, sms):
    plans = [zconv_columns_plan(b, m, aligned, sms, t) for t in ZCONV_COLUMNS]
    return next((p for p in plans if p.blocks == p.blocks_per_sm * sms),
                max(plans, key=lambda p: p.blocks))


def zconv_columns_plan(b: int, m: int, aligned: bool, sms: int,
                       cols: int) -> ZconvTilePlan:
    """The ring kernel's plan with tiles of ``cols`` columns (one of
    :data:`ZCONV_COLUMNS`) for ``b`` columns at m, the pointers
    16-byte ``aligned`` or not, on ``sms`` SMs."""
    return _columns_plan(b, m, aligned, sms, cols, _zconv_smem(m, cols),
                         ZCONV_STAGES, 256 if m == 512 else 512)


def _columns_plan(b, m, aligned, sms, cols, smem, stages, sm_threads):
    """A z ring kernel's plan: tiles of ``cols`` columns, blocks of
    ``cols`` x m1 threads, as many an SM as ``sm_threads`` (the kernel's
    launch bound) and the shared memory allow."""
    m1, _ = best_factors(m)
    threads = cols * m1
    per_sm = max(1, min(sm_threads // threads,
                        SM_SHARED_BYTES // (smem + BLOCK_SHARED_RESERVE)))
    return ZconvTilePlan(cols, min(-(-b // cols), per_sm * sms), stages,
                         smem, aligned and b % 4 == 0, threads, per_sm)


#: the fast tier's z ring kernel: its input ring is the three components'
#: slot regions
ZCONV_CURL_STAGES = 3


def _zconv_curl_smem(m: int, cols: int) -> int:
    """Shared bytes of the fast tier's z ring kernel with tiles of ``cols``
    columns: three components' slot regions (the z conv's slots, each
    also the ring stage of its component's input) and the W_m^(n1 k2)
    twiddles in rows of m2 + 1."""
    m1, m2 = best_factors(m)
    region = m2 * (m1 * cols + (cols if cols < 16 else 0))
    return 8 * ZCONV_CURL_STAGES * region + 8 * m1 * (m2 + 1)


def zconv_curl_tile_plan(b: int, m: int, data_ptr: int,
                         sms: int = H100_SMS) -> ZconvTilePlan:
    """The launch plan of :func:`fft_greens_curl_ifft_pass` on (3, m/2,
    ``b``) pairs whose pointers, or-ed together, are ``data_ptr``, on a card
    of ``sms`` SMs. The C entry point refuses any other plan.

    m = 64 ... 512 (:data:`ZCONV_LENGTHS`): the ring kernel, a block of
    T columns x m1 threads, T the first of :data:`ZCONV_COLUMNS` whose tiles
    give every SM a block, else the one with the most blocks; as many
    blocks an SM as fit, up to 256 threads an SM at m = 256 and 512 (the
    middle factor holds three components' spectra, up to 255 registers)
    and 512 below. On an H100 the 64^3 run's 512 tiles of 16 columns (four
    blocks an SM) take 0.0133 ms of device time, its 1,024 of 8 (seven an
    SM) 0.0184-0.0191 (``tools/probe_edge_passes.py --sweep``). The input
    moves by 16-byte copies when the pointers are 16-byte aligned and ``b``
    is a multiple of 4. Other lengths: :data:`FOUR_STEP_ZCONV_PLAN`."""
    _check_length(m)
    if b <= 0:
        raise ValueError(f"no plan for (3, {m // 2}, {b})")
    if m not in ZCONV_LENGTHS:
        return FOUR_STEP_ZCONV_PLAN
    return _zconv_curl_tile_plan(b, m, data_ptr % 16 == 0, sms)


@functools.lru_cache(maxsize=64)
def _zconv_curl_tile_plan(b, m, aligned, sms):
    plans = [zconv_curl_columns_plan(b, m, aligned, sms, t)
             for t in ZCONV_COLUMNS]
    return next((p for p in plans if -(-b // p.cols) >= sms),
                max(plans, key=lambda p: p.blocks))


def zconv_curl_columns_plan(b: int, m: int, aligned: bool, sms: int,
                            cols: int) -> ZconvTilePlan:
    """The fast tier's z ring kernel's plan with tiles of ``cols`` columns
    (one of :data:`ZCONV_COLUMNS`) for ``b`` columns at m, the pointers
    16-byte ``aligned`` or not, on ``sms`` SMs."""
    return _columns_plan(b, m, aligned, sms, cols, _zconv_curl_smem(m, cols),
                         ZCONV_CURL_STAGES, 256 if m >= 256 else 512)


class FusedR2cPlan(NamedTuple):
    """How a fused edge pass (:func:`rfft_fft_pass_fused`, and
    :func:`ifft_irfft_pass_fused` under :func:`fused_c2r_cluster_plan`)
    covers its (A, ny, nx) slabs: a ``cluster`` of C blocks a slab (1, 2,
    4, 8, 16; block r takes rows r ny / C on and owns columns r nx / C on),
    ``threads`` a block, ``clusters`` launched (persistent, all resident at once, each walking slabs),
    ``smem`` bytes a block, ``bulk`` input copies (the inverse: 16-byte
    tile copies) and the ``blocks_per_sm`` the plan counts on being
    resident. :data:`FUSED_R2C_DENSE_PLAN` (every field 0) takes the
    dense-x kernel of either pass."""

    cluster: int
    threads: int
    clusters: int
    smem: int
    bulk: bool
    blocks_per_sm: int

    def args(self):
        """The plan as the C entry point takes it."""
        return (self.cluster, self.threads, self.clusters, self.smem,
                int(self.bulk))


#: the plan of either pass's dense-x kernel (every field 0): the shapes
#: where no cluster holds a slab's slots (the inverse: its column tiles)
FUSED_R2C_DENSE_PLAN = FusedR2cPlan(0, 0, 0, 0, False, 0)
#: the cluster sizes (16: Hopper's non-portable size) and block sizes of
#: the cluster kernel
FUSED_R2C_CLUSTERS = (1, 2, 4, 8, 16)
FUSED_R2C_THREADS = (256, 512)
# threads an SM under the kernel's launch bound (512, 1): up to 128
# registers a thread
_CLUSTER_SM_THREADS = 512


def _cluster_smem(ny: int, nx: int, my: int, cluster: int,
                  threads: int) -> int:
    """Shared bytes of the cluster kernel (``cluster_smem_bytes``): the x
    twiddles, the y tables, the slot buffer (the spectrum's ny rows of
    nx / C columns, then ny rows of slots or the x phase's work buffers,
    whichever is larger), the staged input rows and their barrier."""
    _, g, sh = _edge_shape(nx)
    m1, m2, m1c, h2c = _register_classes(my)
    lower = ny * (nx // cluster)
    work = threads // g * (nx + (nx >> sh))
    return (8 * (_edge_twiddles(nx) + m1 * m1c + m2 * h2c + my + lower
                 + max(lower, work)) + 4 * (ny // cluster) * nx + 8)


@functools.lru_cache(maxsize=64)
def fused_r2c_cluster_shapes(ny: int, nx: int, my: int, mx: int):
    """Every (C, threads, smem, blocks_per_sm) the cluster kernel takes for
    (ny, nx) slabs doubled to (my, mx), best first: the most threads an SM,
    then the most blocks an SM, then the smallest cluster (the fewest
    remote stores); on an H100 it picks the fastest plan at the 256^3, rod
    and 64^3 slabs (``tools/probe_edge_passes.py --sweep fused_r2c``).
    Empty where a length is not a power of two or no cluster of at most 16
    blocks holds the slots (twice the spectrum)."""
    if my & (my - 1) or mx & (mx - 1):
        return ()
    shapes = []
    for c in FUSED_R2C_CLUSTERS:
        for threads in FUSED_R2C_THREADS:
            smem = _cluster_smem(ny, nx, my, c, threads)
            if threads % (nx // c) or smem > BLOCK_SHARED_MAX:
                continue
            per_sm = min(_CLUSTER_SM_THREADS // threads, SM_SHARED_BYTES // (
                smem + BLOCK_SHARED_RESERVE))
            shapes.append((c, threads, smem, per_sm))
    return tuple(sorted(shapes, key=lambda v: (-v[1] * v[3], -v[3], v[0])))


def fused_r2c_cluster_plan(a: int, ny: int, nx: int, my: int, mx: int,
                           device="cpu", data_ptr: int = 0) -> FusedR2cPlan:
    """The launch plan of :func:`rfft_fft_pass_fused` on ``a`` real
    (ny, nx) slabs at ``data_ptr`` doubled to (my, mx), on ``device``. The
    C entry point refuses any other plan.

    Power-of-two lengths whose slots fit a cluster: the cluster kernel
    under the first of :func:`fused_r2c_cluster_shapes`, one spectrum
    buffer a block, ``min(a, clusters the card holds at once)`` clusters
    (on a CUDA device, ``cudaOccupancyMaxActiveClusters``; elsewhere an
    H100's 132 SMs' worth), bulk input copies when ``data_ptr`` is 16-byte
    aligned. Other shapes (a length that is not a power of two, slots above
    16 blocks' shared memory as at 512 x 512 slabs):
    :data:`FUSED_R2C_DENSE_PLAN`."""
    _check_fused_sizes(ny, nx, my, mx)
    if a <= 0:
        raise ValueError(f"no plan for {a} slabs")
    shapes = fused_r2c_cluster_shapes(ny, nx, my, mx)
    if not shapes:
        return FUSED_R2C_DENSE_PLAN
    return fused_r2c_plan_of(a, nx, my, *shapes[0], device, data_ptr)


def fused_r2c_plan_of(a: int, nx: int, my: int, cluster: int, threads: int,
                      smem: int, blocks_per_sm: int, device="cpu",
                      data_ptr: int = 0) -> FusedR2cPlan:
    """The cluster kernel's plan for ``a`` slabs under one of
    :func:`fused_r2c_cluster_shapes`, as many clusters as ``device``
    holds at once."""
    clusters = _clusters(False, a, nx, my, cluster, threads, smem,
                         blocks_per_sm, device)
    return FusedR2cPlan(cluster, threads, clusters, smem, data_ptr % 16 == 0,
                        blocks_per_sm)


def _clusters(inverse, a, nx, my, cluster, threads, smem, blocks_per_sm,
              device) -> int:
    """The clusters a cluster kernel's plan launches for ``a`` slabs: at
    most as many as ``device`` holds at once."""
    device = torch.device(device)
    if device.type == "cuda":
        most = _cluster_capacity(device, inverse, nx, my, cluster, threads,
                                 smem)
    else:
        most = H100_SMS * blocks_per_sm // cluster
    return min(a, most)


@functools.cache
def _cluster_capacity(device, inverse, nx, my, cluster, threads,
                      smem) -> int:
    with torch.cuda.device(device):
        most = library().sopht_fused_cluster_capacity(
            int(inverse), nx, my, cluster, threads, smem)
    if most < 0:
        _check_err("sopht_fused_cluster_capacity", -most)
    if most == 0:
        raise RuntimeError(f"the card holds no cluster of {cluster} blocks of "
                           f"{threads} threads and {smem} shared bytes")
    return most


def _c2r_cluster_smem(ny: int, nx: int, my: int, cluster: int) -> int:
    """Shared bytes of the inverse cluster kernel
    (``c2r_cluster_smem_bytes``): the x twiddles, the y tables, the column
    tile's two float planes (my rows of nx / C and a row of padding after
    each run of m2) and the receive buffers (ny / C rows at the c2r's
    padded pitch)."""
    _, _, sh = _edge_shape(nx)
    m1, m2, m1c, h2c = _register_classes(my)
    return 8 * (_edge_twiddles(nx) + m1 * m1c + m2 * h2c + my
                + (my + m1) * (nx // cluster)
                + (ny // cluster) * (nx + (nx >> sh)))


@functools.lru_cache(maxsize=64)
def fused_c2r_cluster_shapes(ny: int, nx: int, my: int, mx: int):
    """Every (C, threads, smem, blocks_per_sm) the inverse cluster kernel
    takes for (my, nx) pairs into (ny, nx) slabs, best first, in
    :func:`fused_r2c_cluster_shapes`' order. A plan needs nx / C >= 4
    columns a block (16-byte tile copies) dividing the threads and ny / C
    a multiple of the c2r's lane groups a warp (whole warps of rows).
    Empty where a length is not a power of two or no cluster of at most 16
    blocks holds a column tile and its rows."""
    if my & (my - 1) or mx & (mx - 1):
        return ()
    _, g, _ = _edge_shape(nx)
    shapes = []
    for c in FUSED_R2C_CLUSTERS:
        t, rows = nx // c, ny // c
        smem = _c2r_cluster_smem(ny, nx, my, c)
        if t < 4 or (g < 32 and rows % (32 // g)) or smem > BLOCK_SHARED_MAX:
            continue
        for threads in FUSED_R2C_THREADS:
            if threads % t:
                continue
            per_sm = min(_CLUSTER_SM_THREADS // threads, SM_SHARED_BYTES // (
                smem + BLOCK_SHARED_RESERVE))
            shapes.append((c, threads, smem, per_sm))
    return tuple(sorted(shapes, key=lambda v: (-v[1] * v[3], -v[3], v[0])))


def fused_c2r_cluster_plan(a: int, ny: int, nx: int, my: int, mx: int,
                           device="cpu", data_ptr: int = 0) -> FusedR2cPlan:
    """The launch plan of :func:`ifft_irfft_pass_fused` on ``a`` bulk
    (my, mx/2) pairs at ``data_ptr`` (both planes' pointers or'ed) into
    (ny, nx) reals, on ``device``, in the forward's :class:`FusedR2cPlan`
    (``bulk``: 16-byte tile copies). The C entry point refuses any other
    plan.

    Power-of-two lengths where a cluster holds a column tile and its rows:
    the cluster kernel under the first of :func:`fused_c2r_cluster_shapes`,
    ``min(a, clusters the card holds at once)`` clusters (on a CUDA device,
    ``cudaOccupancyMaxActiveClusters``; elsewhere an H100's 132 SMs'
    worth), 16-byte copies when ``data_ptr`` is 16-byte aligned. Other
    shapes (a length that is not a power of two, a tile above 16 blocks'
    shared memory as at 512 x 512 slabs): :data:`FUSED_R2C_DENSE_PLAN`,
    the dense-x kernel."""
    _check_fused_sizes(ny, nx, my, mx)
    if a <= 0:
        raise ValueError(f"no plan for {a} slabs")
    shapes = fused_c2r_cluster_shapes(ny, nx, my, mx)
    if not shapes:
        return FUSED_R2C_DENSE_PLAN
    return fused_c2r_plan_of(a, nx, my, *shapes[0], device, data_ptr)


def fused_c2r_plan_of(a: int, nx: int, my: int, cluster: int, threads: int,
                      smem: int, blocks_per_sm: int, device="cpu",
                      data_ptr: int = 0) -> FusedR2cPlan:
    """The inverse cluster kernel's plan for ``a`` slabs under one of
    :func:`fused_c2r_cluster_shapes`, as many clusters as ``device`` holds
    at once."""
    clusters = _clusters(True, a, nx, my, cluster, threads, smem,
                         blocks_per_sm, device)
    return FusedR2cPlan(cluster, threads, clusters, smem, data_ptr % 16 == 0,
                        blocks_per_sm)


@functools.cache
def _sm_count(device) -> int:
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


# The 3D convolve's fused edge passes (the JAX package's flag and default):
# off, so the solve runs the four unfused edge kernels. Read at each solve.
USE_FUSED_EDGE_PASSES = False


def fused_edge_pass_ok(ny: int, nx: int, my: int, mx: int) -> bool:
    """Whether the 3D convolve takes :func:`rfft_fft_pass_fused` and
    :func:`ifft_irfft_pass_fused` for a (.., ny, nx) field doubled to
    (my, mx): the flag on and the sizes the kernels take (the JAX gate's
    conditions; its VMEM budget ``_fused_edge_vmem_ok`` has no counterpart
    here: each pass holds a slab in a cluster's shared memory where one
    fits and takes its dense-x kernel elsewhere)."""
    return (
        USE_FUSED_EDGE_PASSES
        and kernel_fft_supported(my)
        and kernel_fft_supported(mx)
        and my == 2 * ny
        and mx == 2 * nx
        and nx % 4 == 0  # the forward kernel stages rows 16 bytes at a time
        and (my // 2) % best_factors(my)[0] == 0
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _split(z):
    return z.real.contiguous(), z.imag.contiguous()


def rfft_pass_padded_split_ref(x, m: int):
    """r2c of each row of (R, n_in) zero-padded to ``m``:
    ``(bulk_r, bulk_i, side_r, side_i)``, bulk (R, m/2) = k < m/2, side
    (R, 1) = k = m/2."""
    z = torch.fft.rfft(x, n=m, dim=1)
    return (*_split(z[:, : m // 2]), *_split(z[:, m // 2:]))


def fft_pass_padded_ref(xr, xi, axis_len_out: int):
    """Forward DFT along the middle axis of (A, m/2, B), zero-padded to
    ``m = axis_len_out``: (A, m, B) pair."""
    return _split(torch.fft.fft(torch.complex(xr, xi), n=axis_len_out, dim=1))


def fft_greens_ifft_pass_ref(xr, xi, greens):
    """``ifft_pass_truncated(*fft_pass_padded(xr, xi, m), greens)`` with
    ``m = 2 L`` for (A, L, B) pairs; ``greens`` (1, m, B)."""
    half = xr.shape[1]
    f = torch.fft.fft(torch.complex(xr, xi), n=2 * half, dim=1)
    return _split(torch.fft.ifft(f * greens, dim=1)[:, :half])


def ifft_pass_truncated_ref(xr, xi, greens=None):
    """Inverse DFT along the middle axis of (A, m, B), optionally times the
    real ``greens`` (A or 1, m, B), keeping the first m/2 outputs."""
    f = torch.complex(xr, xi)
    if greens is not None:
        f = f * greens
    return _split(torch.fft.ifft(f, dim=1)[:, : xr.shape[1] // 2])


def _c2r(re, im, m: int, n_out: int):
    """c2r of (.., m/2 + 1) rows along the last axis, the first ``n_out``
    reals kept. The imaginary parts of k = 0 and k = m/2 do not enter (the
    JAX package's c2r weights, 1 there and 2 elsewhere)."""
    im = im.clone()
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    return torch.fft.irfft(torch.complex(re, im), n=m, dim=-1)[..., :n_out] \
        .contiguous()


def irfft_pass_merge_ref(br, bi, sr, si, m: int, n_out: int):
    """c2r of rows from the bulk (R, m/2) and Nyquist (R, 1) pairs, keeping
    the first ``n_out`` reals."""
    return _c2r(torch.cat([br, sr], dim=1), torch.cat([bi, si], dim=1), m,
                n_out)


def rfft_pass_padded_ref(x, m: int):
    """r2c of each row of (R, n_in) zero-padded to ``m``: the (R, m/2 + 1)
    pair, the Nyquist column kept in the row."""
    return _split(torch.fft.rfft(x, n=m, dim=1))


def irfft_pass_truncated_ref(xr, xi, m: int, n_out: int):
    """c2r of rows of the (R, m/2 + 1) pair, keeping the first ``n_out``
    reals."""
    return _c2r(xr, xi, m, n_out)


def rfft_fft_pass_fused_ref(x, mx: int, my: int):
    """``rfft_pass_padded_split`` along x, then ``fft_pass_padded`` along y
    of the bulk, of a real (A, ny, nx) array: the bulk (A, my, mx/2) pair
    and the r2c Nyquist column's (A, ny, 1) pair."""
    z = torch.fft.rfft(x, n=mx, dim=2)
    bulk = torch.fft.fft(z[..., : mx // 2], n=my, dim=1)
    return (*_split(bulk), *_split(z[..., mx // 2:]))


def ifft_irfft_pass_fused_ref(br, bi, sr, si, mx: int, nx: int):
    """``ifft_pass_truncated`` along y of the bulk (A, my, mx/2) pair, then
    ``irfft_pass_merge`` along x with the Nyquist column's (A, ny, 1) pair:
    the real (A, ny, nx) array."""
    my = br.shape[1]
    bulk = torch.fft.ifft(torch.complex(br, bi), dim=1)[:, : my // 2]
    return _c2r(torch.cat([bulk.real, sr], dim=2),
                torch.cat([bulk.imag, si], dim=2), mx, nx)


def fft_greens_curl_ifft_pass_ref(xr, xi, greens, sym_z, sym_yx):
    """``fft_greens_ifft_pass`` of the three components of (3, L, B) pairs
    with the spectral curl mixed in at the full spectrum:
    ``u_hat = i s x (greens * x_hat)``, ``s = (sym_yx[1], sym_yx[0],
    sym_z)`` per component (x, y, z), ``sym_z`` (2L,) along the transform
    axis, ``sym_yx`` (2, B) along the two axes flattened into B (B-major,
    then B-minor)."""
    half, b = xr.shape[1], xr.shape[2]
    m = 2 * half
    psi = torch.fft.fft(torch.complex(xr, xi), n=m, dim=1) * greens
    sz = sym_z.view(m, 1)
    sy = sym_yx[0].view(1, b)
    sx = sym_yx[1].view(1, b)
    u_hat = 1j * torch.stack([
        sy * psi[2] - sz * psi[1],
        sz * psi[0] - sx * psi[2],
        sx * psi[1] - sy * psi[0],
    ])
    return _split(torch.fft.ifft(u_hat, dim=1)[:, :half])


def _interior_mask(nz, ny, nx, device):
    ring = lambda n: (torch.arange(n, device=device) > 0) & (
        torch.arange(n, device=device) < n - 1)
    return (ring(nz)[:, None, None] & ring(ny)[None, :, None]
            & ring(nx)[None, None, :])


def irfft_pass_merge_velocity_ref(br, bi, sr, si, fsv, m: int, n_out: int,
                                  ny: int, nz: int):
    """``irfft_pass_merge`` of the three components of (3, nz*ny, m/2) and
    (3, nz*ny, 1) pairs, the width-1 wall ring zeroed, ``fsv`` (3,) added
    on every cell: ``(u (3, nz*ny, n_out), max over cells of sum_c
    |u_c|)``, the maximum a 0-d tensor."""
    rows = br.shape[1]
    u = irfft_pass_merge_ref(
        br.reshape(3 * rows, -1), bi.reshape(3 * rows, -1),
        sr.reshape(3 * rows, 1), si.reshape(3 * rows, 1), m, n_out,
    ).view(3, nz, ny, n_out)
    u = torch.where(_interior_mask(nz, ny, n_out, u.device), u, 0.0) \
        + fsv.view(3, 1, 1, 1)
    return u.reshape(3, rows, n_out), u.abs().sum(dim=0).max()


# ---------------------------------------------------------------------------
# reverse-mode rules: the JAX package's analytic adjoints
# (``sopht_mpi_tpu/parallel/pallas_fft.py``, "reverse-mode rules"), real
# inner product, adjoint of zero-padding = truncation and vice versa
# ---------------------------------------------------------------------------


def _c2r_ct_weights(m: int, like) -> torch.Tensor:
    """The c2r adjoint's Hermitian weights over the m/2 + 1 columns: 1/m at
    DC and Nyquist, 2/m elsewhere."""
    w = torch.full((m // 2 + 1,), 2.0 / m, dtype=like.dtype,
                   device=like.device)
    w[0] = w[-1] = 1.0 / m
    return w


def _c2r_adjoint(ct, m: int):
    """``(w Re F, w Im F)`` with ``F`` the first m/2 + 1 DFT outputs of the
    real cotangent zero-padded to ``m``: the adjoint of the truncated c2r."""
    f = torch.fft.rfft(ct, n=m, dim=-1)
    w = _c2r_ct_weights(m, ct)
    return (w * f.real).contiguous(), (w * f.imag).contiguous()


def _greens_ct(s, q, greens):
    """``Re(conj(s) q)``, summed over the leading axis where one Green's
    multiplier is shared by all of it."""
    g = (s.conj() * q).real
    if greens.shape[0] == 1 and s.shape[0] != 1:
        g = g.sum(dim=0, keepdim=True)
    return g.to(greens.dtype)


class FftPassPaddedFn(torch.autograd.Function):
    """:func:`fft_pass_padded`; backward ``m ifft(ct)`` truncated to m/2
    (nothing saved)."""

    @staticmethod
    def forward(ctx, xr, xi, m):
        ctx.m = m
        return _fft_pass_padded(xr, xi, m)

    @staticmethod
    @once_differentiable
    def backward(ctx, ctr, cti):
        m = ctx.m
        x = m * torch.fft.ifft(torch.complex(ctr, cti), dim=1)[:, : m // 2]
        return (*_split(x), None)


class IfftPassTruncatedFn(torch.autograd.Function):
    """:func:`ifft_pass_truncated`; backward ``q = fft(pad(ct)) / m``,
    ``x_ct = q greens``, ``greens_ct = Re(conj(x) q)`` (summed over the
    broadcast axis of a shared multiplier)."""

    @staticmethod
    def forward(ctx, xr, xi, greens):
        ctx.m = xr.shape[1]
        want_g = greens is not None and ctx.needs_input_grad[2]
        ctx.save_for_backward(
            xr if want_g else None, xi if want_g else None, greens)
        return _ifft_pass_truncated(xr, xi, greens)

    @staticmethod
    @once_differentiable
    def backward(ctx, ctr, cti):
        xr, xi, greens = ctx.saved_tensors
        q = torch.fft.fft(torch.complex(ctr, cti), n=ctx.m, dim=1) / ctx.m
        if greens is None:
            return (*_split(q), None)
        g_ct = (_greens_ct(torch.complex(xr, xi), q, greens)
                if ctx.needs_input_grad[2] else None)
        return (*_split(q * greens), g_ct)


class FftGreensIfftPassFn(torch.autograd.Function):
    """:func:`fft_greens_ifft_pass`; backward ``x_ct = trunc(ifft(greens
    fft(pad(ct))))`` (the pass is self-adjoint up to the same composition)
    and ``greens_ct = Re(conj(fft(pad(x))) fft(pad(ct))) / m``."""

    @staticmethod
    def forward(ctx, xr, xi, greens):
        want_g = ctx.needs_input_grad[2]
        ctx.save_for_backward(
            xr if want_g else None, xi if want_g else None, greens)
        return _fft_greens_ifft_pass(xr, xi, greens)

    @staticmethod
    @once_differentiable
    def backward(ctx, ctr, cti):
        xr, xi, greens = ctx.saved_tensors
        half = ctr.shape[1]
        m = 2 * half
        ctf = torch.fft.fft(torch.complex(ctr, cti), n=m, dim=1)
        x_ct = torch.fft.ifft(greens * ctf, dim=1)[:, :half]
        g_ct = None
        if ctx.needs_input_grad[2]:
            s = torch.fft.fft(torch.complex(xr, xi), n=m, dim=1)
            g_ct = _greens_ct(s, ctf / m, greens)
        return (*_split(x_ct), g_ct)


class RfftPassPaddedFn(torch.autograd.Function):
    """:func:`rfft_pass_padded`; backward ``Re(m ifft(pad(ct)))`` truncated
    to the input's length (only that length saved)."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.m, ctx.n_in = m, x.shape[1]
        return _rfft_pass_padded(x, m)

    @staticmethod
    @once_differentiable
    def backward(ctx, ctr, cti):
        z = torch.fft.ifft(torch.complex(ctr, cti), n=ctx.m, dim=1)
        return (ctx.m * z.real[:, : ctx.n_in]).contiguous(), None


class RfftPassPaddedSplitFn(torch.autograd.Function):
    """:func:`rfft_pass_padded_split`; the unsplit pass's backward on the
    bulk and Nyquist columns put back together."""

    @staticmethod
    def forward(ctx, x, m):
        ctx.m, ctx.n_in = m, x.shape[1]
        return _rfft_pass_padded_split(x, m)

    @staticmethod
    @once_differentiable
    def backward(ctx, br, bi, sr, si):
        z = torch.complex(torch.cat([br, sr], dim=1), torch.cat([bi, si], dim=1))
        z = torch.fft.ifft(z, n=ctx.m, dim=1)
        return (ctx.m * z.real[:, : ctx.n_in]).contiguous(), None


class IrfftPassTruncatedFn(torch.autograd.Function):
    """:func:`irfft_pass_truncated`; backward the Hermitian-weighted DFT of
    the zero-padded cotangent (nothing saved)."""

    @staticmethod
    def forward(ctx, xr, xi, m, n_out):
        ctx.m = m
        return _irfft_pass_truncated(xr, xi, m, n_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return (*_c2r_adjoint(ct, ctx.m), None, None)


class IrfftPassMergeFn(torch.autograd.Function):
    """:func:`irfft_pass_merge`; the unsplit c2r's backward, split into the
    bulk and Nyquist columns (nothing saved)."""

    @staticmethod
    def forward(ctx, br, bi, sr, si, m, n_out):
        ctx.m = m
        return _irfft_pass_merge(br, bi, sr, si, m, n_out)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        xr, xi = _c2r_adjoint(ct, ctx.m)
        h = ctx.m // 2
        return (xr[:, :h].contiguous(), xi[:, :h].contiguous(),
                xr[:, h:].contiguous(), xi[:, h:].contiguous(), None, None)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_TABLES: dict = {}


def _table(m: int, device) -> torch.Tensor:
    """The twiddle table of length ``m`` on ``device``, built once in
    float64 on the host by the library and kept."""
    key = (m, str(device))
    if key not in _TABLES:
        lib = library()
        host = torch.empty(lib.sopht_fft_table_floats(m), dtype=torch.float32)
        _check_err("sopht_fft_fill_table", lib.sopht_fft_fill_table(
            m, host.data_ptr()))
        _TABLES[key] = host.to(device)
    return _TABLES[key]


def _check_err(name, err):
    if err != 0:
        msg = library().sopht_fft_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def _launch(name, device, *args):
    stream = None
    if device.type == "cuda":
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
    _check_err(name, getattr(library(), name)(*args, stream))


def _check(name, t, ndim, like=None):
    if not torch.is_tensor(t) or t.ndim != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if min(t.shape) == 0:
        raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name} lies on {t.device}, the input on "
                         f"{like.device}")


def _check_length(m):
    if not kernel_fft_supported(m):
        raise ValueError(f"transform length {m} is not supported "
                         "(kernel_fft_supported)")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _empty(like, *shape):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def rfft_pass_padded_split(x, m: int):
    """r2c of the minor axis of a real (R, n_in) view zero-padded to ``m``
    (``n_in <= m/2``), the Nyquist column split off:
    ``(bulk_r, bulk_i, side_r, side_i)`` of shapes (R, m/2) and (R, 1)."""
    _check("x", x, 2)
    _check_length(m)
    rows, n_in = x.shape
    if n_in > m // 2:
        raise ValueError(f"rows of {n_in} do not fit the padded half of {m}")
    if needs_grad(x):
        return RfftPassPaddedSplitFn.apply(x, m)
    return _rfft_pass_padded_split(x, m)


def _rfft_pass_padded_split(x, m):
    if x.device.type == "cpu":
        return rfft_pass_padded_split_ref(x, m)
    out = _k_rfft_pass_padded_split(x, m)
    rfft_pass_padded_split.launches += 1
    return out


def _k_rfft_pass_padded_split(x, m):
    rows, n_in = x.shape
    br, bi = _empty(x, rows, m // 2), _empty(x, rows, m // 2)
    sr, si = _empty(x, rows, 1), _empty(x, rows, 1)
    plan = edge_tile_plan(rows, n_in, m, False, x.data_ptr(),
                          _sm_count(x.device))
    _launch("sopht_rfft_pass_padded_split_f32", x.device, x.data_ptr(),
            br.data_ptr(), bi.data_ptr(), sr.data_ptr(), si.data_ptr(),
            _table(m, x.device).data_ptr(), rows, n_in, m, *plan.args())
    return br, bi, sr, si


def fft_pass_padded(xr, xi, axis_len_out: int):
    """Forward padded FFT along the middle axis of (A, L, B) float32 pairs:
    input L = m/2 (zero-padded semantics), output L = m = axis_len_out."""
    m = axis_len_out
    _check("xr", xr, 3)
    _check("xi", xi, 3, like=xr)
    _check_shape("xi", xi, xr.shape)
    _check_length(m)
    _check_shape("xr", xr, (xr.shape[0], m // 2, xr.shape[2]))
    if needs_grad(xr, xi):
        return FftPassPaddedFn.apply(xr, xi, m)
    return _fft_pass_padded(xr, xi, m)


def _fft_pass_padded(xr, xi, m):
    if xr.device.type == "cpu":
        return fft_pass_padded_ref(xr, xi, m)
    out = _k_fft_pass_padded(xr, xi, m)
    fft_pass_padded.launches += 1
    return out


def _k_fft_pass_padded(xr, xi, m):
    a, _, b = xr.shape
    zr, zi = _empty(xr, a, m, b), _empty(xr, a, m, b)
    _launch("sopht_fft_pass_padded_f32", xr.device, xr.data_ptr(),
            xi.data_ptr(), zr.data_ptr(), zi.data_ptr(),
            _table(m, xr.device).data_ptr(), a, b, m)
    return zr, zi


def fft_greens_ifft_pass(xr, xi, greens):
    """Fused ``ifft_pass_truncated(*fft_pass_padded(xr, xi, m), greens)``
    along the middle axis of (A, m/2, B) float32 pairs; ``greens`` is the
    real multiplier (1, m, B), one copy shared by every A."""
    _check("xr", xr, 3)
    _check("xi", xi, 3, like=xr)
    _check("greens", greens, 3, like=xr)
    _check_shape("xi", xi, xr.shape)
    a, half, b = xr.shape
    m = 2 * half
    _check_length(m)
    _check_shape("greens", greens, (1, m, b))
    if needs_grad(xr, xi, greens):
        return FftGreensIfftPassFn.apply(xr, xi, greens)
    return _fft_greens_ifft_pass(xr, xi, greens)


def _fft_greens_ifft_pass(xr, xi, greens):
    if xr.device.type == "cpu":
        return fft_greens_ifft_pass_ref(xr, xi, greens)
    out = _k_fft_greens_ifft_pass(xr, xi, greens)
    fft_greens_ifft_pass.launches += 1
    return out


def _k_fft_greens_ifft_pass(xr, xi, greens):
    a, half, b = xr.shape
    yr, yi = _empty(xr, a, half, b), _empty(xr, a, half, b)
    plan = zconv_tile_plan(a, b, 2 * half, xr.data_ptr() | xi.data_ptr(),
                           _sm_count(xr.device))
    _launch("sopht_fft_greens_ifft_pass_f32", xr.device, xr.data_ptr(),
            xi.data_ptr(), greens.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _table(2 * half, xr.device).data_ptr(), a, b, 2 * half,
            *plan.args())
    return yr, yi


def ifft_pass_truncated(xr, xi, greens=None):
    """Inverse FFT along the middle axis of (A, m, B) float32 pairs, keeping
    the first m/2 outputs. ``greens`` (float32, shape (A, m, B) or
    (1, m, B)) is an optional real spectral multiplier folded into the
    load."""
    _check("xr", xr, 3)
    _check("xi", xi, 3, like=xr)
    _check_shape("xi", xi, xr.shape)
    a, m, b = xr.shape
    _check_length(m)
    if greens is not None:
        _check("greens", greens, 3, like=xr)
        if greens.shape[0] not in (1, a):
            raise ValueError(f"greens: leading axis {greens.shape[0]} is "
                             f"neither 1 nor {a}")
        _check_shape("greens", greens, (greens.shape[0], m, b))
    if needs_grad(xr, xi, greens):
        return IfftPassTruncatedFn.apply(xr, xi, greens)
    return _ifft_pass_truncated(xr, xi, greens)


def _ifft_pass_truncated(xr, xi, greens):
    if xr.device.type == "cpu":
        return ifft_pass_truncated_ref(xr, xi, greens)
    out = _k_ifft_pass_truncated(xr, xi, greens)
    ifft_pass_truncated.launches += 1
    return out


def _k_ifft_pass_truncated(xr, xi, greens):
    a, m, b = xr.shape
    yr, yi = _empty(xr, a, m // 2, b), _empty(xr, a, m // 2, b)
    _launch("sopht_ifft_pass_truncated_f32", xr.device, xr.data_ptr(),
            xi.data_ptr(), None if greens is None else greens.data_ptr(),
            int(greens is not None and greens.shape[0] == 1),
            yr.data_ptr(), yi.data_ptr(), _table(m, xr.device).data_ptr(),
            a, b, m)
    return yr, yi


def irfft_pass_merge(br, bi, sr, si, m: int, n_out: int):
    """c2r of the minor axis from split bulk (R, m/2) / Nyquist (R, 1)
    float32 pairs, keeping the first ``n_out <= m/2`` real outputs."""
    _check("br", br, 2)
    for name, t in (("bi", bi), ("sr", sr), ("si", si)):
        _check(name, t, 2, like=br)
    _check_length(m)
    rows = br.shape[0]
    _check_shape("br", br, (rows, m // 2))
    _check_shape("bi", bi, (rows, m // 2))
    _check_shape("sr", sr, (rows, 1))
    _check_shape("si", si, (rows, 1))
    if not 0 < n_out <= m // 2:
        raise ValueError(f"n_out {n_out} is not in (0, {m // 2}]")
    if needs_grad(br, bi, sr, si):
        return IrfftPassMergeFn.apply(br, bi, sr, si, m, n_out)
    return _irfft_pass_merge(br, bi, sr, si, m, n_out)


def _irfft_pass_merge(br, bi, sr, si, m, n_out):
    if br.device.type == "cpu":
        return irfft_pass_merge_ref(br, bi, sr, si, m, n_out)
    out = _k_irfft_pass_merge(br, bi, sr, si, m, n_out)
    irfft_pass_merge.launches += 1
    return out


def _k_irfft_pass_merge(br, bi, sr, si, m, n_out):
    # the Nyquist column's imaginary part does not enter the c2r
    rows = br.shape[0]
    out = _empty(br, rows, n_out)
    plan = c2r_tile_plan(rows, n_out, m, False,
                         br.data_ptr() | bi.data_ptr() | sr.data_ptr(),
                         _sm_count(br.device))
    _launch("sopht_irfft_pass_merge_f32", br.device, br.data_ptr(),
            bi.data_ptr(), sr.data_ptr(), out.data_ptr(),
            _table(m, br.device).data_ptr(), rows, m, n_out, *plan.args())
    return out


def fft_greens_curl_ifft_pass(xr, xi, greens, sym_z, sym_yx):
    """The fast tier's z pass: :func:`fft_greens_ifft_pass` of the three
    vorticity components of (3, m/2, B) float32 pairs with the spectral
    central-difference curl mixed in (see
    :func:`fft_greens_curl_ifft_pass_ref`); ``greens`` (1, m, B),
    ``sym_z`` (m,), ``sym_yx`` (2, B). Returns the velocity spectrum's
    (3, m/2, B) pair."""
    _check("xr", xr, 3)
    _check("xi", xi, 3, like=xr)
    _check("greens", greens, 3, like=xr)
    _check("sym_z", sym_z, 1, like=xr)
    _check("sym_yx", sym_yx, 2, like=xr)
    _check_shape("xi", xi, xr.shape)
    a, half, b = xr.shape
    m = 2 * half
    if a != 3:
        raise ValueError(f"xr: {a} components, the curl needs 3")
    _check_length(m)
    _check_shape("greens", greens, (1, m, b))
    _check_shape("sym_z", sym_z, (m,))
    _check_shape("sym_yx", sym_yx, (2, b))
    return kernel_or_plain_vjp(_fft_greens_curl_ifft_pass,
                               fft_greens_curl_ifft_pass_ref, xr, xi, greens,
                               sym_z, sym_yx)


def _fft_greens_curl_ifft_pass(xr, xi, greens, sym_z, sym_yx):
    if xr.device.type == "cpu":
        return fft_greens_curl_ifft_pass_ref(xr, xi, greens, sym_z, sym_yx)
    out = _k_fft_greens_curl_ifft_pass(xr, xi, greens, sym_z, sym_yx)
    fft_greens_curl_ifft_pass.launches += 1
    return out


def _k_fft_greens_curl_ifft_pass(xr, xi, greens, sym_z, sym_yx):
    _, half, b = xr.shape
    yr, yi = _empty(xr, 3, half, b), _empty(xr, 3, half, b)
    plan = zconv_curl_tile_plan(b, 2 * half, xr.data_ptr() | xi.data_ptr(),
                                _sm_count(xr.device))
    _launch("sopht_fft_greens_curl_ifft_pass_f32", xr.device, xr.data_ptr(),
            xi.data_ptr(), greens.data_ptr(), sym_z.data_ptr(),
            sym_yx.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            _table(2 * half, xr.device).data_ptr(), b, 2 * half,
            *plan.args())
    return yr, yi


def irfft_pass_merge_velocity(br, bi, sr, si, fsv, m: int, n_out: int,
                              ny: int, nz: int):
    """The fast tier's x c2r: :func:`irfft_pass_merge` of the three
    velocity components of (3, nz*ny, m/2) bulk and (3, nz*ny, 1) Nyquist
    float32 pairs, then the width-1 wall ring zeroed, the free stream
    ``fsv`` (3,) added, and ``max |u|_1`` reduced. Returns ``(u (3, nz*ny,
    n_out), l1_max)``, the maximum a 0-d tensor on the input's device (no
    host sync)."""
    _check("br", br, 3)
    for name, t in (("bi", bi), ("sr", sr), ("si", si)):
        _check(name, t, 3, like=br)
    _check("fsv", fsv, 1, like=br)
    _check_length(m)
    rows = br.shape[1]
    if rows != nz * ny:
        raise ValueError(f"{rows} rows are not nz * ny = {nz} * {ny}")
    _check_shape("br", br, (3, rows, m // 2))
    _check_shape("bi", bi, (3, rows, m // 2))
    _check_shape("sr", sr, (3, rows, 1))
    _check_shape("si", si, (3, rows, 1))
    _check_shape("fsv", fsv, (3,))
    if not 0 < n_out <= m // 2:
        raise ValueError(f"n_out {n_out} is not in (0, {m // 2}]")
    return kernel_or_plain_vjp(_irfft_pass_merge_velocity,
                               irfft_pass_merge_velocity_ref, br, bi, sr, si,
                               fsv, m, n_out, ny, nz)


def _irfft_pass_merge_velocity(br, bi, sr, si, fsv, m, n_out, ny, nz):
    if br.device.type == "cpu":
        return irfft_pass_merge_velocity_ref(br, bi, sr, si, fsv, m, n_out,
                                             ny, nz)
    out = _k_irfft_pass_merge_velocity(br, bi, sr, fsv, m, n_out, ny, nz)
    irfft_pass_merge_velocity.launches += 1
    return out


def _k_irfft_pass_merge_velocity(br, bi, sr, fsv, m, n_out, ny, nz):
    # the Nyquist column's imaginary part does not enter the c2r
    rows = br.shape[1]
    out = _empty(br, 3, rows, n_out)
    l1_max = torch.zeros((), dtype=br.dtype, device=br.device)
    plan = c2r_velocity_tile_plan(
        rows, n_out, m, br.data_ptr() | bi.data_ptr() | sr.data_ptr(),
        _sm_count(br.device))
    _launch("sopht_irfft_pass_merge_velocity_f32", br.device, br.data_ptr(),
            bi.data_ptr(), sr.data_ptr(), fsv.data_ptr(), out.data_ptr(),
            l1_max.data_ptr(), _table(m, br.device).data_ptr(), rows, m,
            n_out, ny, nz, *plan.args())
    return out, l1_max


def rfft_pass_padded(x, m: int):
    """r2c of the minor axis of a real (R, n_in) view zero-padded to ``m``
    (``n_in <= m/2``): the (R, m/2 + 1) float32 pair, the Nyquist column
    kept in the row."""
    _check("x", x, 2)
    _check_length(m)
    rows, n_in = x.shape
    if n_in > m // 2:
        raise ValueError(f"rows of {n_in} do not fit the padded half of {m}")
    if needs_grad(x):
        return RfftPassPaddedFn.apply(x, m)
    return _rfft_pass_padded(x, m)


def _rfft_pass_padded(x, m):
    if x.device.type == "cpu":
        return rfft_pass_padded_ref(x, m)
    out = _k_rfft_pass_padded(x, m)
    rfft_pass_padded.launches += 1
    return out


def _k_rfft_pass_padded(x, m):
    rows, n_in = x.shape
    xr, xi = _empty(x, rows, m // 2 + 1), _empty(x, rows, m // 2 + 1)
    plan = edge_tile_plan(rows, n_in, m, True, x.data_ptr(),
                          _sm_count(x.device))
    _launch("sopht_rfft_pass_padded_f32", x.device, x.data_ptr(),
            xr.data_ptr(), xi.data_ptr(), _table(m, x.device).data_ptr(),
            rows, n_in, m, *plan.args())
    return xr, xi


def irfft_pass_truncated(xr, xi, m: int, n_out: int):
    """c2r of the minor axis of the (R, m/2 + 1) float32 pair, keeping the
    first ``n_out <= m/2`` real outputs."""
    _check("xr", xr, 2)
    _check("xi", xi, 2, like=xr)
    _check_length(m)
    rows = xr.shape[0]
    _check_shape("xr", xr, (rows, m // 2 + 1))
    _check_shape("xi", xi, (rows, m // 2 + 1))
    if not 0 < n_out <= m // 2:
        raise ValueError(f"n_out {n_out} is not in (0, {m // 2}]")
    if needs_grad(xr, xi):
        return IrfftPassTruncatedFn.apply(xr, xi, m, n_out)
    return _irfft_pass_truncated(xr, xi, m, n_out)


def _irfft_pass_truncated(xr, xi, m, n_out):
    if xr.device.type == "cpu":
        return irfft_pass_truncated_ref(xr, xi, m, n_out)
    out = _k_irfft_pass_truncated(xr, xi, m, n_out)
    irfft_pass_truncated.launches += 1
    return out


def _k_irfft_pass_truncated(xr, xi, m, n_out):
    rows = xr.shape[0]
    out = _empty(xr, rows, n_out)
    plan = c2r_tile_plan(rows, n_out, m, True, xr.data_ptr() | xi.data_ptr(),
                         _sm_count(xr.device))
    _launch("sopht_irfft_pass_truncated_f32", xr.device, xr.data_ptr(),
            xi.data_ptr(), out.data_ptr(), _table(m, xr.device).data_ptr(),
            rows, m, n_out, *plan.args())
    return out


_X_TABLES: dict = {}


def _x_table(mx: int, device) -> torch.Tensor:
    """``exp(-2 pi i j / mx)`` for j < mx as (mx, 2) float32 on ``device``,
    computed once in float64: the dense x transform of both fused edge
    passes under their all-zero plans."""
    key = (mx, str(device))
    if key not in _X_TABLES:
        ang = -2.0 * math.pi * torch.arange(mx, dtype=torch.float64) / mx
        _X_TABLES[key] = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1) \
            .to(torch.float32).to(device)
    return _X_TABLES[key]


def _check_fused_sizes(ny, nx, my, mx):
    _check_length(my)
    _check_length(mx)
    if my != 2 * ny or mx != 2 * nx or nx % 4:
        raise ValueError(
            f"the fused edge passes need my = 2 ny, mx = 2 nx and nx a "
            f"multiple of 4, got ({ny}, {nx}) doubled to ({my}, {mx})")


def rfft_fft_pass_fused(x, mx: int, my: int):
    """Fused :func:`rfft_pass_padded_split` (minor axis, zero-padded to
    ``mx = 2 nx``) and :func:`fft_pass_padded` (middle axis, zero-padded to
    ``my = 2 ny``) of a real float32 (A, ny, nx) array: the bulk
    (A, my, mx/2) pair and the r2c Nyquist column's (A, ny, 1) pair. On a
    CUDA tensor, the kernel of :func:`fused_r2c_cluster_plan`'s plan: the
    thread-block-cluster kernel, or the dense-x one where no cluster holds
    a slab."""
    _check("x", x, 3)
    a, ny, nx = x.shape
    _check_fused_sizes(ny, nx, my, mx)
    return kernel_or_plain_vjp(_rfft_fft_pass_fused, rfft_fft_pass_fused_ref,
                               x, mx, my)


def _rfft_fft_pass_fused(x, mx, my):
    if x.device.type == "cpu":
        return rfft_fft_pass_fused_ref(x, mx, my)
    out = _k_rfft_fft_pass_fused(x, mx, my)
    rfft_fft_pass_fused.launches += 1
    return out


def _k_rfft_fft_pass_fused(x, mx, my):
    a, ny, nx = x.shape
    br, bi = _empty(x, a, my, mx // 2), _empty(x, a, my, mx // 2)
    sr, si = _empty(x, a, ny, 1), _empty(x, a, ny, 1)
    plan = fused_r2c_cluster_plan(a, ny, nx, my, mx, x.device, x.data_ptr())
    # the dense x table only for the dense-x kernel
    xw = _x_table(mx, x.device).data_ptr() if not plan.cluster else None
    _launch("sopht_rfft_fft_pass_fused_f32", x.device, x.data_ptr(),
            br.data_ptr(), bi.data_ptr(), sr.data_ptr(), si.data_ptr(),
            _table(my, x.device).data_ptr(), _table(mx, x.device).data_ptr(),
            xw, a, nx, mx, my, *plan.args())
    return br, bi, sr, si


def ifft_irfft_pass_fused(br, bi, sr, si, mx: int, nx: int):
    """Fused :func:`ifft_pass_truncated` (middle axis) and
    :func:`irfft_pass_merge` (minor axis): the bulk (A, my, mx/2) float32
    pair and the Nyquist column's (A, ny, 1) pair to the real (A, ny, nx)
    array. On a CUDA tensor, the kernel of :func:`fused_c2r_cluster_plan`'s
    plan: the thread-block-cluster kernel, or the dense-x one where no
    cluster holds a slab's column tiles."""
    _check("br", br, 3)
    for name, t in (("bi", bi), ("sr", sr), ("si", si)):
        _check(name, t, 3, like=br)
    a, my, bx = br.shape
    _check_fused_sizes(my // 2, nx, my, mx)
    _check_shape("br", br, (a, my, mx // 2))
    _check_shape("bi", bi, (a, my, mx // 2))
    _check_shape("sr", sr, (a, my // 2, 1))
    _check_shape("si", si, (a, my // 2, 1))
    return kernel_or_plain_vjp(_ifft_irfft_pass_fused,
                               ifft_irfft_pass_fused_ref, br, bi, sr, si, mx,
                               nx)


def _ifft_irfft_pass_fused(br, bi, sr, si, mx, nx):
    if br.device.type == "cpu":
        return ifft_irfft_pass_fused_ref(br, bi, sr, si, mx, nx)
    out = _k_ifft_irfft_pass_fused(br, bi, sr, mx, nx)
    ifft_irfft_pass_fused.launches += 1
    return out


def _k_ifft_irfft_pass_fused(br, bi, sr, mx, nx):
    # the Nyquist column's imaginary part does not enter the c2r
    a, my, _ = br.shape
    out = _empty(br, a, my // 2, nx)
    plan = fused_c2r_cluster_plan(a, my // 2, nx, my, mx, br.device,
                                  br.data_ptr() | bi.data_ptr())
    # the dense x table only for the dense-x kernel
    xw = _x_table(mx, br.device).data_ptr() if not plan.cluster else None
    _launch("sopht_ifft_irfft_pass_fused_f32", br.device, br.data_ptr(),
            bi.data_ptr(), sr.data_ptr(), out.data_ptr(),
            _table(my, br.device).data_ptr(), _table(mx, br.device).data_ptr(),
            xw, a, nx, mx, my, *plan.args())
    return out


rfft_pass_padded_split.launches = 0
fft_pass_padded.launches = 0
fft_greens_ifft_pass.launches = 0
ifft_pass_truncated.launches = 0
irfft_pass_merge.launches = 0
fft_greens_curl_ifft_pass.launches = 0
irfft_pass_merge_velocity.launches = 0
rfft_pass_padded.launches = 0
irfft_pass_truncated.launches = 0
rfft_fft_pass_fused.launches = 0
ifft_irfft_pass_fused.launches = 0

#: the wrappers, for code that resets or reads every launch count
KERNELS = (rfft_pass_padded_split, fft_pass_padded, fft_greens_ifft_pass,
           ifft_pass_truncated, irfft_pass_merge, fft_greens_curl_ifft_pass,
           irfft_pass_merge_velocity, rfft_pass_padded, irfft_pass_truncated,
           rfft_fft_pass_fused, ifft_irfft_pass_fused)
