"""Build ``csrc/fft_passes.cu`` and hold the x-edge passes (split, unsplit
and fused) and the z conv against their plain versions on one CUDA device,
with times:

    python3 -m sopht_mpi_tpu_torch.tools.probe_edge_passes [nz ny nx ...]
    python3 sopht_mpi_tpu_torch/tools/probe_edge_passes.py --json [tag]
    python3 -m sopht_mpi_tpu_torch.tools.probe_edge_passes --sweep [name ...]

The first form is a short first run for a changed kernel: it prints the
card, the build time, ptxas' register and spill lines of the x-edge r2c and
c2r (the fast tier's c2r ``irfft_pass_merge_velocity`` is the c2r's
instance ``[H, 1]``), the two z ring kernels, the fused kernels and the
fused passes' cluster kernels ``rfft_fft_cluster_kernel`` and
``ifft_irfft_cluster_kernel`` ``[nx, M1, H2]``, the z ring, c2r ring and
cluster kernels' SASS instruction counts (``cuobjdump``), the
forward r2c pair, the c2r pair, the z conv (``fft_greens_ifft_pass``) and
the fast tier's z pass (``fft_greens_curl_ifft_pass``) on ragged,
storage-offset, odd-output and non-power-of-two inputs, then for each grid
(default: an odd-factor grid,
the (256, 512) cylinder grid as one slab a component, a 17 x 32 factor grid
and 256^3) each pass's relative error against ``*_ref`` and the median of 10
timed calls of both (CUDA events), and ends with the JSON line below.

``--json`` prints the card (name and power limit) and one JSON line only:
the median of 20 calls (CUDA events, after 3 warm-up calls) of each of the
eleven FFT-pass kernels at the 256^3 vector solve's shapes, of the forward
r2c and the c2r pairs at the 2D route's (256, 512) shape (m = 1024), of the
z conv at the 2D route's (1, 256, 512) shape (m = 512) and at a 2D mesh
shard's (1, 256, 129) (key ``2d mesh shard``), and of
``torch.fft.rfft`` and ``torch.fft.irfft`` on the x edges' inputs, with the
edge passes' and the z conv's relative errors; and the fast tier's z pass's
and c2r's ``device_ms``, ``host_us`` and relative errors (``curl_rel_err``,
``vel_rel_err``: ``u`` and ``l1_max``) at 256^3 and at the multi-body
case's (128, 128, 256) (z at m = 256, x at 512, key ``multibody``), with
the host time of the c2r wrapper's plan step alone (``host_us`` key
``c2r_velocity_tile_plan``, in trees that have it); and the fused forward
pass ``rfft_fft_pass_fused`` (key ``fused_r2c``) at the 256^3 solve's
(768, 256, 256) slabs and the rod grid's (768, 64, 256): its ``ms``,
``device_ms`` and ``host_us``, its relative error, the plan
``fused_r2c_cluster_plan`` gives (in trees that have it), and the ``ms`` and
``device_ms`` of ``torch.fft.rfft2`` and of the unfused pair
(``rfft_pass_padded_split`` then ``fft_pass_padded``) on the same field;
and the fused inverse pass ``ifft_irfft_pass_fused`` (key ``fused_c2r``)
at the same slabs' (A, my, nx) pairs: the same numbers, the plan
``fused_c2r_cluster_plan`` gives (in trees that have it), and the ``ms``
and ``device_ms`` of ``torch.fft.irfft2`` with the ``[:ny, :nx]`` view (on
the whole spectrum, the Nyquist column's y spectrum joined outside the
timing) and of the unfused pair (``ifft_pass_truncated`` then
``irfft_pass_merge``) on the same spectrum.
It imports the package from ``sys.path`` and uses only the wrappers' public
names, so it compares two trees on one card within one job: unpack the other
tree into a directory and run this file with ``PYTHONPATH`` set to each, in
turns (a, b, b, a). Each x-edge pass, the z conv, ``torch.fft.rfft`` and
``torch.fft.irfft`` also get their device time from ``torch.profiler``
(``device_ms``) and the
host's time to enqueue one call (``host_us``): a call's event time starts
from an idle card and includes that enqueue, which at the 2D shape is most
of it.

``--sweep`` (or ``--sweep`` followed by some of ``fused_c2r``,
``fused_r2c``, ``velocity``, ``curl``, ``zconv``, ``r2c``, ``c2r``: those
sweeps only) prints the split
r2c kernel's device time under every plan its
launcher takes at both shapes, the one ``edge_tile_plan`` picks marked, the
split c2r kernel's under each tile and ring depth with the most blocks an SM
that fit (at most nine plans a shape), the one ``c2r_tile_plan`` picks
marked, and the z conv's under each of its two instances (16 and 8 columns a tile)
with one block an SM up to as many as the plan allows (at most six plans a
shape) at 256^3, the 2D shape and the multi-body case's m = 256, the one
``zconv_tile_plan`` picks marked, and the fast tier's z pass the same way
at 256^3, the multi-body case's and the 64^3 case's shapes, the one
``zconv_curl_tile_plan`` picks marked, and its c2r under each tile and ring
depth with the most blocks an SM that fit at those three shapes, the one
``c2r_velocity_tile_plan`` picks marked, and the fused forward pass's
cluster kernel under each of ``fused_r2c_cluster_shapes`` (cluster size,
threads, one buffer, as many clusters as the card holds) at the 256^3, rod
and 64^3 slabs, the one ``fused_r2c_cluster_plan`` picks marked, and the
fused inverse pass's cluster kernel the same way under each of
``fused_c2r_cluster_shapes``, 16-byte and 4-byte tile copies, the one
``fused_c2r_cluster_plan`` picks marked.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import torch

from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.parallel import cuda_fft

DEFAULT_GRIDS = ((48, 32, 64), (1, 256, 512), (16, 272, 80), (256, 256, 256))
R2C = ("rfft_pass_padded_split", "rfft_pass_padded")
C2R = ("irfft_pass_merge", "irfft_pass_truncated")
# the x edges' shapes: the 256^3 vector solve's rows and the 2D route's
# (rows, real row length n, m = 2 n)
EDGE_SHAPES = (("256^3", 3 * 256 * 256, 256), ("2d", 256, 512))
# the x edges' extra checks (rows, real row length, m, storage offset in
# floats): ragged last tiles, inputs 4 bytes off 16-byte alignment, odd
# lengths, the 2D route's m = 1024 and the four-step kernel's m = 96, 544
EDGE_CASES = ((203, 256, 512, 0), (61, 255, 512, 1), (9, 3, 64, 0),
              (256, 512, 1024, 0), (37, 48, 96, 0), (40, 272, 544, 3),
              (5, 511, 1024, 1))
# the z conv's (A, m/2, B) shapes: the 256^3 vector solve's, the 2D
# route's y pass and a shard's y step of the (256, 512) grid's 2D mesh
# solve on 4 shards (fxp = 516: 129 columns)
ZCONV_INPUTS = (("256^3", (3, 256, 512 * 256)), ("2d", (1, 256, 512)),
                ("2d mesh shard", (1, 256, 129)))
# its extra checks (A, m/2, B, storage offset in floats): ragged last tiles,
# inputs 4 bytes off 16-byte alignment, A = 1, and the four-step kernel's
# lengths (m = 96, 544, 1024)
ZCONV_CASES = ((3, 256, 1001, 0), (3, 256, 4100, 1), (1, 256, 512, 0),
               (1, 128, 300, 0), (3, 64, 999, 2), (3, 32, 4096, 0),
               (3, 48, 333, 0), (3, 272, 200, 1), (3, 512, 777, 0))
# the fast tier's z pass's (nz, ny, nx) grids: the 256^3 sphere's, the
# multi-body case's and the 64^3 drag run's
CURL_GRIDS = (("256^3", (256, 256, 256)), ("multibody", (128, 128, 256)),
              ("64^3", (64, 64, 64)))
# the fused forward pass's (A, ny, nx) slabs: the 256^3 vector solve's, the
# rod grid's (256, 64, 256) and the 64^3 run's
FUSED_R2C_SLABS = (("256^3", (768, 256, 256)), ("rod", (768, 64, 256)),
                   ("64^3", (192, 64, 64)))


def median_ms(fn, n=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def device_ms(fn, n=20):
    """Device time of one call, from ``torch.profiler`` over ``n`` calls:
    the kernels' own time, without the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / n / 1e3


def host_us(fn, n=200):
    """Host time to enqueue one call (microseconds), over ``n`` calls that
    are not waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def rel_err(out, ref):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((o - q).abs().max()) for o, q in zip(out, ref))
    return err / max(float(q.abs().max()) for q in ref)


def pass_args(grid, rand, components=3):
    nz, ny, nx = grid
    rows, a, my, mx = components * nz * ny, components * nz, 2 * ny, 2 * nx
    return {
        "rfft_pass_padded": (rand(rows, nx), mx),
        "irfft_pass_truncated": (rand(rows, nx + 1), rand(rows, nx + 1), mx, nx),
        "rfft_fft_pass_fused": (rand(a, ny, nx), mx, my),
        "ifft_irfft_pass_fused": (rand(a, my, nx), rand(a, my, nx),
                                  rand(a, ny, 1), rand(a, ny, 1), mx, nx),
        "rfft_pass_padded_split": (rand(rows, nx), mx),
        "irfft_pass_merge": (rand(rows, nx), rand(rows, nx), rand(rows, 1),
                             rand(rows, 1), mx, nx),
    }


def c2r_args(name, rows, n, rand):
    """A c2r pass's inputs: (rows, n) spectra (n + 1 unsplit) into n reals
    at m = 2 n."""
    if name == "irfft_pass_merge":
        return (rand(rows, n), rand(rows, n), rand(rows, 1), rand(rows, 1),
                2 * n, n)
    return rand(rows, n + 1), rand(rows, n + 1), 2 * n, n


def irfft_call(args):
    """``torch.fft.irfft`` on a c2r pass's inputs (joined outside the
    timing)."""
    if len(args) == 6:
        br, bi, sr, si, m, _ = args
        z = torch.complex(torch.cat([br, sr], 1), torch.cat([bi, si], 1))
    else:
        z, m = torch.complex(args[0], args[1]), args[2]
    return lambda: torch.fft.irfft(z, n=m, dim=1)


def solve_pass_args(n, rand, dev):
    """Each of the other seven FFT-pass kernels' inputs at the shapes of the
    n^3 vector solve (3 components, doubled axes) and its fast tier."""
    c, m = 3, 2 * n
    rows = c * n * n
    sym_z, _, sym_yx = poisson._curl_symbols((m, m, m), 1.0 / n, dev)
    return {
        "fft_pass_padded": lambda: (rand(c * n, n, n), rand(c * n, n, n), m),
        "fft_greens_ifft_pass": lambda: (rand(c, n, m * n), rand(c, n, m * n),
                                         rand(1, m, m * n)),
        "ifft_pass_truncated": lambda: (rand(c * n, m, n), rand(c * n, m, n)),
        "fft_greens_curl_ifft_pass": lambda: (
            rand(3, n, m * n), rand(3, n, m * n), rand(1, m, m * n), sym_z,
            sym_yx),
        "irfft_pass_merge_velocity": lambda: (
            rand(3, n * n, n), rand(3, n * n, n), rand(3, n * n, 1),
            rand(3, n * n, 1), torch.tensor([1.0, -0.5, 0.25], device=dev), m,
            n, n, n),
        "rfft_fft_pass_fused": lambda: (rand(c * n, n, n), m, m),
        "ifft_irfft_pass_fused": lambda: (rand(c * n, m, n), rand(c * n, m, n),
                                          rand(c * n, n, 1), rand(c * n, n, 1),
                                          m, n),
    }


def curl_args(grid, rand, dev, offset=0):
    """The fast tier's z pass's inputs for an (nz, ny, nx) grid: the
    vorticity spectra (3, nz, 2 ny nx) (``offset`` floats into their
    storage), the Green's spectrum and the grid's curl symbols."""
    nz, ny, nx = grid
    b = 2 * ny * nx
    sym_z, _, sym_yx = poisson._curl_symbols((2 * nz, 2 * ny, 2 * nx),
                                             1.0 / nx, dev)
    n = 3 * nz * b

    def spectrum():
        return rand(n + offset)[offset:].view(3, nz, b)

    return spectrum(), spectrum(), rand(1, 2 * nz, b), sym_z, sym_yx


def vel_args(grid, rand, dev):
    """The fast tier's c2r inputs for an (nz, ny, nx) grid: the three
    components' (nz ny, nx) bulk spectra and Nyquist pairs, the free stream,
    m = 2 nx, n_out = nx."""
    nz, ny, nx = grid
    rows = nz * ny
    return (rand(3, rows, nx), rand(3, rows, nx), rand(3, rows, 1),
            rand(3, rows, 1), torch.tensor([1.0, -0.5, 0.25], device=dev),
            2 * nx, nx, ny, nz)


def vel_rel_err(args):
    """Relative errors of the fast tier's c2r against its plain version:
    ``{"u": ..., "l1_max": ...}``."""
    u, l1 = cuda_fft.irfft_pass_merge_velocity(*args)
    ref_u, ref_l1 = cuda_fft.irfft_pass_merge_velocity_ref(*args)
    return {"u": rel_err(u, ref_u),
            "l1_max": abs(float(l1) - float(ref_l1)) / float(ref_l1)}


def sass_sizes(path, pattern):
    """Instructions of each kernel whose mangled name matches ``pattern`` in
    the library at ``path``, from ``cuobjdump --dump-sass`` (empty where the
    toolkit has none)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "--dump-sass", str(path)],
                             capture_output=True, text=True).stdout
    except OSError:
        return {}
    sizes, name = {}, None
    for ln in out.splitlines():
        fn = re.search(r"Function : (\S+)", ln)
        if fn:
            name = fn.group(1) if re.search(pattern, fn.group(1)) else None
            if name:
                sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln):
            sizes[name] += 1
    return sizes


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def timing(tag, rand, dev):
    """The JSON line: medians of 20 calls of the r2c and c2r pairs,
    torch.fft.rfft and torch.fft.irfft at 256^3 and at the 2D shape, and of
    the other seven at 256^3."""
    out = {"tag": tag, "module": cuda_fft.__file__, "card": card(),
           "ms": {"256^3": {}, "2d": {}, "2d mesh shard": {}},
           "torch_fft_rfft_ms": {}, "torch_fft_irfft_ms": {},
           "device_ms": {"256^3": {}, "2d": {}, "2d mesh shard": {}},
           "host_us": {"256^3": {}, "2d": {}, "2d mesh shard": {}},
           "r2c_rel_err": {"256^3": {}, "2d": {}},
           "c2r_rel_err": {"256^3": {}, "2d": {}}}

    def record(shape, name, fn, args, ref_fn, errs):
        errs[shape][name] = rel_err(fn(*args), ref_fn(*args))
        out["ms"][shape][name] = median_ms(lambda: fn(*args), 20, 3)
        out["device_ms"][shape][name] = device_ms(lambda: fn(*args))
        out["host_us"][shape][name] = host_us(lambda: fn(*args))

    for shape, rows, n in EDGE_SHAPES:
        x = rand(rows, n)
        for name in R2C:
            record(shape, name, getattr(cuda_fft, name), (x, 2 * n),
                   getattr(cuda_fft, name + "_ref"), out["r2c_rel_err"])
        out["torch_fft_rfft_ms"][shape] = median_ms(
            lambda: torch.fft.rfft(x, n=2 * n, dim=1), 20, 3)
        out["device_ms"][shape]["torch.fft.rfft"] = device_ms(
            lambda: torch.fft.rfft(x, n=2 * n, dim=1))
        del x
        for name in C2R:
            args = c2r_args(name, rows, n, rand)
            record(shape, name, getattr(cuda_fft, name), args,
                   getattr(cuda_fft, name + "_ref"), out["c2r_rel_err"])
            if name == "irfft_pass_merge":
                irfft = irfft_call(args)
                out["torch_fft_irfft_ms"][shape] = median_ms(irfft, 20, 3)
                out["device_ms"][shape]["torch.fft.irfft"] = device_ms(irfft)
                del irfft
            del args
        torch.cuda.empty_cache()
    for name, make in solve_pass_args(256, rand, dev).items():
        args, fn = make(), getattr(cuda_fft, name)
        out["ms"]["256^3"][name] = median_ms(lambda: fn(*args), 20, 3)
        del args
        torch.cuda.empty_cache()
    name, fn = "fft_greens_curl_ifft_pass", cuda_fft.fft_greens_curl_ifft_pass
    out["curl_rel_err"] = {}
    for shape, grid in CURL_GRIDS[:2]:
        args = curl_args(grid, rand, dev)
        out["curl_rel_err"][shape] = rel_err(
            fn(*args), cuda_fft.fft_greens_curl_ifft_pass_ref(*args))
        for key in ("ms", "device_ms", "host_us"):
            out[key].setdefault(shape, {})
        if shape != "256^3":
            out["ms"][shape][name] = median_ms(lambda: fn(*args), 20, 3)
        out["device_ms"][shape][name] = device_ms(lambda: fn(*args))
        out["host_us"][shape][name] = host_us(lambda: fn(*args))
        del args
        torch.cuda.empty_cache()
    name, fn = "irfft_pass_merge_velocity", cuda_fft.irfft_pass_merge_velocity
    out["vel_rel_err"] = {}
    for shape, grid in CURL_GRIDS[:2]:
        args = vel_args(grid, rand, dev)
        out["vel_rel_err"][shape] = vel_rel_err(args)
        if shape != "256^3":
            out["ms"][shape][name] = median_ms(lambda: fn(*args), 20, 3)
        out["device_ms"][shape][name] = device_ms(lambda: fn(*args))
        out["host_us"][shape][name] = host_us(lambda: fn(*args))
        plan = getattr(cuda_fft, "c2r_velocity_tile_plan", None)
        if plan is not None:
            br, bi, sr, _, _, m, n, ny, nz = args
            out["host_us"][shape][plan.__name__] = host_us(lambda: plan(
                nz * ny, n, m, br.data_ptr() | bi.data_ptr() | sr.data_ptr(),
                cuda_fft._sm_count(br.device)))
        del args
        torch.cuda.empty_cache()
    name, fn = "fft_greens_ifft_pass", cuda_fft.fft_greens_ifft_pass
    out["zconv_rel_err"] = {}
    for shape, (a, h, b) in ZCONV_INPUTS:
        args = (rand(a, h, b), rand(a, h, b), rand(1, 2 * h, b))
        out["zconv_rel_err"][shape] = rel_err(
            fn(*args), cuda_fft.fft_greens_ifft_pass_ref(*args))
        if shape != "256^3":
            out["ms"][shape][name] = median_ms(lambda: fn(*args), 20, 3)
        out["device_ms"][shape][name] = device_ms(lambda: fn(*args))
        out["host_us"][shape][name] = host_us(lambda: fn(*args))
        del args
        torch.cuda.empty_cache()
    out["fused_r2c"] = {}
    for shape, (a, ny, nx) in FUSED_R2C_SLABS[:2]:
        x = rand(a, ny, nx)
        my, mx = 2 * ny, 2 * nx
        rec = out["fused_r2c"][shape] = {}
        plan = getattr(cuda_fft, "fused_r2c_cluster_plan", None)
        if plan is not None:
            rec["plan"] = plan(a, ny, nx, my, mx, dev, x.data_ptr())._asdict()
        fn = lambda: cuda_fft.rfft_fft_pass_fused(x, mx, my)
        rec["rel_err"] = rel_err(fn(), cuda_fft.rfft_fft_pass_fused_ref(
            x, mx, my))
        rec["ms"], rec["device_ms"] = median_ms(fn, 20, 3), device_ms(fn)
        rec["host_us"] = host_us(fn)
        rfft2 = lambda: torch.fft.rfft2(x, s=(my, mx))
        rec["torch_fft_rfft2_ms"] = median_ms(rfft2, 20, 3)
        rec["torch_fft_rfft2_device_ms"] = device_ms(rfft2)

        def pair():
            br, bi, _, _ = cuda_fft.rfft_pass_padded_split(
                x.view(a * ny, nx), mx)
            return cuda_fft.fft_pass_padded(br.view(a, ny, nx),
                                            bi.view(a, ny, nx), my)

        rec["unfused_ms"], rec["unfused_device_ms"] = median_ms(pair, 20, 3), \
            device_ms(pair)
        del x
        torch.cuda.empty_cache()
    out["fused_c2r"] = {}
    for shape, (a, ny, nx) in FUSED_R2C_SLABS[:2]:
        my, mx = 2 * ny, 2 * nx
        br, bi, sr, si = rand(a, my, nx), rand(a, my, nx), rand(a, ny, 1), \
            rand(a, ny, 1)
        rec = out["fused_c2r"][shape] = {}
        plan = getattr(cuda_fft, "fused_c2r_cluster_plan", None)
        if plan is not None:
            rec["plan"] = plan(a, ny, nx, my, mx, dev, br.data_ptr()
                               | bi.data_ptr())._asdict()
        fn = lambda: cuda_fft.ifft_irfft_pass_fused(br, bi, sr, si, mx, nx)
        rec["rel_err"] = rel_err(fn(), cuda_fft.ifft_irfft_pass_fused_ref(
            br, bi, sr, si, mx, nx))
        rec["ms"], rec["device_ms"] = median_ms(fn, 20, 3), device_ms(fn)
        rec["host_us"] = host_us(fn)
        z = torch.cat([torch.complex(br, bi), torch.fft.fft(
            torch.complex(sr, si), n=my, dim=1)], dim=2)
        irfft2 = lambda: torch.fft.irfft2(z, s=(my, mx))[:, :ny, :nx]
        rec["torch_fft_irfft2_ms"] = median_ms(irfft2, 20, 3)
        rec["torch_fft_irfft2_device_ms"] = device_ms(irfft2)
        del z

        def pair():
            yr, yi = cuda_fft.ifft_pass_truncated(br, bi)
            return cuda_fft.irfft_pass_merge(
                yr.view(a * ny, nx), yi.view(a * ny, nx), sr.view(a * ny, 1),
                si.view(a * ny, 1), mx, nx)

        rec["unfused_ms"], rec["unfused_device_ms"] = median_ms(pair, 20, 3), \
            device_ms(pair)
        del br, bi, sr, si
        torch.cuda.empty_cache()
    return out


def sweep_fused_c2r(rand, dev):
    """Device time of the fused inverse pass's cluster kernel under each of
    ``fused_c2r_cluster_shapes`` at the 256^3, rod and 64^3 slabs, with
    16-byte and 4-byte tile copies, the plan ``fused_c2r_cluster_plan``
    picks marked: one line a plan."""
    lib = cuda_fft.library()
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (a, ny, nx) in FUSED_R2C_SLABS:
        my, mx = 2 * ny, 2 * nx
        br, bi, sr = rand(a, my, nx), rand(a, my, nx), rand(a, ny, 1)
        out = torch.empty(a, ny, nx, device=dev)
        tables = (cuda_fft._table(my, dev), cuda_fft._table(mx, dev))
        chosen = cuda_fft.fused_c2r_cluster_plan(
            a, ny, nx, my, mx, dev, br.data_ptr() | bi.data_ptr())
        for c, threads, smem, per_sm in cuda_fft.fused_c2r_cluster_shapes(
                ny, nx, my, mx):
            plan = cuda_fft.fused_c2r_plan_of(a, nx, my, c, threads, smem,
                                              per_sm, dev, br.data_ptr())
            for p in (plan, plan._replace(bulk=False)):

                def fn(p=p):
                    return lib.sopht_ifft_irfft_pass_fused_f32(
                        br.data_ptr(), bi.data_ptr(), sr.data_ptr(),
                        out.data_ptr(), *(t.data_ptr() for t in tables),
                        None, a, nx, mx, my, *p.args(), stream)

                if fn():
                    print(f"sweep fused_c2r {shape}: {p} refused", flush=True)
                    continue
                mark = " <- fused_c2r_cluster_plan" if p == chosen else ""
                print(f"sweep fused_c2r {shape}: C {c} threads {threads} "
                      f"clusters {p.clusters} smem {smem} blocks/SM {per_sm} "
                      f"copies {16 if p.bulk else 4} B: "
                      f"{device_ms(fn):.4f} ms{mark}", flush=True)
        del br, bi, sr, out
        torch.cuda.empty_cache()


def sweep_fused_r2c(rand, dev):
    """Device time of the fused forward pass's cluster kernel under each
    of ``fused_r2c_cluster_shapes`` at the 256^3, rod and 64^3 slabs, the
    plan ``fused_r2c_cluster_plan`` picks marked: one line a plan."""
    lib = cuda_fft.library()
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (a, ny, nx) in FUSED_R2C_SLABS:
        my, mx = 2 * ny, 2 * nx
        x = rand(a, ny, nx)
        outs = [torch.empty(a, my, nx, device=dev) for _ in range(2)] + [
            torch.empty(a, ny, 1, device=dev) for _ in range(2)]
        tables = (cuda_fft._table(my, dev), cuda_fft._table(mx, dev))
        chosen = cuda_fft.fused_r2c_cluster_plan(a, ny, nx, my, mx, dev,
                                                 x.data_ptr())
        for c, threads, smem, per_sm in cuda_fft.fused_r2c_cluster_shapes(
                ny, nx, my, mx):
            plan = cuda_fft.fused_r2c_plan_of(a, nx, my, c, threads, smem,
                                              per_sm, dev, x.data_ptr())

            def fn(plan=plan):
                return lib.sopht_rfft_fft_pass_fused_f32(
                    x.data_ptr(), *(o.data_ptr() for o in outs),
                    *(t.data_ptr() for t in tables), None, a, nx, mx, my,
                    *plan.args(), stream)

            if fn():
                print(f"sweep fused_r2c {shape}: {plan} refused", flush=True)
                continue
            mark = " <- fused_r2c_cluster_plan" if plan == chosen else ""
            print(f"sweep fused_r2c {shape}: C {c} threads {threads} "
                  f"clusters {plan.clusters} smem {smem} "
                  f"blocks/SM {per_sm}: {device_ms(fn):.4f} ms{mark}",
                  flush=True)
        del x, outs
        torch.cuda.empty_cache()


def sweep(rand, dev):
    """Device time of the split r2c kernel under every plan its launcher
    takes at 256^3 rows and the 2D shape (rows a tile, ring stages, blocks
    an SM), the plan ``edge_tile_plan`` picks marked: one line a plan."""
    lib, sms = cuda_fft.library(), cuda_fft._sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, rows, n_in in EDGE_SHAPES:
        m, h = 2 * n_in, n_in
        x = rand(rows, n_in)
        outs = [rand(rows, h), rand(rows, h), rand(rows, 1), rand(rows, 1)]
        table = cuda_fft._table(m, dev)
        chosen = cuda_fft.edge_tile_plan(rows, n_in, m, False, x.data_ptr(),
                                         sms)
        g = cuda_fft._edge_shape(h)[1]
        for t in (4, 8, 16, 32, 64):
            threads = t * g
            if threads % 32 or threads > 256:
                continue
            for stages in (2, 3, 4):
                smem = cuda_fft._edge_smem(h, t, n_in, stages, False)
                for per_sm in range(1, 2048 // threads + 1):
                    if per_sm * (smem + cuda_fft.BLOCK_SHARED_RESERVE) > \
                            cuda_fft.SM_SHARED_BYTES:
                        break
                    plan = cuda_fft.EdgeTilePlan(
                        t, min(-(-rows // t), per_sm * sms), stages, smem,
                        True, threads, per_sm)

                    def fn(plan=plan):
                        return lib.sopht_rfft_pass_padded_split_f32(
                            x.data_ptr(), *(o.data_ptr() for o in outs),
                            table.data_ptr(), rows, n_in, m, *plan.args(),
                            stream)

                    if fn():  # refused: the blocks would not all be resident
                        break
                    mark = " <- edge_tile_plan" if plan == chosen else ""
                    print(f"sweep {shape}: T {t} threads {threads} stages "
                          f"{stages} blocks/SM {per_sm} blocks {plan.blocks}: "
                          f"{device_ms(fn):.4f} ms{mark}", flush=True)
        del x, outs
        torch.cuda.empty_cache()


def sweep_c2r(rand, dev):
    """Device time of the split c2r kernel at 256^3 rows and the 2D shape
    under each tile (rows) and ring depth, with the most blocks an SM that
    fit (at most nine plans a shape), the plan ``c2r_tile_plan`` picks
    marked: one line a plan."""
    lib, sms = cuda_fft.library(), cuda_fft._sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, rows, n in EDGE_SHAPES:
        m = 2 * n
        br, bi, sr, _, _, _ = c2r_args("irfft_pass_merge", rows, n, rand)
        out = rand(rows, n)
        table = cuda_fft._table(m, dev)
        chosen = cuda_fft.c2r_tile_plan(
            rows, n, m, False, br.data_ptr() | bi.data_ptr() | sr.data_ptr(),
            sms)
        g = cuda_fft._edge_shape(n)[1]
        for t in (4, 8, 16, 32, 64):
            threads = t * g
            if threads % 32 or threads > 256:
                continue
            for stages in (2, 3, 4):
                smem = cuda_fft._c2r_smem(n, t, n, stages, False)
                per_sm = min(512 // threads, cuda_fft.SM_SHARED_BYTES // (
                    smem + cuda_fft.BLOCK_SHARED_RESERVE))
                if per_sm < 1 or smem > cuda_fft.BLOCK_SHARED_MAX:
                    continue
                plan = cuda_fft.EdgeTilePlan(
                    t, min(-(-rows // t), per_sm * sms), stages, smem, True,
                    threads, per_sm)

                def fn(plan=plan):
                    return lib.sopht_irfft_pass_merge_f32(
                        br.data_ptr(), bi.data_ptr(), sr.data_ptr(),
                        out.data_ptr(), table.data_ptr(), rows, m, n,
                        *plan.args(), stream)

                if fn():
                    print(f"sweep c2r {shape}: {plan} refused", flush=True)
                    continue
                mark = " <- c2r_tile_plan" if plan == chosen else ""
                print(f"sweep c2r {shape}: T {t} threads {threads} stages "
                      f"{stages} blocks/SM {per_sm} blocks {plan.blocks}: "
                      f"{device_ms(fn):.4f} ms{mark}", flush=True)
        del br, bi, sr, out
        torch.cuda.empty_cache()


def sweep_zconv(rand, dev):
    """Device time of the z conv kernel under the plans of each instance
    (columns a tile) with 1 up to ``blocks_per_sm`` blocks an SM, at the
    256^3 solve's shape, the 2D shape and the multi-body case's (m = 256),
    the plan ``zconv_tile_plan`` picks marked: one line a plan."""
    lib, sms = cuda_fft.library(), cuda_fft._sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (a, h, b) in ZCONV_INPUTS + (("multibody",
                                             (3, 128, 256 * 256)),):
        m = 2 * h
        xr, xi, g = rand(a, h, b), rand(a, h, b), rand(1, m, b)
        outs = [rand(a, h, b), rand(a, h, b)]
        table = cuda_fft._table(m, dev)
        aligned = (xr.data_ptr() | xi.data_ptr()) % 16 == 0
        chosen = cuda_fft.zconv_tile_plan(a, b, m, xr.data_ptr() |
                                          xi.data_ptr(), sms)
        for cols in cuda_fft.ZCONV_COLUMNS:
            base = cuda_fft.zconv_columns_plan(b, m, aligned, sms, cols)
            for per_sm in range(1, base.blocks_per_sm + 1):
                plan = base._replace(blocks=min(-(-b // cols), per_sm * sms),
                                     blocks_per_sm=per_sm)

                def fn(plan=plan):
                    return lib.sopht_fft_greens_ifft_pass_f32(
                        xr.data_ptr(), xi.data_ptr(), g.data_ptr(),
                        *(o.data_ptr() for o in outs), table.data_ptr(),
                        a, b, m, *plan.args(), stream)

                if fn():  # refused: the blocks would not all be resident
                    print(f"sweep zconv {shape}: {plan} refused", flush=True)
                    continue
                mark = " <- zconv_tile_plan" if plan == chosen else ""
                print(f"sweep zconv {shape}: T {cols} threads {plan.threads} "
                      f"blocks/SM {per_sm} blocks {plan.blocks}: "
                      f"{device_ms(fn):.4f} ms{mark}", flush=True)
        del xr, xi, g, outs
        torch.cuda.empty_cache()


def sweep_zconv_curl(rand, dev):
    """Device time of the fast tier's z ring kernel under the plans of each
    instance (columns a tile) with 1 up to ``blocks_per_sm`` blocks an SM,
    at the 256^3, multi-body and 64^3 grids' shapes, the plan
    ``zconv_curl_tile_plan`` picks marked: one line a plan."""
    lib, sms = cuda_fft.library(), cuda_fft._sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, grid in CURL_GRIDS:
        args = curl_args(grid, rand, dev)
        _, h, b = args[0].shape
        m = 2 * h
        outs = [torch.empty_like(args[0]) for _ in range(2)]
        table = cuda_fft._table(m, dev)
        ptr = args[0].data_ptr() | args[1].data_ptr()
        chosen = cuda_fft.zconv_curl_tile_plan(b, m, ptr, sms)
        for cols in cuda_fft.ZCONV_COLUMNS:
            base = cuda_fft.zconv_curl_columns_plan(b, m, ptr % 16 == 0, sms,
                                                    cols)
            for per_sm in range(1, base.blocks_per_sm + 1):
                plan = base._replace(blocks=min(-(-b // cols), per_sm * sms),
                                     blocks_per_sm=per_sm)

                def fn(plan=plan):
                    return lib.sopht_fft_greens_curl_ifft_pass_f32(
                        *(t.data_ptr() for t in args),
                        *(o.data_ptr() for o in outs), table.data_ptr(), b,
                        m, *plan.args(), stream)

                if fn():  # refused: the blocks would not all be resident
                    print(f"sweep curl {shape}: {plan} refused", flush=True)
                    continue
                mark = " <- zconv_curl_tile_plan" if plan == chosen else ""
                print(f"sweep curl {shape}: T {cols} threads {plan.threads} "
                      f"blocks/SM {per_sm} blocks {plan.blocks}: "
                      f"{device_ms(fn):.4f} ms{mark}", flush=True)
        del args, outs
        torch.cuda.empty_cache()


def sweep_velocity(rand, dev):
    """Device time of the fast tier's c2r ring kernel at the 256^3,
    multi-body and 64^3 grids' shapes under each tile (rows) and ring depth,
    with the most blocks an SM that fit, the plan
    ``c2r_velocity_tile_plan`` picks marked: one line a plan."""
    lib, sms = cuda_fft.library(), cuda_fft._sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, grid in CURL_GRIDS:
        br, bi, sr, _, fsv, m, n, ny, nz = vel_args(grid, rand, dev)
        rows, h = nz * ny, m // 2
        out = torch.empty(3, rows, n, device=dev)
        l1 = torch.zeros((), device=dev)
        table = cuda_fft._table(m, dev)
        chosen = cuda_fft.c2r_velocity_tile_plan(
            rows, n, m, br.data_ptr() | bi.data_ptr() | sr.data_ptr(), sms)
        g = cuda_fft._edge_shape(h)[1]
        for t in (4, 8, 16, 32, 64):
            threads = t * g
            if threads % 32 or threads > 256:
                continue
            for stages in (2, 3, 4):
                smem = cuda_fft._c2r_smem(h, t, n, stages, False)
                per_sm = min(512 // threads, cuda_fft.SM_SHARED_BYTES // (
                    smem + cuda_fft.BLOCK_SHARED_RESERVE))
                if per_sm < 1 or smem > cuda_fft.BLOCK_SHARED_MAX:
                    continue
                plan = cuda_fft.EdgeTilePlan(
                    t, min(-(-rows // t), per_sm * sms), stages, smem,
                    chosen.bulk, threads, per_sm)

                def fn(plan=plan):
                    return lib.sopht_irfft_pass_merge_velocity_f32(
                        br.data_ptr(), bi.data_ptr(), sr.data_ptr(),
                        fsv.data_ptr(), out.data_ptr(), l1.data_ptr(),
                        table.data_ptr(), rows, m, n, ny, nz, *plan.args(),
                        stream)

                if fn():
                    print(f"sweep vel {shape}: {plan} refused", flush=True)
                    continue
                mark = " <- c2r_velocity_tile_plan" if plan == chosen else ""
                print(f"sweep vel {shape}: T {t} threads {threads} stages "
                      f"{stages} blocks/SM {per_sm} blocks {plan.blocks}: "
                      f"{device_ms(fn):.4f} ms{mark}", flush=True)
        del br, bi, sr, out
        torch.cuda.empty_cache()


def curl_cases(rand, dev):
    """The fast tier's z pass on ragged column counts, storage-offset
    inputs and the four-step kernel's lengths (m = 96, 1024): (case,
    relative error)."""
    results = []
    for grid, offset in (((256, 5, 101), 0), ((128, 3, 50), 1),
                         ((64, 7, 9), 2), ((32, 4, 8), 0), ((48, 5, 7), 0),
                         ((512, 2, 3), 1)):
        args = curl_args(grid, rand, dev, offset)
        err = rel_err(cuda_fft.fft_greens_curl_ifft_pass(*args),
                      cuda_fft.fft_greens_curl_ifft_pass_ref(*args))
        results.append((f"fft_greens_curl_ifft_pass {tuple(args[0].shape)} "
                        f"m={2 * grid[0]} offset {offset}", err))
    torch.cuda.synchronize()
    return results


def zconv_cases(rand):
    """The z conv on ragged column counts, storage-offset inputs, A = 1 and
    the four-step kernel's lengths: (case, relative error)."""
    results = []
    for a, h, b, offset in ZCONV_CASES:
        n = a * h * b
        xr = rand(n + offset)[offset:].view(a, h, b)
        xi = rand(n + offset)[offset:].view(a, h, b)
        g = rand(1, 2 * h, b)
        err = rel_err(cuda_fft.fft_greens_ifft_pass(xr, xi, g),
                      cuda_fft.fft_greens_ifft_pass_ref(xr, xi, g))
        results.append((f"fft_greens_ifft_pass ({a}, {h}, {b}) m={2 * h} "
                        f"offset {offset}", err))
    torch.cuda.synchronize()
    return results


def r2c_cases(rand):
    """The forward r2c pair on ragged row counts, a storage-offset input
    and lengths off the power-of-two design: (case, relative error)."""
    results = []
    for rows, n_in, m, offset in EDGE_CASES:
        x = rand(rows * n_in + offset)[offset:].view(rows, n_in)
        for name in R2C:
            err = rel_err(getattr(cuda_fft, name)(x, m),
                          getattr(cuda_fft, name + "_ref")(x, m))
            results.append((f"{name} ({rows}, {n_in}) m={m} offset {offset}",
                            err))
    torch.cuda.synchronize()
    return results


def c2r_cases(rand):
    """The c2r pair on ragged row counts, storage-offset inputs, odd output
    counts and lengths off the power-of-two design: (case, relative
    error)."""
    results = []
    for rows, n_out, m, offset in EDGE_CASES:
        h = m // 2

        def spectrum(cols):
            return rand(rows * cols + offset)[offset:].view(rows, cols)

        for name, args in (
                ("irfft_pass_merge", (spectrum(h), spectrum(h),
                                      rand(rows, 1), rand(rows, 1))),
                ("irfft_pass_truncated", (spectrum(h + 1), spectrum(h + 1)))):
            err = rel_err(getattr(cuda_fft, name)(*args, m, n_out),
                          getattr(cuda_fft, name + "_ref")(*args, m, n_out))
            results.append((f"{name} ({rows}, {n_out}) m={m} offset "
                            f"{offset}", err))
    torch.cuda.synchronize()
    return results


def main(argv):
    if not torch.cuda.is_available():
        print("probe_edge_passes: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    if argv and argv[0] == "--sweep":
        print(card())
        sweeps = {"fused_c2r": sweep_fused_c2r, "fused_r2c": sweep_fused_r2c,
                  "velocity": sweep_velocity,
                  "curl": sweep_zconv_curl, "zconv": sweep_zconv,
                  "r2c": sweep, "c2r": sweep_c2r}
        for name in argv[1:] or sweeps:
            sweeps[name](rand, dev)
        return 0
    if argv and argv[0] == "--json":
        tag = argv[1] if len(argv) > 1 else cuda_fft.__file__
        print(card())
        print(json.dumps(timing(tag, rand, dev)))
        return 0
    grids = DEFAULT_GRIDS
    if argv:
        if len(argv) % 3:
            print("usage: probe_edge_passes [nz ny nx ...] | --json [tag]",
                  file=sys.stderr)
            return 2
        vals = [int(v) for v in argv]
        grids = tuple(tuple(vals[i:i + 3]) for i in range(0, len(vals), 3))
    print(torch.__version__, torch.version.cuda)
    print(card())
    t0 = time.perf_counter()
    lib = cuda_fft.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    lines = lib.build_log.splitlines()
    for i, ln in enumerate(lines[:-2]):
        name = re.search(
            r"(irfft_edge_kernel|rfft_edge_kernel|zconv_kernel|"
            r"zconv_curl_kernel|rfft_fft_cluster_kernel|"
            r"ifft_irfft_cluster_kernel|"
            r"\w+_fused_kernel)((?:ILi|Li|Lb)\d+E)+",
            ln)
        if "Function properties" in ln and name:
            print(name.group(1)[-28:], re.findall(r"\d+", name.group(0)[
                len(name.group(1)):]), "|", lines[i + 1].strip(), "|",
                lines[i + 2].strip()[:60])
    for name, n in sass_sizes(
            lib._name, "zconv|irfft_edge|rfft_fft_cluster|ifft_irfft_cluster"
    ).items():
        kernel = re.search(r"(zconv\w*kernel|irfft_edge_kernel|"
                           r"rfft_fft_cluster_kernel|ifft_irfft_cluster_kernel)"
                           r"I((?:L[ib]\d+E)+)", name)
        dims = re.findall(r"\d+", kernel.group(2))
        print(f"sass {kernel.group(1)} {dims}: {n} instructions")
    for case, err in (r2c_cases(rand) + c2r_cases(rand) + zconv_cases(rand)
                      + curl_cases(rand, dev)):
        print(f"{case}: relative err {err:.3g}", flush=True)
    for grid in grids:
        if not all(cuda_fft.kernel_fft_supported(2 * n) for n in grid[1:]):
            print(f"{grid}: unsupported lengths")
            continue
        for name, args in pass_args(grid, rand).items():
            fn, ref_fn = getattr(cuda_fft, name), getattr(cuda_fft, name + "_ref")
            err = rel_err(fn(*args), ref_fn(*args))
            torch.cuda.synchronize()
            print(f"{grid} {name}: relative err {err:.3g}, "
                  f"{median_ms(lambda: fn(*args)):.4f} ms, plain "
                  f"{median_ms(lambda: ref_fn(*args), 3):.4f} ms", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(timing(cuda_fft.__file__, rand, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
