"""The port's FFT passes (``parallel/cuda_fft.py``) against the JAX
package's Pallas passes (interpret mode on CPU), the kernel-route solve
against the dense ``torch.fft`` solve, and the kernels against their plain
versions on the card (``cuda`` marker, skipped without one).

Tolerance: ``5e-6 max|ref|`` for every pass - float32 rounding of two
differently factored DFTs of length <= 128 (the JAX package holds its own
passes to 2e-6 of numpy's), and ``1e-5`` relative for the whole solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.parallel import pallas_fft as jax_fft
from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.parallel import cuda_fft

TOL = 5e-6
LENGTHS = [64, 96, 128]


def _rng(m):
    return np.random.default_rng(m)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(outs, refs, tol=TOL):
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    refs = refs if isinstance(refs, (tuple, list)) else (refs,)
    assert len(outs) == len(refs)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        ref = np.asarray(ref)
        assert out.shape == ref.shape, (out.shape, ref.shape)
        err = float(np.abs(out.astype(np.float64) - ref).max())
        assert err <= tol * scale, f"max|diff| {err} > {tol} * {scale}"


def _pass_inputs(name, m, rng):
    """(port args, JAX args) of one pass at length m, from one seed."""
    a, b, rows = 3, 12, 20
    h = m // 2
    if name == "rfft_pass_padded_split":
        x = _f32(rng, rows, h)
        return (x, m), (x, m)
    if name == "fft_pass_padded":
        xr, xi = _f32(rng, a, h, b), _f32(rng, a, h, b)
        return (xr, xi, m), (xr, xi, m)
    if name == "fft_greens_ifft_pass":
        xr, xi, g = _f32(rng, a, h, b), _f32(rng, a, h, b), _f32(rng, 1, m, b)
        return (xr, xi, g), (xr, xi, g)
    if name == "ifft_pass_truncated":
        xr, xi = _f32(rng, a, m, b), _f32(rng, a, m, b)
        return (xr, xi), (xr, xi)
    if name == "ifft_pass_truncated_greens":
        xr, xi, g = _f32(rng, a, m, b), _f32(rng, a, m, b), _f32(rng, a, m, b)
        return (xr, xi, g), (xr, xi, g)
    if name == "ifft_pass_truncated_shared_greens":
        xr, xi, g = _f32(rng, a, m, b), _f32(rng, a, m, b), _f32(rng, 1, m, b)
        return (xr, xi, g), (xr, xi, g)
    if name == "rfft_pass_padded":
        x = _f32(rng, rows, h)
        return (x, m), (x, m)
    if name == "irfft_pass_truncated":
        args = (_f32(rng, rows, h + 1), _f32(rng, rows, h + 1), m, h)
        return args, args
    if name == "rfft_fft_pass_fused":  # (A, ny, nx), mx = 64, my = m
        x = _f32(rng, a, h, 32)
        return (x, 64, m), (x, 64, m)
    if name == "ifft_irfft_pass_fused":
        args = (_f32(rng, a, m, 32), _f32(rng, a, m, 32), _f32(rng, a, h, 1),
                _f32(rng, a, h, 1), 64, 32)
        return args, args
    assert name == "irfft_pass_merge"
    args = (_f32(rng, rows, h), _f32(rng, rows, h), _f32(rng, rows, 1),
            _f32(rng, rows, 1), m, h)
    return args, args


PASSES = [
    "rfft_pass_padded_split",
    "fft_pass_padded",
    "fft_greens_ifft_pass",
    "ifft_pass_truncated",
    "ifft_pass_truncated_greens",
    "ifft_pass_truncated_shared_greens",
    "irfft_pass_merge",
    "rfft_pass_padded",
    "irfft_pass_truncated",
    "rfft_fft_pass_fused",
    "ifft_irfft_pass_fused",
]


def _fn_name(name):
    return "ifft_pass_truncated" if name.startswith("ifft_pass") else name


def _to_torch(args, device="cpu"):
    return tuple(
        torch.tensor(v, device=device) if isinstance(v, np.ndarray) else v
        for v in args
    )


@pytest.mark.parametrize("m", LENGTHS)
@pytest.mark.parametrize("name", PASSES)
def test_plain_pass_matches_jax_pallas(name, m):
    port_args, jax_args = _pass_inputs(name, m, _rng(m))
    fn = getattr(cuda_fft, _fn_name(name))
    jax_fn = getattr(jax_fft, _fn_name(name))
    ref = jax_fn(*(jnp.asarray(v) if isinstance(v, np.ndarray) else v
                   for v in jax_args))
    counts = [k.launches for k in cuda_fft.KERNELS]
    out = fn(*_to_torch(port_args))
    # a CPU tensor runs the plain version: no launch is counted
    assert [k.launches for k in cuda_fft.KERNELS] == counts
    _close(out, ref)
    for t in out if isinstance(out, tuple) else (out,):
        assert t.dtype == torch.float32 and t.is_contiguous()


def test_kernel_fft_supported_matches_jax_gate():
    for m in range(32, 2049):
        assert cuda_fft.kernel_fft_supported(m) == jax_fft.pallas_fft_supported(m), m


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(4, 32)
    with pytest.raises(TypeError):
        cuda_fft.rfft_pass_padded_split(x.double(), 64)
    with pytest.raises(ValueError):  # rows longer than the padded half
        cuda_fft.rfft_pass_padded_split(torch.zeros(4, 40), 64)
    with pytest.raises(ValueError):  # unsupported length
        cuda_fft.rfft_pass_padded_split(torch.zeros(4, 15), 30)
    with pytest.raises(ValueError):  # input is not half the output length
        cuda_fft.fft_pass_padded(torch.zeros(2, 30, 8), torch.zeros(2, 30, 8), 64)
    with pytest.raises(ValueError):
        cuda_fft.fft_pass_padded(torch.zeros(2, 32, 8), torch.zeros(2, 32, 7), 64)
    with pytest.raises(ValueError):  # a Green's tile per A is not the conv
        cuda_fft.fft_greens_ifft_pass(torch.zeros(2, 32, 8),
                                      torch.zeros(2, 32, 8),
                                      torch.zeros(2, 64, 8))
    with pytest.raises(ValueError):
        cuda_fft.ifft_pass_truncated(torch.zeros(3, 64, 8),
                                     torch.zeros(3, 64, 8),
                                     torch.zeros(2, 64, 8))
    with pytest.raises(ValueError):  # more outputs than the kept half
        cuda_fft.irfft_pass_merge(torch.zeros(4, 32), torch.zeros(4, 32),
                                  torch.zeros(4, 1), torch.zeros(4, 1), 64, 33)


@pytest.mark.parametrize(
    "grid", [(32, 32, 32), (48, 32, 64)], ids=["32^3", "48x32x64"]
)
@pytest.mark.parametrize("per_component", [False, True],
                         ids=["batched", "per-component"])
def test_kernel_route_solve_matches_dense(grid, per_component, monkeypatch):
    """The whole split pipeline (plain passes on CPU) against the dense
    ``torch.fft`` solve of the same solver; ``per_component`` lowers the
    512^3-class threshold so the component loop runs."""
    rhs = torch.tensor(_f32(np.random.default_rng(7), 3, *grid))
    dense_solver = poisson.UnboundedPoissonSolver3D(*grid, device="cpu")
    assert not isinstance(dense_solver.fourier_greens_times_dx_pow_dim, tuple)
    assert not dense_solver.uses_kernel_route(rhs)
    ref = dense_solver.vector_field_solve(rhs)
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    if per_component:
        monkeypatch.setattr(poisson, "_COMPONENT_MAP_THRESHOLD", 1)
    solver = poisson.UnboundedPoissonSolver3D(*grid, device="cpu")
    bulk, side = solver.fourier_greens_times_dx_pow_dim
    nz, ny, nx = grid
    assert tuple(bulk.shape) == (2 * nz, 2 * ny, nx)
    assert tuple(side.shape) == (2 * nz, 2 * ny)
    assert solver.uses_kernel_route(rhs)
    _close(solver.vector_field_solve(rhs), ref.numpy(), 1e-5)
    # a dense spectrum passed explicitly is split on the way in
    _close(solver.solve(rhs[0], dense_solver.fourier_greens_times_dx_pow_dim),
           ref[0].numpy(), 1e-5)
    # float64 stays on the dense route, with the pair reassembled
    assert not solver.uses_kernel_route(rhs.double())
    _close(solver._dense_greens(),
           dense_solver.fourier_greens_times_dx_pow_dim.numpy(), 0.0)


@pytest.mark.parametrize("grid", [(32, 32, 32), (48, 32, 64)],
                         ids=["32^3", "48x32x64"])
def test_fused_edge_convolve_matches_jax_pallas(grid, monkeypatch):
    """The 3D convolve with the fused edge passes on (plain versions on
    CPU) against the JAX package's ``_pallas_convolve_local`` with its flag
    on (Pallas kernels in interpret mode), and against the port's unfused
    arm: 1e-5 relative, as for the whole solve."""
    from sopht_mpi_tpu.ops import poisson as jax_poisson

    rng = np.random.default_rng(11)
    rhs = _f32(rng, 3, *grid)
    doubled = tuple(2 * n for n in grid)
    bulk = _f32(rng, doubled[0], doubled[1], grid[2])
    side = _f32(rng, doubled[0], doubled[1])
    monkeypatch.setattr(jax_fft, "USE_FUSED_EDGE_PASSES", True)
    assert jax_fft.fused_edge_pass_ok(grid[1], grid[2], doubled[1], doubled[2])
    ref = np.asarray(jax_poisson._pallas_convolve_local(
        jnp.asarray(rhs), (jnp.asarray(bulk), jnp.asarray(side)), doubled))
    greens = (torch.tensor(bulk), torch.tensor(side))
    unfused = poisson._kernel_convolve_local(torch.tensor(rhs), greens, doubled)
    monkeypatch.setattr(cuda_fft, "USE_FUSED_EDGE_PASSES", True)
    calls = []
    for name in ("rfft_fft_pass_fused", "ifft_irfft_pass_fused"):
        fn = getattr(cuda_fft, name)
        monkeypatch.setattr(
            cuda_fft, name,
            lambda *a, _fn=fn, _n=name: (calls.append(_n), _fn(*a))[1])
    fused = poisson._kernel_convolve_local(torch.tensor(rhs), greens, doubled)
    assert calls == ["rfft_fft_pass_fused", "ifft_irfft_pass_fused"]
    _close(fused, ref, 1e-5)
    _close(fused, unfused.numpy(), 1e-5)


# (ny, nx, my, mx); the last three differ from the JAX gate only where its
# VMEM budget (no counterpart on the card) or its dense x matrices (any mx)
# decide
FUSED_GATE_SHAPES = [
    (32, 32, 64, 64), (32, 64, 64, 128), (48, 32, 96, 64), (256, 256, 512, 512),
    (32, 32, 64, 96), (30, 32, 60, 64), (32, 1024, 64, 2048),
    (17, 32, 34, 64),
]


@pytest.mark.parametrize("shape", FUSED_GATE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_edge_gate_matches_jax_gate(shape, monkeypatch):
    assert not cuda_fft.USE_FUSED_EDGE_PASSES  # the default, as in JAX
    assert not jax_fft.USE_FUSED_EDGE_PASSES
    assert not cuda_fft.fused_edge_pass_ok(*shape)
    monkeypatch.setattr(cuda_fft, "USE_FUSED_EDGE_PASSES", True)
    monkeypatch.setattr(jax_fft, "USE_FUSED_EDGE_PASSES", True)
    ny, nx, my, mx = shape
    # the JAX gate leaves mx to the route gate above it (mx <= 1024) and
    # transforms x with dense matrices; the port also asks for a supported mx
    jax_ok = jax_fft.fused_edge_pass_ok(*shape) and mx <= 1024 \
        and jax_fft.pallas_fft_supported(mx)
    assert cuda_fft.fused_edge_pass_ok(*shape) == jax_ok


def test_route_gate():
    gate = poisson._kernel_convolve_supported
    assert not gate((64, 64, 64), torch.float32, "cpu")
    assert gate((64, 64, 64), torch.float32, "cuda")
    assert not gate((64, 64, 64), torch.float64, "cuda")
    assert not gate((2048, 64, 64), torch.float32, "cuda")
    assert not gate((64, 64, 2048), torch.float32, "cuda")
    assert not gate((64, 60, 64), torch.float32, "cuda")  # 60 < 64
    assert gate((64, 128), torch.float32, "cuda")  # the 2D solver's pair
    assert not gate((64, 2048), torch.float32, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [96, 512])
@pytest.mark.parametrize("name", PASSES)
def test_kernel_matches_plain_on_card(name, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    port_args, _ = _pass_inputs(name, m, _rng(m))
    fn = getattr(cuda_fft, _fn_name(name))
    plain = getattr(cuda_fft, _fn_name(name) + "_ref")
    args = _to_torch(port_args, "cuda")
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(*args)
    ref = tuple(r.cpu().numpy() for r in ref) if isinstance(ref, tuple) \
        else ref.cpu().numpy()
    _close(out, ref)
