"""The port's fast spectral tier against the JAX package's: the fused-curl
pair's plain versions against the Pallas passes (interpret mode on CPU),
the fused velocity recovery and its dense ``torch.fft`` form against the
JAX solver's, the simulator step on the tier, the construction-time
default, and the kernels against their plain versions on the card
(``cuda`` marker, skipped without one).

Tolerances: ``5e-6 max|ref|`` for each pass (float32 rounding of two
differently factored DFTs of length <= 128, the JAX package's own bound
for these passes); ``5e-6 max(1, |u|)`` for the velocity recovery (the JAX
package's bound against solve + curl); ``1e-5`` relative for the dense
form in float32, ``1e-10`` in float64; ``2e-4 max(1, |ref|)`` after two
simulator steps (the JAX test's bound for its fast tier, whose 3-pass bf16
matmuls the port's plain FP32 does not share).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.poisson as jax_poisson
from sopht_mpi_tpu.models import UnboundedFlowSimulator3D as JaxSim
from sopht_mpi_tpu.ops.stencils_3d import curl_3d as jax_curl_3d
from sopht_mpi_tpu.parallel import pallas_fft as jax_fft
import sopht_mpi_tpu_torch
from sopht_mpi_tpu_torch.models import UnboundedFlowSimulator3D
from sopht_mpi_tpu_torch.ops import poisson
from sopht_mpi_tpu_torch.ops.stencils_3d import curl_3d
from sopht_mpi_tpu_torch.parallel import cuda_fft

TOL = 5e-6


def _close(outs, refs, tol, scale=None):
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    refs = refs if isinstance(refs, (tuple, list)) else (refs,)
    assert len(outs) == len(refs)
    if scale is None:
        scale = max(float(np.abs(np.asarray(r)).max()) for r in refs)
    for out, ref in zip(outs, refs):
        out = out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
        ref = np.asarray(ref)
        assert out.shape == ref.shape, (out.shape, ref.shape)
        err = float(np.abs(out.astype(np.float64) - ref).max())
        assert err <= tol * scale, f"max|diff| {err} > {tol} * {scale}"


def _sym(n, dx):
    return np.sin(2 * np.pi * np.arange(n) / n) / dx


def _curl_pass_inputs(m, seed=11):
    """The JAX test's shapes: B = my * bx = 16 * 8, one lane tile."""
    rng = np.random.default_rng(seed)
    half, my, bx, dx = m // 2, 16, 8, 0.02
    b = my * bx
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    sym_yx = np.stack([np.repeat(_sym(my, dx), bx),
                       np.tile(_sym(2 * bx, dx)[:bx], my)]).astype(np.float32)
    return (f32(3, half, b), f32(3, half, b), f32(1, m, b),
            _sym(m, dx).astype(np.float32), sym_yx)


def _merge_inputs(m, n_out, nz=8, ny=8, seed=12):
    rng = np.random.default_rng(seed)
    rows, h = nz * ny, m // 2
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    fsv = np.array([1.0, -0.5, 0.25], np.float32)
    return (f32(3, rows, h), f32(3, rows, h), f32(3, rows, 1),
            f32(3, rows, 1), fsv, m, n_out, ny, nz)


def _torch_args(args, device="cpu"):
    return tuple(torch.tensor(a, device=device) if isinstance(a, np.ndarray)
                 else a for a in args)


def _jax_args(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args)


@pytest.mark.parametrize("m", [64, 128])
def test_curl_pass_plain_matches_jax_pallas(m):
    args = _curl_pass_inputs(m)
    assert jax_fft.conv_curl_pass_tile_ok(args[0].shape[2], m)
    ref = jax_fft.fft_greens_curl_ifft_pass(*_jax_args(args), fast=False)
    counts = [k.launches for k in cuda_fft.KERNELS]
    out = cuda_fft.fft_greens_curl_ifft_pass(*_torch_args(args))
    assert [k.launches for k in cuda_fft.KERNELS] == counts  # plain on CPU
    _close(out, ref, TOL)
    for t in out:
        assert t.dtype == torch.float32 and t.is_contiguous()


@pytest.mark.parametrize("m,n_out", [(64, 32), (128, 64), (128, 50)])
def test_merge_velocity_plain_matches_jax_pallas(m, n_out):
    args = _merge_inputs(m, n_out)
    assert jax_fft.merge_velocity_epilogue_ok(64, m // 2, n_out)
    ref_u, ref_max = jax_fft.irfft_pass_merge_velocity(*_jax_args(args))
    u, l1_max = cuda_fft.irfft_pass_merge_velocity(*_torch_args(args))
    assert l1_max.ndim == 0 and u.shape == (3, 64, n_out)
    _close(u, ref_u, TOL)
    _close(l1_max, ref_max, TOL)
    # the ring is the free stream exactly
    ring = u.view(3, 8, 8, n_out)[:, 0]
    assert torch.equal(ring, torch.tensor(args[4]).view(3, 1, 1).expand_as(ring))


def test_fused_pair_wrappers_refuse_bad_inputs():
    xr, xi, g, sz, syx = _torch_args(_curl_pass_inputs(64))
    with pytest.raises(ValueError, match="3"):
        cuda_fft.fft_greens_curl_ifft_pass(xr[:2], xi[:2], g, sz, syx)
    with pytest.raises(ValueError):
        cuda_fft.fft_greens_curl_ifft_pass(xr, xi, g, sz[:-1], syx)
    with pytest.raises(ValueError):
        cuda_fft.fft_greens_curl_ifft_pass(xr, xi, g, sz, syx[:1])
    with pytest.raises(TypeError):
        cuda_fft.fft_greens_curl_ifft_pass(xr.double(), xi, g, sz, syx)
    br, bi, sr, si, fsv, m, n_out, ny, nz = _torch_args(_merge_inputs(64, 32))
    with pytest.raises(ValueError, match="nz"):
        cuda_fft.irfft_pass_merge_velocity(br, bi, sr, si, fsv, m, n_out,
                                           ny, nz + 1)
    with pytest.raises(ValueError):
        cuda_fft.irfft_pass_merge_velocity(br, bi, sr, si, fsv, m, 33, ny, nz)
    with pytest.raises(ValueError):
        cuda_fft.irfft_pass_merge_velocity(br, bi, sr, si, fsv[:2], m, n_out,
                                           ny, nz)


def _force_split_routes(monkeypatch):
    monkeypatch.setattr(jax_poisson, "FORCE_PALLAS_CONVOLVE", True)
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)


def test_velocity_from_vorticity_fused_matches_jax(monkeypatch):
    """At (32, 32, 64) (anisotropic: the axis symbols must not mix up):
    the port's fused recovery (plain passes) against the JAX one (Pallas
    in interpret mode) and against ``curl_3d(vector_field_solve(w)) +
    U_inf``; ``l1_max`` against the maximum of the reference."""
    _force_split_routes(monkeypatch)
    grid = (32, 32, 64)
    jsolver = jax_poisson.UnboundedPoissonSolver3D(*grid, x_range=1.0)
    solver = poisson.UnboundedPoissonSolver3D(*grid, x_range=1.0,
                                              device="cpu")
    assert jsolver.fused_curl_supported(jnp.float32)
    assert solver.fused_curl_supported(torch.float32, "cpu")
    w = np.random.default_rng(12).standard_normal((3, *grid)).astype(
        np.float32)
    fsv = np.array([1.0, -0.5, 0.25], np.float32)
    ref_u, ref_max = jsolver.velocity_from_vorticity_fused(
        jnp.asarray(w), free_stream=jnp.asarray(fsv))
    u, l1_max = solver.velocity_from_vorticity_fused(
        torch.tensor(w), free_stream=torch.tensor(fsv))
    scale = max(1.0, float(np.abs(np.asarray(ref_u)).max()))
    _close(u, ref_u, TOL, scale)
    _close(l1_max, ref_max, TOL, scale)
    tw = torch.tensor(w)
    u_ref = curl_3d(solver.vector_field_solve(tw), 0.5 / solver.dx) \
        + torch.tensor(fsv).view(3, 1, 1, 1)
    _close(u, u_ref.numpy(), TOL, scale)
    _close(l1_max, u_ref.abs().sum(dim=0).max().numpy(), TOL, scale)
    # an explicit dense spectrum is split on the way in
    _close(solver.velocity_from_vorticity_fused(
        tw, solver._dense_greens(), torch.tensor(fsv))[0], ref_u, TOL, scale)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_velocity_from_vorticity_spectral_matches_jax(precision):
    """The dense ``torch.fft`` form of the fused recovery against the JAX
    package's, and against ``curl_3d(vector_field_solve(w))``."""
    grid = (12, 16, 20)
    jt, tt, nt = {"single": (jnp.float32, torch.float32, np.float32),
                  "double": (jnp.float64, torch.float64, np.float64)}[precision]
    tol = {"single": 1e-5, "double": 1e-10}[precision]
    jsolver = jax_poisson.UnboundedPoissonSolver3D(*grid, x_range=1.0,
                                                   real_t=jt)
    solver = poisson.UnboundedPoissonSolver3D(*grid, x_range=1.0,
                                              real_t=tt, device="cpu")
    w = np.random.default_rng(5).standard_normal((3, *grid)).astype(nt)
    ref = np.asarray(jsolver.velocity_from_vorticity_spectral(jnp.asarray(w)))
    out = solver.velocity_from_vorticity_spectral(torch.tensor(w))
    assert out.dtype == tt
    _close(out, ref, tol)
    _close(out, np.asarray(jax_curl_3d(
        jsolver.vector_field_solve(jnp.asarray(w)), 0.5 / jsolver.dx)), tol)


def test_fused_gate():
    """The port's gate is the kernel route below the 512^3-class
    threshold; the JAX gate's VMEM tile checks have no counterpart, so
    (50, 50, 50) (a lane batch of 5000, no 128-multiple tile) and
    (512, 32, 32) (m = 1024 along z) take the fused route here and not in
    the JAX package."""
    solver = lambda *g: poisson.UnboundedPoissonSolver3D(*g, device="cpu")
    assert not solver(16, 16, 16).fused_curl_supported(torch.float32, "cuda")
    s = poisson.UnboundedPoissonSolver3D.__new__(
        poisson.UnboundedPoissonSolver3D)
    for grid, port_ok in (((32, 32, 64), True), ((50, 50, 50), True),
                          ((512, 32, 32), True), ((512, 512, 512), False),
                          ((36, 36, 36), False)):
        s.grid_size_z, s.grid_size_y, s.grid_size_x = grid
        assert s.fused_curl_supported(torch.float32, "cuda") == port_ok, grid
        assert not s.fused_curl_supported(torch.float64, "cuda")
        assert not s.fused_curl_supported(torch.float32, "cpu")
    nz, ny, nx = 50, 50, 50
    assert not jax_fft.conv_curl_pass_tile_ok(2 * ny * nx, 2 * nz)
    assert not jax_fft.conv_curl_pass_tile_ok(2 * 32 * 32, 1024)


def _sim_state(grid, seed=7):
    return 0.1 * np.random.default_rng(seed).standard_normal(
        (3, *grid)).astype(np.float32)


def test_fast_tier_step_matches_jax(monkeypatch):
    """Two Navier-Stokes steps at 32^3 with ``fast_spectral=True`` on both
    packages (split routes forced on the CPU): the port's fused route
    engages (twice) and agrees with the JAX fast tier."""
    _force_split_routes(monkeypatch)
    grid = (32, 32, 32)
    common = dict(grid_size=grid, x_range=1.0, kinematic_viscosity=1e-3,
                  flow_type="navier_stokes_with_forcing",
                  with_free_stream_flow=True, fast_spectral=True)
    jsim = JaxSim(**common, real_t=jnp.float32, use_pallas=True)
    sim = UnboundedFlowSimulator3D(**common, device="cpu", use_kernels=True)
    assert jsim.unbounded_poisson_solver.fast_spectral
    assert sim.unbounded_poisson_solver.fast_spectral
    calls = []
    fused = poisson.UnboundedPoissonSolver3D.velocity_from_vorticity_fused
    monkeypatch.setattr(
        poisson.UnboundedPoissonSolver3D, "velocity_from_vorticity_fused",
        lambda self, *a, **k: calls.append(1) or fused(self, *a, **k))
    w = _sim_state(grid)
    jsim.primary_field = jnp.asarray(w)
    sim.primary_field = torch.tensor(w)
    for _ in range(2):
        jsim.time_step(1e-3, free_stream_velocity=(1.0, 0.5, 0.0))
        sim.time_step(1e-3, free_stream_velocity=(1.0, 0.5, 0.0))
    assert len(calls) == 2
    ref_w = np.asarray(jsim.primary_field)
    ref_u = np.asarray(jsim.velocity_field)
    _close(sim.primary_field, ref_w, 2e-4, max(1.0, np.abs(ref_w).max()))
    _close(sim.velocity_field, ref_u, 2e-4, max(1.0, np.abs(ref_u).max()))


@pytest.mark.parametrize("why", ["float64", "dense-route", "kernels-off"])
def test_fast_tier_falls_back_to_solve_and_curl(why, monkeypatch):
    """Where the fused route does not apply the step takes the solve +
    curl, as the JAX package routes: the same result as the exact tier."""
    grid = (32, 32, 32)
    dtype = torch.float64 if why == "float64" else torch.float32
    if why != "dense-route":
        monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    calls = []
    fused = poisson.UnboundedPoissonSolver3D.velocity_from_vorticity_fused
    monkeypatch.setattr(
        poisson.UnboundedPoissonSolver3D, "velocity_from_vorticity_fused",
        lambda self, *a, **k: calls.append(1) or fused(self, *a, **k))

    def run(fast):
        sim = UnboundedFlowSimulator3D(
            grid_size=grid, x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes", with_free_stream_flow=True,
            real_t=dtype, device="cpu",
            use_kernels=why != "kernels-off", fast_spectral=fast)
        sim.primary_field = torch.tensor(_sim_state(grid), dtype=dtype)
        sim.time_step(1e-3, free_stream_velocity=(1.0, 0.5, 0.0))
        return sim.velocity_field

    out, ref = run(True), run(False)
    assert not calls
    assert torch.equal(out, ref)


def test_enable_fast_spectral_is_construction_time(monkeypatch):
    monkeypatch.setattr(poisson, "DEFAULT_FAST_SPECTRAL", None)
    build = lambda **kw: poisson.UnboundedPoissonSolver3D(8, 8, 8,
                                                          device="cpu", **kw)
    assert build().fast_spectral is False  # unset: off on every device
    before = build()
    sopht_mpi_tpu_torch.enable_fast_spectral()
    after = build()
    assert after.fast_spectral is True and before.fast_spectral is False
    assert build(fast_spectral=False).fast_spectral is False  # explicit wins
    sim = UnboundedFlowSimulator3D((8, 8, 8), 1.0, 1e-3, device="cpu",
                                   flow_type="navier_stokes")
    assert sim.unbounded_poisson_solver.fast_spectral is True
    sopht_mpi_tpu_torch.enable_fast_spectral(False)
    assert build().fast_spectral is False and after.fast_spectral is True
    assert build(fast_spectral=True).fast_spectral is True
    sopht_mpi_tpu_torch.enable_fast_spectral(None)
    assert poisson.DEFAULT_FAST_SPECTRAL is None
    assert build().fast_spectral is False


def test_solver_needs_a_device():
    """``UnboundedPoissonSolver3D`` takes no default device."""
    with pytest.raises(TypeError):
        poisson.UnboundedPoissonSolver3D(8, 8, 8)
    with pytest.raises(TypeError):
        poisson.UnboundedPoissonSolver3D(8, 8, 8, 1.0, torch.float32, "cpu")
    assert poisson.UnboundedPoissonSolver3D(8, 8, 8, device="cpu").device \
        == torch.device("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128])
def test_fused_pair_kernels_match_plain_on_card(m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for fn, args in ((cuda_fft.fft_greens_curl_ifft_pass,
                      _curl_pass_inputs(m)),
                     (cuda_fft.irfft_pass_merge_velocity,
                      _merge_inputs(m, m // 2 - 3))):
        dev_args = _torch_args(args, "cuda")
        before = fn.launches
        out = fn(*dev_args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        ref = getattr(cuda_fft, fn.__name__ + "_ref")(*dev_args)
        _close(out, tuple(r.cpu().numpy() for r in ref), TOL)
