"""Reverse mode through the port's 21 kernel wrappers against the JAX
package's rules.

Each wrapper goes through a ``torch.autograd.Function`` when a gradient is
needed (``ops/_autograd.py``, the ``*Fn`` classes of
``parallel/cuda_fft.py``); on the CPU its forward is the plain version and
its backward the JAX package's rule, the code the card runs after its
kernel. For a seeded cotangent (``_tree_loss``'s pattern of
``tests/test_parallel/test_pallas_fft_grad.py``) every wrapper's gradients
w.r.t. every tensor input (0-d prefactors, ``add_vector``, ``fsv``,
``greens`` and the curl symbols included) are held

- against ``jax.vjp`` of the JAX package's Pallas entry (interpret mode),
  at the JAX tests' shapes: ``1e-5 max(1, |ref|)`` in float32, ``1e-12``
  in float64;
- against torch autograd through the port's plain version, the same
  tolerances.

Beside them: ``torch.autograd.gradcheck`` in float64 of the ten stencil
wrappers at 8^3; inputs that need no gradient get none (the Functions save
only what their rule reads); the launch counts do not move on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.ops.pallas_stencils_sharded as jss
from sopht_mpi_tpu.ops import pallas_stencils_3d as jst
from sopht_mpi_tpu.parallel import create_mesh as jax_create_mesh
from sopht_mpi_tpu.parallel import pallas_fft as jfft
from sopht_mpi_tpu.parallel import shard_vector_field as jax_shard
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as st
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sst
from sopht_mpi_tpu_torch.ops._autograd import PlainVJP
from sopht_mpi_tpu_torch.parallel import cuda_fft as fft
from sopht_mpi_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_vector_field,
    unshard_vector_field,
)

M = 64
H = M // 2
STENCIL_SHAPE = (3, 8, 8, 128)  # the JAX package's stencil gradient tests'
SHARDED_SHAPE = (3, 16, 32, 128)
SHARDED_MESH = (4, 2)
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _close(out, ref, dtype, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    tol = TOL[dtype] * max(1.0, float(np.abs(ref).max(initial=0.0)))
    err = float(np.abs(out - ref).max(initial=0.0))
    assert err <= tol, f"{what}: max|diff| {err} > {tol}"


def _cotangents(outs, seed):
    """One seeded standard normal cotangent per output."""
    return [np.random.default_rng(seed + i).standard_normal(np.shape(o))
            .astype(np.asarray(o).dtype) for i, o in enumerate(outs)]


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _port_vjp(fn, args, wrt, seed):
    """Gradients of ``sum(out_k ct_k)`` w.r.t. ``args[i]`` for i in
    ``wrt`` through ``fn`` (numpy in, numpy out), and the torch inputs."""
    targs = [torch.tensor(a, requires_grad=i in wrt)
             if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    outs = _as_tuple(fn(*targs))
    cts = _cotangents([o.detach().numpy() for o in outs], seed)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cts])
    return [targs[i].grad.numpy() for i in wrt], targs


def _jax_vjp(fn, args, wrt, seed):
    def f(*w):
        a = list(args)
        for i, x in zip(wrt, w):
            a[i] = x
        return fn(*a)

    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    out, vjp = jax.vjp(f, *(args[i] for i in wrt))
    leaves, tree = jax.tree_util.tree_flatten(out)
    cts = _cotangents([np.asarray(o) for o in leaves], seed)
    grads = vjp(jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(c) for c in cts]))
    return [np.asarray(g) for g in grads]


def _rng(seed):
    return np.random.default_rng(seed)


def _f(rng, *shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _curl_symbols(b_major, b_minor, m, dtype=np.float32):
    sym = lambda n: np.sin(2 * np.pi * np.arange(n) / n) / 0.02
    return (sym(m).astype(dtype),
            np.stack([np.repeat(sym(b_major), b_minor),
                      np.tile(sym(2 * b_minor)[:b_minor], b_major)])
            .astype(dtype))


# (name, port wrapper, JAX entry, its plain version in the port, args,
# differentiable argument indices); the JAX entries run their Pallas
# kernels in interpret mode on the CPU
def _fft_cases():
    r = _rng(0)
    sym_z, sym_yx = _curl_symbols(16, 8, M)
    rows = 64  # (nz, ny) = (8, 8): the JAX c2r epilogue's row tiling
    return [
        ("rfft_pass_padded_split", (_f(r, 16, 30), M), (0,)),
        ("fft_pass_padded", (_f(r, 2, H, 8), _f(r, 2, H, 8), M), (0, 1)),
        ("fft_greens_ifft_pass",
         (_f(r, 2, H, 8), _f(r, 2, H, 8), _f(r, 1, M, 8)), (0, 1, 2)),
        ("ifft_pass_truncated", (_f(r, 2, M, 8), _f(r, 2, M, 8)), (0, 1)),
        ("ifft_pass_truncated shared greens",
         (_f(r, 2, M, 8), _f(r, 2, M, 8), _f(r, 1, M, 8)), (0, 1, 2)),
        ("ifft_pass_truncated greens",
         (_f(r, 2, M, 8), _f(r, 2, M, 8), _f(r, 2, M, 8)), (0, 1, 2)),
        ("irfft_pass_merge",
         (_f(r, 16, H), _f(r, 16, H), _f(r, 16, 1), _f(r, 16, 1), M, 31),
         (0, 1, 2, 3)),
        ("fft_greens_curl_ifft_pass",
         (_f(r, 3, H, 128), _f(r, 3, H, 128), _f(r, 1, M, 128), sym_z,
          sym_yx), (0, 1, 2, 3, 4)),
        ("irfft_pass_merge_velocity",
         (_f(r, 3, rows, H), _f(r, 3, rows, H), _f(r, 3, rows, 1),
          _f(r, 3, rows, 1), np.array([1.0, -0.5, 0.25], np.float32), M, H,
          8, 8), (0, 1, 2, 3, 4)),
        ("rfft_pass_padded", (_f(r, 16, 30), M), (0,)),
        ("irfft_pass_truncated", (_f(r, 16, H + 1), _f(r, 16, H + 1), M, 31),
         (0, 1)),
        ("rfft_fft_pass_fused", (_f(r, 3, H, 32), 64, M), (0,)),
        ("ifft_irfft_pass_fused",
         (_f(r, 3, M, 32), _f(r, 3, M, 32), _f(r, 3, H, 1), _f(r, 3, H, 1),
          64, 32), (0, 1, 2, 3)),
    ]


FFT_CASES = _fft_cases()


def _fft_fns(name):
    base = name.split(" ")[0]
    return getattr(fft, base), getattr(fft, base + "_ref"), getattr(jfft, base)


@pytest.mark.parametrize("case", FFT_CASES, ids=[c[0] for c in FFT_CASES])
def test_fft_pass_vjp_matches_jax(case):
    name, args, wrt = case
    port_fn, ref_fn, jax_fn = _fft_fns(name)
    got, _ = _port_vjp(port_fn, args, wrt, seed=100)
    want = _jax_vjp(jax_fn, args, wrt, seed=100)
    plain, _ = _port_vjp(ref_fn, args, wrt, seed=100)
    for i, g, w, p in zip(wrt, got, want, plain):
        _close(g, w, np.float32, f"{name} d/d arg {i} against JAX")
        _close(g, p, np.float32, f"{name} d/d arg {i} against the plain "
               "version's autograd")


@pytest.mark.parametrize("case", FFT_CASES, ids=[c[0] for c in FFT_CASES])
def test_fft_pass_inputs_without_grad_get_none(case):
    """Only the first input needs a gradient: it matches, the others get
    no gradient, and the forward's values are the plain version's."""
    name, args, wrt = case
    port_fn, ref_fn, _ = _fft_fns(name)
    got, targs = _port_vjp(port_fn, args, wrt[:1], seed=7)
    full, _ = _port_vjp(ref_fn, args, wrt, seed=7)
    _close(got[0], full[0], np.float32, name)
    assert all(t.grad is None for t in targs[1:] if torch.is_tensor(t))


def test_analytic_fft_functions_save_only_what_their_rule_reads():
    r = _rng(3)
    xr, xi = (torch.tensor(_f(r, 2, H, 8), requires_grad=True)
              for _ in range(2))
    g = torch.tensor(_f(r, 1, M, 8))
    out = fft.fft_pass_padded(xr, xi, M)
    assert type(out[0].grad_fn).__name__ == "FftPassPaddedFnBackward"
    assert out[0].grad_fn.saved_tensors == ()
    # the Green's multiplier needs no gradient: the input is not saved
    out = fft.fft_greens_ifft_pass(xr, xi, g)
    saved = out[0].grad_fn.saved_tensors
    assert saved[0] is None and saved[1] is None and saved[2] is g
    br, bi, sr, si = (torch.tensor(_f(r, 4, n), requires_grad=True)
                      for n in (H, H, 1, 1))
    out = fft.irfft_pass_merge(br, bi, sr, si, M, 30)
    assert out.grad_fn.saved_tensors == ()
    # no gradient needed: no Function at all
    with torch.no_grad():
        assert fft.fft_pass_padded(xr, xi, M)[0].grad_fn is None


def _stencil_cases(dtype):
    r = _rng(6 if dtype == np.float32 else 16)
    w, u = _f(r, *STENCIL_SHAPE, dtype=dtype), _f(r, *STENCIL_SHAPE,
                                                  dtype=dtype)
    p, q = np.asarray(0.3, dtype), np.asarray(0.1, dtype)
    fsv = np.array([1.0, 0.5, -0.2], dtype)
    return [
        ("rotational_curl_add_3d", (w, u, p), (0, 1, 2),
         lambda a, b, c: jst.rotational_curl_add_3d_pallas(
             a, b, c, interpret=True)),
        ("diffusion_penalise_vector_3d", (w, q, 2), (0, 1),
         lambda a, b, k: jst.diffusion_penalise_vector_3d_pallas(
             a, b, k, interpret=True)),
        ("curl_3d", (w, p), (0, 1),
         lambda a, b: jst.curl_3d_pallas(a, b, interpret=True)),
        ("curl_3d add l1", (w, p, fsv, True), (0, 1, 2),
         lambda a, b, c, _: jst.curl_3d_pallas(
             a, b, add_vector=c, interpret=True, compute_l1_max=True)),
        ("diffusion_timestep_vector_3d", (w, q), (0, 1),
         lambda a, b: jst.diffusion_timestep_vector_3d_pallas(
             a, b, interpret=True)),
        ("laplacian_filter_vector_3d multiplicative", (w, 2, "multiplicative"),
         (0,), lambda a, k, t: jst.laplacian_filter_vector_3d_pallas(
             a, k, t, interpret=True)),
        ("laplacian_filter_vector_3d convolution", (w, 3, "convolution"),
         (0,), lambda a, k, t: jst.laplacian_filter_vector_3d_pallas(
             a, k, t, interpret=True)),
        ("penalise_field_boundary_vector_3d", (w, 2), (0,),
         lambda a, k: jst.penalise_field_boundary_vector_3d_pallas(
             a, k, interpret=True)),
    ]


STENCIL_CASES = [(dtype, c) for dtype in (np.float32, np.float64)
                 for c in _stencil_cases(dtype)]


@pytest.mark.parametrize(
    "dtype,case", STENCIL_CASES,
    ids=[f"{c[0]}-{np.dtype(d).name}" for d, c in STENCIL_CASES])
def test_stencil_vjp_matches_jax(dtype, case):
    name, args, wrt, jax_fn = case
    base = name.split(" ")[0]
    port_fn, ref_fn = getattr(st, base), getattr(st, base + "_ref")
    got, _ = _port_vjp(port_fn, args, wrt, seed=100)
    want = _jax_vjp(jax.jit(jax_fn, static_argnums=tuple(
        i for i, a in enumerate(args) if not isinstance(a, np.ndarray))),
        args, wrt, seed=100)
    plain, _ = _port_vjp(ref_fn, args, wrt, seed=100)
    for i, g, w, p in zip(wrt, got, want, plain):
        _close(g, w, dtype, f"{name} d/d arg {i} against JAX")
        _close(g, p, dtype, f"{name} d/d arg {i} against the plain "
               "version's autograd")


def _std(fn, fields, rest, mesh):
    """(fields, prefactor[, width], mesh)"""
    return fn(*fields, *rest, mesh)


def _curl(fn, fields, rest, mesh):
    """(field, prefactor, mesh, add_vector, compute_l1_max)"""
    return fn(*fields, rest[0], mesh, add_vector=rest[1], compute_l1_max=True)


def _sharded_cases(dtype):
    r = _rng(5)
    w, u = _f(r, *SHARDED_SHAPE, dtype=dtype), _f(r, *SHARDED_SHAPE,
                                                  dtype=dtype)
    p = np.asarray(0.37, dtype)
    fsv = np.array([1.0, -0.5, 0.25], dtype)
    return [
        ("diffusion_timestep_vector_3d_sharded", (w, p), (0, 1), 1, _std),
        ("curl_3d_sharded", (w, p, fsv), (0, 1, 2), 1, _curl),
        ("rotational_curl_add_3d_sharded", (w, u, p), (0, 1, 2), 2, _std),
        ("diffusion_penalise_vector_3d_sharded", (w, p, 2), (0, 1), 1, _std),
    ]


SHARDED_CASES = [(dtype, c) for dtype in (np.float32, np.float64)
                 for c in _sharded_cases(dtype)]


def _sharded_call(fn, n_fields, mesh, call, jax_side=False):
    """``fn`` on fields given as global arrays: sharded over ``mesh``, the
    result assembled (JAX's sharded arrays are global already)."""

    def run(*args):
        if jax_side:
            fields = [jax_shard(f, mesh) for f in args[:n_fields]]
            return call(fn, fields, args[n_fields:], mesh)
        fields = [shard_vector_field(f, mesh) for f in args[:n_fields]]
        out = call(fn, fields, args[n_fields:], mesh)
        if isinstance(out, tuple):
            return unshard_vector_field(out[0], mesh), out[1]
        return unshard_vector_field(out, mesh)

    return run


@pytest.mark.parametrize(
    "dtype,case", SHARDED_CASES,
    ids=[f"{c[0]}-{np.dtype(d).name}" for d, c in SHARDED_CASES])
def test_sharded_stencil_vjp_matches_jax(dtype, case):
    """On a (4, 2) mesh: the port's gradient w.r.t. its sharded layout,
    assembled, against JAX's w.r.t. its sharded global array (under
    ``jax.jit``: an eager ``shard_map`` lowers every primitive alone)."""
    name, args, wrt, n_fields, call = case
    mesh = create_mesh(3, SHARDED_MESH, device="cpu")
    jmesh = jax_create_mesh(3, SHARDED_MESH)
    port_fn, ref_fn = getattr(sst, name), getattr(sst, name + "_ref")
    got, _ = _port_vjp(_sharded_call(port_fn, n_fields, mesh, call), args,
                       wrt, seed=100)
    statics = tuple(i for i, a in enumerate(args)
                    if not isinstance(a, np.ndarray))
    want = _jax_vjp(
        jax.jit(_sharded_call(getattr(jss, name), n_fields, jmesh, call,
                              jax_side=True), static_argnums=statics),
        args, wrt, seed=100)
    plain, _ = _port_vjp(_sharded_call(ref_fn, n_fields, mesh, call), args,
                         wrt, seed=100)
    for i, g, w, p in zip(wrt, got, want, plain):
        _close(g, w, dtype, f"{name} d/d arg {i} against JAX")
        _close(g, p, dtype, f"{name} d/d arg {i} against the plain "
               "version's autograd")


# gradcheck (float64, 8^3, the VJPs against finite differences)
GRID8 = (3, 8, 8, 8)


def _gradcheck_cases():
    mesh = create_mesh(3, (2, 2), device="cpu")

    def sharded(fn, n_fields=1):
        return lambda *a: unshard_vector_field(fn(
            *(shard_vector_field(f, mesh) for f in a[:n_fields]),
            *a[n_fields:], mesh), mesh)

    return {
        "rotational_curl_add_3d": (st.rotational_curl_add_3d, 2, ()),
        "diffusion_penalise_vector_3d": (
            lambda f, p: st.diffusion_penalise_vector_3d(f, p, 1), 1, ()),
        "curl_3d": (lambda f, p, a: st.curl_3d(f, p, a, True), 1, ("add",)),
        "diffusion_timestep_vector_3d": (st.diffusion_timestep_vector_3d, 1,
                                         ()),
        "laplacian_filter_vector_3d": (
            lambda f: st.laplacian_filter_vector_3d(f, 2, "convolution"), 1,
            ("no prefactor",)),
        "penalise_field_boundary_vector_3d": (
            lambda f: st.penalise_field_boundary_vector_3d(f, 2), 1,
            ("no prefactor",)),
        "diffusion_timestep_vector_3d_sharded": (
            sharded(sst.diffusion_timestep_vector_3d_sharded), 1, ()),
        "curl_3d_sharded": (
            lambda f, p, a: (lambda o: (unshard_vector_field(o[0], mesh),
                                        o[1]))(sst.curl_3d_sharded(
                shard_vector_field(f, mesh), p, mesh, a,
                compute_l1_max=True)), 1, ("add",)),
        "rotational_curl_add_3d_sharded": (
            sharded(sst.rotational_curl_add_3d_sharded, 2), 2, ()),
        "diffusion_penalise_vector_3d_sharded": (
            lambda f, p: unshard_vector_field(
                sst.diffusion_penalise_vector_3d_sharded(
                    shard_vector_field(f, mesh), p, 1, mesh), mesh), 1, ()),
    }


GRADCHECK = _gradcheck_cases()


@pytest.mark.parametrize("name", list(GRADCHECK))
def test_stencil_gradcheck_float64(name):
    fn, n_fields, flags = GRADCHECK[name]
    gen = torch.Generator().manual_seed(11)
    args = [torch.randn(GRID8, dtype=torch.float64, generator=gen,
                        requires_grad=True) for _ in range(n_fields)]
    if "no prefactor" not in flags:
        args.append(torch.tensor(0.2, dtype=torch.float64,
                                 requires_grad=True))
    if "add" in flags:
        args.append(torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64,
                                 requires_grad=True))
    assert torch.autograd.gradcheck(fn, args, fast_mode=True)


def test_prefactor_gradients_reach_the_cfl_dt():
    """A 0-d dt that enters the prefactors of the transport, diffusion and
    curl wrappers receives the gradient the plain ops give it."""
    gen = torch.Generator().manual_seed(2)
    w0, u0 = (torch.randn(GRID8, dtype=torch.float64, generator=gen)
              for _ in range(2))

    def step(ops, dt):
        w = ops.rotational_curl_add_3d(w0, u0, dt / 0.2)
        w = ops.diffusion_penalise_vector_3d(w, 1e-3 * dt / 0.01, 1)
        u, l1 = ops.curl_3d(w, 0.5 / 0.1 * dt, torch.ones(3, dtype=w.dtype),
                            True)
        return (u ** 2).sum() + l1

    grads = []
    for ops in (st, _PlainOps):
        dt = torch.tensor(0.01, dtype=torch.float64, requires_grad=True)
        grads.append(torch.autograd.grad(step(ops, dt), dt)[0])
    assert float(grads[0]) != 0.0
    _close(grads[0].numpy(), grads[1].numpy(), np.float64, "d/d dt")


class _PlainOps:
    rotational_curl_add_3d = staticmethod(st.rotational_curl_add_3d_ref)
    diffusion_penalise_vector_3d = staticmethod(
        st.diffusion_penalise_vector_3d_ref)
    curl_3d = staticmethod(st.curl_3d_ref)


def test_wrappers_record_a_function_only_when_a_gradient_is_needed():
    gen = torch.Generator().manual_seed(4)
    f = torch.randn(GRID8, dtype=torch.float64, generator=gen)
    assert st.curl_3d(f, 0.5).grad_fn is None
    g = f.clone().requires_grad_()
    assert isinstance(st.curl_3d(g, 0.5).grad_fn,
                      PlainVJP._backward_cls)
    with torch.no_grad():
        assert st.curl_3d(g, 0.5).grad_fn is None
    # a prefactor that needs a gradient is enough
    p = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    out = st.diffusion_timestep_vector_3d(f, p)
    (gp,) = torch.autograd.grad(out.sum(), p)
    (gq,) = torch.autograd.grad(
        st.diffusion_timestep_vector_3d_ref(f, p).sum(), p)
    assert float(gp) == pytest.approx(float(gq), rel=1e-12)


def test_backward_launches_nothing_on_the_cpu():
    before = [fn.launches for fn in st.KERNELS + fft.KERNELS + sst.KERNELS]
    gen = torch.Generator().manual_seed(9)
    f = torch.randn(GRID8, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    st.laplacian_filter_vector_3d(st.curl_3d(f, 0.5), 1,
                                  "multiplicative").sum().backward()
    x = torch.randn(4, 30, generator=gen, requires_grad=True)
    fft.irfft_pass_merge(*fft.rfft_pass_padded_split(x, M), M,
                         30).sum().backward()
    assert f.grad is not None and x.grad is not None
    assert before == [fn.launches for fn in
                      st.KERNELS + fft.KERNELS + sst.KERNELS]
