"""The port's plain stencil versions against the JAX package: each kernel's
plain version (``ops/cuda_stencils_3d.py *_ref``, what the wrappers run on
CPU tensors) against its Pallas kernel in interpret mode, and each plain op
of ``ops/stencils_3d.py`` against its jnp twin. Inputs are numpy, seeded.

Tolerances: float64 ``atol=1e-12``; float32 ``1e-5 max(1, |ref|max)`` (a
few ulps of float32 rounding in differently ordered sums).

The kernels themselves need a CUDA device (``cuda`` marker, skipped here);
``chip_smoke.py`` holds each against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.ops import elementwise as jax_elementwise
from sopht_mpi_tpu.ops import stencils_3d as jax_stencils
from sopht_mpi_tpu.ops.pallas_stencils_3d import (
    curl_3d_pallas,
    diffusion_penalise_vector_3d_pallas,
    diffusion_timestep_vector_3d_pallas,
    laplacian_filter_vector_3d_pallas,
    penalise_field_boundary_vector_3d_pallas,
    rotational_curl_add_3d_pallas,
)
from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as kernels
from sopht_mpi_tpu_torch.ops import elementwise, stencils_3d

SHAPES = [(3, 16, 16, 16), (3, 12, 16, 20)]
# the filtered-transport kernels' shapes: odd and thin axes
TRANSPORT_SHAPES = [(3, 17, 33, 65), (3, 16, 8, 24)]
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
FILTER_TYPES = ["multiplicative", "convolution"]


def _fields(shape, np_dtype, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np_dtype) for _ in range(n)]


def _t(a, torch_dtype):
    return torch.tensor(a, dtype=torch_dtype)


def _check(out, ref):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if ref.dtype == np.float64:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    else:
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * scale)


def _grids(shapes, ids):
    """Parametrize over ``shapes`` then the dtypes (outermost decorator)."""

    def mark(fn):
        fn = pytest.mark.parametrize("shape", shapes, ids=ids)(fn)
        return pytest.mark.parametrize("dtype", list(DTYPES))(fn)

    return mark


on_sphere_grids = _grids(SHAPES, ["16^3", "12x16x20"])
on_transport_grids = _grids(TRANSPORT_SHAPES, ["17x33x65", "16x8x24"])


@on_sphere_grids
def test_rotational_curl_add_matches_pallas(shape, dtype):
    np_t, t_t = DTYPES[dtype]
    w, u = _fields(shape, np_t)
    p = np_t(0.05)
    ref = rotational_curl_add_3d_pallas(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(p), interpret=True
    )
    _check(kernels.rotational_curl_add_3d(_t(w, t_t), _t(u, t_t), float(p)), ref)


@on_sphere_grids
@pytest.mark.parametrize("width", [1, 2, 3])
def test_diffusion_penalise_matches_pallas(shape, dtype, width):
    np_t, t_t = DTYPES[dtype]
    (f,) = _fields(shape, np_t, n=1, seed=width)
    p = np_t(0.11)
    ref = diffusion_penalise_vector_3d_pallas(
        jnp.asarray(f), jnp.asarray(p), width, interpret=True
    )
    _check(
        kernels.diffusion_penalise_vector_3d(_t(f, t_t), _t(p, t_t), width), ref
    )


@on_sphere_grids
@pytest.mark.parametrize("add", [False, True], ids=["no-add", "add"])
@pytest.mark.parametrize("l1", [False, True], ids=["no-l1", "l1"])
def test_curl_matches_pallas(shape, dtype, add, l1):
    np_t, t_t = DTYPES[dtype]
    (psi,) = _fields(shape, np_t, n=1, seed=7)
    p = np_t(8.0)
    vec = np.asarray([1.0, -0.5, 0.25], np_t) if add else None
    ref = curl_3d_pallas(
        jnp.asarray(psi), jnp.asarray(p),
        add_vector=None if vec is None else jnp.asarray(vec),
        interpret=True, compute_l1_max=l1,
    )
    out = kernels.curl_3d(
        _t(psi, t_t), float(p),
        add_vector=None if vec is None else _t(vec, t_t), compute_l1_max=l1,
    )
    if l1:
        (out, out_l1), (ref, ref_l1) = out, ref
        assert out_l1.ndim == 0
        _check(out_l1, ref_l1)
    _check(out, ref)


@on_sphere_grids
def test_plain_ops_match_jnp(shape, dtype):
    np_t, t_t = DTYPES[dtype]
    a, b = _fields(shape, np_t, seed=3)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a, t_t), _t(b, t_t)
    _check(elementwise.cross_product_3d(ta, tb),
           jax_elementwise.cross_product_3d(ja, jb))
    fsv = np.asarray([1.0, -2.0, 0.5], np_t)
    _check(elementwise.add_fixed_val(ta, _t(fsv, t_t)),
           jax_elementwise.add_fixed_val(ja, jnp.asarray(fsv)))
    _check(stencils_3d.curl_3d(ta, 0.7), jax_stencils.curl_3d(ja, np_t(0.7)))
    _check(stencils_3d.diffusion_timestep_vector_3d(ta, 0.1),
           jax_stencils.diffusion_timestep_vector_3d(ja, np_t(0.1)))
    _check(stencils_3d.update_vorticity_from_velocity_forcing_3d(ta, tb, 0.3),
           jax_stencils.update_vorticity_from_velocity_forcing_3d(
               ja, jb, np_t(0.3)))
    for width in (0, 1, 2, 3):
        _check(stencils_3d.penalise_field_boundary_vector_3d(ta, width),
               jax_stencils.penalise_field_boundary_vector_3d(ja, width))
        _check(stencils_3d.penalise_field_boundary_3d(ta[0], width),
               jax_stencils.penalise_field_boundary_3d(ja[0], width))
    for kind in ("multiplicative", "convolution"):
        _check(stencils_3d.laplacian_filter_vector_3d(ta, 2, kind),
               jax_stencils.laplacian_filter_vector_3d(ja, 2, kind))


@on_sphere_grids
def test_wrapper_contract(shape, dtype):
    """Shape/dtype/size checks raise; a CPU tensor takes the plain version
    and adds nothing to the launch counts."""
    np_t, t_t = DTYPES[dtype]
    (f,) = _fields(shape, np_t, n=1)
    tf = _t(f, t_t)
    counts = [fn.launches for fn in kernels.KERNELS]
    kernels.curl_3d(tf, 1.0)
    kernels.rotational_curl_add_3d(tf, tf, 1.0)
    kernels.diffusion_penalise_vector_3d(tf, 1.0, 2)
    assert [fn.launches for fn in kernels.KERNELS] == counts
    with pytest.raises(ValueError):
        kernels.curl_3d(tf[:2], 1.0)
    with pytest.raises(TypeError):
        kernels.curl_3d(tf.to(torch.float16), 1.0)
    with pytest.raises(ValueError):
        kernels.rotational_curl_add_3d(tf, tf[:, 1:], 1.0)
    with pytest.raises(ValueError):
        kernels.diffusion_penalise_vector_3d(tf, 1.0, min(shape[1:]) // 2)
    with pytest.raises(ValueError):
        kernels.diffusion_penalise_vector_3d(tf, 1.0, 0)


@on_sphere_grids
@pytest.mark.cuda
def test_kernels_match_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    np_t, t_t = DTYPES[dtype]
    w, u = (_t(a, t_t).cuda() for a in _fields(shape, np_t))
    p = torch.tensor(0.05, dtype=t_t, device="cuda")
    add = torch.tensor([1.0, -0.5, 0.25], dtype=t_t, device="cuda")
    pairs = [
        (kernels.rotational_curl_add_3d(w, u, p),
         kernels.rotational_curl_add_3d_ref(w, u, p)),
        (kernels.diffusion_penalise_vector_3d(w, p, 2),
         kernels.diffusion_penalise_vector_3d_ref(w, p, 2)),
        (kernels.curl_3d(w, p, add), kernels.curl_3d_ref(w, p, add)),
        (kernels.curl_3d(w, p, add, True)[1],
         kernels.curl_3d_ref(w, p, add, True)[1]),
    ]
    torch.cuda.synchronize()
    for out, ref in pairs:
        _check(out.cpu(), ref.cpu().numpy())


# -- the filtered transport: diffusion, Laplacian filter, wall sponge -------


@on_transport_grids
def test_diffusion_matches_pallas(shape, dtype):
    np_t, t_t = DTYPES[dtype]
    (f,) = _fields(shape, np_t, n=1, seed=11)
    p = np_t(0.13)
    ref = diffusion_timestep_vector_3d_pallas(
        jnp.asarray(f), jnp.asarray(p), interpret=True
    )
    _check(kernels.diffusion_timestep_vector_3d(_t(f, t_t), _t(p, t_t)), ref)


@on_transport_grids
@pytest.mark.parametrize("filter_type", FILTER_TYPES)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_laplacian_filter_matches_pallas(shape, dtype, filter_type, order):
    np_t, t_t = DTYPES[dtype]
    (f,) = _fields(shape, np_t, n=1, seed=order)
    ref = laplacian_filter_vector_3d_pallas(
        jnp.asarray(f), order, filter_type, interpret=True
    )
    _check(kernels.laplacian_filter_vector_3d(_t(f, t_t), order, filter_type),
           ref)


@on_transport_grids
@pytest.mark.parametrize("width", [1, 2, 3])
def test_penalise_matches_pallas(shape, dtype, width):
    np_t, t_t = DTYPES[dtype]
    (f,) = _fields(shape, np_t, n=1, seed=20 + width)
    assert kernels.penalise_supported(shape, width)
    ref = penalise_field_boundary_vector_3d_pallas(
        jnp.asarray(f), width, interpret=True
    )
    _check(kernels.penalise_field_boundary_vector_3d(_t(f, t_t), width), ref)


@pytest.mark.parametrize(
    "shape,width",
    [((3, 16, 8, 24), 0), ((3, 4, 8, 24), 2), ((3, 16, 6, 24), 3),
     ((3, 9, 8, 4), 2)],
    ids=["w0", "nz=2w", "ny=2w", "nx=2w"],
)
def test_penalise_jnp_path_shapes(shape, width):
    """Where the JAX function takes its jnp path (no sponge, or an axis of
    2 width cells; fewer fail in the JAX package) the wrapper runs the
    plain version on any device, and the two agree."""
    (f,) = _fields(shape, np.float64, n=1, seed=5)
    assert not kernels.penalise_supported(shape, width)
    ref = penalise_field_boundary_vector_3d_pallas(
        jnp.asarray(f), width, interpret=True
    )
    before = kernels.penalise_field_boundary_vector_3d.launches
    _check(kernels.penalise_field_boundary_vector_3d(_t(f, torch.float64),
                                                     width), ref)
    assert kernels.penalise_field_boundary_vector_3d.launches == before


def test_transport_wrapper_contract():
    """The three wrappers take the plain versions on CPU tensors, count no
    launch there, and reject what the kernels do not take."""
    (f,) = _fields((3, 8, 8, 8), np.float32, n=1)
    tf = _t(f, torch.float32)
    counts = [fn.launches for fn in kernels.KERNELS]
    kernels.diffusion_timestep_vector_3d(tf, 0.1)
    for filter_type in FILTER_TYPES:
        kernels.laplacian_filter_vector_3d(tf, 2, filter_type)
    kernels.penalise_field_boundary_vector_3d(tf, 2)
    assert [fn.launches for fn in kernels.KERNELS] == counts
    assert kernels.laplacian_filter_vector_3d(tf, 0, "multiplicative") is tf
    with pytest.raises(ValueError, match="filter type"):
        kernels.laplacian_filter_vector_3d(tf, 1, "gaussian")
    with pytest.raises(ValueError, match="filter order"):
        kernels.laplacian_filter_vector_3d(tf, -1, "multiplicative")
    with pytest.raises(ValueError):
        kernels.diffusion_timestep_vector_3d(tf[0], 0.1)
    with pytest.raises(TypeError):
        kernels.penalise_field_boundary_vector_3d(tf.to(torch.float16), 2)


@pytest.mark.cuda
@on_transport_grids
def test_transport_kernels_match_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    np_t, t_t = DTYPES[dtype]
    (f,) = (_t(a, t_t).cuda() for a in _fields(shape, np_t, n=1))
    p = torch.tensor(0.13, dtype=t_t, device="cuda")
    pairs = [(kernels.diffusion_timestep_vector_3d(f, p),
              kernels.diffusion_timestep_vector_3d_ref(f, p))]
    for filter_type in FILTER_TYPES:
        for order in (1, 2, 3):
            pairs.append((
                kernels.laplacian_filter_vector_3d(f, order, filter_type),
                kernels.laplacian_filter_vector_3d_ref(f, order, filter_type)))
    for width in (1, 2, 3):
        pairs.append((kernels.penalise_field_boundary_vector_3d(f, width),
                      kernels.penalise_field_boundary_vector_3d_ref(f, width)))
    torch.cuda.synchronize()
    for out, ref in pairs:
        _check(out.cpu(), ref.cpu().numpy())
