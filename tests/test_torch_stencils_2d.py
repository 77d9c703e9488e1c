"""The port's 2D stencil ops (``ops/stencils_2d.py``, ``_stencil_utils``'s
ENO3 helpers) against the JAX package's on the same numpy-seeded fields.

Tolerance: ``2e-6 max(1, |ref|)`` in float32 and ``1e-12`` in float64 -
the same shifted-slice arithmetic in both, differing by the order in which
XLA and PyTorch fuse and round a few sums. The ENO3 stencil choice is a
comparison of differences, so a rounding flip picks another (equally valid)
3rd-order stencil; the seeded fields here have no such tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.ops import _stencil_utils as jax_utils
from sopht_mpi_tpu.ops import stencils_2d as jax_ops
from sopht_mpi_tpu_torch.ops import _stencil_utils as utils
from sopht_mpi_tpu_torch.ops import stencils_2d as ops

GRID = (24, 40)
DTYPES = {"single": (np.float32, 2e-6), "double": (np.float64, 1e-12)}


def _fields(precision, seed=0):
    dtype, tol = DTYPES[precision]
    rng = np.random.default_rng(seed)
    scalar = rng.standard_normal(GRID).astype(dtype)
    vector = rng.standard_normal((2, *GRID)).astype(dtype)
    return scalar, vector, tol


def _close(out, ref, tol):
    out = out.numpy()
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = np.abs(out.astype(np.float64) - ref)
    assert (err <= tol * np.maximum(1.0, np.abs(ref))).all(), err.max()


CASES = {
    "diffusion_flux_2d": lambda m, f, v: m.diffusion_flux_2d(f, 0.1),
    "diffusion_timestep_2d": lambda m, f, v: m.diffusion_timestep_2d(f, 0.2),
    "advection_flux_conservative_eno3_2d":
        lambda m, f, v: m.advection_flux_conservative_eno3_2d(f, v, -0.3),
    "advection_timestep_eno3_2d":
        lambda m, f, v: m.advection_timestep_eno3_2d(f, v, 0.05),
    "outplane_field_curl_2d": lambda m, f, v: m.outplane_field_curl_2d(f, 8.0),
    "update_vorticity_from_velocity_forcing_2d":
        lambda m, f, v: m.update_vorticity_from_velocity_forcing_2d(f, v, 0.4),
    "penalise_field_boundary_2d_w2":
        lambda m, f, v: m.penalise_field_boundary_2d(f, 2),
    "penalise_field_boundary_2d_w1":
        lambda m, f, v: m.penalise_field_boundary_2d(f, 1),
    "penalise_field_boundary_2d_w0":
        lambda m, f, v: m.penalise_field_boundary_2d(f, 0),
    "brinkmann_penalise_2d":
        lambda m, f, v: m.brinkmann_penalise_2d(v, 1e3, abs(f) / 4, 0.5 * v),
    "char_func_from_level_set_via_sine_heaviside_2d":
        lambda m, f, v: m.char_func_from_level_set_via_sine_heaviside_2d(
            f, 0.7),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stencil_matches_jax(name, precision):
    scalar, vector, tol = _fields(precision)
    ref = CASES[name](jax_ops, jnp.asarray(scalar), jnp.asarray(vector))
    out = CASES[name](ops, torch.tensor(scalar), torch.tensor(vector))
    _close(out, ref, tol)


@pytest.mark.parametrize("axis", [0, 1])
def test_eno3_divergence_matches_jax(axis, precision):
    scalar, vector, tol = _fields(precision, seed=3)
    ref = jax_utils.eno3_divergence_interior(
        jnp.asarray(scalar), jnp.asarray(vector[axis]), axis)
    out = utils.eno3_divergence_interior(
        torch.tensor(scalar), torch.tensor(vector[axis]), axis)
    _close(out, ref, 4 * tol)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pad_axis_matches_jax(axis):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref = jax_utils.pad_axis(jnp.asarray(x), 2, 1, axis % 2)
    out = utils.pad_axis(torch.tensor(x), 2, 1, axis)
    _close(out, ref, 0.0)


def test_eno3_face_value_is_exact_on_quadratics():
    """Every candidate stencil reconstructs a quadratic's face value
    exactly, whichever the selector picks."""
    i = torch.arange(-2.0, 3.0, dtype=torch.float64)
    # cell averages of q(x) = x^2 over unit cells centred on i
    g = i**2 + 1.0 / 12.0
    face = utils._eno3_left_biased(*g)
    assert abs(float(face) - 0.25) < 1e-14
