"""The rod surface grid's fixed-order marker-to-element sums against the
``index_add_`` they replace, on the CPU.

``body_loads`` sums each element's markers along a row of a table built
on the host; ``index_add_`` on a CUDA tensor adds with atomics in no fixed
order, and made two unbroken runs of the freely rotating rod part on the
card. Here, on uniform rods and on tapered rods whose rings hold different
numbers of markers (so the rows are padded), with random states and
forcing: the forces and
torques against the ``index_add_`` form over the element index, float64
to 1e-12 of the largest value, and the same bits on every call.
"""

import numpy as np
import pytest
import torch

from sopht_mpi_tpu_torch.models import CosseratRod, CosseratRodSurfaceForcingGrid

TOL = 1e-12


def _close(out, ref):
    scale = max(1.0, float(ref.abs().max()))
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= TOL * scale


@pytest.mark.parametrize("n_elem, taper, density", [
    (9, 0.3, 12), (9, 1.0, 12), (1, 1.0, 5), (20, 0.1, 16)])
def test_body_loads_match_index_add_form(n_elem, taper, density):
    rod = CosseratRod.straight_rod(
        n_elem, np.array([0.3, 0.2, 0.4]), np.array([0.0, 0.6, 0.8]),
        np.array([1.0, 0.0, 0.0]), base_length=0.6, base_radius=0.05,
        density=1e3, youngs_modulus=1e6, shear_modulus=1e6 / 1.5,
        device="cpu")
    radius = rod.params.radius * torch.linspace(1.0, taper, n_elem,
                                                dtype=torch.float64)
    rod.params = rod.params._replace(radius=radius)
    grid = CosseratRodSurfaceForcingGrid(rod, density)
    counts = torch.bincount(grid._elem_idx)
    # rings of different sizes where the rod tapers
    assert (len(set(counts.tolist())) > 1) == (taper < 0.5)
    rng = np.random.default_rng(n_elem)
    state = rod.state._replace(
        omega=torch.tensor(rng.standard_normal(rod.state.omega.shape)),
        velocity=torch.tensor(rng.standard_normal(rod.state.velocity.shape)))
    lag_force = torch.tensor(rng.standard_normal((3, grid.num_lag_nodes)))
    forces, torques = grid.body_loads(state, lag_force)

    # the same loads with the element sums as index_add_ over _elem_idx
    n = state.omega.shape[1]
    body_force = -lag_force
    elem_force = body_force.new_zeros((3, n)).index_add_(
        1, grid._elem_idx, body_force)
    half = 0.5 * elem_force
    ref_forces = (torch.nn.functional.pad(half, (0, 1))
                  + torch.nn.functional.pad(half, (1, 0)))
    torque_lab = torch.linalg.cross(grid._moment_arms(state), body_force,
                                    dim=0)
    elem_torque = body_force.new_zeros((3, n)).index_add_(
        1, grid._elem_idx, torque_lab)
    ref_torques = torch.einsum("ijn,jn->in", state.director, elem_torque)
    _close(forces, ref_forces)
    _close(torques, ref_torques)
    again = grid.body_loads(state, lag_force)
    assert torch.equal(forces, again[0]) and torch.equal(torques, again[1])
