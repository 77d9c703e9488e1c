"""Cosserat rod model: functional core and a PyElastica-style wrapper
(counterpart of ``sopht_mpi_tpu/models/elastica/rod.py``).

The discrete Cosserat rod equations of Gazzola, Dudte, McCormick &
Mahadevan (2018, R. Soc. Open Sci. 5:171628) as pure functions on
NamedTuples of tensors.

Discretization (n elements, n+1 nodes, n-1 interior/voronoi regions):
- nodes: position r (3, n+1), velocity v (3, n+1), mass m (n+1,)
- elements: director Q (3, 3, n) (rows = material axes in lab frame),
  material-frame angular velocity w (3, n), rest length l0 (n,),
  shear/stretch stiffness S = diag(a G A, a G A, E A), inertia J
- voronoi: rest length D0 (n-1,), bending/twist stiffness
  B = diag(E I1, E I2, G I3)

Governing discrete equations (paper eqs. 5a/5b):
    m dv/dt = dh( Q^T S sigma / e ) + F_ext
    (J/e) dw/dt = dh( B kappa / eps^3 ) + Ah( kappa x B kappa D0 / eps^3 )
                  + ( Q t x S sigma ) l0 + ( J w / e ) x w
                  + J w (de/dt) / e^2 + C_ext
with sigma = Q (e t) - e3, kappa = -log(Q_{k+1} Q_k^T) / D0, e the element
dilatation, eps the voronoi dilatation, dh the discrete difference and Ah
the trapezoidal quadrature.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sopht_mpi_tpu_torch.models.elastica.rotations import (
    exp_rotate,
    relative_rotation_vectors,
)

# shear correction factor alpha_c for circular cross sections
ALPHA_C = 4.0 / 3.0

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class CosseratRodState(NamedTuple):
    """Dynamic rod state."""

    position: torch.Tensor  # (3, n+1) node positions, lab frame
    velocity: torch.Tensor  # (3, n+1) node velocities, lab frame
    director: torch.Tensor  # (3, 3, n) element frames (lab -> material)
    omega: torch.Tensor  # (3, n) element angular velocity, material frame


class CosseratRodParams(NamedTuple):
    """Static rod properties."""

    rest_lengths: torch.Tensor  # (n,)
    rest_voronoi_lengths: torch.Tensor  # (n-1,)
    mass: torch.Tensor  # (n+1,)
    shear_diag: torch.Tensor  # (3, n)  diag of S
    bend_diag: torch.Tensor  # (3, n-1) diag of B on voronoi
    inertia_diag: torch.Tensor  # (3, n)  diag of J (mass second moment)
    inv_inertia_diag: torch.Tensor  # (3, n)
    radius: torch.Tensor  # (n,)
    density: torch.Tensor  # (n,)


# ---------------------------------------------------------------------------
# Discrete operators (paper's dh and Ah)
# ---------------------------------------------------------------------------


def difference_kernel(a):
    """Element -> node difference: out_i = a_i - a_{i-1}, zero-padded ends.
    (3, m) -> (3, m+1)."""
    pad = F.pad(a, (1, 1))
    return pad[:, 1:] - pad[:, :-1]


def quadrature_kernel(a):
    """Voronoi -> element trapezoidal quadrature: out_k = (a_k + a_{k-1})/2
    with half-weight ends. (3, m) -> (3, m+1)."""
    pad = F.pad(a, (1, 1))
    return 0.5 * (pad[:, 1:] + pad[:, :-1])


# ---------------------------------------------------------------------------
# Kinematics / strains
# ---------------------------------------------------------------------------


def compute_geometry(state: CosseratRodState, params: CosseratRodParams):
    """Per-element lengths, unit tangents, dilatations."""
    seg = state.position[:, 1:] - state.position[:, :-1]  # (3, n)
    lengths = torch.sqrt((seg * seg).sum(dim=0))
    tangents = seg / lengths
    dilatation = lengths / params.rest_lengths
    voronoi_len = 0.5 * (lengths[1:] + lengths[:-1])
    voronoi_dilatation = voronoi_len / params.rest_voronoi_lengths
    return lengths, tangents, dilatation, voronoi_dilatation


def compute_strains(state: CosseratRodState, params: CosseratRodParams):
    """sigma (3, n) shear/stretch strain and kappa (3, n-1) curvature,
    both in the material frame."""
    _, tangents, dilatation, _ = compute_geometry(state, params)
    # sigma = Q (e t) - e3
    et = dilatation * tangents
    et_material = torch.einsum("ijn,jn->in", state.director, et)
    e3 = torch.zeros_like(et_material)
    e3[2] = 1.0
    sigma = et_material - e3
    # kappa = -log(Q_{k+1} Q_k^T) / D0
    kappa = (
        -relative_rotation_vectors(state.director) / params.rest_voronoi_lengths
    )
    return sigma, kappa


# ---------------------------------------------------------------------------
# Dynamics
# ---------------------------------------------------------------------------


def compute_accelerations(
    state: CosseratRodState,
    params: CosseratRodParams,
    external_forces,
    external_torques,
):
    """Accelerations (dv/dt (3, n+1) lab frame, dw/dt (3, n) material).

    :param external_forces: (3, n+1) lab-frame forces on nodes.
    :param external_torques: (3, n) material-frame torques on elements.
    """
    lengths, tangents, dilatation, voronoi_dilatation = compute_geometry(
        state, params
    )
    sigma, kappa = compute_strains(state, params)
    q = state.director

    # internal stress (material) and node forces
    stress = params.shear_diag * sigma  # S sigma
    stress_lab = torch.einsum("jin,jn->in", q, stress)  # Q^T S sigma
    internal_forces = difference_kernel(stress_lab / dilatation)
    dvdt = (internal_forces + external_forces) / params.mass

    # internal torques (material frame, per element)
    eps3_inv = 1.0 / voronoi_dilatation**3
    couple = params.bend_diag * kappa  # B kappa (voronoi)
    bend_couple = difference_kernel(couple * eps3_inv)  # dh -> elements
    twist_couple = quadrature_kernel(
        torch.linalg.cross(kappa, couple, dim=0)
        * params.rest_voronoi_lengths
        * eps3_inv
    )
    t_material = torch.einsum("ijn,jn->in", q, tangents)
    shear_couple = (
        torch.linalg.cross(t_material, stress, dim=0) * params.rest_lengths
    )
    # Lagrangian transport (J w / e) x w and unsteady dilatation J w de/dt / e^2
    j_w = params.inertia_diag * state.omega
    transport = torch.linalg.cross(j_w / dilatation, state.omega, dim=0)
    # de/dt = t . (v_{i+1} - v_i) / l0
    dv_seg = state.velocity[:, 1:] - state.velocity[:, :-1]
    de_dt = (tangents * dv_seg).sum(dim=0) / params.rest_lengths
    unsteady = j_w * de_dt / dilatation**2

    torques = (
        bend_couple
        + twist_couple
        + shear_couple
        + transport
        + unsteady
        + external_torques
    )
    dwdt = params.inv_inertia_diag * torques * dilatation
    return dvdt, dwdt


def kinematic_step(state: CosseratRodState, dt) -> CosseratRodState:
    """Advance positions and directors with current rates."""
    return state._replace(
        position=state.position + dt * state.velocity,
        director=exp_rotate(state.director, dt * state.omega),
    )


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def make_straight_rod_arrays(
    n_elements: int,
    start,
    direction,
    normal,
    base_length: float,
    base_radius,
    density: float,
    youngs_modulus: float,
    shear_modulus: float | None = None,
    poisson_ratio: float = 0.5,
    dtype=np.float64,
):
    """Numpy (state, params) dicts for a straight untwisted rod, computed
    on the host in ``dtype`` (a numpy dtype) as the JAX package does."""
    n = n_elements
    start = np.asarray(start, dtype=dtype)
    d3 = np.asarray(direction, dtype=dtype)
    d3 = d3 / np.linalg.norm(d3)
    d1 = np.asarray(normal, dtype=dtype)
    d1 = d1 / np.linalg.norm(d1)
    if abs(np.dot(d3, d1)) > 1e-12:
        raise ValueError("direction and normal must be orthogonal")
    d2 = np.cross(d3, d1)

    if shear_modulus is None:
        shear_modulus = youngs_modulus / (2.0 * (1.0 + poisson_ratio))

    # geometry
    s = np.linspace(0.0, base_length, n + 1, dtype=dtype)
    position = start[:, None] + d3[:, None] * s[None, :]
    rest_lengths = np.full(n, base_length / n, dtype=dtype)
    rest_voronoi = 0.5 * (rest_lengths[1:] + rest_lengths[:-1])
    radius = np.broadcast_to(
        np.asarray(base_radius, dtype=dtype), (n,)
    ).astype(dtype)
    area = np.pi * radius**2

    # mass: element mass split to adjacent nodes
    elem_mass = density * area * rest_lengths
    mass = np.zeros(n + 1, dtype=dtype)
    mass[:-1] += 0.5 * elem_mass
    mass[1:] += 0.5 * elem_mass

    # section properties
    i1 = np.pi / 4.0 * radius**4
    i3 = 2.0 * i1
    shear_diag = np.stack(
        [
            ALPHA_C * shear_modulus * area,
            ALPHA_C * shear_modulus * area,
            youngs_modulus * area,
        ]
    )
    bend_elem = np.stack(
        [youngs_modulus * i1, youngs_modulus * i1, shear_modulus * i3]
    )  # (3, n)
    # voronoi average weighted by rest length
    bend_diag = (
        bend_elem[:, 1:] * rest_lengths[1:]
        + bend_elem[:, :-1] * rest_lengths[:-1]
    ) / (2.0 * rest_voronoi)
    inertia_diag = density * rest_lengths * np.stack([i1, i1, i3])

    director = np.zeros((3, 3, n), dtype=dtype)
    director[0, :, :] = d1[:, None]
    director[1, :, :] = d2[:, None]
    director[2, :, :] = d3[:, None]

    state = dict(
        position=position,
        velocity=np.zeros((3, n + 1), dtype),
        director=director,
        omega=np.zeros((3, n), dtype),
    )
    params = dict(
        rest_lengths=rest_lengths,
        rest_voronoi_lengths=rest_voronoi,
        mass=mass,
        shear_diag=shear_diag,
        bend_diag=bend_diag,
        inertia_diag=inertia_diag,
        inv_inertia_diag=1.0 / inertia_diag,
        radius=radius,
        density=np.full(n, density, dtype=dtype),
    )
    return state, params


class CosseratRod:
    """PyElastica-style wrapper around the functional core: ``state`` and
    ``params`` NamedTuples (``rod.params = rod.params._replace(...)``
    changes a property before ``finalize``), plus the attribute surface
    the reference code touches (``position_collection``, ``lengths``,
    ``n_elems``, ``external_forces``, ...)."""

    def __init__(self, state: CosseratRodState, params: CosseratRodParams):
        self.state = state
        self.params = params
        n = params.rest_lengths.shape[0]
        self.n_elems = n
        like = state.position
        self.external_forces = like.new_zeros((3, n + 1))
        self.external_torques = like.new_zeros((3, n))

    @classmethod
    def straight_rod(
        cls,
        n_elements,
        start,
        direction,
        normal,
        base_length,
        base_radius,
        density,
        *args,
        youngs_modulus=None,
        shear_modulus=None,
        device,
        dtype=torch.float64,
    ):
        """A straight untwisted rod on ``device`` in ``dtype`` (float64 by
        default, what the JAX package resolves ``np.float64`` to with x64
        on). A positional ``youngs_modulus`` may follow the density, after
        the deprecated internal-damping argument or alone."""
        args = list(args)
        if youngs_modulus is None:
            if len(args) == 1:
                youngs_modulus = args[0]
            elif len(args) == 2:
                youngs_modulus = args[1]  # args[0] = deprecated nu
            else:
                raise TypeError("youngs_modulus required")
        state, params = make_straight_rod_arrays(
            n_elements, start, direction, normal, base_length, base_radius,
            density, youngs_modulus, shear_modulus=shear_modulus,
            dtype=_NUMPY_DTYPE[dtype],
        )

        def tensors(arrays):
            return {
                k: torch.tensor(v, dtype=dtype, device=device)
                for k, v in arrays.items()
            }

        return cls(
            CosseratRodState(**tensors(state)),
            CosseratRodParams(**tensors(params)),
        )

    # -- PyElastica-style accessors -----------------------------------------

    @property
    def position_collection(self):
        return self.state.position

    @position_collection.setter
    def position_collection(self, value):
        self.state = self.state._replace(position=value)

    @property
    def velocity_collection(self):
        return self.state.velocity

    @velocity_collection.setter
    def velocity_collection(self, value):
        self.state = self.state._replace(velocity=value)

    @property
    def director_collection(self):
        return self.state.director

    @director_collection.setter
    def director_collection(self, value):
        self.state = self.state._replace(director=value)

    @property
    def omega_collection(self):
        return self.state.omega

    @omega_collection.setter
    def omega_collection(self, value):
        self.state = self.state._replace(omega=value)

    @property
    def rest_lengths(self):
        return self.params.rest_lengths

    @property
    def radius(self):
        return self.params.radius

    @property
    def mass(self):
        return self.params.mass

    @property
    def lengths(self):
        return compute_geometry(self.state, self.params)[0]

    @property
    def tangents(self):
        return compute_geometry(self.state, self.params)[1]

    # -- checkpointing (parity with ea.save_state/load_state) ---------------

    def get_state_arrays(self) -> dict:
        """The dynamic state as numpy arrays (one host copy each), keyed
        ``position``, ``velocity``, ``director``, ``omega``."""
        return {name: getattr(self.state, name).detach().cpu().numpy()
                for name in CosseratRodState._fields}

    def set_state_arrays(self, arrays: dict):
        """Set the dynamic state from arrays keyed as
        :meth:`get_state_arrays`' result, on the rod's device and dtype."""
        like = self.state.position
        self.state = CosseratRodState(**{
            name: torch.tensor(np.asarray(arrays[name]), dtype=like.dtype,
                               device=like.device)
            for name in CosseratRodState._fields
        })
