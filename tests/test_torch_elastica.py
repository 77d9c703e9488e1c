"""The port's Cosserat rod (``models/elastica``) against the JAX package's:
rotations, geometry, strains and accelerations of a bent and twisted rod,
and position-Verlet steps with a clamp, gravity and the damper, from the
same numpy inputs; plus the analytical validations of the JAX package's
own rod tests, run on the port alone.

Tolerances (float64): ``1e-12 max(1, |ref|max)`` for one evaluation,
``1e-9 max(1, |ref|max)`` after many steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sopht_mpi_tpu.models import elastica as jel
from sopht_mpi_tpu_torch.convert import rod_params_from_numpy, rod_state_from_numpy
from sopht_mpi_tpu_torch.models import elastica as el

KERNEL_TOL = 1e-12
STEP_TOL = 1e-9


def _close(out, ref, tol, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rotations(rng, n, scale):
    """Random rotation matrices exp(hat(phi)) built with the JAX package."""
    phi = scale * rng.standard_normal((3, n))
    eye = np.repeat(np.eye(3)[:, :, None], n, axis=2)
    return np.asarray(jel.exp_rotate(jnp.asarray(eye), jnp.asarray(phi)))


@pytest.mark.parametrize("scale", [1e-12, 1e-6, 0.3, 2.0],
                         ids=["theta~0", "small", "moderate", "large"])
def test_rotations_match_jax(scale):
    rng = np.random.default_rng(1)
    n = 16
    q = _rotations(rng, n, 0.7)
    phi = scale * rng.standard_normal((3, n))
    phi[:, 0] = 0.0  # exactly zero rotation in one element
    _close(el.exp_rotate(_t(q), _t(phi)),
           jel.exp_rotate(jnp.asarray(q), jnp.asarray(phi)), KERNEL_TOL,
           "exp_rotate")
    rot = _rotations(rng, n, scale)
    _close(el.log_rotation_vector(_t(rot)),
           jel.log_rotation_vector(jnp.asarray(rot)), KERNEL_TOL,
           "log_rotation_vector")
    chain = np.concatenate([q, _rotations(rng, 1, scale)], axis=2)
    _close(el.relative_rotation_vectors(_t(chain)),
           jel.relative_rotation_vectors(jnp.asarray(chain)), KERNEL_TOL,
           "relative_rotation_vectors")


def _bent_rod(seed=0, n=12):
    """A straight JAX rod, then bent, twisted and set moving with seeded
    numpy noise; returns (JAX state, JAX params, numpy state)."""
    rng = np.random.default_rng(seed)
    rod = jel.CosseratRod.straight_rod(
        n, np.zeros(3), np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]),
        1.0, 0.05, 1e3, youngs_modulus=1e6, shear_modulus=1e6 / 1.5,
    )
    pos = np.asarray(rod.state.position) + 0.01 * rng.standard_normal((3, n + 1))
    director = np.asarray(jel.exp_rotate(
        rod.state.director, jnp.asarray(0.2 * rng.standard_normal((3, n)))
    ))
    state = dict(
        position=pos,
        velocity=0.1 * rng.standard_normal((3, n + 1)),
        director=director,
        omega=0.5 * rng.standard_normal((3, n)),
    )
    jstate = jel.CosseratRodState(**{k: jnp.asarray(v) for k, v in state.items()})
    return jstate, rod.params, state


def test_rod_mechanics_match_jax():
    jstate, jparams, state = _bent_rod()
    params = rod_params_from_numpy(
        [np.asarray(p) for p in jparams], device="cpu"
    )
    tstate = rod_state_from_numpy(state, device="cpu")
    for out, ref, what in zip(
        el.compute_geometry(tstate, params),
        jel.compute_geometry(jstate, jparams),
        ("lengths", "tangents", "dilatation", "voronoi_dilatation"),
    ):
        _close(out, ref, KERNEL_TOL, what)
    for out, ref, what in zip(el.compute_strains(tstate, params),
                              jel.compute_strains(jstate, jparams),
                              ("sigma", "kappa")):
        _close(out, ref, KERNEL_TOL, what)
    rng = np.random.default_rng(3)
    n = params.rest_lengths.shape[0]
    f_ext = rng.standard_normal((3, n + 1))
    c_ext = rng.standard_normal((3, n))
    for out, ref, what in zip(
        el.compute_accelerations(tstate, params, _t(f_ext), _t(c_ext)),
        jel.compute_accelerations(jstate, jparams, jnp.asarray(f_ext),
                                  jnp.asarray(c_ext)),
        ("dvdt", "dwdt"),
    ):
        _close(out, ref, KERNEL_TOL, what)
    a = rng.standard_normal((3, 7))
    _close(el.difference_kernel(_t(a)), jel.difference_kernel(jnp.asarray(a)),
           KERNEL_TOL, "difference_kernel")
    _close(el.quadrature_kernel(_t(a)), jel.quadrature_kernel(jnp.asarray(a)),
           KERNEL_TOL, "quadrature_kernel")


def _collection(pkg, n_elem, dt, device_kw):
    """A clamped rod under gravity with the damper, as the rod FSI cases
    build it."""
    rod = pkg.CosseratRod.straight_rod(
        n_elem, np.array([0.2, 0.5, 0.75]), np.array([0.0, 0.0, -1.0]),
        np.array([0.0, 1.0, 0.0]), 1.0, 0.05, 100.0,
        youngs_modulus=2e4, shear_modulus=2e4 / 1.5, **device_kw,
    )
    sim = pkg.BaseSystemCollection()
    sim.append(rod)
    sim.constrain(rod).using(
        pkg.OneEndFixedBC, constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    sim.add_forcing_to(rod).using(
        pkg.GravityForces, acc_gravity=np.array([0.0, 0.0, -9.81])
    )
    sim.add_forcing_to(rod).using(
        pkg.EndpointForces, start_force=np.zeros(3),
        end_force=np.array([0.5, 0.0, 0.0]), ramp_up_time=0.05,
    )
    sim.dampen(rod).using(
        pkg.AnalyticalLinearDamper, damping_constant=0.5, time_step=dt
    )
    sim.finalize()
    return sim, rod


@pytest.mark.parametrize("driver", ["step", "run_steps"])
def test_position_verlet_matches_jax(driver):
    n_elem, dt, n_steps = 10, 2e-4, 300
    jsim, jrod = _collection(jel, n_elem, dt, {})
    sim, rod = _collection(el, n_elem, dt, {"device": "cpu"})
    if driver == "step":
        ts = el.PositionVerlet()
        do_step, stages = el.extend_stepper_interface(ts, sim)
        jts = jel.PositionVerlet()
        jdo_step, jstages = jel.extend_stepper_interface(jts, jsim)
        t = jt = 0.0
        for _ in range(n_steps):
            t = do_step(ts, stages, sim, t, dt)
            jt = jdo_step(jts, jstages, jsim, jt, dt)
    else:
        sim.run_steps(0.0, dt, n_steps)
        jsim.run_steps(0.0, dt, n_steps)
    for what in ("position", "velocity", "director", "omega"):
        _close(getattr(rod.state, what), getattr(jrod.state, what), STEP_TOL,
               what)
    # the tip moved: gravity, the end force and the clamp all acted
    assert float((rod.state.position[:, -1] - rod.state.position[:, 0]).abs()
                 .max()) > 0
    _close(rod.state.position[:, 0], np.array([0.2, 0.5, 0.75]), 0.0, "clamp")


def test_general_constraint_matches_jax():
    """A translation-fixed end that spins freely about the rod axis."""
    n = 8
    results = []
    for pkg, kw in ((jel, {}), (el, {"device": "cpu"})):
        rod = pkg.CosseratRod.straight_rod(
            n, np.zeros(3), np.array([1.0, 0.0, 0.0]),
            np.array([0.0, 1.0, 0.0]), 1.0, 0.05, 1e3,
            youngs_modulus=1e5, shear_modulus=1e5 / 1.5, **kw,
        )
        omega = np.zeros((3, n))
        omega[2] = 5.0  # spin about the material d3 = the rod axis
        omega[0, 0] = 1.0
        rod.omega_collection = (jnp.asarray(omega) if pkg is jel
                                else torch.tensor(omega))
        sim = pkg.BaseSystemCollection()
        sim.append(rod)
        sim.constrain(rod).using(
            pkg.GeneralConstraint, constrained_position_idx=(0,),
            constrained_director_idx=(0,),
            translational_constraint_selector=np.array([True, True, True]),
            rotational_constraint_selector=np.array([False, True, True]),
        )
        sim.finalize()
        sim.run_steps(0.0, 1e-4, 50)
        results.append(rod.state)
    for what in ("position", "velocity", "director", "omega"):
        _close(getattr(results[1], what), getattr(results[0], what),
               STEP_TOL, what)


# -- the JAX package's analytical rod validations, on the port alone ---------

E, G, L, R, RHO = 1e6, 1e4, 3.0, 0.25, 5e3
AREA = np.pi * R * R
I_SECOND = np.pi / 4 * R**4
ALPHA = 4.0 / 3.0


def _clamped(n_elem, end_force, damping, dt):
    sim = el.BaseSystemCollection()
    rod = el.CosseratRod.straight_rod(
        n_elem, np.zeros(3), np.array([0.0, 0.0, 1.0]),
        np.array([0.0, 1.0, 0.0]), L, R, RHO, youngs_modulus=E,
        shear_modulus=G, device="cpu",
    )
    sim.append(rod)
    sim.constrain(rod).using(
        el.OneEndFixedBC, constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    sim.add_forcing_to(rod).using(
        el.EndpointForces, start_force=np.zeros(3), end_force=end_force
    )
    sim.dampen(rod).using(
        el.AnalyticalLinearDamper, damping_constant=damping, time_step=dt
    )
    sim.finalize()
    return sim, rod


def test_timoshenko_cantilever_deflection():
    """A clamped rod with a transverse tip force relaxes to the Timoshenko
    beam deflection, within the JAX package test's 8% (tip) and 10% of the
    tip (profile)."""
    n_elem = 20
    dt = 0.01 * L / n_elem
    force = 15.0
    sim, rod = _clamped(n_elem, np.array([0.0, force, 0.0]), 0.2, dt)
    sim.run_steps(0.0, dt, int(50.0 / dt))
    tip = float(rod.position_collection[1, -1])
    tip_analytical = force / (ALPHA * G * AREA) * L + force / (E * I_SECOND) * (
        L**3 / 2 - L**3 / 6
    )
    assert tip == pytest.approx(tip_analytical, rel=0.08)
    s = rod.position_collection[2].numpy()
    y_analytical = force / (ALPHA * G * AREA) * s + force / (E * I_SECOND) * (
        L * s**2 / 2 - s**3 / 6
    )
    np.testing.assert_allclose(
        rod.position_collection[1].numpy(), y_analytical,
        atol=0.1 * abs(tip_analytical),
    )


def test_axial_stretch():
    """An end force along the rod stretches it by F L / (E A), within the
    JAX package test's 2%."""
    n_elem = 10
    dt = 0.01 * L / n_elem
    force = 100.0
    sim, rod = _clamped(n_elem, np.array([0.0, 0.0, force]), 0.3, dt)
    sim.run_steps(0.0, dt, int(30.0 / dt))
    stretch = float(rod.position_collection[2, -1]) - L
    assert stretch == pytest.approx(force * L / (E * AREA), rel=0.02)
