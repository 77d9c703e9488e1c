"""The port's rigid-body dynamics against the JAX package's, float64.

Tolerance ``1e-12 max(1, |ref|)``: the same float64 arithmetic in another
order (3x3 products, Rodrigues' formula).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sopht_mpi_tpu.models.rigid_body as jrb
import sopht_mpi_tpu_torch.models.rigid_body as trb

TOL = 1e-12


def _close(out, ref, what):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _random_state(rng):
    """A moving, spinning body with a random orientation (numpy)."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return dict(position=rng.standard_normal(3),
                velocity=rng.standard_normal(3),
                omega=rng.standard_normal(3), director=q)


@pytest.mark.parametrize("omega_scale", [1.0, 1e-13],
                         ids=["rotating", "series-branch"])
def test_position_verlet_matches_jax(omega_scale):
    """Ten position-Verlet steps under constant loads with an anisotropic
    inertia (the gyroscopic term alive); ``omega_scale`` puts the rotation
    angle below 1e-10 so Rodrigues' series branch runs."""
    rng = np.random.default_rng(3)
    s = _random_state(rng)
    s["omega"] = omega_scale * s["omega"]
    force, torque = rng.standard_normal(3), rng.standard_normal((3, 1))
    mass, inertia = 2.5, np.array([0.3, 0.5, 0.8])
    jstate = jrb.RigidBodyState(**{k: jnp.asarray(v) for k, v in s.items()})
    state = trb.RigidBodyState(**{k: torch.tensor(v) for k, v in s.items()})
    dt = 0.01
    for _ in range(10):
        jstate = jrb.rigid_body_position_verlet_step(
            jstate, dt, force, torque, mass, inertia)
        state = trb.rigid_body_position_verlet_step(
            state, torch.tensor(dt, dtype=torch.float64),
            torch.tensor(force), torch.tensor(torque), mass,
            torch.tensor(inertia))
    for what in trb.RigidBodyState._fields:
        _close(getattr(state, what), getattr(jstate, what), what)
        assert getattr(state, what).dtype == torch.float64
    # the director stays a rotation
    q = state.director
    _close(q @ q.T, np.eye(3), "orthogonality")


def test_acceleration_and_rotation_match_jax():
    rng = np.random.default_rng(4)
    s = _random_state(rng)
    force, torque = rng.standard_normal(3), rng.standard_normal(3)
    inertia = np.array([0.2, 0.7, 1.1])
    jstate = jrb.RigidBodyState(**{k: jnp.asarray(v) for k, v in s.items()})
    state = trb.RigidBodyState(**{k: torch.tensor(v) for k, v in s.items()})
    ref = jrb.rigid_body_acceleration(jstate, force, torque, 1.7, inertia)
    out = trb.rigid_body_acceleration(state, torch.tensor(force),
                                      torch.tensor(torque), 1.7, inertia)
    for o, r, what in zip(out, ref, ("acc", "alpha")):
        _close(o, r, what)
    for dt in (0.3, 1e-12):
        _close(trb._rotate_matrix(state.director, state.omega, dt),
               jrb._rotate_matrix(jstate.director, jstate.omega, dt),
               f"rotate dt={dt}")


def test_sphere_mass_and_inertia_match_jax():
    sphere = trb.Sphere(np.array([0.1, 0.2, 0.3]), 0.05, device="cpu",
                        dtype=torch.float64, density=3.0)
    jsphere = jrb.Sphere(np.array([0.1, 0.2, 0.3]), 0.05,
                         dtype=jnp.float64, density=3.0)
    assert sphere.mass == pytest.approx(jsphere.mass, rel=1e-15)
    np.testing.assert_allclose(sphere.inertia_body, jsphere.inertia_body,
                               rtol=1e-15)
    assert not hasattr(trb.Sphere(np.zeros(3), 0.05, device="cpu"), "mass")


def test_state_needs_a_device():
    """``RigidBodyState.create`` takes no default device."""
    with pytest.raises(TypeError):
        trb.RigidBodyState.create(np.zeros(3))
    state = trb.RigidBodyState.create(np.zeros(3), device="cpu",
                                      dtype=torch.float64)
    assert state.director.dtype == torch.float64
    assert torch.equal(state.director, torch.eye(3, dtype=torch.float64))
