"""Position-Verlet time stepping and the system-collection API
(counterpart of ``sopht_mpi_tpu/models/elastica/stepper.py``).

The whole per-rod step (both kinematic half steps, the dynamic update,
constraints, pure forcings, damping) is one plain function of the rod
state; host-dependent forcings (the FSI ``FlowForces``) enter as
force/torque buffers refreshed between steps, as the reference loop
refreshes the interactor.

Stepping scheme (PyElastica's PositionVerlet):
    1. kinematic half step:  x += dt/2 v ; Q <- exp(-dt/2 w^) Q ;
       constrain values
    2. dynamic step: accelerations at the half-step configuration
       (internal + external forcing), v += dt dv/dt, w += dt dw/dt;
       constrain rates; dampen rates
    3. kinematic half step again; constrain values
"""

from __future__ import annotations

from sopht_mpi_tpu_torch.models.elastica.rod import (
    CosseratRod,
    compute_accelerations,
    kinematic_step,
)


class PositionVerlet:
    """Marker class for API parity with ``ea.PositionVerlet``."""


def make_rod_step_fn(params, constraints, pure_forcings, dampers):
    """Build the one-step function for a rod.

    Returns ``step(state, time, dt, host_forces, host_torques) -> state``
    where the host buffers carry forcing contributions computed outside
    the step (zero tensors when there are none). ``time`` and ``dt`` are
    numbers or 0-d tensors of the rod's dtype on its device.
    """

    def constrain_values(state):
        for bc in constraints:
            state = bc.constrain_values(state)
        return state

    def constrain_rates(state):
        for bc in constraints:
            state = bc.constrain_rates(state)
        return state

    def step(state, time, dt, host_forces, host_torques):
        half_dt = 0.5 * dt
        # stage 1: kinematic half step
        state = kinematic_step(state, half_dt)
        state = constrain_values(state)
        # stage 2: dynamic step at the half-step configuration
        forces = host_forces
        torques = host_torques
        for forcing in pure_forcings:
            f, t = forcing.compute(state, params, time + half_dt)
            forces = forces + f
            torques = torques + t
        dvdt, dwdt = compute_accelerations(state, params, forces, torques)
        state = state._replace(
            velocity=state.velocity + dt * dvdt,
            omega=state.omega + dt * dwdt,
        )
        state = constrain_rates(state)
        for damper in dampers:
            state = damper.dampen_rates(state, params)
        # stage 3: kinematic half step
        state = kinematic_step(state, half_dt)
        state = constrain_values(state)
        return state

    return step


class BaseSystemCollection:
    """Rod system collection with the reference's builder API::

        sim = BaseSystemCollection()
        sim.append(rod)
        sim.constrain(rod).using(OneEndFixedBC, ...)
        sim.add_forcing_to(rod).using(GravityForces, acc_gravity=...)
        sim.dampen(rod).using(AnalyticalLinearDamper, ...)
        sim.finalize()

    The builder methods are always available (PyElastica's mixins
    ``ea.Constraints`` etc. collapse into this class). ``_step_fns`` holds
    one plain step function per rod.
    """

    def __init__(self):
        self._systems: list[CosseratRod] = []
        self._constraints: dict[int, list] = {}
        self._forcings: dict[int, list] = {}
        self._dampers: dict[int, list] = {}
        self._finalized = False

    def append(self, system):
        self._systems.append(system)

    def _builder(self, registry, system):
        idx = self._systems.index(system)

        class _Using:
            def using(self, cls, *args, **kwargs):
                registry.setdefault(idx, []).append((cls, args, kwargs))
                return self

        return _Using()

    def constrain(self, system):
        return self._builder(self._constraints, system)

    def add_forcing_to(self, system):
        return self._builder(self._forcings, system)

    def dampen(self, system):
        return self._builder(self._dampers, system)

    def finalize(self):
        """Instantiate constraints/forcings/dampers and build one step
        function per rod. ``OneEndFixedBC``-style constraints capture the
        *current* (initial) constrained values, as PyElastica's finalize
        does."""
        from sopht_mpi_tpu_torch.models.elastica.forcing import (
            GeneralConstraint,
            OneEndFixedBC,
        )

        self._step_fns = []
        self._host_forcings = []
        for idx, rod in enumerate(self._systems):
            constraints = []
            for cls, args, kwargs in self._constraints.get(idx, []):
                if cls in (OneEndFixedBC, GeneralConstraint):
                    kw = dict(kwargs)
                    node_idx = kw.pop("constrained_position_idx", (0,))[0]
                    elem_idx = kw.pop("constrained_director_idx", (0,))[0]
                    constraints.append(
                        cls(
                            rod.state.position[:, node_idx].clone(),
                            rod.state.director[:, :, elem_idx].clone(),
                            node_idx=node_idx,
                            elem_idx=elem_idx,
                            **kw,
                        )
                    )
                else:
                    constraints.append(cls(*args, **kwargs))
            forcings = [
                cls(*args, **kwargs)
                for cls, args, kwargs in self._forcings.get(idx, [])
            ]
            dampers = [
                cls(*args, **kwargs)
                for cls, args, kwargs in self._dampers.get(idx, [])
            ]
            pure = [f for f in forcings if not getattr(f, "requires_host", False)]
            host = [f for f in forcings if getattr(f, "requires_host", False)]
            self._step_fns.append(
                make_rod_step_fn(rod.params, constraints, pure, dampers)
            )
            self._host_forcings.append(host)
        self._finalized = True

    # -- stepping -------------------------------------------------------------

    def step(self, time: float, dt: float) -> float:
        """One position-Verlet step for every system in the collection."""
        assert self._finalized, "call finalize() before stepping"
        for idx, rod in enumerate(self._systems):
            hf = rod.external_forces.new_zeros(rod.external_forces.shape)
            ht = rod.external_torques.new_zeros(rod.external_torques.shape)
            for forcing in self._host_forcings[idx]:
                f, t = forcing.compute_host(rod, time)
                hf = hf + f
                ht = ht + t
            rod.state = self._step_fns[idx](rod.state, time, dt, hf, ht)
        return time + dt

    def run_steps(self, time: float, dt: float, n_steps: int) -> float:
        """Advance ``n_steps`` steps in a plain loop (only valid when no
        host-dependent forcings are registered)."""
        assert self._finalized, "call finalize() before stepping"
        for idx, rod in enumerate(self._systems):
            if self._host_forcings[idx]:
                raise ValueError("run_steps requires all forcings to be pure")
            zero_f = rod.external_forces.new_zeros(rod.external_forces.shape)
            zero_t = rod.external_torques.new_zeros(rod.external_torques.shape)
            state, t = rod.state, time
            for _ in range(n_steps):
                state = self._step_fns[idx](state, t, dt, zero_f, zero_t)
                t = t + dt
            rod.state = state
        return time + n_steps * dt


def extend_stepper_interface(timestepper, system_collection):
    """API parity with ``ea.extend_stepper_interface``: returns
    ``(do_step, stages_and_updates)`` where
    ``do_step(timestepper, stages_and_updates, sim, time, dt) -> time``."""

    def do_step(_timestepper, _stages, collection, time, dt):
        return collection.step(time, dt)

    return do_step, None
