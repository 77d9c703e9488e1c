"""Cosserat rod dynamics (counterpart of ``sopht_mpi_tpu.models.elastica``):
the rod as NamedTuples of tensors stepped by plain functions."""

from sopht_mpi_tpu_torch.models.elastica.rod import (
    CosseratRod,
    CosseratRodParams,
    CosseratRodState,
    compute_accelerations,
    compute_geometry,
    compute_strains,
    difference_kernel,
    kinematic_step,
    make_straight_rod_arrays,
    quadrature_kernel,
)
from sopht_mpi_tpu_torch.models.elastica.rotations import (
    exp_rotate,
    log_rotation_vector,
    relative_rotation_vectors,
)
from sopht_mpi_tpu_torch.models.elastica.forcing import (
    AnalyticalLinearDamper,
    EndpointForces,
    FlowForces,
    FreeBC,
    GeneralConstraint,
    GravityForces,
    OneEndFixedBC,
)
from sopht_mpi_tpu_torch.models.elastica.stepper import (
    BaseSystemCollection,
    PositionVerlet,
    extend_stepper_interface,
    make_rod_step_fn,
)
