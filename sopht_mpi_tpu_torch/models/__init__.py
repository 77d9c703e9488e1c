"""Physics models: the 2D and 3D flow simulators, the rigid cylinder and
sphere and the Cosserat rod, their forcing grids and interactors, and the fused FSI steps (rigid,
rod and multi-body)."""

from sopht_mpi_tpu_torch.models.flow.simulator_2d import UnboundedFlowSimulator2D
from sopht_mpi_tpu_torch.models.flow.simulator_3d import UnboundedFlowSimulator3D
from sopht_mpi_tpu_torch.models.rigid_body import (
    Cylinder,
    RigidBodyState,
    Sphere,
    rigid_body_position_verlet_step,
)
from sopht_mpi_tpu_torch.models.immersed_body import (
    CircularCylinderForcingGrid,
    EmptyForcingGrid,
    CosseratRodEdgeForcingGrid,
    CosseratRodElementCentricForcingGrid,
    CosseratRodFlowInteraction,
    CosseratRodSurfaceForcingGrid,
    ImmersedBodyFlowInteraction,
    ImmersedBodyForcingGrid,
    RigidBodyFlowInteraction,
    SphereForcingGrid,
)
from sopht_mpi_tpu_torch.models import elastica
from sopht_mpi_tpu_torch.models.fsi import (
    FlowOnlyCarry,
    RigidFSICarry,
    RodFSICarry,
    MultiBodyFSICarry,
    RodBody,
    DynamicRigidBody,
    FixedRigidBody,
    build_flow_only_step,
    build_rigid_fsi_step,
    build_rod_fsi_step,
    build_multi_body_fsi_step,
    suggest_rigid_forcing_window,
    suggest_rod_forcing_window,
    init_flow_only_carry,
    init_rigid_fsi_carry,
    init_rod_fsi_carry,
    init_multi_body_fsi_carry,
    scan_steps,
)
from sopht_mpi_tpu_torch.models.elastica import (
    AnalyticalLinearDamper,
    BaseSystemCollection,
    CosseratRod,
    EndpointForces,
    FlowForces,
    GeneralConstraint,
    GravityForces,
    OneEndFixedBC,
    PositionVerlet,
    extend_stepper_interface,
)
