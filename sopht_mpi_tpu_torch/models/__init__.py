"""Physics models: the 3D flow simulator, the rigid sphere, its forcing
grid and interactor, and the fused rigid-body FSI step."""

from sopht_mpi_tpu_torch.models.flow.simulator_3d import UnboundedFlowSimulator3D
from sopht_mpi_tpu_torch.models.rigid_body import RigidBodyState, Sphere
from sopht_mpi_tpu_torch.models.immersed_body import (
    ImmersedBodyFlowInteraction,
    ImmersedBodyForcingGrid,
    RigidBodyFlowInteraction,
    SphereForcingGrid,
)
from sopht_mpi_tpu_torch.models.fsi import (
    RigidFSICarry,
    build_rigid_fsi_step,
    init_rigid_fsi_carry,
    scan_steps,
)
