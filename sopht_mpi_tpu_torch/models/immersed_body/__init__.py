from sopht_mpi_tpu_torch.models.immersed_body.forcing_grids import (
    CircularCylinderForcingGrid,
    EmptyForcingGrid,
    ImmersedBodyForcingGrid,
    SphereForcingGrid,
)
from sopht_mpi_tpu_torch.models.immersed_body.rod_forcing_grids import (
    CosseratRodEdgeForcingGrid,
    CosseratRodElementCentricForcingGrid,
    CosseratRodSurfaceForcingGrid,
)
from sopht_mpi_tpu_torch.models.immersed_body.interaction import (
    CosseratRodFlowInteraction,
    ImmersedBodyFlowInteraction,
    RigidBodyFlowInteraction,
)
