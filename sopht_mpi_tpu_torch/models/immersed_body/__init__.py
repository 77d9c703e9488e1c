from sopht_mpi_tpu_torch.models.immersed_body.forcing_grids import (
    ImmersedBodyForcingGrid,
    SphereForcingGrid,
)
from sopht_mpi_tpu_torch.models.immersed_body.interaction import (
    ImmersedBodyFlowInteraction,
    RigidBodyFlowInteraction,
)
