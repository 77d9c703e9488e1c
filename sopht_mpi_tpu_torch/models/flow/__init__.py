from sopht_mpi_tpu_torch.models.flow.simulator_2d import (
    FlowState2D,
    UnboundedFlowSimulator2D,
    advection_and_diffusion_timestep_2d,
    compute_stable_timestep_2d,
    compute_velocity_from_vorticity_2d,
    flow_step_2d,
)
from sopht_mpi_tpu_torch.models.flow.simulator_3d import (
    FlowState3D,
    UnboundedFlowSimulator3D,
    compute_flow_velocity_3d,
    compute_stable_timestep_3d,
    flow_step_3d,
)
