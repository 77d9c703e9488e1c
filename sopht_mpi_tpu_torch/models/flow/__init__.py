from sopht_mpi_tpu_torch.models.flow.simulator_3d import (
    FlowState3D,
    UnboundedFlowSimulator3D,
    compute_flow_velocity_3d,
    compute_stable_timestep_3d,
    flow_step_3d,
)
