"""Numerics on tensors: stencil ops and their Hopper kernels, the
free-space Poisson solver, immersed-boundary transfers and forcing."""

from sopht_mpi_tpu_torch.ops.elementwise import (
    add_fixed_val,
    cross_product_3d,
    saxpby,
    set_fixed_val,
)
from sopht_mpi_tpu_torch.ops.stencils_3d import (
    advection_flux_conservative_eno3_3d,
    advection_timestep_eno3_3d,
    advection_timestep_eno3_vector_3d,
    brinkmann_penalise_3d,
    char_func_from_level_set_via_sine_heaviside_3d,
    curl_3d,
    diffusion_flux_3d,
    diffusion_timestep_3d,
    diffusion_timestep_vector_3d,
    divergence_3d,
    laplacian_filter_3d,
    laplacian_filter_vector_3d,
    penalise_field_boundary_3d,
    penalise_field_boundary_vector_3d,
    update_vorticity_from_penalised_velocity_3d,
    update_vorticity_from_velocity_forcing_3d,
)
from sopht_mpi_tpu_torch.ops.stencils_2d import (
    advection_flux_conservative_eno3_2d,
    advection_timestep_eno3_2d,
    brinkmann_penalise_2d,
    char_func_from_level_set_via_sine_heaviside_2d,
    diffusion_flux_2d,
    diffusion_timestep_2d,
    outplane_field_curl_2d,
    penalise_field_boundary_2d,
    update_vorticity_from_velocity_forcing_2d,
)
from sopht_mpi_tpu_torch.ops.poisson import (
    UnboundedPoissonSolver2D,
    UnboundedPoissonSolver3D,
)
from sopht_mpi_tpu_torch.ops.ibm import (
    INTERP_KERNEL_WIDTH,
    axis_delta_weight_matrices,
    cosine_delta_weights_1d,
    eulerian_to_lagrangian_interpolation,
    eulerian_to_lagrangian_interpolation_mm,
    interpolation_weights,
    lagrangian_to_eulerian_spread,
    lagrangian_to_eulerian_spread_mm,
    nearest_grid_index_and_support,
    peskin_delta_weights_1d,
)
from sopht_mpi_tpu_torch.ops.virtual_boundary import (
    LagGridInteraction,
    VirtualBoundaryForcingParams,
    VirtualBoundaryState,
    compute_interaction_force_on_eul_and_lag_grid,
    compute_interaction_force_on_lag_grid,
    compute_penalty_force,
    init_virtual_boundary_state,
    virtual_boundary_time_step,
)
