#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line with its result and wall time; any failure
raises and exits non-zero, and nothing falls back to the CPU:

1. device: the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them;
2. build: ``nvcc`` builds both sources of ``sopht_mpi_tpu_torch/csrc``
   at once (one compiler process each) and prints ptxas' register lines;
3. kernels: each stencil kernel against its plain PyTorch version on the
   card (float32 at 256^3 and (3, 17, 33, 65), float64 at 64^3; the
   filtered-transport trio also at (3, 3, 3, 3), the freely rotating rod's
   (3, 64, 64, 128) and the rod's (3, 256, 64, 256), the multiplicative
   filter at orders 1 and 2, the convolution filter at 1, 2 and 5
   (``conv_filter_zmarch_kernel``, one launch a call) and at 6 (the line
   route above its instances, ``conv_filter_line_kernel`` and
   ``conv_filter_z_pass_kernel``, 2 + 6 launches a call); the trio's times a call in a batch of 20 at the rod's shape beside them, the
   convolution filter's at 256^3, the rod's and the freely rotating rod's
   shapes), and each FFT-pass kernel
   against its plain
   ``torch.fft`` version (float32 at the 256^3 main-path shapes and at
   those of a (48, 32, 64) grid), with kernel and plain times at the main
   paths' shapes (CUDA events, median of 20 calls after warm-up);
4. solve: the 256^3 vector Poisson solve on the kernel route against the
   same solver's dense ``torch.fft`` route, values and times;
5. main path: the 256^3 flow-past-sphere FSI step (sparse IBM window,
   float32, exact spectral tier, Poisson solve on the kernel route), 5
   warm-up + 20 timed steps that must not synchronise with the host, with
   every kernel's launch count over the timed steps;
6. physics: the 64^3 Re=100 sphere drag case (dense IBM path) to t* = 2 on
   the kernel route, Cd against the JAX package's validated value and
   against the same run on the dense ``torch.fft`` route;
7. card vs CPU: 3 steps of the 32^3 case from one numpy-seeded state,
   kernels on the card against the plain versions on the CPU;
8. rod main path: the (256, 64, 256) flexible-rod FSI step (float32 flow,
   float64 rod, sparse moving window, order-1 multiplicative filter,
   dynamic substeps, Poisson solve on the kernel route), 5 warm-up + 20
   timed steps with every kernel's launch count, 3 steps with their host
   syncs counted, then a profiled window for the device busy share and the
   time by kernel (written to ``build/rod_profile.txt``);
9. rod physics: the (128, 32, 128) rod case to t = 0.1 (the reference
   runs to 0.2; the depth was cut to keep the script near 650 s), its tip
   against the JAX package's CPU trajectory
   (``sopht_mpi_tpu_torch/data/rod_tip_reference.json``);
10. rod card vs CPU: 3 steps of the (64, 16, 64) rod case from one
    numpy-seeded state;
11. fast tier: the 256^3 sphere step with ``fast_spectral=True`` (the
    fused-curl route: ``fft_greens_curl_ifft_pass`` and
    ``irfft_pass_merge_velocity`` in place of the z conv, the c2r merge and
    the curl) timed in turns with the exact tier, with launch counts, and
    the 64^3 Cd at t* = 2 on the fast tier against phase 6's;
12. multibody main path: the (128, 128, 256) rod + sphere FSI step
    (``cases._build_multibody_bench_case``, fast tier, per-body sparse
    windows, dynamic substeps, order-1 filter), 5 warm-up + 20 timed steps
    with every kernel's launch count, 3 steps with their host syncs
    counted, a profiled window (written to
    ``build/multibody_profile.txt``), and the exact tier in turns;
13. multibody physics: the same case at (64, 64, 128), the grid of
    ``doc/validation_rod_and_sphere_64x64x128.csv``, for 160 of the
    reference's 320 steps (cut to keep the script near 650 s) on the fast
    tier, the rod tip and the sphere's x-force against the JAX package's
    CPU trajectory
    (``sopht_mpi_tpu_torch/data/multibody_reference.json``);
14. multibody card vs CPU: 3 steps of the (32, 32, 64) case from one
    numpy-seeded state, the fast tier on the card against the plain passes
    on the CPU;
15. fused edges: the fused forward pass ``rfft_fft_pass_fused`` against its
    plain version at the 256^3 solve's slabs and the rod grid's, each with
    the plan ``fused_r2c_cluster_plan`` gives (the thread-block-cluster
    kernel at both), and at (3, 48, 32), (3, 32, 48) and (2, 512, 512)
    slabs, where the plan is the dense-x kernel's; the fused inverse pass
    ``ifft_irfft_pass_fused`` the same way on those slabs' (A, 2 ny, nx)
    pairs, with the plan ``fused_c2r_cluster_plan`` gives (its cluster
    kernel at the first two, its dense-x kernel at the other three); the
    unsplit x passes (``rfft_pass_padded``,
    ``irfft_pass_truncated``) in 20 round trips of the 256^3 solve's rows;
    the 256^3 vector solve with ``cuda_fft.USE_FUSED_EDGE_PASSES`` on
    (``rfft_fft_pass_fused``, ``ifft_irfft_pass_fused`` in place of the four
    unfused edge passes) against the flag off, values and times; and the
    256^3 sphere step with the flag on timed in turns with the flag off,
    with launch counts and no host sync, each run followed by 3 profiled
    steps for its device time (``build/sphere_fused_edges_profile.txt``,
    ``build/sphere_unfused_edges_profile.txt``); the flag is restored
    whatever happens, and a slower fused arm is a result, not a failure;
16. 2D main path: the (256, 512) Re = 200 flow-past-cylinder step
    (``cases._build_cylinder_fsi_case``, 60 markers, dense IBM path,
    Poisson solve on the 2D kernel route), 5 warm-up + 20 timed steps that
    must not synchronise with the host, launch counts, and a profiled window
    (written to ``build/cylinder_profile.txt``);
17. 2D physics: the Lamb-Oseen vortex at 256^2 from t = 1.0 to 1.2 (CFL
    0.1, free stream (1, 1)) against the analytic vortex and against the
    same run on the dense ``torch.fft`` route; the (256, 512) cylinder's Cd
    after a fixed number of steps against the JAX package's CPU run
    (``sopht_mpi_tpu_torch/data/cylinder_reference.json``);
18. 2D card vs CPU: 3 steps of the (32, 64) cylinder case from one
    numpy-seeded state;
19. sharded kernels: the four sharded stencils (one launch for all shards
    of an in-process (pz, py) mesh, after the halo exchange) against their
    plain versions and against their single-device twins on the assembled
    field: float32 and float64 at (3, 34, 66, 65) on (2, 2), (2, 3) and
    (17, 1), float64 at 64^3, float32 at 64^3 on (64, 1) (one-plane
    shards), float32 at 256^3 on (8, 1), (4, 2) and (2, 2), with wrapper,
    plain and twin times at the last; there also the z-marching curl's and
    transport's plans and times in a batch (wrapper, kernel alone) and the
    exchange of one field's two z planes and two y rows;
20. sharded solve: the 256^3 vector Poisson solve on a (2, 2) mesh (the
    distributed convolve: ``torch.fft`` along x, the y and z pass kernels
    per shard, four ``all_to_all`` transposes) against the single-device
    kernel route, values, times, launches and transposes;
21. sharded main path: ``cases.sharded_flow_case`` at 256^3 on a (2, 2)
    mesh and on one device from the same field: the fields after 3 steps
    against each other, 5 warm-up + 20 timed steps of each that must not
    synchronise with the host, launch counts of the sharded stencils and
    the per-shard passes, halo exchanges and transposes a step, peak
    memory, a profiled window (``build/sharded_flow_profile.txt``); then
    the same with the order-1 multiplicative filter, whose step runs the
    sharded diffusion kernel alone and gathers the field once for the
    filter and the sponge;
22. sharded card vs CPU: 3 steps of the (16, 32, 128) case on a (4, 2)
    mesh from one numpy-seeded state;
23. filter plans: the multiplicative filter's z-marching kernel
    (``mult_filter_zmarch_kernel``) under every tile, ring depth and z
    chunk count its launcher takes, with no orig, with orig the field
    itself and with another orig, against the plain passes at (3, 17, 33,
    65), the rod's shape and 256^3 (float32) and (3, 34, 66, 64) (float64);
    the convolution filter's (``conv_filter_zmarch_kernel``) the same way
    at orders 1 ... 5 at (3, 17, 33, 65) and (3, 34, 66, 64), 1 and 5 at
    the rod's shape;
24. freely rotating rod: ``cases._build_freely_rotating_rod_case`` at the
    example's default (64, 64, 128) (float32 flow, float64 rod, the order-5
    convolution filter, dynamic substeps, dense IBM path) for 20 steps with
    one filter launch a step, the first 3 against the port's CPU run from
    the same state, the rod tip against the JAX package's CPU trajectory
    (``sopht_mpi_tpu_torch/data/freely_rotating_rod_reference.json``), and
    3 profiled steps (``build/free_rod_profile.txt``);
25. passive 3D: the point source of
    ``cases.point_source_advection_diffusion_case`` (``passive_vector``,
    plain torch, no hand-written kernel) at 64^3 run to t = 5.4 in windows
    of 100 steps, its L2 error against the analytic field within 5% of the
    JAX package's CPU run of the example
    (``sopht_mpi_tpu_torch/data/point_source_reference.json``); 3 steps of a
    seeded 32^3 ``passive_vector`` and ``passive_scalar`` state against the
    port's CPU run; the example's default 128^3 for 5 warm-up + 20 timed
    steps that must not synchronise with the host, and 3 profiled steps
    (``build/point_source_profile.txt``);
26. 2D rod: ``cases.flow_past_rod_2d_case`` (float32 flow, float64 rod,
    element-centric forcing grid, dynamic substeps, dense IBM path, the 2D
    route's three pass kernels) at (256, 512) for 5 warm-up + 20 timed
    steps with launch counts, host syncs counted on 3 more steps and 3
    profiled steps (``build/rod_2d_profile.txt``); at (64, 128) the tip
    against the JAX package's CPU trajectory
    (``sopht_mpi_tpu_torch/data/rod_2d_reference.json``) and the first 3
    steps against the port's CPU run;
27. sedimenting sphere: ``cases.sedimenting_sphere_case`` at the example's
    64^3 float64 (one dynamic rigid body, sparse window, the Poisson solve
    on the dense ``torch.fft`` route, which float64 takes) for 20 steps with
    every window covering its support, launch counts and 3 profiled steps
    (``build/sedimenting_sphere_profile.txt``); the sphere's z position and
    velocity against the JAX package's CPU trajectory
    (``sopht_mpi_tpu_torch/data/sedimenting_sphere_reference.json``); 3
    steps at 32^3 against the port's CPU run;
28. io: the native async dumper (``AsyncFieldDumper``, built by ``g++``
    from ``sopht_mpi_tpu_torch/csrc/async_dump.cpp`` into
    ``build/sopht_mpi_tpu_torch/``) writes a 256^3 float32 vector field from
    the card that loads back equal; a ``CarryCheckpointer`` save and restore
    of the 256^3 sphere carry (its Green's pair included), 5 steps from the
    restored carry against 5 from the original, gated at the gap between two
    unbroken 5-step runs (bit-equal where that gap is 0, else within 10
    times it), the save and restore times; ``measure_op_time`` on
    ``curl_3d`` at 256^3 beside phase 3's event median;
29. sphere driver: ``examples_torch/3d/flow_past_sphere.py``'s fused loop
    at the example's 128^3 (windows of 100 steps) with a snapshot at every
    window end, in turns with the same run without snapshots: each
    snapshot equals the carry at its window's end, ``times.csv`` holds the
    windows' times, each step launches ``fft_greens_ifft_pass`` and
    ``irfft_pass_merge`` once, and the snapshots' cost a window (the
    writer's own time and the window's wall time against the run without);
30. freely rotating rod restart: ``examples_torch/3d/
    flow_past_freely_rotating_rod.py``'s fused loop at the example's
    default (64, 64, 128) with the ``carry`` checkpoint backend, run to t =
    0.02 and restarted in fresh objects to 0.04, against an unbroken run to
    0.04: the two unbroken runs and the restarted run bit-equal; the
    restarted run launches ``conv_filter_zmarch_kernel`` once a step (order
    5);
31. 3D rod driver: ``examples_torch/3d/flow_past_rod.py``'s fused loop at
    the example's default (128, 32, 128) (n_elem 40, float64 rod, the
    sparse window, the order-1 multiplicative filter) in windows of 10
    steps to t = 0.02, first with ``suggest_rod_forcing_window`` wrapped to
    give a window too small for the rod (it trips in the first window, is
    regrown and the window replayed), then twice with the grown window from
    the start: the replayed run equals the grown-window run bit for bit,
    and the two grown-window runs each other; every kernel of the rod path
    at least once a step;
32. rod and sphere driver: ``rod_and_sphere.py`` at its default (32, 32,
    64) to t = 0.05 in windows of 20, the rod path's kernels at least once a
    step;
33. sedimenting sphere driver: ``sedimenting_sphere.py`` at 64^3 float64 to
    one relaxation time, the sphere path's three stencils at least once a
    step and no FFT pass (the float64 solve takes ``torch.fft``);
34. Lamb-Oseen driver: ``examples_torch/2d/lamb_oseen_vortex.py`` at 256^2,
    the fused loop and the host loop from t = 1.0 to 1.4, their L2 errors
    within 5% of each other, the 2D route's three passes launched;
35. cylinder driver: ``flow_past_cylinder.py`` at (256, 512), the fused
    loop in windows of 100 to t* = 2 (each of the 2D route's passes once a
    step) and the host loop to t* = 1 with its drag file;
36. 2D rod driver: ``flow_past_rod.py`` at (256, 512), the fused loop in
    windows of 20 to t* = 0.05 (each of the 2D route's passes once a step)
    and the host loop to t* = 0.025 (without ``--save-flow-data``: the
    script does not need h5py; the CPU tests write and check those files);
37. kernel gradients: each of the 21 wrappers' gradient through its
    ``torch.autograd.Function`` (the kernel's forward, the JAX package's
    rule as the backward, plain torch) against torch autograd through its
    plain version, every tensor input differentiated (prefactors,
    ``add_vector``, ``fsv``, ``greens``, the curl symbols), at the kernel
    table's shapes (the stencils also at 64^3 float64,
    ``ifft_pass_truncated`` with its Green's fold at a (48, 32, 64) grid's
    shapes), with the forward gates' tolerances; the backward's time (CUDA
    events, median of 20) goes into each kernel row as ``backward_ms``;
38. adjoint driver: ``examples_torch/2d/adjoint_viscosity_inversion.py``
    at the example's (64, 64) and 160 steps, float32: the first value and
    gradient on the 2D kernel route within 1e-3 relative of the dense
    route's, each of the route's three passes launched once a rollout step
    (the backward launches none); an inversion at the JAX smoke test's
    settings on the kernels recovering nu to 5%; the float64 driver's
    history on the card over 4 iterations of those settings within 1e-8
    relative of the CPU's; s/iteration and
    peak memory;
39. sphere gradient: the gradient of ``sum u^2`` after 2 steps of the
    256^3 sphere case w.r.t. the initial vorticity, the kernel path
    (exact tier) against the plain path (plain stencils, dense solve) to
    1e-3 relative L2, run twice (bit-equal or not, peak memory, forward
    launches only); 1 step each on the fast tier and with
    ``USE_FUSED_EDGE_PASSES``; the flow-only step on a (2, 2) mesh at
    128^3 against one device;
40. mesh dryrun: ``cases.dryrun_multichip((4, 2))`` on the card, the eight
    rows of the JAX package's multi-device gate (the rigid sphere, the rod's
    vorticity and tip, the rod's sparse window against the dense path on
    the mesh, the rod and sphere, the bit-exact checkpoint restart, the
    kernel fork against the plain fork) on an in-process (4, 2) mesh
    against one device, and the (4, 2) sparse rod case's vorticity after 3
    steps on the card against the same case on the CPU;
41. sharded sphere fsi: the main path's case, ``cases._build_fsi_case`` at
    256^3 on an in-process (2, 2) mesh (the sparse 72^3 window, float32,
    exact tier) against the same case on one device: vorticity, velocity
    and the summed marker force after 3 steps; 5 warm-up + 20 timed steps
    of each that must not synchronise with the host, the four sharded
    kernels' and the z conv's launches at least once a step, the step's
    collectives exactly those of its flow step plus one ``psum`` (the
    windowed E->L) and no assembled-field call, s/step against one device,
    device ms and kernels a step (3 profiled steps,
    ``build/sharded_sphere_profile.txt``) and peak memory.

Phases 31-36 print s/step (the windows after the first) and a window's
wall. The phases from 28 on run in ``build/`` and remove what they write.

Phase 3 also checks the fused-curl pair against its plain versions at the
256^3 sphere's, the (128, 128, 256) multi-body case's, the 64^3 drag run's
and the (48, 32, 64) and (32, 32, 48) grids' shapes (the fast tier's z pass
at m = 512, 256, 128, 64 on its ring kernel and m = 96 on its four-step
one; its c2r ``irfft_pass_merge_velocity`` at m = 512, 128 on its ring
kernel and m = 96 on its four-step one), the unsplit x
passes and the fused edge passes at the 256^3
solve's, a (48, 32, 64) grid's and the (256, 512) cylinder grid's shapes,
and the 2D route's three passes at the cylinder grid's shapes, and the
forward r2c pair (``rfft_pass_padded_split``, ``rfft_pass_padded``) and
the c2r pair (``irfft_pass_merge``, ``irfft_pass_truncated``) on ragged row
counts, inputs 4 bytes off 16-byte alignment, odd output counts, the 2D
route's m = 1024 and the four-step kernel's lengths (m = 96, 544), and the
z conv (``fft_greens_ifft_pass``) on ``ZCONV_CASES``: ragged column counts,
storage-offset inputs, A = 1, the 2D route's shape and every length class
(m = 64 ... 512 on the ring kernel, 96, 544, 1024 on the four-step one). The
line before the last is the kernel table as JSON (each kernel's launches on
a main path, error, kernel / plain / one-PyTorch-call times, its bound at
the main path's shape and its backward's time, phase 37); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "sopht_mpi_tpu_torch/csrc/stencils_3d.cu"
FFT_SOURCE = "sopht_mpi_tpu_torch/csrc/fft_passes.cu"
REPLACES = {
    "rotational_curl_add_3d": "sopht_mpi_tpu/ops/pallas_stencils_3d.py:683",
    "diffusion_penalise_vector_3d": "sopht_mpi_tpu/ops/pallas_stencils_3d.py:1324",
    "curl_3d": "sopht_mpi_tpu/ops/pallas_stencils_3d.py:645",
    "diffusion_timestep_vector_3d": "sopht_mpi_tpu/ops/pallas_stencils_3d.py:606",
    "laplacian_filter_vector_3d": "sopht_mpi_tpu/ops/pallas_stencils_3d.py:922",
    "penalise_field_boundary_vector_3d":
        "sopht_mpi_tpu/ops/pallas_stencils_3d.py:1144",
}
# the kernels of the sphere path; the rod path runs the filtered-transport
# trio in place of diffusion_penalise_vector_3d
SPHERE_KERNELS = ("rotational_curl_add_3d", "diffusion_penalise_vector_3d",
                  "curl_3d")
TRANSPORT_KERNELS = ("diffusion_timestep_vector_3d",
                     "laplacian_filter_vector_3d",
                     "penalise_field_boundary_vector_3d")
ROD_SHAPE = (3, 256, 64, 256)
# the freely rotating rod's default grid, its field's shape and filter
FREE_ROD_GRID = (64, 64, 128)
FREE_ROD_SHAPE = (3, *FREE_ROD_GRID)
FREE_ROD_ORDER = 5
# the point source: the example's default grid (timed), the grid of the
# JAX run it is held to, the card-vs-cpu grid, and the gate on its L2 error
PASSIVE_GRID = (128, 128, 128)
PASSIVE_CONV_GRID = (64, 64, 64)
PASSIVE_PARITY_GRID = (32, 32, 32)
PASSIVE_L2_TOL = 0.05
# the 2D rod at the example's default (timed)
ROD_2D_GRID = (256, 512)
# the sedimenting sphere at the example's default, its card-vs-cpu grid,
# and the gates on its trajectory against the JAX package's float64 run:
# z velocity relative to its largest value, z position in box lengths
SEDIMENT_GRID = (64, 64, 64)
SEDIMENT_PARITY_GRID = (32, 32, 32)
SEDIMENT_VZ_TOL = 1e-8
SEDIMENT_Z_TOL = 1e-10
# phase 28: the dumped field and the sphere carry; the gate on a restarted
# run against the gap between two unbroken runs (0: bit-equal)
IO_GRID = (256, 256, 256)
RESTART_FLOOR_FACTOR = 10.0
# phase 29: the sphere driver at the example's grid, run to this t*
SPHERE_DRIVER_GRID = (128, 128, 128)
SPHERE_DRIVER_T = 0.5
# phase 30: the freely rotating rod driver restarted at t = 0.02, run to 0.04
FREE_ROD_RESTART_T = (0.02, 0.04)
# phases 31-36, the drivers at their examples' default grids: the 3D rod's
# grid, final time and scan window; rod and sphere's final time; the
# sedimenting sphere's run in relaxation times; the cylinder's and the 2D
# rod's final t* (their host loops run half as long); the bound on the
# Lamb-Oseen L2 error of the fused loop against the host loop's
ROD_DRIVER_GRID = (128, 32, 128)
ROD_DRIVER_T = 0.02
ROD_DRIVER_WINDOW = 10
ROD_SPHERE_DRIVER_T = 0.05
SEDIMENT_DRIVER_N_TAU = 1.0
CYLINDER_DRIVER_T = 2.0
ROD_2D_DRIVER_T = 0.05
LAMB_OSEEN_LOOP_RTOL = 0.05
# the convolution filter's row of the kernel table: its TPU kernel
CONV_REPLACES = "sopht_mpi_tpu/ops/pallas_stencils_3d.py:825"
# the rod tip against the JAX package's trajectory: the bound to which
# doc/validation_rod_sparse_vs_dense.json holds sparse against dense
TIP_TOL = 2e-5
# how far phases 9 and 13 follow the JAX trajectories (t = 0.2 and 320
# steps in the references): cut in half to keep the script near 650 s
ROD_PHYSICS_T = 0.1
MULTIBODY_PHYSICS_STEPS = 160
FFT_REPLACES = {
    "rfft_pass_padded_split": "sopht_mpi_tpu/parallel/pallas_fft.py:730",
    "fft_pass_padded": "sopht_mpi_tpu/parallel/pallas_fft.py:260",
    "fft_greens_ifft_pass": "sopht_mpi_tpu/parallel/pallas_fft.py:384",
    "ifft_pass_truncated": "sopht_mpi_tpu/parallel/pallas_fft.py:307",
    "irfft_pass_merge": "sopht_mpi_tpu/parallel/pallas_fft.py:757",
}
# the fast tier's fused-curl pair
FUSED_REPLACES = {
    "fft_greens_curl_ifft_pass": "sopht_mpi_tpu/parallel/pallas_fft.py:517",
    "irfft_pass_merge_velocity": "sopht_mpi_tpu/parallel/pallas_fft.py:844",
}
# the unsplit x passes and the fused edge passes
EDGE_REPLACES = {
    "rfft_pass_padded": "sopht_mpi_tpu/parallel/pallas_fft.py:657",
    "irfft_pass_truncated": "sopht_mpi_tpu/parallel/pallas_fft.py:683",
    "rfft_fft_pass_fused": "sopht_mpi_tpu/parallel/pallas_fft.py:1300",
    "ifft_irfft_pass_fused": "sopht_mpi_tpu/parallel/pallas_fft.py:1341",
}
# the four sharded stencils: the TPU kernel each replaces, its single-device
# twin (whose operation count it shares) and the fields it reads beside the
# one it writes
SHARDED_REPLACES = {
    "diffusion_timestep_vector_3d_sharded": (
        "sopht_mpi_tpu/ops/pallas_stencils_sharded.py:219",
        "diffusion_timestep_vector_3d", 1),
    "curl_3d_sharded": (
        "sopht_mpi_tpu/ops/pallas_stencils_sharded.py:297", "curl_3d", 1),
    "rotational_curl_add_3d_sharded": (
        "sopht_mpi_tpu/ops/pallas_stencils_sharded.py:379",
        "rotational_curl_add_3d", 2),
    "diffusion_penalise_vector_3d_sharded": (
        "sopht_mpi_tpu/ops/pallas_stencils_sharded.py:653",
        "diffusion_penalise_vector_3d", 1),
}
SHARDED_GRID = (256, 256, 256)
SHARDED_MESH = (2, 2)
# phase 41: the main path's sparse window at SHARDED_GRID (cells an axis)
SHARDED_SPHERE_WINDOW = (72, 72, 72)
# phase 40: the mesh and base grid of cases.dryrun_multichip
DRYRUN_MESH = (4, 2)
DRYRUN_GRID = (32, 32, 32)
# the distributed convolve's three per-shard passes and their launches a
# vector solve on SHARDED_MESH: the y passes fold every shard into one
# launch, the z pass is launched once a shard with that shard's Green's block
SHARDED_FFT_LAUNCHES = {"fft_pass_padded": 1, "fft_greens_ifft_pass": 4,
                        "ifft_pass_truncated": 1}
# the forward r2c pair's extra checks (rows, n_in, m, storage offset in
# floats): ragged last tiles, inputs 4 bytes off 16-byte alignment (no bulk
# copies), the 2D route's m = 1024 and lengths of the four-step kernel
R2C_CASES = ((203, 256, 512, 0), (61, 255, 512, 1), (256, 512, 1024, 0),
             (5, 511, 1024, 1), (9, 3, 64, 0), (37, 48, 96, 0),
             (40, 272, 544, 3))
# the c2r pair's extra checks, the same (rows, n_out, m, storage offset)
# with n_out the real rows' length: odd n_out among them
C2R_CASES = R2C_CASES
# the z conv's extra checks (A, m/2, B, storage offset in floats): ragged
# last tiles, inputs 4 bytes off 16-byte alignment (4-byte copies), the 2D
# route's (1, 256, 512), A = 1, the ring kernel's other lengths (m = 64,
# 128, 256) and the four-step kernel's (m = 96, 544, 1024)
ZCONV_CASES = ((3, 256, 1001, 0), (3, 256, 4100, 1), (1, 256, 512, 0),
               (1, 256, 4096, 0), (3, 128, 999, 2), (3, 64, 4096, 0),
               (3, 32, 333, 1), (3, 48, 333, 0), (3, 272, 200, 1),
               (3, 512, 777, 0))
FUSED_EDGE_PASSES = ("rfft_fft_pass_fused", "ifft_irfft_pass_fused")
UNFUSED_EDGE_PASSES = ("rfft_pass_padded_split", "fft_pass_padded",
                       "ifft_pass_truncated", "irfft_pass_merge")
# the 2D route's three passes
ROUTE_2D = ("rfft_pass_padded_split", "fft_greens_ifft_pass",
            "irfft_pass_merge")
CYLINDER_GRID = (256, 512)
# the exact tier's kernels that the fused route replaces
EXACT_ONLY = ("curl_3d", "fft_greens_ifft_pass", "irfft_pass_merge")
MULTIBODY_GRID = (128, 128, 256)
# the card's peak rates (NVIDIA's data sheet, H100 SXM): HBM3 bytes/s and
# FP32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FFT passes against torch.fft: float32 rounding of two differently
# factored length-m DFTs grows like log m; the JAX package holds its passes
# to 2e-6 of numpy's at m <= 128, and m = 512 here
FFT_TOL = 5e-6
# the grid of the kernel table's 256^3 shapes (phase 37's gradients)
TABLE_GRID = (256, 256, 256)
# phases 38-39, reverse mode: the adjoint driver at the example's defaults
# (grid, rollout steps) and at the JAX smoke test's settings; the gates on
# the float32 kernel route's first value and gradient against the dense
# route's, on the recovered nu, and on the card's float64 history against
# the CPU's; the 256^3 sphere gradient of the kernels against the plain
# path's (relative L2), and the sharded flow step's at 128^3 against one
# device's (of the largest value)
ADJOINT_GRID = (64, 64)
ADJOINT_STEPS = 160
ADJOINT_SMOKE = dict(grid_size=(32, 32), n_steps=60, iters=16,
                     learning_rate=0.2)
ADJOINT_ROUTE_TOL = 1e-3
ADJOINT_NU_TOL = 0.05
ADJOINT_F64_TOL = 1e-8
# the float64 card-vs-CPU histories: the smoke settings, fewer iterations
ADJOINT_F64_ITERS = 4
SPHERE_GRAD_GRID = (256, 256, 256)
SPHERE_GRAD_TOL = 1e-3
SHARDED_GRAD_GRID = (128, 128, 128)
SHARDED_GRAD_TOL = 1e-4
# Cd at t* = 2 of the 64^3 fused sphere case
# (doc/validation_sphere_cd_convergence.json, grids["64"]["cd_t2"])
CD_T2_64 = 1.34141910580261


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    """Decorator: run, print ``[name] ok (t s) detail``; failures propagate."""

    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            detail = out[1] if isinstance(out, tuple) else ""
            print(f"[{name}] ok ({time.perf_counter() - t0:.2f} s) {detail}",
                  flush=True)
            return out[0] if isinstance(out, tuple) else out

        return run

    return wrap


def median_ms(torch, fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[n // 2]


def bound(nbytes, ops):
    """The least time the card could take: (ms, "bytes" or "operations"),
    the larger of the bytes over the HBM rate and the FP32 operations over
    the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def fft_ops(m):
    """Operations of one complex transform of length m (5 m log2 m)."""
    import math

    return 5.0 * m * math.log2(m)


# operations a cell of each stencil kernel does (3 components, float32),
# counted from its formula: rotational transport 6 products of the cross
# product at 4 neighbours a component and the differences; the 7-point
# Laplacian and its update; the curl's 4 differences and scale a
# component with the free stream and the |u| sum; the 27-point
# multiplicative filter as three 3-point passes; the sponge's ramp
STENCIL_OPS = {
    "rotational_curl_add_3d": 51, "diffusion_penalise_vector_3d": 42,
    "curl_3d": 25, "diffusion_timestep_vector_3d": 30,
    "laplacian_filter_vector_3d": 45, "penalise_field_boundary_vector_3d": 9,
}


def conv_filter_work(shape, order):
    """(bytes, operations) of the convolution filter of ``order`` on a (3,
    nz, ny, nx) float32 field: the field read once, the result written once;
    a cell's three stages of ``order`` high-passes (4 operations each) and a
    subtraction, a component each."""
    cells = shape[1] * shape[2] * shape[3]
    return 4 * 3 * cells * 2, 9 * (4 * order + 1) * cells


def stencil_work(name, shape, nfields_in):
    """(bytes, operations) of a stencil kernel on (3, nz, ny, nx) float32
    fields: each input field read once, the output written once."""
    cells = shape[1] * shape[2] * shape[3]
    return 4 * 3 * cells * (nfields_in + 1), STENCIL_OPS[name] * cells


def sharded_stencil_work(name, grid, mesh):
    """(bytes, operations) of a sharded stencil on a float32 ``grid`` over a
    (pz, py) mesh, all shards: every input field read once with its width-1
    halo planes and rows (as the exchange hands them over), the output
    written once, the twin kernel's operations a cell."""
    nz, ny, nx = grid[0] // mesh[0], grid[1] // mesh[1], grid[2]
    cells, halo_cells = nz * ny * nx, (nz + 2) * (ny + 2) * nx
    _, twin, n_in = SHARDED_REPLACES[name]
    shards = mesh[0] * mesh[1]
    return (12 * (n_in * halo_cells + cells) * shards,
            STENCIL_OPS[twin] * cells * shards)


def fft_work(name, args):
    """(bytes, operations) of an FFT pass on its arguments: each input byte
    read once, each output byte written once, 5 m log2 m operations a
    complex transform (half that for a real one)."""
    if name == "rfft_pass_padded_split":
        x, m = args
        r, n_in = x.shape
        return 4 * r * n_in + 8 * r * (m // 2 + 1), 0.5 * fft_ops(m) * r
    if name == "fft_pass_padded":
        xr, _, m = args
        a, h, b = xr.shape
        return 8 * a * b * (h + m), fft_ops(m) * a * b
    if name == "fft_greens_ifft_pass":
        xr, _, g = args
        a, h, b = xr.shape
        m = 2 * h
        return 16 * a * h * b + 4 * m * b, (2 * fft_ops(m) + 2 * m) * a * b
    if name == "ifft_pass_truncated":
        xr, _ = args[:2]
        a, m, b = xr.shape
        return 8 * a * b * (m + m // 2), fft_ops(m) * a * b
    if name == "irfft_pass_merge":
        # the Nyquist column's imaginary part is not read
        br, _, _, _, m, n_out = args
        r = br.shape[0]
        return 8 * r * (m // 2) + 4 * r + 4 * r * n_out, 0.5 * fft_ops(m) * r
    if name == "fft_greens_curl_ifft_pass":
        xr, _, g, sym_z, sym_yx = args
        _, h, b = xr.shape
        m = 2 * h
        nbytes = 2 * 24 * h * b + 4 * m * b + 4 * (m + 2 * b)
        # three transforms each way, the Green's product and the curl
        return nbytes, 3 * b * 2 * fft_ops(m) + 24 * m * b
    if name == "rfft_pass_padded":
        x, m = args
        r, n_in = x.shape
        return 4 * r * n_in + 8 * r * (m // 2 + 1), 0.5 * fft_ops(m) * r
    if name == "irfft_pass_truncated":
        xr, _, m, n_out = args
        r = xr.shape[0]
        return 8 * r * (m // 2 + 1) + 4 * r * n_out, 0.5 * fft_ops(m) * r
    if name == "rfft_fft_pass_fused":
        # the least work of the function: a factored x r2c of each row and
        # a factored y transform of each bulk column (the kernel's dense x
        # sums do more)
        x, mx, my = args
        a, ny, nx = x.shape
        nbytes = 4 * a * ny * nx + 8 * a * my * (mx // 2) + 8 * a * ny
        return nbytes, a * (ny * 0.5 * fft_ops(mx) + (mx // 2) * fft_ops(my))
    if name == "ifft_irfft_pass_fused":
        br, _, _, _, mx, nx = args
        a, my, bx = br.shape
        # the Nyquist column's imaginary part is not read
        nbytes = 8 * a * my * bx + 4 * a * (my // 2) + 4 * a * (my // 2) * nx
        return nbytes, a * ((my // 2) * 0.5 * fft_ops(mx) + bx * fft_ops(my))
    assert name == "irfft_pass_merge_velocity"
    br, _, _, _, _, m, n_out, _, _ = args
    r = br.shape[1]
    nbytes = 24 * r * (m // 2) + 12 * r + 12 * r * n_out + 16
    return nbytes, 3 * r * 0.5 * fft_ops(m) + 9 * r * n_out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "sopht_mpi_tpu_torch")):
        print("chip_smoke: the sopht_mpi_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from sopht_mpi_tpu_torch import cases
    from sopht_mpi_tpu_torch.convert import flow_state_from_numpy
    from sopht_mpi_tpu_torch.models import (
        UnboundedFlowSimulator3D,
        build_flow_only_step,
        init_flow_only_carry,
        scan_steps,
    )
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as kernels
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
    from sopht_mpi_tpu_torch.ops import poisson
    from sopht_mpi_tpu_torch.parallel import collectives, cuda_fft
    from sopht_mpi_tpu_torch.parallel.mesh import (
        create_mesh,
        shard_vector_field,
        unshard_vector_field,
    )
    from sopht_mpi_tpu_torch.tools.probe_sharded import (
        batched_ms as sharded_batched_ms,
        exchange as sharded_exchange,
        kernel_alone as sharded_kernel_alone,
        stencil_calls as sharded_stencil_calls,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)

    @phase("device")
    def device_phase():
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", "--id=0"],
                capture_output=True, text=True, timeout=60, check=True,
            ).stdout.strip()
        except FileNotFoundError:
            smi = f"{kind}, power limit not readable (no nvidia-smi)"
        print(smi, flush=True)
        return smi, f"{kind}; {torch.cuda.device_count()} device(s); torch " \
                    f"{torch.__version__}, CUDA {torch.version.cuda}"

    card = device_phase()

    @phase("build")
    def build_phase():
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            libs = list(pool.map(lambda load: load(),
                                 (kernels.library, cuda_fft.library)))
        for src, lib in zip((SOURCE, FFT_SOURCE), libs):
            for ln in lib.build_log.splitlines():
                if ("Compiling entry" in ln or "registers" in ln or (
                        "spill" in ln and "0 bytes spill stores, 0 bytes "
                        "spill loads" not in ln)):
                    print(f"  {os.path.basename(src)}: {ln.strip()}")
        return libs, (f"nvcc sm_90a from {SOURCE} and {FFT_SOURCE} in "
                      f"{time.perf_counter() - t0:.2f} s")

    build_phase()

    def max_err(out, ref):
        return float((out - ref).abs().max()), float(ref.abs().max())

    def run_kernel_checks(shape, dtype, gen):
        w = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
        u = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
        p = torch.tensor(0.05, dtype=dtype, device=dev)
        add = torch.tensor([1.0, -0.5, 0.25], dtype=dtype, device=dev)
        calls = {
            "rotational_curl_add_3d": (
                lambda: kernels.rotational_curl_add_3d(w, u, p),
                lambda: kernels.rotational_curl_add_3d_ref(w, u, p)),
            "diffusion_penalise_vector_3d": (
                lambda: kernels.diffusion_penalise_vector_3d(w, p, 2),
                lambda: kernels.diffusion_penalise_vector_3d_ref(w, p, 2)),
            "curl_3d": (
                lambda: kernels.curl_3d(w, p, add, True),
                lambda: kernels.curl_3d_ref(w, p, add, True)),
        }
        return check_calls(calls, shape, dtype)

    def transport_calls(shape, dtype, gen):
        """The filtered-transport trio at ``shape``: diffusion, the filter
        (multiplicative orders 1 and 2; convolution orders 1, 2 and 5 on
        conv_filter_zmarch_kernel, one launch a call, and 6 on the line
        route above its instances, conv_filter_line_kernel and
        conv_filter_z_pass_kernel, 2 + 6 launches) and the sponge (width 2,
        where the shape has more than 4 cells an axis)."""
        w = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
        p = torch.tensor(0.13, dtype=dtype, device=dev)
        calls = {
            "diffusion_timestep_vector_3d": (
                lambda: kernels.diffusion_timestep_vector_3d(w, p),
                lambda: kernels.diffusion_timestep_vector_3d_ref(w, p)),
        }
        if kernels.penalise_supported(shape, 2):
            calls["penalise_field_boundary_vector_3d"] = (
                lambda: kernels.penalise_field_boundary_vector_3d(w, 2),
                lambda: kernels.penalise_field_boundary_vector_3d_ref(w, 2))
        # the main path's filter first: its entry carries the kernel's name
        for ftype, order in (("multiplicative", 1), ("multiplicative", 2),
                             ("convolution", 1), ("convolution", 2),
                             ("convolution", 5), ("convolution", 6)):
            name = "laplacian_filter_vector_3d"
            if (ftype, order) != ("multiplicative", 1):
                name += f" {ftype} {order}"
            calls[name] = (
                lambda f=ftype, o=order: kernels.laplacian_filter_vector_3d(
                    w, o, f),
                lambda f=ftype, o=order:
                    kernels.laplacian_filter_vector_3d_ref(w, o, f))
        filt = kernels.laplacian_filter_vector_3d
        for order, launches in ((1, 1), (2, 1), (5, 1), (6, 2 + 6)):
            before = filt.launches
            filt(w, order, "convolution")
            check(filt.launches - before == launches,
                  f"convolution filter order {order} at {shape}: "
                  f"{filt.launches - before} launches, not {launches}")
        return check_calls(calls, shape, dtype)

    def check_calls(calls, shape, dtype):
        errs = {}
        for name, (fn, ref_fn) in calls.items():
            out, ref = fn(), ref_fn()
            if name == "curl_3d":
                (out, l1), (ref, l1_ref) = out, ref
                rel = abs(float(l1) - float(l1_ref)) / float(l1_ref)
                check(rel <= 1e-6, f"curl_3d l1_max {shape} {dtype}: rel {rel}")
            err, scale = max_err(out, ref)
            tol = 1e-12 if dtype == torch.float64 else 1e-5 * max(1.0, scale)
            check(err <= tol, f"{name} {shape} {dtype}: max|diff| {err} > {tol}")
            errs[name] = err
        torch.cuda.synchronize()
        return calls, errs

    def fft_pass_args(grid, gen):
        """Each FFT pass's inputs at the shapes the vector solve of a
        (nz, ny, nx) grid gives it (3 components, doubled axes)."""
        nz, ny, nx = grid
        c, mz, my, mx = 3, 2 * nz, 2 * ny, 2 * nx

        def r(*shape):
            return torch.randn(shape, dtype=torch.float32, device=dev,
                               generator=gen)

        rows = c * nz * ny
        return {
            "rfft_pass_padded_split": (r(rows, nx), mx),
            "fft_pass_padded": (r(c * nz, ny, nx), r(c * nz, ny, nx), my),
            "fft_greens_ifft_pass": (r(c, nz, my * nx), r(c, nz, my * nx),
                                     r(1, mz, my * nx)),
            "ifft_pass_truncated": (r(c * nz, my, nx), r(c * nz, my, nx)),
            "irfft_pass_merge": (r(rows, nx), r(rows, nx), r(rows, 1),
                                 r(rows, 1), mx, nx),
        }

    def edge_pass_args(grid, gen, c=3):
        """The unsplit x passes' and the fused edge passes' inputs at the
        shapes the solve of ``c`` components on a (nz, ny, nx) grid gives
        them (nz = 1: one slab a component)."""
        nz, ny, nx = grid
        my, mx = 2 * ny, 2 * nx

        def r(*shape):
            return torch.randn(shape, dtype=torch.float32, device=dev,
                               generator=gen)

        rows, a = c * nz * ny, c * nz
        return {
            "rfft_pass_padded": (r(rows, nx), mx),
            "irfft_pass_truncated": (r(rows, nx + 1), r(rows, nx + 1), mx, nx),
            "rfft_fft_pass_fused": (r(a, ny, nx), mx, my),
            "ifft_irfft_pass_fused": (r(a, my, nx), r(a, my, nx), r(a, ny, 1),
                                      r(a, ny, 1), mx, nx),
        }

    def route_2d_args(grid, gen):
        """The 2D route's three passes at a (ny, nx) grid's shapes."""
        ny, nx = grid

        def r(*shape):
            return torch.randn(shape, dtype=torch.float32, device=dev,
                               generator=gen)

        return {
            "rfft_pass_padded_split": (r(ny, nx), 2 * nx),
            "fft_greens_ifft_pass": (r(1, ny, nx), r(1, ny, nx),
                                     r(1, 2 * ny, nx)),
            "irfft_pass_merge": (r(ny, nx), r(ny, nx), r(ny, 1), r(ny, 1),
                                 2 * nx, nx),
        }

    def check_pass_calls(where, calls):
        """Each (kernel, plain version) pair of ``calls`` agrees within
        ``FFT_TOL`` of the plain outputs' largest magnitude: the errors."""
        errs = {}
        for name, (fn, ref_fn) in calls.items():
            out, ref = fn(), ref_fn()
            out = out if isinstance(out, tuple) else (out,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            check(len(out) == len(ref) and all(
                o.shape == q.shape for o, q in zip(out, ref)),
                f"{name} {where}: output shapes differ")
            err = max(float((o - q).abs().max()) for o, q in zip(out, ref))
            scale = max(float(q.abs().max()) for q in ref)
            check(err <= FFT_TOL * scale,
                  f"{name} {where}: max|diff| {err} > {FFT_TOL} * {scale}")
            errs[name] = err
        torch.cuda.synchronize()
        return errs

    def run_pass_checks(where, args):
        """Each pass of ``args`` against its plain version: (calls, errs)."""
        calls = {
            name: (lambda f=getattr(cuda_fft, name), a=a: f(*a),
                   lambda f=getattr(cuda_fft, name + "_ref"), a=a: f(*a))
            for name, a in args.items()
        }
        return calls, check_pass_calls(where, calls)

    def run_fft_checks(grid, gen, args=None):
        calls, _ = run_pass_checks(grid, args or fft_pass_args(grid, gen))
        a, m, b = 3 * grid[0], 2 * grid[1], grid[2]
        for lead in (1, a):  # the optional Green's fold, shared and not
            xr, xi, g = (torch.randn(shape, device=dev, generator=gen)
                         for shape in ((a, m, b), (a, m, b), (lead, m, b)))
            calls[f"ifft_pass_truncated greens ({lead}, m, B)"] = (
                lambda x=(xr, xi, g): cuda_fft.ifft_pass_truncated(*x),
                lambda x=(xr, xi, g): cuda_fft.ifft_pass_truncated_ref(*x))
        return calls, check_pass_calls(grid, calls)

    def fused_pair_args(grid, gen):
        """The fused-curl pair's inputs at the shapes the fast-tier velocity
        recovery of a (nz, ny, nx) grid gives them, with the grid's curl
        symbols (unit x range)."""
        nz, ny, nx = grid
        doubled = (2 * nz, 2 * ny, 2 * nx)

        def r(*shape):
            return torch.randn(shape, dtype=torch.float32, device=dev,
                               generator=gen)

        sym_z, _, sym_yx = poisson._curl_symbols(doubled, 1.0 / nx, dev)
        b, rows = 2 * ny * nx, nz * ny
        return {
            "fft_greens_curl_ifft_pass": (r(3, nz, b), r(3, nz, b),
                                          r(1, 2 * nz, b), sym_z, sym_yx),
            "irfft_pass_merge_velocity": (
                r(3, rows, nx), r(3, rows, nx), r(3, rows, 1), r(3, rows, 1),
                torch.tensor([1.0, -0.5, 0.25], device=dev), 2 * nx, nx, ny,
                nz),
        }

    def run_fused_checks(grid, args):
        calls, errs = {}, {}
        for name, a in args.items():
            fn = lambda f=getattr(cuda_fft, name), a=a: f(*a)
            ref_fn = lambda f=getattr(cuda_fft, name + "_ref"), a=a: f(*a)
            out, ref = fn(), ref_fn()
            check(all(o.shape == q.shape for o, q in zip(out, ref)),
                  f"{name} {grid}: output shapes differ")
            scale = max(float(q.abs().max()) for q in ref)
            err = max(float((o - q).abs().max()) for o, q in zip(out, ref))
            check(err <= FFT_TOL * scale,
                  f"{name} {grid}: max|diff| {err} > {FFT_TOL} * {scale}")
            if name == "irfft_pass_merge_velocity":
                l1_err = abs(float(out[1]) - float(ref[1])) / float(ref[1])
                check(l1_err <= FFT_TOL,
                      f"{name} {grid}: l1_max relative {l1_err} > {FFT_TOL}")
                errs["l1_max"] = l1_err
            calls[name], errs[name] = (fn, ref_fn), err
        torch.cuda.synchronize()
        return calls, errs

    def library_call(name, args):
        """One PyTorch call that computes the pass's function on its inputs
        (prepared outside the timing), or None where there is none."""
        if name == "rfft_pass_padded_split":
            x, m = args
            return lambda: torch.fft.rfft(x, n=m, dim=1)
        if name == "fft_pass_padded":
            z, m = torch.complex(args[0], args[1]), args[2]
            return lambda: torch.fft.fft(z, n=m, dim=1)
        if name == "ifft_pass_truncated":
            z = torch.complex(args[0], args[1])
            return lambda: torch.fft.ifft(z, dim=1)
        if name == "irfft_pass_merge":
            br, bi, sr, si, m, _ = args
            z = torch.complex(torch.cat([br, sr], 1), torch.cat([bi, si], 1))
            return lambda: torch.fft.irfft(z, n=m, dim=1)
        if name == "rfft_pass_padded":
            x, m = args
            return lambda: torch.fft.rfft(x, n=m, dim=1)
        if name == "irfft_pass_truncated":
            z, m = torch.complex(args[0], args[1]), args[2]
            return lambda: torch.fft.irfft(z, n=m, dim=1)
        if name == "rfft_fft_pass_fused":
            x, mx, my = args
            return lambda: torch.fft.rfft2(x, s=(my, mx))
        if name == "ifft_irfft_pass_fused":
            # the whole (A, my, mx/2 + 1) spectrum: the bulk and the Nyquist
            # column's y spectrum
            br, bi, sr, si, mx, nx = args
            my = br.shape[1]
            z = torch.cat([torch.complex(br, bi), torch.fft.fft(
                torch.complex(sr, si), n=my, dim=1)], dim=2)
            return lambda: torch.fft.irfft2(z, s=(my, mx))[:, : my // 2, :nx]
        return None

    def entry(name, source, replaces, err, fn, ref_fn, work, shape,
              library_fn=None, times=None):
        """A row of the kernel table: kernel, plain and library times
        (CUDA events) and the bound from (bytes, operations)."""
        ms, plain_ms = times or (median_ms(torch, fn), median_ms(torch, ref_fn))
        bound_ms, bound_by = bound(*work)
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if library_fn is None
            else median_ms(torch, library_fn),
            "shape": str(shape),
        }

    def line(k, v):
        lib = v["library_ms"]
        lib = "none" if lib is None else f"{lib:.4f} ms"
        return (f"{k}: err {v['max_abs_err']:.3g}, {v['ms']:.4f} ms vs "
                f"plain {v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} "
                f"ms ({v['bound_by']}), one torch call {lib} at "
                f"{v['shape']} f32")

    @phase("kernels")
    def kernel_phase():
        gen = torch.Generator(device=dev).manual_seed(0)
        table = {}
        for shape, dtype in (((3, 17, 33, 65), torch.float32),
                             ((3, 64, 64, 64), torch.float64),
                             ((3, 256, 256, 256), torch.float32)):
            calls, errs = run_kernel_checks(shape, dtype, gen)
        # the last shape is the main path's: its errors and times are kept
        for name, (fn, ref_fn) in calls.items():
            table[name] = entry(
                name, SOURCE, REPLACES[name], errs[name], fn, ref_fn,
                stencil_work(name, shape,
                             2 if name == "rotational_curl_add_3d" else 1),
                shape)
        del calls
        conv_lines = []

        def conv_line(shape, name, errs, fn, order):
            route = ("" if order in kernels.CONV_FILTER_ORDERS
                     else " (line route)")
            conv_lines.append(
                f"{name[len('laplacian_filter_vector_3d '):]}{route} at "
                f"{shape} "
                f"f32: err {errs[name]:.3g}, {median_ms(torch, fn):.4f} ms, "
                f"in a batch {sharded_batched_ms(fn):.4f} ms a call, bound "
                f"{bound(*conv_filter_work(shape, order))[0]:.4f} ms")

        for shape, dtype in (((3, 17, 33, 65), torch.float32),
                             ((3, 64, 64, 64), torch.float64),
                             ((3, 3, 3, 3), torch.float32),
                             ((3, 256, 256, 256), torch.float32),
                             (FREE_ROD_SHAPE, torch.float32),
                             (ROD_SHAPE, torch.float32)):
            calls, errs = transport_calls(shape, dtype, gen)
            if shape[1] == 256 and shape[2] == 256:
                fn = calls["laplacian_filter_vector_3d"][0]
                work = stencil_work("laplacian_filter_vector_3d", shape, 1)
                cube = (
                    f"the filter (multiplicative 1) at {shape} f32: err "
                    f"{errs['laplacian_filter_vector_3d']:.3g}, "
                    f"{median_ms(torch, fn):.4f} ms, in a batch "
                    f"{sharded_batched_ms(fn):.4f} ms a call, bound "
                    f"{bound(*work)[0]:.4f} ms")
                for order in (1, 2, 5):
                    name = f"laplacian_filter_vector_3d convolution {order}"
                    conv_line(shape, name, errs, calls[name][0], order)
                del calls, fn
            elif shape == FREE_ROD_SHAPE:
                # the freely rotating rod's filter: the table's row
                name = ("laplacian_filter_vector_3d convolution "
                        f"{FREE_ROD_ORDER}")
                fn, ref_fn = calls[name]
                table["laplacian_filter_vector_3d convolution"] = entry(
                    "laplacian_filter_vector_3d convolution", SOURCE,
                    CONV_REPLACES, errs[name], fn, ref_fn,
                    conv_filter_work(shape, FREE_ROD_ORDER), shape)
                row = table["laplacian_filter_vector_3d convolution"]
                row["kernel"] = "conv_filter_zmarch_kernel"
                row["order"] = FREE_ROD_ORDER
                row["plan"] = list(kernels.conv_filter_plan(
                    torch.empty(shape, device=dev), FREE_ROD_ORDER).args())
                row["batch_ms"] = sharded_batched_ms(fn)
                del calls, fn, ref_fn
        # the rod path's shape: errors and times kept, the other filter
        # variants' times printed
        variants = []
        for name, (fn, ref_fn) in calls.items():
            ms, plain_ms = median_ms(torch, fn), median_ms(torch, ref_fn)
            if name in REPLACES:
                table[name] = entry(
                    name, SOURCE, REPLACES[name], errs[name], None, None,
                    stencil_work(name, ROD_SHAPE, 1), ROD_SHAPE,
                    times=(ms, plain_ms))
                # the time a call in a batch of back-to-back calls: the
                # device's where the host keeps ahead of it
                table[name]["batch_ms"] = sharded_batched_ms(fn)
            else:
                variants.append(f"{name}: err {errs[name]:.3g}, {ms:.4f} ms "
                                f"vs plain {plain_ms:.4f} ms")
                if "convolution" in name:
                    order = int(name.rsplit(" ", 1)[1])
                    conv_line(ROD_SHAPE, name, errs, fn, order)
        del calls
        filt = table["laplacian_filter_vector_3d"]
        filt["kernel"] = "mult_filter_zmarch_kernel"
        filt["plan"] = list(kernels.filter_plan(
            torch.empty(ROD_SHAPE, device=dev)).args())
        run_fft_checks((48, 32, 64), gen)  # m = 96, 64, 128
        args = fft_pass_args((256, 256, 256), gen)
        calls, errs = run_fft_checks((256, 256, 256), gen, args)
        for name in FFT_REPLACES:
            fn, ref_fn = calls[name]
            table[name] = entry(
                name, FFT_SOURCE, FFT_REPLACES[name], errs[name], fn, ref_fn,
                fft_work(name, args[name]), "256^3",
                library_fn=library_call(name, args[name]))
        del calls, args
        torch.cuda.empty_cache()
        # the fused-curl pair: odd-factor grids (z at m = 96: the z pass's
        # four-step kernel; x at m = 96: the c2r's), the 64^3 drag run's
        # (m = 128), the sphere's 256^3 (m = 512) and the multi-body case's
        # (128, 128, 256) (z at m = 256, x at 512), whose errors and times
        # go into the table
        fused = []
        for grid in ((48, 32, 64), (32, 32, 48), (64, 64, 64),
                     (256, 256, 256), MULTIBODY_GRID):
            args = fused_pair_args(grid, gen)
            calls, errs = run_fused_checks(grid, args)
            for name, (fn, ref_fn) in calls.items():
                e = entry(name, FFT_SOURCE, FUSED_REPLACES[name], errs[name],
                          fn, ref_fn, fft_work(name, args[name]), str(grid))
                if grid == MULTIBODY_GRID:
                    table[name] = e
                if grid[0] > 48:
                    l1 = (f", l1_max relative {errs['l1_max']:.3g}"
                          if "l1_max" in errs and "merge" in name else "")
                    fused.append(
                        f"{name} at {grid}: err {errs[name]:.3g}{l1}, "
                        f"{e['ms']:.4f} ms vs plain {e['plain_ms']:.4f} ms, "
                        f"bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
            del calls, args
            torch.cuda.empty_cache()
        # the unsplit x passes and the fused edge passes: an odd-factor
        # grid, the cylinder's (256, 512) as one slab a component, and the
        # 256^3 solve's shapes, whose errors and times go into the table;
        # the 2D route's three passes at the cylinder grid's shapes
        edge = []
        grids = ((48, 32, 64), (1, *CYLINDER_GRID), (256, 256, 256))
        for grid in grids:
            args = edge_pass_args(grid, gen)
            calls, errs = run_pass_checks(grid, args)
            for name, (fn, ref_fn) in calls.items():
                if grid == grids[0]:
                    continue
                e = entry(name, FFT_SOURCE, EDGE_REPLACES[name], errs[name],
                          fn, ref_fn, fft_work(name, args[name]), str(grid),
                          library_fn=library_call(name, args[name]))
                if grid == grids[-1]:
                    table[name] = e
                else:
                    edge.append(line(f"{name} at {grid}", e))
            del calls, args
            torch.cuda.empty_cache()
        r2c = []
        for rows, n_in, m, offset in R2C_CASES:
            flat = torch.randn(rows * n_in + offset, device=dev, generator=gen)
            x = flat[offset:].view(rows, n_in)
            where = f"({rows}, {n_in}) m = {m} offset {offset}"
            _, errs = run_pass_checks(where, {
                name: (x, m)
                for name in ("rfft_pass_padded_split", "rfft_pass_padded")})
            r2c.append(f"{where}: err "
                       + " / ".join(f"{e:.3g}" for e in errs.values()))
        edge.append("forward r2c pair (split / unsplit) at " + ", ".join(r2c))
        c2r = []
        for rows, n_out, m, offset in C2R_CASES:
            h = m // 2

            def spectrum(cols):
                return torch.randn(rows * cols + offset, device=dev,
                                   generator=gen)[offset:].view(rows, cols)

            sr, si = (torch.randn(rows, 1, device=dev, generator=gen)
                      for _ in range(2))
            where = f"({rows}, {n_out}) m = {m} offset {offset}"
            _, errs = run_pass_checks(where, {
                "irfft_pass_merge": (spectrum(h), spectrum(h), sr, si, m,
                                     n_out),
                "irfft_pass_truncated": (spectrum(h + 1), spectrum(h + 1), m,
                                         n_out)})
            c2r.append(f"{where}: err "
                       + " / ".join(f"{e:.3g}" for e in errs.values()))
        edge.append("c2r pair (split / unsplit) at " + ", ".join(c2r))
        zconv = []
        for a, h, b, offset in ZCONV_CASES:
            xr, xi = (torch.randn(a * h * b + offset, device=dev,
                                  generator=gen)[offset:].view(a, h, b)
                      for _ in range(2))
            g = torch.randn(1, 2 * h, b, device=dev, generator=gen)
            where = f"({a}, {h}, {b}) m = {2 * h} offset {offset}"
            _, errs = run_pass_checks(where, {"fft_greens_ifft_pass":
                                              (xr, xi, g)})
            zconv.append(f"{where}: err {errs['fft_greens_ifft_pass']:.3g}")
            del xr, xi, g
        edge.append("z conv at " + ", ".join(zconv))
        args = route_2d_args(CYLINDER_GRID, gen)
        calls, errs = run_pass_checks(CYLINDER_GRID, args)
        for name, (fn, ref_fn) in calls.items():
            e = entry(name, FFT_SOURCE, FFT_REPLACES[name], errs[name], fn,
                      ref_fn, fft_work(name, args[name]), str(CYLINDER_GRID),
                      library_fn=library_call(name, args[name]))
            edge.append(line(f"{name} at {CYLINDER_GRID}", e))
        del calls, args

        detail = "; ".join(line(k, v) for k, v in table.items())
        detail += "; the trio at (3, 256, 64, 256) f32: " + "; ".join(
            f"{k} in a batch {table[k]['batch_ms']:.4f} ms a call"
            for k in TRANSPORT_KERNELS)
        detail += "; at (3, 256, 64, 256) f32: " + "; ".join(variants)
        detail += "; " + cube
        detail += ("; the convolution filter (conv_filter_zmarch_kernel at "
                   "orders 1-5, conv_filter_line_kernel and "
                   "conv_filter_z_pass_kernel above): "
                   + "; ".join(conv_lines))
        detail += "; " + "; ".join(fused) + "; " + "; ".join(edge)
        return table, detail + f" [{card}]"

    table = kernel_phase()
    exact_fft = [fn for fn in cuda_fft.KERNELS if fn.__name__ in FFT_REPLACES]
    by_name = {fn.__name__: fn for fn in
               kernels.KERNELS + cuda_fft.KERNELS + sharded.KERNELS}

    def reset_counts():
        for fn in by_name.values():
            fn.launches = 0

    def check_not_launched(names, where):
        for name in names:
            check(by_name[name].launches == 0,
                  f"{name} launched {by_name[name].launches} times on {where}")

    def timed_steps(step, carry, n, no_sync=True):
        """``n`` steps timed on the host clock around a synchronise;
        ``no_sync`` raises on any synchronising call inside them."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if no_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            carry, diag = scan_steps(step, carry, n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return carry, diag, (time.perf_counter() - t0) / n

    def profile_steps(step, carry, n, path, title):
        """Device busy time and time by kernel over ``n`` steps under
        ``torch.profiler``, the table written to ``path``: (carry, wall ms,
        busy ms, CUDA kernels a step, the top entries)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            carry, _ = scan_steps(step, carry, n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        n_launch = sum(e.count for e in events)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(f"{card}\n{title}, {n} steps, wall {wall_ms:.3f} ms, "
                    f"device busy {busy_ms:.3f} ms\n")
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40,
                max_name_column_width=90))
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
        return carry, wall_ms, busy_ms, n_launch / n, top

    def profile_detail(wall_ms, busy_ms, per_step, top, s_step):
        return (f"profiled 3 steps: wall {wall_ms:.3f} ms, device busy "
                f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%} of the profiled "
                f"wall, {busy_ms / 3e3 / s_step:.1%} of an unprofiled step), "
                f"{per_step:.0f} CUDA kernels/step, top "
                + ", ".join(f"{e.key[:60]} "
                            f"{e.self_device_time_total / 3e3:.3f} ms/step "
                            f"x{e.count // 3}" for e in top))

    class dense_route:
        """Within: every solve takes the dense ``torch.fft`` route."""

        def __enter__(self):
            poisson.FORCE_KERNEL_CONVOLVE = False

        def __exit__(self, *exc):
            poisson.FORCE_KERNEL_CONVOLVE = None

    @phase("solve")
    def solve_phase():
        n = 256
        solver = poisson.UnboundedPoissonSolver3D(n, n, n, device=dev)
        check(isinstance(solver.fourier_greens_times_dx_pow_dim, tuple),
              "the 256^3 solver does not store the split Green's pair")
        gen = torch.Generator(device=dev).manual_seed(1)
        rhs = torch.randn((3, n, n, n), device=dev, generator=gen)
        check(solver.uses_kernel_route(rhs), "256^3 solve is not on the "
              "kernel route")
        out = solver.vector_field_solve(rhs)
        ms = median_ms(torch, lambda: solver.vector_field_solve(rhs))
        with dense_route():
            check(not solver.uses_kernel_route(rhs), "dense route not taken")
            ref = solver.vector_field_solve(rhs)
            plain_ms = median_ms(torch, lambda: solver.vector_field_solve(rhs))
        err = float((out - ref).abs().max()) / float(ref.abs().max())
        check(err <= 1e-5, f"kernel vs dense solve: relative {err}")
        return None, (f"256^3 vector solve: kernel route {ms:.4f} ms, dense "
                      f"torch.fft route {plain_ms:.4f} ms, relative max|diff| "
                      f"{err:.3g} [{card}]")

    solve_phase()

    @phase("main path")
    def main_path_phase():
        n = 256
        step, (carry,) = cases._build_fsi_case((n, n, n), device=dev)
        check(step.uses_sparse_forcing, "the 256^3 case did not take the "
              "sparse-window branch")
        check(isinstance(carry.greens, tuple), "the 256^3 case's Poisson "
              "solve is not on the kernel route")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
        all_kernels = [fn for fn in kernels.KERNELS
                       if fn.__name__ in SPHERE_KERNELS] + exact_fft
        reset_counts()
        # the step never waits for the device: a synchronising call raises
        carry, forces, s_step = timed_steps(step, carry, 20)
        launches = {fn.__name__: fn.launches for fn in all_kernels}
        for name, count in launches.items():
            check(count >= 20, f"{name} launched {count} times on the main path")
            table[name]["launches"] = count
        # the z conv and the c2r run once a step, on their ring kernels at
        # m = 512
        for name in ("fft_greens_ifft_pass", "irfft_pass_merge"):
            check(launches[name] == 20,
                  f"{name} launched {launches[name]} times in 20 steps")
        check_not_launched(FUSED_REPLACES, "the exact-tier sphere path")
        fs = carry.flow_state
        for what, t in (("vorticity", fs.primary_field),
                        ("velocity", fs.velocity_field), ("forces", forces)):
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        check(tuple(fs.velocity_field.shape) == (3, n, n, n), "velocity shape")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        return None, (f"256^3 f32 sparse window {step.window}: {s_step:.6f} "
                      f"s/step, {n**3 / s_step / 1e6:.3f} Mcells/s, peak "
                      f"{peak:.2f} GiB, no host sync in the timed steps, "
                      f"launches {launches} [{card}]")

    main_path_phase()

    @phase("physics")
    def physics_phase():
        def drag():
            return cases.flow_past_sphere_fused_case(
                nondim_time=2.0, grid_size=(64, 64, 64), window=10,
                device=dev)

        check(poisson._kernel_convolve_supported(
            (128, 128, 128), torch.float32, dev), "64^3 not on the kernel route")
        times, cds = drag()
        with dense_route():
            times_d, cds_d = drag()
        check(np.all(np.isfinite(cds)) and np.all(np.isfinite(cds_d)),
              "non-finite Cd")
        cd, cd_d = float(cds[-1]), float(cds_d[-1])
        rel = abs(cd - CD_T2_64) / CD_T2_64
        check(rel <= 0.02, f"Cd {cd} at t*={times[-1]} is {rel:.2%} from "
              f"{CD_T2_64}")
        # both routes are exact-tier float32 (solve error ~1e-7): a larger
        # gap than 1e-3 is a kernel fault, not physics
        rel_routes = abs(cd - cd_d) / abs(cd_d)
        check(len(times) == len(times_d) and rel_routes <= 1e-3,
              f"Cd {cd} (kernel route) vs {cd_d} (torch.fft route): "
              f"relative {rel_routes}")
        cd_interp = float(np.interp(2.0, times, cds))
        return cd, (f"64^3 dense IBM, kernel route: Cd {cd:.6f} at "
                      f"t*={times[-1]:.4f} (first sample past 2; "
                      f"{len(times) * 10} steps), interpolated at t*=2 "
                      f"{cd_interp:.5f}; torch.fft route Cd {cd_d:.6f} "
                      f"(relative {rel_routes:.3g}); JAX reference "
                      f"{CD_T2_64:.5f}, diff {rel:.3%}")

    cd_exact = physics_phase()

    @phase("card vs cpu")
    def parity_phase():
        n = 32
        vort = np.random.default_rng(0).standard_normal((3, n, n, n)) * 0.1
        finals = []
        for device in (dev, torch.device("cpu")):
            step, (carry,) = cases._build_fsi_case((n, n, n), device=device)
            state = flow_state_from_numpy(
                (vort, carry.flow_state.velocity_field.cpu().numpy(),
                 carry.flow_state.eul_grid_forcing_field.cpu().numpy()),
                device=device, dtype=torch.float32)
            carry, _ = scan_steps(step, carry._replace(flow_state=state), 3)
            finals.append(carry.flow_state)
        (gpu, cpu) = finals
        errs = {}
        for what in ("primary_field", "velocity_field"):
            ref = getattr(cpu, what)
            err = float((getattr(gpu, what).cpu() - ref).abs().max())
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"{what}: card vs cpu {err} > {tol}")
            errs[what] = err
        return None, f"32^3, 3 steps, max|diff| {errs}"

    parity_phase()

    rod_kernels = [fn for fn in kernels.KERNELS
                   if fn.__name__ != "diffusion_penalise_vector_3d"]
    rod_kernels += exact_fft

    def count_syncs(fn):
        """Run ``fn`` with every synchronising CUDA call reported; returns
        (its result, the number of synchronising calls)."""
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out, sum("synchroniz" in str(w.message) for w in caught)

    @phase("rod main path")
    def rod_main_path_phase():
        grid = (256, 64, 256)
        step, (carry,) = cases._build_rod_bench_case(grid, device=dev)
        check(step.sparse_forcing_window == (181, 64, 181),
              f"sparse window {step.sparse_forcing_window}, not (181, 64, 181)")
        check(isinstance(carry.greens, tuple), "the rod case's Poisson solve "
              "is not on the kernel route")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
        reset_counts()
        n_steps = 20
        stats0 = dict(step.stats)
        carry, (forces, window_ok), s_step = timed_steps(
            step, carry, n_steps, no_sync=False)
        launches = {fn.__name__: fn.launches for fn in rod_kernels}
        for name, count in launches.items():
            check(count >= n_steps,
                  f"{name} launched {count} times on the rod path")
            table[name]["launches"] = count
        check_not_launched(FUSED_REPLACES, "the exact-tier rod path")
        substeps = step.stats["substeps"] - stats0["substeps"]
        # the host syncs, counted on 3 more steps: the sync debug mode costs
        # host time, which this host-bound step would show in its s/step
        stats0 = dict(step.stats)
        (carry, _), syncs = count_syncs(lambda: scan_steps(step, carry, 3))
        host_reads = step.stats["host_syncs"] - stats0["host_syncs"]
        check(syncs == host_reads == 3,
              f"{syncs} synchronising calls, {host_reads} substep-count "
              f"reads in 3 steps")
        fs, rs = carry.flow_state, carry.rod_state
        for what, t in (("vorticity", fs.primary_field),
                        ("velocity", fs.velocity_field), ("forces", forces),
                        ("rod", rs.position), ("tip", rs.position[:, -1])):
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        check(bool(window_ok.all()), "the rod's support left the window")
        check(tuple(fs.velocity_field.shape) == (3, *grid), "velocity shape")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        # the device's busy share and the time by kernel over 3 more steps
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build", "rod_profile.txt"),
            "(256, 64, 256) rod step")
        return None, (
            f"(256, 64, 256) f32 flow, f64 rod, window "
            f"{step.sparse_forcing_window}: {s_step:.6f} s/step, "
            f"{np.prod(grid) / s_step / 1e6:.3f} Mcells/s, peak {peak:.2f} "
            f"GiB, {substeps / n_steps:.2f} substeps/step, "
            f"{syncs / 3:.2f} host syncs/step, launches {launches}; "
            + profile_detail(*prof, s_step) + f" [{card}]")

    rod_main_path_phase()

    @phase("rod physics")
    def rod_physics_phase():
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "rod_tip_reference.json")) as f:
            ref = json.load(f)
        grid = tuple(ref["grid_size"])
        step, (carry,) = cases._build_rod_bench_case(grid, device=dev)
        check(step.sparse_forcing_window is not None, "no sparse window")
        times = [float(carry.time)]
        tips = [carry.rod_state.position[:, -1].cpu().numpy()]
        while times[-1] < ROD_PHYSICS_T:
            carry, _ = step(carry)
            times.append(float(carry.time))
            tips.append(carry.rod_state.position[:, -1].cpu().numpy())
        times, tips = np.asarray(times), np.asarray(tips)
        ref_t, ref_tip = np.asarray(ref["times"]), np.asarray(ref["tip"])
        check(np.isfinite(tips).all(), "non-finite tip")
        # the JAX tip at the card's times (the step sizes agree to float32
        # rounding); the card's run stops at the first step past t_end
        inside = times <= ref_t[-1]
        ref_at = np.stack([np.interp(times[inside], ref_t, ref_tip[:, c])
                           for c in range(3)], axis=1)
        dev_max = float(np.abs(tips[inside] - ref_at).max())
        rel = dev_max / ref["rod_length"]
        check(rel <= TIP_TOL, f"tip deviates {rel:.3g} L from the JAX "
              f"trajectory (> {TIP_TOL})")
        moved = float(np.abs(tips[-1] - tips[0]).max())
        return None, (
            f"{grid} rod case to t = {times[-1]:.5f} in {len(times) - 1} steps "
            f"(JAX CPU: {int(np.searchsorted(ref_t, times[-1]))} to there, "
            f"{len(ref_t) - 1} to {ref['t_end']}), "
            f"{step.stats['substeps']} substeps; "
            f"tip moved {moved:.6g}, max deviation from the JAX trajectory "
            f"{dev_max:.3g} = {rel:.3g} L (bound {TIP_TOL} L)")

    rod_physics_phase()

    @phase("rod card vs cpu")
    def rod_parity_phase():
        grid = (64, 16, 64)
        vort = np.random.default_rng(0).standard_normal((3, *grid)) * 0.1
        finals = []
        for device in (dev, torch.device("cpu")):
            step, (carry,) = cases._build_rod_bench_case(grid, device=device)
            check(step.sparse_forcing_window is not None, "no sparse window")
            fs = carry.flow_state
            state = flow_state_from_numpy(
                (vort, fs.velocity_field.cpu().numpy(),
                 fs.eul_grid_forcing_field.cpu().numpy()),
                device=device, dtype=torch.float32)
            carry, _ = scan_steps(step, carry._replace(flow_state=state), 3)
            finals.append((carry, step.stats["substeps"]))
        (gpu, n_gpu), (cpu, n_cpu) = finals
        errs = {}
        for what, out, ref in (
                ("vorticity", gpu.flow_state.primary_field,
                 cpu.flow_state.primary_field),
                ("velocity", gpu.flow_state.velocity_field,
                 cpu.flow_state.velocity_field),
                ("rod position", gpu.rod_state.position,
                 cpu.rod_state.position),
                ("position mismatch", gpu.vb_state.position_mismatch,
                 cpu.vb_state.position_mismatch)):
            err = float((out.cpu() - ref).abs().max())
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"rod {what}: card vs cpu {err} > {tol}")
            errs[what] = err
        return None, (f"(64, 16, 64), 3 steps, {n_gpu} substeps (cpu "
                      f"{n_cpu}), max|diff| {errs}")

    rod_parity_phase()

    fast_kernels = [by_name[n] for n in (
        "rfft_pass_padded_split", "fft_pass_padded",
        "fft_greens_curl_ifft_pass", "ifft_pass_truncated",
        "irfft_pass_merge_velocity")]

    def check_fast_route(n_steps, where):
        """Over ``n_steps`` fast-tier steps: the fused pair once a step, the
        exact tier's z conv, c2r merge and curl never."""
        for name in FUSED_REPLACES:
            count = by_name[name].launches
            check(count == n_steps, f"{name} launched {count} times in "
                  f"{n_steps} steps on {where}")
        check_not_launched(EXACT_ONLY, where)

    @phase("fast tier")
    def fast_tier_phase():
        n, n_steps = 256, 20
        runs = {}
        for fast in (False, True):
            step, (carry,) = cases._build_fsi_case(
                (n, n, n), device=dev, sim_kwargs={"fast_spectral": fast})
            check(step.uses_sparse_forcing, "no sparse window")
            check(isinstance(carry.greens, tuple), "the 256^3 case's Poisson "
                  "solve is not on the kernel route")
            carry, _ = scan_steps(step, carry, 5)
            runs[fast] = [step, carry, []]
        launches = None
        # in turns: exact, fast, fast, exact
        for fast in (False, True, True, False):
            step, carry, times = runs[fast]
            reset_counts()
            carry, forces, s_step = timed_steps(step, carry, n_steps)
            if fast:
                check_fast_route(n_steps, "the fast-tier sphere path")
                launches = {fn.__name__: fn.launches for fn in fast_kernels}
            else:
                check_not_launched(FUSED_REPLACES, "the exact-tier sphere path")
            runs[fast][1] = carry
            times.append(s_step)
            fs = carry.flow_state
            for what, t in (("vorticity", fs.primary_field),
                            ("velocity", fs.velocity_field), ("forces", forces)):
                check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        exact, fast = runs[False][2], runs[True][2]

        # the 64^3 Cd on the fast tier, through the package default
        import sopht_mpi_tpu_torch

        sopht_mpi_tpu_torch.enable_fast_spectral(True)
        try:
            reset_counts()
            times, cds = cases.flow_past_sphere_fused_case(
                nondim_time=2.0, grid_size=(64, 64, 64), window=10, device=dev)
            n_drag = len(times) * 10
            check_fast_route(n_drag, "the fast-tier 64^3 drag run")
        finally:
            sopht_mpi_tpu_torch.enable_fast_spectral(None)
        cd = float(cds[-1])
        rel = abs(cd - cd_exact) / abs(cd_exact)
        check(np.isfinite(cd) and rel <= 1e-3,
              f"fast-tier Cd {cd} vs exact {cd_exact}: relative {rel}")
        mc = lambda t: n**3 / t / 1e6
        return None, (
            f"256^3 sphere, {n_steps} timed steps a run, in turns: exact "
            f"{exact[0]:.6f} / {exact[1]:.6f} s/step ({mc(exact[0]):.3f} / "
            f"{mc(exact[1]):.3f} Mcells/s), fast {fast[0]:.6f} / "
            f"{fast[1]:.6f} s/step ({mc(fast[0]):.3f} / {mc(fast[1]):.3f} "
            f"Mcells/s), no host sync; fast-tier launches {launches}, "
            f"{', '.join(EXACT_ONLY)} 0; 64^3 Cd at t*={times[-1]:.4f}: fast "
            f"{cd:.6f} vs exact {cd_exact:.6f} (relative {rel:.3g}) [{card}]")

    fast_tier_phase()

    multibody_kernels = [
        by_name[n] for n in ("rotational_curl_add_3d",) + TRANSPORT_KERNELS
    ] + fast_kernels

    @phase("multibody main path")
    def multibody_main_path_phase():
        grid, n_steps = MULTIBODY_GRID, 20
        runs = {}
        torch.cuda.reset_peak_memory_stats(dev)
        for fast in (True, False):
            step, (carry,) = cases._build_multibody_bench_case(
                grid, device=dev, fast_spectral=fast)
            check(step.uses_sparse_forcing, "no sparse windows")
            check(isinstance(carry.greens, tuple), "the multi-body case's "
                  "Poisson solve is not on the kernel route")
            carry, _ = scan_steps(step, carry, 5)
            torch.cuda.synchronize()
            runs[fast] = [step, carry, [], []]
        launches = None
        # in turns: fast, exact, exact, fast; one host read a step, so the
        # sync debug mode stays off (it costs a host-bound step host time)
        for fast in (True, False, False, True):
            step, carry, times, subs = runs[fast]
            reset_counts()
            stats0 = dict(step.stats)
            carry, (forces, ok), s_step = timed_steps(step, carry, n_steps,
                                                      no_sync=False)
            check(bool(ok.all()), "a body's support left its window")
            if fast:
                check_fast_route(n_steps, "the multi-body path")
                counts = {fn.__name__: fn.launches for fn in multibody_kernels}
                for name, count in counts.items():
                    check(count >= n_steps, f"{name} launched {count} times "
                          "on the multi-body path")
                if launches is None:
                    launches = counts
                    for name, count in counts.items():
                        table[name]["launches"] = count
            else:
                check_not_launched(FUSED_REPLACES, "the exact-tier multi-body "
                                   "path")
            runs[fast][1] = carry
            times.append(s_step)
            subs.append((step.stats["substeps"] - stats0["substeps"]) / n_steps)
            fs = carry.flow_state
            rod = carry.body_states[0]
            for what, t in (("vorticity", fs.primary_field),
                            ("velocity", fs.velocity_field),
                            ("rod", rod.position),
                            ("forces", torch.stack(forces))):
                check(bool(torch.isfinite(t).all()), f"non-finite {what}")
            check(tuple(fs.velocity_field.shape) == (3, *grid),
                  "velocity shape")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        step, carry, _, _ = runs[True]
        stats0 = dict(step.stats)
        (carry, _), syncs = count_syncs(lambda: scan_steps(step, carry, 3))
        host_reads = step.stats["host_syncs"] - stats0["host_syncs"]
        check(syncs == host_reads == 3,
              f"{syncs} synchronising calls, {host_reads} substep-count "
              f"reads in 3 steps")
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build",
                                         "multibody_profile.txt"),
            f"{grid} multi-body step, fast tier")
        # the exact tier's profile beside it: where its step time goes
        _, e_wall, e_busy, e_per_step, _ = profile_steps(
            runs[False][0], runs[False][1], 3,
            os.path.join(REPO, "build", "multibody_exact_profile.txt"),
            f"{grid} multi-body step, exact tier")
        (f0, f1), (e0, e1) = runs[True][2], runs[False][2]
        mc = lambda t: np.prod(grid) / t / 1e6
        return None, (
            f"{grid} f32 flow, f64 rod, fixed sphere, windows "
            f"{step.body_windows}, in turns: fast {f0:.6f} / {f1:.6f} "
            f"s/step ({mc(f0):.3f} / {mc(f1):.3f} Mcells/s), exact "
            f"{e0:.6f} / {e1:.6f} s/step ({mc(e0):.3f} / {mc(e1):.3f} "
            f"Mcells/s); substeps/step fast {runs[True][3]}, exact "
            f"{runs[False][3]}; peak {peak:.2f} GiB, {syncs / 3:.2f} host "
            f"syncs/step, windows ok; fast-tier launches {launches}, "
            f"{', '.join(EXACT_ONLY)} 0; fast tier "
            + profile_detail(*prof, f1)
            + f"; exact tier profiled 3 steps: wall {e_wall:.3f} ms, device "
            f"busy {e_busy:.3f} ms, {e_per_step:.0f} CUDA kernels/step "
            f"[{card}]")

    multibody_main_path_phase()

    @phase("multibody physics")
    def multibody_physics_phase():
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "multibody_reference.json")) as f:
            ref = json.load(f)
        grid, n_steps = tuple(ref["grid_size"]), MULTIBODY_PHYSICS_STEPS
        step, (carry,) = cases._build_multibody_bench_case(
            grid, device=dev, fast_spectral=True)
        check(step.uses_sparse_forcing, "no sparse windows")
        reset_counts()
        times = [float(carry.time)]
        tips = [carry.body_states[0].position[:, -1].cpu().numpy()]
        forces, oks = [], []
        for _ in range(n_steps):
            carry, (sums, ok) = step(carry)
            oks.append(ok)
            times.append(float(carry.time))
            tips.append(carry.body_states[0].position[:, -1].cpu().numpy())
            forces.append(float(sums[1][0]))
        check_fast_route(n_steps, "the multi-body physics run")
        check(bool(torch.stack(oks).all()), "a body left its window")
        times, tips = np.asarray(times), np.asarray(tips)
        check(np.isfinite(tips).all() and np.isfinite(forces).all(),
              "non-finite tip or force")
        ref_t, ref_tip = np.asarray(ref["times"]), np.asarray(ref["tip"])
        inside = times <= ref_t[-1]
        ref_at = np.stack([np.interp(times[inside], ref_t, ref_tip[:, c])
                           for c in range(3)], axis=1)
        dev_max = float(np.abs(tips[inside] - ref_at).max())
        rel = dev_max / ref["rod_length"]
        check(rel <= TIP_TOL, f"tip deviates {rel:.3g} L from the JAX "
              f"trajectory (> {TIP_TOL})")
        # the same step of both runs (their times agree to float32 rounding)
        f_ref = ref["sphere_force_x"][n_steps]
        f_rel = abs(forces[-1] - f_ref) / abs(f_ref)
        check(f_rel <= 1e-3, f"sphere x-force {forces[-1]} vs JAX {f_ref}: "
              f"relative {f_rel:.3g} > 1e-3")
        # the TPU's fast-tier run of this grid (bf16 matmuls), ungated
        csv = np.loadtxt(os.path.join(
            REPO, "doc", "validation_rod_and_sphere_64x64x128.csv"),
            delimiter=",", skiprows=1)
        sphere_d = 0.4 * ref["rod_length"]
        drag_scale = 0.5 * 0.25 * np.pi * sphere_d**2
        rows = []
        for t_csv, *tip_csv, cd_csv in csv[csv[:, 0] <= times[-1]]:
            k = int(np.argmin(np.abs(times - t_csv)))
            cd = -forces[k - 1] / drag_scale if k > 0 else float("nan")
            rows.append(f"t {t_csv:.4f}: tip x {tip_csv[0]:.6f} (card "
                        f"{tips[k, 0]:.6f} at t {times[k]:.4f}), Cd "
                        f"{cd_csv:.3f} (card {cd:.3f})")
        return None, (
            f"{grid} fast tier, {n_steps} steps to t = {times[-1]:.5f} (JAX "
            f"CPU: {ref_t[n_steps]:.5f}), {step.stats['substeps']} "
            f"substeps; tip "
            f"moved {float(np.abs(tips[-1] - tips[0]).max()):.6g}, max "
            f"deviation from the JAX trajectory {dev_max:.3g} = {rel:.3g} L "
            f"(bound {TIP_TOL} L); sphere x-force at the last step "
            f"{forces[-1]:.8g} vs JAX {f_ref:.8g} (relative {f_rel:.3g}, "
            f"bound 1e-3); the TPU's validation run, ungated: "
            + "; ".join(rows))

    multibody_physics_phase()

    @phase("multibody card vs cpu")
    def multibody_parity_phase():
        grid = (32, 32, 64)
        vort = np.random.default_rng(0).standard_normal((3, *grid)) * 0.1
        finals = []
        # the CPU takes the fused route's plain passes
        poisson.FORCE_KERNEL_CONVOLVE = True
        try:
            for device in (dev, torch.device("cpu")):
                step, (carry,) = cases._build_multibody_bench_case(
                    grid, device=device, fast_spectral=True,
                    sim_kwargs={"use_kernels": True})
                check(step.uses_sparse_forcing, "no sparse windows")
                fs = carry.flow_state
                state = flow_state_from_numpy(
                    (vort, fs.velocity_field.cpu().numpy(),
                     fs.eul_grid_forcing_field.cpu().numpy()),
                    device=device, dtype=torch.float32)
                reset_counts()
                carry, _ = scan_steps(step, carry._replace(flow_state=state),
                                      3)
                if device.type == "cuda":
                    check_fast_route(3, "the multi-body parity run")
                finals.append((carry, step.stats["substeps"]))
        finally:
            poisson.FORCE_KERNEL_CONVOLVE = None
        (gpu, n_gpu), (cpu, n_cpu) = finals
        errs = {}
        for what, out, ref in (
                ("vorticity", gpu.flow_state.primary_field,
                 cpu.flow_state.primary_field),
                ("velocity", gpu.flow_state.velocity_field,
                 cpu.flow_state.velocity_field),
                ("rod position", gpu.body_states[0].position,
                 cpu.body_states[0].position),
                ("rod mismatch", gpu.vb_states[0].position_mismatch,
                 cpu.vb_states[0].position_mismatch),
                ("sphere mismatch", gpu.vb_states[1].position_mismatch,
                 cpu.vb_states[1].position_mismatch)):
            err = float((out.cpu() - ref).abs().max())
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"multi-body {what}: card vs cpu {err} > {tol}")
            errs[what] = err
        return None, (f"{grid}, 3 steps, {n_gpu} substeps (cpu {n_cpu}), "
                      f"max|diff| {errs}")

    multibody_parity_phase()

    @phase("fused edges")
    def fused_edges_phase():
        n, n_steps = 256, 20
        gen = torch.Generator(device=dev).manual_seed(2)
        # the fused forward pass: the cluster kernel at the 256^3 solve's
        # (768, 256, 256) slabs and the rod grid's (768, 64, 256); the
        # dense-x kernel where a length is not a power of two and at
        # 512 x 512 slabs, which no cluster holds; then the inverse
        passes = []
        for (a, ny, nx), clustered in (((3 * n, n, n), True),
                                       ((3 * ROD_SHAPE[1], *ROD_SHAPE[2:]),
                                        True),
                                       ((3, 48, 32), False),
                                       ((3, 32, 48), False),
                                       ((2, 512, 512), False)):
            x = torch.randn((a, ny, nx), device=dev, generator=gen)
            plan = cuda_fft.fused_r2c_cluster_plan(a, ny, nx, 2 * ny, 2 * nx,
                                                   dev, x.data_ptr())
            if clustered:
                check(plan.cluster > 0, f"no cluster plan for {x.shape}")
            else:
                check(plan == cuda_fft.FUSED_R2C_DENSE_PLAN,
                      f"a cluster plan for {x.shape}: {plan}")
            out = cuda_fft.rfft_fft_pass_fused(x, 2 * nx, 2 * ny)
            ref = cuda_fft.rfft_fft_pass_fused_ref(x, 2 * nx, 2 * ny)
            fwd_err = max(float((o - r).abs().max())
                          for o, r in zip(out, ref)) \
                / max(float(r.abs().max()) for r in ref)
            check(fwd_err <= FFT_TOL, f"rfft_fft_pass_fused at {x.shape}: "
                  f"relative {fwd_err} > {FFT_TOL}")
            fwd_ms = median_ms(torch, lambda: cuda_fft.rfft_fft_pass_fused(
                x, 2 * nx, 2 * ny))
            kind = (f"cluster {plan.cluster}, {plan.threads} threads, "
                    f"{plan.clusters} clusters, {plan.smem} B"
                    if clustered else "dense-x kernel")
            passes.append(
                f"rfft_fft_pass_fused at ({a}, {ny}, {nx}) slabs: {kind}, "
                f"relative max|diff| {fwd_err:.3g}, {fwd_ms:.4f} ms")
            del x, out, ref
            # the fused inverse pass on the same slabs' (a, 2 ny, nx)
            # pairs: its cluster kernel where the forward's runs, the
            # dense-x kernel at the same three dense shapes
            spec = [torch.randn(shape, device=dev, generator=gen)
                    for shape in ((a, 2 * ny, nx), (a, 2 * ny, nx),
                                  (a, ny, 1), (a, ny, 1))]
            plan = cuda_fft.fused_c2r_cluster_plan(
                a, ny, nx, 2 * ny, 2 * nx, dev,
                spec[0].data_ptr() | spec[1].data_ptr())
            if clustered:
                check(plan.cluster > 0,
                      f"no inverse cluster plan for ({a}, {ny}, {nx})")
            else:
                check(plan == cuda_fft.FUSED_R2C_DENSE_PLAN,
                      f"an inverse cluster plan for ({a}, {ny}, {nx}): "
                      f"{plan}")
            out = cuda_fft.ifft_irfft_pass_fused(*spec, 2 * nx, nx)
            ref = cuda_fft.ifft_irfft_pass_fused_ref(*spec, 2 * nx, nx)
            inv_err = float((out - ref).abs().max()) / float(ref.abs().max())
            check(inv_err <= FFT_TOL, f"ifft_irfft_pass_fused into "
                  f"({a}, {ny}, {nx}): relative {inv_err} > {FFT_TOL}")
            inv_ms = median_ms(torch, lambda: cuda_fft.ifft_irfft_pass_fused(
                *spec, 2 * nx, nx))
            kind = (f"cluster {plan.cluster}, {plan.threads} threads, "
                    f"{plan.clusters} clusters, {plan.smem} B"
                    if clustered else "dense-x kernel")
            passes.append(
                f"ifft_irfft_pass_fused from ({a}, {2 * ny}, {nx}) pairs: "
                f"{kind}, relative max|diff| {inv_err:.3g}, {inv_ms:.4f} ms")
            del spec, out, ref
        torch.cuda.empty_cache()
        # the unsplit x passes: round trips of the 256^3 solve's rows
        x = torch.randn((3 * n * n, n), device=dev, generator=gen)
        reset_counts()
        for _ in range(n_steps):
            back = cuda_fft.irfft_pass_truncated(
                *cuda_fft.rfft_pass_padded(x, 2 * n), 2 * n, n)
        trip = float((back - x).abs().max()) / float(x.abs().max())
        check(trip <= FFT_TOL, f"x round trip: relative {trip} > {FFT_TOL}")
        for name in ("rfft_pass_padded", "irfft_pass_truncated"):
            check(by_name[name].launches == n_steps,
                  f"{name} launched {by_name[name].launches} times in "
                  f"{n_steps} round trips")
            table[name]["launches"] = by_name[name].launches
        del x, back

        def check_edges(fused, n_solves, where):
            on, off = ((FUSED_EDGE_PASSES, UNFUSED_EDGE_PASSES) if fused
                       else (UNFUSED_EDGE_PASSES, FUSED_EDGE_PASSES))
            for name in on:
                count = by_name[name].launches
                check(count == n_solves, f"{name} launched {count} times in "
                      f"{n_solves} solves on {where}")
            check_not_launched(off, where)

        solver = poisson.UnboundedPoissonSolver3D(n, n, n, device=dev)
        rhs = torch.randn((3, n, n, n), device=dev, generator=gen)
        step, (carry,) = cases._build_fsi_case((n, n, n), device=dev)
        check(step.uses_sparse_forcing, "no sparse window")
        carry, _ = scan_steps(step, carry, 5)
        check(not cuda_fft.USE_FUSED_EDGE_PASSES, "the fused edge passes are "
              "not off by default")
        ref = solver.vector_field_solve(rhs)
        off_ms = median_ms(torch, lambda: solver.vector_field_solve(rhs))
        times = {False: [], True: []}
        busy = {False: [], True: []}
        try:
            cuda_fft.USE_FUSED_EDGE_PASSES = True
            reset_counts()
            out = solver.vector_field_solve(rhs)
            check_edges(True, 1, "the fused-edge solve")
            on_ms = median_ms(torch, lambda: solver.vector_field_solve(rhs))
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            check(err <= FFT_TOL, f"fused-edge vs unfused solve: relative "
                  f"{err} > {FFT_TOL}")
            del out, ref, rhs
            # in turns: off, on, on, off
            for fused in (False, True, True, False):
                cuda_fft.USE_FUSED_EDGE_PASSES = fused
                reset_counts()
                carry, forces, s_step = timed_steps(step, carry, n_steps)
                check_edges(fused, n_steps, f"the sphere step, flag {fused}")
                check(by_name["fft_greens_ifft_pass"].launches == n_steps,
                      "the z pass did not run once a step")
                if fused and not times[True]:
                    for name in FUSED_EDGE_PASSES:
                        table[name]["launches"] = by_name[name].launches
                times[fused].append(s_step)
                fs = carry.flow_state
                for what, t in (("vorticity", fs.primary_field),
                                ("velocity", fs.velocity_field),
                                ("forces", forces)):
                    check(bool(torch.isfinite(t).all()), f"non-finite {what}")
                # the step's device time, over 3 steps under the profiler
                tag = "fused" if fused else "unfused"
                carry, _, busy_ms, per_step, _ = profile_steps(
                    step, carry, 3, os.path.join(
                        REPO, "build", f"sphere_{tag}_edges_profile.txt"),
                    f"256^3 sphere step, {tag} edge passes")
                busy[fused].append((busy_ms / 3, per_step))
        finally:
            cuda_fft.USE_FUSED_EDGE_PASSES = False
        off, on = times[False], times[True]
        device = "; ".join(
            f"{tag} " + " / ".join(f"{ms:.4f}" for ms, _ in busy[fused])
            + f" ms ({busy[fused][0][1]:.1f} kernels)"
            for tag, fused in (("unfused", False), ("fused", True)))
        return None, (
            f"{'; '.join(passes)}; "
            f"x round trip of (196608, 256) rows, m = 512: relative "
            f"max|diff| {trip:.3g}, {n_steps} launches each; 256^3 vector "
            f"solve: fused edges {on_ms:.4f} ms, unfused {off_ms:.4f} ms, "
            f"relative max|diff| {err:.3g}; 256^3 sphere step, {n_steps} "
            f"timed steps a run, in turns: unfused {off[0]:.6f} / "
            f"{off[1]:.6f} s/step, fused {on[0]:.6f} / {on[1]:.6f} s/step, "
            f"no host sync; device time a step (3 profiled steps a run): "
            f"{device}; fused launches "
            f"{ {k: table[k]['launches'] for k in FUSED_EDGE_PASSES} }, "
            f"{', '.join(UNFUSED_EDGE_PASSES)} 0 [{card}]")

    fused_edges_phase()

    route_2d = [by_name[name] for name in ROUTE_2D]

    def check_2d_route(n_solves, where):
        for fn in route_2d:
            check(fn.launches == n_solves, f"{fn.__name__} launched "
                  f"{fn.launches} times in {n_solves} solves on {where}")
        check_not_launched(
            [fn.__name__ for fn in by_name.values() if fn not in route_2d],
            where)

    @phase("2d main path")
    def cylinder_main_path_phase():
        grid, n_steps = CYLINDER_GRID, 20
        step, (carry,) = cases._build_cylinder_fsi_case(grid, device=dev)
        check(not step.uses_sparse_forcing, "the 2D case took a sparse window")
        check(isinstance(carry.greens, tuple), "the cylinder case's Poisson "
              "solve is not on the kernel route")
        torch.cuda.reset_peak_memory_stats(dev)
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
        reset_counts()
        # the step never waits for the device: a synchronising call raises
        carry, forces, s_checked = timed_steps(step, carry, n_steps)
        check_2d_route(n_steps, "the cylinder path")
        launches = {fn.__name__: fn.launches for fn in route_2d}
        # the sync debug mode costs this host-bound step host time: timed
        # again without it
        carry, forces, s_step = timed_steps(step, carry, n_steps,
                                            no_sync=False)
        fs = carry.flow_state
        for what, t in (("vorticity", fs.primary_scalar_field),
                        ("velocity", fs.velocity_field), ("forces", forces)):
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        check(tuple(fs.velocity_field.shape) == (2, *grid), "velocity shape")
        check(tuple(forces.shape) == (n_steps, 2), "force shape")
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build", "cylinder_profile.txt"),
            f"{grid} cylinder step")
        return None, (
            f"{grid} f32, 60 markers, dense IBM: {s_step:.6f} s/step, "
            f"{np.prod(grid) / s_step / 1e6:.3f} Mcells/s ({s_checked:.6f} "
            f"s/step with every synchronising call set to raise: none did), "
            f"peak {peak:.1f} MiB, launches {launches} over the checked "
            f"steps; "
            + profile_detail(*prof, s_step) + f" [{card}]")

    cylinder_main_path_phase()

    @phase("2d physics")
    def physics_2d_phase():
        # Lamb-Oseen at 256^2, t 1.0 -> 1.2; the JAX package's run of the
        # same drive gives L2 ~ 1.0e-3, Linf ~ 1.3e-2, and its own example
        # test bounds the 64^2 run by 2e-2 / 2e-1
        n = 256
        check(poisson._kernel_convolve_supported((2 * n, 2 * n), torch.float32,
                                                 dev), "256^2 not on the "
              "kernel route")
        reset_counts()
        l2, linf = cases.lamb_oseen_vortex_case((n, n), t_end=1.2, device=dev)
        n_lamb = route_2d[0].launches
        check_2d_route(n_lamb, "the Lamb-Oseen run")
        with dense_route():
            l2_d, linf_d = cases.lamb_oseen_vortex_case((n, n), t_end=1.2,
                                                        device=dev)
        check(np.isfinite([l2, linf, l2_d, linf_d]).all(), "non-finite error")
        check(l2 <= 2e-3 and linf <= 2.6e-2,
              f"Lamb-Oseen 256^2 errors L2 {l2}, Linf {linf} exceed twice the "
              "JAX package's 1.0e-3 / 1.3e-2")
        check(abs(l2 - l2_d) <= 1e-5 and abs(linf - linf_d) <= 1e-4,
              f"Lamb-Oseen kernel route ({l2}, {linf}) vs torch.fft route "
              f"({l2_d}, {linf_d})")
        # the cylinder's Cd after a fixed number of steps
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "cylinder_reference.json")) as f:
            ref = json.load(f)
        grid, n_steps = tuple(ref["grid_size"]), ref["n_steps"]
        step, (carry,) = cases._build_cylinder_fsi_case(grid, device=dev)
        reset_counts()
        carry, forces = scan_steps(step, carry, n_steps)
        check_2d_route(n_steps, "the cylinder drag run")
        cds = (forces[:, 0].abs() / ref["drag_scale"]).cpu().numpy()
        t_star = float(carry.time) / ref["timescale"]
        check(np.isfinite(cds).all(), "non-finite Cd")
        worst = 0.0
        for k, cd_ref in zip(ref["steps"], ref["cd"]):
            worst = max(worst, abs(cds[k - 1] - cd_ref) / abs(cd_ref))
        check(worst <= 1e-3, f"cylinder Cd deviates {worst:.3g} from the JAX "
              "package's CPU run (> 1e-3)")
        check(abs(t_star - ref["t_star"]) <= 1e-3 * ref["t_star"],
              f"t* {t_star} vs JAX {ref['t_star']}")
        return None, (
            f"Lamb-Oseen 256^2 t 1.0 -> 1.2 in {n_lamb} steps: L2 {l2:.6g}, "
            f"Linf {linf:.6g} (torch.fft route {l2_d:.6g}, {linf_d:.6g}); "
            f"{grid} cylinder, {n_steps} steps to t* = {t_star:.4f} (JAX CPU "
            f"{ref['t_star']:.4f}): Cd {cds[-1]:.6f} vs JAX "
            f"{ref['cd'][-1]:.6f}, largest relative deviation over "
            f"{len(ref['steps'])} samples {worst:.3g} (bound 1e-3; the "
            f"shedding band of t* = 200 is beyond a smoke run)")

    physics_2d_phase()

    @phase("2d card vs cpu")
    def parity_2d_phase():
        grid = (32, 64)
        vort = np.random.default_rng(0).standard_normal(grid) * 0.1
        finals = []
        for device in (dev, torch.device("cpu")):
            step, (carry,) = cases._build_cylinder_fsi_case(grid, device=device)
            fs = carry.flow_state
            state = flow_state_from_numpy(
                (vort, fs.velocity_field.cpu().numpy(),
                 fs.eul_grid_forcing_field.cpu().numpy()),
                device=device, dtype=torch.float32)
            reset_counts()
            carry, forces = scan_steps(step, carry._replace(flow_state=state),
                                       3)
            if device.type == "cuda":
                check_2d_route(3, "the 2D parity run")
            finals.append((carry, forces))
        (gpu, f_gpu), (cpu, f_cpu) = finals
        errs = {}
        for what, out, ref in (
                ("vorticity", gpu.flow_state.primary_scalar_field,
                 cpu.flow_state.primary_scalar_field),
                ("velocity", gpu.flow_state.velocity_field,
                 cpu.flow_state.velocity_field),
                ("position mismatch", gpu.vb_state.position_mismatch,
                 cpu.vb_state.position_mismatch),
                ("forces", f_gpu, f_cpu)):
            err = float((out.cpu() - ref).abs().max())
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"cylinder {what}: card vs cpu {err} > {tol}")
            errs[what] = err
        return None, f"{grid} cylinder, 3 steps, max|diff| {errs}"

    parity_2d_phase()

    def check_sharded_calls(shape, mesh_shape, dtype, gen):
        """Every sharded stencil at ``shape`` over ``mesh_shape`` against
        its plain version and against its single-device twin on the
        assembled field, and the sponge at every width its gate takes:
        (calls, errors against the plain versions, the largest difference
        from a twin, the number of checks, the two sharded fields and the
        mesh)."""
        mesh = create_mesh(3, mesh_shape, device=dev)
        w = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
        u = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
        # name -> (the sharded wrapper, its plain version, its single-device
        # twin on the assembled field); the fused sponge only where its gate
        # holds
        calls = sharded_stencil_calls(w, u, mesh, dtype)
        errs, twin_err = {}, 0.0
        where = f"{shape} on {mesh_shape} {dtype}"
        for name, (fn, ref_fn, twin_fn) in calls.items():
            before = by_name[name].launches
            out, ref, twin = fn(), ref_fn(), twin_fn()
            check(by_name[name].launches == before + 1,
                  f"{name} {where}: the wrapper did not count one launch")
            if name == "curl_3d_sharded":
                (out, l1), (ref, l1_ref), (twin, l1_twin) = out, ref, twin
                check(l1.ndim == 0 and l1.device == dev,
                      f"{name} {where}: max |u|_1 is not a 0-d device tensor")
                for other in (l1_ref, l1_twin):
                    rel = abs(float(l1) - float(other)) / float(other)
                    check(rel <= 1e-6, f"{name} {where}: l1_max rel {rel}")
            tol = (1e-12 if dtype == torch.float64
                   else 1e-5 * max(1.0, float(ref.abs().max())))
            err, _ = max_err(out, ref)
            check(err <= tol, f"{name} {where}: max|diff| {err} > {tol} "
                  "against the plain version")
            err_twin, _ = max_err(unshard_vector_field(out, mesh), twin)
            check(err_twin <= tol, f"{name} {where}: max|diff| {err_twin} > "
                  f"{tol} against the single-device kernel")
            errs[name], twin_err = err, max(twin_err, err_twin)
        # the sponge at every width 1 ... 4 its gate takes (each a launch of
        # the fused kernel); where the gate is closed at all four (one-plane
        # shards), the wrapper's route at width 2: the sharded diffusion and
        # the sponge on the assembled field
        ws = shard_vector_field(w, mesh)
        p = torch.tensor(0.05, dtype=dtype, device=dev)
        spo = by_name["diffusion_penalise_vector_3d_sharded"]
        widths = [wd for wd in range(1, 5)
                  if sharded.diffusion_penalise_sharded_supported(
                      shape, mesh, wd)]
        for width in widths or [2]:
            before = spo.launches
            out = sharded.diffusion_penalise_vector_3d_sharded(ws, p, width,
                                                               mesh)
            check(spo.launches == before + (1 if widths else 0),
                  f"sponge width {width} {where}: launches")
            ref = sharded.diffusion_penalise_vector_3d_sharded_ref(
                ws, p, width, mesh)
            twin = kernels.diffusion_penalise_vector_3d(w, p, width)
            tol = (1e-12 if dtype == torch.float64
                   else 1e-5 * max(1.0, float(ref.abs().max())))
            err, _ = max_err(out, ref)
            err_twin, _ = max_err(unshard_vector_field(out, mesh), twin)
            check(max(err, err_twin) <= tol, f"sponge width {width} {where}: "
                  f"max|diff| {err} / {err_twin} > {tol} against the plain "
                  "version / the single-device kernel")
            twin_err = max(twin_err, err_twin)
        torch.cuda.synchronize()
        return calls, errs, twin_err, len(calls) + len(widths or [2]), (
            ws, shard_vector_field(u, mesh), mesh)

    @phase("sharded kernels")
    def sharded_kernel_phase():
        gen = torch.Generator(device=dev).manual_seed(3)
        odd = (3, 34, 66, 65)
        twin_err = 0.0
        n_checked = 0
        for shape, mesh_shape, dtype in (
                (odd, (2, 2), torch.float32), (odd, (2, 3), torch.float64),
                (odd, (17, 1), torch.float32),
                ((3, 64, 64, 64), (2, 2), torch.float64),
                ((3, 64, 64, 64), (64, 1), torch.float32),
                ((3, *SHARDED_GRID), (8, 1), torch.float32),
                ((3, *SHARDED_GRID), (4, 2), torch.float32),
                ((3, *SHARDED_GRID), SHARDED_MESH, torch.float32)):
            calls, errs, e, n, (ws, us, mesh) = check_sharded_calls(
                shape, mesh_shape, dtype, gen)
            twin_err = max(twin_err, e)
            n_checked += n
            if mesh_shape == (64, 1):
                # the sponge's kernel on one-plane shards at width 1, the
                # one width its launcher takes there (the wrapper's gate
                # sends every width to the assembled field)
                out = torch.full_like(ws, float("nan"))
                sharded_kernel_alone(ws, us, mesh, out=out, width=1)[
                    "diffusion_penalise_vector_3d_sharded"]()
                ref = sharded.diffusion_penalise_vector_3d_sharded_ref(
                    ws, 0.05, 1, mesh)
                err, scale = max_err(out, ref)
                check(err <= 1e-5 * max(1.0, scale), "the sponge's kernel "
                      f"on one-plane shards at width 1: max|diff| {err}")
                n_checked += 1
        # the last is the main path's shape: its errors and times are kept
        check(sharded.diffusion_penalise_sharded_supported(
            (3, *SHARDED_GRID), mesh, 2), "the fused sponge's gate is closed "
            "at the main path's shape")
        shape = tuple(ws.shape)
        twins = []
        for name, (fn, ref_fn, twin_fn) in calls.items():
            table[name] = entry(
                name, SOURCE, SHARDED_REPLACES[name][0], errs[name], fn,
                ref_fn, sharded_stencil_work(name, SHARDED_GRID, SHARDED_MESH),
                shape)
            twins.append(f"{name}: single-device twin on the assembled field "
                         f"{median_ms(torch, twin_fn):.4f} ms")
        # the z-marching kernels: plan, and the time a call of the wrapper
        # and of the kernel alone on halos made beforehand takes in a batch
        # of 20 back-to-back calls (CUDA events; the kernel alone's is its
        # device time, the wrapper's may be its host enqueue)
        zmarch = []
        for name, fn in sharded_kernel_alone(ws, us, mesh).items():
            zmarch.append(
                f"{name}: plan {tuple(fn.plan)}; in a batch the wrapper "
                f"{sharded_batched_ms(calls[name][0]):.4f} ms a call, the "
                f"kernel alone {sharded_batched_ms(fn):.4f} ms")
        # what of a wrapper's time is the exchange: one field's two z planes
        # and two y rows
        halo_ms = median_ms(torch, sharded_exchange(ws, mesh))
        detail = "; ".join(line(k, table[k]) for k in SHARDED_REPLACES)
        return None, (
            f"{n_checked} checks at {odd} on (2, 2), (2, 3), (17, 1), 64^3 "
            f"f64 on (2, 2), 64^3 on (64, 1) (one-plane shards), 256^3 on "
            f"(8, 1), (4, 2), (2, 2), the sponge at every width 1-4 its gate "
            f"takes: largest max|diff| from a single-device twin "
            f"{twin_err:.3g}; one launch for all shards: {detail}; "
            f"{'; '.join(twins)}; {'; '.join(zmarch)}; the halo exchange of "
            f"one field (two z planes, two y rows) {halo_ms:.4f} ms [{card}]")

    sharded_kernel_phase()

    sharded_fft = [by_name[name] for name in SHARDED_FFT_LAUNCHES]

    def check_sharded_solves(n_solves, where):
        """Over ``n_solves`` vector solves on SHARDED_MESH: the three
        per-shard passes at their counts, no other FFT pass."""
        for name, per_solve in SHARDED_FFT_LAUNCHES.items():
            count = by_name[name].launches
            check(count == per_solve * n_solves, f"{name} launched {count} "
                  f"times in {n_solves} solves on {where}")
        check_not_launched(
            [fn.__name__ for fn in cuda_fft.KERNELS if fn not in sharded_fft],
            where)

    @phase("sharded solve")
    def sharded_solve_phase():
        n = SHARDED_GRID[0]
        mesh = create_mesh(3, SHARDED_MESH, device=dev)
        one = poisson.UnboundedPoissonSolver3D(n, n, n, device=dev)
        many = poisson.UnboundedPoissonSolver3D(n, n, n, device=dev, mesh=mesh)
        pz, py = SHARDED_MESH
        fxp = many.fourier_greens_times_dx_pow_dim.shape[-1] * py
        check(tuple(many.fourier_greens_times_dx_pow_dim.shape)
              == (pz, py, 2 * n, 2 * n // pz, fxp // py) and fxp >= n + 1,
              "the sharded Green's is not in the Fourier layout")
        gen = torch.Generator(device=dev).manual_seed(4)
        rhs = torch.randn((3, n, n, n), device=dev, generator=gen)
        rhs_s = shard_vector_field(rhs, mesh)
        ref = one.vector_field_solve(rhs)
        reset_counts()
        collectives.reset_counts()
        out = many.vector_field_solve(rhs_s)
        check_sharded_solves(1, "the sharded solve")
        counts = collectives.counts()
        check(counts == {"ppermute": 0, "all_to_all": 4, "pmax": 0, "psum": 0,
                         "apply_assembled": 0},
              f"collectives of a sharded vector solve: {counts}")
        check(tuple(out.shape) == tuple(rhs_s.shape), "solution layout")
        err = (float((unshard_vector_field(out, mesh) - ref).abs().max())
               / float(ref.abs().max()))
        check(err <= 2e-5, f"sharded vs single-device solve: relative {err}")
        ms = median_ms(torch, lambda: many.vector_field_solve(rhs_s))
        one_ms = median_ms(torch, lambda: one.vector_field_solve(rhs))
        return None, (
            f"256^3 vector solve on an in-process {SHARDED_MESH} mesh "
            f"(x-frequency axis padded to {fxp}): {ms:.4f} ms against the "
            f"single-device kernel route's {one_ms:.4f} ms, relative "
            f"max|diff| {err:.3g}; launches a solve {SHARDED_FFT_LAUNCHES}, "
            f"{counts['all_to_all']} all_to_all [{card}]")

    sharded_solve_phase()

    @phase("sharded main path")
    def sharded_main_path_phase():
        n_steps = 20
        runs = {}
        torch.cuda.reset_peak_memory_stats(dev)
        for mesh_shape in (None, SHARDED_MESH):
            step, (carry,) = cases.sharded_flow_case(SHARDED_GRID, mesh_shape,
                                                     device=dev)
            carry, _ = scan_steps(step, carry, 3)
            runs[mesh_shape] = [step, carry]
            if mesh_shape is None:
                peak_one = torch.cuda.max_memory_allocated(dev) / 2**30
                torch.cuda.reset_peak_memory_stats(dev)
        mesh = runs[SHARDED_MESH][0].flow_sim.mesh
        check(mesh is not None and mesh.axis_sizes == SHARDED_MESH,
              "the sharded case holds no mesh")
        # the same initial field on both: after 3 steps the assembled fields
        # agree with the single-device run
        errs = {}
        for what in ("primary_field", "velocity_field"):
            ref = getattr(runs[None][1].flow_state, what)
            field = getattr(runs[SHARDED_MESH][1].flow_state, what)
            check(tuple(field.shape) == (*SHARDED_MESH, 3, 128, 128, 256),
                  f"{what} is not sharded: {tuple(field.shape)}")
            err, scale = max_err(unshard_vector_field(field, mesh), ref)
            check(err <= 1e-4 * max(1.0, scale), f"{what} after 3 steps: "
                  f"sharded vs single-device {err} (|ref| max {scale})")
            errs[what] = err
        results = {}
        for mesh_shape, (step, carry) in runs.items():
            carry, _ = scan_steps(step, carry, 2)
            reset_counts()
            collectives.reset_counts()
            # the step never waits for the device: a synchronising call raises
            carry, dts, s_step = timed_steps(step, carry, n_steps)
            launches = {name: fn.launches for name, fn in by_name.items()
                        if fn.launches}
            results[mesh_shape] = (s_step, launches, collectives.counts())
            fs = carry.flow_state
            for what, t in (("vorticity", fs.primary_field),
                            ("velocity", fs.velocity_field), ("dt", dts)):
                check(bool(torch.isfinite(t).all()), f"non-finite {what}")
            check(bool((dts > 0).all()), "a non-positive timestep")
            runs[mesh_shape][1] = carry
        s_one, launches_one, counts_one = results[None]
        s_many, launches, counts = results[SHARDED_MESH]
        check(not any(counts_one.values()) and not any(
            name in launches_one for name in SHARDED_REPLACES),
            "the single-device step moved data between shards")
        # the forcing curl and the stream function's curl: two a step
        expected = {name: n_steps for name in SHARDED_REPLACES}
        expected["curl_3d_sharded"] = 2 * n_steps
        expected.pop("diffusion_timestep_vector_3d_sharded")  # fused sponge
        expected.update({name: per_solve * n_steps for name, per_solve
                         in SHARDED_FFT_LAUNCHES.items()})
        check(launches == expected, f"launches on the sharded path "
              f"{launches}, expected {expected}")
        for name in expected:
            if name in SHARDED_REPLACES:
                table[name]["launches"] = launches[name]
        per_step = {k: v / n_steps for k, v in counts.items()}
        check(per_step == {"ppermute": 20, "all_to_all": 4, "pmax": 1,
                           "psum": 0, "apply_assembled": 0},
              f"collectives a step on the sharded path: {per_step}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        step, carry = runs[SHARDED_MESH]
        carry, *prof = profile_steps(
            step, carry, 3,
            os.path.join(REPO, "build", "sharded_flow_profile.txt"),
            f"{SHARDED_GRID} flow step on an in-process {SHARDED_MESH} mesh")
        del runs, step, carry
        torch.cuda.empty_cache()
        # the filtered arm (the rod cases' order-1 multiplicative filter):
        # the sharded diffusion kernel alone, then the filter and the sponge
        # on the assembled field, one gather a step
        filtered = {"filter_vorticity": True,
                    "filter_setting_dict": {"order": 1,
                                            "type": "multiplicative"}}
        f_fields, f_times = {}, {}
        for mesh_shape in (None, SHARDED_MESH):
            step, (carry,) = cases.sharded_flow_case(
                SHARDED_GRID, mesh_shape, device=dev, sim_kwargs=filtered)
            carry, _ = scan_steps(step, carry, 3)
            f_fields[mesh_shape] = unshard_vector_field(
                carry.flow_state.primary_field, step.flow_sim.mesh)
            reset_counts()
            collectives.reset_counts()
            carry, _, f_times[mesh_shape] = timed_steps(step, carry, 10)
            del step, carry
        f_err, f_scale = max_err(f_fields[SHARDED_MESH], f_fields[None])
        check(f_err <= 1e-4 * max(1.0, f_scale), "filtered vorticity after 3 "
              f"steps: sharded vs single-device {f_err}")
        f_launches = {name: by_name[name].launches for name in SHARDED_REPLACES}
        check(f_launches == {"diffusion_timestep_vector_3d_sharded": 10,
                             "curl_3d_sharded": 20,
                             "rotational_curl_add_3d_sharded": 10,
                             "diffusion_penalise_vector_3d_sharded": 0},
              f"launches on the filtered sharded path: {f_launches}")
        f_counts = collectives.counts()
        check(f_counts["apply_assembled"] == 10 and f_counts["ppermute"] == 200,
              f"collectives on the filtered sharded path: {f_counts}")
        check(by_name["laplacian_filter_vector_3d"].launches == 10
              and by_name["penalise_field_boundary_vector_3d"].launches == 10,
              "the filter and the sponge did not run once a step on the "
              "assembled field")
        name = "diffusion_timestep_vector_3d_sharded"
        table[name]["launches"] = f_launches[name]
        cells = np.prod(SHARDED_GRID)
        return None, (
            f"256^3 f32 flow only (forcing flow type, free stream, sponge "
            f"2) on an in-process {SHARDED_MESH} mesh: {s_many:.6f} s/step "
            f"({cells / s_many / 1e6:.3f} Mcells/s) against {s_one:.6f} "
            f"s/step ({cells / s_one / 1e6:.3f} Mcells/s) on one device from "
            f"the same field, no host sync in either; after 3 steps "
            f"max|diff| {errs}; launches over {n_steps} steps {launches} "
            f"(single device {launches_one}); a step {per_step}; peak "
            f"{peak:.2f} GiB (single device {peak_one:.2f} GiB); "
            + profile_detail(*prof, s_many)
            + f"; with the order-1 multiplicative filter (filter and sponge "
            f"on the assembled field once a step), 10 timed steps: "
            f"{f_times[SHARDED_MESH]:.6f} s/step against "
            f"{f_times[None]:.6f} on one device, vorticity after 3 steps "
            f"max|diff| {f_err:.3g}, launches {f_launches} [{card}]")

    sharded_main_path_phase()

    @phase("sharded card vs cpu")
    def sharded_parity_phase():
        grid, mesh_shape = (16, 32, 128), (4, 2)
        vort = np.random.default_rng(0).standard_normal((3, *grid)) * 0.1
        finals = []
        for device in (dev, torch.device("cpu")):
            # on the CPU the wrappers run their per-shard plain computation
            # on the exchanged halos
            step, (carry,) = cases.sharded_flow_case(
                grid, mesh_shape, device=device,
                sim_kwargs={"use_kernels": True})
            mesh = step.flow_sim.mesh
            fs = carry.flow_state
            state = flow_state_from_numpy(
                (vort, unshard_vector_field(fs.velocity_field, mesh).cpu()
                 .numpy(), np.zeros_like(vort)),
                device=device, dtype=torch.float32, mesh=mesh)
            reset_counts()
            carry, _ = scan_steps(step, carry._replace(flow_state=state), 3)
            if device.type == "cuda":
                # 2 nz = 32 is below the passes' range: the z pass is
                # torch.fft here, the y passes the kernels
                for name in SHARDED_REPLACES:
                    check((by_name[name].launches > 0) == (
                        name != "diffusion_timestep_vector_3d_sharded"),
                        f"{name}: {by_name[name].launches} launches in the "
                        "sharded parity run")
                check(by_name["fft_pass_padded"].launches == 3
                      and by_name["ifft_pass_truncated"].launches == 3,
                      "the y passes did not run once a step")
            finals.append((carry.flow_state, mesh))
        (gpu, gmesh), (cpu, cmesh) = finals
        errs = {}
        for what in ("primary_field", "velocity_field"):
            ref = unshard_vector_field(getattr(cpu, what), cmesh)
            out = unshard_vector_field(getattr(gpu, what), gmesh).cpu()
            err = float((out - ref).abs().max())
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"sharded {what}: card vs cpu {err} > {tol}")
            errs[what] = err
        return None, f"{grid} on {mesh_shape}, 3 steps, max|diff| {errs}"

    sharded_parity_phase()

    @phase("filter plans")
    def filter_plan_phase():
        """mult_filter_zmarch_kernel and conv_filter_zmarch_kernel under
        every plan their launchers take."""
        gen = torch.Generator(device=dev).manual_seed(7)
        lo = 2 + sharded.ZMARCH_KEEP["filter"]
        hi = sharded.ZMARCH_STAGE_RANGE[1]
        n_checked, worst = 0, {}
        for shape, dtype in (((3, 17, 33, 65), torch.float32),
                             ((3, 34, 66, 64), torch.float64),
                             (ROD_SHAPE, torch.float32),
                             ((3, 256, 256, 256), torch.float32)):
            _, nz, ny, nx = shape
            buf, other = (torch.randn(shape, dtype=dtype, device=dev,
                                      generator=gen) for _ in range(2))
            # one application's res, and the three outputs
            res = kernels.mult_filter_pass_ref(buf)
            refs = ((None, res), (buf, buf - res), (other, other - res))
            tol = (1e-12 if dtype == torch.float64
                   else 1e-5 * max(1.0, float(buf.abs().max()),
                                   float(other.abs().max())))
            out = torch.empty_like(buf)
            entry_fn = getattr(kernels.library(),
                               "sopht_mult_filter_3d_zmarch_"
                               + kernels._SUFFIX[dtype])
            stream = torch.cuda.current_stream().cuda_stream
            err_max = 0.0
            for tile in sharded.ZMARCH_TILES:
                for stages in range(lo, hi + 1):
                    for chunks in (1, 2, 4, 8, 16):
                        plan = sharded.sharded_stencil_plan_of(
                            "filter", 1, nz, ny, nx, buf.element_size(),
                            True, tile, stages, -(-nz // chunks))
                        for orig, ref in refs:
                            out.fill_(float("nan"))
                            rc = entry_fn(
                                buf.data_ptr(),
                                None if orig is None else orig.data_ptr(),
                                out.data_ptr(), nz, ny, nx, *plan.args(),
                                stream)
                            check(rc == 0, f"filter plan {tuple(plan)} at "
                                  f"{shape}: CUDA error {rc}")
                            err, _ = max_err(out, ref)
                            check(err <= tol, f"filter plan {tuple(plan)} "
                                  f"at {shape} {dtype}: max|diff| {err} > "
                                  f"{tol}")
                            err_max = max(err_max, err)
                            n_checked += 1
            worst[str(shape)] = err_max
            del buf, other, res, refs, out
            torch.cuda.empty_cache()
        # the convolution filter's kernel under every plan, orders 1 ... 5
        # (1 and 5 at the rod's shape)
        n_conv, worst_conv = 0, {}
        for shape, dtype, orders in (
                ((3, 17, 33, 65), torch.float32, kernels.CONV_FILTER_ORDERS),
                ((3, 34, 66, 64), torch.float64, kernels.CONV_FILTER_ORDERS),
                (ROD_SHAPE, torch.float32, (1, 5))):
            _, nz, ny, nx = shape
            f = torch.randn(shape, dtype=dtype, device=dev, generator=gen)
            out = torch.empty_like(f)
            entry_fn = getattr(kernels.library(),
                               "sopht_conv_filter_3d_zmarch_"
                               + kernels._SUFFIX[dtype])
            stream = torch.cuda.current_stream().cuda_stream
            err_max = 0.0
            for order in orders:
                ref = kernels.laplacian_filter_vector_3d_ref(f, order,
                                                             "convolution")
                tol = (1e-12 if dtype == torch.float64
                       else 1e-5 * max(1.0, float(ref.abs().max())))
                for tile in sharded.ZMARCH_TILES:
                    for stages in range(sharded.ZMARCH_STAGE_RANGE[0],
                                        sharded.ZMARCH_STAGE_RANGE[1] + 1):
                        for chunks in (1, 2, 4, 8, 16):
                            try:
                                plan = kernels.conv_filter_plan_of(
                                    order, nz, ny, nx, f.element_size(),
                                    True, tile, stages, -(-nz // chunks))
                            except ValueError:  # too many shared bytes
                                continue
                            out.fill_(float("nan"))
                            rc = entry_fn(f.data_ptr(), out.data_ptr(), nz,
                                          ny, nx, order, *plan.args(),
                                          stream)
                            check(rc == 0, f"conv plan {tuple(plan)} order "
                                  f"{order} at {shape}: CUDA error {rc}")
                            err, _ = max_err(out, ref)
                            check(err <= tol, f"conv plan {tuple(plan)} "
                                  f"order {order} at {shape} {dtype}: "
                                  f"max|diff| {err} > {tol}")
                            err_max = max(err_max, err)
                            n_conv += 1
                del ref
            worst_conv[str(shape)] = err_max
            del f, out
            torch.cuda.empty_cache()
        return None, (f"{n_checked} launches (every tile x ring depth x 1, "
                      f"2, 4, 8, 16 z chunks; no orig, orig the field, "
                      f"another orig): largest max|diff| by shape {worst}; "
                      f"conv_filter_zmarch_kernel {n_conv} launches (every "
                      f"tile x ring depth x z chunks, orders 1-5, 1 and 5 at "
                      f"the rod's shape): largest max|diff| {worst_conv}")

    filter_plan_phase()

    @phase("freely rotating rod")
    def free_rod_phase():
        """The freely rotating rod at the example's default size: 20 steps
        on the card with one convolution filter launch a step; the first 3
        against the port's CPU run from the same state; the tip against the
        JAX package's CPU trajectory; 3 profiled steps."""
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "freely_rotating_rod_reference.json")) as f:
            ref = json.load(f)
        check(tuple(ref["grid_size"]) == FREE_ROD_GRID, "reference grid")
        n_steps, n_cpu = ref["n_steps"], 3
        step, carry = cases._build_freely_rotating_rod_case(device=dev)
        check(step.sparse_forcing_window is None, "not the dense IBM path")
        check(isinstance(carry.greens, tuple), "the case's Poisson solve is "
              "not on the kernel route")
        times = [float(carry.time)]
        tips = [carry.rod_state.position[:, -1].cpu().numpy()]
        reset_counts()
        t0 = time.perf_counter()
        for k in range(n_steps):
            carry, _ = step(carry)
            times.append(float(carry.time))
            tips.append(carry.rod_state.position[:, -1].cpu().numpy())
            if k + 1 == n_cpu:
                gpu3 = carry
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t0) / n_steps
        launches = kernels.laplacian_filter_vector_3d.launches
        check(launches == n_steps, f"{launches} filter launches in "
              f"{n_steps} steps")
        table["laplacian_filter_vector_3d convolution"]["launches"] = launches
        others = {fn.__name__: fn.launches for fn in rod_kernels
                  if fn.launches}
        fs, rs = carry.flow_state, carry.rod_state
        for what, t in (("vorticity", fs.primary_field),
                        ("velocity", fs.velocity_field),
                        ("rod", rs.position)):
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        check(tuple(fs.velocity_field.shape) == FREE_ROD_SHAPE,
              "velocity shape")
        # the card against the port's CPU run after n_cpu steps
        cstep, ccarry = cases._build_freely_rotating_rod_case(device="cpu")
        ccarry, _ = scan_steps(cstep, ccarry, n_cpu)
        errs = {}
        for what, out, want, tol in (
                ("vorticity", gpu3.flow_state.primary_field,
                 ccarry.flow_state.primary_field, None),
                ("velocity", gpu3.flow_state.velocity_field,
                 ccarry.flow_state.velocity_field, None),
                ("rod position", gpu3.rod_state.position,
                 ccarry.rod_state.position, TIP_TOL * ref["rod_length"])):
            err = float((out.cpu() - want).abs().max())
            if tol is None:
                tol = 1e-4 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"free rod {what}: card vs cpu {err} > {tol}")
            errs[what] = err
        # the tip against the JAX trajectory, at the card's times
        times, tips = np.asarray(times), np.asarray(tips)
        ref_t, ref_tip = np.asarray(ref["times"]), np.asarray(ref["tip"])
        check(np.isfinite(tips).all(), "non-finite tip")
        inside = times <= ref_t[-1]
        ref_at = np.stack([np.interp(times[inside], ref_t, ref_tip[:, c])
                           for c in range(3)], axis=1)
        dev_max = float(np.abs(tips[inside] - ref_at).max())
        rel = dev_max / ref["rod_length"]
        check(rel <= TIP_TOL, f"free rod tip deviates {rel:.3g} L from the "
              f"JAX trajectory (> {TIP_TOL})")
        moved = float(np.abs(tips[-1] - tips[0]).max())
        substeps = step.stats["substeps"]
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build",
                                         "free_rod_profile.txt"),
            f"{FREE_ROD_GRID} freely rotating rod step")
        return None, (
            f"{FREE_ROD_GRID} f32 flow, f64 rod, order-{FREE_ROD_ORDER} "
            f"convolution filter: {n_steps} steps to t = {times[-1]:.5f}, "
            f"{s_step:.6f} s/step, {substeps} substeps, "
            f"{launches} filter launches, other stencil and pass launches "
            f"{others}; card vs cpu after {n_cpu} steps max|diff| {errs}; "
            f"tip moved {moved:.6g}, max deviation from the JAX trajectory "
            f"{dev_max:.3g} = {rel:.3g} L (bound {TIP_TOL} L); "
            + profile_detail(*prof, s_step) + f" [{card}]")

    free_rod_phase()

    @phase("passive 3d")
    def passive_phase():
        """The point source's L2 error at 64^3 against the JAX run's; 3
        seeded steps of both passive types, card against cpu; the 128^3
        step timed and profiled. The ENO3 advection is plain torch: no
        hand-written kernel but the vector diffusion's may launch."""
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "point_source_reference.json")) as f:
            ref = json.load(f)
        check(tuple(ref["grid_size"]) == PASSIVE_CONV_GRID, "reference grid")
        reset_counts()
        step, carry = cases.point_source_advection_diffusion_case(
            PASSIVE_CONV_GRID, device=dev)
        check(step.flow_sim.flow_type == "passive_vector", "flow type")
        check(step.flow_sim.unbounded_poisson_solver is None,
              "a passive simulator built a Poisson solver")
        t0 = time.perf_counter()
        carry, l2, linf = cases.run_point_source_case(
            step, carry, window=ref["window"])
        s_conv = time.perf_counter() - t0
        check(np.isfinite([l2, linf]).all(), "non-finite error")
        rel = abs(l2 - ref["l2"]) / ref["l2"]
        check(rel <= PASSIVE_L2_TOL, f"point source L2 {l2} is {rel:.3%} from "
              f"the JAX run's {ref['l2']} (> {PASSIVE_L2_TOL:.0%})")
        t_final = float(carry.time)
        # card against cpu: 3 steps of a seeded state of each passive type
        errs = {}
        for flow_type in ("passive_vector", "passive_scalar"):
            rng = np.random.default_rng(3)
            shape = (PASSIVE_PARITY_GRID if flow_type == "passive_scalar"
                     else (3, *PASSIVE_PARITY_GRID))
            field = np.exp(rng.standard_normal(shape))
            velocity = 0.5 + 0.5 * rng.standard_normal(
                (3, *PASSIVE_PARITY_GRID))
            finals = []
            for device in (dev, torch.device("cpu")):
                sim = UnboundedFlowSimulator3D(
                    PASSIVE_PARITY_GRID, 1.0, 2e-3, flow_type=flow_type,
                    device=device)
                sim._set_state(flow_state_from_numpy(
                    (field, velocity, None), device=device,
                    dtype=torch.float32))
                out, _ = scan_steps(build_flow_only_step(sim, dt_prefac=0.5),
                                    init_flow_only_carry(sim), 3)
                finals.append(out.flow_state.primary_field)
            gpu, cpu = finals
            err = float((gpu.cpu() - cpu).abs().max())
            tol = 1e-5 * max(1.0, float(cpu.abs().max()))
            check(err <= tol, f"{flow_type}: card vs cpu {err} > {tol}")
            errs[flow_type] = err
        # the example's default grid, timed
        step, carry = cases.point_source_advection_diffusion_case(
            PASSIVE_GRID, device=dev)
        carry, _ = scan_steps(step, carry, 5)
        carry, dts, s_step = timed_steps(step, carry, 20)
        field = carry.flow_state.primary_field
        check(bool(torch.isfinite(field).all()), "non-finite field")
        check(tuple(field.shape) == (3, *PASSIVE_GRID), "field shape")
        # the ENO3 advection has no kernel (none in JAX either); only the
        # passive_vector diffusion has one the path may take
        check_not_launched(
            [n for n in by_name if n != "diffusion_timestep_vector_3d"],
            "the passive ENO3 transport path")
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build",
                                         "point_source_profile.txt"),
            f"{PASSIVE_GRID} point source step")
        return None, (
            f"{PASSIVE_CONV_GRID} f32 point source to t = {t_final:.5f} in "
            f"{s_conv:.2f} s: L2 {l2:.6g}, Linf {linf:.6g} (JAX CPU L2 "
            f"{ref['l2']:.6g}, Linf {ref['linf']:.6g}; relative {rel:.3g}, "
            f"bound {PASSIVE_L2_TOL}); card vs cpu after 3 steps at "
            f"{PASSIVE_PARITY_GRID} max|diff| {errs}; {PASSIVE_GRID}: "
            f"{s_step:.6f} s/step, {np.prod(PASSIVE_GRID) / s_step / 1e6:.3f} "
            f"Mcells/s, no host sync in the timed steps, hand-written "
            f"kernels launched: "
            f"{ {n: f.launches for n, f in by_name.items() if f.launches} }; " + profile_detail(*prof, s_step) + f" [{card}]")

    passive_phase()

    @phase("2d rod")
    def rod_2d_phase():
        """The 2D rod at (256, 512) timed with launch counts and host syncs;
        at (64, 128) the tip against the JAX trajectory and the first 3
        steps against the port's CPU run."""
        step, carry, _ = cases.flow_past_rod_2d_case(ROD_2D_GRID, device=dev)
        check(step.sparse_forcing_window is None, "not the dense IBM path")
        check(isinstance(carry.greens, tuple), "the 2D rod's Poisson solve "
              "is not on the kernel route")
        carry, _ = scan_steps(step, carry, 5)
        torch.cuda.synchronize()
        reset_counts()
        n_steps = 20
        stats0 = dict(step.stats)
        carry, forces, s_step = timed_steps(step, carry, n_steps,
                                            no_sync=False)
        check_2d_route(n_steps, "the 2D rod path")
        launches = {fn.__name__: fn.launches for fn in route_2d}
        substeps = (step.stats["substeps"] - stats0["substeps"]) / n_steps
        stats0 = dict(step.stats)
        (carry, _), syncs = count_syncs(lambda: scan_steps(step, carry, 3))
        host_reads = step.stats["host_syncs"] - stats0["host_syncs"]
        check(syncs == host_reads == 3,
              f"{syncs} synchronising calls, {host_reads} substep-count "
              f"reads in 3 steps")
        fs, rs = carry.flow_state, carry.rod_state
        for what, t in (("vorticity", fs.primary_scalar_field),
                        ("velocity", fs.velocity_field), ("forces", forces),
                        ("rod", rs.position)):
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        check(tuple(fs.velocity_field.shape) == (2, *ROD_2D_GRID),
              "velocity shape")
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build", "rod_2d_profile.txt"),
            f"{ROD_2D_GRID} 2D rod step")
        main = (f"{ROD_2D_GRID} f32 flow, f64 rod of {rs.position.shape[1] - 1}"
                f" elements: {s_step:.6f} s/step, "
                f"{np.prod(ROD_2D_GRID) / s_step / 1e6:.3f} Mcells/s, "
                f"{substeps:.2f} substeps/step, {syncs / 3:.2f} host "
                f"syncs/step, launches {launches}; "
                + profile_detail(*prof, s_step))

        # the tip against the JAX trajectory, the first 3 steps card vs cpu
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "rod_2d_reference.json")) as f:
            ref = json.load(f)
        grid, n_steps, n_cpu = tuple(ref["grid_size"]), ref["n_steps"], 3
        step, carry, tip_start = cases.flow_past_rod_2d_case(grid, device=dev)
        check(np.array_equal(tip_start, ref["tip_start"]), "tip start")
        times = [float(carry.time)]
        tips = [carry.rod_state.position[:, -1].cpu().numpy()]
        for k in range(n_steps):
            carry, _ = step(carry)
            times.append(float(carry.time))
            tips.append(carry.rod_state.position[:, -1].cpu().numpy())
            if k + 1 == n_cpu:
                gpu3 = carry
        cstep, ccarry, _ = cases.flow_past_rod_2d_case(grid, device="cpu")
        ccarry, _ = scan_steps(cstep, ccarry, n_cpu)
        errs = {}
        for what, out, want in (
                ("vorticity", gpu3.flow_state.primary_scalar_field,
                 ccarry.flow_state.primary_scalar_field),
                ("velocity", gpu3.flow_state.velocity_field,
                 ccarry.flow_state.velocity_field),
                ("rod position", gpu3.rod_state.position,
                 ccarry.rod_state.position),
                ("position mismatch", gpu3.vb_state.position_mismatch,
                 ccarry.vb_state.position_mismatch)):
            err = float((out.cpu() - want).abs().max())
            tol = 1e-4 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"2D rod {what}: card vs cpu {err} > {tol}")
            errs[what] = err
        times, tips = np.asarray(times), np.asarray(tips)
        ref_t, ref_tip = np.asarray(ref["times"]), np.asarray(ref["tip"])
        check(np.isfinite(tips).all(), "non-finite tip")
        inside = times <= ref_t[-1]
        ref_at = np.stack([np.interp(times[inside], ref_t, ref_tip[:, c])
                           for c in range(3)], axis=1)
        dev_max = float(np.abs(tips[inside] - ref_at).max())
        rel = dev_max / ref["rod_length"]
        check(rel <= TIP_TOL, f"2D rod tip deviates {rel:.3g} L from the "
              f"JAX trajectory (> {TIP_TOL})")
        moved = (tips[-1, :2] - tips[0, :2]) / ref["rod_length"]
        return None, (
            main + f"; {grid}: {n_steps} steps to t = {times[-1]:.5f} "
            f"(JAX CPU {ref_t[-1]:.5f}), tip moved ({moved[0]:+.6g}, "
            f"{moved[1]:+.6g}) L, max deviation from the JAX trajectory "
            f"{dev_max:.3g} = {rel:.3g} L (bound {TIP_TOL} L); card vs cpu "
            f"after {n_cpu} steps max|diff| {errs} [{card}]")

    rod_2d_phase()

    @phase("sedimenting sphere")
    def sedimenting_sphere_phase():
        """The sedimenting sphere at 64^3 float64 for 20 steps, against the
        JAX package's trajectory; 3 steps at 32^3 card against cpu."""
        with open(os.path.join(REPO, "sopht_mpi_tpu_torch", "data",
                               "sedimenting_sphere_reference.json")) as f:
            ref = json.load(f)
        check(tuple(ref["grid_size"]) == SEDIMENT_GRID, "reference grid")
        n_steps = ref["n_steps"]
        step, carry, v_t, tau = cases.sedimenting_sphere_case(
            SEDIMENT_GRID, device=dev)
        check(step.uses_sparse_forcing == ref["sparse_forcing"],
              "the sparse window is not the JAX run's")
        solver = step.flow_sim.unbounded_poisson_solver
        doubled = tuple(2 * n for n in SEDIMENT_GRID)
        kernel_route = poisson._kernel_convolve_supported(
            doubled, torch.float64, dev)
        check(not kernel_route and not isinstance(carry.greens, tuple),
              "float64 took the kernel route")
        route = (f"dense torch.fft route (kernel_fft_supported "
                 f"{[cuda_fft.kernel_fft_supported(m) for m in doubled]}, "
                 f"float64 outside the kernel route's float32 gate; fast "
                 f"tier {solver.fast_spectral})")
        reset_counts()
        stats0 = dict(step.stats)
        times, z, vz, oks = [float(carry.time)], [], [], []
        sphere = carry.body_states[0]
        z.append(float(sphere.position[2]))
        vz.append(float(sphere.velocity[2]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            carry, (forces, ok) = step(carry)
            oks.append(ok)
            times.append(float(carry.time))
            sphere = carry.body_states[0]
            z.append(float(sphere.position[2]))
            vz.append(float(sphere.velocity[2]))
        s_host_reads = (time.perf_counter() - t0) / n_steps
        check(bool(torch.stack(oks).all()),
              "the sphere's support left its window")
        launches = {fn.__name__: fn.launches for fn in by_name.values()
                    if fn.launches}
        for name in SPHERE_KERNELS:
            check(launches.get(name, 0) == n_steps,
                  f"{name} launched {launches.get(name, 0)} times in "
                  f"{n_steps} steps")
        check_not_launched(FFT_REPLACES, "the float64 sphere path")
        host_reads = step.stats["host_syncs"] - stats0["host_syncs"]
        fs = carry.flow_state
        for what, t in (("vorticity", fs.primary_field),
                        ("velocity", fs.velocity_field)):
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")
        check(tuple(fs.velocity_field.shape) == (3, *SEDIMENT_GRID),
              "velocity shape")
        # the trajectory against the JAX run's
        check(np.allclose(times, ref["times"], rtol=1e-12, atol=0.0),
              "step times differ from the JAX run's")
        vz_err = float(np.abs(np.subtract(vz, ref["v_z"])).max())
        vz_scale = float(np.abs(ref["v_z"]).max())
        z_err = float(np.abs(np.subtract(z, ref["z"])).max())
        check(vz_err <= SEDIMENT_VZ_TOL * vz_scale,
              f"z velocity deviates {vz_err} from the JAX run (> "
              f"{SEDIMENT_VZ_TOL} x {vz_scale})")
        check(z_err <= SEDIMENT_Z_TOL, f"z position deviates {z_err} from "
              f"the JAX run (> {SEDIMENT_Z_TOL})")
        # the step alone, timed without the host reads of the trajectory;
        # one static substep a step: a synchronising call raises
        carry, _, s_step = timed_steps(step, carry, n_steps)
        carry, *prof = profile_steps(
            step, carry, 3, os.path.join(REPO, "build",
                                         "sedimenting_sphere_profile.txt"),
            f"{SEDIMENT_GRID} sedimenting sphere step, float64")
        # card against cpu after 3 steps
        finals = []
        for device in (dev, torch.device("cpu")):
            pstep, pcarry, _, _ = cases.sedimenting_sphere_case(
                SEDIMENT_PARITY_GRID, device=device)
            pcarry, _ = scan_steps(pstep, pcarry, 3)
            finals.append(pcarry)
        gpu, cpu = finals
        errs = {}
        for what, out, want in (
                ("vorticity", gpu.flow_state.primary_field,
                 cpu.flow_state.primary_field),
                ("velocity", gpu.flow_state.velocity_field,
                 cpu.flow_state.velocity_field),
                ("sphere position", gpu.body_states[0].position,
                 cpu.body_states[0].position),
                ("sphere velocity", gpu.body_states[0].velocity,
                 cpu.body_states[0].velocity),
                ("position mismatch", gpu.vb_states[0].position_mismatch,
                 cpu.vb_states[0].position_mismatch)):
            err = float((out.cpu() - want).abs().max())
            tol = 1e-9 * max(1.0, float(want.abs().max()))
            check(err <= tol, f"sedimenting sphere {what}: card vs cpu {err} "
                  f"> {tol}")
            errs[what] = err
        return None, (
            f"{SEDIMENT_GRID} f64, window {step.body_windows}, {route}: "
            f"{n_steps} steps to t = {times[-1]:.6g} = {times[-1] / tau:.4g} "
            f"tau, v_z {vz[-1]:.6g} = {vz[-1] / -v_t:.4g} v_t, windows ok; "
            f"max deviation from the JAX trajectory v_z {vz_err:.3g} (bound "
            f"{SEDIMENT_VZ_TOL} x {vz_scale:.4g}), z {z_err:.3g} (bound "
            f"{SEDIMENT_Z_TOL}); {s_step:.6f} s/step ({s_host_reads:.6f} with "
            f"the trajectory's host reads), {host_reads / n_steps:.2f} "
            f"substep-count reads/step, no host sync in the timed steps, "
            f"launches {launches}; " + profile_detail(*prof, s_step)
            + f"; card vs cpu after 3 steps at {SEDIMENT_PARITY_GRID} "
            f"max|diff| {errs} [{card}]")

    sedimenting_sphere_phase()

    from sopht_mpi_tpu_torch import _build
    from sopht_mpi_tpu_torch.utils import (
        AsyncFieldDumper,
        CarryCheckpointer,
        measure_op_time,
        native_io,
    )
    from sopht_mpi_tpu_torch.utils.checkpoint import _flatten

    def carry_gap(a, b):
        """Largest |difference| between the tensors of two trees of the
        same structure."""
        fa, fb = _flatten(a), _flatten(b)
        check(fa.keys() == fb.keys(), "the two carries differ in structure")
        return max((float((fa[k].double() - fb[k].double()).abs().max())
                    for k in fa if fa[k].numel()), default=0.0)

    def restart_bound(floor):
        return 0.0 if floor == 0.0 else RESTART_FLOOR_FACTOR * floor

    def fresh_dir(name):
        path = os.path.join(REPO, "build", name)
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        return path

    def load_example(name, dim="3d"):
        """``examples_torch/<dim>/<name>.py`` as a module."""
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{dim}_{name}",
            os.path.join(REPO, "examples_torch", dim, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    @phase("io")
    def io_phase():
        """The native dumper on a 256^3 field from the card; the 256^3
        sphere carry saved, restored and stepped; measure_op_time."""
        io_dir = fresh_dir("io_phase")
        try:
            dumper = AsyncFieldDumper()
            lib_path = os.path.realpath(native_io.library().path)
            check(dumper.is_native, "the dumper is not the native writer")
            check(os.path.dirname(lib_path)
                  == os.path.realpath(_build.BUILD_DIR),
                  f"the dumper's library {lib_path} is not in build/")
            gen = torch.Generator(device=dev).manual_seed(28)
            field = torch.randn((3, *IO_GRID), device=dev, generator=gen)
            path = os.path.join(io_dir, "field.npy")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dumper.dump(path, field)
            dump_s = time.perf_counter() - t0
            dumper.flush()
            write_s = time.perf_counter() - t0
            check(dumper.failed() == 0, f"{dumper.failed()} failed writes")
            # the queueing's two parts: the device-to-host copy and the
            # writer's copy of those bytes into its queue
            t0 = time.perf_counter()
            host = field.cpu().numpy()
            d2h_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            np.array(host, copy=True)
            memcpy_s = time.perf_counter() - t0
            check(np.array_equal(np.load(path), host),
                  "the dumped field does not load back equal")
            dumper.close()
            dump = (f"dumper {os.path.basename(lib_path)}: a {field.nbytes / 2**20:.0f} "
                    f"MiB field queued in {dump_s * 1e3:.3f} ms (a second "
                    f"device-to-host copy alone {d2h_s * 1e3:.3f} ms, a host "
                    f"copy into fresh memory {memcpy_s * 1e3:.3f} ms), on disk "
                    f"after {write_s * 1e3:.3f} ms, loads back equal")
            del host
            del field

            step, (carry,) = cases._build_fsi_case(IO_GRID, device=dev)
            check(isinstance(carry.greens, tuple), f"the {IO_GRID} carry "
                  "holds no split Green's pair")
            carry, _ = scan_steps(step, carry, 5)
            ref_a, _ = scan_steps(step, carry, 5)
            ref_b, _ = scan_steps(step, carry, 5)
            floor = carry_gap(ref_a, ref_b)
            nbytes = sum(t.nbytes for t in _flatten(carry).values())
            ckpt = CarryCheckpointer(os.path.join(io_dir, "carry"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(5, carry)
            copy_s = time.perf_counter() - t0
            ckpt.wait_until_finished()
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            restored = ckpt.restore(template=carry)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            ckpt.close()
            check(carry_gap(restored, carry) == 0.0,
                  "the restored carry differs from the saved one")
            check(restored.greens[0].device == dev, "restored off the card")
            out, _ = scan_steps(step, restored, 5)
            gap = carry_gap(out, ref_a)
            check(gap <= restart_bound(floor),
                  f"5 steps from the restored carry differ by {gap} from 5 "
                  f"from the original (two unbroken runs: {floor})")
            del carry, ref_a, ref_b, restored, out

            w = torch.randn((3, *IO_GRID), device=dev, generator=gen)
            p = torch.tensor(0.25, device=dev)
            op_s = measure_op_time(lambda x: kernels.curl_3d(x, p), w,
                                   iters=20, repeats=3)
        finally:
            shutil.rmtree(io_dir, ignore_errors=True)
        return None, (
            f"{dump}; {IO_GRID} sphere carry ({nbytes / 2**20:.1f} MiB, Green's "
            f"pair included): save {copy_s * 1e3:.3f} ms to the host copy, "
            f"{save_s * 1e3:.3f} ms to the file, restore {restore_s * 1e3:.3f}"
            f" ms; 5 steps from the restored carry vs the original max|diff| "
            f"{gap:.3g}, two unbroken runs {floor:.3g} (bound "
            f"{restart_bound(floor):.3g}); measure_op_time curl_3d {IO_GRID} "
            f"{op_s * 1e3:.4f} ms a call (chain of 20, best of 3), phase 3's "
            f"event median {table['curl_3d']['ms']:.4f} ms [{card}]")

    io_phase()

    @phase("sphere driver")
    def sphere_driver_phase():
        """The fused sphere driver with and without a snapshot at every
        window end, in turns."""
        mod = load_example("flow_past_sphere")
        rec = {}
        scan = mod.scan_steps

        def recording_scan(step, carry, n):
            carry, diag = scan(step, carry, n)
            torch.cuda.synchronize()
            rec["carries"].append(carry)
            rec["steps"] += n
            rec["ends"].append(time.perf_counter())
            return carry, diag

        class TimedWriter(mod.SnapshotWriter):
            def maybe_save(self, t, **fields):
                t0 = time.perf_counter()
                saved = super().maybe_save(t, **fields)
                rec["save_s"].append(time.perf_counter() - t0)
                return saved

        mod.scan_steps = recording_scan
        mod.SnapshotWriter = TimedWriter
        cwd = os.getcwd()
        run_dir = fresh_dir("sphere_driver")
        windows = {False: [], True: []}
        try:
            for k, snaps in enumerate((False, True, True, False)):
                shutil.rmtree(run_dir)
                os.makedirs(run_dir)
                os.chdir(run_dir)
                rec.update(carries=[], steps=0, ends=[], save_s=[])
                first_snap_run = snaps and not windows[True]
                if first_snap_run:
                    reset_counts()
                times, cds = mod.flow_past_sphere_fused_case(
                    nondim_time=SPHERE_DRIVER_T, grid_size=SPHERE_DRIVER_GRID,
                    save_interval=1e-9 if snaps else None, device=dev)
                os.chdir(cwd)
                n_win = len(rec["carries"])
                check(n_win >= 2 and len(cds) == n_win,
                      f"{n_win} windows, {len(cds)} drags")
                check(np.isfinite(cds).all(), f"non-finite Cd {cds}")
                windows[snaps].append(np.diff(rec["ends"]))
                if not first_snap_run:
                    continue
                steps = rec["steps"]
                launches = {n: by_name[n].launches for n in
                            ("fft_greens_ifft_pass", "irfft_pass_merge")}
                for name, count in launches.items():
                    check(count == steps, f"{name} launched {count} times in "
                          f"{steps} steps of the sphere driver")
                snap_dir = os.path.join(run_dir, "snapshots")
                manifest = np.loadtxt(os.path.join(snap_dir, "times.csv"),
                                      delimiter=",", skiprows=1, ndmin=2)
                check(manifest.shape == (n_win, 2) and np.array_equal(
                    manifest[:, 0], np.arange(n_win)), "times.csv rows")
                for i, c in enumerate(rec["carries"]):
                    check(manifest[i, 1] == float(c.time),
                          f"times.csv row {i}: {manifest[i, 1]} is not the "
                          f"window's time {float(c.time)}")
                    for name, f in (("vorticity", c.flow_state.primary_field),
                                    ("velocity", c.flow_state.velocity_field)):
                        snap = np.load(os.path.join(snap_dir,
                                                    f"{name}_{i:04d}.npy"))
                        check(np.array_equal(snap, f.cpu().numpy()),
                              f"snapshot {name}_{i:04d} is not the carry's")
                drag = np.loadtxt(os.path.join(run_dir, "drag_vs_time.csv"),
                                  delimiter=",", ndmin=2)
                check(drag.shape == (n_win, 2), "drag_vs_time.csv rows")
                first = (f"{n_win} windows of {steps // n_win} steps to t* = "
                         f"{times[-1]:.4f}, Cd {cds[-1]:.4f}, {2 * n_win} "
                         f"snapshots equal to the carry, times.csv right, "
                         f"launches {launches} in {steps} steps; writer "
                         f"{np.mean(rec['save_s']) * 1e3:.3f} ms a snapshot "
                         f"({np.array2string(np.asarray(rec['save_s']) * 1e3, precision=3)} ms)")
        finally:
            os.chdir(cwd)
            shutil.rmtree(run_dir, ignore_errors=True)
        walls = {k: [float(np.mean(w)) * 1e3 for w in v]
                 for k, v in windows.items()}
        return None, (
            f"{SPHERE_DRIVER_GRID} f32: {first}; a window's wall (after the "
            f"first) in turns without / with / with / without snapshots: "
            f"{walls[False][0]:.3f} / {walls[True][0]:.3f} / "
            f"{walls[True][1]:.3f} / {walls[False][1]:.3f} ms, snapshot "
            f"overhead {np.mean(walls[True]) - np.mean(walls[False]):.3f} ms "
            f"a window [{card}]")

    sphere_driver_phase()

    @phase("freely rotating rod restart")
    def free_rod_restart_phase():
        """The fused freely rotating rod driver with the carry backend:
        restarted against unbroken."""
        mod = load_example("flow_past_freely_rotating_rod")
        rec = {"steps": 0}
        scan = mod.scan_steps

        def counting_scan(step, carry, n):
            rec["steps"] += n
            return scan(step, carry, n)

        mod.scan_steps = counting_scan
        base = fresh_dir("free_rod_restart")
        t1, t2 = FREE_ROD_RESTART_T

        def run(name, final_time, restart=False):
            t0 = time.perf_counter()
            rod, sim = mod.flow_past_freely_rotating_rod_case(
                final_time=final_time, fused=True,
                checkpoint_backend="carry",
                restart_dir=os.path.join(base, name),
                restart_simulation=restart, device=dev)
            torch.cuda.synchronize()
            fields = {"vorticity": sim.vorticity_field,
                      "velocity": sim.velocity_field,
                      **{f"rod {k}": v for k, v in rod.state._asdict().items()}}
            return fields, sim.time, time.perf_counter() - t0

        try:
            rec["steps"] = 0
            ref_a, time_a, wall_a = run("unbroken_a", t2)
            steps = rec["steps"]
            ref_b, time_b, _ = run("unbroken_b", t2)
            floor = carry_gap(ref_a, ref_b)
            rec["steps"] = 0
            _, time_1, _ = run("restart", t1)
            first_steps = rec["steps"]
            check(t2 > time_1 >= t1, f"first leg ended at t = {time_1}")
            rec["steps"] = 0
            reset_counts()
            out, time_2, wall_2 = run("restart", t2, restart=True)
            restart_steps = rec["steps"]
            launches = kernels.laplacian_filter_vector_3d.launches
            check(launches == restart_steps,
                  f"conv_filter_zmarch_kernel launched {launches} times in "
                  f"{restart_steps} steps")
            check(first_steps + restart_steps == steps,
                  f"{first_steps} + {restart_steps} steps restarted, {steps} "
                  f"unbroken")
            for what, t in out.items():
                check(bool(torch.isfinite(t).all()), f"non-finite {what}")
            gap = carry_gap(out, ref_a)
            check(floor == 0.0, f"two unbroken runs differ by {floor}")
            check(gap == 0.0, f"restarted run differs by {gap} from the "
                  f"unbroken one")
            files = sorted(os.listdir(os.path.join(base, "restart", "carry")))
        finally:
            shutil.rmtree(base, ignore_errors=True)
        return None, (
            f"{FREE_ROD_GRID} f32 flow, f64 rod, carry backend: unbroken "
            f"{steps} steps to t = {time_a!r} (again: {time_b!r}) in "
            f"{wall_a:.2f} s; restarted at t = {time_1:.6f} after "
            f"{first_steps} steps, {restart_steps} more steps to {time_2!r} "
            f"in {wall_2:.2f} s, {launches} filter launches; "
            f"checkpoints {files}; restarted vs unbroken and two unbroken "
            f"runs bit-equal [{card}]")

    free_rod_restart_phase()

    # the paths of the drivers below: the rod paths run the filtered
    # transport, the sphere paths the fused diffusion; all the exact tier
    rod_path = (*TRANSPORT_KERNELS, "rotational_curl_add_3d", "curl_3d",
                *FFT_REPLACES)

    def recording(mod):
        """Wrap ``mod.scan_steps``: count the steps, time each window to a
        synchronise, keep the last carry."""
        rec = {"steps": 0, "walls": [], "windows": [], "last": None}
        scan = mod.scan_steps

        def wrapped(step, carry, n, **kwargs):
            t0 = time.perf_counter()
            carry, diag = scan(step, carry, n, **kwargs)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["windows"].append(n)
            rec["steps"] += n
            rec["last"] = carry
            return carry, diag

        mod.scan_steps = wrapped
        return rec

    def window_times(rec):
        """(s/step over the windows after the first, the median window's
        wall in ms); the first window holds the step's first-call work."""
        walls, sizes = rec["walls"], rec["windows"]
        if len(walls) > 1:
            walls, sizes = walls[1:], sizes[1:]
        return sum(walls) / sum(sizes), float(np.median(walls)) * 1e3

    def check_launches(names, steps, where):
        launches = {n: by_name[n].launches for n in names}
        for name, count in launches.items():
            check(count >= steps, f"{name} launched {count} times in {steps} "
                  f"steps of {where}")
        return launches

    def check_finite(what, *tensors):
        for t in tensors:
            t = torch.as_tensor(t)
            check(bool(torch.isfinite(t).all()), f"non-finite {what}")

    def in_dir(name, fn):
        """``fn()`` with the working directory a fresh ``build/<name>``,
        removed after; returns (fn's result, the files it left)."""
        path, cwd = fresh_dir(name), os.getcwd()
        try:
            os.chdir(path)
            out = fn()
            return out, sorted(os.listdir(path))
        finally:
            os.chdir(cwd)
            shutil.rmtree(path, ignore_errors=True)

    @phase("3d rod driver")
    def rod_driver_phase():
        """The 3D rod driver's fused loop at the example's default: a first
        window too small for the rod, tripped, regrown and replayed, against
        the run with the grown window from the start, bit for bit, and
        that run again."""
        mod = load_example("flow_past_rod")
        suggest = mod.suggest_rod_forcing_window
        rec = recording(mod)
        calls, windows = [], []

        def small_first(interactor, rod, grid_size, margin=1.1, **kwargs):
            calls.append(margin)
            windows.append(suggest(interactor, rod, grid_size,
                                   margin=0.5 if len(calls) == 1 else 1.1,
                                   **kwargs))
            return windows[-1]

        nx = ROD_DRIVER_GRID[-1]
        kwargs = dict(n_elem=5 * nx // 16, grid_size=ROD_DRIVER_GRID,
                      surface_grid_density_for_largest_element=nx // 8,
                      final_time=ROD_DRIVER_T, window=ROD_DRIVER_WINDOW,
                      fused=True, device=dev)
        runs = {}
        try:
            for name in ("tripped", "grown", "grown again"):
                mod.suggest_rod_forcing_window = (
                    small_first if name == "tripped" else suggest)
                rec.update(steps=0, walls=[], windows=[], last=None)
                reset_counts()
                (times, tips), _ = in_dir(
                    "rod_driver", lambda: mod.flow_past_rod_case(**kwargs))
                runs[name] = dict(
                    times=times, tips=tips, carry=rec["last"],
                    steps=rec["steps"], timing=window_times(rec),
                    launches=check_launches(rod_path, rec["steps"],
                                            f"the 3D rod driver ({name})"))
        finally:
            mod.suggest_rod_forcing_window = suggest
        trip, grown, again = (runs[k] for k in
                              ("tripped", "grown", "grown again"))
        check(len(calls) == 2 and calls[0] == 1.1
              and abs(calls[1] - 1.43) < 1e-9 and windows[1] is not None,
              f"no trip and regrow on the sparse window: margins {calls}, "
              f"windows {windows}")
        check(trip["steps"] == grown["steps"] + ROD_DRIVER_WINDOW,
              f"{trip['steps']} steps with the replay, {grown['steps']} "
              f"without: not one window replayed")
        check(np.array_equal(trip["times"], grown["times"])
              and np.array_equal(trip["tips"], grown["tips"])
              and carry_gap(trip["carry"], grown["carry"]) == 0.0,
              "the replayed run is not the grown-window run bit for bit")
        check(carry_gap(grown["carry"], again["carry"]) == 0.0
              and np.array_equal(grown["tips"], again["tips"]),
              "two runs with the grown window differ")
        check(len(grown["times"]) >= 2, f"{len(grown['times'])} windows")
        check_finite("3D rod driver tips", grown["tips"])
        fs = grown["carry"].flow_state
        check_finite("3D rod driver fields", fs.primary_field,
                     fs.velocity_field, grown["carry"].rod_state.position)
        s_step, win_ms = grown["timing"]
        return None, (
            f"{ROD_DRIVER_GRID} f32 flow, f64 rod of {kwargs['n_elem']} "
            f"elements, windows of {ROD_DRIVER_WINDOW}: window "
            f"{windows[0]} tripped in the first window, regrown to "
            f"{windows[1]} and replayed; {len(grown['times'])} windows to "
            f"t = {grown['times'][-1]:.5f}, tip {grown['tips'][-1]}; the "
            f"replayed run equals the grown-window run bit for bit "
            f"({trip['steps']} and {grown['steps']} steps), two grown-window "
            f"runs bit-equal; {s_step:.6f} s/step, a window {win_ms:.3f} ms; "
            f"launches {grown['launches']} in {grown['steps']} steps [{card}]")

    rod_driver_phase()

    @phase("rod and sphere driver")
    def rod_and_sphere_driver_phase():
        mod = load_example("rod_and_sphere")
        rec = recording(mod)
        reset_counts()
        (times, tips, cds), _ = in_dir(
            "rod_and_sphere_driver", lambda: mod.rod_and_sphere_case(
                final_time=ROD_SPHERE_DRIVER_T, device=dev))
        launches = check_launches(rod_path, rec["steps"],
                                  "the rod and sphere driver")
        check(len(times) >= 2, f"{len(times)} windows")
        check_finite("rod and sphere outputs", times, tips, cds)
        fs = rec["last"].flow_state
        check_finite("rod and sphere fields", fs.primary_field,
                     fs.velocity_field)
        s_step, win_ms = window_times(rec)
        return None, (
            f"(32, 32, 64) f32 flow, f64 rod of 8 elements and a fixed "
            f"sphere, windows of 20: {len(times)} windows to t = "
            f"{times[-1]:.5f}, tip {tips[-1]}, sphere Cd {cds[-1]:.5f}; "
            f"{s_step:.6f} s/step, a window {win_ms:.3f} ms; launches "
            f"{launches} in {rec['steps']} steps [{card}]")

    rod_and_sphere_driver_phase()

    @phase("sedimenting sphere driver")
    def sedimenting_driver_phase():
        mod = load_example("sedimenting_sphere")
        rec = recording(mod)
        reset_counts()
        (times, vz, v_t), _ = in_dir(
            "sedimenting_driver", lambda: mod.sedimenting_sphere_case(
                n_tau=SEDIMENT_DRIVER_N_TAU, device=dev))
        launches = check_launches(SPHERE_KERNELS, rec["steps"],
                                  "the sedimenting sphere driver")
        check_not_launched(FFT_REPLACES, "the float64 sedimenting driver")
        check(len(times) >= 2, f"{len(times)} windows")
        check_finite("sedimenting sphere outputs", times, vz)
        s_step, win_ms = window_times(rec)
        return None, (
            f"{SEDIMENT_GRID} f64, windows of 10: {len(times)} windows to "
            f"{SEDIMENT_DRIVER_N_TAU} tau, v_z / v_t {vz[-1] / -v_t:.5f}; "
            f"{s_step:.6f} s/step, a window {win_ms:.3f} ms; launches "
            f"{launches} in {rec['steps']} steps [{card}]")

    sedimenting_driver_phase()

    @phase("lamb oseen driver")
    def lamb_oseen_driver_phase():
        mod = load_example("lamb_oseen_vortex", "2d")
        rec = recording(mod)
        out = {}
        for fused in (True, False):
            reset_counts()
            t0 = time.perf_counter()
            errs, _ = in_dir("lamb_oseen_driver",
                             lambda: mod.lamb_oseen_vortex_flow_case(
                                 fused=fused, device=dev))
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in route_2d}
            check(min(launches.values()) > 0, f"2D route launches {launches}")
            check_finite("Lamb-Oseen errors", errs)
            out[fused] = (errs, launches, wall)
        fused_steps = rec["steps"]
        l2_f, l2_h = out[True][0][0], out[False][0][0]
        check(abs(l2_f - l2_h) <= LAMB_OSEEN_LOOP_RTOL * l2_h,
              f"fused L2 {l2_f} against the host loop's {l2_h}")
        s_step, win_ms = window_times(rec)
        return None, (
            f"(256, 256) f32 to t = 1.4: fused (windows of 100) L2 / Linf "
            f"{out[True][0][0]:.6g} / {out[True][0][1]:.6g}, host loop "
            f"{out[False][0][0]:.6g} / {out[False][0][1]:.6g} (bound "
            f"{LAMB_OSEEN_LOOP_RTOL} relative between the loops); fused "
            f"{fused_steps} steps, {s_step:.6f} s/step, a window "
            f"{win_ms:.3f} ms, launches {out[True][1]}; host loop "
            f"{out[False][2]:.2f} s, launches {out[False][1]} [{card}]")

    lamb_oseen_driver_phase()

    @phase("cylinder driver")
    def cylinder_driver_phase():
        mod = load_example("flow_past_cylinder", "2d")
        rec = recording(mod)
        reset_counts()
        (times, cds), files = in_dir(
            "cylinder_driver", lambda: mod.flow_past_cylinder_fused_case(
                nondim_final_time=CYLINDER_DRIVER_T, window=100,
                device=dev))
        check("drag_vs_time.csv" in files, f"files {files}")
        check_2d_route(rec["steps"], "the fused cylinder driver")
        check(len(times) >= 2, f"{len(times)} windows")
        check_finite("cylinder drag", times, cds)
        s_step, win_ms = window_times(rec)
        reset_counts()
        t0 = time.perf_counter()
        (htimes, hcds), hfiles = in_dir(
            "cylinder_driver", lambda: mod.
            flow_past_cylinder_boundary_forcing_case(
                nondim_final_time=CYLINDER_DRIVER_T / 2,
                save_diagnostic=True, device=dev))
        host_wall = time.perf_counter() - t0
        host = {fn.__name__: fn.launches for fn in route_2d}
        check(min(host.values()) > 0 and "drag_vs_time.csv" in hfiles,
              f"host loop: launches {host}, files {hfiles}")
        check_finite("cylinder host-loop drag", htimes, hcds)
        return None, (
            f"{CYLINDER_GRID} f32: fused (windows of 100) {len(times)} "
            f"windows to t* = {times[-1]:.4f}, Cd {cds[-1]:.5f}, "
            f"{s_step:.6f} s/step, a window {win_ms:.3f} ms, "
            f"{rec['steps']} launches each of the 2D route's three passes "
            f"in {rec['steps']} steps; host loop to t* = "
            f"{CYLINDER_DRIVER_T / 2}: {len(htimes)} drag reads, Cd "
            f"{hcds[-1]:.5f}, {host_wall:.2f} s, launches {host} [{card}]")

    cylinder_driver_phase()

    @phase("2d rod driver")
    def rod_2d_driver_phase():
        mod = load_example("flow_past_rod", "2d")
        rec = recording(mod)
        reset_counts()
        (times, tips), files = in_dir(
            "rod_2d_driver", lambda: mod.flow_past_rod_case(
                nondim_final_time=ROD_2D_DRIVER_T, window=20, fused=True,
                device=dev))
        check_2d_route(rec["steps"], "the fused 2D rod driver")
        check("rod_tip_position_vs_time.csv" in files, f"files {files}")
        check(len(times) >= 2, f"{len(times)} windows")
        check_finite("2D rod tips", times, tips)
        s_step, win_ms = window_times(rec)
        reset_counts()
        t0 = time.perf_counter()
        (htimes, htips), hfiles = in_dir(
            "rod_2d_driver", lambda: mod.flow_past_rod_case(
                nondim_final_time=ROD_2D_DRIVER_T / 2, fused=False,
                device=dev))
        host_wall = time.perf_counter() - t0
        host = {fn.__name__: fn.launches for fn in route_2d}
        check(min(host.values()) > 0
              and "rod_tip_position_vs_time.csv" in hfiles,
              f"host loop: launches {host}, files {hfiles}")
        check_finite("2D rod host-loop tips", htimes, htips)
        return None, (
            f"{ROD_2D_GRID} f32 flow, f64 rod: fused (windows of 20) "
            f"{len(times)} windows to t* = {times[-1]:.5f}, tip "
            f"({tips[-1][0]:+.6f}, {tips[-1][1]:+.6f}) L, {s_step:.6f} "
            f"s/step, a window {win_ms:.3f} ms, {rec['steps']} launches each "
            f"of the 2D route's passes in {rec['steps']} steps; host loop to "
            f"t* = {ROD_2D_DRIVER_T / 2}: {len(htimes)} tip reads, "
            f"{host_wall:.2f} s, launches {host} [{card}]")

    rod_2d_driver_phase()

    @phase("kernel gradients")
    def kernel_gradients_phase():
        """Each wrapper's gradient through its ``torch.autograd.Function``
        (the kernel's forward, the JAX package's rule as the backward)
        against torch autograd through the plain version, at the kernel
        table's shapes; the backward's time (CUDA events, median of 20)
        goes into the table's row as ``backward_ms``."""
        gen = torch.Generator(device=dev).manual_seed(37)

        def r(*shape, dtype=torch.float32):
            return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

        def as_tuple(out):
            return out if isinstance(out, tuple) else (out,)

        def grads_of(fn, args, wrt, cts=None):
            leaves = [a.detach().clone().requires_grad_(i in wrt)
                      if torch.is_tensor(a) else a
                      for i, a in enumerate(args)]
            outs = as_tuple(fn(*leaves))
            if cts is None:
                cts = [r(*o.shape, dtype=o.dtype) for o in outs]
            inputs = [leaves[i] for i in wrt]
            got = torch.autograd.grad(outs, inputs, cts, retain_graph=True)
            return got, outs, inputs, cts

        def grad_check(name, fn, ref_fn, args, wrt, fft_pass):
            got, outs, inputs, cts = grads_of(fn, args, wrt)
            want, *_ = grads_of(ref_fn, args, wrt, cts)
            err = 0.0
            for i, g, w in zip(wrt, got, want):
                e, scale = max_err(g, w)
                tol = (FFT_TOL * scale if fft_pass else 1e-12
                       if w.dtype == torch.float64 else 1e-5 * max(1.0, scale))
                check(e <= tol, f"{name}: gradient of argument {i}: "
                      f"max|diff| {e} > {tol} against the plain version")
                err = max(err, e)
            ms = median_ms(torch, lambda: torch.autograd.grad(
                outs, inputs, cts, retain_graph=True))
            return err, ms

        results = {}

        def run(name, fn, ref_fn, args, wrt, fft_pass=False, row=None):
            err, ms = grad_check(name, fn, ref_fn, args, wrt, fft_pass)
            results[name] = (err, ms)
            if row is not None:
                table[row]["backward_ms"] = ms
                table[row]["backward_max_abs_err"] = err
            torch.cuda.empty_cache()

        # the single-device stencils at their rows' shapes, float32, and at
        # 64^3 float64
        for shape, dtype in ((TABLE_GRID, torch.float32),
                             ((64, 64, 64), torch.float64)):
            keep = dtype == torch.float32
            w, u = r(3, *shape, dtype=dtype), r(3, *shape, dtype=dtype)
            p = torch.tensor(0.05, dtype=dtype, device=dev)
            add = torch.tensor([1.0, -0.5, 0.25], dtype=dtype, device=dev)
            tag = "" if keep else " f64"
            run("rotational_curl_add_3d" + tag, kernels.rotational_curl_add_3d,
                kernels.rotational_curl_add_3d_ref, (w, u, p), (0, 1, 2),
                row="rotational_curl_add_3d" if keep else None)
            run("diffusion_penalise_vector_3d" + tag,
                kernels.diffusion_penalise_vector_3d,
                kernels.diffusion_penalise_vector_3d_ref, (w, p, 2), (0, 1),
                row="diffusion_penalise_vector_3d" if keep else None)
            run("curl_3d" + tag, kernels.curl_3d, kernels.curl_3d_ref,
                (w, p, add, True), (0, 1, 2),
                row="curl_3d" if keep else None)
            del w, u
        for shape, dtype in ((ROD_SHAPE, torch.float32),
                             ((3, 64, 64, 64), torch.float64)):
            keep = dtype == torch.float32
            tag = "" if keep else " f64"
            w = r(*shape, dtype=dtype)
            p = torch.tensor(0.13, dtype=dtype, device=dev)
            run("diffusion_timestep_vector_3d" + tag,
                kernels.diffusion_timestep_vector_3d,
                kernels.diffusion_timestep_vector_3d_ref, (w, p), (0, 1),
                row="diffusion_timestep_vector_3d" if keep else None)
            run("laplacian_filter_vector_3d" + tag,
                kernels.laplacian_filter_vector_3d,
                kernels.laplacian_filter_vector_3d_ref,
                (w, 1, "multiplicative"), (0,),
                row="laplacian_filter_vector_3d" if keep else None)
            run("penalise_field_boundary_vector_3d" + tag,
                kernels.penalise_field_boundary_vector_3d,
                kernels.penalise_field_boundary_vector_3d_ref, (w, 2), (0,),
                row="penalise_field_boundary_vector_3d" if keep else None)
            del w
        w = r(*FREE_ROD_SHAPE)
        run("laplacian_filter_vector_3d convolution",
            kernels.laplacian_filter_vector_3d,
            kernels.laplacian_filter_vector_3d_ref,
            (w, FREE_ROD_ORDER, "convolution"), (0,),
            row="laplacian_filter_vector_3d convolution")
        # the FFT passes at their rows' shapes, every tensor input a
        # gradient; the optional Green's fold of ifft_pass_truncated, shared
        # and not, at a (48, 32, 64) grid's shapes
        args = fft_pass_args(TABLE_GRID, gen)
        for name in FFT_REPLACES:
            a = args[name]
            run(name, getattr(cuda_fft, name),
                getattr(cuda_fft, name + "_ref"), a,
                tuple(i for i, t in enumerate(a) if torch.is_tensor(t)),
                fft_pass=True, row=name)
        del args
        grid = (48, 32, 64)
        a, m, b = 3 * grid[0], 2 * grid[1], grid[2]
        for lead in (1, a):
            run(f"ifft_pass_truncated greens ({lead}, m, B)",
                cuda_fft.ifft_pass_truncated, cuda_fft.ifft_pass_truncated_ref,
                (r(a, m, b), r(a, m, b), r(lead, m, b)), (0, 1, 2),
                fft_pass=True)
        args = fused_pair_args(MULTIBODY_GRID, gen)
        for name, a in args.items():
            run(name, getattr(cuda_fft, name),
                getattr(cuda_fft, name + "_ref"), a,
                tuple(i for i, t in enumerate(a) if torch.is_tensor(t)),
                fft_pass=True, row=name)
        del args
        args = edge_pass_args(TABLE_GRID, gen)
        for name, a in args.items():
            run(name, getattr(cuda_fft, name),
                getattr(cuda_fft, name + "_ref"), a,
                tuple(i for i, t in enumerate(a) if torch.is_tensor(t)),
                fft_pass=True, row=name)
        del args
        # the sharded four on SHARDED_MESH at the table's shape
        mesh = create_mesh(3, SHARDED_MESH, device=dev)
        ws = shard_vector_field(r(3, *SHARDED_GRID), mesh)
        us = shard_vector_field(r(3, *SHARDED_GRID), mesh)
        p = torch.tensor(0.05, device=dev)
        add = torch.tensor([1.0, -0.5, 0.25], device=dev)
        sharded_args = {
            "diffusion_timestep_vector_3d_sharded": ((ws, p, mesh), (0, 1)),
            "curl_3d_sharded": ((ws, p, mesh, add, True), (0, 1, 3)),
            "rotational_curl_add_3d_sharded": ((ws, us, p, mesh), (0, 1, 2)),
            "diffusion_penalise_vector_3d_sharded": ((ws, p, 2, mesh),
                                                     (0, 1)),
        }
        for name, (a, wrt) in sharded_args.items():
            fn = getattr(sharded, name)
            if name == "curl_3d_sharded":
                fn = lambda f, q, m, v, l1: sharded.curl_3d_sharded(
                    f, q, m, v, compute_l1_max=l1)
            run(name, fn, getattr(sharded, name + "_ref"), a, wrt, row=name)
        del ws, us
        missing = [k for k, v in table.items() if "backward_ms" not in v]
        check(not missing, f"no backward time for {missing}")
        return None, "; ".join(
            f"{k}: gradient max|diff| {e:.3g}, backward {ms:.4f} ms"
            for k, (e, ms) in results.items()) + f" [{card}]"

    kernel_gradients_phase()

    @phase("adjoint driver")
    def adjoint_driver_phase():
        """``examples_torch/2d/adjoint_viscosity_inversion.py``: the first
        value and gradient at the example's defaults in float32 on the 2D
        kernel route against the dense route, an inversion at the smoke
        settings on the kernels, the float64 driver on the card against the
        CPU's."""
        import math

        mod = load_example("adjoint_viscosity_inversion", "2d")

        def first(dense):
            with (dense_route() if dense else contextlib.nullcontext()):
                loss_fn, real_t = mod.build_inversion(
                    ADJOINT_GRID, 1e-3, ADJOINT_STEPS, "single", device=dev)
                log_nu = torch.tensor(math.log(2e-3), dtype=real_t,
                                      device=dev, requires_grad=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                t0 = time.perf_counter()
                val = loss_fn(log_nu)
                (grad,) = torch.autograd.grad(val, log_nu)
                val, grad = float(val.detach()), float(grad)
                wall = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in route_2d}
                peak = torch.cuda.max_memory_allocated(dev) / 2**30
            return val, grad, wall, launches, peak

        val, grad, wall, launches, peak = first(False)
        # the backward launches no kernel: each pass once a rollout step
        for name, count in launches.items():
            check(count == ADJOINT_STEPS, f"{name} launched {count} times in "
                  f"a value and gradient of {ADJOINT_STEPS} steps")
        check_not_launched(
            [fn.__name__ for fn in by_name.values() if fn not in route_2d],
            "the adjoint rollout")
        dval, dgrad, dwall, dlaunch, dpeak = first(True)
        check(not any(dlaunch.values()), f"the dense route launched {dlaunch}")
        gap_val = abs(val - dval) / abs(dval)
        gap_grad = abs(grad - dgrad) / abs(dgrad)
        check(max(gap_val, gap_grad) <= ADJOINT_ROUTE_TOL,
              f"kernel route value / gradient {val} / {grad} against the "
              f"dense route's {dval} / {dgrad}")
        smoke = ADJOINT_SMOKE
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        nu, nu_true, rel, hist = mod.adjoint_viscosity_inversion_case(
            **smoke, precision="single", device=dev)
        s_iter = (time.perf_counter() - t0) / smoke["iters"]
        smoke_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        solves = smoke["n_steps"] * (smoke["iters"] + 2)
        check_2d_route(solves, "the float32 inversion")
        check(rel < ADJOINT_NU_TOL, f"float32 kernel route recovered nu "
              f"{nu} against {nu_true}")
        t0 = time.perf_counter()
        short = dict(smoke, iters=ADJOINT_F64_ITERS)
        *_, card64 = mod.adjoint_viscosity_inversion_case(**short,
                                                          device=dev)
        s_iter64 = (time.perf_counter() - t0) / short["iters"]
        *_, cpu64 = mod.adjoint_viscosity_inversion_case(**short,
                                                         device="cpu")
        gap64 = float(np.max(np.abs(np.asarray(card64) - np.asarray(cpu64))
                             / np.abs(np.asarray(cpu64))))
        check(gap64 <= ADJOINT_F64_TOL, f"float64 history on the card parts "
              f"from the CPU's by {gap64} relative")
        return None, (
            f"{ADJOINT_GRID} f32, {ADJOINT_STEPS} steps: loss {val:.10g}, "
            f"d loss / d log nu {grad:.10g} on the kernel route against "
            f"{dval:.10g} / {dgrad:.10g} dense (relative {gap_val:.3g} / "
            f"{gap_grad:.3g}); a value and gradient {wall:.3f} s (dense "
            f"{dwall:.3f} s), peak {peak:.3f} GiB (dense {dpeak:.3f}), "
            f"launches {launches}; smoke settings {smoke}: f32 kernels nu "
            f"{nu:.6e} ({rel:.3%} from {nu_true}), {s_iter:.4f} s/iteration, "
            f"peak {smoke_peak:.3f} GiB, each pass {solves} launches; f64 "
            f"{s_iter64:.4f} s/iteration, the {ADJOINT_F64_ITERS}-iteration "
            f"history within {gap64:.3g} relative of the CPU's [{card}]")

    adjoint_driver_phase()

    @phase("sphere gradient")
    def sphere_gradient_phase():
        """The gradient of ``sum u^2`` after the 256^3 sphere step w.r.t.
        the initial vorticity: kernels (exact tier, twice; fast tier; fused
        edge passes) against the plain path (plain stencils, the dense
        ``torch.fft`` solve); the (2, 2) sharded flow step's at 128^3
        against one device's."""
        def rel_l2(a, b):
            return float((a.double() - b.double()).norm() / b.double().norm())

        def gradient(step, carry, steps):
            omega0 = carry.flow_state.primary_field.detach().clone() \
                .requires_grad_()
            c = carry._replace(
                flow_state=carry.flow_state._replace(primary_field=omega0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            c2, _ = scan_steps(step, c, steps)
            loss = (c2.flow_state.velocity_field ** 2).sum()
            (g,) = torch.autograd.grad(loss, omega0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(g).all()) and float(g.norm()) > 0,
                  "a non-finite or zero gradient")
            return g, wall, torch.cuda.max_memory_allocated(dev) / 2**30

        with dense_route():
            step, (carry,) = cases._build_fsi_case(
                SPHERE_GRAD_GRID, device=dev,
                sim_kwargs={"use_kernels": False})
            check(not isinstance(carry.greens, tuple), "the plain path's "
                  "solve is not dense")
            reset_counts()
            plain = {n: gradient(step, carry, n) for n in (2, 1)}
            check(not any(fn.launches for fn in by_name.values()),
                  "the plain path launched a kernel")
        del step, carry
        _, plain_wall, plain_peak = plain[2]
        step, (carry,) = cases._build_fsi_case(SPHERE_GRAD_GRID, device=dev)
        check(isinstance(carry.greens, tuple), "the kernel path's solve is "
              "not on the kernel route")
        reset_counts()
        g1, wall, peak = gradient(step, carry, 2)
        launches = {fn.__name__: fn.launches
                    for fn in list(kernels.KERNELS) + exact_fft
                    if fn.__name__ in SPHERE_KERNELS or fn in exact_fft}
        # forward launches only: the z conv and the c2r once a step
        for name, count in launches.items():
            check(count >= 2, f"{name} launched {count} times in 2 steps")
        for name in ("fft_greens_ifft_pass", "irfft_pass_merge"):
            check(launches[name] == 2, f"{name} launched {launches[name]} "
                  "times in 2 steps and their gradient")
        check_not_launched(FUSED_REPLACES, "the exact-tier sphere gradient")
        g2, wall2, _ = gradient(step, carry, 2)
        bit_equal = bool(torch.equal(g1, g2))
        err = rel_l2(g1, plain[2][0])
        check(err <= SPHERE_GRAD_TOL, f"exact tier: relative L2 {err} from "
              "the plain path's gradient")
        del g2
        cuda_fft.USE_FUSED_EDGE_PASSES = True
        try:
            reset_counts()
            gf, wall_fused, _ = gradient(step, carry, 1)
            check(all(by_name[n].launches == 1 for n in FUSED_EDGE_PASSES),
                  "the fused edge passes did not run once")
            check_not_launched(UNFUSED_EDGE_PASSES, "the fused-edge gradient")
        finally:
            cuda_fft.USE_FUSED_EDGE_PASSES = False
        err_fused = rel_l2(gf, plain[1][0])
        check(err_fused <= SPHERE_GRAD_TOL, f"fused edges: relative L2 "
              f"{err_fused} from the plain path's gradient")
        del step, carry, gf
        step, (carry,) = cases._build_fsi_case(
            SPHERE_GRAD_GRID, device=dev, sim_kwargs={"fast_spectral": True})
        reset_counts()
        gfast, wall_fast, _ = gradient(step, carry, 1)
        check(all(by_name[n].launches == 1 for n in FUSED_REPLACES),
              "the fast tier's pair did not run once")
        check_not_launched(EXACT_ONLY, "the fast-tier gradient")
        err_fast = rel_l2(gfast, plain[1][0])
        check(err_fast <= SPHERE_GRAD_TOL, f"fast tier: relative L2 "
              f"{err_fast} from the plain path's gradient")
        del step, carry, gfast, plain
        torch.cuda.empty_cache()
        grads = []
        for mesh_shape in (SHARDED_MESH, None):
            step, (carry,) = cases.sharded_flow_case(SHARDED_GRAD_GRID,
                                                     mesh_shape, device=dev)
            reset_counts()
            g, wall_sh, _ = gradient(step, carry, 1)
            if mesh_shape is not None:
                g = unshard_vector_field(g, step.flow_sim.mesh)
                sh_launches = {fn.__name__: fn.launches
                               for fn in sharded.KERNELS}
            grads.append(g)
        check(all(sh_launches[n] >= 1 for n in (
            "rotational_curl_add_3d_sharded", "curl_3d_sharded",
            "diffusion_penalise_vector_3d_sharded")),
            f"sharded launches {sh_launches}")
        sh_err, scale = max_err(grads[0], grads[1])
        check(sh_err <= SHARDED_GRAD_TOL * scale, f"sharded gradient: "
              f"max|diff| {sh_err} > {SHARDED_GRAD_TOL} * {scale}")
        del grads
        torch.cuda.empty_cache()
        return None, (
            f"{SPHERE_GRAD_GRID} f32, loss sum u^2, d/d initial vorticity: "
            f"exact tier 2 steps relative L2 {err:.3g} from the plain path, "
            f"{wall:.3f} s (second run {wall2:.3f} s, plain "
            f"{plain_wall:.3f} s), peak {peak:.2f} GiB (plain "
            f"{plain_peak:.2f}), two runs bit-equal: {bit_equal}, launches "
            f"{launches}; 1 step: fused edges {err_fused:.3g} "
            f"({wall_fused:.3f} s), fast tier {err_fast:.3g} "
            f"({wall_fast:.3f} s); sharded {SHARDED_GRAD_GRID} on "
            f"{SHARDED_MESH} against one device max|diff| {sh_err:.3g} of "
            f"{scale:.3g}, launches {sh_launches} [{card}]")

    sphere_gradient_phase()

    @phase("mesh dryrun")
    def mesh_dryrun_phase():
        reset_counts()
        collectives.reset_counts()
        rows = cases.dryrun_multichip(DRYRUN_MESH, device=dev)
        check(len(rows) == 8 and all(ok for *_, ok in rows),
              f"dryrun_multichip rows {rows}")
        launches = {name: by_name[name].launches for name in
                    (*SHARDED_REPLACES, *SHARDED_FFT_LAUNCHES)}
        check(all(launches[name] > 0 for name in (
            "rotational_curl_add_3d_sharded", "curl_3d_sharded",
            "diffusion_penalise_vector_3d_sharded")),
            f"the mesh cases launched the sharded kernels {launches}")
        counts = collectives.counts()
        # the sparse rod case on the mesh, card against the CPU
        finals = []
        for device in (dev, torch.device("cpu")):
            mesh = create_mesh(3, DRYRUN_MESH, device=device)
            step, carry = cases._build_rod_fsi_case(
                DRYRUN_GRID, device=device, mesh=mesh, sparse_forcing=True)
            carry, diag = scan_steps(step, carry, 3)
            check(bool(diag[1].all()), f"the rod's window tripped on {device}")
            finals.append(unshard_vector_field(
                carry.flow_state.primary_field, mesh).cpu())
        err, scale = max_err(*finals)
        check(err <= 1e-4 * max(1.0, scale), f"sparse rod on {DRYRUN_MESH}: "
              f"card vs cpu {err} (|ref| max {scale})")
        table_rows = "; ".join(f"{name} {d:.3e} (tol {tol:.1e})"
                               for name, d, tol, _ in rows)
        return None, (f"{DRYRUN_GRID} on {DRYRUN_MESH}: {table_rows}; sparse "
                      f"rod x3 card vs cpu max|diff| {err:.3e} of {scale:.3g};"
                      f" launches {launches}, collectives {counts} "
                      f"[{card}]")

    mesh_dryrun_phase()

    @phase("sharded sphere fsi")
    def sharded_sphere_phase():
        from sopht_mpi_tpu_torch.models.flow.simulator_3d import flow_step_3d

        n_steps = 20
        out = {}
        for mesh_shape in (None, SHARDED_MESH):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            mesh = (None if mesh_shape is None
                    else create_mesh(3, mesh_shape, device=dev))
            step, (carry,) = cases._build_fsi_case(SHARDED_GRID, device=dev,
                                                   mesh=mesh)
            window = tuple(b - a for a, b in zip(step.window[::2],
                                                 step.window[1::2]))
            check(step.uses_sparse_forcing
                  and window == SHARDED_SPHERE_WINDOW, f"window {window}")
            check(isinstance(carry.greens, tuple) == (mesh is None),
                  "the sphere's solve is not on its kernel route")
            carry, forces = scan_steps(step, carry, 3)
            fs = carry.flow_state
            fields = {what: unshard_vector_field(getattr(fs, what), mesh)
                      for what in ("primary_field", "velocity_field")}
            flow_counts = None
            if mesh is not None:
                # the collectives of the flow step alone (the no-forcing
                # step the sparse path advances through), once
                collectives.reset_counts()
                flow_step_3d(fs, torch.tensor(1e-4, device=dev),
                             torch.zeros(3, device=dev),
                             poisson_greens=carry.greens,
                             return_velocity_l1_max=True,
                             **step.flow_sim.step_config("navier_stokes"))
                flow_counts = collectives.counts()
            carry, _ = scan_steps(step, carry, 5)
            reset_counts()
            collectives.reset_counts()
            carry, timed_forces, s_step = timed_steps(step, carry, n_steps)
            launches = {name: fn.launches for name, fn in by_name.items()
                        if fn.launches}
            counts = collectives.counts()
            for what, t in (("vorticity", carry.flow_state.primary_field),
                            ("velocity", carry.flow_state.velocity_field),
                            ("forces", timed_forces)):
                check(bool(torch.isfinite(t).all()), f"non-finite {what}")
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
            name = "one" if mesh is None else "mesh"
            carry, *prof = profile_steps(
                step, carry, 3,
                os.path.join(REPO, "build", f"sharded_sphere_{name}_profile"
                             ".txt"),
                f"{SHARDED_GRID} sphere FSI step"
                + ("" if mesh is None else
                   f" on an in-process {SHARDED_MESH} mesh"))
            out[mesh_shape] = dict(fields=fields, forces=forces, s=s_step,
                                   launches=launches, counts=counts,
                                   flow_counts=flow_counts, peak=peak,
                                   prof=prof)
            del step, carry, fs
        one, many = out[None], out[SHARDED_MESH]
        errs = {}
        for what, ref in one["fields"].items():
            err, scale = max_err(many["fields"][what], ref)
            check(err <= 1e-4 * max(1.0, scale), f"{what} after 3 steps: "
                  f"sharded vs single-device {err} (|ref| max {scale})")
            errs[what] = err
        f_err, f_scale = max_err(many["forces"], one["forces"])
        check(f_err <= 1e-4 * f_scale, f"summed marker force after 3 steps: "
              f"sharded vs single-device {f_err} (|ref| max {f_scale})")
        errs["force (relative)"] = f_err / f_scale
        launches = many["launches"]
        for name in ("rotational_curl_add_3d_sharded",
                     "diffusion_penalise_vector_3d_sharded",
                     "curl_3d_sharded", "fft_greens_ifft_pass"):
            check(launches.get(name, 0) >= n_steps,
                  f"{name} launched {launches.get(name, 0)} times in "
                  f"{n_steps} sharded sphere steps")
        per_step = {k: v / n_steps for k, v in many["counts"].items()}
        flow_counts = many["flow_counts"]
        expected = dict(flow_counts, psum=flow_counts["psum"] + 1)
        check(per_step == expected and per_step["apply_assembled"] == 0,
              f"collectives a step {per_step}, expected the flow step's "
              f"{flow_counts} and one psum")
        del out
        torch.cuda.empty_cache()
        return None, (
            f"256^3 f32 sphere, sparse {SHARDED_SPHERE_WINDOW} window, exact "
            f"tier, on an in-process {SHARDED_MESH} mesh: {many['s']:.6f} "
            f"s/step against {one['s']:.6f} on one device, no host sync in "
            f"either; device {many['prof'][1] / 3:.3f} ms/step and "
            f"{many['prof'][2]:.0f} kernels/step against "
            f"{one['prof'][1] / 3:.3f} ms and {one['prof'][2]:.0f} on one "
            f"device; after 3 steps max|diff| {errs}; launches over "
            f"{n_steps} steps {launches}; collectives a step {per_step} (the "
            f"flow step alone {flow_counts}); peak {many['peak']:.2f} GiB "
            f"above the phase's start (one device {one['peak']:.2f} GiB); "
            + profile_detail(*many["prof"], many["s"]) + f" [{card}]")

    sharded_sphere_phase()

    for row in table.values():
        check(row["launches"], f"{row['name']} was launched on no path")
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
