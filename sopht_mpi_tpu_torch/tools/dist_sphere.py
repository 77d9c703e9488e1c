"""One process of the flow-past-sphere FSI step on a distributed mesh (one
shard a process): build ``cases._build_fsi_case`` on the mesh, run
warm-up steps and save this rank's blocks, then time steps and count what
they launch and move.

    python -m sopht_mpi_tpu_torch.tools.dist_sphere --rank R --world W \\
        --init-file F --out DIR [--grid 256] [--mesh 2 1] [--warmup 3] \\
        [--steps 10] [--flow-steps 0] [--device cuda:0]

Every rank of the world runs the same command with its own ``--rank``;
``F`` is the file store of ``init_process_group``. The world is a gloo
one, so the ranks may share one card (gloo stages every exchange through
the host; NCCL refuses two ranks on one device), and a collective waits
:data:`TIMEOUT_S` for the others before it raises.

Each rank writes ``DIR/rank<r>_fields.pt`` (its vorticity and velocity
blocks after the warm-up steps, (3, nz/pz, ny/py, nx) on the host, and
the summed marker forces of those steps) and ``DIR/rank<r>.json``: its
mesh coordinates, set-up seconds, seconds a timed step (host clock around
the steps and a synchronise), device milliseconds a step (the sum of the
device events of ``torch.profiler`` over :data:`PROFILE_STEPS` more
steps) and the part of it that is memory copies, between device and host
included (null on the CPU; a step or a profiler that fails fails the
rank), and over the timed steps each kernel wrapper's launches, each collective's
calls, the block gathers and the bytes staged between device and host.

With ``--flow-steps K`` it then runs K steps of the flow-only case
(``cases.sharded_flow_case``) with the order-1 Laplacian filter on the
same mesh, whose transport launches the sharded diffusion kernel alone
(the filter runs on the assembled field), and records them alike under
``flow``. Kernels are built at first use (``_build``): a library an
earlier process built from the same sources is loaded as it is.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

TIMEOUT_S = 240
PROFILE_STEPS = 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--init-file", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--grid", type=int, default=256)
    parser.add_argument("--mesh", type=int, nargs=2, default=(2, 1))
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--flow-steps", type=int, default=0)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from sopht_mpi_tpu_torch import cases
    from sopht_mpi_tpu_torch.models import scan_steps
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d as single
    from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded as sharded
    from sopht_mpi_tpu_torch.parallel import collectives, cuda_fft
    from sopht_mpi_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from sopht_mpi_tpu_torch.parallel.mesh import create_mesh

    dev = torch.device(args.device)
    initialize_distributed(
        init_method=f"file://{os.path.abspath(args.init_file)}",
        world_size=args.world, rank=args.rank, device=dev, backend="gloo",
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    wrappers = (*single.KERNELS, *sharded.KERNELS, *cuda_fft.KERNELS)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(step, carry, n):
        """(carry, diagnostics, s a step, the launches, the collectives'
        calls and the transfers of ``n`` steps)."""
        collectives.reset_counts()
        for fn in wrappers:
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        carry, diag = scan_steps(step, carry, n)
        sync()
        return (carry, diag, (time.perf_counter() - t0) / n,
                {fn.__name__: fn.launches for fn in wrappers if fn.launches},
                collectives.counts(), collectives.transfer_counts())

    try:
        mesh = create_mesh(3, tuple(args.mesh), device=dev, distributed=True)
        n = args.grid
        t0 = time.perf_counter()
        step, (carry,) = cases._build_fsi_case((n, n, n), device=dev,
                                               mesh=mesh)
        sync()
        setup_s = time.perf_counter() - t0
        carry, forces = scan_steps(step, carry, args.warmup)
        fs = carry.flow_state
        torch.save({"vorticity": fs.primary_field[0, 0].cpu(),
                    "velocity": fs.velocity_field[0, 0].cpu(),
                    "forces": forces.cpu()},
                   os.path.join(args.out, f"rank{args.rank}_fields.pt"))
        del fs
        carry, forces, s_step, launches, counts, transfers = timed(
            step, carry, args.steps)
        finite = bool(torch.isfinite(forces).all()) and bool(
            torch.isfinite(carry.flow_state.primary_field).all())
        device_ms = copy_ms = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                carry, _ = scan_steps(step, carry, PROFILE_STEPS)
                sync()
            events = [e for e in prof.key_averages()
                      if e.device_type.name == "CUDA"]
            per_step = 1e3 * PROFILE_STEPS
            device_ms = sum(e.self_device_time_total
                            for e in events) / per_step
            copy_ms = sum(e.self_device_time_total for e in events
                          if e.key.startswith("Memcpy")) / per_step
        window = list(step.window) if hasattr(step, "window") else None
        del step, carry
        flow = None
        if args.flow_steps:
            fstep, (fcarry,) = cases.sharded_flow_case(
                (n, n, n), mesh=mesh, device=dev, sim_kwargs={
                    "filter_vorticity": True,
                    "filter_setting_dict": {"order": 1,
                                            "type": "multiplicative"}})
            fcarry, dts, fs_step, flaunch, fcounts, ftransfers = timed(
                fstep, fcarry, args.flow_steps)
            flow = {"steps": args.flow_steps, "s_step": fs_step,
                    "launches": flaunch, "counts": fcounts,
                    "transfers": ftransfers,
                    "finite": bool(torch.isfinite(dts).all()) and bool(
                        torch.isfinite(fcarry.flow_state.primary_field)
                        .all())}
            del fstep, fcarry
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump({
                "rank": args.rank, "coords": list(mesh.coords),
                "mesh": list(args.mesh), "grid": n,
                "backend": dist.get_backend(), "setup_s": setup_s,
                "warmup": args.warmup, "steps": args.steps,
                "s_step": s_step, "device_ms_step": device_ms,
                "copy_ms_step": copy_ms,
                "launches": launches, "counts": counts,
                "transfers": transfers, "finite": finite, "window": window,
                "flow": flow,
            }, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
