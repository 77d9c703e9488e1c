"""Multi-process driver: the fused flow-past-sphere FSI case over every
process of a ``torch.distributed`` world, one shard a process, on the
PyTorch port.

Counterpart of ``doc/tpu/pod_flow_past_sphere.py``, with the same
arguments: one program, identical on every process.
``initialize_distributed()`` is a no-op in a plain single-process run and
starts ``torch.distributed`` under a launcher; ``auto_mesh`` factors the
world slab-first over the shardable grid axes; the case is the sphere
driver's ``flow_past_sphere_fused_case`` on that mesh. Only rank 0 logs
and writes ``drag_vs_time.csv``.

Run (one process a card of the host, NCCL):
    python -m torch.distributed.run --nproc-per-node 4 \\
        examples_torch/3d/pod_flow_past_sphere.py --grid-size-x 512

On the CPU (gloo; float64 needs ``--precision double``):
    python -m torch.distributed.run --nproc-per-node 2 \\
        examples_torch/3d/pod_flow_past_sphere.py --device cpu \\
        --grid-size-x 32 --nondim-time 0.05 --window 4

Without a launcher it runs the case on one device.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
sys.path.insert(0, HERE)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size-x", type=int, default=256)
    parser.add_argument("--nondim-time", type=float, default=5.0)
    parser.add_argument("--window", type=int, default=100)
    parser.add_argument(
        "--overlap-chunks", type=int, default=None,
        help="the pipelining request of the sharded Poisson transposes "
        "(accepted, one chunk is realised)",
    )
    parser.add_argument("--precision", default="single")
    parser.add_argument(
        "--device", default=None,
        help="this process's torch device (default cuda:LOCAL_RANK; cpu "
        "runs on the CPU over gloo)",
    )
    args = parser.parse_args(argv)

    import torch

    from sopht_mpi_tpu_torch.parallel import auto_mesh, initialize_distributed
    from sopht_mpi_tpu_torch.parallel.distributed import process_device
    from sopht_mpi_tpu_torch.parallel.mesh import is_distributed
    from sopht_mpi_tpu_torch.utils import logger

    initialize_distributed(device=args.device)  # no-op without a launcher
    device = (torch.device(args.device) if args.device is not None
              else process_device())
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device; run with --device cpu for the CPU")
    n = args.grid_size_x
    grid_size = (n, n, n)
    mesh = auto_mesh(3, grid_size, device=device)
    lead = not is_distributed(mesh) or mesh.rank == 0
    if lead:
        logger.info(f"processes: {mesh.size}, mesh {mesh.shape}, grid "
                    f"{grid_size}, device {device}")

    from flow_past_sphere import flow_past_sphere_fused_case

    times, cds = flow_past_sphere_fused_case(
        nondim_time=args.nondim_time,
        grid_size=grid_size,
        precision=args.precision,
        window=args.window,
        mesh=mesh,
        overlap_chunks=args.overlap_chunks,
        device=device,
    )
    if not lead:
        return times, cds
    if times:
        logger.info(f"done: t*={times[-1]:.2f} Cd={cds[-1]:.4f}")
    else:
        logger.warning("no scan windows ran (nondim_time <= 0?)")
    return times, cds


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
