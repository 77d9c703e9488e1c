"""The ``torch.distributed`` wire of a distributed mesh
(:class:`~sopht_mpi_tpu_torch.parallel.mesh.DistributedMesh`): what the
distributed backend of the collectives and the block gathers send through.

A group's backend decides the route. NCCL sends device tensors as they
are. Gloo sends host tensors: a CUDA tensor bound for a gloo group is
copied to the host before the call and the result back to the device after
it, and :func:`stage` counts those bytes (``stage.bytes``, both
directions), so a run can tell a transport through the host from one on
the card. A failed call raises, on either backend. Complex tensors travel
as their real views.
"""

from __future__ import annotations

import torch


def _dist():
    import torch.distributed as dist

    return dist


def staged(group, tensor) -> bool:
    """Whether ``tensor`` goes through the host to reach ``group``: a
    device tensor and a gloo group."""
    return (tensor.device.type != "cpu"
            and _dist().get_backend(group) == "gloo")


def stage(tensor, host: bool):
    """``tensor`` on the host (``host``) or as it is; counts the bytes
    copied."""
    if not host:
        return tensor
    stage.bytes += tensor.numel() * tensor.element_size()
    return tensor.cpu()


def unstage(tensor, device, host: bool):
    """A result received through the host back on ``device``; counts the
    bytes copied."""
    if not host:
        return tensor
    stage.bytes += tensor.numel() * tensor.element_size()
    return tensor.to(device)


stage.bytes = 0


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def _complex(t, like):
    return torch.view_as_complex(t) if like.is_complex() else t


def send_recv(tensor, group, send_to: int, recv_from: int):
    """Send ``tensor`` to global rank ``send_to`` and receive a tensor of
    its shape and dtype from ``recv_from``, in one ``batch_isend_irecv``
    (both may be the same peer)."""
    dist = _dist()
    host = staged(group, tensor)
    src = _real(stage(tensor.contiguous(), host))
    out = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, send_to, group),
        dist.P2POp(dist.irecv, out, recv_from, group),
    ])
    for req in reqs:
        req.wait()
    return unstage(_complex(out, tensor), tensor.device, host)


def all_to_all_rows(chunks, group):
    """``chunks`` (p, ...): row ``j`` goes to group rank ``j``; returns
    (p, ...) with row ``i`` the row this rank received from group rank
    ``i`` (``all_to_all_single``)."""
    host = staged(group, chunks)
    src = _real(stage(chunks.contiguous(), host))
    out = torch.empty_like(src)
    _dist().all_to_all_single(out, src, group=group)
    return unstage(_complex(out, chunks), chunks.device, host)


def all_gather_rows(tensor, group, n: int):
    """(n, *tensor.shape): every rank's ``tensor``, in group-rank order."""
    if tensor.numel() == 0:
        return tensor.new_empty((n, *tensor.shape))
    host = staged(group, tensor)
    src = _real(stage(tensor.contiguous(), host))
    out = [torch.empty_like(src) for _ in range(n)]
    _dist().all_gather(out, src, group=group)
    return unstage(_complex(torch.stack(out), tensor), tensor.device, host)


def all_reduce_max(tensor, group):
    """The elementwise maximum of ``tensor`` over ``group``."""
    dist = _dist()
    host = staged(group, tensor)
    out = stage(tensor.contiguous(), host).clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return unstage(out, tensor.device, host)
