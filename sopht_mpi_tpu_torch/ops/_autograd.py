"""Reverse mode through the hand-written kernels.

The JAX package makes every public Pallas entry a ``jax.custom_vjp`` whose
backward pass is jnp: for the stencils, the sharded stencils and the fast
tier's and fused edges' FFT passes, the VJP of the plain formulation; for
the other FFT passes an analytic adjoint (those are written out in
:mod:`sopht_mpi_tpu_torch.parallel.cuda_fft`). The port does the same with
``torch.autograd.Function``: the forward is the kernel on a CUDA tensor and
the plain version on a CPU tensor; the backward is plain PyTorch on both
devices and launches no kernel, so a wrapper's ``launches`` count counts
forward launches only.

A wrapper calls :func:`kernel_or_plain_vjp`: where autograd records
(:func:`needs_grad`) it goes through :class:`PlainVJP`, otherwise it calls
its forward directly, with no autograd bookkeeping.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def needs_grad(*args) -> bool:
    """Whether autograd records a call on ``args``: grad mode is on and some
    tensor among them requires a gradient."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad for a in args)


class PlainVJP(torch.autograd.Function):
    """``forward(*args)`` with the VJP of ``plain(*args)`` as its backward.

    ``forward`` runs without autograd (the kernel, or the plain version on
    the CPU). The backward re-runs ``plain`` on the saved inputs under
    ``torch.enable_grad`` and returns a gradient for every tensor input
    that needs one (0-d prefactors and additive vectors included; the CFL
    dt enters the prefactors), ``None`` for the rest. Double backward is
    not supported, as in the JAX package."""

    @staticmethod
    def forward(ctx, forward, plain, *args):
        ctx.plain = plain
        ctx.args = [None if torch.is_tensor(a) else a for a in args]
        ctx.tensor_at = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return forward(*args)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        args, wrt = list(ctx.args), []
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            t = t.detach()
            if ctx.needs_input_grad[2 + i]:
                t.requires_grad_(True)
                wrt.append(i)
            args[i] = t
        with torch.enable_grad():
            outs = ctx.plain(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        got = torch.autograd.grad(
            [o for o, _ in pairs], [args[i] for i in wrt],
            [g for _, g in pairs], allow_unused=True,
        ) if pairs and wrt else [None] * len(wrt)
        result = [None] * len(args)
        for i, g in zip(wrt, got):
            result[i] = torch.zeros_like(args[i]) if g is None else g
        return (None, None, *result)


def kernel_or_plain_vjp(forward, plain, *args):
    """``forward(*args)``, through :class:`PlainVJP` where autograd records
    the call."""
    if needs_grad(*args):
        return PlainVJP.apply(forward, plain, *args)
    return forward(*args)
