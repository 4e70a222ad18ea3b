"""K4 and K7 on the training forward, where autograd needs them.

The reference writes no backward Pallas kernel (``src/repro/kernels``
holds no ``custom_vjp``): JAX differentiates its plain ``rmsnorm`` and
its ``logsumexp`` loss.  Here each kernel is a ``torch.autograd.
Function`` whose forward is the kernel (``ops``: K4 or K7 on a CUDA
tensor, their plain versions on a CPU tensor) and whose backward is
plain PyTorch in float32 (``ref.rmsnorm_backward``,
``ref.softmax_xent_rows_backward``).  Without gradients to take, the
calls go to ``ops`` directly, so serving runs exactly as before.

``softmax_xent_block_rows`` is the loss over a vocabulary split across
the ranks of a group (tensor parallelism): K7's block entry on this
rank's columns, the ranks' triples combined by two all-reduces, the
backward ``softmax - onehot`` on this rank's columns alone.
"""
from __future__ import annotations

import torch

from . import ops, ref


def combine_over(m, s, xl, group):
    """Every rank's triple of ``group`` (its block of the vocabulary) as
    the per-row losses and the rows' ``lse`` over the whole vocabulary:
    one all-reduce of the maxima, one of the sums rescaled to the
    largest and the ``x[label]`` (a label lies in one block)."""
    import torch.distributed as dist
    top = m.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    both = torch.stack([s * torch.exp(m - top), xl])
    dist.all_reduce(both, group=group)
    lse = top + torch.log(both[0])
    return lse - both[1], lse


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class RMSNorm(torch.autograd.Function):
    """K4 forward, ``ref.rmsnorm_backward`` backward."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return ops.rmsnorm(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dgamma = ref.rmsnorm_backward(x, gamma, dy, ctx.eps)
        return dx, dgamma, None


class XentRows(torch.autograd.Function):
    """K7 forward (the per-row losses), ``ref.softmax_xent_rows_backward``
    backward (the labels take no gradient)."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return ops.softmax_xent_rows(logits, labels)

    @staticmethod
    def backward(ctx, dloss):
        logits, labels = ctx.saved_tensors
        return ref.softmax_xent_rows_backward(logits, labels, dloss), None


class XentBlockRows(torch.autograd.Function):
    """The per-row losses over a vocabulary split across ``group``: this
    rank's logits (T, Vb) hold columns ``[c0, c0 + Vb)``.  Forward: K7's
    block entry (``ops.softmax_xent_block``), the triples combined
    (``combine_over``); every rank returns the same (T,) losses.
    Backward: ``ref.softmax_xent_block_backward`` on this rank's block
    with the rows' ``lse``, the gradient of the losses, which every rank
    holds whole, for the logits only this rank holds."""

    @staticmethod
    def forward(ctx, logits, labels, c0, group):
        m, s, xl = ops.softmax_xent_block(logits, labels, c0)
        rows, lse = combine_over(m, s, xl, group)
        ctx.save_for_backward(logits, labels, lse)
        ctx.c0 = c0
        return rows

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        return ref.softmax_xent_block_backward(logits, labels, ctx.c0, lse,
                                               dloss), None, None, None


def softmax_xent_block_rows(logits, labels, c0: int, group):
    """The per-row losses of a vocabulary split over ``group``
    (``XentBlockRows``)."""
    return XentBlockRows.apply(logits, labels, c0, group)


def rmsnorm(x, gamma, eps: float = 1e-6):
    """``ops.rmsnorm``, differentiable where x or gamma takes a
    gradient."""
    if _needs_grad(x, gamma):
        return RMSNorm.apply(x, gamma, eps)
    return ops.rmsnorm(x, gamma, eps)


def softmax_xent_rows(logits, labels):
    """``ops.softmax_xent_rows``, differentiable where the logits take a
    gradient."""
    if _needs_grad(logits):
        return XentRows.apply(logits, labels)
    return ops.softmax_xent_rows(logits, labels)
