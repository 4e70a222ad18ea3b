"""K4 and K7 on the training forward, where autograd needs them.

The reference writes no backward Pallas kernel (``src/repro/kernels``
holds no ``custom_vjp``): JAX differentiates its plain ``rmsnorm`` and
its ``logsumexp`` loss.  Here each kernel is a ``torch.autograd.
Function`` whose forward is the kernel (``ops``: K4 or K7 on a CUDA
tensor, their plain versions on a CPU tensor) and whose backward is
plain PyTorch in float32 (``ref.rmsnorm_backward``,
``ref.softmax_xent_rows_backward``).  Without gradients to take, the
calls go to ``ops`` directly, so serving runs exactly as before.
"""
from __future__ import annotations

import torch

from . import ops, ref


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
