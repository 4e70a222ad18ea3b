"""Public API over the hand kernels, with the reference's names and
argument order (``repro.kernels.ops``): ``rmsnorm`` (K4), ``bicgk`` (K2)
and ``gemver`` (K3).

Tensors on a CUDA device always launch the kernel; tensors on the CPU
run the plain version in ``kernels.ref``.  Nothing falls back: a failed
build or launch, or a mix of devices, raises.  The reference's
``use_pallas``/``interpret`` switches are gone, and so is its
``LANES = 128`` gate (rmsnorm only on ``D % 128 == 0``, else the plain
version): that was a TPU layout limit, and the CUDA kernels take any
``D``.  ``adamw_update``, ``softmax_xent`` and ``decode_attention`` come
with their kernels (K6, K7, K5).
"""
from __future__ import annotations

import torch

from . import bicgk as _bicgk
from . import gemver as _gemver
from . import ref
from . import rmsnorm as _rmsnorm


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors
               if isinstance(t, torch.Tensor))


def _device_scalar(a, device: torch.device) -> torch.Tensor:
    """A scalar as a one-element float32 tensor on ``device``, made on
    the device (no host round trip) when it is a Python number."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.full((), float(a), dtype=torch.float32, device=device)


def rmsnorm(x, gamma, eps=1e-6):
    """Rowwise over the last dim of ``x`` (any leading shape)."""
    if _on_cpu(x, gamma):
        return ref.rmsnorm(x, gamma, eps)
    return _rmsnorm.rmsnorm(x.reshape(-1, x.shape[-1]), gamma,
                            eps).reshape(x.shape)


def bicgk(A, p, r):
    """(q, s) = (A p, Aᵀ r)."""
    if _on_cpu(A, p, r):
        return ref.bicgk(A, p, r)
    return _bicgk.bicgk(A, p, r)


def gemver(A, u1, v1, u2, v2, y, z, alpha, beta):
    """(B, x, w) with B = A + u1 v1ᵀ + u2 v2ᵀ, x = β Bᵀ y + z,
    w = α B x."""
    if _on_cpu(A, u1, v1, u2, v2, y, z, alpha, beta):
        return ref.gemver(A, u1, v1, u2, v2, y, z, alpha, beta)
    return _gemver.gemver(A, u1, v1, u2, v2, y, z,
                          _device_scalar(alpha, A.device),
                          _device_scalar(beta, A.device))
