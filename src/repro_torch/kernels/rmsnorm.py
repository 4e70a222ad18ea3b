"""Kernel K4: RMSNorm, ``x · rsqrt(mean(x²) + eps) · γ`` per row,
accumulated in float32, returned in x's dtype (float32 or bfloat16).

Replaces ``src/repro/kernels/rmsnorm.py:18`` ``_rmsnorm_kernel``.  The
CUDA source, its bound and its design (one CTA per row) are in
``csrc/rmsnorm.cu``; it takes any D.  The plain version is
``kernels.ref.rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

NAMES = {torch.float32: "K4/rmsnorm_f32", torch.bfloat16: "K4/rmsnorm_bf16"}

_fn = None


def _launcher():
    """The C launcher of the kernel."""
    global _fn
    if _fn is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.c_function(_build.load_csrc("rmsnorm.cu"),
                                "rmsnorm_launch",
                                [ptr] * 3 + [i] * 2 + [ctypes.c_float, i, ptr])
    return _fn


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """x: (T, D) float32 or bfloat16; gamma: (D,) float32 or bfloat16,
    on one CUDA device.  Returns (T, D) in x's dtype."""
    name = NAMES.get(x.dtype, NAMES[torch.float32])
    _launch.check(name, "x", x, (None, None), tuple(NAMES))
    T, D = x.shape
    _launch.check(name, "gamma", gamma, (D,), tuple(NAMES), device=x.device)
    g32 = gamma.to(torch.float32)
    out = torch.empty_like(x)
    _launch.launch(name, _launcher(), x.data_ptr(), g32.data_ptr(),
                   out.data_ptr(), T, D, float(eps),
                   int(x.dtype == torch.bfloat16), device=x.device)
    return out
