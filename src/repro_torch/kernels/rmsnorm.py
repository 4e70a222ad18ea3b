"""Kernel K4: RMSNorm, ``x · rsqrt(mean(x²) + eps) · γ`` per row,
accumulated in float32, returned in x's dtype (float32 or bfloat16).

Replaces ``src/repro/kernels/rmsnorm.py:18`` ``_rmsnorm_kernel``.  The
CUDA source, its bound and its design are in ``csrc/rmsnorm.cu``: rows
of up to 1024 16-byte packs are read once into registers, several rows
a CTA; longer rows, a D that is not a whole number of packs and
unaligned pointers take the kernel's general path, so it takes any D
(``plan`` says which path a shape takes).  The plain version is
``kernels.ref.rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

NAMES = {torch.float32: "K4/rmsnorm_f32", torch.bfloat16: "K4/rmsnorm_bf16"}

#: the fields of ``plan``, in the order the C query returns them
PLAN_FIELDS = ("path", "threads_per_row", "rows_per_cta", "packs_per_thread")
#: ``plan``'s path numbers
PATHS = ("registers", "general_packs", "general_elements")

_fn = None
_plan_fn = None


def _launcher():
    """The C launcher of the kernel."""
    global _fn
    if _fn is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.c_function(_build.load_csrc("rmsnorm.cu"),
                                "rmsnorm_launch",
                                [ptr] * 3 + [i] * 2 + [ctypes.c_float, i, ptr])
    return _fn


def plan(D: int, dtype, device: torch.device, aligned: bool = True) -> dict:
    """The kernel's path for rows of D elements of ``dtype`` with 16-byte
    aligned pointers (or not): ``PLAN_FIELDS``, the path named after
    ``PATHS``."""
    global _plan_fn
    if _plan_fn is None:
        i = ctypes.c_int
        _plan_fn = _build.c_function(_build.load_csrc("rmsnorm.cu"),
                                     "rmsnorm_plan",
                                     [i] * 3 + [ctypes.POINTER(i)] * 4)
    vals = _launch.grid_query(NAMES[dtype], _plan_fn, D,
                              int(dtype == torch.bfloat16), int(aligned),
                              device=device, count=len(PLAN_FIELDS))
    out = dict(zip(PLAN_FIELDS, vals))
    out["path"] = PATHS[out["path"]]
    return out


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """x: (T, D) float32 or bfloat16; gamma: (D,) float32 or bfloat16,
    on one CUDA device.  Returns (T, D) in x's dtype."""
    name = NAMES.get(x.dtype, NAMES[torch.float32])
    _launch.check(name, "x", x, (None, None), tuple(NAMES))
    T, D = x.shape
    _launch.check(name, "gamma", gamma, (D,), tuple(NAMES), device=x.device)
    g32 = gamma.to(torch.float32)
    if g32.data_ptr() % 16:     # the kernel reads gamma in 16-byte vectors
        g32 = g32.clone()
    out = torch.empty_like(x)
    _launch.launch(name, _launcher(), x.data_ptr(), g32.data_ptr(),
                   out.data_ptr(), T, D, float(eps),
                   int(x.dtype == torch.bfloat16), device=x.device)
    return out
