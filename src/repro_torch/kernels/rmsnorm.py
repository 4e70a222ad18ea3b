"""Kernel K4: RMSNorm, ``x · rsqrt(mean(x²) + eps) · γ`` per row,
accumulated in float32, returned in x's dtype (float32 or bfloat16).

Replaces ``src/repro/kernels/rmsnorm.py:18`` ``_rmsnorm_kernel``.  The
CUDA source, its bound and its design are in ``csrc/rmsnorm.cu``: rows
of up to 1024 16-byte packs are read once into registers, several rows
a CTA; longer rows, a D that is not a whole number of packs and
unaligned pointers take the kernel's general path, so it takes any D
(``plan`` says which path a shape takes).  The plain version is
``kernels.ref.rmsnorm``.

``rmsnorm_block_sumsq`` and ``rmsnorm_block_scale`` are the same
source's entry for rows split over tensor-parallel ranks (Mamba-2's
gated norm over ``d_inner``, each rank holding its SSD heads' block):
each row's float32 sum of squares over the block, which the ranks add
(``models.common.rmsnorm_over_model``), then the block scaled by the
whole row's statistic.  Their plain versions are
``ref.rmsnorm_block_sumsq`` and ``ref.rmsnorm_block_scale``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

NAMES = {torch.float32: "K4/rmsnorm_f32", torch.bfloat16: "K4/rmsnorm_bf16"}
#: the block entry's two kernels, by x's dtype
SUMSQ_NAMES = {torch.float32: "K4/block_sumsq_f32",
               torch.bfloat16: "K4/block_sumsq_bf16"}
SCALE_NAMES = {torch.float32: "K4/block_scale_f32",
               torch.bfloat16: "K4/block_scale_bf16"}

#: the fields of ``plan``, in the order the C query returns them
PLAN_FIELDS = ("path", "threads_per_row", "rows_per_cta", "packs_per_thread")
#: ``plan``'s path numbers
PATHS = ("registers", "general_packs", "general_elements")

_fn = None
_plan_fn = None
_block_fns = None


def _launcher():
    """The C launcher of the kernel."""
    global _fn
    if _fn is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.c_function(_build.load_csrc("rmsnorm.cu"),
                                "rmsnorm_launch",
                                [ptr] * 3 + [i] * 2 + [ctypes.c_float, i, ptr])
    return _fn


def _block_launchers():
    """The C launchers of the block entry (the same library): (sum of
    squares, scale)."""
    global _block_fns
    if _block_fns is None:
        ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = _build.load_csrc("rmsnorm.cu")
        _block_fns = (
            _build.c_function(lib, "rmsnorm_block_sumsq_launch",
                              [ptr] * 2 + [i] * 3 + [ptr]),
            _build.c_function(lib, "rmsnorm_block_scale_launch",
                              [ptr] * 4 + [i] * 3 + [f, i, ptr]))
    return _block_fns


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


def rmsnorm_block_sumsq(x: torch.Tensor) -> torch.Tensor:
    """x: (T, D) float32 or bfloat16 on a CUDA device, one rank's block of
    the rows.  Returns each row's float32 sum of squares over the block,
    (T,)."""
    name = SUMSQ_NAMES.get(x.dtype, SUMSQ_NAMES[torch.float32])
    _launch.check(name, "x", x, (None, None), tuple(SUMSQ_NAMES))
    T, D = x.shape
    if D < 1:
        raise ValueError(f"{name}: needs a block of >= 1 columns")
    ss = torch.empty(T, dtype=torch.float32, device=x.device)
    _launch.launch(name, _block_launchers()[0], x.data_ptr(), ss.data_ptr(),
                   T, D, int(x.dtype == torch.bfloat16), device=x.device)
    return ss


def rmsnorm_block_scale(x: torch.Tensor, ss: torch.Tensor,
                        gamma: torch.Tensor, d_total: int,
                        eps: float = 1e-6) -> torch.Tensor:
    """x: (T, D) float32 or bfloat16, one rank's block of rows of
    ``d_total`` columns; ss: (T,) float32, the rows' sums of squares over
    all ``d_total`` columns; gamma: (D,), the block's; on one CUDA
    device.  Returns ``x · rsqrt(ss / d_total + eps) · gamma`` (T, D) in
    x's dtype."""
    name = SCALE_NAMES.get(x.dtype, SCALE_NAMES[torch.float32])
    _launch.check(name, "x", x, (None, None), tuple(SCALE_NAMES))
    T, D = x.shape
    _launch.check(name, "ss", ss, (T,), device=x.device)
    _launch.check(name, "gamma", gamma, (D,), tuple(SCALE_NAMES),
                  device=x.device)
    if not 1 <= D <= d_total:
        raise ValueError(f"{name}: a block of {D} columns of rows of "
                         f"{d_total}")
    g32 = gamma.to(torch.float32)
    if g32.data_ptr() % 16:     # read in 16-byte vectors where x allows
        g32 = g32.clone()
    out = torch.empty_like(x)
    _launch.launch(name, _block_launchers()[1], x.data_ptr(), ss.data_ptr(),
                   g32.data_ptr(), out.data_ptr(), T, D, int(d_total),
                   float(eps), int(x.dtype == torch.bfloat16),
                   device=x.device)
    return out
