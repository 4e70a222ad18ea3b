"""Kernel K3: GEMVER, ``B = A + u1 v1ᵀ + u2 v2ᵀ``, ``x = β Bᵀy + z``,
``w = α B x`` — two CUDA kernels with the cheap ``x`` between them.

Replaces ``src/repro/kernels/gemver.py:26`` ``_k1`` and ``:38`` ``_k2``.
The CUDA source, its bound (three matrix streams) and its design are in
``csrc/gemver.cu``.  The plain versions are ``kernels.ref.gemver_k1``,
``gemver_k2`` and ``gemver``.  Scalars travel as one-element device
tensors, so nothing here waits for the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

NAME_K1, NAME_K2 = "K3/gemver_k1", "K3/gemver_k2"

_fns: tuple | None = None


def _launchers():
    """The C launchers of gemver_k1 and gemver_k2, and gemver_k1's C
    grid query."""
    global _fns
    if _fns is None:
        lib = _build.load_csrc("gemver.cu")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fns = (_build.c_function(lib, "gemver_k1_launch",
                                  [ptr] * 8 + [i] * 3 + [ptr]),
                _build.c_function(lib, "gemver_k2_launch",
                                  [ptr] * 4 + [i] * 2 + [ptr]),
                _build.c_function(lib, "gemver_groups",
                                  [i, i] + [ctypes.POINTER(i)] * 2))
    return _fns


def gemver_k1(A, u1, v1, u2, v2, y):
    """Returns (B, t): ``B = A + u1 v1ᵀ + u2 v2ᵀ`` and ``t = Bᵀ y``, one
    pass over A.  A: (m, n); u1, u2, y: (m,); v1, v2: (n,); float32."""
    _launch.check(NAME_K1, "A", A, (None, None))
    m, n = A.shape
    for name, t, size in (("u1", u1, m), ("v1", v1, n), ("u2", u2, m),
                          ("v2", v2, n), ("y", y, m)):
        _launch.check(NAME_K1, name, t, (size,), device=A.device)
    launch, _, query = _launchers()
    groups, _ = _launch.grid_query(NAME_K1, query, m, n, device=A.device)
    B = torch.empty_like(A)
    t_part = torch.empty((groups, n), dtype=torch.float32, device=A.device)
    _launch.launch(NAME_K1, launch,
                   *(t.data_ptr() for t in (A, u1, v1, u2, v2, y, B, t_part)),
                   m, n, groups, device=A.device)
    return B, t_part.sum(0)


def gemver_k2(B, x, alpha):
    """``w = α B x``.  B: (m, n); x: (n,); alpha: a one-element tensor;
    float32."""
    _launch.check(NAME_K2, "B", B, (None, None))
    m, n = B.shape
    _launch.check(NAME_K2, "x", x, (n,), device=B.device)
    _launch.check(NAME_K2, "alpha", alpha.reshape(-1), (1,), device=B.device)
    w = torch.empty(m, dtype=torch.float32, device=B.device)
    _launch.launch(NAME_K2, _launchers()[1], B.data_ptr(),
                   x.data_ptr(), alpha.data_ptr(), w.data_ptr(), m, n,
                   device=B.device)
    return w


def gemver(A, u1, v1, u2, v2, y, z, alpha, beta):
    """Returns (B, x, w).  alpha, beta: one-element float32 tensors on
    A's device."""
    _launch.check(NAME_K1, "z", z, (A.shape[-1],), device=A.device)
    _launch.check(NAME_K1, "beta", beta.reshape(-1), (1,), device=A.device)
    B, t = gemver_k1(A, u1, v1, u2, v2, y)
    x = torch.addcmul(z, beta.reshape(()), t)
    return B, x, gemver_k2(B, x, alpha)
