"""Kernel K2: BiCGK, ``q = A p`` and ``s = Aᵀ r`` in one pass over A.

Replaces ``src/repro/kernels/bicgk.py:20`` ``_bicgk_kernel``.  The CUDA
source, its bound and its design are in ``csrc/bicgk.cu``: column strips
of A cut into as many row ranges as fill the card in one wave, one CTA
each, with per-CTA partials of q and s summed here after the kernel.
The plain version is ``kernels.ref.bicgk``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

NAME = "K2/bicgk"

_fns: tuple | None = None


def _launchers():
    """The C launcher and the C grid query of the kernel."""
    global _fns
    if _fns is None:
        lib = _build.load_csrc("bicgk.cu")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fns = (_build.c_function(lib, "bicgk_launch",
                                  [ptr] * 5 + [i] * 3 + [ptr]),
                _build.c_function(lib, "bicgk_groups",
                                  [i, i] + [ctypes.POINTER(i)] * 2))
    return _fns


def bicgk(A: torch.Tensor, p: torch.Tensor, r: torch.Tensor):
    """A: (m, n), p: (n,), r: (m,), float32 on one CUDA device.
    Returns (q, s)."""
    _launch.check(NAME, "A", A, (None, None))
    m, n = A.shape
    _launch.check(NAME, "p", p, (n,), device=A.device)
    _launch.check(NAME, "r", r, (m,), device=A.device)
    launch, query = _launchers()
    groups, strips = _launch.grid_query(NAME, query, m, n, device=A.device)
    q_part = torch.empty((strips, m), dtype=torch.float32, device=A.device)
    s_part = torch.empty((groups, n), dtype=torch.float32, device=A.device)
    _launch.launch(NAME, launch, A.data_ptr(), p.data_ptr(), r.data_ptr(),
                   q_part.data_ptr(), s_part.data_ptr(), m, n, groups,
                   device=A.device)
    return q_part.sum(0), s_part.sum(0)
