"""Kernel K6: one AdamW step in one pass, out of place: reads p, g, m,
v, writes p', m', v'.

Replaces ``src/repro/kernels/adamw.py:24`` ``_adamw_kernel``.  The CUDA
source, its bound (28 bytes a parameter in float32) and its design (one
grid-stride streaming pass, 16-byte loads where the pointers allow, any
N) are in ``csrc/adamw.cu``.  The plain version is ``kernels.ref.adamw``.

The hyperparameters reach the kernel as one (8,) float32 tensor on the
device, ``[lr, b1, b2, eps, wd, c1, c2, 0]`` as in the TPU kernel.  It
is made without waiting for the card: the Python numbers go in one
asynchronous copy from pinned host memory, and a learning rate or step
that is already a device tensor (a schedule) is written in on the
device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

#: by p's dtype
NAMES = {torch.float32: "K6/adamw_f32", torch.bfloat16: "K6/adamw_bf16"}

_fn = None


def _launcher():
    """The C launcher of the kernel."""
    global _fn
    if _fn is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.c_function(_build.load_csrc("adamw.cu"), "adamw_launch",
                                [ptr] * 8 + [ctypes.c_longlong, i, i, ptr])
    return _fn


def hyper(*, lr, beta1, beta2, eps, weight_decay, step,
          device: torch.device) -> torch.Tensor:
    """``[lr, b1, b2, eps, wd, c1, c2, 0]`` as an (8,) float32 tensor on
    ``device``, with ``c1 = 1 / (1 - b1**step)`` and ``c2 = 1 / (1 -
    b2**step)`` (in float64 for a Python ``step``, as the plain version
    computes them; in float32 on the device for a tensor ``step``)."""
    lr_t = lr if isinstance(lr, torch.Tensor) else None
    step_t = step if isinstance(step, torch.Tensor) else None
    c1 = c2 = 0.0
    if step_t is None:
        c1 = 1.0 / (1.0 - beta1 ** step)
        c2 = 1.0 / (1.0 - beta2 ** step)
    host = torch.tensor([0.0 if lr_t is not None else float(lr), beta1,
                         beta2, eps, weight_decay, c1, c2, 0.0],
                        dtype=torch.float32,
                        pin_memory=device.type == "cuda")
    h = host.to(device, non_blocking=True)
    if lr_t is not None:
        h[0].copy_(lr_t.reshape(()))
    if step_t is not None:
        sf = step_t.to(device=device, dtype=torch.float32)
        h[5:7] = 1.0 / (1.0 - h[1:3] ** sf)
    return h


def adamw(p, g, m, v, h):
    """p: (N,) float32 or bfloat16; g: (N,) float32 or bfloat16; m, v:
    (N,) float32; h: the (8,) float32 ``hyper`` tensor; all on one CUDA
    device.  Returns new (p', m', v'), p' in p's dtype."""
    name = NAMES.get(p.dtype, NAMES[torch.float32])
    _launch.check(name, "p", p, (None,), tuple(NAMES))
    (n,) = p.shape
    _launch.check(name, "g", g, (n,), tuple(NAMES), device=p.device)
    _launch.check(name, "m", m, (n,), device=p.device)
    _launch.check(name, "v", v, (n,), device=p.device)
    _launch.check(name, "h", h, (8,), device=p.device)
    po, mo, vo = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    _launch.launch(name, _launcher(),
                   *(t.data_ptr() for t in (h, p, g, m, v, po, mo, vo)), n,
                   int(p.dtype == torch.bfloat16),
                   int(g.dtype == torch.bfloat16), device=p.device)
    return po, mo, vo


def adamw_update(p, g, m, v, *, lr, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.0, step=1):
    """One AdamW step on flat CUDA tensors; see ``adamw``."""
    h = hyper(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step, device=p.device)
    return adamw(p, g, m, v, h)
