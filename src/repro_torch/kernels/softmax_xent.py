"""Kernel K7: softmax cross-entropy, ``logsumexp(x_t) - x_t[label_t]``
per row in float32; the mean over rows is one ``torch.mean`` after the
kernel, as the reference takes it outside its kernel.

Replaces ``src/repro/kernels/softmax_xent.py:17`` ``_xent_kernel``.
The CUDA source, its bound (the logits read once) and its design (one
CTA per row, an online max and sum in one pass) are in
``csrc/softmax_xent.cu``.  The plain versions are
``kernels.ref.softmax_xent_rows`` and ``ref.softmax_xent``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

#: by the logits' dtype
NAMES = {torch.float32: "K7/xent_f32", torch.bfloat16: "K7/xent_bf16"}
LABEL_DTYPES = (torch.int32, torch.int64)

_fn = None


def _launcher():
    """The C launcher of the kernel."""
    global _fn
    if _fn is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.c_function(_build.load_csrc("softmax_xent.cu"),
                                "xent_launch", [ptr] * 3 + [i] * 4 + [ptr])
    return _fn


def softmax_xent_rows(logits, labels):
    """logits: (T, V) float32 or bfloat16; labels: (T,) int32 or int64,
    on one CUDA device.  Returns the (T,) float32 per-row losses."""
    name = NAMES.get(logits.dtype, NAMES[torch.float32])
    _launch.check(name, "logits", logits, (None, None), tuple(NAMES))
    T, V = logits.shape
    _launch.check(name, "labels", labels, (T,), LABEL_DTYPES,
                  device=logits.device)
    if V < 1:
        raise ValueError(f"{name}: needs V >= 1 columns")
    loss = torch.empty(T, dtype=torch.float32, device=logits.device)
    _launch.launch(name, _launcher(), logits.data_ptr(), labels.data_ptr(),
                   loss.data_ptr(), T, V,
                   int(logits.dtype == torch.bfloat16),
                   int(labels.dtype == torch.int64), device=logits.device)
    return loss


def softmax_xent(logits, labels):
    """The mean cross-entropy over the rows, a 0-d float32 tensor."""
    return torch.mean(softmax_xent_rows(logits, labels))
