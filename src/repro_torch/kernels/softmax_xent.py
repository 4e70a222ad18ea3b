"""Kernel K7: softmax cross-entropy, ``logsumexp(x_t) - x_t[label_t]``
per row in float32; the mean over rows is one ``torch.mean`` after the
kernel, as the reference takes it outside its kernel.

Replaces ``src/repro/kernels/softmax_xent.py:17`` ``_xent_kernel``.
The CUDA source, its bound (the logits read once) and its design (one
CTA per row, an online max and sum in one pass) are in
``csrc/softmax_xent.cu``.  The plain versions are
``kernels.ref.softmax_xent_rows`` and ``ref.softmax_xent``.

``softmax_xent_block`` is the same kernel's entry for one block of the
vocabulary, the logits a tensor-parallel rank holds: per row the float32
triple (max, sum of ``exp(x - max)``, ``x[label]`` where the label falls
in the block, else 0), which the ranks combine into the row's loss
(``kernels.grad.XentBlockRows``).  Its plain version is
``ref.softmax_xent_block``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _launch

#: by the logits' dtype
NAMES = {torch.float32: "K7/xent_f32", torch.bfloat16: "K7/xent_bf16"}
#: the block entry, by the logits' dtype
BLOCK_NAMES = {torch.float32: "K7/xent_block_f32",
               torch.bfloat16: "K7/xent_block_bf16"}
LABEL_DTYPES = (torch.int32, torch.int64)

_fn = None
_block_fn = None


def _launcher():
    """The C launcher of the whole rows' entry."""
    global _fn
    if _fn is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fn = _build.c_function(_build.load_csrc("softmax_xent.cu"),
                                "xent_launch", [ptr] * 3 + [i] * 4 + [ptr])
    return _fn


def _block_launcher():
    """The C launcher of the block entry (the same library)."""
    global _block_fn
    if _block_fn is None:
        ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _block_fn = _build.c_function(
            _build.load_csrc("softmax_xent.cu"), "xent_block_launch",
            [ptr] * 5 + [i] * 2 + [ll] * 2 + [i] * 2 + [ptr])
    return _block_fn


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


def softmax_xent_block(logits, labels, c0: int):
    """logits: (T, Vb) float32 or bfloat16, columns ``[c0, c0 + Vb)`` of
    the vocabulary, its rows contiguous (a column slice of wider logits
    too: the rows may lie further apart); labels: (T,) int32 or int64,
    on the same CUDA device.  Returns the float32 triple (m, s, xl), (T,)
    each: the row's max, its sum of ``exp(x - m)``, and ``x[label]``
    where ``c0 <= label < c0 + Vb``, else 0."""
    name = BLOCK_NAMES.get(logits.dtype, BLOCK_NAMES[torch.float32])
    _launch.check(name, "logits", logits, (None, None), tuple(BLOCK_NAMES),
                  rows_apart=True)
    T, Vb = logits.shape
    _launch.check(name, "labels", labels, (T,), LABEL_DTYPES,
                  device=logits.device)
    if Vb < 1:
        raise ValueError(f"{name}: needs a block of >= 1 columns")
    m, s, xl = torch.empty((3, T), dtype=torch.float32, device=logits.device)
    _launch.launch(name, _block_launcher(), logits.data_ptr(),
                   labels.data_ptr(), m.data_ptr(), s.data_ptr(),
                   xl.data_ptr(), T, Vb, logits.stride(0) if T else Vb,
                   int(c0), int(logits.dtype == torch.bfloat16),
                   int(labels.dtype == torch.int64), device=logits.device)
    return m, s, xl
