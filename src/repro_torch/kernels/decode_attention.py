"""Kernel K5: single-token GQA decode attention, ``o = softmax(q Kᵀ ·
scale) V`` per query head, the ``G = Hq / Hkv`` query heads of one KV
head sharing its K/V stream (flash-decoding).

Replaces ``src/repro/kernels/decode_attention.py:20``
``_decode_attn_kernel``.  The CUDA source, its bound and its design are
in ``csrc/decode_attention.cu``: a split kernel, one CTA per (b, h_kv,
chunk of S) with the chunk count sized from its occupancy, writes
float32 partials ``(acc, m, l)`` per chunk; a combine kernel rescales
and sums them into ``o`` in q's dtype.  Two launches, counted as
``K5/split_*`` and ``K5/combine_*``.  The plain versions are
``kernels.ref.decode_attention`` (the whole function) and
``ref.decode_attention_split`` / ``ref.decode_attention_combine`` (each
kernel).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _launch

NAMES = {torch.float32: ("K5/split_f32", "K5/combine_f32"),
         torch.bfloat16: ("K5/split_bf16", "K5/combine_bf16")}
#: the largest head dim the kernel takes (the configs in the repository
#: go up to DeepSeek-V2-Lite's 128 + 64 = 192 query-key dims)
D_MAX = 256

_fns: tuple | None = None


def _launchers():
    """The C launchers of the split and combine kernels, and the split's
    C grid query."""
    global _fns
    if _fns is None:
        lib = _build.load_csrc("decode_attention.cu")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fns = (_build.c_function(lib, "decode_attention_split_launch",
                                  [ptr] * 6 + [i] * 7
                                  + [ctypes.c_float, i, ptr]),
                _build.c_function(lib, "decode_attention_combine_launch",
                                  [ptr] * 4 + [i] * 6 + [ptr]),
                _build.c_function(lib, "decode_attention_chunks",
                                  [i] * 5 + [ctypes.POINTER(i)] * 2))
    return _fns


def check_heads(Hq: int, Hkv: int):
    """Grouped query heads: Hq must be a multiple of Hkv."""
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hq = {Hq} query heads are not "
                         f"a multiple of Hkv = {Hkv} KV heads")


def _check(q, k, v):
    """(B, Hq, Hkv, S, d) of checked inputs."""
    name = NAMES.get(q.dtype, NAMES[torch.float32])[0]
    _launch.check(name, "q", q, (None, None, None), tuple(NAMES))
    B, Hq, d = q.shape
    _launch.check(name, "k", k, (B, None, None, d), (q.dtype,),
                  device=q.device)
    _, S, Hkv, _ = k.shape
    _launch.check(name, "v", v, (B, S, Hkv, d), (q.dtype,), device=q.device)
    check_heads(Hq, Hkv)
    if not 1 <= d <= D_MAX:
        raise ValueError(f"{name}: head dim {d} is outside [1, {D_MAX}]")
    if S < 1 or B < 1:
        raise ValueError(f"{name}: needs B >= 1 and S >= 1, got {B}, {S}")
    return B, Hq, Hkv, S, d


def split(q, k, v, scale: float | None = None):
    """The split kernel: per (b, h_kv, chunk) float32 partials ``acc``
    (B·Hkv·chunks, G, d), ``m`` and ``l`` (B·Hkv·chunks, G), and the
    chunk length."""
    B, Hq, Hkv, S, d = _check(q, k, v)
    G = Hq // Hkv
    bf16 = int(q.dtype == torch.bfloat16)
    # one wave of CTAs over (b, h_kv, chunk) on this card
    chunks, length = _launch.grid_query(NAMES[q.dtype][0], _launchers()[2],
                                        B * Hkv, S, G, d, bf16,
                                        device=q.device)
    rows = B * Hkv * chunks
    acc = torch.empty((rows, G, d), dtype=torch.float32, device=q.device)
    m = torch.empty((rows, G), dtype=torch.float32, device=q.device)
    l = torch.empty((rows, G), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    _launch.launch(NAMES[q.dtype][0], _launchers()[0],
                   *(t.data_ptr() for t in (q, k, v, acc, m, l)),
                   B, Hq, Hkv, S, d, chunks, length, scale, bf16,
                   device=q.device)
    return acc, m, l, length


def combine(acc, m, l, B: int, Hq: int, dtype=torch.float32):
    """The combine kernel: ``o`` (B, Hq, d) in ``dtype`` from the split's
    partials."""
    rows, G, d = acc.shape
    name = NAMES.get(dtype, NAMES[torch.float32])[1]
    if dtype not in NAMES:
        raise TypeError(f"{name}: output dtype {dtype}, the kernel writes "
                        f"{', '.join(map(str, NAMES))}")
    if G < 1 or Hq % G:
        raise ValueError(f"{name}: Hq = {Hq} is not a multiple of G = {G}")
    Hkv = Hq // G
    if rows % (B * Hkv):
        raise ValueError(f"{name}: {rows} partial rows for B·Hkv = "
                         f"{B * Hkv}")
    _launch.check(name, "acc", acc, (rows, G, d))
    _launch.check(name, "m", m, (rows, G), device=acc.device)
    _launch.check(name, "l", l, (rows, G), device=acc.device)
    out = torch.empty((B, Hq, d), dtype=dtype, device=acc.device)
    _launch.launch(name, _launchers()[1], acc.data_ptr(), m.data_ptr(),
                   l.data_ptr(), out.data_ptr(), B, Hq, Hkv, d,
                   rows // (B * Hkv), int(dtype == torch.bfloat16),
                   device=acc.device)
    return out


def decode_attention(q, k, v, scale: float | None = None):
    """q: (B, Hq, d); k, v: (B, S, Hkv, d); all float32 or all bfloat16
    on one CUDA device, Hq a multiple of Hkv, d <= D_MAX.  Returns (B, Hq,
    d) in q's dtype."""
    acc, m, l, _ = split(q, k, v, scale)
    return combine(acc, m, l, q.shape[0], q.shape[1], q.dtype)
