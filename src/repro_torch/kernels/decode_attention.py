"""Kernel K5: single-token GQA decode attention, ``o = softmax(q Kᵀ ·
scale) V`` per query head, the ``G = Hq / Hkv`` query heads of one KV
head sharing its K/V stream (flash-decoding).

Replaces ``src/repro/kernels/decode_attention.py:20``
``_decode_attn_kernel``.  The CUDA source, its bound and its design are
in ``csrc/decode_attention.cu``: a split kernel, one CTA per (b, h_kv,
chunk of S, group of at most 8 query heads), streams its chunk of K and
V through a ring of shared-memory stages filled by ``cp.async`` (bulk
copies and tensor cores for bfloat16 at d of 64, 128 or 256) and
writes float32 partials ``(acc, m, l)`` per chunk; a combine kernel
folds the chunks of each query head, a warp per 1-32 chunks, into ``o``
in q's dtype.  Two launches, counted as ``K5/split_*`` and
``K5/combine_*``.  The chunks are sized by ``chunk_plan`` from the
split's configuration on the card (``config``).  The plain versions are
``kernels.ref.decode_attention`` (the whole function) and
``ref.decode_attention_split`` / ``ref.decode_attention_combine`` (each
kernel).  ``kv_len`` (at most S; default S) attends only the first
``kv_len`` rows of each batch's K and V: a decode cache allocated at its
full horizon and filled up to the step's position, read in place.  It is
a host integer, or a 0-d int32 tensor on q's device that the split reads
from device memory when it runs: then the chunks are planned once for
all S, a chunk past ``kv_len`` writes empty partials (m = -inf, l = 0,
acc = 0) that the combine skips, and one captured CUDA graph of a decode
step serves every position.
"""
from __future__ import annotations

import ctypes
import math
import operator

import torch

from . import _build, _launch

NAMES = {torch.float32: ("K5/split_f32", "K5/combine_f32"),
         torch.bfloat16: ("K5/split_bf16", "K5/combine_bf16")}
#: the largest head dim the kernel takes (the configs in the repository
#: go up to DeepSeek-V2-Lite's 128 + 64 = 192 query-key dims)
D_MAX = 256

#: the split configuration's fields, in the order the C query returns them
CONFIG_FIELDS = ("ctas_per_sm", "sms", "head_groups", "heads_per_cta",
                 "tile", "stages", "smem_bytes", "threads", "lanes_per_row",
                 "tensor_cores")

_fns: tuple | None = None


def _launchers():
    """The C launchers of the split and combine kernels, and the split's
    C configuration query."""
    global _fns
    if _fns is None:
        lib = _build.load_csrc("decode_attention.cu")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        _fns = (_build.c_function(lib, "decode_attention_split_launch",
                                  [ptr] * 6 + [i] * 8
                                  + [ctypes.c_float, i, ptr, ptr]),
                _build.c_function(lib, "decode_attention_combine_launch",
                                  [ptr] * 4 + [i] * 6 + [ptr]),
                _build.c_function(lib, "decode_attention_config",
                                  [i] * 3 + [ctypes.POINTER(i)]
                                  * len(CONFIG_FIELDS)))
    return _fns


def config(G: int, d: int, dtype, device: torch.device) -> dict:
    """The split kernel's configuration for G query heads a KV head and
    head dim d on ``device``'s card (K and V 16-byte aligned):
    ``CONFIG_FIELDS``."""
    vals = _launch.grid_query(NAMES[dtype][0], _launchers()[2], G, d,
                              int(dtype == torch.bfloat16), device=device,
                              count=len(CONFIG_FIELDS))
    return dict(zip(CONFIG_FIELDS, vals))


def ctas_per_chunk(B: int, Hkv: int, cfg: dict) -> int:
    """The split's CTAs for one chunk of S: one a (b, KV head, group of
    query heads)."""
    return B * Hkv * cfg["head_groups"]


def chunk_plan(ctas: int, S: int, slots: int, tile: int) -> tuple[int, int]:
    """(chunks, length): S cut into chunks of ``length`` positions, a
    whole number of ``tile``-row tiles each, so that ``ctas`` CTAs a
    chunk (``ctas_per_chunk``) fill the card's ``slots`` resident CTAs
    in one wave; at least one chunk, and every chunk holds at least one
    position (only the last one is short)."""
    if min(ctas, S, slots, tile) < 1:
        raise ValueError(f"chunk_plan: needs positive arguments, got "
                         f"{ctas}, {S}, {slots}, {tile}")
    want = max(1, slots // ctas)
    length = -(-S // want)
    length = -(-length // tile) * tile
    return -(-S // length), length


def check_heads(Hq: int, Hkv: int):
    """Grouped query heads: Hq must be a multiple of Hkv."""
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hq = {Hq} query heads are not "
                         f"a multiple of Hkv = {Hkv} KV heads")


def check_kv_len(kv_len, S: int, device: torch.device | None = None):
    """The rows of the cache to attend: ``kv_len`` (a host integer,
    1 <= kv_len <= S), S where it is None; or a 0-d int32 tensor on
    ``device`` (where given), returned as it is: its value stays on the
    device, unchecked (1 <= kv_len <= S is the caller's)."""
    if kv_len is None:
        return S
    if isinstance(kv_len, torch.Tensor):
        if kv_len.shape != () or kv_len.dtype != torch.int32:
            raise ValueError(f"decode_attention: a kv_len tensor must be "
                             f"0-d int32, got {tuple(kv_len.shape)} "
                             f"{kv_len.dtype}")
        if device is not None and kv_len.device != device:
            raise ValueError(f"decode_attention: kv_len is on "
                             f"{kv_len.device}, q on {device}")
        return kv_len
    kv_len = operator.index(kv_len)
    if not 1 <= kv_len <= S:
        raise ValueError(f"decode_attention: kv_len = {kv_len} is outside "
                         f"[1, S = {S}]")
    return kv_len


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


def split(q, k, v, scale: float | None = None, *, kv_len=None):
    """The split kernel: per (b, h_kv, chunk of the first ``kv_len``
    rows) float32 partials ``acc`` (B·Hkv·chunks, G, d), ``m`` and ``l``
    (B·Hkv·chunks, G), and the chunk length.  With a device ``kv_len``
    the chunks cover all S, those past it empty."""
    B, Hq, Hkv, S, d = _check(q, k, v)
    kv_len = check_kv_len(kv_len, S, q.device)
    on_device = isinstance(kv_len, torch.Tensor)
    planned = S if on_device else kv_len
    G = Hq // Hkv
    bf16 = int(q.dtype == torch.bfloat16)
    cfg = config(G, d, q.dtype, q.device)
    chunks, length = chunk_plan(ctas_per_chunk(B, Hkv, cfg), planned,
                                cfg["ctas_per_sm"] * cfg["sms"],
                                cfg["tile"])
    rows = B * Hkv * chunks
    acc = torch.empty((rows, G, d), dtype=torch.float32, device=q.device)
    m = torch.empty((rows, G), dtype=torch.float32, device=q.device)
    l = torch.empty((rows, G), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    _launch.launch(NAMES[q.dtype][0], _launchers()[0],
                   *(t.data_ptr() for t in (q, k, v, acc, m, l)),
                   B, Hq, Hkv, S, planned, d, chunks, length, scale, bf16,
                   kv_len.data_ptr() if on_device else None,
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


def decode_attention(q, k, v, scale: float | None = None, *, kv_len=None):
    """q: (B, Hq, d); k, v: (B, S, Hkv, d); all float32 or all bfloat16
    on one CUDA device, Hq a multiple of Hkv, d <= D_MAX; attends the
    first ``kv_len`` rows (default S; a host integer or a 0-d int32
    device tensor).  Returns (B, Hq, d) in q's dtype."""
    acc, m, l, _ = split(q, k, v, scale, kv_len=kv_len)
    return combine(acc, m, l, q.shape[0], q.shape[1], q.dtype)
