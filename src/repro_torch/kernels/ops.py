"""Public API over the hand kernels, with the reference's names and
argument order (``repro.kernels.ops``): ``rmsnorm`` (K4), ``bicgk`` (K2),
``gemver`` (K3), ``adamw_update`` (K6), ``softmax_xent`` (K7) and
``decode_attention`` (K5); and ``softmax_xent_rows``, K7's per-row losses
(the training loss masks and averages them, ``models.forward.lm_loss``),
and ``softmax_xent_block``, K7's triple over one block of the vocabulary
(a tensor-parallel rank's logits).

Tensors on a CUDA device always launch the kernel; tensors on the CPU
run the plain version in ``kernels.ref``.  Nothing falls back: a failed
build or launch, or a mix of devices, raises.  The reference's
``use_pallas``/``interpret`` switches are gone, and so are its gates
that sent TPU-unfriendly shapes to the plain version, because the CUDA
kernels take those shapes:

* ``rmsnorm``: any ``D`` (the reference's ``D % 128``);
* ``adamw_update``: any ``N`` and any shape, taken flat (the reference's
  1-D ``N % 128``);
* ``decode_attention``: any head dim ``d`` up to
  ``kernels.decode_attention.D_MAX`` = 256 (the reference's ``d % 128``);
  a larger ``d`` raises.  ``Hq % Hkv != 0`` raises ``ValueError`` on
  every device: the plain version cannot compute it either;
* ``softmax_xent``: 2-D logits on CUDA (the reference's ``ndim == 2``
  gate); other shapes raise there.
"""
from __future__ import annotations

import torch

from . import adamw as _adamw
from . import bicgk as _bicgk
from . import decode_attention as _attn
from . import gemver as _gemver
from . import ref
from . import rmsnorm as _rmsnorm
from . import softmax_xent as _xent
from ._launch import device_scalar


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors
               if isinstance(t, torch.Tensor))


def rmsnorm(x, gamma, eps=1e-6):
    """Rowwise over the last dim of ``x`` (any leading shape)."""
    if _on_cpu(x, gamma):
        return ref.rmsnorm(x, gamma, eps)
    return _rmsnorm.rmsnorm(x.reshape(-1, x.shape[-1]), gamma,
                            eps).reshape(x.shape)


def bicgk(A, p, r):
    """(q, s) = (A p, Aᵀ r)."""
    if _on_cpu(A, p, r):
        return ref.bicgk(A, p, r)
    return _bicgk.bicgk(A, p, r)


def gemver(A, u1, v1, u2, v2, y, z, alpha, beta):
    """(B, x, w) with B = A + u1 v1ᵀ + u2 v2ᵀ, x = β Bᵀ y + z,
    w = α B x."""
    if _on_cpu(A, u1, v1, u2, v2, y, z, alpha, beta):
        return ref.gemver(A, u1, v1, u2, v2, y, z, alpha, beta)
    return _gemver.gemver(A, u1, v1, u2, v2, y, z,
                          device_scalar(alpha, A.device),
                          device_scalar(beta, A.device))


def adamw_update(p, g, m, v, *, lr, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.0, step=1):
    """One AdamW step; returns new (p', m', v') of p's shape.  ``lr``
    and ``step`` may be tensors (a schedule)."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step)
    if _on_cpu(p, g, m, v, lr, step):
        return ref.adamw(p, g, m, v, **kw)
    outs = _adamw.adamw_update(p.reshape(-1), g.reshape(-1), m.reshape(-1),
                               v.reshape(-1), **kw)
    return tuple(o.reshape(p.shape) for o in outs)


def softmax_xent_rows(logits, labels):
    """Per-row losses ``logsumexp(x_t) - x_t[label_t]`` (T,) float32;
    logits (T, V), labels (T,) (a label outside [0, V) reads no
    column)."""
    if _on_cpu(logits, labels):
        return ref.softmax_xent_rows(logits, labels)
    if logits.dim() != 2:
        raise ValueError(f"softmax_xent_rows: logits must be 2-D (T, V) on "
                         f"CUDA, got shape {tuple(logits.shape)}")
    return _xent.softmax_xent_rows(logits, labels)


def softmax_xent_block(logits, labels, c0: int):
    """The float32 triple (max, sum of ``exp(x - max)``, ``x[label]`` or
    0), (T,) each, of logits (T, Vb) holding columns ``[c0, c0 + Vb)``
    of the vocabulary; labels (T,)."""
    if _on_cpu(logits, labels):
        return ref.softmax_xent_block(logits, labels, c0)
    if logits.dim() != 2:
        raise ValueError(f"softmax_xent_block: logits must be 2-D (T, Vb) "
                         f"on CUDA, got shape {tuple(logits.shape)}")
    return _xent.softmax_xent_block(logits, labels, c0)


def softmax_xent(logits, labels):
    """Mean token cross-entropy; logits (T, V), labels (T,)."""
    if _on_cpu(logits, labels):
        return ref.softmax_xent(logits, labels)
    if logits.dim() != 2:
        raise ValueError(f"softmax_xent: logits must be 2-D (T, V) on "
                         f"CUDA, got shape {tuple(logits.shape)}")
    return _xent.softmax_xent(logits, labels)


def decode_attention(q, k, v, kv_len=None):
    """q: (B, Hq, d); k, v: (B, S, Hkv, d) -> (B, Hq, d), attending the
    first ``kv_len`` rows of k and v (a host integer, 1 <= kv_len <= S,
    or a 0-d int32 tensor on q's device holding one; default S): the
    valid prefix of a cache allocated at its full horizon, read in
    place."""
    _attn.check_heads(q.shape[1], k.shape[2])
    kv_len = _attn.check_kv_len(kv_len, k.shape[1], q.device)
    if _on_cpu(q, k, v):
        return ref.decode_attention(q, k, v, kv_len=kv_len)
    return _attn.decode_attention(q, k, v, kv_len=kv_len)
