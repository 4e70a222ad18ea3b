"""Plain PyTorch versions of every hand kernel, K2–K7, accumulated in
float32 as the reference's ``repro.kernels.ref`` is, and of the two
kernels of K5 one by one.

The tests hold the kernels' arithmetic to these on the CPU, and
``chip_smoke.py`` holds the kernels to them on the card.  ``ops`` runs
them for tensors on the CPU; nothing on the card's path calls them.
"""
from __future__ import annotations

import math

import torch


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K4: y = x / rms(x) * gamma, rowwise over the last dim."""
    x32 = x.to(torch.float32)
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)
            * gamma.to(torch.float32)).to(x.dtype)


def bicgk(A, p, r):
    """K2: q = A p ; s = Aᵀ r."""
    return torch.mv(A, p), torch.mv(A.T, r)


def gemver_k1(A, u1, v1, u2, v2, y):
    """K3 ``_k1``: B = A + u1 v1ᵀ + u2 v2ᵀ and t = Bᵀ y."""
    B = A + torch.outer(u1, v1) + torch.outer(u2, v2)
    return B, torch.mv(B.T, y)


def gemver_k2(B, x, alpha):
    """K3 ``_k2``: w = α B x."""
    return alpha * torch.mv(B, x)


def gemver(A, u1, v1, u2, v2, y, z, alpha, beta):
    """K3: B = A + u1 v1ᵀ + u2 v2ᵀ ; x = β Bᵀ y + z ; w = α B x."""
    B, t = gemver_k1(A, u1, v1, u2, v2, y)
    x = beta * t + z
    return B, x, gemver_k2(B, x, alpha)


def adamw(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, step):
    """K6: one fused AdamW update; returns (p', m', v')."""
    g32, p32 = g.to(torch.float32), p.to(torch.float32)
    m = beta1 * m + (1 - beta1) * g32
    v = beta2 * v + (1 - beta2) * (g32 * g32)
    c1 = 1.0 / (1.0 - beta1 ** step)
    c2 = 1.0 / (1.0 - beta2 ** step)
    upd = (m * c1) / (torch.sqrt(v * c2) + eps) + weight_decay * p32
    return (p32 - lr * upd).to(p.dtype), m, v


def softmax_xent_rows(logits, labels):
    """K7's per-row losses ``logsumexp(x_t) - x_t[label_t]`` in float32;
    logits (T, V), labels (T,)."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.to(torch.int64)[:, None])[:, 0]
    return lse - ll


def softmax_xent(logits, labels):
    """K7: mean token cross-entropy; logits (T, V) f32-accumulated,
    labels (T,)."""
    return torch.mean(softmax_xent_rows(logits, labels))


def decode_attention(q, k, v, scale: float | None = None):
    """K5: single-token GQA decode attention.

    q: (B, Hq, d) ; k, v: (B, S, Hkv, d) ; returns (B, Hq, d).
    Hq must be a multiple of Hkv (grouped sharing).
    """
    B, Hq, d = q.shape
    _, S, Hkv, _ = k.shape
    groups = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, groups, d).to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32)) * scale
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.to(torch.float32))
    return o.reshape(B, Hq, d).to(q.dtype)


def decode_attention_split(q, k, v, length: int, scale: float | None = None):
    """K5's split kernel: per (b, h_kv, chunk of ``length`` positions)
    float32 partials ``acc`` (B·Hkv·chunks, G, d) = Σ exp(s - m) v over
    the chunk, ``m`` (B·Hkv·chunks, G) its max score and ``l`` its sum of
    exp(s - m)."""
    B, Hq, d = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    chunks = -(-S // length)
    pad = chunks * length - S
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, G, d).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32)) * scale
    s = torch.nn.functional.pad(s, (0, pad), value=-math.inf)
    s = s.reshape(B, Hkv, G, chunks, length)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    vv = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bhgcl,bclhd->bhcgd", p,
                       vv.reshape(B, chunks, length, Hkv, d))
    return (acc.reshape(B * Hkv * chunks, G, d),
            m.permute(0, 1, 3, 2).reshape(B * Hkv * chunks, G),
            p.sum(-1).permute(0, 1, 3, 2).reshape(B * Hkv * chunks, G))


def decode_attention_combine(acc, m, l, B: int, Hq: int,
                             dtype=torch.float32):
    """K5's combine kernel: the chunks' partials rescaled by exp(m_c - m)
    and normalized; returns (B, Hq, d) in ``dtype``."""
    rows, G, d = acc.shape
    Hkv = Hq // G
    chunks = rows // (B * Hkv)
    acc = acc.reshape(B, Hkv, chunks, G, d)
    m = m.reshape(B, Hkv, chunks, G)
    w = torch.exp(m - torch.amax(m, dim=2, keepdim=True))
    o = (acc * w[..., None]).sum(2) / (l.reshape(B, Hkv, chunks, G)
                                       * w).sum(2)[..., None]
    return o.reshape(B, Hq, d).to(dtype)
