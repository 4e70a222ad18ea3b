"""Shared layers of the decoder: norms, rope, blockwise attention and the
MLP, from the reference's ``repro.models.common``.

Plain functions on tensors.  ``rmsnorm`` goes through
``kernels.ops.rmsnorm``: K4 on a CUDA tensor, K4's plain version on a CPU
tensor.  ``blockwise_attention`` is plain PyTorch, as the reference's is
plain JAX: no Pallas kernel stands behind it.  The reference's sharding
helpers (``constrain``, ``pspec``, ``resolve_axis``,
``set_tensor_parallel``) are the identity on one device; they come with
the port's ``dist`` slice, and ``moe_layer`` with the MoE family
(``ROADMAP.md``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops

#: the mask value of the reference's online softmax
NEG = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, gamma, eps: float = 1e-6):
    """x · rsqrt(mean x² + eps) · γ over the last dim (K4 on the card).
    The statistics and the products are float32, rounded once to x's
    dtype; the reference rounds rsqrt to x's dtype and multiplies in it,
    which is the same in float32 and within bfloat16's rounding in
    bfloat16."""
    return ops.rmsnorm(x, gamma, eps)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return ((x - mu.to(x.dtype)) * r * gamma.to(x.dtype)
            + beta.to(x.dtype))


def apply_norm(cfg, x, p, prefix: str):
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}_g"], p[f"{prefix}_b"])
    return rmsnorm(x, p[f"{prefix}_g"])


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, dh), its halves ``[:dh/2]`` and ``[dh/2:]`` rotated
    as pairs (rotate-half, the reference's convention); positions:
    (..., S).  Angles in float32, the result in x's dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention (online softmax over KV blocks)
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, block_kv: int = 1024):
    """Causal online-softmax attention streaming K and V in blocks of
    ``bk`` rows (``block_kv``, halved until it divides Sk), so the logits
    held at once are (B, Sq, Hq, bk) float32, never (Sq, Sk).

    q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, dh); Hq % Hkv == 0, the G =
    Hq / Hkv query heads of a KV head next to each other; q[0] and k[0]
    at position 0.  Masked logits are -1e30, as in the reference's
    ``causal=True, q_offset=0, window=0`` (the only case a dense
    decoder's prefill runs).  Returns q's dtype.
    """
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = dh ** -0.5
    bk = min(block_kv, Sk)
    while Sk % bk:
        bk //= 2
    dev = q.device
    qh = q.to(torch.float32) * scale
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, Hq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hq, dv), dtype=torch.float32, device=dev)
    for b0 in range(0, Sk, bk):
        kblk, vblk = k[:, b0:b0 + bk], v[:, b0:b0 + bk]
        if G > 1:                                     # grouped expansion
            kblk = kblk.repeat_interleave(G, dim=2)
            vblk = vblk.repeat_interleave(G, dim=2)
        logits = torch.einsum("bshd,bthd->bsht", qh, kblk.to(torch.float32))
        k_pos = b0 + torch.arange(bk, device=dev)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, :, None, :]
        logits = torch.where(mask, logits, NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsht,bthd->bshd", p, vblk.to(torch.float32))
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(cfg, x, wg, wu, wd):
    """SwiGLU (wg, wu, wd) or GELU in its tanh form, as ``jax.nn.gelu``
    computes it (wu, wd; wg unused)."""
    if cfg.act == "swiglu":
        h = F.silu(x @ wg) * (x @ wu)
    else:
        h = F.gelu(x @ wu, approximate="tanh")
    return h @ wd
