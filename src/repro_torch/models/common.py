"""Shared layers of the decoder: norms, rope, blockwise attention, the
MLP and the MoE layer, from the reference's ``repro.models.common``.

Plain functions on tensors.  ``rmsnorm`` goes through
``kernels.ops.rmsnorm`` (``kernels.grad`` where autograd needs it): K4 on
a CUDA tensor, K4's plain version on a CPU tensor.  ``blockwise_attention`` and ``moe_layer`` are plain PyTorch, as
the reference's are plain JAX: no Pallas kernel stands behind them.  The
reference's sharding helpers (``constrain``, ``pspec``, ``resolve_axis``,
``set_tensor_parallel``) are the identity on one device; they come with
the port's ``dist`` slice (``ROADMAP.md``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import grad

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
    bfloat16.  Differentiable on the training forward (``kernels.grad``:
    K4 forward, a plain float32 backward)."""
    return grad.rmsnorm(x, gamma, eps)


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

def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        block_kv: int = 1024, scale: float | None = None):
    """Online-softmax attention streaming K and V in blocks of
    ``block_kv`` rows, so the logits held at once are (B, Sq, Hq, bk)
    float32, never (Sq, Sk).

    q, k: (B, Sq, Hq, dh), (B, Sk, Hkv, dh); v: (B, Sk, Hkv, dv); Hq %
    Hkv == 0, the G = Hq / Hkv query heads of a KV head next to each
    other (they read its K and V in place, with no copy a query head);
    q[0] and k[0] at position 0; the logits scaled by ``scale``
    (``dh ** -0.5`` unless given).  ``causal``: query i attends keys j <=
    i; ``window`` (> 0): only keys with i - j < window.  Masked logits
    are -1e30, as in the reference's ``q_offset=0`` case.  Returns q's
    dtype.

    The reference halves ``block_kv`` until it divides Sk, which at
    Whisper's 1500 encoder frames leaves blocks of 4 rows; here the last
    block is shorter instead: the same online softmax over the same
    keys, equal within rounding.
    """
    B, Sq, Hq, dh = q.shape
    _, Sk, Hkv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else dh ** -0.5
    dev = q.device
    qh = (q.to(torch.float32) * scale).reshape(B, Sq, Hkv, G, dh)
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, dv), dtype=torch.float32, device=dev)
    for b0 in range(0, Sk, block_kv):
        kblk = k[:, b0:b0 + block_kv].to(torch.float32)
        vblk = v[:, b0:b0 + block_kv].to(torch.float32)
        logits = torch.einsum("bskgd,btkd->bskgt", qh, kblk)
        dropped = None                       # the masked (query, key) pairs
        if causal or window:
            gap = q_pos[:, None] - (b0 + torch.arange(kblk.shape[1],
                                                      device=dev))
            keep = torch.ones_like(gap, dtype=torch.bool)
            if causal:
                keep &= gap >= 0
            if window:
                keep &= gap < window
            dropped = ~keep[None, :, None, None, :]
            logits.masked_fill_(dropped, NEG)
        m_new = torch.maximum(m, logits.amax(-1))
        if torch.is_grad_enabled():     # training: autograd keeps logits
            p = torch.exp(logits - m_new[..., None])
            if dropped is not None:
                p = p.masked_fill(dropped, 0.0)
        else:
            p = logits.sub_(m_new[..., None]).exp_()
            if dropped is not None:
                p.masked_fill_(dropped, 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bskgt,btkd->bskgd",
                                                    p, vblk)
        m = m_new
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.reshape(B, Sq, Hq, dv).to(q.dtype)


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


# ---------------------------------------------------------------------------
# MoE: sort-based capacity dispatch
# ---------------------------------------------------------------------------

def route(cfg, x, router):
    """The router: (probs (G, Tg, E) float32, gates (G, Tg, k) renormalised
    to sum to 1, expert ids (G, Tg, k)), the top k of a token's softmax
    over its float32 router logits, largest first."""
    logits = x.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.topk, dim=-1)
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx


def dispatch(cfg, idx):
    """Capacity dispatch of expert ids (G, Tg, k): (C; the Tg·k
    assignments of a group stably sorted by expert, ``se``, and their
    token-major ``order``; tokens a expert ``counts`` and its first
    sorted position ``starts`` (G, E); each sorted assignment's ``rank``
    within its expert and whether it is kept, rank < C)."""
    G, Tg, k = idx.shape
    E, A = cfg.n_experts, Tg * k
    C = min(max(8, int(Tg * k / E * cfg.capacity_factor)), A)
    se, order = torch.sort(idx.reshape(G, A), dim=-1, stable=True)
    counts = (se[..., None] == torch.arange(E, device=idx.device)).sum(1)
    starts = counts.cumsum(-1) - counts
    rank = torch.arange(A, device=idx.device) - starts.gather(1, se)
    return C, se, order, counts, starts, rank, rank < C


def moe_layer(cfg, x, p):
    """x: (G, Tg, D) tokens in groups; p: ``router`` (D, E), ``wg``/``wu``
    (E, D, F), ``wd`` (E, F, D), and the shared expert ``wg_s``/``wu_s``/
    ``wd_s`` where ``cfg.n_shared_experts``.  Returns (out (G, Tg, D),
    aux), the reference's dispatch assignment for assignment:

    top-k of the float32 router softmax, gates renormalised; the Tg·k
    assignments of a group (token-major) stably sorted by expert; an
    assignment's rank within its expert kept below the capacity ``C =
    min(max(8, int(Tg·k / E · capacity_factor)), Tg·k)``, the rest
    dropped; the (G, E, C, D) expert batch, the expert matmuls, and each
    token's kept contributions weighted by their gates.

    Every shape is fixed by (G, Tg) and the config, and no value goes to
    the host, so a step holding this layer can be captured as one CUDA
    graph.  The expert batch is gathered (slot ``(e, c)`` reads the
    sorted assignment at expert e's start + c), and each token sums its
    k contributions in a fixed order after the sort is inverted: no
    scatter-add, so a repeated call is bitwise equal.  ``aux`` is the
    Switch-style load-balance term, E · Σ_e mean prob_e · share of
    first choices_e."""
    G, Tg, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    probs, gate, idx = route(cfg, x, p["router"])
    C, se, order, counts, starts, rank, keep = dispatch(cfg, idx)
    A = Tg * k
    dev = x.device

    # the expert batch: slot (e, c) holds sorted assignment starts_e + c
    c = torch.arange(C, device=dev)
    src = (starts[..., None] + c).reshape(G, E * C)       # (G, E·C)
    filled = (c < counts[..., None]).reshape(G, E * C)
    tok = (order // k).gather(1, src.clamp_max(A - 1))
    xe = torch.where(filled[..., None],
                     x.gather(1, tok[..., None].expand(G, E * C, D)), 0)
    xe = xe.reshape(G, E, C, D)
    h = torch.einsum("gecd,edf->gecf", xe, p["wg"])
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, p["wu"])
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("gecf,efd->gecd", h, p["wd"]).reshape(G, E * C, D)

    # back to token order: assignment (t, j) reads its slot's output
    pos = torch.arange(A, device=dev)
    inv = torch.empty_like(order).scatter_(1, order, pos.expand(G, A))
    slot = (se * C + torch.where(keep, rank, 0)).gather(1, inv)
    kept = keep.gather(1, inv)
    contrib = ye.gather(1, slot[..., None].expand(G, A, D))
    contrib = torch.where(kept[..., None], contrib, 0) \
        * gate.reshape(G, A, 1).to(x.dtype)
    out = contrib.reshape(G, Tg, k, D).to(torch.float32).sum(2).to(x.dtype)

    if cfg.n_shared_experts:
        xs = x.reshape(G * Tg, D)
        out = out + mlp(cfg, xs, p.get("wg_s"), p["wu_s"], p["wd_s"]
                        ).reshape(G, Tg, D)
    first = idx[..., 0, None] == torch.arange(E, device=dev)
    me = probs.mean(dim=(0, 1))
    ce = first.to(torch.float32).mean(dim=(0, 1))
    return out, E * (me * ce).sum()
