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


def rmsnorm_block_sumsq(x: torch.Tensor) -> torch.Tensor:
    """K4's block entry, first kernel: each row's float32 sum of squares
    over the last dim of x (one rank's block of the rows)."""
    x32 = x.to(torch.float32)
    return torch.sum(x32 * x32, dim=-1)


def rmsnorm_block_scale(x: torch.Tensor, ss: torch.Tensor,
                        gamma: torch.Tensor, d_total: int,
                        eps: float = 1e-6) -> torch.Tensor:
    """K4's block entry, second kernel: x · rsqrt(ss / d_total + eps) · γ,
    ``ss`` the rows' float32 sums of squares over all ``d_total``
    columns (x's leading shape), x and γ this block's; float32, rounded
    once to x's dtype."""
    r = torch.rsqrt(ss.to(torch.float32) / d_total + eps)[..., None]
    return (x.to(torch.float32) * r
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


def rmsnorm_backward(x, gamma, dy, eps: float = 1e-6):
    """The gradients of K4's function for the output gradient ``dy``, in
    float32 and returned in x's and gamma's dtypes: with r = rsqrt(mean
    x² + eps) and g = dy · γ, dx = r g - x r³ mean(g x) and dγ = Σ over
    the rows of dy x r."""
    x32, g32 = x.to(torch.float32), gamma.to(torch.float32)
    dy32 = dy.to(torch.float32)
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    g = dy32 * g32
    dx = r * g - x32 * r ** 3 * torch.mean(g * x32, dim=-1, keepdim=True)
    dgamma = (dy32 * x32 * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


def softmax_xent_rows(logits, labels):
    """K7's per-row losses ``logsumexp(x_t) - x_t[label_t]`` in float32;
    logits (T, V), labels (T,).  A label outside [0, V) (the -1 of a
    position with no target) reads no column: its row's loss is
    ``logsumexp(x_t)``, as the kernel's."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    lab = labels.to(torch.int64)
    valid = (lab >= 0) & (lab < lg.shape[-1])
    ll = torch.gather(lg, -1, torch.where(valid, lab, 0)[:, None])[:, 0]
    return lse - torch.where(valid, ll, 0.0)


#: rows of the logits ``softmax_xent_rows_backward`` takes at a time
XENT_BACKWARD_ROWS = 1024


def softmax_xent_rows_backward(logits, labels, dloss):
    """The gradient of ``softmax_xent_rows`` for the per-row gradients
    ``dloss`` (T,): (softmax(x_t) - onehot(label_t)) · dloss_t in float32,
    returned in the logits' dtype, ``XENT_BACKWARD_ROWS`` rows at a time
    (a float32 copy of all (T, V) logits is not held).  A label outside
    [0, V) has no one-hot column."""
    T, V = logits.shape
    out = torch.empty_like(logits)
    lab = labels.to(torch.int64)
    for r0 in range(0, T, XENT_BACKWARD_ROWS):
        r1 = min(r0 + XENT_BACKWARD_ROWS, T)
        p = torch.softmax(logits[r0:r1].to(torch.float32), dim=-1)
        lb = lab[r0:r1]
        valid = (lb >= 0) & (lb < V)
        p.scatter_add_(1, torch.where(valid, lb, 0)[:, None],
                       -valid.to(torch.float32)[:, None])
        out[r0:r1] = p.mul_(dloss[r0:r1, None].to(torch.float32))
    return out


def softmax_xent(logits, labels):
    """K7: mean token cross-entropy; logits (T, V) f32-accumulated,
    labels (T,)."""
    return torch.mean(softmax_xent_rows(logits, labels))


def softmax_xent_block(logits, labels, c0: int):
    """K7's block entry: logits (T, Vb), columns ``[c0, c0 + Vb)`` of the
    vocabulary, labels (T,).  Returns the float32 triple (m, s, xl), (T,)
    each: the row's max, its sum of ``exp(x - m)``, and ``x[label]``
    where the label falls in the block, else 0."""
    lg = logits.to(torch.float32)
    m = lg.amax(-1)
    s = torch.exp(lg - m[:, None]).sum(-1)
    lab = labels.to(torch.int64) - c0
    valid = (lab >= 0) & (lab < lg.shape[-1])
    xl = torch.gather(lg, -1, torch.where(valid, lab, 0)[:, None])[:, 0]
    return m, s, torch.where(valid, xl, 0.0)


def combine_xent_blocks(triples):
    """The per-row losses from every block's triple (``softmax_xent_block``
    over blocks that cover the vocabulary once), as the tensor-parallel
    ranks combine theirs: the largest max, the sums rescaled to it,
    ``x[label]`` summed; ``m + log(s) - x[label]``."""
    m, s, xl = (torch.stack(t) for t in zip(*triples))
    top = m.amax(0)
    return top + torch.log((s * torch.exp(m - top)).sum(0)) - xl.sum(0)


def softmax_xent_block_backward(logits, labels, c0: int, lse, dloss):
    """The gradient of a block's share of the per-row losses for the
    per-row gradients ``dloss`` (T,), given each row's ``lse`` over the
    whole vocabulary (T,): (exp(x - lse) - onehot(label - c0)) · dloss in
    float32, returned in the logits' dtype, ``XENT_BACKWARD_ROWS`` rows at
    a time.  A label outside the block has no one-hot column here."""
    T, V = logits.shape
    out = torch.empty_like(logits)
    lab = labels.to(torch.int64) - c0
    for r0 in range(0, T, XENT_BACKWARD_ROWS):
        r1 = min(r0 + XENT_BACKWARD_ROWS, T)
        p = torch.exp(logits[r0:r1].to(torch.float32) - lse[r0:r1, None])
        lb = lab[r0:r1]
        valid = (lb >= 0) & (lb < V)
        p.scatter_add_(1, torch.where(valid, lb, 0)[:, None],
                       -valid.to(torch.float32)[:, None])
        out[r0:r1] = p.mul_(dloss[r0:r1, None].to(torch.float32))
    return out


def _prefix(k, v, kv_len):
    """K and V cut to their first ``kv_len`` rows (all S where None;
    1 <= kv_len <= S); a 0-d tensor ``kv_len`` cuts nothing (its rows
    are masked instead, ``_masked``)."""
    if kv_len is None or isinstance(kv_len, torch.Tensor):
        return k, v
    S = k.shape[1]
    if not 1 <= kv_len <= S:
        raise ValueError(f"decode_attention: kv_len = {kv_len} is outside "
                         f"[1, S = {S}]")
    return k[:, :kv_len], v[:, :kv_len]


def _masked(s, kv_len):
    """Scores s (..., S) with the positions at or past a 0-d tensor
    ``kv_len`` set to -inf (unchanged for a host ``kv_len``, whose rows
    ``_prefix`` cut)."""
    if not isinstance(kv_len, torch.Tensor):
        return s
    past = torch.arange(s.shape[-1], device=s.device) >= kv_len.to(s.device)
    return s.masked_fill(past, -math.inf)


def decode_attention(q, k, v, scale: float | None = None, *, kv_len=None):
    """K5: single-token GQA decode attention over the first ``kv_len``
    rows of the cache (default all S; a host integer, or a 0-d tensor
    whose value masks the rows past it).

    q: (B, Hq, d) ; k, v: (B, S, Hkv, d) ; returns (B, Hq, d).
    Hq must be a multiple of Hkv (grouped sharing).
    """
    k, v = _prefix(k, v, kv_len)
    B, Hq, d = q.shape
    _, S, Hkv, _ = k.shape
    groups = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, groups, d).to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32)) * scale
    w = torch.softmax(_masked(logits, kv_len), dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v.to(torch.float32))
    return o.reshape(B, Hq, d).to(q.dtype)


def decode_attention_split(q, k, v, length: int, scale: float | None = None,
                           *, kv_len=None):
    """K5's split kernel: per (b, h_kv, chunk of ``length`` positions of
    the first ``kv_len``) float32 partials ``acc`` (B·Hkv·chunks, G, d) =
    Σ exp(s - m) v over the chunk, ``m`` (B·Hkv·chunks, G) its max score
    and ``l`` its sum of exp(s - m).  With a 0-d tensor ``kv_len`` the
    chunks cover all S, as the kernel plans them for a device
    ``kv_len``, and a chunk past it is empty: m = -inf, l = 0, acc = 0."""
    k, v = _prefix(k, v, kv_len)
    B, Hq, d = q.shape
    _, S, Hkv, _ = k.shape
    G = Hq // Hkv
    chunks = -(-S // length)
    pad = chunks * length - S
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, G, d).to(torch.float32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32)) * scale
    s = torch.nn.functional.pad(_masked(s, kv_len), (0, pad),
                                value=-math.inf)
    s = s.reshape(B, Hkv, G, chunks, length)
    m = torch.amax(s, dim=-1)
    p = torch.where(m[..., None] == -math.inf, 0.0,
                    torch.exp(s - m[..., None]))
    vv = torch.nn.functional.pad(v.to(torch.float32), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bhgcl,bclhd->bhcgd", p,
                       vv.reshape(B, chunks, length, Hkv, d))
    return (acc.reshape(B * Hkv * chunks, G, d),
            m.permute(0, 1, 3, 2).reshape(B * Hkv * chunks, G),
            p.sum(-1).permute(0, 1, 3, 2).reshape(B * Hkv * chunks, G))


def decode_attention_combine(acc, m, l, B: int, Hq: int,
                             dtype=torch.float32):
    """K5's combine kernel: the chunks' partials rescaled by exp(m_c - m)
    and normalized, an empty chunk (m_c = -inf) skipped; returns (B, Hq,
    d) in ``dtype``."""
    rows, G, d = acc.shape
    Hkv = Hq // G
    chunks = rows // (B * Hkv)
    acc = acc.reshape(B, Hkv, chunks, G, d)
    m = m.reshape(B, Hkv, chunks, G)
    # an empty chunk (m = -inf) weighs 0; chunk 0 is never empty
    w = torch.where(m == -math.inf, 0.0,
                    torch.exp(m - torch.amax(m, dim=2, keepdim=True)))
    o = (acc * w[..., None]).sum(2) / (l.reshape(B, Hkv, chunks, G)
                                       * w).sum(2)[..., None]
    return o.reshape(B, Hq, d).to(dtype)
