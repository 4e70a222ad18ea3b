"""Shared layers of the decoder: norms, rope, blockwise attention, the
MLP and the MoE layer, from the reference's ``repro.models.common``.

Plain functions on tensors.  ``rmsnorm`` goes through
``kernels.ops.rmsnorm`` (``kernels.grad`` where autograd needs it): K4 on
a CUDA tensor, K4's plain version on a CPU tensor.  ``blockwise_attention``
and ``moe_layer`` are plain PyTorch, as the reference's are plain JAX: no
Pallas kernel stands behind them.

The reference's sharding helpers (``set_tensor_parallel``,
``resolve_axis``, ``pspec``, ``logical_axis_size``, ``constrain``) read
the ambient mesh (``dist.sharding.use_mesh``).  Logical axes: ``dp``,
data parallel (``pod`` and ``data``; with tensor parallelism off, also
``model``), and ``tp``, tensor parallel (``model``).

Tensor parallelism does not go through ``constrain``.  The reference's
constraints tell GSPMD where each tensor lies and leave the collectives
to it; the port has no such compiler, and its layers run on plain
tensors (FSDP2 hands each layer its whole weights).  So each of the
reference's ``tp`` sites is explicit on a sharded step's
``TensorParallel`` (``tensor_parallel()``, None elsewhere): the layer
takes its block of the weight (``mlp``'s ``tp``: the columns of ``wg``
and ``wu``, the rows of ``wd``; ``model.gqa_attention``'s heads;
``forward.unembed``'s vocabulary), and the sequence-parallel
boundaries are collectives with their gradients
(``dist.spmd.gather_seq`` before a block, ``scatter_seq`` after it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import grad

#: the mask value of the reference's online softmax
NEG = -1e30


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

def _mesh():
    from ..dist.sharding import current_mesh
    return current_mesh()


def _mesh_axes() -> tuple[str, ...]:
    from ..dist.sharding import axis_names
    mesh = _mesh()
    return axis_names(mesh) if mesh is not None else ()


#: with tensor parallelism off, ``tp`` resolves to nothing and ``dp``
#: absorbs the whole mesh (the reference's pure FSDP over every chip)
_TP_ENABLED = True


def set_tensor_parallel(enabled: bool):
    global _TP_ENABLED
    _TP_ENABLED = bool(enabled)


def tensor_parallel_enabled() -> bool:
    return _TP_ENABLED


def resolve_axis(logical: str | None, axes: tuple[str, ...]):
    """The mesh axes a logical axis maps to on a mesh of ``axes``: a
    tuple of names for ``dp``, ``model`` (or None) for ``tp``, the name
    itself where the mesh has it, None otherwise."""
    if logical is None:
        return None
    if logical == "dp":
        pool = ("pod", "data") if _TP_ENABLED else ("pod", "data", "model")
        got = tuple(a for a in pool if a in axes)
        return got if got else None
    if logical == "tp":
        if not _TP_ENABLED:
            return None
        return "model" if "model" in axes else None
    return logical if logical in axes else None


def pspec(*logical: str | None) -> tuple:
    """The spec entries of logical axes on the ambient mesh."""
    axes = _mesh_axes()
    return tuple(resolve_axis(x, axes) for x in logical)


def logical_axis_size(logical: str) -> int:
    """The product of the mesh sizes a logical axis maps to (1 off a
    mesh)."""
    mesh = _mesh()
    if mesh is None:
        return 1
    from ..dist.sharding import mesh_axis_sizes
    sizes = mesh_axis_sizes(mesh)
    ax = resolve_axis(logical, tuple(sizes))
    if ax is None:
        return 1
    out = 1
    for a in ((ax,) if isinstance(ax, str) else ax):
        out *= sizes[a]
    return out


def tensor_parallel():
    """The ``dist.spmd.TensorParallel`` of the sharded step running now
    (a dense config's forward split over its ``model`` ranks), or
    None."""
    from ..dist.spmd import current_spmd
    spmd = current_spmd()
    return spmd.tp if spmd is not None else None


def constrain(x, *logical: str | None, barrier: bool = False):
    """The reference's sharding constraint: the identity on a plain
    tensor or off a mesh; a ``DTensor`` is redistributed to the
    placements of the logical axes on its own mesh.  ``barrier`` is the
    reference's XLA scheduling barrier, which has no counterpart here."""
    del barrier
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not _mesh_axes():
        return x
    from ..dist.sharding import NamedSharding, axis_names
    mesh = x.device_mesh
    spec = tuple(resolve_axis(a, axis_names(mesh)) for a in logical)
    return x.redistribute(mesh, NamedSharding(mesh, spec).placements)


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

def mlp(cfg, x, wg, wu, wd, tp=None):
    """SwiGLU (wg, wu, wd) or GELU in its tanh form, as ``jax.nn.gelu``
    computes it (wu, wd; wg unused).  ``tp`` (a ``TensorParallel``): this
    rank's block of the hidden columns (``wg``/``wu`` cut by columns,
    ``wd`` by rows), and the result is this rank's partial sum."""
    if tp is not None:
        lo, hi = tp.block(wd.shape[0])
        wg = None if wg is None else wg[:, lo:hi]
        wu, wd = wu[:, lo:hi], wd[lo:hi]
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
    probs, gate, idx = route(cfg, x, p["router"])
    xe, plan = expert_batch(cfg, x, idx)
    ye = expert_ffn(cfg, xe, p["wg"], p["wu"], p["wd"])
    out = combine(ye, gate, plan, x.dtype)
    return shared_experts(cfg, x, out, p), load_balance(cfg, probs, idx)


def expert_batch(cfg, x, idx):
    """The (G, E, C, D) expert batch of tokens x (G, Tg, D) routed to
    experts ``idx`` (G, Tg, k): slot (e, c) holds the sorted assignment
    at expert e's start + c, zeros past its count; and the plan that
    ``combine`` reads (C, the sort, each assignment's rank and whether
    it is kept)."""
    G, Tg, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    C, se, order, counts, starts, rank, keep = dispatch(cfg, idx)
    A = Tg * k
    c = torch.arange(C, device=x.device)
    src = (starts[..., None] + c).reshape(G, E * C)       # (G, E·C)
    filled = (c < counts[..., None]).reshape(G, E * C)
    tok = (order // k).gather(1, src.clamp_max(A - 1))
    xe = torch.where(filled[..., None],
                     x.gather(1, tok[..., None].expand(G, E * C, D)), 0)
    return xe.reshape(G, E, C, D), (C, k, se, order, rank, keep)


def expert_ffn(cfg, xe, wg, wu, wd):
    """Each expert's MLP on its slots: xe (G, E, C, D) against (E, D, F)
    ``wg``/``wu`` and (E, F, D) ``wd``."""
    h = torch.einsum("gecd,edf->gecf", xe, wg)
    if cfg.act == "swiglu":
        h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, wu)
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("gecf,efd->gecd", h, wd)


def combine(ye, gate, plan, dtype):
    """Back to token order: assignment (t, j) reads its slot's output of
    ye (G, E, C, D), dropped ones nothing, weighted by its gate; each
    token sums its k contributions in a fixed order."""
    C, k, se, order, rank, keep = plan
    G, E, _, D = ye.shape
    A = order.shape[1]
    ye = ye.reshape(G, E * C, D)
    pos = torch.arange(A, device=ye.device)
    inv = torch.empty_like(order).scatter_(1, order, pos.expand(G, A))
    slot = (se * C + torch.where(keep, rank, 0)).gather(1, inv)
    kept = keep.gather(1, inv)
    contrib = ye.gather(1, slot[..., None].expand(G, A, D))
    contrib = torch.where(kept[..., None], contrib, 0) \
        * gate.reshape(G, A, 1).to(dtype)
    return contrib.reshape(G, A // k, k, D).to(torch.float32).sum(2).to(dtype)


def shared_experts(cfg, x, out, p):
    """``out`` plus the shared experts' MLP on x where the config has
    them."""
    if not cfg.n_shared_experts:
        return out
    G, Tg, D = x.shape
    return out + mlp(cfg, x.reshape(G * Tg, D), p.get("wg_s"), p["wu_s"],
                     p["wd_s"]).reshape(G, Tg, D)


def load_balance(cfg, probs, idx):
    """The Switch-style load-balance term, E · Σ_e mean prob_e · share of
    first choices_e, the means over every token of the batch: where the
    ranks of a sharded step hold different rows (``dist.spmd``), both
    means are averaged over them (each rank's loss carries the term
    once, its gradient to this rank's rows)."""
    from ..dist.spmd import current_spmd, mean_over
    E = cfg.n_experts
    first = idx[..., 0, None] == torch.arange(E, device=idx.device)
    me = probs.mean(dim=(0, 1))
    ce = first.to(torch.float32).mean(dim=(0, 1))
    spmd = current_spmd()
    if spmd is not None and spmd.rows is not None and spmd.rows.n > 1:
        me = mean_over(me, spmd.rows.group, spmd.rows.n)
        ce = mean_over(ce, spmd.rows.group, spmd.rows.n)
    return E * (me * ce).sum()
