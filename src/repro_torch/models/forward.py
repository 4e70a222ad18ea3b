"""Every family end to end: the full-sequence forward, the training loss
(``lm_loss``), prefill and one decode step, from the reference's
``repro.models.forward``.

The reference casts the parameters to ``cfg.compute_dtype`` inside every
call (``_cast``); the port casts them once, when a model is loaded for
serving (``cast_params``), and these functions refuse a model that was not
cast: the same values, without a cast of every weight at every step.
The layers run as a Python loop where the reference scans them, an MoE
model's dense head layers first.  The cache is a dict of tensors whose
index l runs over the head layers and then the main stack, updated in
place by ``decode_step`` (the reference returns a new one):

* ``k``, ``v`` (L, B, S, Hkv, dh): the dense, vlm and GQA MoE families,
  and a Whisper decoder's self-attention;
* ``ckv`` (L, B, S, r), ``kr`` (L, B, S, rd): MLA;
* ``state`` (L, B, H, P, N), float32 whatever the compute dtype: the SSD
  mixer's (ssm, hybrid);
* a hybrid's ``k``, ``v`` (L, B, W, Hkv, dh): a ring of W = ``window``
  slots, position i in slot i mod W;
* ``xk``, ``xv`` (L, B, F, Hkv, dh): a Whisper decoder's cross-attention
  keys and values over the F encoder frames, written by the prefill.
"""
from __future__ import annotations

import operator

import torch
import torch.utils.checkpoint

from ..core.codegen import resolve_device
from ..kernels import grad
from . import ssm as ssm_lib
from .common import apply_norm, mlp, tensor_parallel
from .model import (_moe_or_mlp, check_family, decode_gqa_attention,
                    decoder_layer, gqa_attention, hybrid_mix,
                    mla_decode_attention, new_kv, new_latent, ssm_params)

#: the cache leaves kept in float32 whatever the compute dtype
FLOAT32_LEAVES = ("state",)


def _compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


@torch.no_grad()
def cast_params(cfg, model):
    """Cast every floating parameter of ``model`` to ``cfg.compute_dtype``
    in place, one leaf at a time (so the peak is the model plus its
    largest leaf), and return it: the reference's per-call ``_cast``,
    done once."""
    cd = _compute_dtype(cfg)
    for p in model.parameters():
        if p.is_floating_point() and p.dtype != cd:
            p.data = p.data.to(cd)
    return model


def _check_cast(cfg, model):
    check_family(cfg)
    if model["embed"].dtype != _compute_dtype(cfg):
        raise ValueError(
            f"{cfg.name}: the parameters are {model['embed'].dtype}, the "
            f"compute dtype is {cfg.compute_dtype}: cast_params first")


def embed_tokens(cfg, model, tokens):
    return model["embed"][tokens.long()]


def unembed(cfg, model, x, tp=None):
    """The logits of x; ``tp`` (a ``TensorParallel``): this rank's block
    of the vocabulary's columns (``TensorParallel.block``, the last
    block shorter where the ranks do not divide the vocabulary)."""
    w = model["embed"].T if cfg.tie_embeddings else model["unembed"]
    if tp is not None:
        lo, hi = tp.block(w.shape[1])
        w = w[:, lo:hi]
    return x @ w


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------

def whisper_encode(cfg, model, frames):
    """frames (B, F, D): the precomputed embeddings of the audio frontend
    (a stub in the reference too).  Adds ``enc_pos``, runs the
    bidirectional encoder (no rope) and its final norm."""
    x = frames.to(_compute_dtype(cfg))
    x = x + model["enc_pos"][None, :x.shape[1]]

    def layer(lp, x):
        a = apply_norm(cfg, x, lp, "ln1")
        x = x + gqa_attention(cfg, a, lp, causal=False, use_rope=False)[0]
        m = apply_norm(cfg, x, lp, "ln2")
        return x + mlp(cfg, m, lp.get("wg"), lp["wu"], lp["wd"])

    for lp in model.enc_layers:
        x = lp(layer, x)
    return apply_norm(cfg, x, model, "encf")


def whisper_decoder_layer(cfg, x, lp, enc_out):
    """One Whisper decoder layer over the sequence: causal self-attention
    with rope, cross-attention to ``enc_out`` (no rope, no mask), the
    MLP; returns (x', (k, v, xk, xv), 0.0)."""
    h = apply_norm(cfg, x, lp, "ln1")
    o, (k, v) = gqa_attention(cfg, h, lp)
    x = x + o
    hx = apply_norm(cfg, x, lp, "lnx")
    xo, (xk, xv) = gqa_attention(cfg, hx, lp, kv_x=enc_out, causal=False,
                                 use_rope=False, prefix="x_")
    x = x + xo
    h2 = apply_norm(cfg, x, lp, "ln2")
    return x + mlp(cfg, h2, lp.get("wg"), lp["wu"], lp["wd"]), \
        (k, v, xk, xv), 0.0


def _embed(cfg, model, tokens, patches):
    """The token embeddings, a VLM's ``patches`` (B, n, D) in place of
    the first n positions."""
    x = embed_tokens(cfg, model, tokens)
    if cfg.family == "vlm" and patches is not None:
        n = patches.shape[1]
        if n > x.shape[1]:
            raise ValueError(
                f"{cfg.name}: {n} patches do not fit a prompt of "
                f"{x.shape[1]} tokens (the reference's sequence would grow "
                f"to {n}; ROADMAP.md §3)")
        x = torch.cat([patches.to(x.dtype), x[:, n:]], dim=1)
    return x


def _layers(cfg, model, tokens, patches=None, frames=None, collect=None,
            remat: bool = False):
    """Embedding (a VLM's patches in place, Whisper's encoder run first)
    and every layer, head layers first: (x before the final norm, the
    summed aux); ``collect(l, pieces)`` receives each layer's cache
    pieces where given.  ``remat``: each decoder layer under activation
    checkpointing (its activations recomputed in the backward), as the
    reference's ``cfg.remat`` wraps its scanned layer in
    ``jax.checkpoint``.  Each layer runs through its module's call
    (``model.Layer``), where a sharded step's FSDP hooks gather it.

    On a sharded step's ``TensorParallel`` the residual stream is this
    rank's block of the sequence, taken at the embedding (the
    reference's constraint after it): x is (B, S/n, D) from there
    through every layer (``model.decoder_layer``); under ``remat`` each
    rank recomputes a layer's collectives in the same order."""
    tp = tensor_parallel()
    if tp is not None:
        S = tokens.shape[1]
        if S % tp.n:
            raise NotImplementedError(
                f"{cfg.name}: a sequence of {S} does not split over "
                f"{tp.n} tensor-parallel ranks")
        lo, hi = tp.block(S)
        tokens = tokens[:, lo:hi]
    x = _embed(cfg, model, tokens, patches)
    enc_out = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs frames")
        enc_out = whisper_encode(cfg, model, frames)
    aux = 0.0
    for l, (lp, kind) in enumerate(model.stacks()):
        def layer(lp, x, kind=kind):
            if enc_out is not None:
                return whisper_decoder_layer(cfg, x, lp, enc_out)
            return decoder_layer(cfg, x, lp, kind)

        def remat_layer(lp, x, layer=layer):
            # the layer bound now: the backward recomputes it later
            return torch.utils.checkpoint.checkpoint(
                lambda x: layer(lp, x)[0::2], x, use_reentrant=False)
        if remat:
            x, a = lp(remat_layer, x)
        else:
            x, pieces, a = lp(layer, x)
            if collect is not None:
                collect(l, pieces)
        aux = aux + a
    return x, aux


@torch.no_grad()
def forward_lm(cfg, model, tokens, *, patches=None, frames=None,
               collect_cache=False):
    """Full-sequence forward of a cast model; tokens (B, S), a VLM's
    ``patches`` (B, n ≤ S, D), Whisper's encoder ``frames`` (B, F, D).
    Returns (logits (B, S, V), aux (the MoE layers' load-balance terms
    summed, 0.0 for the other families), caches: each layer's cache
    pieces where ``collect_cache``)."""
    _check_cast(cfg, model)
    caches = []
    x, aux = _layers(cfg, model, tokens, patches, frames,
                     (lambda l, c: caches.append(c)) if collect_cache
                     else None)
    x = apply_norm(cfg, x, model, "final")
    return unembed(cfg, model, x), aux, caches


def lm_loss(cfg, model, batch, count=None):
    """Mean next-token cross-entropy of a cast ``model`` on ``batch``
    (``tokens``, ``labels`` (B, S), and ``patches``/``frames`` where the
    family takes them), with gradients where the model's leaves take
    them: returns (loss, {"xent", "aux"}), the reference's ``lm_loss``.
    ``count``: the divisor of the masked sum in place of this batch's
    count of labels (a sharded step's rows, over the whole batch's).

    The per-row ``logsumexp(x_t) - x_t[label_t]`` comes from K7
    (``kernels.grad.softmax_xent_rows``: the kernel forward, a plain
    float32 backward) over the (B·S, V) logits, where the reference
    builds it from ``logsumexp`` and ``take_along_axis``; then the
    reference's mask ``labels >= 0`` (a label of -1 reads no column and
    is masked out), its mean over the mask and ``+ 0.01 · aux``.  The
    layers run under activation checkpointing where ``cfg.remat`` and
    autograd is on.

    On a sharded step's ``TensorParallel``, the final norm runs on this
    rank's block of the sequence, the normed stream is gathered, and
    the logits are this rank's block of the vocabulary (``unembed``):
    the rows come from K7's block entry, the ranks' triples combined
    (``kernels.grad.softmax_xent_block_rows``); every rank returns the
    same loss."""
    _check_cast(cfg, model)
    remat = cfg.remat and torch.is_grad_enabled()
    x, aux = _layers(cfg, model, batch["tokens"], batch.get("patches"),
                     batch.get("frames"), remat=remat)
    x = apply_norm(cfg, x, model, "final")
    labels = batch["labels"].reshape(-1)
    tp = tensor_parallel()
    if tp is None:
        logits = unembed(cfg, model, x)
        rows = grad.softmax_xent_rows(logits.reshape(-1, logits.shape[-1]),
                                      labels)
    else:
        from ..dist.spmd import gather_seq
        logits = unembed(cfg, model, gather_seq(x, tp), tp)
        rows = grad.softmax_xent_block_rows(
            logits.reshape(-1, logits.shape[-1]), labels,
            tp.block(cfg.vocab)[0], tp.group)
    mask = (labels >= 0).to(torch.float32)
    if count is None:
        count = torch.clamp(torch.sum(mask), min=1.0)
    xent = torch.sum(rows * mask) / count
    return xent + 0.01 * aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_pspec_rules(cfg):
    """Logical sharding for each cache leaf (dp over batch; heads on tp
    when divisible; sequence dim sharded on tp for batch-1 long ctx), the
    reference's rules as written: its first ``k``/``v``/``xk``/``xv``
    rule is overwritten by the next."""
    rules = {}
    fam = cfg.family
    head_tp = "tp" if cfg.n_kv_heads % 8 == 0 else None
    for name in ("k", "v", "xk", "xv"):
        rules[name] = (None, "dp", "tp" if fam == "ssm" else None, head_tp,
                       None)
        rules[name] = (None, "dp", None, head_tp, None)
    rules["ckv"] = (None, "dp", None, None)
    rules["kr"] = (None, "dp", None, None)
    rules["state"] = (None, "dp", "tp", None, None)
    return rules


def cache_shapes(cfg, batch: int, seq: int) -> dict:
    """The decode cache's leaves at KV length ``seq``, as the reference's
    ``abstract_cache`` (the module's docstring lists them)."""
    check_family(cfg)
    L, fam = cfg.n_layers, cfg.family
    kv = (L, batch, seq, cfg.n_kv_heads, cfg.dh)
    state = (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    if cfg.kv_lora_rank:
        return {"ckv": (L, batch, seq, cfg.kv_lora_rank),
                "kr": (L, batch, seq, cfg.qk_rope_dim)}
    if fam == "ssm":
        return {"state": state}
    if fam == "hybrid":
        ring = (L, batch, cfg.window, cfg.n_kv_heads, cfg.dh)
        return {"k": ring, "v": ring, "state": state}
    if fam == "encdec":
        x = (L, batch, cfg.encoder_frames, cfg.n_kv_heads, cfg.dh)
        return {"k": kv, "v": kv, "xk": x, "xv": x}
    return {"k": kv, "v": kv}


def cache_dtype(cfg, name: str) -> torch.dtype:
    """A cache leaf's dtype: float32 for ``FLOAT32_LEAVES``, the compute
    dtype otherwise."""
    return torch.float32 if name in FLOAT32_LEAVES else _compute_dtype(cfg)


def zero_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """The decode cache at KV length ``seq`` (``cache_shapes``), zeros in
    each leaf's ``cache_dtype``."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=cache_dtype(cfg, name),
                              device=dev)
            for name, shape in cache_shapes(cfg, batch, seq).items()}


def ring_slots(pos, window: int):
    """The rows of a hybrid's ring that hold keys at ``pos``: the first
    ``min(pos + 1, W)`` (device arithmetic where ``pos`` is a tensor).

    The reference attends the W slots masked by each slot's position
    ``pos - ((pos - slot) mod W)``, kept where it is >= 0.  Before the
    ring wraps (pos < W) slot i holds position i, so the kept slots are
    0..pos; after it (pos >= W) every slot holds one of the last W
    positions.  Each key was roped at its own position when it was
    written, and a softmax does not depend on the order of its keys, so
    K5 over those rows in slot order is the reference's attention."""
    if isinstance(pos, torch.Tensor):
        return torch.clamp(pos + 1, max=window)
    return min(pos + 1, window)


def write_row(leaf, pos, row):
    """Write ``row`` (B, 1, ...) into row ``pos`` of ``leaf`` (B, S, ...)
    in place: an indexed copy where ``pos`` is a device tensor (a captured
    step writes wherever the position then is), plain indexing for a
    host integer."""
    if isinstance(pos, torch.Tensor):
        leaf.index_copy_(1, pos.reshape(1).long(), row.to(leaf.dtype))
    else:
        leaf[:, pos] = row[:, 0]


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_layer(cfg, x, lp, kind: str, cache, l: int, pos):
    """One layer of ``decode_step`` on x (B, 1, D) at position ``pos`` (a
    host integer or a 0-d int32 device tensor): writes the layer's k and
    v (MLA: its latent and roped rope key; a hybrid: into ring slot
    ``pos mod W``) into ``cache[...][l]`` before its attention reads
    them, advances its SSD state in place, and returns x'."""
    h = apply_norm(cfg, x, lp, "ln1")
    if kind == "ssm":
        o, _ = ssm_lib.ssm_mixer(cfg, h, ssm_params(lp),
                                 state=cache["state"][l])
    elif kind == "hybrid":
        k, v = new_kv(cfg, h, lp, pos)
        slot = pos % cfg.window
        write_row(cache["k"][l], slot, k)
        write_row(cache["v"][l], slot, v)
        ao = decode_gqa_attention(cfg, h, lp, cache["k"][l], cache["v"][l],
                                  pos, kv_len=ring_slots(pos, cfg.window))
        so, _ = ssm_lib.ssm_mixer(cfg, h, ssm_params(lp),
                                  state=cache["state"][l])
        o = hybrid_mix(ao, so, lp)
    elif cfg.kv_lora_rank:
        ckv, kr = new_latent(cfg, h, lp, pos)
        write_row(cache["ckv"][l], pos, ckv)
        write_row(cache["kr"][l], pos, kr)
        o = mla_decode_attention(cfg, h, lp, cache["ckv"][l],
                                 cache["kr"][l], pos)
    else:
        k, v = new_kv(cfg, h, lp, pos)
        write_row(cache["k"][l], pos, k)
        write_row(cache["v"][l], pos, v)
        o = decode_gqa_attention(cfg, h, lp, cache["k"][l], cache["v"][l],
                                 pos)
    x = x + o
    if cfg.family == "encdec":
        hx = apply_norm(cfg, x, lp, "lnx")
        x = x + decode_gqa_attention(
            cfg, hx, lp, cache["xk"][l], cache["xv"][l], pos,
            kv_len=cfg.encoder_frames, use_rope=False, prefix="x_")
    if kind != "ssm":
        h2 = apply_norm(cfg, x, lp, "ln2")
        x = x + _moe_or_mlp(cfg, h2, lp, kind == "moe")[0]
    return x


@torch.no_grad()
def decode_step(cfg, model, cache, tokens, pos):
    """One token for every sequence of the batch: tokens (B,) at position
    ``pos``, against ``cache`` holding positions ``[0, pos)``: every
    layer's ``decode_layer``, the cache updated in place; returns (logits
    (B, V), cache).  ``pos`` is a host integer, or a 0-d int32 tensor on
    the model's device, as the reference traces it: no shape and no
    host value then depends on it, so the step can be captured as one
    CUDA graph and replayed at every position."""
    _check_cast(cfg, model)
    if isinstance(pos, torch.Tensor):
        if pos.shape != () or pos.dtype != torch.int32 \
                or pos.device != model.device:
            raise ValueError(f"decode_step: pos must be a 0-d int32 tensor "
                             f"on {model.device}, got {tuple(pos.shape)} "
                             f"{pos.dtype} on {pos.device}")
    else:
        pos = operator.index(pos)
    x = embed_tokens(cfg, model, tokens[:, None])           # (B, 1, D)
    for l, (lp, kind) in enumerate(model.stacks()):
        x = decode_layer(cfg, x, lp, kind, cache, l, pos)
    x = apply_norm(cfg, x, model, "final")
    return unembed(cfg, model, x)[:, 0], cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _cache_names(cfg) -> tuple:
    """The names of a layer's cache pieces, in the order the layer
    returns them."""
    if cfg.kv_lora_rank:
        return ("ckv", "kr")
    return {"ssm": ("state",), "hybrid": ("k", "v", "state"),
            "encdec": ("k", "v", "xk", "xv")}.get(cfg.family, ("k", "v"))


def write_layer(cfg, cache, l: int, pieces, S: int):
    """Write layer l's prefill pieces over S positions (``_cache_names``
    order) into ``cache[...][l]``: K/V rows (and MLA's) into the first S
    rows of a cache of S or more; a hybrid's ring holds the last ``min(S,
    W)`` positions, position i in slot i mod W (the reference's roll;
    zeros past S while S < W); the SSD state and Whisper's cross K/V
    whole."""
    W = cfg.window if cfg.family == "hybrid" else 0
    for name, t in zip(_cache_names(cfg), pieces):
        if W and name in ("k", "v"):
            ring = cache[name][l]
            if S >= W:
                t = torch.roll(t[:, S - W:], (S - W) % W, dims=1)
            else:
                ring[:, S:] = 0
            ring[:, :t.shape[1]] = t
        elif name in ("k", "v", "ckv", "kr"):
            cache[name][l, :, :S] = t
        else:
            cache[name][l] = t


@torch.no_grad()
def prefill(cfg, model, tokens, *, patches=None, frames=None):
    """Full-sequence forward that also builds the decode cache: returns
    (the last position's logits (B, V), the cache at KV length S).  Each
    layer's pieces are written into the cache (``write_layer``) as the
    layer returns them.  The final norm and the unembedding run on the
    last position alone: the same rows as the reference's, without its
    (B, S, V) logits.  An MLA cache holds ``kr`` before rope, as the
    reference's prefill returns it (``model.mla_attention``)."""
    _check_cast(cfg, model)
    B, S = tokens.shape
    cache = {name: torch.empty(shape, dtype=cache_dtype(cfg, name),
                               device=model.device)
             for name, shape in cache_shapes(cfg, B, S).items()}
    x, _ = _layers(cfg, model, tokens, patches, frames,
                   lambda l, pieces: write_layer(cfg, cache, l, pieces, S))
    x = apply_norm(cfg, x[:, -1:].contiguous(), model, "final")
    return unembed(cfg, model, x)[:, 0], cache
