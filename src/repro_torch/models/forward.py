"""The dense and MoE decoders end to end: the full-sequence forward,
prefill and one decode step, from the reference's
``repro.models.forward``.

The reference casts the parameters to ``cfg.compute_dtype`` inside every
call (``_cast``); the port casts them once, when a model is loaded for
serving (``cast_params``), and these functions refuse a model that was not
cast: the same values, without a cast of every weight at every step.
The layers run as a Python loop where the reference scans them, an MoE
model's dense head layers first; the cache is a dict of ``k`` and ``v``,
each (L, B, S, Hkv, dh), or for MLA of ``ckv`` (L, B, S, r) and ``kr``
(L, B, S, rd), its index l running over the head layers and then the
main stack, updated in place by ``decode_step`` (the reference returns a
new one).
"""
from __future__ import annotations

import operator

import torch

from ..core.codegen import resolve_device
from .common import apply_norm
from .model import (_moe_or_mlp, check_family, decode_gqa_attention,
                    decoder_layer, mla_decode_attention, new_kv, new_latent)


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


def unembed(cfg, model, x):
    w = model["embed"].T if cfg.tie_embeddings else model["unembed"]
    return x @ w


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------

def _layers(cfg, model, tokens, collect_cache=False):
    """Embedding and every layer, head layers first: (x before the final
    norm, the summed aux, each layer's cache pieces where
    ``collect_cache``)."""
    x = embed_tokens(cfg, model, tokens)
    caches, aux = [], 0.0
    for lp, kind in model.stacks():
        x, cache, a = decoder_layer(cfg, x, lp, kind)
        aux = aux + a
        if collect_cache:
            caches.append(cache)
    return x, aux, caches


@torch.no_grad()
def forward_lm(cfg, model, tokens, *, collect_cache=False):
    """Full-sequence forward of a cast model; tokens (B, S).  Returns
    (logits (B, S, V), aux (the MoE layers' load-balance terms summed,
    0.0 for a dense model), caches: a layer's (k, v) or MLA's (c_kv,
    k_rope) where ``collect_cache``)."""
    _check_cast(cfg, model)
    x, aux, caches = _layers(cfg, model, tokens, collect_cache)
    x = apply_norm(cfg, x, model, "final")
    return unembed(cfg, model, x), aux, caches


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_shapes(cfg, batch: int, seq: int) -> dict:
    """The decode cache's leaves at KV length ``seq``, as the reference's
    ``abstract_cache``: ``k`` and ``v`` (L, batch, seq, Hkv, dh), or for
    MLA ``ckv`` (L, batch, seq, r) and ``kr`` (L, batch, seq, rd)."""
    check_family(cfg)
    L = cfg.n_layers
    if cfg.kv_lora_rank:
        return {"ckv": (L, batch, seq, cfg.kv_lora_rank),
                "kr": (L, batch, seq, cfg.qk_rope_dim)}
    shape = (L, batch, seq, cfg.n_kv_heads, cfg.dh)
    return {"k": shape, "v": shape}


def zero_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """The decode cache at KV length ``seq`` (``cache_shapes``), zeros in
    ``cfg.compute_dtype``."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=_compute_dtype(cfg), device=dev)
            for name, shape in cache_shapes(cfg, batch, seq).items()}


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(cfg, model, cache, tokens, pos: int):
    """One token for every sequence of the batch: tokens (B,) at position
    ``pos`` (a host integer), against ``cache`` holding positions
    ``[0, pos)``.  Writes this step's k and v (MLA: its latent and roped
    rope key) into ``cache[...][l, :, pos]`` before the layer's attention
    reads them, and returns (logits (B, V), cache)."""
    _check_cast(cfg, model)
    pos = operator.index(pos)
    x = embed_tokens(cfg, model, tokens[:, None])           # (B, 1, D)
    for l, (lp, kind) in enumerate(model.stacks()):
        h = apply_norm(cfg, x, lp, "ln1")
        if cfg.kv_lora_rank:
            ckv, kr = new_latent(cfg, h, lp, pos)
            cache["ckv"][l, :, pos] = ckv[:, 0]
            cache["kr"][l, :, pos] = kr[:, 0]
            o = mla_decode_attention(cfg, h, lp, cache["ckv"][l],
                                     cache["kr"][l], pos)
        else:
            k, v = new_kv(cfg, h, lp, pos)
            cache["k"][l, :, pos] = k[:, 0]
            cache["v"][l, :, pos] = v[:, 0]
            o = decode_gqa_attention(cfg, h, lp, cache["k"][l],
                                     cache["v"][l], pos)
        x = x + o
        h2 = apply_norm(cfg, x, lp, "ln2")
        m, _ = _moe_or_mlp(cfg, h2, lp, kind == "moe")
        x = x + m
    x = apply_norm(cfg, x, model, "final")
    return unembed(cfg, model, x)[:, 0], cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(cfg, model, tokens):
    """Full-sequence forward that also builds the decode cache: returns
    (the last position's logits (B, V), cache of KV length S).  The
    final norm and the unembedding run on the last position alone: the
    same rows as the reference's, without its (B, S, V) logits.  An MLA
    cache holds ``kr`` before rope, as the reference's prefill returns
    it (``model.mla_attention``)."""
    _check_cast(cfg, model)
    x, _, caches = _layers(cfg, model, tokens, collect_cache=True)
    x = apply_norm(cfg, x[:, -1:].contiguous(), model, "final")
    names = ("ckv", "kr") if cfg.kv_lora_rank else ("k", "v")
    cache = {name: torch.stack([c[i] for c in caches])
             for i, name in enumerate(names)}
    return unembed(cfg, model, x)[:, 0], cache
