"""The dense decoder end to end: the full-sequence forward, prefill
and one decode step, from the reference's ``repro.models.forward``.

The reference casts the parameters to ``cfg.compute_dtype`` inside every
call (``_cast``); the port casts them once, when a model is loaded for
serving (``cast_params``), and these functions refuse a model that was not
cast: the same values, without a cast of every weight at every step.
The layers run as a Python loop where the reference scans them; the KV
cache is a dict of ``k`` and ``v``, each (L, B, S, Hkv, dh), updated in
place by ``decode_step`` (the reference returns a new one).
"""
from __future__ import annotations

import operator

import torch

from ..core.codegen import resolve_device
from .common import apply_norm
from .model import (_moe_or_mlp, check_family, decode_gqa_attention,
                    decoder_layer, new_kv)


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
    """Embedding and every layer: (x before the final norm, aux, the
    layers' (k, v) where ``collect_cache``)."""
    x = embed_tokens(cfg, model, tokens)
    caches, aux = [], 0.0
    for lp in model.layers:
        x, cache, a = decoder_layer(cfg, x, lp)
        aux = aux + a
        if collect_cache:
            caches.append(cache)
    return x, aux, caches


@torch.no_grad()
def forward_lm(cfg, model, tokens, *, collect_cache=False):
    """Full-sequence forward of a cast model; tokens (B, S).  Returns
    (logits (B, S, V), aux, caches: a (k, v) a layer where
    ``collect_cache``)."""
    _check_cast(cfg, model)
    x, aux, caches = _layers(cfg, model, tokens, collect_cache)
    x = apply_norm(cfg, x, model, "final")
    return unembed(cfg, model, x), aux, caches


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def zero_cache(cfg, batch: int, seq: int, device="cuda") -> dict:
    """The decode cache at KV length ``seq``: ``k`` and ``v``, each
    (L, batch, seq, Hkv, dh) zeros in ``cfg.compute_dtype``."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.dh)
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=_compute_dtype(cfg), device=dev)
            for name in ("k", "v")}


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(cfg, model, cache, tokens, pos: int):
    """One token for every sequence of the batch: tokens (B,) at position
    ``pos`` (a host integer), against ``cache`` holding positions
    ``[0, pos)``.  Writes this step's k and v into ``cache[...][l, :,
    pos]`` before the layer's attention reads them, and returns (logits
    (B, V), cache)."""
    _check_cast(cfg, model)
    pos = operator.index(pos)
    x = embed_tokens(cfg, model, tokens[:, None])           # (B, 1, D)
    for l, lp in enumerate(model.layers):
        h = apply_norm(cfg, x, lp, "ln1")
        k, v = new_kv(cfg, h, lp, pos)
        cache["k"][l, :, pos] = k[:, 0]
        cache["v"][l, :, pos] = v[:, 0]
        x = x + decode_gqa_attention(cfg, h, lp, cache["k"][l],
                                     cache["v"][l], pos)
        h2 = apply_norm(cfg, x, lp, "ln2")
        m, _ = _moe_or_mlp(cfg, h2, lp)
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
    same rows as the reference's, without its (B, S, V) logits."""
    _check_cast(cfg, model)
    x, _, caches = _layers(cfg, model, tokens, collect_cache=True)
    x = apply_norm(cfg, x[:, -1:].contiguous(), model, "final")
    cache = {"k": torch.stack([k for k, _ in caches]),
             "v": torch.stack([v for _, v in caches])}
    return unembed(cfg, model, x)[:, 0], cache
