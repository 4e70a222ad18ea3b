"""The dense decoder: parameter shapes, initialisation, attention and the
layer body, from the reference's ``repro.models.model``.

The reference keeps its parameters in a nested dict whose ``layers`` are
stacked ``(L, ...)`` for ``lax.scan``; the port keeps them in an ``LM``
module under the same leaf names, ``layers`` unstacked: one
``nn.ParameterDict`` a layer, walked by a Python loop.  The functions
read parameters as the reference does (``p["wq"]``).  The parameters
take no gradient: the slice serves; training comes with its own slice.

On the card, ``decode_gqa_attention`` runs K5 over the layer's cache slab
in place, attending its first ``pos + 1`` rows.

Families outside the slice (``moe`` with MLA, ``ssm``, ``hybrid``,
``encdec``, ``vlm``) and sliding-window attention (hybrid's) raise
``NotImplementedError``; ``ROADMAP.md`` lists them in order.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..core.codegen import resolve_device
from ..kernels import ops
from .common import apply_norm, blockwise_attention, mlp, rope

#: the families this slice runs
FAMILIES = ("dense",)


def check_family(cfg):
    """Raise ``NotImplementedError`` for a family the port has no path
    for yet: the one gate of the model's entry points."""
    if cfg.family not in FAMILIES or cfg.kv_lora_rank:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            f"the port runs {', '.join(FAMILIES)} (ROADMAP.md lists the "
            f"rest in order)")
    if cfg.window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention (window {cfg.window}) "
            f"comes with the hybrid family (ROADMAP.md)")


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------

def _attn_shapes(cfg):
    D, dh, Hq, Hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    s = {"wq": (D, Hq * dh), "wk": (D, Hkv * dh), "wv": (D, Hkv * dh),
         "wo": (Hq * dh, D)}
    if cfg.qkv_bias:
        s |= {"bq": (Hq * dh,), "bk": (Hkv * dh,), "bv": (Hkv * dh,)}
    return s


def _mlp_shapes(cfg, ff):
    D = cfg.d_model
    if cfg.act == "swiglu":
        return {"wg": (D, ff), "wu": (D, ff), "wd": (ff, D)}
    return {"wu": (D, ff), "wd": (ff, D)}


def _norm_shapes(cfg, prefix):
    if cfg.norm == "layernorm":
        return {f"{prefix}_g": (cfg.d_model,), f"{prefix}_b": (cfg.d_model,)}
    return {f"{prefix}_g": (cfg.d_model,)}


def layer_shapes(cfg):
    """One dense layer's leaves."""
    return (_norm_shapes(cfg, "ln1") | _attn_shapes(cfg)
            | _norm_shapes(cfg, "ln2") | _mlp_shapes(cfg, cfg.d_ff))


def model_shapes(cfg) -> dict:
    """The reference's shape tree: ``embed``, ``unembed`` (unless tied),
    the final norm, and ``layers`` stacked ``(L, ...)``."""
    check_family(cfg)
    tree: dict[str, Any] = {"embed": (cfg.vocab, cfg.d_model)}
    if not cfg.tie_embeddings:
        tree["unembed"] = (cfg.d_model, cfg.vocab)
    tree |= _norm_shapes(cfg, "final")
    tree["layers"] = {k: (cfg.n_layers,) + v
                      for k, v in layer_shapes(cfg).items()}
    return tree


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------

def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class LM(nn.Module):
    """A decoder's parameters under the reference's leaf names:
    ``embed``, ``unembed`` (unless tied), ``final_g`` (and ``final_b``
    for layernorm), and ``layers``, one ``nn.ParameterDict`` a layer
    (``ln1_g``, ``wq``, ``wk``, ``wv``, ``wo``, ``bq``/``bk``/``bv``,
    ``ln2_g``, ``wg``, ``wu``, ``wd``).  ``model["embed"]`` reads a
    top-level leaf as the reference reads its tree."""

    def __init__(self, cfg, top: dict, layers: list):
        super().__init__()
        self.cfg = cfg
        for name, t in top.items():
            self.register_parameter(name, _frozen(t))
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: _frozen(t) for k, t in lp.items()})
            for lp in layers)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(cfg, generator: torch.Generator, device="cuda") -> LM:
    """Random parameters at the config's shapes in ``cfg.param_dtype`` on
    ``device``: ones for ``*_g``, zeros for biases (``*_b``, ``b*``),
    ``0.02 · N(0, 1)`` from ``generator`` (on ``device``) otherwise, as
    the reference's ``init_params``.  The numbers are not the
    reference's: its ``jax.random`` key draws others."""
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)

    def leaf(name, shape):
        if name.endswith("_g"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name.endswith("_b") or name.startswith("b"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev).mul_(0.02)

    shapes = model_shapes(cfg)
    stacked = shapes.pop("layers")
    top = {k: leaf(k, s) for k, s in shapes.items()}
    layers = [{k: leaf(k, s[1:]) for k, s in stacked.items()}
              for _ in range(cfg.n_layers)]
    return LM(cfg, top, layers)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def gqa_attention(cfg, x, p):
    """Causal (G)QA self-attention over the sequence from position 0
    (prefill); returns (out, (k, v)), k after rope, for the cache."""
    B, S, _ = x.shape
    dh, Hq, Hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, Hq, dh)
    k = _split_heads(k, Hkv, dh)
    v = _split_heads(v, Hkv, dh)
    positions = torch.arange(S, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v)
    return o.reshape(B, S, Hq * dh) @ p["wo"], (k, v)


def decode_gqa_attention(cfg, x, p, cache_k, cache_v, pos: int):
    """One token's attention against the layer's cache ``cache_k``,
    ``cache_v`` (B, S, Hkv, dh), which already holds this step's k and v
    at ``pos``: K5 over its first ``pos + 1`` rows, read in place (the
    reference masks the rows after ``pos``)."""
    B = x.shape[0]
    dh, Hq = cfg.dh, cfg.n_heads
    q = _split_heads(x @ p["wq"], Hq, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(1, 1, Hq, dh)
    q = rope(q, torch.full((B, 1), pos, device=x.device), cfg.rope_theta)
    o = ops.decode_attention(q.reshape(B, Hq, dh), cache_k, cache_v, pos + 1)
    return o.reshape(B, 1, Hq * dh).to(x.dtype) @ p["wo"]


def new_kv(cfg, x, p, pos: int):
    """This step's k (after rope) and v, (B, 1, Hkv, dh) each."""
    B = x.shape[0]
    dh, Hkv = cfg.dh, cfg.n_kv_heads
    k = _split_heads(x @ p["wk"], Hkv, dh)
    v = _split_heads(x @ p["wv"], Hkv, dh)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, Hkv, dh)
        v = v + p["bv"].reshape(1, 1, Hkv, dh)
    k = rope(k, torch.full((B, 1), pos, device=x.device), cfg.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# the layer body
# ---------------------------------------------------------------------------

def _moe_or_mlp(cfg, x, p):
    """The layer's feed-forward: the MLP (the MoE layer comes with its
    family); returns (out, aux)."""
    return mlp(cfg, x, p.get("wg"), p["wu"], p["wd"]), 0.0


def decoder_layer(cfg, x, lp):
    """One dense layer over the sequence (prefill); returns (x', (k, v),
    aux)."""
    h = apply_norm(cfg, x, lp, "ln1")
    o, cache = gqa_attention(cfg, h, lp)
    x = x + o
    h2 = apply_norm(cfg, x, lp, "ln2")
    m, aux = _moe_or_mlp(cfg, h2, lp)
    return x + m, cache, aux
