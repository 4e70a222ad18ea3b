"""Serving steps, from the reference's ``repro.train.steps``:
``make_prefill_step`` and ``make_decode_step`` with greedy ``argmax``.
The train step waits for the training slice (``ROADMAP.md``)."""
from __future__ import annotations

import torch

from ..models import forward


def make_prefill_step(cfg):
    """serve prefill: (model, batch) -> (last logits, cache); the batch's
    ``patches`` (a VLM) and ``frames`` (an encoder-decoder) where it has
    them."""

    def prefill_step(model, batch):
        return forward.prefill(cfg, model, batch["tokens"],
                               patches=batch.get("patches"),
                               frames=batch.get("frames"))

    return prefill_step


def make_decode_step(cfg):
    """serve decode: (model, cache, tokens, pos) -> (next ids, logits,
    cache).  One new token against the KV cache, the greedy choice
    (``argmax``, the first of equal maxima, as ``jnp.argmax``)."""

    def decode_step(model, cache, tokens, pos):
        logits, cache = forward.decode_step(cfg, model, cache, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return decode_step
