"""The train step and the serving steps, from the reference's
``repro.train.steps``: ``make_train_step`` (with ``init_train_state``,
the state it takes), ``make_prefill_step`` and ``make_decode_step`` with
greedy ``argmax``, and ``DecodeReplay``, the decode step captured once
as a CUDA graph and replayed at every position, as the reference jits it
once with the position traced."""
from __future__ import annotations

import torch

from ..kernels._launch import LAUNCHES
from ..models import forward
from ..optim import apply_adamw, init_opt_state


def init_train_state(cfg, model) -> dict:
    """The reference's train state from ``model`` (an ``LM`` holding the
    parameters in ``cfg.param_dtype``, float32): ``params``, the float32
    masters (the model's own tensors, by name); ``params_c``, a copy in
    ``cfg.compute_dtype`` that takes gradients (what the forward runs
    on); ``opt``, zero moments and step 0 (``optim.init_opt_state``)."""
    params = model.leaves()
    cd = getattr(torch, cfg.compute_dtype)
    params_c = model.map(lambda t: t.to(cd, copy=True), requires_grad=True)
    return {"params": params, "params_c": params_c,
            "opt": init_opt_state(cfg, params)}


def make_train_step(cfg, hyper, accum: int = 1):
    """train_step(state, batch) -> (state, metrics), the reference's: the
    loss (``forward.lm_loss``) differentiated with respect to the
    compute copy ``params_c``; AdamW (``optim.apply_adamw``) on the
    float32 masters with the gradients upcast to float32; the copy
    refreshed from the new masters.  ``accum`` > 1 splits the batch into
    ``accum`` microbatches and sums their float32 gradients (then / accum),
    as the reference's scan; ``metrics`` (device tensors) are the last
    microbatch's ``xent`` and ``aux``, with ``loss`` (the mean over the
    microbatches), ``lr`` and ``grad_norm``.  The state's dicts are
    updated in place and returned."""

    def grads_of(model, batch):
        names, leaves = zip(*model.named_parameters())
        loss, metrics = forward.lm_loss(cfg, model, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, g, p in zip(names, grads, leaves)}
        return loss.detach(), metrics, grads

    def train_step(state, batch):
        model = state["params_c"]
        if accum == 1:
            loss, metrics, grads = grads_of(model, batch)
        else:
            loss, grads = 0.0, None
            for i in range(accum):
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                l, metrics, g = grads_of(model, micro)
                loss = loss + l
                if grads is None:
                    grads = {n: t.to(torch.float32, copy=True)
                             for n, t in g.items()}
                else:
                    for n, t in g.items():
                        grads[n].add_(t)
                del g
            for t in grads.values():
                t.div_(accum)
            loss = loss / accum
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        params, opt, opt_metrics = apply_adamw(cfg, hyper, state["params"],
                                               grads, state["opt"])
        del grads
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(params[n])
        state = {"params": params, "params_c": model, "opt": opt}
        return state, metrics | opt_metrics | {"loss": loss}

    return train_step


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
    (``argmax``, the first of equal maxima, as ``jnp.argmax``); ``pos``
    a host integer or a 0-d int32 device tensor."""

    def decode_step(model, cache, tokens, pos):
        logits, cache = forward.decode_step(cfg, model, cache, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return decode_step


class DecodeReplay:
    """Greedy decode steps of ``cfg`` on ``model`` against ``cache``
    (updated in place, as the reference donates it), from ``tokens``
    (B,) at position ``pos``.

    The tokens and the position live in static device buffers, and each
    step advances them on the device (the step's greedy tokens copied
    in, the position incremented), so no step waits for the host.  Each
    call runs one step and returns its tokens (a fresh (B,) int32
    tensor).  ``capture()`` records the step once as a CUDA graph;
    every later call replays it and adds its kernels to ``LAUNCHES``.
    Call it after one eager step, which builds and loads the kernels
    (the capture runs nothing).  Without a capture every call runs the
    step eagerly on the same buffers: the same kernels in the same
    order.  A failed capture raises."""

    def __init__(self, cfg, model, cache, tokens, pos: int):
        self.model, self.cache = model, cache
        self.tokens = tokens.to(device=model.device, dtype=torch.int32,
                                copy=True)
        self.pos = torch.full((), pos, dtype=torch.int32, device=model.device)
        self.logits = None
        self.launches: list[str] = []
        self.captures = 0
        self._step = make_decode_step(cfg)
        self._graph = None

    def _advance(self):
        ids, self.logits, _ = self._step(self.model, self.cache, self.tokens,
                                         self.pos)
        self.tokens.copy_(ids)
        self.pos.add_(1)

    def __call__(self) -> torch.Tensor:
        if self._graph is None:
            self._advance()
        else:
            self._graph.replay()
            for name in self.launches:
                LAUNCHES.add(name)
        return self.tokens.clone()

    def capture(self):
        """Capture the step (the model on a CUDA device) as one graph."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.model.device), \
                LAUNCHES.capturing() as launches, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._advance()
        self._graph, self.launches = graph, launches
        self.captures += 1
