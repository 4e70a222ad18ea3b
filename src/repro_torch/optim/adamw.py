"""AdamW with optional 8-bit block-quantized moments, from the reference's
``repro.optim.adamw``, with its names and numbers.

The reference's update is a jnp map chain that XLA fuses into its one
jitted train step.  Here each float32-moment leaf is one launch of K6
(``kernels.adamw``: the same AdamW map, one pass over p, g, m, v) on the
card, and its plain version (``kernels.ref.adamw``) on the CPU.  K6 takes
no clip factor, so the gradient is scaled by it first, as the reference
multiplies ``g · clip`` outside its map.  The learning rate, the clip
factor and the bias corrections ``c1``, ``c2`` stay device tensors: the
update never waits for the host.

8-bit moments (``opt_moment_dtype='int8'``): each moment is stored as
int8 with one float32 scale per 128-element block of its trailing dim
(absmax), ``v`` in the sqrt domain.  An int8 leaf is dequantized, runs
K6 and is quantized again; the (de)quantization is plain PyTorch, as the
reference's is jnp.

Parameters, gradients and moments are dicts keyed by the model's
parameter names (``LM.named_parameters``); ``apply_adamw`` replaces their
entries leaf by leaf, so the old leaf is freed as its new one is written.

Sharded (``apply_adamw(..., shardings=)``, a sharded train step's
``dist.spmd.StateShardings``): each leaf is this rank's piece, and K6
runs once a piece.  The gradient norm sums every rank's squares over
the process group, a piece that several ranks hold counted once.  A
float32 moment lies as its parameter does.  An int8 moment's ``q`` and
``scale`` lie by their own shapes (the reference's ``opt_pspecs``), so
they may be cut on another dim, or at other elements, than the
parameter; and the 128-blocks are the global last dim's.  Where the
parameter's, ``q``'s and ``scale``'s cuts over the data-parallel ranks,
and over ``model``, are the same dim and that is not the last, each
piece holds whole blocks and the update is local; otherwise the moment
is gathered over the data-parallel ranks (and over ``model`` where its
cut there differs), dequantized, cut as the parameter, updated,
gathered again and quantized on the global block grid, each rank
keeping its pieces.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import adamw as k6
from ..kernels import ref

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWHyper:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def schedule(h: AdamWHyper, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: a float32
    tensor on ``step``'s device."""
    step = step.to(torch.float32)
    warm = step / max(1.0, h.warmup_steps)
    t = (step - h.warmup_steps) / max(1.0, h.total_steps - h.warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = h.min_lr_frac + (1 - h.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return h.lr * torch.where(step < h.warmup_steps, warm, cos)


# --- int8 blockwise quantization --------------------------------------------

def _pad_to_block(n: int) -> int:
    return (n + QBLOCK - 1) // QBLOCK * QBLOCK


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (int8 q, float32 scale per trailing 128-block)."""
    shape = x.shape
    last = shape[-1]
    pad = _pad_to_block(last) - last
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blocks = x.reshape(*shape[:-1], -1, QBLOCK)
    scale = torch.clamp(blocks.abs().amax(-1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.round(blocks / scale).to(torch.int8)
    return q.reshape(*shape[:-1], -1), scale[..., 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               last: int) -> torch.Tensor:
    shape = q.shape
    blocks = q.reshape(*shape[:-1], -1, QBLOCK).to(torch.float32)
    x = (blocks * scale[..., None]).reshape(*shape[:-1], -1)
    return x[..., :last]


# --- optimizer state ----------------------------------------------------------

def init_opt_state(cfg, params: dict) -> dict:
    """Zero moments for each leaf of ``params`` (float32, or ``{"q",
    "scale"}`` for int8 moments) and step 0, on the leaves' devices."""

    def zeros_like_moment(p):
        if cfg.opt_moment_dtype == "int8":
            last = _pad_to_block(p.shape[-1]) if p.dim() else QBLOCK
            return {"q": torch.zeros(p.shape[:-1] + (last,),
                                     dtype=torch.int8, device=p.device),
                    "scale": torch.zeros(p.shape[:-1] + (last // QBLOCK,),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = next(iter(params.values())).device
    return {"m": {n: zeros_like_moment(p) for n, p in params.items()},
            "v": {n: zeros_like_moment(p) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# --- update ---------------------------------------------------------------------

def _global_norm(grads, counted=None, group=None) -> torch.Tensor:
    """The float32 norm of all the gradients together: the square root of
    the sum of each leaf's squares.  Sharded: only the leaves in
    ``counted`` (this rank's pieces that no lower rank holds too), the
    sum taken over the process group ``group``."""
    parts = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
             for n, g in grads.items() if counted is None or n in counted]
    sq = torch.stack(parts).sum() if parts else torch.zeros(
        (), dtype=torch.float32, device=next(iter(grads.values())).device)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def _update(p, g, m, v, h: AdamWHyper, lr, step, hvec):
    """One leaf's AdamW map: K6 on the card (``hvec`` its hyperparameter
    vector), the plain version on the CPU; returns (p', m', v')."""
    if p.device.type == "cpu":
        return ref.adamw(p, g, m, v, lr=lr, beta1=h.beta1, beta2=h.beta2,
                         eps=h.eps, weight_decay=h.weight_decay, step=step)
    outs = k6.adamw(p.reshape(-1), g.reshape(-1), m.reshape(-1),
                    v.reshape(-1), hvec)
    return tuple(o.reshape(p.shape) for o in outs)


def _aligned(lp, lq, ls, spmd, dim: str) -> bool:
    """Do an int8 moment's ``q`` and ``scale`` pieces (layouts ``lq``,
    ``ls``) hold whole 128-blocks of the parameter's piece (``lp``) over
    the ranks of ``dim`` (``"dp_dim"`` or ``"model_dim"``)?"""
    if (spmd.dpn if dim == "dp_dim" else spmd.mp) == 1:
        return True
    cut = getattr(lp, dim)
    return cut == getattr(lq, dim) == getattr(ls, dim) \
        and cut != len(lp.shape) - 1


def _moment_in(m, lay, lp, spmd, last: int):
    """An int8 moment (sqrt-domain ``v`` squared by the caller) as float32
    on the parameter's piece."""
    over_model = not _aligned(lp, lay["q"], lay["scale"], spmd, "model_dim")
    if not over_model and _aligned(lp, lay["q"], lay["scale"], spmd,
                                   "dp_dim"):
        return dequantize(m["q"], m["scale"], last)
    full = dequantize(
        lay["q"].gather(m["q"], spmd, over_model=over_model),
        lay["scale"].gather(m["scale"], spmd, over_model=over_model),
        lp.shape[-1])
    return lp.local(full, spmd, over_model=over_model)


def _moment_out(x, lay, lp, spmd) -> dict:
    """A float32 moment on the parameter's piece quantized on the global
    block grid, as the rank's ``q`` and ``scale`` pieces."""
    over_model = not _aligned(lp, lay["q"], lay["scale"], spmd, "model_dim")
    if not over_model and _aligned(lp, lay["q"], lay["scale"], spmd,
                                   "dp_dim"):
        q, sc = quantize(x)
        return {"q": q, "scale": sc}
    q, sc = quantize(lp.gather(x, spmd, over_model=over_model))
    return {"q": lay["q"].local(q, spmd, over_model=over_model),
            "scale": lay["scale"].local(sc, spmd, over_model=over_model)}


def apply_adamw(cfg, h: AdamWHyper, params: dict, grads: dict, opt: dict,
                shardings=None):
    """One AdamW step of the float32 masters ``params`` with ``grads``
    (any float dtype, upcast a leaf at a time; float32 gradients are
    scaled by the clip factor in place) and ``opt`` (``m``, ``v``,
    ``step``).  Replaces the entries of ``params``, ``opt["m"]`` and
    ``opt["v"]`` leaf by leaf and returns (params, opt, metrics
    ``{"lr", "grad_norm"}``), as the reference returns its new trees.
    ``shardings``: the leaves are a sharded step's pieces
    (``dist.spmd.StateShardings``; module docstring)."""
    step = opt["step"] + 1
    lr = schedule(h, step)
    spmd = shardings.spmd if shardings is not None else None
    if spmd is None:
        gnorm = _global_norm(grads)
    else:
        import torch.distributed as dist
        gnorm = _global_norm(grads, shardings.counted(),
                             group=dist.group.WORLD)
    clip = torch.clamp(h.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    quant = cfg.opt_moment_dtype == "int8"
    dev = step.device
    hvec = None
    if dev.type == "cuda":      # one hyperparameter vector for every leaf
        hvec = k6.hyper(lr=lr, beta1=h.beta1, beta2=h.beta2, eps=h.eps,
                        weight_decay=h.weight_decay, step=step, device=dev)
    ms, vs = opt["m"], opt["v"]
    for name, p in params.items():
        g = grads[name].to(torch.float32)   # a float32 gradient: itself
        g.mul_(clip)
        m, v = ms[name], vs[name]
        if quant and spmd is not None:
            lp = shardings.tree["params"][name]
            lm = shardings.tree["opt"]["m"][name]
            lv = shardings.tree["opt"]["v"][name]
            m = _moment_in(m, lm, lp, spmd, p.shape[-1])
            sv32 = _moment_in(v, lv, lp, spmd, p.shape[-1])
            v = sv32 * sv32
        elif quant:
            m32 = dequantize(m["q"], m["scale"], p.shape[-1])
            # v is stored in the sqrt domain (the reference's choice: a
            # linear int8 grid loses the small-v tail)
            sv32 = dequantize(v["q"], v["scale"], p.shape[-1])
            m, v = m32, sv32 * sv32
        params[name], m, v = _update(p, g, m, v, h, lr, step, hvec)
        del g
        if quant and spmd is not None:
            m = _moment_out(m, lm, lp, spmd)
            v = _moment_out(torch.sqrt(v), lv, lp, spmd)
        elif quant:
            qm, sm = quantize(m)
            qv, sv = quantize(torch.sqrt(v))
            m, v = {"q": qm, "scale": sm}, {"q": qv, "scale": sv}
        ms[name], vs[name] = m, v
    opt["step"] = step
    return params, opt, {"lr": lr, "grad_norm": gnorm}
