"""AdamW as a fusion-compiler script: the paper's technique applied to
the optimizer.

The update is four elementary map calls over equal-length vectors.  The
compiler fuses them into one group, so ``best`` runs one kernel (K1 on
the ``cuda`` backend) that reads p, g, m, v once and writes p', m', v'
— 7 vector streams against 13 for ``unfused``.  Port of the reference's
``repro/optim/fused.py``; the hand-written kernel of the same update is
K6 (``kernels.adamw``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import FusionCompiler
from repro_torch.core.elementary import make_map
from repro_torch.kernels._launch import device_scalar as _scalar

# elementary library for the optimizer ---------------------------------------

ema = make_map(
    "ema", lambda b, m, g: b * m + (1.0 - b) * g, arity=3, scalar_args=(0,),
    flops_per_point=3, cuda="{0} * {1} + (1.0f - {0}) * {2}")
ema_sq = make_map(
    "ema_sq", lambda b, v, g: b * v + (1.0 - b) * (g * g), arity=3,
    scalar_args=(0,), flops_per_point=4,
    cuda="{0} * {1} + (1.0f - {0}) * ({2} * {2})")
adam_dir = make_map(
    "adam_dir",
    lambda c1, c2, eps, wd, m, v, p: (m * c1) / (torch.sqrt(v * c2) + eps)
    + wd * p,
    arity=7, scalar_args=(0, 1, 2, 3), flops_per_point=6,
    cuda="({4} * {0}) / (sqrtf({5} * {1}) + {2}) + {3} * {6}")
apply_lr = make_map(
    "apply_lr", lambda lr, p, u: p - lr * u, arity=3, scalar_args=(0,),
    flops_per_point=2, cuda="{1} - {0} * {2}")


def adamw_script(g, p, grad, m, v, lr, b1, b2, eps, wd, c1, c2):
    m2 = g.apply(ema, b1, m, grad, name="m2")
    v2 = g.apply(ema_sq, b2, v, grad, name="v2")
    u = g.apply(adam_dir, c1, c2, eps, wd, m2, v2, p, name="u")
    p2 = g.apply(apply_lr, lr, p, u, name="p2")
    return p2, m2, v2


@functools.lru_cache(maxsize=32)
def make_fused_adamw(n: int, backend: str = "cuda", mode="best",
                     device="cuda"):
    """Compile the fused AdamW update for flat float32 vectors of length
    ``n`` on ``device``.

    Returns ``prog(**inputs) -> (p', m', v')``.  With ``mode='unfused'``
    each map runs as its own kernel (the baseline the paper compares
    against).
    """
    cc = FusionCompiler(backend=backend, device=device)
    shapes = {"p": (n,), "grad": (n,), "m": (n,), "v": (n,),
              "lr": (), "b1": (), "b2": (), "eps": (), "wd": (),
              "c1": (), "c2": ()}
    return cc.compile(adamw_script, shapes, mode=mode)


def fused_adamw_update(p, grad, m, v, *, lr, beta1=0.9, beta2=0.95,
                       eps=1e-8, weight_decay=0.0, step=1,
                       backend: str = "cuda", mode="best"):
    """Flat-vector AdamW through the fusion compiler, on ``p``'s device.

    Every scalar, the bias corrections ``c1 = 1 / (1 - beta1**step)`` and
    ``c2`` included, is a float32 0-d tensor on that device, so ``lr``
    and ``step`` may be tensors (a schedule) and nothing waits for the
    card.  Returns new ``(p', m', v')`` in float32.
    """
    dev = p.device
    prog = make_fused_adamw(p.shape[0], backend, mode, dev)
    b1, b2 = _scalar(beta1, dev), _scalar(beta2, dev)
    sf = _scalar(step, dev)
    c1 = 1.0 / (1.0 - b1 ** sf)
    c2 = 1.0 / (1.0 - b2 ** sf)
    return prog(p=p, grad=grad, m=m, v=v, lr=_scalar(lr, dev), b1=b1, b2=b2,
                eps=_scalar(eps, dev), wd=_scalar(weight_decay, dev),
                c1=c1, c2=c2)
