"""The reference's parameter tree as the port's model, so that the tests
run both packages on the same numbers.

``params_from_reference`` takes the tree that ``repro.models.init_params``
builds (``embed``, ``unembed``, the final norm, and ``layers`` stacked
``(L, ...)``), its leaves as numpy arrays (or anything ``np.asarray``
reads, in a dtype numpy has: the configs' ``param_dtype`` is float32),
and returns an ``LM`` with every leaf copied and ``layers`` unstacked, in
the arrays' dtype.  It is cast with ``forward.cast_params``, as a loaded
model is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.codegen import resolve_device
from .model import LM, model_shapes


def params_from_reference(cfg, tree: dict, device="cuda") -> LM:
    """An ``LM`` on ``device`` (the card unless the caller asks for
    ``"cpu"``; raises without one) holding a copy of the reference's
    parameter ``tree``; raises where a leaf is missing, extra or of
    another shape than ``model_shapes(cfg)`` gives."""
    dev = resolve_device(device)
    shapes = model_shapes(cfg)
    per_layer = shapes.pop("layers")
    if set(tree) != set(shapes) | {"layers"} \
            or set(tree["layers"]) != set(per_layer):
        raise ValueError(f"{cfg.name}: the tree's leaves are not the "
                         f"config's: {sorted(tree)}, layers "
                         f"{sorted(tree['layers'])}")

    def array(name, a, shape) -> np.ndarray:
        a = np.asarray(a)
        if a.shape != tuple(shape):
            raise ValueError(f"{cfg.name}: leaf {name} has shape {a.shape}, "
                             f"the config {tuple(shape)}")
        return a

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    top = {k: tensor(array(k, tree[k], s)) for k, s in shapes.items()}
    stacked = {k: array(k, tree["layers"][k], s)
               for k, s in per_layer.items()}
    layers = [{k: tensor(a[l]) for k, a in stacked.items()}
              for l in range(cfg.n_layers)]
    return LM(cfg, top, layers)
