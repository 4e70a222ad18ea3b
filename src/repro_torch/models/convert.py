"""The reference's parameter tree as the port's model, so that the tests
run both packages on the same numbers.

``params_from_reference`` takes the tree that ``repro.models.init_params``
builds (``embed``, ``unembed``, the final norm, ``layers`` stacked
``(L, ...)``, an MoE model's ``head_layers`` and Whisper's
``enc_layers``, ``enc_pos`` and ``encf_*``; the MoE leaves ``router``,
``wg``/``wu``/``wd`` of (E, ·, ·) and ``*_s``, the SSD mixer's ``ssm_*``,
a hybrid's ``mix_*`` and a Whisper decoder's ``lnx_*`` and ``x_*``), its
leaves as numpy arrays (or anything ``np.asarray`` reads, in a dtype
numpy has: the configs' ``param_dtype`` is float32), and returns an
``LM`` with every leaf copied and every stack unstacked, in the arrays'
dtype.  It
is cast with ``forward.cast_params``, as a loaded model is.

``train_state_from_reference`` carries the reference's train state
across (``repro.launch.train.build_state``'s: float32 ``params``, the
optimizer's ``m`` and ``v``, float32 or int8 ``{"q", "scale"}`` leaves
stacked as the parameters are, and its ``step``) into the port's
(``train.steps.init_train_state``'s: leaves by parameter name).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.codegen import resolve_device
from .model import LM, model_shapes


def params_from_reference(cfg, tree: dict, device="cuda", tp=None) -> LM:
    """An ``LM`` on ``device`` (the card unless the caller asks for
    ``"cpu"``; raises without one) holding a copy of the reference's
    parameter ``tree``; raises where a leaf is missing, extra or of
    another shape than ``model_shapes(cfg)`` gives.  ``tp`` (a serving
    rank's ``dist.spmd.TensorParallel``): the rank's blocks of the
    leaves alone (``dist.sharding.param_block``), as
    ``launch.serve.load_model`` holds them."""
    from ..dist.sharding import param_block, take_block
    dev = resolve_device(device)
    shapes = model_shapes(cfg)
    stacks = {k: shapes.pop(k) for k in ("layers", "head_layers",
                                          "enc_layers") if k in shapes}
    if set(tree) != set(shapes) | set(stacks) or any(
            set(tree[k]) != set(s) for k, s in stacks.items()):
        raise ValueError(f"{cfg.name}: the tree's leaves are not the "
                         f"config's: {sorted(tree)}, " + ", ".join(
                             f"{k} {sorted(tree[k])}" for k in stacks
                             if k in tree))

    def array(name, a, shape) -> np.ndarray:
        a = np.asarray(a)
        if a.shape != tuple(shape):
            raise ValueError(f"{cfg.name}: leaf {name} has shape {a.shape}, "
                             f"the config {tuple(shape)}")
        return a

    def tensor(name, a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, copy=True))
        return take_block(t, param_block(cfg, name, t.shape, tp)).to(dev)

    def unstack(name):
        per_layer = stacks.get(name, {})
        stacked = {k: array(k, tree[name][k], s)
                   for k, s in per_layer.items()}
        n = next(iter(per_layer.values()))[0] if per_layer else 0
        return [{k: tensor(k, a[l]) for k, a in stacked.items()}
                for l in range(n)]

    top = {k: tensor(k, array(k, tree[k], s)) for k, s in shapes.items()}
    return LM(cfg, top, unstack("layers"), unstack("head_layers"),
              unstack("enc_layers"))


def _by_name(tree: dict, name: str):
    """The reference's leaf for the port's parameter ``name`` (``embed``,
    ``layers.3.wq``): a top-level leaf, or layer l of a stacked one; a
    ``{"q", "scale"}`` moment leaf as the same dict of layer l."""
    parts = name.split(".")
    if len(parts) == 1:
        return tree[name]
    stack, l, leaf = parts
    a = tree[stack][leaf]
    if isinstance(a, dict):
        return {k: np.asarray(v)[int(l)] for k, v in a.items()}
    return np.asarray(a)[int(l)]


def train_state_from_reference(cfg, state: dict, device="cuda") -> dict:
    """The port's train state on ``device`` holding a copy of the
    reference's ``state`` (``params``, ``opt`` with ``m``, ``v``,
    ``step``; its ``params_c`` is made again from the masters, as the
    reference makes it)."""
    from ..train.steps import init_train_state
    dev = resolve_device(device)
    out = init_train_state(cfg, params_from_reference(cfg, state["params"],
                                                      dev))

    def tensor(a):
        if isinstance(a, dict):
            return {k: tensor(v) for k, v in a.items()}
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    opt = state["opt"]
    for key in ("m", "v"):
        out["opt"][key] = {n: tensor(_by_name(opt[key], n))
                           for n in out["params"]}
    out["opt"]["step"] = torch.tensor(int(np.asarray(opt["step"])),
                                      dtype=torch.int32, device=dev)
    return out
