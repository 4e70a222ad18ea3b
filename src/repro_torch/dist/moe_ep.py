"""Expert-parallel MoE over the ``model`` axis of a mesh, from the
reference's ``repro.dist.moe_ep`` (``supported``, ``moe_layer_ep``).

The reference ``shard_map``s the expert FFN over ``model`` and leaves
the rest to GSPMD.  Here each rank of the ``model`` axis computes the
same layer (its rows are the same: the batch shards over the
data-parallel axes only) and the layer is cut by hand:

* routing (the float32 router softmax and top k) and the load-balance
  term run replicated, on every group of tokens;
* each model rank dispatches and combines its own contiguous block of
  the G token groups (``ceil(G / mp)`` groups, the last blocks padded
  with empty groups), the dispatch and combine of
  ``models.common.moe_layer``, group by group the same math;
* the expert FFN: on the **EP path** (``E % mp == 0``) rank j owns
  experts ``[j E/mp, (j+1) E/mp)``; one ``all_to_all_single`` sends
  each rank's expert batch of its groups to the experts' owners and one
  sends the outputs back.  On the **replica path** (``mp % E == 0``)
  each expert is replicated over ``r = mp / E`` ranks: the capacity
  pads to ``C_pad``, a multiple of r, and rank j runs the contiguous
  slot block ``j mod r`` of expert ``j // r`` (zero slots map to zero
  outputs: the FFN has no bias), through the same two exchanges with
  ``E·r = mp`` virtual experts of one slot block each;
* the combined groups are gathered over ``model``, so the output is
  replicated again.

Gradients: the exchanges carry theirs (the reverse exchange); a
replicated input cut into this rank's block gets every rank's block
gradient back (``spmd.chunk_rows``), a gathered output gives each rank
its own block's (``spmd.join_rows``), so every replicated tensor ends
with its whole gradient on every rank.  Expert weights come either
whole (``(E, ...)``, replicated: this rank's experts are cut out the
same way, and on the replica path the weights' gradients are summed
over ``model``) or as this rank's experts only (``(E / mp, ...)``, the
sharded train step's expert leaves), whose gradients are complete on
their owner.
"""
from __future__ import annotations

import torch

from ..models.common import (combine, expert_batch, expert_ffn,
                             load_balance, route, shared_experts)
from . import spmd as spmd_lib
from .sharding import current_mesh, mesh_axis_sizes


def supported(cfg, mesh=None) -> bool:
    """Can ``moe_layer_ep`` run ``cfg`` on the (ambient) mesh?  True when
    the mesh has a ``model`` axis larger than 1 and the expert count
    divides it or is divided by it; False otherwise (callers fall back
    to ``moe_layer``)."""
    mesh = current_mesh(mesh)
    if mesh is None or not getattr(cfg, "n_experts", 0) or cfg.topk < 1:
        return False
    mp = mesh_axis_sizes(mesh).get("model", 1)
    if mp <= 1:
        return False
    E = cfg.n_experts
    return E % mp == 0 or mp % E == 0


def _model_group(mesh):
    if not hasattr(mesh, "get_group"):
        raise ValueError("moe_layer_ep needs a torch.distributed DeviceMesh "
                         "(launch.mesh.make_host_mesh), not a replica mesh")
    return mesh.get_group("model"), mesh.get_local_rank("model")


def moe_layer_ep(cfg, x, p, mesh=None, shared: bool = True):
    """Expert-parallel MoE layer; a drop-in for ``models.common.moe_layer``
    on the ranks of the mesh's ``model`` axis (module docstring).

    x: (G, Tg, D) token groups, the same on every model rank; p:
    ``router`` (D, E), ``wg``/``wu`` (E, D, F) and ``wd`` (E, F, D), or on
    the EP path this rank's experts (E / mp, ...), and the shared
    experts' ``wg_s``/``wu_s``/``wd_s``.  Returns (y (G, Tg, D), aux),
    the same on every model rank; ``shared=False`` leaves the shared
    experts out (the caller runs them).  Raises ``ValueError`` without a
    mesh or where ``supported(cfg, mesh)`` is False."""
    mesh = current_mesh(mesh)
    if mesh is None or not supported(cfg, mesh):
        raise ValueError(
            "moe_layer_ep needs an active mesh whose 'model' axis size "
            "divides (or is divided by) n_experts; guard calls with "
            "moe_ep.supported(cfg)")
    group, j = _model_group(mesh)
    mp = mesh_axis_sizes(mesh)["model"]
    G, Tg, D = x.shape
    E = cfg.n_experts

    probs, gate, idx = route(cfg, x, p["router"])      # replicated
    aux = load_balance(cfg, probs, idx)
    gc = -(-G // mp)                                    # groups a rank
    n_real = max(0, min(G - j * gc, gc))
    xs = spmd_lib.chunk_rows(x, j, gc, group, mp)
    gs = spmd_lib.chunk_rows(gate, j, gc, group, mp)
    ids = idx[j * gc:j * gc + n_real]
    if n_real < gc:         # empty groups route nowhere: pad the ids
        ids = torch.cat([ids, ids.new_zeros((gc - n_real,) + ids.shape[1:])])
    xe, plan = expert_batch(cfg, xs, ids)              # (gc, E, C, D)
    C = plan[0]
    if n_real < gc:
        xe = torch.cat([xe[:n_real], xe.new_zeros(
            (gc - n_real,) + tuple(xe.shape[1:]))])

    if E % mp == 0:                                     # EP path
        El = E // mp
        ws = [p[k] if p[k].shape[0] == El and El != E
              else spmd_lib.chunk_rows(p[k], j, El, group, mp)
              for k in ("wg", "wu", "wd")]
        slots = xe
    else:                                               # replica path
        r = mp // E
        El = 1
        C_pad = -(-C // r) * r
        slots = torch.nn.functional.pad(xe, (0, 0, 0, C_pad - C))
        slots = slots.reshape(gc, E * r, C_pad // r, D)
        ws = [spmd_lib.sum_grad(p[k], group)[j // r:j // r + 1]
              for k in ("wg", "wu", "wd")]
    Cs = slots.shape[2]
    # block i of the exchange goes to rank i: my groups, i's experts
    send = slots.reshape(gc, mp, El, Cs, D).transpose(0, 1)
    got = spmd_lib.all_to_all(send, group)          # (mp, gc, El, Cs, D)
    y = expert_ffn(cfg, got.reshape(mp * gc, El, Cs, D), *ws)
    back = spmd_lib.all_to_all(y.reshape(mp, gc, El, Cs, D), group)
    ye = back.transpose(0, 1).reshape(gc, mp * El, Cs, D)
    if E % mp:
        ye = ye.reshape(gc, E, -1, D)[:, :, :C]

    out = combine(ye, gs, plan, x.dtype)                # (gc, Tg, D)
    out = spmd_lib.join_rows(out, j, G, group, mp)
    return (shared_experts(cfg, x, out, p) if shared else out), aux
