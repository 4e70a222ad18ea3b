"""The reference's ``repro.dist.sharding``: the pspec builders of the
FSDP layout and the replica side of the serving engine.

Builders (``param_pspecs``, ``opt_pspecs``, ``batch_pspecs``,
``cache_pspecs``, with ``_fsdp_entry``) give every leaf of a tree the
reference's ``PartitionSpec``, as a ``NamedSharding`` whose ``spec`` is
a tuple of entries (an axis name, a tuple of names, or None), one a
tensor dim.  A tree is nested dicts of leaves; a leaf is anything with
a ``.shape`` (a tensor, the reference's ``ShapeDtypeStruct``) or a
tuple of ints, so the reference's stacked trees (``layers`` -> ``wq``
(L, ...)) and the port's trees by parameter name (``layers.3.wq``)
both go through: a leaf under a ``<stack>.<l>.`` name takes the spec of
its stacked leaf, the layer dim dropped.  On a ``DeviceMesh`` a
``NamedSharding`` also gives its DTensor ``placements``.

``mesh_axis_sizes``, ``dp_axes`` and ``axis_product`` accept both a
``torch.distributed`` ``DeviceMesh`` and the replica ``launch.mesh.Mesh``.
``use_mesh`` installs an ambient mesh (the reference's
``jax.sharding.set_mesh``) that ``current_mesh`` returns.

A tensor-parallel serving rank holds blocks: ``param_block`` gives a
parameter leaf's (ranges of one dim: Mamba-2's ``ssm_in_proj`` is four,
its heads' z, xs and dt columns around B and C whole),
``serving_rows`` its rows of the batch; its decode cache holds those
rows and its KV heads (Whisper's cross ``xk``/``xv`` too) or SSD heads'
``state``, as ``cache_pspecs`` places them
(``train.steps.tensor_parallel_split`` admits only such splits).

``shard_program`` is the replica side: the reference ``shard_map``s a
batched program over contiguous row blocks of the global batch, one
block a replica of the ``data`` axis, with no communication (requests
are independent).  Here one controller does the same by hand:
``ShardedProgram`` cuts the batch into ``n_replicas`` contiguous row
blocks and runs block j with replica j's program (the same plan and
kernels, bound to replica j's device, with graphs of its own), then
joins the blocks' outputs in order on the program's device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Sequence

import torch

from ..core.codegen import BatchedProgram


# ---------------------------------------------------------------------------
# meshes: the ambient one, and the helpers on either kind
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (nested blocks
    stack), as the reference's ``jax.sharding.set_mesh``."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh(mesh=None):
    """``mesh`` if given, else the ambient one (``use_mesh``), else
    None."""
    if mesh is not None:
        return mesh
    return _AMBIENT[-1] if _AMBIENT else None


def axis_names(mesh) -> tuple[str, ...]:
    """A mesh's axis names: the replica ``Mesh``'s ``axis_names`` or a
    ``DeviceMesh``'s ``mesh_dim_names``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}``."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in ``mesh`` (``pod`` and/or
    ``data``), in mesh order."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def axis_product(mesh, axes: Sequence[str]) -> int:
    sizes = mesh_axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def mesh_fingerprint(mesh) -> str:
    """Stable content key of a mesh (a program-cache component: the same
    plan spread over different meshes is a different program).  Keys on
    the device identities, not just the topology: two ('data', 4)
    meshes over different devices never share a program."""
    return repr((tuple(mesh_axis_sizes(mesh).items()),
                 tuple(str(d) for d in mesh.devices)))


# ---------------------------------------------------------------------------
# pspec builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's ``spec`` (the reference's ``PartitionSpec`` entries, one a
    tensor dim) on ``mesh``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The DTensor placements of ``spec`` on a ``DeviceMesh``, one a
        mesh dim: ``Shard(d)`` on every axis that tensor dim d names
        (a tuple entry shards d over its axes in mesh order, as a tuple
        of names does in JAX), ``Replicate()`` on the rest."""
        from torch.distributed.tensor import Replicate, Shard
        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                out[names.index(a)] = Shard(d)
        return tuple(out)


#: a port leaf name inside a stack of layers: ``layers.3.wq``
_STACKED = re.compile(r"^(layers|head_layers|enc_layers)\.(\d+)\.")


def _shape(leaf) -> tuple[int, ...] | None:
    if hasattr(leaf, "shape"):
        return tuple(int(d) for d in leaf.shape)
    if isinstance(leaf, tuple) and all(isinstance(d, int) for d in leaf):
        return leaf
    return None


def _stack_len(cfg, stack: str) -> int:
    from ..models.model import _stack_sizes
    return _stack_sizes(cfg)[stack]


def _map(tree, fn, path: str = ""):
    """``fn(path, shape)`` for every leaf of a nested dict (an ``nn.Module``
    by its parameters' names), the same structure back."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    shape = _shape(tree)
    if shape is not None:
        return fn(path, shape)
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    raise TypeError(f"sharding: leaf {path!r} of type "
                    f"{type(tree).__name__} has no shape")


def _per_layer(cfg, path: str, shape, rule) -> tuple:
    """``rule(shape)`` for a leaf; a port leaf of a layer stack takes its
    stacked leaf's spec with the layer entry dropped."""
    for part in path.split("/"):
        m = _STACKED.match(part)
        if m and cfg is not None:
            return rule((_stack_len(cfg, m.group(1)),) + shape)[1:]
    return rule(shape)


def _fsdp_entry(shape, dp: tuple[str, ...], dpn: int,
                model_n: int, use_model: bool) -> tuple:
    """FSDP spec for one tensor: dp axes on the largest divisible dim,
    optionally ``model`` on the largest remaining divisible dim."""
    spec: list[Any] = [None] * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    if dp and dpn > 1:
        for i in order:
            if shape[i] % dpn == 0 and shape[i] >= dpn:
                spec[i] = dp if len(dp) > 1 else dp[0]
                break
    if use_model and model_n > 1:
        for i in order:
            if spec[i] is None and shape[i] % model_n == 0 \
                    and shape[i] >= model_n:
                spec[i] = "model"
                break
    return tuple(spec)


def param_pspecs(cfg, params, mesh) -> Any:
    """``NamedSharding`` tree for a parameter tree (FSDP/ZeRO-3): every
    tensor sharded over the data-parallel axes (``pod`` x ``data``) on
    its largest evenly divisible dim; where ``cfg.fsdp_only`` is False
    (MoE archs) a second dim over ``model``.  ``params``: the
    reference's stacked tree, ``models.model_shapes(cfg)``, an ``LM`` or
    the port's leaves by name."""
    dp = dp_axes(mesh)
    dpn = axis_product(mesh, dp)
    model_n = mesh_axis_sizes(mesh).get("model", 1)
    use_model = not getattr(cfg, "fsdp_only", True)

    def rule(shape):
        return _fsdp_entry(shape, dp, dpn, model_n, use_model)

    return _map(params, lambda path, shape: NamedSharding(
        mesh, _per_layer(cfg, path, shape, rule)))


def opt_pspecs(cfg, opt_state, mesh, params=None) -> Any:
    """``NamedSharding`` tree for an AdamW state: each moment (an int8
    moment's ``q`` and ``scale`` each) by the FSDP rule on its own
    shape, the scalar ``step`` replicated.  ``params`` is accepted for
    the reference's signature; the rule reads the moments' shapes."""
    del params
    return param_pspecs(cfg, opt_state, mesh)


def batch_pspecs(cfg, batch, mesh) -> Any:
    """``NamedSharding`` tree for a data batch: the leading global-batch
    dim over the data-parallel axes, everything else replicated;
    scalars, and batch dims that do not divide, replicate."""
    del cfg
    dp = dp_axes(mesh)
    dpn = axis_product(mesh, dp)

    def leaf(path, shape):
        if not shape or not dp or dpn <= 1 or shape[0] % dpn \
                or shape[0] < dpn:
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, (dp if len(dp) > 1 else dp[0],)
                             + (None,) * (len(shape) - 1))

    return _map(batch, leaf)


#: cache leaves are (layers, batch, ...); the dim that may also shard
#: over ``model``: the head dim of KV leaves, the SSD head dim
_CACHE_MODEL_DIM = {"k": 3, "v": 3, "xk": 3, "xv": 3, "state": 2}


def cache_pspecs(cfg, cache, mesh) -> Any:
    """``NamedSharding`` dict for a decode cache (``models.cache_shapes``
    or ``zero_cache``): the batch dim over the data-parallel axes, the
    KV and SSD head dims over ``model`` where they divide (serving keeps
    tensor parallelism for the cache)."""
    del cfg
    dp = dp_axes(mesh)
    dpn = axis_product(mesh, dp)
    model_n = mesh_axis_sizes(mesh).get("model", 1)

    def leaf(name: str, shape):
        spec: list[Any] = [None] * len(shape)
        if len(shape) > 1 and dp and dpn > 1 and shape[1] % dpn == 0 \
                and shape[1] >= dpn:
            spec[1] = dp if len(dp) > 1 else dp[0]
        hd = _CACHE_MODEL_DIM.get(name)
        if hd is not None and hd < len(shape) and model_n > 1 \
                and shape[hd] % model_n == 0 and shape[hd] >= model_n:
            spec[hd] = "model"
        return NamedSharding(mesh, tuple(spec))

    return {k: leaf(k, _shape(v)) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# a tensor-parallel serving rank's blocks
# ---------------------------------------------------------------------------

def param_block(cfg, name: str, shape, tp):
    """(dim, ranges): the part of parameter leaf ``name`` (a top-level
    leaf's name, or a layer leaf's own, ``wq``) of ``shape`` (one
    layer's, unstacked) that a tensor-parallel serving rank holds on
    ``tp`` (a ``dist.spmd.TensorParallel``): the ``[lo, hi)`` ranges of
    one dim, held as one tensor in that order (one range for every leaf
    but ``ssm_in_proj``), the blocks the layers cut from whole weights:

    * GQA: the columns of its query heads in ``wq`` and ``bq`` and their
      rows in ``wo``, of the KV heads those read in ``wk``, ``wv``,
      ``bk``, ``bv`` (``models.model.tp_heads``: MQA's one head whole);
      a Whisper decoder's cross-attention ``x_wq``, ``x_wk``, ``x_wv``,
      ``x_wo`` (and ``x_b*`` where the config has biases) alike, and its
      encoder's (``enc_layers``) attention and MLP as the decoder's;
    * MLA (``model.mla_attention``): its heads' ``nope + rope`` columns
      of ``wq``, ``nope`` columns of ``w_uk``, ``v_head_dim`` columns of
      ``w_uv`` and rows of ``wo``; the latent's ``w_dkv`` and ``w_kr``
      whole;
    * a dense MLP (a dense layer's, an MoE model's ``head_layers``): its
      block of the hidden columns of ``wg``, ``wu`` and rows of ``wd``;
      the shared experts' alike in ``wg_s``, ``wu_s``, ``wd_s``;
    * the experts, (E, D, F) ``wg``/``wu`` and (E, F, D) ``wd``
      (``common.moe_layer``): its block of E where the ranks divide it,
      else its block of every expert's F;
    * the SSD mixer (``models.ssm.ssm_mixer``), its block h0:h1 of the
      ``ssm_heads`` of P columns: ``ssm_in_proj``'s columns (z, xs, B,
      C, dt) in four ranges, z's and xs's ``[h0 P, h1 P)``, B and C
      whole, dt's ``[h0, h1)``; its heads of ``ssm_dt_bias``,
      ``ssm_A_log``, ``ssm_D_skip``, their P columns of ``ssm_norm_g``
      and rows of ``ssm_out_proj``;
    * ``unembed``: its block of the vocabulary's columns
      (``TensorParallel.block``).

    None for a leaf held whole (``embed``, tied or not: every rank looks
    tokens up in it, and a tied model's logits read the rank's
    vocabulary rows of it, ``forward.unembed``; the norms, ``router``,
    ``enc_pos``) and off ``tp``."""
    if tp is None:
        return None
    if name in ("wg", "wu", "wd") and len(shape) == 3:
        E = cfg.n_experts
        if E % tp.n == 0:
            return 0, (tp.block(E),)
        return (2 if name != "wd" else 1), (tp.block(cfg.d_ff_moe),)
    if name.startswith("ssm_"):
        P, di, N = cfg.ssm_head_dim, cfg.d_inner, cfg.ssm_state
        h0, h1 = tp.block(cfg.ssm_heads)
        cols = (h0 * P, h1 * P)
        cut = {"ssm_in_proj": (1, (cols, (di + cols[0], di + cols[1]),
                                   (2 * di, 2 * di + 2 * N),
                                   (2 * di + 2 * N + h0,
                                    2 * di + 2 * N + h1))),
               "ssm_dt_bias": (0, ((h0, h1),)),
               "ssm_A_log": (0, ((h0, h1),)),
               "ssm_D_skip": (0, ((h0, h1),)),
               "ssm_norm_g": (0, (cols,)),
               "ssm_out_proj": (0, (cols,))}
        return cut.get(name)
    if cfg.family == "encdec" and name.startswith("x_"):
        name = name[2:]                 # cross-attention: cut as self's
    if cfg.kv_lora_rank:
        h0, h1 = tp.block(cfg.n_heads)
        nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        heads = {"wq": (1, nd + rd), "w_uk": (1, nd), "w_uv": (1, vd),
                 "wo": (0, vd)}.get(name)
        if heads is not None:
            dim, w = heads
            return dim, ((h0 * w, h1 * w),)
    from ..models.model import tp_heads
    dh = cfg.dh
    (q0, q1), (kv0, kv1) = tp_heads(cfg, tp)
    q, kv = (q0 * dh, q1 * dh), (kv0 * dh, kv1 * dh)
    ff = tp.block(cfg.d_ff)
    fs = tp.block(cfg.d_ff_moe * cfg.n_shared_experts)
    cut = {"wq": (1, q), "bq": (0, q), "wo": (0, q), "wk": (1, kv),
           "wv": (1, kv), "bk": (0, kv), "bv": (0, kv), "wg": (1, ff),
           "wu": (1, ff), "wd": (0, ff), "wg_s": (1, fs), "wu_s": (1, fs),
           "wd_s": (0, fs),
           "unembed": (1, tp.block(cfg.vocab))}
    got = cut.get(name)
    return None if got is None else (got[0], (got[1],))


def take_block(t: torch.Tensor, block) -> torch.Tensor:
    """``t``'s ``block`` (``param_block``: its ranges of one dim joined in
    order) as a tensor of its own (``t`` itself where None), so that the
    whole leaf can be freed."""
    if block is None:
        return t
    dim, ranges = block
    return torch.cat([t.narrow(dim, lo, hi - lo) for lo, hi in ranges],
                     dim).contiguous()


def rank_param_bytes(cfg, tp, itemsize: int, without=()) -> int:
    """The bytes of the parameters a tensor-parallel serving rank holds
    (``param_block`` of every leaf of ``models.model_shapes``, rank
    ``tp.rank``'s; the whole model's off ``tp``), at ``itemsize`` bytes
    an element; the entries of the tree named in ``without`` (a stack,
    ``enc_layers``, or a top-level leaf) left out."""
    from ..models.model import model_shapes
    total = 0
    for name, shape in model_shapes(cfg).items():
        if name in without:
            continue
        stacked = isinstance(shape, dict)
        for leaf, s in (shape.items() if stacked else [(name, shape)]):
            n, s = (s[0], list(s[1:])) if stacked else (1, list(s))
            b = param_block(cfg, leaf, s, tp)
            if b is not None:
                s[b[0]] = sum(hi - lo for lo, hi in b[1])
            total += n * math.prod(s)
    return total * itemsize


def serving_rows(cfg, batch: int, spmd) -> tuple[int, int]:
    """The ``[lo, hi)`` rows of a global batch of ``batch`` a serving rank
    holds: its block over the data-parallel ranks where ``batch_pspecs``
    splits the batch, every row where it replicates it."""
    spec = batch_pspecs(cfg, {"tokens": (batch,)}, spmd.source)["tokens"]
    if not spec.spec or spec.spec[0] is None:
        return 0, batch
    per = batch // spmd.dpn
    return spmd.dp_rank * per, (spmd.dp_rank + 1) * per


# ---------------------------------------------------------------------------
# the replica side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedProgram:
    """A ``BatchedProgram`` spread over the replicas of a mesh axis
    (module docstring).  Called as the batched program is; the global
    batch must be a multiple of ``n_replicas``.  A block bound for
    another device than the one its rows lie on is copied there, into a
    fresh tensor each call, so that replica replays a graph only where
    the allocator hands back the same address; a replica on the rows'
    own device reads its block in place."""

    base: BatchedProgram
    replicas: tuple[BatchedProgram, ...]
    axis: str
    #: the replicas keep the graphs (``replica_runners``)
    replays = None

    @property
    def graph(self):
        return self.base.graph

    @property
    def plan(self):
        return self.base.plan

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def group_fns(self):
        return self.base.group_fns

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def replica_runners(self) -> list:
        return [r.replays for r in self.replicas if r.replays is not None]

    def prepare(self, **inputs) -> list[torch.Tensor]:
        return self.base.prepare(**inputs)

    def run(self, *tensors: torch.Tensor) -> tuple:
        """The program on positional batched tensors: row block j on
        replica j, the outputs joined in order on ``device``."""
        nb = tensors[0].shape[0]
        R = self.n_replicas
        if nb % R:
            raise ValueError(f"a batch of {nb} rows does not split over "
                             f"{R} replicas")
        per = nb // R
        blocks = []
        for j, rep in enumerate(self.replicas):
            part = [t[j * per:(j + 1) * per].to(rep.device)
                    for t in tensors]
            blocks.append(rep.run(*part))
        return tuple(torch.cat([b[k].to(self.device) for b in blocks])
                     for k in range(len(blocks[0])))

    def __call__(self, **inputs):
        outs = self.run(*self.prepare(**inputs))
        return outs[0] if len(outs) == 1 else outs


def shard_program(prog: BatchedProgram, mesh, axis: str = "data"):
    """Spread ``prog`` (from ``FusionCompiler.compile_batched``) over the
    ``axis`` replicas of ``mesh``: a ``ShardedProgram`` whose replica j
    runs on ``mesh.along(axis)[j]``.  Returns ``prog`` unchanged when the
    axis has size 1.  Raises ``ValueError`` when ``mesh`` lacks
    ``axis``."""
    sizes = mesh_axis_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh {tuple(sizes)} has no {axis!r} axis")
    if sizes[axis] == 1:
        return prog
    replicas = tuple(dataclasses.replace(prog, device=d, replays=None)
                     for d in mesh.along(axis))
    return ShardedProgram(base=prog, replicas=replicas, axis=axis)
