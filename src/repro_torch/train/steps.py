"""The train step and the serving steps, from the reference's
``repro.train.steps``: ``make_train_step`` (with ``init_train_state``,
the state it takes), ``make_prefill_step`` and ``make_decode_step`` with
greedy ``argmax``, ``DecodeReplay``, the decode step captured once as a
CUDA graph and replayed at every position, as the reference jits it
once with the position traced, and ``abstract_batch``.

Sharded training (``shard_train_state``, then ``make_train_step(...,
shardings=)``) runs the reference's FSDP layout on the ranks of a
``torch.distributed`` ``DeviceMesh`` (``launch.mesh.make_host_mesh``):

* the float32 masters and the moments hold each rank's piece of the
  reference's spec (``dist.sharding.param_pspecs``/``opt_pspecs``): the
  data-parallel axes (``pod`` x ``data``, flattened) cut the dim the
  spec gives them, and ``model`` the second dim a MoE config's spec
  gives it (a dense config's spec, ``fsdp_only``, replicates every leaf
  over ``model``).  The expert leaves (E, ...) a tensor-parallel MoE
  step splits are cut over ``model`` where it computes with them
  instead: along E where the axis divides the experts (either
  ``moe_impl``; ``shard_map``'s expert-parallel path without tensor
  parallelism too), along their hidden dim F for ``moe_layer``'s
  F-split; an int8 moment of such a leaf cut along its last dim lies as
  its own spec says;
* the compute copy ``params_c`` is FSDP2 (``fully_shard``, one unit a
  layer and the root), each parameter ``Shard(d)`` on the same dim over
  the data-parallel ranks, a leaf the spec replicates left out of FSDP
  (its gradient all-reduced); gradients are summed, never averaged.
  Over ``model`` it holds a rank's own piece of a split expert leaf and
  every other leaf whole: after the update the masters' pieces cut
  over ``model`` are gathered into it (one all-gather a leaf a step),
  and its gradients are reduce-scattered onto them;
* the batch (the global batch on every rank) is laid out as
  ``batch_pspecs`` lays it: the rows over the data-parallel ranks where
  they divide, replicated otherwise.  A dense config with tensor
  parallelism off (``set_tensor_parallel(False)``) runs its rows over
  the ``model`` ranks as well (the reference's ``dp`` absorbing
  ``model``), its gradients summed over ``model`` too;
* a dense or MoE config with tensor parallelism on (the default)
  splits its forward over the ``model`` ranks
  (``dist.spmd.TensorParallel``): each takes its block of the query
  heads (GQA's or MLA's), the MLP's columns (a MoE config's dense
  layers' and shared experts' too), the experts or their hidden columns
  (``models.common.moe_layer``; ``moe_impl="shard_map"``:
  ``dist.moe_ep``'s all-to-all over the same ranks) and the vocabulary,
  the residual stream is cut along the sequence between the layers, and
  the loss comes from K7's block entry (``models.forward.lm_loss``).
  The ``model`` ranks hold the same rows; each one's gradients are
  partial (its blocks, its block of the sequence) and are summed over
  ``model`` once;
* each rank's loss is its rows' masked sum over the whole batch's label
  count, plus the load-balance term averaged over the ranks' rows,
  divided by the number of ranks holding the same rows with the same
  forward, so the summed gradients are the reference's.

A family other than dense and MoE with tensor parallelism on a
``model`` axis larger than 1, and a split the axis does not divide,
raise: they come with a later tensor-parallel slice.  With tensor
parallelism off a MoE config trains its rows over ``model`` (the
experts whole on every rank) or, on ``moe_ep``'s path, its experts
over ``model``.
"""
from __future__ import annotations

import re

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


def make_train_step(cfg, hyper, accum: int = 1, shardings=None):
    """train_step(state, batch) -> (state, metrics), the reference's: the
    loss (``forward.lm_loss``) differentiated with respect to the
    compute copy ``params_c``; AdamW (``optim.apply_adamw``) on the
    float32 masters with the gradients upcast to float32; the copy
    refreshed from the new masters.  ``accum`` > 1 splits the batch into
    ``accum`` microbatches and sums their float32 gradients (then / accum),
    as the reference's scan; ``metrics`` (device tensors) are the last
    microbatch's ``xent`` and ``aux``, with ``loss`` (the mean over the
    microbatches), ``lr`` and ``grad_norm``.  The state's dicts are
    updated in place and returned.  ``shardings``: the sharded step on
    the state ``shard_train_state`` made (module docstring); it takes
    the global batch on every rank and returns global metrics."""
    if shardings is not None:
        return _sharded_step(cfg, hyper, accum, shardings)

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


def _under(spmd):
    """``dist.spmd.running(spmd)``, or no context where ``spmd`` is
    None."""
    import contextlib
    if spmd is None:
        return contextlib.nullcontext()
    from ..dist.spmd import running
    return running(spmd)


def make_prefill_step(cfg, spmd=None):
    """serve prefill: (model, batch) -> (last logits, cache); the batch's
    ``patches`` (a VLM) and ``frames`` (an encoder-decoder) where it has
    them.  ``spmd`` (``serving_spmd``): the step runs under it, split
    over its ``model`` ranks where ``spmd.tp`` is set."""

    def prefill_step(model, batch):
        with _under(spmd):
            return forward.prefill(cfg, model, batch["tokens"],
                                   patches=batch.get("patches"),
                                   frames=batch.get("frames"))

    return prefill_step


def make_decode_step(cfg, spmd=None):
    """serve decode: (model, cache, tokens, pos) -> (next ids, logits,
    cache).  One new token against the KV cache, the greedy choice
    (``argmax``, the first of equal maxima, as ``jnp.argmax``); ``pos``
    a host integer or a 0-d int32 device tensor.  ``spmd`` as in
    ``make_prefill_step``: every ``model`` rank computes the same whole
    logits, so the same ids."""

    def decode_step(model, cache, tokens, pos):
        with _under(spmd):
            logits, cache = forward.decode_step(cfg, model, cache, tokens,
                                                pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    return decode_step


def serving_spmd(cfg, mesh):
    """The ``dist.spmd.Spmd`` of tensor-parallel serving on ``mesh`` (a
    ``DeviceMesh`` over the process group, ``launch.mesh.make_host_mesh``):
    on a ``model`` axis larger than 1 its ``tp`` splits each layer over
    the ``model`` ranks, the model holding this rank's blocks
    (``TensorParallel.blocks``; ``tensor_parallel_split(...,
    serving=True)`` must hold, or this raises); the data-parallel ranks
    serve their rows of the batch (``dist.sharding.serving_rows``)."""
    from ..dist.spmd import Spmd, TensorParallel
    spmd = Spmd(mesh)
    if spmd.mp > 1:
        tensor_parallel_split(cfg, spmd.mp, serving=True)
        spmd.tp = TensorParallel(spmd.model_group, spmd.mp,
                                 spmd.model_rank, blocks=True)
    return spmd


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
    order.  On the card the first step runs on a side stream, the
    warm-up ``torch.cuda.graph`` asks for.  A failed capture raises.
    ``spmd``: the steps run under it (``make_decode_step``); on NCCL
    the capture records the collectives too, gloo's cannot be captured
    (``launch.serve.generate`` runs them eagerly)."""

    def __init__(self, cfg, model, cache, tokens, pos: int, spmd=None):
        self.model, self.cache = model, cache
        self.tokens = tokens.to(device=model.device, dtype=torch.int32,
                                copy=True)
        self.pos = torch.full((), pos, dtype=torch.int32, device=model.device)
        self.logits = None
        self.launches: list[str] = []
        self.captures = 0
        self._step = make_decode_step(cfg, spmd)
        self._graph = None
        self._warm = model.device.type != "cuda"

    def _advance(self):
        ids, self.logits, _ = self._step(self.model, self.cache, self.tokens,
                                         self.pos)
        self.tokens.copy_(ids)
        self.pos.add_(1)

    def __call__(self) -> torch.Tensor:
        if not self._warm:
            here = torch.cuda.current_stream(self.model.device)
            side = torch.cuda.Stream(self.model.device)
            side.wait_stream(here)
            with torch.cuda.stream(side):
                self._advance()
            here.wait_stream(side)
            self._warm = True
        elif self._graph is None:
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


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------

#: an expert leaf of a layer stack: (E, ...)
_EXPERT = re.compile(r"^layers\.\d+\.(wg|wu|wd)$")


def tensor_parallel_split(cfg, mp: int, serving: bool = False):
    """Raise unless a ``model`` axis of ``mp`` splits ``cfg``'s forward
    (``ValueError`` naming the dimension; a family it does not split,
    ``NotImplementedError``: both come with a later slice).  Training
    splits the dense and MoE families: ``mp`` must divide the heads,
    the MLP's columns (a MoE config's dense head layers' ``d_ff``, its
    shared experts' ``d_ff_moe · n_shared_experts``) and, where it does
    not divide the experts and the MoE layer is ``moe_layer``'s (the
    F-split), ``d_ff_moe``; a GQA rank's query heads must be whole groups
    of a KV head's or part of one.  ``serving``: the dense, vlm, MoE,
    ssm and encdec families (``models.forward.SERVING_TP_FAMILIES``),
    the MoE layer ``moe_layer``'s (``moe_impl="gspmd"``); the ssm
    family's ``ssm_heads`` must split (the SSD heads, their state and
    their block of the gated norm's columns), and an encoder-decoder's
    heads and ``d_ff`` as a dense config's; a GQA decode cache's KV
    heads (a Whisper decoder's cross ``xk``/``xv`` too) must lie as
    ``dist.sharding.cache_pspecs`` puts them, over ``model`` where ``mp``
    divides them, else whole, and so be the heads each rank's queries
    read: ``mp`` divides ``n_kv_heads``, or there is one
    (``ValueError``); MLA's latent cache, which every head reads, is
    whole on every rank.  The hybrid family waits for splits the axis
    does not divide: Hymba-1.5B's 25 query heads over 5 KV heads split
    over no axis of 2, 4, 8 or 16, and its ``d_ff`` of 5504 not over
    5."""
    from ..models.forward import SERVING_TP_FAMILIES
    families = SERVING_TP_FAMILIES if serving else ("dense", "moe")
    if cfg.family not in families:
        later = (" (the uneven-split item: Hymba-1.5B's 25 query heads "
                 "over 5 KV heads split over no 'model' axis of 2, 4, 8 or "
                 "16)" if serving and cfg.family == "hybrid" else "")
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over a 'model' axis of {mp} "
            f"on the {cfg.family} family comes with a later "
            f"tensor-parallel slice{later} (ROADMAP.md); this one splits "
            f"the {', '.join(families[:-1])} and {families[-1]} families")
    if serving and cfg.moe_impl == "shard_map":
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel serving runs the MoE layer as "
            f"moe_impl='gspmd' places it; moe_impl='shard_map' comes with "
            f"a later tensor-parallel slice (ROADMAP.md)")
    if cfg.family == "ssm":
        dims = [("ssm_heads", cfg.ssm_heads)]
    else:
        dims = [("n_heads", cfg.n_heads)]
    if cfg.family not in ("moe", "ssm") or cfg.first_dense_layers:
        dims.append(("d_ff", cfg.d_ff))
    if cfg.n_shared_experts:
        dims.append(("d_ff_moe · n_shared_experts",
                     cfg.d_ff_moe * cfg.n_shared_experts))
    if cfg.n_experts and cfg.n_experts % mp and not _ep_path(cfg, mp):
        dims.append(("d_ff_moe", cfg.d_ff_moe))
    for dim, size in dims:
        if size % mp:
            raise ValueError(
                f"{cfg.name}: {dim} = {size} does not split over a 'model' "
                f"axis of {mp}: a split the axis does not divide comes "
                f"with a later tensor-parallel slice (ROADMAP.md)")
    if not cfg.n_heads:
        return
    heads, G = cfg.n_heads // mp, cfg.n_heads // cfg.n_kv_heads
    if not cfg.kv_lora_rank and heads % G and G % heads:
        raise ValueError(
            f"{cfg.name}: {heads} query heads a rank over groups of {G} "
            f"a KV head (n_kv_heads = {cfg.n_kv_heads}) on a 'model' axis "
            f"of {mp}: a rank reading part of two groups comes with a "
            f"later tensor-parallel slice (ROADMAP.md)")
    if serving and cfg.n_kv_heads > 1 and cfg.n_kv_heads % mp:
        raise ValueError(
            f"{cfg.name}: n_kv_heads = {cfg.n_kv_heads} does not split over "
            f"a 'model' axis of {mp}: the decode cache would hold every KV "
            f"head on every rank (cache_pspecs), more than its queries "
            f"read; such a split comes with a later tensor-parallel slice "
            f"(ROADMAP.md)")


def _rows_over_model(cfg, spmd) -> bool:
    """What the ``model`` axis carries: False for 1 rank, a tensor-parallel
    split (``tensor_parallel_split`` checks it) or, with tensor
    parallelism off, a MoE config's experts on ``moe_ep``'s path; True
    for any other config with tensor parallelism off (more data-parallel
    rows: the reference's ``dp`` absorbing ``model``)."""
    from ..models.common import tensor_parallel_enabled
    mp = spmd.mp
    if mp == 1:
        return False
    if tensor_parallel_enabled():
        tensor_parallel_split(cfg, mp)
        return False
    return not _ep_path(cfg, mp)


def _ep_path(cfg, mp: int) -> bool:
    """Does the MoE layer run ``moe_ep``'s expert parallelism over a
    ``model`` axis of ``mp`` (``moe_impl="shard_map"``, the counts
    dividing one way or the other)?"""
    E = cfg.n_experts
    return bool(E) and cfg.moe_impl == "shard_map" and (E % mp == 0
                                                        or mp % E == 0)


def _expert_dims(cfg, spmd, tp, rows_over_model) -> dict:
    """The dim of each expert leaf (``wg``, ``wu``, ``wd``) that the
    ``model`` ranks split between them, each computing with its own
    piece: E where they divide it and run the experts split (both
    impls under tensor parallelism, ``moe_ep``'s path without), the
    hidden dim F for ``moe_layer``'s F-split; {} where each rank uses
    the experts whole (``moe_ep``'s replica path, rows over ``model``)."""
    mp, E = spmd.mp, cfg.n_experts
    if mp == 1 or not E or rows_over_model:
        return {}
    if E % mp == 0:
        return dict.fromkeys(("wg", "wu", "wd"), 0)
    if tp is not None and not _ep_path(cfg, mp):
        return {"wg": 2, "wu": 2, "wd": 1}
    return {}


def _dim_of(spec, axes) -> int | None:
    """The dim a spec cuts over any of the mesh ``axes``, or None."""
    for d, entry in enumerate(spec):
        names = (entry,) if isinstance(entry, str) else entry or ()
        if any(a in axes for a in names):
            return d
    return None


def _global_shapes(cfg) -> dict:
    """The port's leaves by name (``layers.3.wq``) with their global
    shapes, from ``model_shapes``' stacked tree."""
    from ..models.model import model_shapes
    out = {}
    for k, v in model_shapes(cfg).items():
        if isinstance(v, dict):
            for n, s in v.items():
                for l in range(s[0]):
                    out[f"{k}.{l}.{n}"] = tuple(s[1:])
        else:
            out[k] = tuple(v)
    return out


def _moment_shapes(cfg, shape):
    from ..optim.adamw import QBLOCK, _pad_to_block
    if cfg.opt_moment_dtype != "int8":
        return shape
    last = _pad_to_block(shape[-1]) if shape else QBLOCK
    return {"q": shape[:-1] + (last,), "scale": shape[:-1] + (last // QBLOCK,)}


def state_shardings(cfg, spmd):
    """The ``dist.spmd.StateShardings`` of ``cfg``'s train state on
    ``spmd``'s ranks (module docstring)."""
    from ..dist.sharding import dp_axes, opt_pspecs, param_pspecs
    from ..dist.spmd import Layout, StateShardings, TensorParallel
    from ..models.common import tensor_parallel_enabled
    mesh = spmd.source
    dp = dp_axes(mesh)
    rows_over_model = _rows_over_model(cfg, spmd)
    tp = None
    if spmd.mp > 1 and not rows_over_model and tensor_parallel_enabled():
        tp = TensorParallel(spmd.model_group, spmd.mp, spmd.model_rank)
    experts = _expert_dims(cfg, spmd, tp, rows_over_model)
    shapes = _global_shapes(cfg)

    def split(name):
        """The dim of leaf ``name`` a rank computes with its piece of."""
        m = _EXPERT.match(name)
        return experts.get(m.group(1)) if m else None

    def layout(name, spec, shape, quantized=False):
        # an int8 moment's 128-blocks run along its last dim: cut there,
        # it lies as its own spec says (``optim.adamw`` gathers it)
        model_dim = split(name)
        if model_dim is None or quantized and model_dim == len(shape) - 1:
            model_dim = _dim_of(spec, ("model",))
        lay = Layout(tuple(shape), _dim_of(spec, dp), model_dim)
        if model_dim is not None and lay.dp_dim == model_dim \
                and (shape[model_dim] // spmd.mp) % spmd.dpn:
            raise NotImplementedError(
                f"{name}: {shape[model_dim] // spmd.mp} of dim {model_dim} "
                f"a model rank do not split over {spmd.dpn} data-parallel "
                f"ranks")
        return lay

    pspecs = param_pspecs(cfg, shapes, mesh)
    params = {n: layout(n, pspecs[n].spec, s) for n, s in shapes.items()}
    # the compute copy: a rank's own piece of a split expert leaf, every
    # other leaf whole over ``model`` (gathered after each update)
    params_c = {n: lay if split(n) is not None else
                Layout(lay.shape, lay.dp_dim, None)
                for n, lay in params.items()}
    moments = {n: _moment_shapes(cfg, s) for n, s in shapes.items()}
    ospecs = opt_pspecs(cfg, {"m": moments}, mesh)["m"]

    def moment(n):
        if isinstance(moments[n], dict):
            return {k: layout(n, ospecs[n][k].spec, moments[n][k], True)
                    for k in moments[n]}
        return layout(n, ospecs[n].spec, moments[n])

    opt = {k: {n: moment(n) for n in shapes} for k in ("m", "v")}
    opt["step"] = Layout(())
    return StateShardings(spmd, {"params": params, "params_c": params_c,
                                 "opt": opt}, rows_over_model, tp)


def shard_train_state(cfg, state, mesh):
    """The sharded train state on the ranks of ``mesh`` (a ``DeviceMesh``
    over the whole process group, or a ``dist.spmd.Spmd``) from
    ``state``, the global state every rank built alike
    (``init_train_state``; its tensors are freed leaf by leaf), and its
    ``StateShardings``: (state, shardings).  Each rank keeps its pieces
    of the masters and moments, and ``params_c`` becomes the FSDP2
    module (module docstring)."""
    from ..dist.spmd import Layout, Spmd
    spmd = mesh if isinstance(mesh, Spmd) else Spmd(mesh)
    sh = state_shardings(cfg, spmd)
    tree = sh.tree
    params = state["params"]
    for n in list(params):
        params[n] = tree["params"][n].local(params[n], spmd)
    for key in ("m", "v"):
        moments = state["opt"][key]
        for n in list(moments):
            lay, t = tree["opt"][key][n], moments[n]
            moments[n] = ({k: lay[k].local(t[k], spmd) for k in t}
                          if isinstance(t, dict) else lay.local(t, spmd))
    model = state["params_c"]
    for n, p in list(model.named_parameters()):
        lay = tree["params_c"][n]
        if lay.model_dim is not None:   # its piece of split experts; FSDP
            # cuts it over dp
            stack, l, leaf = n.split(".")
            getattr(model, stack)[int(l)][leaf] = torch.nn.Parameter(
                Layout(lay.shape, None, lay.model_dim).local(p.data, spmd))
    _fully_shard(model, tree["params_c"], spmd)
    return state, sh


def _fully_shard(model, layouts: dict, spmd):
    """FSDP2 over the data-parallel ranks: one unit a layer, then the root;
    each parameter ``Shard(dp_dim)``, a parameter the spec replicates
    over several ranks left out; gradients summed."""
    from torch.distributed.fsdp import FSDPModule, fully_shard
    from torch.distributed.tensor import Shard
    place, ignored = {}, set()
    for n, p in model.named_parameters():
        d = layouts[n].dp_dim
        if d is None and spmd.dpn > 1:
            ignored.add(p)
        else:
            place[p] = Shard(d or 0)

    def fn(p):
        return place.get(p)

    for stack in (model.head_layers, model.layers, model.enc_layers):
        for lp in stack:
            fully_shard(lp, mesh=spmd.dp_mesh, shard_placement_fn=fn,
                        ignored_params=ignored & set(lp.parameters()) or None)
    fully_shard(model, mesh=spmd.dp_mesh, shard_placement_fn=fn,
                ignored_params=ignored & set(
                    model.parameters(recurse=False)) or None)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.set_gradient_divide_factor(1.0)
            if hasattr(m, "set_force_sum_reduction_for_comms"):
                m.set_force_sum_reduction_for_comms(True)


def _local(p) -> torch.Tensor:
    """A parameter's (or gradient's) piece on this rank."""
    return p.to_local() if hasattr(p, "to_local") else p


def _rows(sh, B: int):
    """How a batch of B rows lies: (the ranks holding different rows or
    None, this rank's block, the ranks holding each block)."""
    import torch.distributed as dist
    from ..dist.spmd import RowGroup
    sp = sh.spmd
    reduce_n = sp.world if sh.rows_over_model else sp.dpn
    if sh.rows_over_model and sp.world > 1 and B % sp.world == 0:
        return (RowGroup(dist.group.WORLD, sp.world),
                sp.dp_rank * sp.mp + sp.model_rank, 1)
    if sp.dpn > 1 and B % sp.dpn == 0:
        return RowGroup(sp.dp_group, sp.dpn), sp.dp_rank, reduce_n // sp.dpn
    return None, 0, reduce_n


def _sharded_step(cfg, hyper, accum: int, sh):
    import torch.distributed as dist
    from ..dist.spmd import all_gather_cat, reduce_scatter_cat, running
    sp = sh.spmd
    reduce_group = dist.group.WORLD if sh.rows_over_model else sp.dp_group
    reduce_n = sp.world if sh.rows_over_model else sp.dpn
    f32 = torch.float32

    def global_value(x, dup: int):
        """A per-rank value summed over the ranks that reduce gradients,
        over the ranks holding each row block."""
        x = x.detach().clone()
        if reduce_n > 1:
            dist.all_reduce(x, group=reduce_group)
        return x / dup if dup > 1 else x

    def micro_step(model, batch):
        rows, block, dup = _rows(sh, batch["tokens"].shape[0])
        if rows is not None:
            batch = {k: v.chunk(rows.n)[block] for k, v in batch.items()}
        count = (batch["labels"] >= 0).to(f32).sum()
        if rows is not None:
            dist.all_reduce(count, group=rows.group)
        count = torch.clamp(count, min=1.0)
        sp.rows, sp.tp = rows, sh.tp
        try:
            with running(sp):
                loss, metrics = model(
                    lambda m: forward.lm_loss(cfg, m, batch, count))
                (loss / dup if dup > 1 else loss).backward()
        finally:
            sp.rows = sp.tp = None
        xent = global_value(metrics["xent"], dup)
        aux = metrics["aux"]
        aux = aux.detach() if isinstance(aux, torch.Tensor) else aux
        return xent + 0.01 * aux, {"xent": xent, "aux": aux}

    def over_model(n, g):
        """A compute-copy gradient of ``n`` (its piece over dp) as the
        master's piece: summed over ``model`` where the ranks' gradients
        are partial (tensor parallelism, rows over ``model``), and cut
        to this rank's piece where the master is cut over ``model`` and
        the compute copy is not."""
        lay, copy = sh.tree["params"][n], sh.tree["params_c"][n]
        if sp.mp == 1 or copy.model_dim is not None:
            return g
        partial = sh.rows_over_model or sh.tp is not None
        if lay.model_dim is None:
            if partial:
                dist.all_reduce(g, group=sp.model_group)
            return g
        if partial:
            return reduce_scatter_cat(g, lay.model_dim, sp.model_group,
                                      sp.mp)
        return g.chunk(sp.mp, lay.model_dim)[sp.model_rank].contiguous()

    def whole_over_model(n, t):
        """A master's piece of ``n`` as the compute copy's: joined over
        ``model`` where the master is cut over it and the copy not."""
        lay, copy = sh.tree["params"][n], sh.tree["params_c"][n]
        if sp.mp == 1 or lay.model_dim is None or copy.model_dim is not None:
            return t
        return all_gather_cat(t, lay.model_dim, sp.model_group, sp.mp)

    def take_grads(model, grads):
        for n, p in model.named_parameters():
            g = torch.zeros(_local(p).shape, dtype=f32, device=_local(
                p).device) if p.grad is None else _local(p.grad).to(f32)
            if n in grads:
                grads[n].add_(g)
            else:
                grads[n] = g
            p.grad = None

    def train_step(state, batch):
        model = state["params_c"]
        grads: dict = {}
        if accum == 1:
            loss, metrics = micro_step(model, batch)
            take_grads(model, grads)
        else:
            loss = 0.0
            mb = batch["tokens"].shape[0] // accum
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, metrics = micro_step(model, micro)
                loss = loss + l
                take_grads(model, grads)
            for t in grads.values():
                t.div_(accum)
            loss = loss / accum
        for n, p in model.named_parameters():
            if not hasattr(p, "to_local") and sp.dpn > 1:
                dist.all_reduce(grads[n], group=sp.dp_group)
            grads[n] = over_model(n, grads[n])
        params, opt, opt_metrics = apply_adamw(
            cfg, hyper, state["params"], grads, state["opt"], shardings=sh)
        del grads
        with torch.no_grad():
            for n, p in model.named_parameters():
                _local(p).copy_(whole_over_model(n, params[n]))
        state = {"params": params, "params_c": model, "opt": opt}
        return state, metrics | opt_metrics | {"loss": loss}

    return train_step


def abstract_batch(cfg, shape) -> dict:
    """Stand-ins for the data batch of a shape cell, as the reference's:
    ``tokens`` and ``labels`` (B, S) int32, a VLM's ``patches`` and an
    encoder-decoder's ``frames`` in the compute dtype, as tensors on the
    ``meta`` device (a shape and a dtype, no storage)."""
    B, S = shape.global_batch, shape.seq_len
    cd = getattr(torch, cfg.compute_dtype)

    def leaf(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    batch = {"tokens": leaf((B, S), torch.int32),
             "labels": leaf((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = leaf((B, cfg.n_patches, cfg.d_model), cd)
    if cfg.family == "encdec":
        batch["frames"] = leaf((B, cfg.encoder_frames, cfg.d_model), cd)
    return batch
