"""The runtime of sharded training on ``torch.distributed``: where each
rank's piece of a leaf lies (``Layout``), the process-group view of a
mesh that a sharded step runs on (``Spmd``), the differentiable
collectives of the expert-parallel MoE, and ``run_ranks``, which starts
a group of ranks over a ``FileStore``.

A leaf's global tensor is cut first over ``model`` (``model_dim``: the
expert dim of an expert leaf on the expert-parallel path) and then, the
model-local tensor, over the data-parallel ranks (``dp_dim``: the dim
the reference's FSDP spec gives its data-parallel axes); each cut takes
``torch.chunk``'s pieces, which the builders keep even (a dim is cut
only where it divides).  ``Layout.local`` takes a rank's piece of a
global tensor, ``Layout.gather`` joins the pieces again.

``Spmd`` flattens the mesh's data-parallel axes (``pod`` and ``data``)
into one: its ``mesh`` is a ``DeviceMesh`` of the same ranks with axes
``("data", "model")``, which the FSDP wrapping, the gathers and the
MoE layers use.  ``rows`` says over which ranks the batch rows differ
(the MoE load-balance term averages over them); ``tp``, where a dense
or MoE config's forward is split over the ``model`` ranks
(``TensorParallel``: heads, MLP columns, experts or their hidden
columns and vocabulary blocks, the residual stream cut along the
sequence between them, ``gather_seq``/``scatter_seq``).

Two conventions meet on a ``model`` axis.  Under ``TensorParallel`` a
tensor every rank holds whole (a gathered stream, a weight) takes on
each rank the gradient of that rank's use of it, and the ranks'
gradients are summed once (partial gradients).  The expert-parallel
MoE layer (``dist.moe_ep``) computes its replicated tensors alike on
every rank and hands each rank the whole gradient.  ``grad_once`` and
``as_partial`` join them: the first counts a whole gradient on one rank
only, the second turns a tensor every rank holds whole into the ranks'
partial sums of it.

Tensor-parallel serving (``launch.serve``, ``train.steps.serving_spmd``)
runs on the same view, each rank holding only its blocks
(``TensorParallel.blocks``); its decode step's collectives carry no
autograd: ``sum_over_model`` (the row-split outputs added in float32),
``gather_vocab`` (the logits' blocks joined) and, at the prefill,
``last_position``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import tempfile
import time
from typing import Any, Callable

import torch

from .sharding import axis_names, dp_axes, mesh_axis_sizes


# ---------------------------------------------------------------------------
# where a rank's piece lies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """A leaf of global ``shape`` cut over ``model`` on ``model_dim``,
    then over the data-parallel ranks on ``dp_dim`` (None: not cut)."""

    shape: tuple
    dp_dim: int | None = None
    model_dim: int | None = None

    def local_shape(self, spmd) -> tuple:
        s = list(self.shape)
        if self.model_dim is not None:
            s[self.model_dim] //= spmd.mp
        if self.dp_dim is not None:
            s[self.dp_dim] //= spmd.dpn
        return tuple(s)

    def local(self, full: torch.Tensor, spmd, over_model=True
              ) -> torch.Tensor:
        """This rank's piece of the global ``full`` (a fresh contiguous
        tensor); ``over_model=False``: of the model-local ``full``, cut
        over the data-parallel ranks only."""
        t = full
        if over_model and self.model_dim is not None and spmd.mp > 1:
            t = t.chunk(spmd.mp, self.model_dim)[spmd.model_rank]
        if self.dp_dim is not None and spmd.dpn > 1:
            t = t.chunk(spmd.dpn, self.dp_dim)[spmd.dp_rank]
        return t.clone() if t is full else t.contiguous().clone()

    def gather(self, local: torch.Tensor, spmd, over_model=True
               ) -> torch.Tensor:
        """The global tensor from every rank's piece (``local``, a DTensor
        read as its local tensor); ``over_model=False`` joins the
        data-parallel pieces only (the model-local tensor).  Every rank
        of the groups takes part."""
        t = local.to_local() if hasattr(local, "to_local") else local
        t = t.detach()
        if self.dp_dim is not None and spmd.dpn > 1:
            t = all_gather_cat(t, self.dp_dim, spmd.dp_group, spmd.dpn)
        if over_model and self.model_dim is not None and spmd.mp > 1:
            t = all_gather_cat(t, self.model_dim, spmd.model_group, spmd.mp)
        return t


def all_gather_cat(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` joined along ``dim``, in rank
    order."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# the process-group view of a mesh
# ---------------------------------------------------------------------------

class Spmd:
    """The ranks of ``mesh`` (a ``DeviceMesh`` over every rank of the
    process group, axes ``data``/``model`` or ``pod``/``data``/``model``)
    as a sharded step uses them: ``dpn`` data-parallel ranks (``pod`` x
    ``data``) and ``mp`` model ranks, this rank's ``dp_rank`` and
    ``model_rank``, their groups, and ``mesh``, the ``("data",
    "model")`` ``DeviceMesh`` of the same ranks (``pod`` and ``data``
    flattened into ``data``).  ``rows``: the ranks over which the batch
    rows differ, set by the step (None while every rank holds the same
    rows; the MoE load-balance term averages over them)."""

    def __init__(self, mesh):
        from torch.distributed.device_mesh import DeviceMesh
        sizes = mesh_axis_sizes(mesh)
        unknown = set(axis_names(mesh)) - {"pod", "data", "model"}
        if unknown:
            raise ValueError(f"mesh axes {axis_names(mesh)}: a training "
                             f"mesh has pod, data and model axes only")
        self.source = mesh
        self.dpn = math.prod(sizes[a] for a in dp_axes(mesh))
        self.mp = sizes.get("model", 1)
        ranks = mesh.mesh.reshape(self.dpn, self.mp)
        self.mesh = DeviceMesh(mesh.device_type, ranks,
                               mesh_dim_names=("data", "model"))
        self.dp_mesh, self.model_mesh = self.mesh["data"], self.mesh["model"]
        self.dp_group = self.dp_mesh.get_group()
        self.model_group = self.model_mesh.get_group()
        self.dp_rank = self.dp_mesh.get_local_rank()
        self.model_rank = self.model_mesh.get_local_rank()
        self.world = self.dpn * self.mp
        self.rows: RowGroup | None = None
        self.tp: TensorParallel | None = None

    def describe(self) -> dict:
        return mesh_axis_sizes(self.source)


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The ``n`` ranks of ``group`` hold different rows of the batch."""

    group: Any
    n: int


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``n`` ranks of ``group`` (this one ``rank``) hold the same rows
    and split a dense or MoE layer between them (serving: an ssm or
    encdec layer too), as the reference's ``tp`` constraints place it:
    each computes its block of the query heads (and the KV heads those
    read; MLA's latent whole), of the MLP's columns, of the experts or
    of their hidden columns, of the SSD heads, and of the vocabulary,
    and holds its block of the sequence of the residual stream between
    the layers.  A tensor every rank holds whole takes
    on each rank only the gradient of this rank's use of it (a partial
    gradient); the blocks are disjoint, so the gradients summed over
    the ranks once are the whole."""

    group: Any
    n: int
    rank: int
    #: the layers are handed this rank's blocks of the weights (serving:
    #: each rank holds only its blocks, ``dist.sharding.param_block``),
    #: not the whole weights to cut them from (training: FSDP2 gathers
    #: whole ones)
    blocks: bool = False

    def block(self, size: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``size``, cut as ``torch.tensor_split``
        cuts it into ``n`` (the first ``size % n`` blocks one longer)."""
        q, r = divmod(size, self.n)
        lo = self.rank * q + min(self.rank, r)
        return lo, lo + q + (self.rank < r)


@dataclasses.dataclass
class StateShardings:
    """Where each rank's pieces of a sharded train state lie: ``tree``,
    the state's structure (``params``, ``params_c``, ``opt`` with ``m``,
    ``v`` and ``step``) with a ``Layout`` a leaf (an int8 moment's
    ``{"q", "scale"}`` a ``Layout`` each), on ``spmd``'s ranks.
    ``rows_over_model``: the ``model`` ranks hold different rows too
    (tensor parallelism off), and the gradients are summed over them.
    ``tp``: the ``model`` ranks split a dense or MoE config's forward
    (``TensorParallel``); each rank's gradients are partial, and are
    summed over them too.  ``tree["params_c"]`` is the compute copy's
    layout: the masters' but whole over ``model`` where the copy holds
    a leaf whole (``train.steps``)."""

    spmd: Spmd
    tree: dict
    rows_over_model: bool = False
    tp: TensorParallel | None = None

    def counted(self) -> set:
        """The parameters whose pieces count toward the gradient norm on
        this rank: a piece the ranks of an axis share counts on the
        axis's rank 0 only."""
        sp = self.spmd
        out = set()
        for name, lay in self.tree["params"].items():
            if lay.dp_dim is None and sp.dpn > 1 and sp.dp_rank:
                continue
            if lay.model_dim is None and sp.mp > 1 and sp.model_rank:
                continue
            out.add(name)
        return out


_SPMD: list = []


def current_spmd():
    """The ``Spmd`` a sharded step runs under (``running``), or None."""
    return _SPMD[-1] if _SPMD else None


class running:
    """Context: ``spmd`` is current, and its ``mesh`` the ambient mesh."""

    def __init__(self, spmd: Spmd):
        self.spmd = spmd

    def __enter__(self):
        from .sharding import use_mesh
        _SPMD.append(self.spmd)
        self._mesh = use_mesh(self.spmd.mesh)
        self._mesh.__enter__()
        return self.spmd

    def __exit__(self, *exc):
        self._mesh.__exit__(*exc)
        _SPMD.pop()


# ---------------------------------------------------------------------------
# differentiable collectives over a group of ranks that compute the same
# value (a value replicated over the group)
# ---------------------------------------------------------------------------

class _Chunk(torch.autograd.Function):
    """Forward: this rank's rows ``[lo, lo + size)`` of a replicated ``x``
    along dim 0, zero-padded to ``size``.  Backward: every rank's rows'
    gradients gathered, so the replicated ``x`` gets its whole gradient
    on every rank."""

    @staticmethod
    def forward(ctx, x, rank: int, size: int, group, n: int):
        ctx.meta = (x.shape[0], size, group, n)
        part = x[rank * size:(rank + 1) * size]
        if part.shape[0] < size:
            pad = x.new_zeros((size - part.shape[0],) + tuple(x.shape[1:]))
            part = torch.cat([part, pad])
        return part.contiguous()

    @staticmethod
    def backward(ctx, g):
        rows, size, group, n = ctx.meta
        return all_gather_cat(g, 0, group, n)[:rows], None, None, None, None


class _Join(torch.autograd.Function):
    """Forward: every rank's ``size`` rows joined along dim 0 in rank
    order, the first ``rows`` kept (a replicated result).  Backward:
    this rank's rows of the replicated gradient."""

    @staticmethod
    def forward(ctx, part, rank: int, rows: int, group, n: int):
        ctx.meta = (rank, part.shape[0], rows)
        return all_gather_cat(part, 0, group, n)[:rows]

    @staticmethod
    def backward(ctx, g):
        rank, size, rows = ctx.meta
        out = g.new_zeros((size,) + tuple(g.shape[1:]))
        part = g[rank * size:(rank + 1) * size]
        out[:part.shape[0]] = part
        return out, None, None, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over the
    group, for a replicated tensor of which each rank uses a part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOver(torch.autograd.Function):
    """Forward: the mean of ``x`` over the ``n`` ranks of the group, each
    holding its own rows' ``x``.  Backward: this rank's share, the
    gradient over ``n`` (each rank's loss carries the mean once)."""

    @staticmethod
    def forward(ctx, x, group, n: int):
        import torch.distributed as dist
        ctx.n = n
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def reduce_scatter_cat(t: torch.Tensor, dim: int, group, n: int
                       ) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` summed, and this rank's block of
    the sum along ``dim`` (which ``n`` divides)."""
    import torch.distributed as dist
    size = t.shape[dim] // n
    parts = t.unflatten(dim, (n, size)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1), group=group)
    return out


class _GatherSeq(torch.autograd.Function):
    """Sequence to tensor parallelism (the reference's SP gather of the
    post-norm ``h``): forward, every rank's block of ``dim`` joined in
    rank order; backward, the ranks' partial gradients of the whole
    summed and cut back to this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim: int, group, n: int):
        ctx.meta = (dim, group, n)
        return all_gather_cat(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.meta
        return reduce_scatter_cat(g, dim, group, n), None, None, None


class _ScatterSeq(torch.autograd.Function):
    """Tensor to sequence parallelism (the reference's SP reduce-scatter
    after a row-split matmul): forward, the ranks' partial sums summed
    and cut to this rank's block of ``dim``; backward, every rank's
    block of the gradient joined (an all-gather), the gradient of this
    rank's partial sum."""

    @staticmethod
    def forward(ctx, x, dim: int, group, n: int):
        ctx.meta = (dim, group, n)
        return reduce_scatter_cat(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.meta
        return all_gather_cat(g, dim, group, n), None, None, None


class _GradOnce(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient on the group's first
    rank, zeros on the others."""

    @staticmethod
    def forward(ctx, x, first: bool):
        ctx.first = first
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


class _AsPartial(torch.autograd.Function):
    """Forward: ``x`` on the group's first rank, zeros on the others.
    Backward: the identity."""

    @staticmethod
    def forward(ctx, x, first: bool):
        return x.view_as(x) if first else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def grad_once(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x``, a tensor every rank of ``tp`` holds whole, whose use on each
    rank yields the whole gradient (a replicated computation: the MoE
    load-balance term, ``dist.moe_ep``'s inputs): the gradient passes
    on the first rank only, so the ranks' partial gradients sum to it
    once."""
    return _GradOnce.apply(x, tp.rank == 0)


def as_partial(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``x``, a result every rank of ``tp`` holds whole, as the ranks'
    partial sums of it (``x`` on the first rank, zeros on the others),
    for ``scatter_seq`` to add; each rank takes the whole gradient of
    the sum, which ``x``'s producer holds on every rank."""
    return _AsPartial.apply(x, tp.rank == 0)


def gather_seq(x: torch.Tensor, tp: TensorParallel, dim: int = 1):
    """``x`` (B, S/n, ...) of each rank joined into (B, S, ...)
    (``_GatherSeq``)."""
    return _GatherSeq.apply(x, dim, tp.group, tp.n)


def scatter_seq(x: torch.Tensor, tp: TensorParallel, dim: int = 1):
    """The ranks' partial sums ``x`` (B, S, ...) summed, this rank's
    (B, S/n, ...) block of the sum (``_ScatterSeq``)."""
    return _ScatterSeq.apply(x, dim, tp.group, tp.n)


# ---------------------------------------------------------------------------
# the serving collectives of tensor parallelism: no autograd; c10d orders
# each on the current stream (NCCL's stream joined to it by events, which
# a CUDA graph capture records), so a captured decode step replays them
# ---------------------------------------------------------------------------

def sum_over_model(x: torch.Tensor, tp: TensorParallel, dtype
                   ) -> torch.Tensor:
    """The ranks' partial sums ``x`` (a row-split matmul's float32 output,
    ``models.common.partial_matmul``: ``wo``'s, ``wd``'s) added in
    float32 over ``tp``'s group (in place), rounded once to ``dtype``:
    every rank gets the same sum."""
    import torch.distributed as dist
    y = x.to(torch.float32)
    dist.all_reduce(y, group=tp.group)
    return y.to(dtype)


def gather_vocab(x: torch.Tensor, tp: TensorParallel, size: int
                 ) -> torch.Tensor:
    """Every rank's block ``x`` (..., hi - lo) of a last dim of ``size``
    cut as ``TensorParallel.block`` cuts it, joined in rank order into
    (..., size) on every rank.  Blocks one shorter than the first (the
    ranks do not divide ``size``) are padded for the gather and cut
    after it."""
    width = -(-size // tp.n)
    if x.shape[-1] < width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    parts = all_gather_cat(x, x.dim() - 1, tp.group, tp.n).split(width, -1)
    return torch.cat([p[..., :hi - lo] for p, (lo, hi) in zip(
        parts, (dataclasses.replace(tp, rank=r).block(size)
                for r in range(tp.n)))], -1)


def last_position(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The last position (B, 1, D) of a stream cut along the sequence
    over ``tp``'s ranks (x: this rank's (B, S/n, D) block): the last
    rank's last row, on every rank."""
    last = all_gather_cat(x[:, -1:].contiguous(), 1, tp.group, tp.n)
    return last[:, -1:].contiguous()


def chunk_rows(x, rank, size, group, n):
    return _Chunk.apply(x, rank, size, group, n)


def join_rows(part, rank, rows, group, n):
    return _Join.apply(part, rank, rows, group, n)


def sum_grad(x, group):
    return _SumGrad.apply(x, group)


def mean_over(x, group, n):
    return _MeanOver.apply(x, group, n)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal blocks; its gradient is the same
    exchange of the output's gradient (block i back to rank i)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` (n equal blocks along dim 0, block
    i to rank i) with its gradient (the reverse exchange)."""
    return _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, backend: str, store: str, out: str,
               job: str):
    import torch.distributed as dist
    with open(job, "rb") as f:
        fn, args = pickle.load(f)
    if backend == "gloo":
        torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        if dist.is_initialized():     # fn may end the group itself
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, world: int, *args, backend: str = "gloo",
              timeout_s: float = 600.0, tmpdir: str | None = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (spawned)
    joined in one process group over a ``FileStore`` in a temporary
    directory (``backend`` ``"gloo"`` on the CPU, one thread a rank;
    ``"nccl"`` with rank r on ``cuda:r``).  Returns the ranks' results
    in rank order (``fn`` and its results must pickle; ``fn`` may end
    the group and go on alone).  Raises
    ``RuntimeError`` when a rank fails or the ranks outlast
    ``timeout_s``; every process is ended before it returns."""
    import torch.multiprocessing as mp
    env = {"OMP_NUM_THREADS": "1"} if backend == "gloo" else {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(dir=tmpdir) as d:
            store, out = os.path.join(d, "store"), os.path.join(d, "out")
            job = os.path.join(d, "job")    # read by each rank: faster
            with open(job, "wb") as f:      # than the spawn's own pipe
                pickle.dump((fn, args), f)
            ctx = mp.start_processes(
                _rank_main, args=(world, backend, store, out, job),
                nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + timeout_s
            try:
                while not ctx.join(timeout=max(0.1, min(
                        5.0, deadline - time.monotonic()))):
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"run_ranks: {world} ranks "
                                           f"outlasted {timeout_s} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
            results = []
            for r in range(world):
                with open(f"{out}.{r}", "rb") as f:
                    results.append(pickle.load(f))
            return results
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"run_ranks: a rank failed:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"run_ranks: a rank exited: {e}") from None
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
