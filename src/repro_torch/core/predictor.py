"""Implementation enumeration + performance prediction (paper §4.2).

For each Fusion we enumerate *implementations* — the TPU analogue of the
paper's (calling order, routine variant, block size, serial iterations):

* a **grid order**: permutation of the fusion's iteration axes
  (outermost→innermost).  The innermost axes act as the paper's "serial
  iterations"; reductions whose reduce axes form the innermost suffix can
  accumulate in VMEM ("accumulable outputs"), otherwise they emit
  per-grid-cell partials combined by a follow-up step (the paper's
  "extra kernel" reduction finalization, §3.2.2(i)).
* **block sizes** per axis (must divide the axis size and respect the
  128-lane / 8-sublane TPU tiling, the analogue of the paper's
  32-element granularity).

The predicted runtime is the paper's model:  ``t = max(t_transfer,
t_compute) + t_launch`` assuming full overlap of DMA and compute
(§4.2 "we assume full overlap of computation and data transfers").
Dominated implementations (no better on traffic, flops and VMEM) are
pruned, as the paper prunes implementations using more on-chip memory.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np

from .fusion import Fusion, call_phases, consumed_reductions
from .graph import Graph, Var

@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Machine constants feeding ``t_pred`` (defaults: one TPU v5e core).

    The constants are the reference's ``V5E`` values, copied verbatim so
    that the search here picks exactly the plans the reference picks.
    Calibrated constants for the H100 (``calibrate``/``refit``) come
    with the autotune slice of the port."""

    name: str = "tpu_v5e"
    peak_flops: float = 197e12          # bf16; f32 ~ 98 TF/s, see scale below
    f32_scale: float = 0.5              # MXU f32 derate
    hbm_bw: float = 819e9               # bytes/s
    vmem_bytes: int = 64 * 1024 * 1024  # usable VMEM budget (of 128 MiB)
    launch_overhead_s: float = 2e-6     # per-kernel dispatch cost
    # minimum efficient tile (sublane, lane) for f32
    min_tile: tuple[int, int] = (8, 128)

    def flops_scale(self, dtype) -> float:
        """Compute-rate derate for ``dtype`` relative to ``peak_flops``.

        Sub-4-byte types (bf16/f16/int8) run at peak, 4-byte at
        ``f32_scale``, 8-byte at half that again — the MXU pattern."""
        size = np.dtype(dtype).itemsize
        if size <= 2:
            return 1.0
        if size <= 4:
            return self.f32_scale
        return self.f32_scale / 2.0

    def min_tile_for(self, dtype) -> tuple[int, int]:
        """Minimum efficient (sublane, lane) tile for ``dtype``.

        The lane count is fixed; sublanes scale inversely with itemsize
        so the packed tile stays the same size in bytes: f32 (8, 128),
        bf16 (16, 128), int8 (32, 128)."""
        size = max(1, np.dtype(dtype).itemsize)
        return (max(1, self.min_tile[0] * 4 // size), self.min_tile[1])

    def group_cost(self, traffic_bytes: float, flops: float,
                   dtype=np.float32) -> float:
        """Predicted seconds for one fused group given its §5 features
        — the paper's roofline: ``max(traffic/bw, flops/rate) +
        launch``."""
        t_transfer = traffic_bytes / self.hbm_bw
        t_compute = flops / (self.peak_flops * self.flops_scale(dtype))
        return max(t_transfer, t_compute) + self.launch_overhead_s


V5E = HardwareModel()


def fusion_dtype(f: "Fusion") -> np.dtype:
    """The dtype the cost model charges a fusion at: the widest dtype
    streamed over HBM (inputs or outputs) — mixed-precision fusions are
    dominated by their widest stream."""
    vs = tuple(f.external_inputs) + tuple(f.outputs)
    if not vs:
        return np.dtype(np.float32)
    return max((np.dtype(v.dtype) for v in vs), key=lambda d: d.itemsize)


@dataclasses.dataclass(frozen=True)
class Impl:
    """One concrete implementation of a Fusion."""

    fusion: Fusion
    order: tuple[int, ...]              # axis roots, outermost -> innermost
    blocks: tuple[int, ...]             # block size per axis in `order`
    traffic_bytes: float = 0.0
    flops: float = 0.0
    vmem_bytes: float = 0.0
    t_transfer: float = 0.0
    t_compute: float = 0.0
    t_pred: float = 0.0

    @property
    def grid(self) -> tuple[int, ...]:
        sizes = dict(zip(self.fusion.axis_roots, self.fusion.axis_sizes))
        return tuple(-(-sizes[a] // b) for a, b in zip(self.order, self.blocks))

    def block_of(self, root: int) -> int:
        return self.blocks[self.order.index(root)]

    def describe(self) -> str:
        return (f"{self.fusion!r} order={self.order} blocks={self.blocks} "
                f"grid={self.grid} traffic={self.traffic_bytes/1e6:.2f}MB "
                f"flops={self.flops/1e6:.2f}MF vmem={self.vmem_bytes/1e3:.0f}KB "
                f"t={self.t_pred*1e6:.2f}us")


def _divisor_blocks(size: int, minimum: int, maximum: int | None = None) -> list[int]:
    """Candidate block sizes: divisors of ``size`` that are multiples of
    ``minimum`` (TPU tiling), plus the full size."""
    maximum = maximum or size
    out = []
    b = minimum
    while b <= min(size, maximum):
        if size % b == 0:
            out.append(b)
        b *= 2
    if size <= maximum and size not in out:
        out.append(size)
    return out or [size]


def var_streams(v: Var, g: Graph, order: tuple[int, ...], grid: tuple[int, ...]) -> int:
    """How many times ``v`` is streamed from HBM for a given grid order.

    An input indexed by axis subset S is re-fetched whenever an axis
    outside S, ordered *outer* than the innermost axis of S, advances
    (Pallas refetches a block when its index map output changes).
    """
    s_roots = {g.axis_root(a) for a in v.axis_ids}
    if not s_roots:
        return 1
    pos = {r: i for i, r in enumerate(order)}
    inner_s = max(pos[r] for r in s_roots if r in pos) if any(r in pos for r in s_roots) else -1
    n = 1
    for i, r in enumerate(order):
        if r not in s_roots and i < inner_s:
            n *= grid[i]
    return n


def reduce_roots_of(v: Var, f: Fusion, g: Graph) -> tuple[int, ...]:
    """Fusion axes over which output ``v`` is reduced."""
    s_roots = {g.axis_root(a) for a in v.axis_ids}
    return tuple(r for r in f.axis_roots if r not in s_roots)


def accumulable(v: Var, f: Fusion, g: Graph, order: tuple[int, ...]) -> bool:
    """True iff v's reduce axes are the innermost suffix of the grid order
    — the in-VMEM accumulation case; else partials + combine."""
    rr = set(reduce_roots_of(v, f, g))
    if not rr:
        return True
    k = len(rr)
    return set(order[-k:]) == rr


def cost_impl(f: Fusion, g: Graph, order: tuple[int, ...],
              blocks: tuple[int, ...], hw: HardwareModel) -> Impl:
    sizes = dict(zip(f.axis_roots, f.axis_sizes))
    grid = tuple(-(-sizes[a] // b) for a, b in zip(order, blocks))
    blk = dict(zip(order, blocks))

    # in-kernel reduce consumption forces a leading phase grid axis: the
    # kernel re-streams every input and recomputes every map value once
    # per phase (rematerialization — DESIGN.md §2), so inputs and flops
    # are charged n_phases times; each consumed reduction additionally
    # holds its FULL finished value in a VMEM scratch accumulator
    consumed = consumed_reductions(f, g)
    n_phases = call_phases(f, g)[1] if consumed else 1

    # ---- traffic ----------------------------------------------------------
    traffic = 0.0
    for v in f.external_inputs:
        traffic += v.nbytes * var_streams(v, g, order, grid) * n_phases
    for v in f.outputs:
        rr = reduce_roots_of(v, f, g)
        if not rr or accumulable(v, f, g, order):
            traffic += v.nbytes
        else:
            nparts = math.prod(grid[order.index(r)] for r in rr)
            traffic += v.nbytes * (2 * nparts + 1)  # write parts, read parts, write final

    # ---- flops ------------------------------------------------------------
    flops = n_phases * sum(c.elem.flops(c.axis_sizes) for c in f.calls)

    # ---- VMEM footprint (double-buffered blocks) ---------------------------
    def block_bytes(v: Var) -> float:
        n = v.dtype.itemsize
        for a in v.axis_ids:
            r = g.axis_root(a)
            n *= blk.get(r, 1)
        sub, lane = hw.min_tile_for(v.dtype)
        return max(n, v.dtype.itemsize * sub * lane)

    vmem = 0.0
    for v in f.external_inputs:
        vmem += 2 * block_bytes(v)
    for v in f.outputs:
        vmem += 2 * block_bytes(v)
    for v in f.internal_vars:
        vmem += block_bytes(v)
    for c in consumed:
        # full-size scratch accumulator carrying the finished reduction
        v = c.out
        sub, lane = hw.min_tile_for(v.dtype)
        vmem += max(v.nbytes, v.dtype.itemsize * sub * lane)

    dt = fusion_dtype(f)
    t_t = traffic / hw.hbm_bw
    t_c = flops / (hw.peak_flops * hw.flops_scale(dt))
    t = hw.group_cost(traffic, flops, dt)
    return Impl(fusion=f, order=order, blocks=blocks, traffic_bytes=traffic,
                flops=flops, vmem_bytes=vmem, t_transfer=t_t, t_compute=t_c,
                t_pred=t)


def enumerate_impls(f: Fusion, g: Graph, hw: HardwareModel = V5E,
                    max_impls: int = 64) -> list[Impl]:
    """All (order × block) implementations of a fusion, pruned.

    Pruning (paper §4.2): drop implementations that exceed the VMEM
    budget (the occupancy analogue) and Pareto-dominated ones.

    Fusions that consume a reduction in-kernel (fusion rule 2, relaxed)
    only admit grid orders under which every consumed reduction is
    ``accumulable`` (reduce axes an innermost suffix) — the orders the
    multi-phase pallas kernel can actually emit.  Rule 2's chain
    condition guarantees at least one such order exists; if VMEM
    pruning still empties the list, ``build_space`` drops the fusion
    and the partition search covers its calls with smaller groups (the
    group-split fallback, DESIGN.md §2).
    """
    roots, sizes = f.axis_roots, f.axis_sizes
    depth = len(roots)
    dt = fusion_dtype(f)
    min_tile = hw.min_tile_for(dt)
    consumed = consumed_reductions(f, g)
    cands: list[Impl] = []
    if depth == 1:
        min_b = min_tile[1]
        for b in _divisor_blocks(sizes[0], min_b, maximum=1 << 22):
            cands.append(cost_impl(f, g, roots, (b,), hw))
    else:
        # the last two canonical axes are the in-memory (sublane, lane)
        # pair and carry the tiling minima; axes above them (depth >= 3:
        # batch-like dims) may block at any divisor
        mins = [1] * (depth - 2) + [min_tile[0], min_tile[1]]
        blocks_per_axis = [
            _divisor_blocks(sizes[k], mins[k], maximum=1 << 16)
            for k in range(depth)
        ]
        for order in itertools.permutations(range(depth)):
            o_roots = tuple(roots[i] for i in order)
            if consumed and any(not accumulable(c.out, f, g, o_roots)
                                for c in consumed):
                continue  # the phase kernel cannot carry the value
            for bs in itertools.product(*(blocks_per_axis[i] for i in order)):
                cands.append(cost_impl(f, g, o_roots, bs, hw))

    cands = [c for c in cands if c.vmem_bytes <= hw.vmem_bytes]
    if not cands:
        return []
    # Pareto prune on (traffic, vmem); flops identical across impls
    cands.sort(key=lambda c: (c.t_pred, c.vmem_bytes))
    kept: list[Impl] = []
    for c in cands:
        if any(k.traffic_bytes <= c.traffic_bytes and k.vmem_bytes <= c.vmem_bytes
               and (k.traffic_bytes, k.vmem_bytes) != (c.traffic_bytes, c.vmem_bytes)
               for k in kept):
            continue
        if any(k.traffic_bytes == c.traffic_bytes and k.vmem_bytes == c.vmem_bytes
               for k in kept):
            continue
        kept.append(c)
        if len(kept) >= max_impls:
            break
    return kept
