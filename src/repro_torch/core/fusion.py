"""Fusion legality + optimization-space generation (paper §3.2, §4.2).

A *fusion* is a subset of the call DAG that can be glued into one kernel.
Legality rules, transposed from CUDA thread blocks to Pallas grids:

1. **Same iteration space.**  All calls in a fusion must iterate over the
   same unified axis set (paper: same thread-block-to-data mapping; also
   subsumes "never fuse different nesting depths", §3.2.3).
2. **Reduce consumption needs phases.**  The *finished* result of a
   reduction is only available once its reduce axes complete, which on
   CUDA meant a global barrier (= kernel boundary, §3.2.2).  The
   reference's Pallas backend uses a leading *phase* grid axis instead;
   this package's generated CUDA kernel (K1) keeps one kernel and puts a
   grid-wide barrier between phases: phase p accumulates the reduction
   into a workspace, phase p+1 reads the finished value back.  That requires a
   grid order with every consumed reduction's reduce axes as an
   innermost suffix, so a producer→consumer edge from a reduction is
   legal iff the consumed reduce-axis sets form a chain under inclusion
   (some order then serves them all).  Groups with no such order are
   rejected here — the documented *group-split*: the partition search
   simply covers those calls with smaller fusions.
3. **Convexity.**  No path from a fusion member to another fusion member
   may leave the fusion (the outside node could not be scheduled).
4. **Connectivity / usefulness.**  Members must be connected through
   shared data (an internal edge or a shared input array); anything else
   spares no memory transfers and is pruned (§4.2).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable

from .graph import CallNode, Graph, Var


@dataclasses.dataclass(frozen=True)
class Fusion:
    """A legal fusible subgraph: frozenset of call indices."""

    calls: tuple[CallNode, ...]            # topo order
    axis_roots: tuple[int, ...]            # unified iteration axes (sorted)
    axis_sizes: tuple[int, ...]
    internal_vars: tuple[Var, ...]         # stay in VMEM
    external_inputs: tuple[Var, ...]       # streamed from HBM
    outputs: tuple[Var, ...]               # written to HBM

    @property
    def key(self) -> frozenset:
        return frozenset(c.idx for c in self.calls)

    @property
    def depth(self) -> int:
        return len(self.axis_roots)

    def __repr__(self):
        names = "+".join(c.elem.name for c in self.calls)
        return f"Fusion[{names}]"


def consumed_reductions(f: Fusion, g: Graph) -> tuple[CallNode, ...]:
    """Reduction members whose output is consumed *inside* ``f`` — the
    calls whose finished value a multi-phase pallas kernel must carry in
    a VMEM scratch accumulator (rule 2, relaxed)."""
    idxset = {c.idx for c in f.calls}
    return tuple(c for c in f.calls if c.elem.is_reduction
                 and any(cc.idx in idxset for cc in g.consumers(c.out)))


def call_phases(f: Fusion, g: Graph) -> tuple[dict[int, int], int]:
    """Phase assignment for a (possibly multi-phase) kernel body.

    ``phase(c)`` is the max over c's in-fusion producers p of
    ``phase(p) + 1`` if p is a consumed reduction (its finished value
    only becomes visible one full grid sweep later) else ``phase(p)``;
    calls fed only by external inputs are phase 0.  Returns
    ``(call idx -> phase, n_phases)``; ``n_phases == 1`` means the
    group needs no phase axis (the single-sweep kernel)."""
    consumed = {c.idx for c in consumed_reductions(f, g)}
    producer = {c.out: c for c in f.calls}
    phase: dict[int, int] = {}
    for c in f.calls:
        p = 0
        for a in c.args:
            pc = producer.get(a)
            if pc is not None:
                p = max(p, phase[pc.idx] + (1 if pc.idx in consumed else 0))
        phase[c.idx] = p
    n_phases = 1 + (max(phase.values()) if phase else 0)
    return phase, n_phases


def _reachability(g: Graph) -> dict[int, set[int]]:
    """call idx -> set of call idxs reachable (downstream)."""
    reach: dict[int, set[int]] = {c.idx: set() for c in g.calls}
    for c in reversed(g.calls):
        for consumer in g.consumers(c.out):
            reach[c.idx].add(consumer.idx)
            reach[c.idx] |= reach[consumer.idx]
    return reach


def analyse_group(g: Graph, members: Iterable[CallNode],
                  reach: dict[int, set[int]] | None = None) -> Fusion | None:
    """Return a Fusion if ``members`` is legal, else None."""
    members = sorted(set(members), key=lambda c: c.idx)
    if not members:
        return None
    idxset = {c.idx for c in members}

    # rule 1: identical unified axis sets
    ref_roots = None
    for c in members:
        roots = tuple(sorted(g.call_axis_roots(c)))
        if len(set(roots)) != len(roots):
            return None  # degenerate: same axis twice
        if ref_roots is None:
            ref_roots = roots
        elif roots != ref_roots:
            return None
    root_to_size = {}
    for c in members:
        for r, s in zip(g.call_axis_roots(c), c.axis_sizes):
            root_to_size[r] = s

    # rule 2 (relaxed): a reduction output consumed inside the fusion is
    # legal iff every consumed reduce-axis set can sit as an innermost
    # suffix of ONE grid order — i.e. the consumed sets form a chain
    # under inclusion.  Codegen then emits a multi-phase kernel carrying
    # the finished value in VMEM scratch; otherwise the group is
    # rejected and the partition search falls back to smaller fusions
    # (the documented group-split, DESIGN.md §2).
    rootset = set(ref_roots)
    consumed_sets: list[set[int]] = []
    for c in members:
        if not c.elem.is_reduction:
            continue
        if any(cc.idx in idxset for cc in g.consumers(c.out)):
            out_roots = {g.axis_root(a) for a in c.out.axis_ids}
            consumed_sets.append(rootset - out_roots)
    consumed_sets.sort(key=len)
    for small, big in zip(consumed_sets, consumed_sets[1:]):
        if not small <= big:
            return None

    # rule 3: convexity
    if reach is None:
        reach = _reachability(g)
    for p in members:
        for c in members:
            if p.idx >= c.idx:
                continue
            for mid in g.calls:
                if mid.idx in idxset:
                    continue
                if mid.idx in reach[p.idx] and c.idx in reach[mid.idx]:
                    return None

    # rule 4: connectivity via shared vars
    if len(members) > 1:
        adj: dict[int, set[int]] = {c.idx: set() for c in members}
        var_users: dict[Var, list[int]] = {}
        for c in members:
            touched = list(c.args) + [c.out]
            for v in touched:
                var_users.setdefault(v, []).append(c.idx)
        for users in var_users.values():
            for a, b in itertools.combinations(set(users), 2):
                adj[a].add(b)
                adj[b].add(a)
        seen = {members[0].idx}
        stack = [members[0].idx]
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        if len(seen) != len(members):
            return None

    # classify vars
    produced = {c.out for c in members}
    internal, outputs = [], []
    for c in members:
        v = c.out
        consumed_outside = any(cc.idx not in idxset for cc in g.consumers(v))
        if g.escapes(v) or consumed_outside:
            outputs.append(v)
        else:
            internal.append(v)
    ext_inputs: list[Var] = []
    seen_vars = set()
    for c in members:
        for a in c.args:
            if a not in produced and a not in seen_vars:
                seen_vars.add(a)
                ext_inputs.append(a)

    roots = ref_roots or ()
    return Fusion(
        calls=tuple(members),
        axis_roots=roots,
        axis_sizes=tuple(root_to_size[r] for r in roots),
        internal_vars=tuple(internal),
        external_inputs=tuple(ext_inputs),
        outputs=tuple(outputs),
    )


def saves_traffic(f: Fusion, g: Graph) -> bool:
    """Paper §4.2: prune fusions which do not spare memory transfers.

    A fusion spares traffic iff it has an internal var (store+load saved)
    or two members share an external input (load saved).
    """
    if len(f.calls) == 1:
        return True  # singleton "fusion" == unfused kernel, always kept
    if f.internal_vars:
        return True
    produced = {c.out for c in f.calls}
    for c in f.calls:
        if any(a in produced for a in c.args):
            return True  # consumer reads producer via VMEM (even if the
            #              value also escapes to HBM, its reload is spared)
    use_count: dict[Var, int] = {}
    for c in f.calls:
        for a in set(c.args):
            use_count[a] = use_count.get(a, 0) + 1
    return any(n > 1 for n in use_count.values())


def enumerate_fusions(g: Graph, max_size: int = 8) -> list[Fusion]:
    """All legal fusions (incl. singletons), traffic-sparing ones only.

    Scripts are small (the paper's largest, GEMVER, has a handful of
    calls), so for n <= 16 we exhaustively test every subset; beyond that
    we grow connected subsets breadth-first.
    """
    reach = _reachability(g)
    calls = g.calls
    n = len(calls)
    out: list[Fusion] = []
    if n <= 16:
        for r in range(1, min(max_size, n) + 1):
            for combo in itertools.combinations(calls, r):
                f = analyse_group(g, combo, reach)
                if f is not None and saves_traffic(f, g):
                    out.append(f)
        return out
    # BFS growth fallback for large graphs (may miss exotic convex sets
    # reachable only through non-convex intermediates; acceptable heuristic)
    seen: set[frozenset] = set()
    frontier: list[tuple[CallNode, ...]] = []
    for c in calls:
        f = analyse_group(g, (c,), reach)
        assert f is not None
        out.append(f)
        seen.add(f.key)
        frontier.append((c,))
    while frontier:
        nxt: list[tuple[CallNode, ...]] = []
        for grp in frontier:
            if len(grp) >= max_size:
                continue
            for c in calls:
                if c in grp:
                    continue
                cand = tuple(sorted(set(grp) | {c}, key=lambda x: x.idx))
                key = frozenset(x.idx for x in cand)
                if key in seen:
                    continue
                seen.add(key)
                f = analyse_group(g, cand, reach)
                if f is None:
                    continue
                nxt.append(cand)
                if saves_traffic(f, g):
                    out.append(f)
        frontier = nxt
    return out
