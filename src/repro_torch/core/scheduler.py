"""Combination selection (paper §4.2, third step).

A *combination of fusion implementations* is a partition of the call DAG
into legal fusions (each with a chosen implementation) covering every
call exactly once.  The seed searched the partition lattice by exhaustive
DFS; that is exponential in the number of partitions and dies on graphs
past a dozen calls.  This module replaces it with a layered search that
scales (DESIGN.md §3):

* ``best_combination`` — memoized dynamic program over *covered-call
  bitmasks*.  Extending always the lowest uncovered call makes the
  partition lattice a DAG on masks; the optimal completion cost of a mask
  is independent of how it was reached, so the DP is exact while visiting
  each reachable mask once.  Exact for ``n <= exact_threshold`` (default
  20); above that a level-synchronous beam over popcount levels bounds
  work (width configurable), trading exactness for scale.
* ``enumerate_combinations`` — lazy k-best enumeration: an A* search over
  (mask, impl-assignment) states whose heuristic is the DP's exact
  completion cost, with lazy sibling expansion over per-fusion
  implementation variants (the paper's Table 4/5 empirical-search mode).
  Combinations stream out in exactly nondecreasing ``t_pred`` order, so
  asking for the k best does O(k·branch) work instead of materialising
  the whole space.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

from .diagnostics import VerificationError
from .fusion import Fusion, enumerate_fusions
from .graph import Graph
from .predictor import V5E, HardwareModel, Impl, enumerate_impls

#: graphs up to this many calls are searched exactly; above, beam-pruned.
EXACT_THRESHOLD = 20
#: beam width (masks kept per popcount level) for large graphs.
BEAM_WIDTH = 512
#: safety cap on enumeration when ``limit`` is None.
ENUMERATE_CAP = 100_000


@dataclasses.dataclass
class Combination:
    impls: tuple[Impl, ...]
    t_pred: float

    def describe(self) -> str:
        lines = [f"combination t_pred={self.t_pred*1e6:.2f}us"]
        for im in self.impls:
            lines.append("  " + im.describe())
        return "\n".join(lines)


@dataclasses.dataclass
class OptimizationSpace:
    graph: Graph
    fusions: list[Fusion]
    impls_by_fusion: dict[frozenset, list[Impl]]

    @property
    def n_impls(self) -> int:
        return sum(len(v) for v in self.impls_by_fusion.values())


def build_space(g: Graph, hw: HardwareModel = V5E, max_impls_per_fusion: int = 64
                ) -> OptimizationSpace:
    fusions = enumerate_fusions(g)
    impls = {}
    for f in fusions:
        lst = enumerate_impls(f, g, hw, max_impls=max_impls_per_fusion)
        if lst:
            impls[f.key] = lst
    fusions = [f for f in fusions if f.key in impls]
    return OptimizationSpace(graph=g, fusions=fusions, impls_by_fusion=impls)


# ---------------------------------------------------------------------------
# search index: fusions as bitmasks, grouped by their lowest call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SearchIndex:
    n: int
    full: int                                   # (1 << n) - 1
    # lowest call idx -> [(mask, fusion, best impl t_pred)]
    by_lowest: dict[int, list[tuple[int, Fusion, float]]]


def _index(space: OptimizationSpace) -> _SearchIndex:
    n = len(space.graph.calls)
    by_lowest: dict[int, list[tuple[int, Fusion, float]]] = {}
    for f in space.fusions:
        mask = 0
        for i in f.key:
            mask |= 1 << i
        best_t = space.impls_by_fusion[f.key][0].t_pred
        by_lowest.setdefault(min(f.key), []).append((mask, f, best_t))
    return _SearchIndex(n=n, full=(1 << n) - 1, by_lowest=by_lowest)


def _lowest_uncovered(mask: int, n: int) -> int:
    # index of the lowest zero bit below n (mask != full)
    inv = ~mask & ((1 << n) - 1)
    return (inv & -inv).bit_length() - 1


# ---------------------------------------------------------------------------
# exact DP over covered-call bitmasks
# ---------------------------------------------------------------------------

def _dp_completion(space: OptimizationSpace, idx: _SearchIndex
                   ) -> dict[int, tuple[float, Fusion | None]]:
    """mask -> (min cost to cover the rest, first fusion of an optimal
    completion).  Computed over exactly the masks reachable from 0 by
    always extending the lowest uncovered call — each visited once."""
    memo: dict[int, tuple[float, Fusion | None]] = {idx.full: (0.0, None)}
    INF = float("inf")

    def solve(mask: int) -> tuple[float, Fusion | None]:
        hit = memo.get(mask)
        if hit is not None:
            return hit
        # iterative DFS to avoid Python recursion limits on deep graphs
        stack = [mask]
        while stack:
            m = stack[-1]
            if m in memo:
                stack.pop()
                continue
            lowest = _lowest_uncovered(m, idx.n)
            pending = False
            best, best_f = INF, None
            for fmask, f, t in idx.by_lowest.get(lowest, []):
                if fmask & m:
                    continue
                child = m | fmask
                got = memo.get(child)
                if got is None:
                    stack.append(child)
                    pending = True
                elif t + got[0] < best:
                    best, best_f = t + got[0], f
            if not pending:
                memo[m] = (best, best_f)
                stack.pop()
        return memo[mask]

    solve(0)
    return memo


def _reconstruct(space: OptimizationSpace, idx: _SearchIndex,
                 memo: dict[int, tuple[float, Fusion | None]]) -> Combination:
    mask, impls = 0, []
    while mask != idx.full:
        _, f = memo[mask]
        if f is None:
            raise VerificationError.single(
                "RPL220", "scheduler",
                "no legal combination covers the graph")
        impls.append(space.impls_by_fusion[f.key][0])
        for i in f.key:
            mask |= 1 << i
    return Combination(impls=tuple(impls),
                       t_pred=sum(i.t_pred for i in impls))


# ---------------------------------------------------------------------------
# beam search (large graphs)
# ---------------------------------------------------------------------------

def _beam_best(space: OptimizationSpace, idx: _SearchIndex,
               width: int) -> Combination:
    """Forward beam over popcount levels: keep the ``width`` cheapest
    masks per number-of-covered-calls, always extending the lowest
    uncovered call.  Approximate but covers every call by construction."""
    # mask -> (cost, parent mask, fusion used to get here)
    levels: list[dict[int, tuple[float, int, Fusion | None]]] = [
        {} for _ in range(idx.n + 1)]
    levels[0][0] = (0.0, -1, None)
    best_final: tuple[float, int] | None = None
    for depth in range(idx.n):
        frontier = levels[depth]
        if not frontier:
            continue
        kept = heapq.nsmallest(width, frontier.items(), key=lambda kv: kv[1][0])
        for mask, (cost, _, _) in kept:
            lowest = _lowest_uncovered(mask, idx.n)
            for fmask, f, t in idx.by_lowest.get(lowest, []):
                if fmask & mask:
                    continue
                child = mask | fmask
                ncost = cost + t
                lvl = levels[bin(child).count("1")]
                old = lvl.get(child)
                if old is None or ncost < old[0]:
                    lvl[child] = (ncost, mask, f)
                if child == idx.full and (best_final is None
                                          or ncost < best_final[0]):
                    best_final = (ncost, mask)
    if best_final is None:
        raise VerificationError.single(
            "RPL220", "scheduler", "no legal combination covers the graph")
    # walk parents back from the full mask
    chain: list[Fusion] = []
    mask = idx.full
    while mask:
        cost, parent, f = levels[bin(mask).count("1")][mask]
        assert f is not None
        chain.append(f)
        mask = parent
    chain.reverse()
    impls = tuple(space.impls_by_fusion[f.key][0] for f in chain)
    return Combination(impls=impls, t_pred=sum(i.t_pred for i in impls))


# ---------------------------------------------------------------------------
# public search API
# ---------------------------------------------------------------------------

def best_combination(space: OptimizationSpace,
                     exact_threshold: int = EXACT_THRESHOLD,
                     beam_width: int = BEAM_WIDTH) -> Combination:
    """Minimum-``t_pred`` combination.  Exact DP for graphs up to
    ``exact_threshold`` calls, beam search beyond."""
    idx = _index(space)
    if idx.n == 0:
        return Combination(impls=(), t_pred=0.0)
    if idx.n <= exact_threshold:
        memo = _dp_completion(space, idx)
        assert memo[0][0] != float("inf"), \
            "no legal combination covers the graph"
        return _reconstruct(space, idx, memo)
    return _beam_best(space, idx, beam_width)


@dataclasses.dataclass(order=True)
class _State:
    priority: float
    g_cost: float
    order: int                       # tiebreak: insertion counter
    mask: int = dataclasses.field(compare=False)
    impls: tuple[Impl, ...] = dataclasses.field(compare=False)
    # lazy-sibling bookkeeping: the last fusion's impl list + chosen index
    last_impls: list[Impl] | None = dataclasses.field(compare=False)
    last_idx: int = dataclasses.field(compare=False)


def iter_combinations(space: OptimizationSpace,
                      exact_threshold: int = EXACT_THRESHOLD):
    """Yield combinations lazily in nondecreasing ``t_pred`` order.

    A* over (mask, impl-assignment) states.  The heuristic is the exact
    DP completion cost (using each fusion's best implementation), which
    is an admissible and consistent lower bound, so states pop in true
    total-cost order.  Implementation variants within a fusion are
    explored by lazy sibling expansion (push index ``i+1`` only when
    index ``i`` pops), exactly the seed's per-partition heap but global.
    """
    idx = _index(space)
    if idx.n == 0:
        yield Combination(impls=(), t_pred=0.0)
        return
    if idx.n <= exact_threshold:
        memo = _dp_completion(space, idx)
        if memo[0][0] == float("inf"):
            return

        def h(mask: int) -> float:
            got = memo.get(mask)
            return got[0] if got is not None else float("inf")
    else:                          # beam regime: uniform-cost (h = 0),
        def h(mask: int) -> float:  # still exact order, explores more
            return 0.0

    counter = itertools.count()
    heap: list[_State] = []

    def push(g_cost: float, mask: int, impls: tuple[Impl, ...],
             last_impls: list[Impl] | None, last_idx: int):
        hm = h(mask)
        if hm == float("inf"):
            return
        heapq.heappush(heap, _State(
            priority=g_cost + hm, g_cost=g_cost, order=next(counter),
            mask=mask, impls=impls, last_impls=last_impls, last_idx=last_idx))

    def extend(st: _State):
        lowest = _lowest_uncovered(st.mask, idx.n)
        for fmask, f, _ in idx.by_lowest.get(lowest, []):
            if fmask & st.mask:
                continue
            il = space.impls_by_fusion[f.key]
            push(st.g_cost + il[0].t_pred, st.mask | fmask,
                 st.impls + (il[0],), il, 0)

    push(0.0, 0, (), None, -1)
    while heap:
        st = heapq.heappop(heap)
        # lazy sibling: same prefix, next implementation of the last fusion
        if st.last_impls is not None and st.last_idx + 1 < len(st.last_impls):
            nxt = st.last_impls[st.last_idx + 1]
            dt = nxt.t_pred - st.last_impls[st.last_idx].t_pred
            push(st.g_cost + dt, st.mask, st.impls[:-1] + (nxt,),
                 st.last_impls, st.last_idx + 1)
        if st.mask == idx.full:
            yield Combination(impls=st.impls, t_pred=st.g_cost)
        else:
            extend(st)


def enumerate_combinations(space: OptimizationSpace, limit: int | None = None
                           ) -> list[Combination]:
    """The ``limit`` best combinations, sorted by predicted time."""
    cap = limit if limit is not None else ENUMERATE_CAP
    return list(itertools.islice(iter_combinations(space), cap))


def unfused_combination(space: OptimizationSpace) -> Combination:
    """The no-fusion baseline: every call its own kernel (CUBLAS-style)."""
    singles = {min(f.key): f for f in space.fusions if len(f.key) == 1}
    impls = []
    for i, call in enumerate(space.graph.calls):
        f = singles.get(i)
        if f is None:
            # build_space drops a singleton when every impl is pruned
            # (e.g. all exceed the VMEM budget) — name the call instead
            # of leaking a bare KeyError
            raise VerificationError.single(
                "RPL221", "scheduler",
                f"no single-call implementation for call #{i} "
                f"({call.elem.name}, axes {call.axis_sizes}): every "
                f"impl was pruned from the optimization space, so the "
                f"unfused baseline cannot be built")
        impls.append(space.impls_by_fusion[f.key][0])
    return Combination(impls=tuple(impls),
                       t_pred=sum(i.t_pred for i in impls))


# ---------------------------------------------------------------------------
# seed reference implementation (kept for equivalence testing)
# ---------------------------------------------------------------------------

def _partitions(space: OptimizationSpace):
    """Yield all partitions of the call set into legal fusions (as tuples
    of Fusion).  DFS always extends the lowest-index uncovered call."""
    n = len(space.graph.calls)
    by_lowest: dict[int, list[Fusion]] = {}
    for f in space.fusions:
        by_lowest.setdefault(min(f.key), []).append(f)

    def rec(covered: frozenset, acc: tuple):
        if len(covered) == n:
            yield acc
            return
        lowest = min(i for i in range(n) if i not in covered)
        for f in by_lowest.get(lowest, []):
            if f.key & covered:
                continue
            yield from rec(covered | f.key, acc + (f,))

    yield from rec(frozenset(), ())


def exhaustive_best_combination(space: OptimizationSpace) -> Combination:
    """The seed's exponential DFS — reference oracle for the DP."""
    best: Combination | None = None
    for part in _partitions(space):
        impls = tuple(space.impls_by_fusion[f.key][0] for f in part)
        t = sum(i.t_pred for i in impls)
        if best is None or t < best.t_pred:
            best = Combination(impls=impls, t_pred=t)
    if best is None:
        raise VerificationError.single(
            "RPL220", "scheduler", "no legal combination covers the graph")
    return best
