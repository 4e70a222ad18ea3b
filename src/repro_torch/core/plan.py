"""ExecutionPlan — the serializable contract between search and codegen.

The seed handed codegen a ``Combination`` (live ``Impl``/``Fusion``
objects full of unhashable ``Var``s) and re-derived group order and value
routing at execution time in a Python interpreter loop.  The plan layer
(DESIGN.md §4) makes the search result an explicit, serializable
artifact:

* ``GroupPlan`` — one fused kernel: which graph calls it covers, the
  chosen grid order (as positions into the fusion's canonical axis list,
  stable across re-traces) and block sizes, plus a *routing table*
  mapping each of its external inputs to either a graph input (by name)
  or an earlier group's output (by group/output index).
* ``ExecutionPlan`` — topo-ordered groups + output routing + the graph
  signature it was computed for.  ``to_json``/``from_json`` round-trip
  losslessly, which is what the on-disk plan cache stores; ``bind``
  re-attaches a deserialized plan to a freshly traced graph, rebuilding
  the concrete ``Impl`` objects without re-running the search.

``graph_signature`` is the content address: a hash over the traced
program's structure (elementaries, dataflow, shapes, dtypes).  Two
scripts tracing to the same graph share plans.

``plan_from_reference`` reads a plan written by the JAX reference
package and maps its backend name onto this package's (``jnp`` ->
``torch``, ``pallas`` -> ``cuda``): plans and inputs are this system's
whole state, so one plan JSON serves both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from .diagnostics import VerificationError
from .fusion import analyse_group
from .graph import Graph, Var
from .predictor import HardwareModel, Impl, cost_impl
from .scheduler import Combination

PLAN_VERSION = 1

#: reference backend name -> this package's counterpart
REFERENCE_BACKENDS = {"jnp": "torch", "pallas": "cuda"}

# A ValueRef routes one runtime value:  ("input", name) reads a graph
# input, ("group", gi, oi) reads output ``oi`` of plan group ``gi``.
ValueRef = tuple


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    call_indices: tuple[int, ...]       # graph call idxs, ascending
    order_pos: tuple[int, ...]          # grid order as positions into the
    #                                     fusion's sorted axis_roots
    blocks: tuple[int, ...]             # block size per grid axis
    inputs: tuple[ValueRef, ...]        # one per fusion external input
    n_outputs: int

    def to_dict(self) -> dict:
        return {"calls": list(self.call_indices),
                "order_pos": list(self.order_pos),
                "blocks": list(self.blocks),
                "inputs": [list(r) for r in self.inputs],
                "n_outputs": self.n_outputs}

    @classmethod
    def from_dict(cls, d: dict) -> "GroupPlan":
        return cls(call_indices=tuple(d["calls"]),
                   order_pos=tuple(d["order_pos"]),
                   blocks=tuple(d["blocks"]),
                   inputs=tuple(tuple(r) for r in d["inputs"]),
                   n_outputs=d["n_outputs"])


@dataclasses.dataclass
class ExecutionPlan:
    signature: str                      # graph_signature() of the trace
    backend: str
    dtype: str                          # canonical numpy dtype name
    t_pred: float
    groups: tuple[GroupPlan, ...]       # topological order
    outputs: tuple[ValueRef, ...]       # routing of the graph outputs
    input_names: tuple[str, ...]        # positional input order
    version: int = PLAN_VERSION

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "version": self.version, "signature": self.signature,
            "backend": self.backend, "dtype": self.dtype,
            "t_pred": self.t_pred,
            "groups": [gp.to_dict() for gp in self.groups],
            "outputs": [list(r) for r in self.outputs],
            "input_names": list(self.input_names),
        })

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        d = json.loads(s)
        if d.get("version") != PLAN_VERSION:
            raise VerificationError.single(
                "RPL201", "plan.version",
                f"plan version {d.get('version')} != {PLAN_VERSION}")
        return cls(signature=d["signature"], backend=d["backend"],
                   dtype=d["dtype"], t_pred=d["t_pred"],
                   groups=tuple(GroupPlan.from_dict(g) for g in d["groups"]),
                   outputs=tuple(tuple(r) for r in d["outputs"]),
                   input_names=tuple(d["input_names"]),
                   version=d["version"])

    # -- rebinding ----------------------------------------------------------
    def bind(self, g: Graph, hw: HardwareModel) -> list[Impl]:
        """Rebuild concrete Impls against a (re-)traced graph.

        This is how a cached (possibly disk-loaded, possibly
        another-host-computed) plan turns back into executable form
        without re-running the search: call indices, fusion analysis
        and axis canonicalization are all deterministic functions of
        the trace, so the groups reconstruct exactly.

        Args:
          g: a graph freshly traced from the same program (verified via
            ``graph_signature``).
          hw: the hardware model used to re-cost the implementations
            (costs are informational at this point — the plan already
            fixed the grouping and grids).

        Returns:
          One bound ``Impl`` per plan group, in topological order —
          what ``codegen.compile_plan`` consumes.

        Raises:
          ValueError: signature mismatch (the graph is not the plan's
            trace), or a plan group that is no longer a legal fusion
            (library semantics changed under a stale cache entry).

        Example::

            plan2 = ExecutionPlan.from_json(plan.to_json())
            impls = plan2.bind(compiler.trace(script, shapes), V5E)
        """
        if graph_signature(g) != self.signature:
            raise VerificationError.single(
                "RPL210", "plan.signature", "plan/graph signature mismatch",
                "the plan was computed for a different trace; recompile")
        impls: list[Impl] = []
        for gi, gp in enumerate(self.groups):
            members = [g.calls[i] for i in gp.call_indices]
            f = analyse_group(g, members)
            if f is None:
                raise VerificationError.single(
                    "RPL211", f"plan.groups[{gi}]",
                    f"plan group {gp.call_indices} no longer legal",
                    "library semantics changed under a stale cache entry; "
                    "recompile")
            order = tuple(f.axis_roots[p] for p in gp.order_pos)
            impls.append(cost_impl(f, g, order, gp.blocks, hw))
        return impls

    def describe(self) -> str:
        lines = [f"plan {self.signature[:12]} backend={self.backend} "
                 f"dtype={self.dtype} t_pred={self.t_pred*1e6:.2f}us "
                 f"groups={len(self.groups)}"]
        for i, gp in enumerate(self.groups):
            lines.append(f"  g{i}: calls={gp.call_indices} blocks={gp.blocks} "
                         f"in={gp.inputs}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# graph signature (content address of a trace)
# ---------------------------------------------------------------------------

def group_signature(g: Graph, f) -> str:
    """Localized content address of ONE fused group (DESIGN.md §8).

    Unlike ``graph_signature``, every reference is *local* to the
    fusion: external inputs by position (shape/dtype only — names are
    the program's ABI, not the group's), member calls by local index,
    axis roots by position in the fusion's canonical axis list.  Two
    groups with the same elementaries, dataflow, shapes and axis
    pattern therefore hash identically **no matter which program they
    were traced from** — which is what lets the per-group measured-cost
    table transfer timings between programs sharing a fusion.
    """
    ext = {v: i for i, v in enumerate(f.external_inputs)}
    local = {c.out: j for j, c in enumerate(f.calls)}
    root_pos = {r: i for i, r in enumerate(f.axis_roots)}

    def ref(v: Var):
        if v in ext:
            return ["x", ext[v]]
        return ["c", local[v]]

    payload = {
        "inputs": [[list(v.shape), str(v.dtype)] for v in f.external_inputs],
        "calls": [[c.elem.name, [ref(a) for a in c.args],
                   list(c.axis_sizes),
                   [root_pos[g.axis_root(a)] for a in c.axis_ids],
                   list(c.out.shape), str(c.out.dtype)]
                  for c in f.calls],
        "outputs": [ref(v) for v in f.outputs],
    }
    blob = json.dumps(payload, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def graph_signature(g: Graph) -> str:
    """Hash of the traced program's structure: elementary names, dataflow
    edges, shapes, dtypes, unified axis pattern.  Var names are included
    only for inputs (they are the call ABI).

    Memoized on the graph instance: a graph is immutable once traced,
    and the signature is hashed on every compile (plan cache key) AND by
    the always-on plan verification (DESIGN.md §11) — computing it twice
    would double the verifier's overhead for nothing."""
    sig = getattr(g, "_signature_memo", None)
    if sig is not None:
        return sig
    inputs = {v: i for i, v in enumerate(g.inputs)}

    def ref(v: Var):
        if v.is_input:
            return ["in", inputs[v]]
        return ["call", v.producer.idx]

    payload = {
        "inputs": [[v.name, list(v.shape), str(v.dtype)] for v in g.inputs],
        "calls": [[c.elem.name, [ref(a) for a in c.args],
                   list(c.axis_sizes),
                   [g.axis_root(a) for a in c.axis_ids],
                   list(c.out.shape), str(c.out.dtype)]
                  for c in g.calls],
        "outputs": [ref(v) for v in g.outputs],
    }
    blob = json.dumps(payload, separators=(",", ":")).encode()
    sig = hashlib.sha256(blob).hexdigest()
    g._signature_memo = sig
    return sig


# ---------------------------------------------------------------------------
# plan construction from a search result
# ---------------------------------------------------------------------------

def topo_group_order(g: Graph, combo: Combination) -> list[Impl]:
    """Topologically order a combination's groups by data dependence."""
    remaining = list(combo.impls)
    ready_vars = set(g.inputs)
    ordered: list[Impl] = []
    while remaining:
        progressed = False
        for im in list(remaining):
            if all(a in ready_vars for a in im.fusion.external_inputs):
                ordered.append(im)
                ready_vars |= set(im.fusion.outputs)
                ready_vars |= set(im.fusion.internal_vars)
                remaining.remove(im)
                progressed = True
        if not progressed:
            raise RuntimeError("cyclic combination — scheduler bug")
    return ordered


def build_plan(g: Graph, combo: Combination, backend: str) -> ExecutionPlan:
    order = topo_group_order(g, combo)
    where: dict[Var, ValueRef] = {v: ("input", v.name) for v in g.inputs}
    groups: list[GroupPlan] = []
    for gi, im in enumerate(order):
        f = im.fusion
        refs = tuple(where[a] for a in f.external_inputs)
        order_pos = tuple(f.axis_roots.index(r) for r in im.order)
        groups.append(GroupPlan(
            call_indices=tuple(sorted(f.key)), order_pos=order_pos,
            blocks=im.blocks, inputs=refs, n_outputs=len(f.outputs)))
        for oi, v in enumerate(f.outputs):
            where[v] = ("group", gi, oi)
    dtype = str(g.outputs[0].dtype) if g.outputs else "float32"
    return ExecutionPlan(
        signature=graph_signature(g), backend=backend, dtype=dtype,
        t_pred=combo.t_pred, groups=tuple(groups),
        outputs=tuple(where[v] for v in g.outputs),
        input_names=tuple(v.name for v in g.inputs))


def plan_from_reference(json_text: str) -> ExecutionPlan:
    """An ``ExecutionPlan`` from a plan JSON written by the JAX reference.

    The plan format is shared; only the backend names differ.  Unknown
    backend names raise RPL201 instead of passing through.

    Example::

        plan = plan_from_reference(reference_plan.to_json())
        prog = codegen.compile_plan(g, plan, device="cpu")
    """
    plan = ExecutionPlan.from_json(json_text)
    if plan.backend not in REFERENCE_BACKENDS:
        raise VerificationError.single(
            "RPL201", "plan.backend",
            f"reference plan backend {plan.backend!r} is not one of "
            f"{', '.join(REFERENCE_BACKENDS)}")
    return dataclasses.replace(plan, backend=REFERENCE_BACKENDS[plan.backend])
