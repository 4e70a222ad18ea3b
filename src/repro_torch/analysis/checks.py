"""Static verification passes over graphs, plans, and packs.

Every invariant the pipeline assumes implicitly — trace well-formedness,
plan routing, fusion legality under a chosen grid order, K1's layout
and shared-memory contracts, pack offset rebasing — is checked here
explicitly, reporting :class:`~repro_torch.core.diagnostics.Diagnostic`
records with the reference's stable ``RPL*`` codes instead of failing
deep inside codegen (or worse, executing a corrupt plan and returning
wrong numbers).  On the same plan JSON every check returns the codes
the reference's verifier returns, except RPL214 and RPL215, which take
their Hopper meaning on the ``cuda`` backend:

* **RPL214** — the group is one K1 can emit: ``cuda_codegen.GroupLayout``
  accepts it (float32 or float16 buffers, every consumed reduction
  accumulable under the plan's order, every phase's reductions mapped
  onto work units);
* **RPL215** — the group's kernel needs at most ``cuda_codegen.SMEM_LIMIT``
  bytes of shared memory a CTA (``cuda_codegen.smem_bytes``).

Both are computed by ``cuda_codegen``'s own layout code, never a copy of
it.  On the ``torch`` backend they keep the reference's meaning for its
dense backend: nothing to check.  That a cooperative grid fits its
co-resident CTAs needs an occupancy query on the card, so it stays a
launch-time check: K1's C launcher caps the grid at the occupancy it
queries and ``kernels/_launch.py`` raises ``CudaLaunchError`` on a
refused launch.

Three passes, by cost:

* :func:`verify_plan_structural` — pure plan-side checks, no graph, no
  hashing.  Microseconds.
* :func:`verify_plan_quick` — structural + plan↔graph signature, dtype
  and coverage.  The **always-on** subset ``FusionCompiler`` runs on
  every cache-served plan: cheap enough to never show
  up against compile latency, strong enough that a corrupt
  cache-deserialized plan is rejected and recompiled, not executed.
* :func:`verify_plan` — the full pass: binds every group against the
  graph (re-running fusion analysis) and re-derives the entire routing
  table, so *any* mis-routed value ref — not just an unresolvable one —
  is caught.  Runs under ``verify=True`` / ``REPRO_VERIFY=1`` and in
  the ``python -m repro_torch.analysis`` CLI.

The verifiers never raise on findings — they return diagnostic lists;
callers choose between :func:`~repro_torch.core.diagnostics.raise_if_errors`
and report aggregation.  (They may still raise on artifacts too corrupt
to traverse, e.g. a plan whose groups are not ``GroupPlan``s at all —
the cache layer treats any such exception as a corrupt entry.)
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..core import cuda_codegen
from ..core.diagnostics import (KNOWN_BACKENDS, Diagnostic,
                                UnsupportedGroupError, diag)
from ..core.fusion import analyse_group
from ..core.graph import Graph
from ..core.masking import MASK_INPUT
from ..core.plan import (PLAN_VERSION, ExecutionPlan, PackedPlan,
                         graph_signature, plan_fingerprint)
from ..core.predictor import V5E, HardwareModel, cost_impl


def _located(diags: Sequence[Diagnostic], prefix: str) -> list[Diagnostic]:
    """Re-root diagnostic locations under ``prefix``."""
    return [Diagnostic(code=d.code, severity=d.severity,
                       location=f"{prefix}.{d.location}",
                       message=d.message, hint=d.hint) for d in diags]


# ---------------------------------------------------------------------------
# graph checks (RPL1xx)
# ---------------------------------------------------------------------------

def verify_graph(g: Graph) -> list[Diagnostic]:
    """Dataflow well-formedness, shape/dtype flow, and pad-safety of a
    traced graph."""
    out: list[Diagnostic] = []
    known = set(g.inputs)

    for pos, c in enumerate(g.calls):
        loc = f"graph.calls[{pos}]"
        if c.idx != pos:
            out.append(diag("RPL101", loc,
                            f"call index {c.idx} at position {pos}",
                            "call indices must equal construction order"))
        for ai, a in enumerate(c.args):
            if a not in known:
                out.append(diag(
                    "RPL101", f"{loc}.args[{ai}]",
                    f"{c.elem.name} reads {a!r} before it is produced "
                    "(or it belongs to another graph)",
                    "every argument must be a graph input or the output "
                    "of an earlier call"))
        # arity + per-dimension shape consistency against the ArgSpecs
        if len(c.args) != len(c.elem.in_specs):
            out.append(diag(
                "RPL102", loc,
                f"{c.elem.name} takes {len(c.elem.in_specs)} args, "
                f"call has {len(c.args)}"))
        else:
            if len(c.axis_sizes) != c.elem.depth:
                out.append(diag(
                    "RPL102", loc,
                    f"call records {len(c.axis_sizes)} axis sizes for a "
                    f"depth-{c.elem.depth} elementary"))
            else:
                for ai, (a, spec) in enumerate(zip(c.args, c.elem.in_specs)):
                    if len(spec.axes) != len(a.shape):
                        out.append(diag(
                            "RPL102", f"{loc}.args[{ai}]",
                            f"{c.elem.name} arg rank {len(a.shape)} does "
                            f"not match ArgSpec axes {spec.axes}"))
                        continue
                    for d, ax in enumerate(spec.axes):
                        if a.shape[d] != c.axis_sizes[ax]:
                            out.append(diag(
                                "RPL102", f"{loc}.args[{ai}]",
                                f"axis {ax} of {c.elem.name} has size "
                                f"{c.axis_sizes[ax]} but arg dim {d} has "
                                f"{a.shape[d]}"))
                want_shape = tuple(c.axis_sizes[a_] for a_ in c.elem.out_axes)
                if c.out.shape != want_shape:
                    out.append(diag(
                        "RPL102", f"{loc}.out",
                        f"{c.elem.name} output shape {c.out.shape} != "
                        f"{want_shape} implied by its out_axes"))
        if c.args:
            want = np.result_type(*(a.dtype for a in c.args))
            if np.dtype(c.out.dtype) != want:
                out.append(diag(
                    "RPL103", f"{loc}.out",
                    f"{c.elem.name} output dtype {c.out.dtype} is not the "
                    f"promotion {want} of its argument dtypes"))
        known.add(c.out)

    for oi, v in enumerate(g.outputs):
        if v not in known:
            out.append(diag(
                "RPL101", f"graph.outputs[{oi}]",
                f"output {v!r} is not produced by this graph"))

    out.extend(_verify_pad_safety(g))
    return out


def _verify_pad_safety(g: Graph) -> list[Diagnostic]:
    """RPL104/RPL105 — is serving this graph with padded lanes sound?

    * An **unmasked** graph is checked against the identity-padding
      analysis (``serving.input_pad_values``); a refusal is a *warning*
      (RPL104): direct execution is unaffected, and the serving engine
      falls back to per-lane masking — but a caller padding by hand
      would corrupt reductions.
    * A **masked** graph (one carrying the reserved ``_mask`` input) is
      held to the masking rewrite's own contract: every reduction
      argument indexed by a padded reduce axis must be routed through
      the matching ``mask_<monoid>_*`` elementary.  A violation
      (RPL105) is an **error** — such a graph runs and silently
      produces wrong numbers for padded batches, the exact failure mode
      the verifier exists to catch.
    """
    out: list[Diagnostic] = []
    mask_var = next((v for v in g.inputs if v.name == MASK_INPUT), None)
    if mask_var is None:
        # identity-padding feasibility (reuse the engine's analysis —
        # one implementation of the rule, two consumers)
        from ..serving.engine import input_pad_values
        try:
            input_pad_values(g)
        except ValueError as e:
            out.append(diag(
                "RPL104", "graph", str(e),
                "serve through per-lane masking (core.masking), or pad "
                "only with explicitly provided identities"))
        return out

    padded = {g.axis_root(a) for a in mask_var.axis_ids}
    for c in g.calls:
        if not c.elem.is_reduction:
            continue
        reduce_axes = set(c.elem.reduce_axes)
        for ai, (a, spec) in enumerate(zip(c.args, c.elem.in_specs)):
            dims = tuple(
                d for d, ax in enumerate(spec.axes)
                if ax in reduce_axes
                and d < len(a.axis_ids)
                and g.axis_root(a.axis_ids[d]) in padded)
            if not dims or a is mask_var:
                continue
            prod = a.producer
            want = f"mask_{c.elem.monoid.value}_"
            if prod is None or not prod.elem.name.startswith(want):
                got = "graph input" if prod is None else prod.elem.name
                out.append(diag(
                    "RPL105", f"graph.calls[{c.idx}].args[{ai}]",
                    f"reduction {c.elem.name} ({c.elem.monoid.value}) "
                    f"consumes {got!r} over padded axis dims {dims} "
                    f"without a {want}* mask",
                    "route the argument through core.masking's "
                    "mask elementary so padded lanes contribute the "
                    "monoid identity"))
    return out


# ---------------------------------------------------------------------------
# plan checks (RPL2xx)
# ---------------------------------------------------------------------------

def _check_ref(ref, gi: int | None, plan: ExecutionPlan, loc: str
               ) -> list[Diagnostic]:
    """Validate one ValueRef.  ``gi`` is the index of the consuming
    group (None for the plan's output table, which may read any
    group)."""
    if not isinstance(ref, (tuple, list)) or not ref:
        return [diag("RPL202", loc, f"malformed ref {ref!r}")]
    tag = ref[0]
    if tag == "input":
        if len(ref) != 2 or ref[1] not in plan.input_names:
            return [diag("RPL202", loc,
                         f"input ref {tuple(ref)!r} names no graph input",
                         f"inputs are {list(plan.input_names)}")]
        return []
    if tag == "group":
        if (len(ref) != 3 or not isinstance(ref[1], int)
                or not isinstance(ref[2], int)):
            return [diag("RPL202", loc, f"malformed group ref {ref!r}")]
        src, oi = ref[1], ref[2]
        if not 0 <= src < len(plan.groups):
            return [diag("RPL202", loc,
                         f"group ref reads group {src} of a "
                         f"{len(plan.groups)}-group plan")]
        if gi is not None and src >= gi:
            return [diag("RPL203", loc,
                         f"group {gi} reads group {src}, which runs at or "
                         "after it",
                         "plan groups must be topologically ordered")]
        if not 0 <= oi < plan.groups[src].n_outputs:
            return [diag("RPL202", loc,
                         f"ref reads output {oi} of group {src}, which has "
                         f"{plan.groups[src].n_outputs} outputs")]
        return []
    return [diag("RPL202", loc, f"unknown ref tag {tag!r}")]


def verify_plan_structural(plan: ExecutionPlan) -> list[Diagnostic]:
    """Plan-side checks needing no graph: field sanity, routing-ref
    resolution, topological group order, call-coverage disjointness."""
    out: list[Diagnostic] = []
    if plan.version != PLAN_VERSION:
        out.append(diag("RPL201", "plan.version",
                        f"plan version {plan.version} != {PLAN_VERSION}"))
    if plan.backend not in KNOWN_BACKENDS:
        out.append(diag("RPL401", "plan.backend",
                        f"unknown backend {plan.backend!r}",
                        f"valid backends: {', '.join(KNOWN_BACKENDS)}"))
    try:
        np.dtype(plan.dtype)
    except TypeError:
        out.append(diag("RPL201", "plan.dtype",
                        f"{plan.dtype!r} is not a dtype"))
    if not (isinstance(plan.t_pred, (int, float))
            and math.isfinite(plan.t_pred) and plan.t_pred >= 0):
        out.append(diag("RPL201", "plan.t_pred",
                        f"predicted time {plan.t_pred!r} is not a finite "
                        "non-negative number"))
    if len(set(plan.input_names)) != len(plan.input_names):
        out.append(diag("RPL201", "plan.input_names",
                        f"duplicate input names in {list(plan.input_names)}"))

    seen_calls: dict[int, int] = {}
    for gi, gp in enumerate(plan.groups):
        loc = f"plan.groups[{gi}]"
        if not gp.call_indices:
            out.append(diag("RPL205", loc, "group covers no calls"))
        if list(gp.call_indices) != sorted(set(gp.call_indices)):
            out.append(diag("RPL205", loc,
                            f"call indices {gp.call_indices} not strictly "
                            "ascending"))
        for ci in gp.call_indices:
            if not isinstance(ci, int) or ci < 0:
                out.append(diag("RPL205", loc,
                                f"bad call index {ci!r}"))
            elif ci in seen_calls:
                out.append(diag(
                    "RPL205", loc,
                    f"call {ci} covered by groups {seen_calls[ci]} and {gi}",
                    "groups must partition the call set"))
            else:
                seen_calls[ci] = gi
        if len(gp.order_pos) != len(gp.blocks):
            out.append(diag(
                "RPL204", loc,
                f"{len(gp.order_pos)} order positions vs "
                f"{len(gp.blocks)} block sizes"))
        if sorted(gp.order_pos) != list(range(len(gp.order_pos))):
            out.append(diag(
                "RPL204", f"{loc}.order_pos",
                f"{gp.order_pos} is not a permutation of the fusion's "
                "axis positions"))
        for bi, b in enumerate(gp.blocks):
            if not isinstance(b, int) or b < 1:
                out.append(diag("RPL204", f"{loc}.blocks[{bi}]",
                                f"block size {b!r} must be a positive int"))
        if not isinstance(gp.n_outputs, int) or gp.n_outputs < 1:
            out.append(diag("RPL204", f"{loc}.n_outputs",
                            f"group must produce >= 1 outputs, "
                            f"has {gp.n_outputs!r}"))
        for ri, ref in enumerate(gp.inputs):
            out.extend(_check_ref(ref, gi, plan, f"{loc}.inputs[{ri}]"))
    for ri, ref in enumerate(plan.outputs):
        out.extend(_check_ref(ref, None, plan, f"plan.outputs[{ri}]"))
    return out


def verify_plan_quick(plan: ExecutionPlan, g: Graph) -> list[Diagnostic]:
    """The always-on subset: structural checks + plan↔graph signature,
    dtype, and exact call coverage.  No fusion re-analysis, no hashing
    beyond one ``graph_signature`` — cheap enough to run on every
    cache-served plan."""
    out = verify_plan_structural(plan)
    if graph_signature(g) != plan.signature:
        out.append(diag(
            "RPL210", "plan.signature",
            "plan/graph signature mismatch",
            "the plan was computed for a different trace; recompile"))
        return out  # coverage/dtype checks are meaningless across graphs
    covered = sorted(i for gp in plan.groups for i in gp.call_indices)
    if covered != list(range(len(g.calls))):
        out.append(diag(
            "RPL218", "plan.groups",
            f"groups cover calls {covered} of a "
            f"{len(g.calls)}-call graph",
            "every call must be covered exactly once"))
    want_dtype = str(g.outputs[0].dtype) if g.outputs else "float32"
    if plan.dtype != want_dtype:
        out.append(diag("RPL219", "plan.dtype",
                        f"plan dtype {plan.dtype!r} != graph output dtype "
                        f"{want_dtype!r}"))
    if tuple(plan.input_names) != tuple(v.name for v in g.inputs):
        out.append(diag(
            "RPL216", "plan.input_names",
            f"plan inputs {list(plan.input_names)} != graph inputs "
            f"{[v.name for v in g.inputs]}"))
    return out


def _cuda_group_checks(g: Graph, impl, loc: str,
                       smem_budget: int | None) -> list[Diagnostic]:
    """RPL214/RPL215 on the ``cuda`` backend, by K1's own layout code."""
    try:
        lay = cuda_codegen.GroupLayout(g, impl)
    except UnsupportedGroupError as e:
        return [Diagnostic(code=d.code, severity=d.severity, location=loc,
                           message=d.message, hint=d.hint)
                for d in e.diagnostics]
    budget = cuda_codegen.SMEM_LIMIT if smem_budget is None else smem_budget
    smem = cuda_codegen.smem_bytes(lay)
    if smem > budget:
        return [diag("RPL215", loc,
                     cuda_codegen.smem_message(lay, smem, budget),
                     "choose smaller blocks or split the group")]
    return []


def verify_plan(plan: ExecutionPlan, g: Graph, hw: HardwareModel = V5E,
                smem_budget: int | None = None) -> list[Diagnostic]:
    """The full pass: everything in :func:`verify_plan_quick`, plus
    per-group fusion re-analysis and an exact re-derivation of the
    routing table.

    Group binding re-runs ``analyse_group`` (RPL211 covers fusion
    legality including the phase-chain-under-inclusion condition, rule
    2), validates the grid order and block sizes against the bound
    fusion (RPL212/RPL213) and, on the ``cuda`` backend, holds the group
    to K1's layout (RPL214) and its shared memory to ``smem_budget``
    bytes a CTA (RPL215; default ``cuda_codegen.SMEM_LIMIT``).

    Routing is checked by *reconstruction*: the only correct ref for a
    value is fully determined by the graph and the grouping, so the
    verifier rebuilds the ``where``-map ``build_plan`` would have
    produced and compares every ref (RPL216/RPL217).  A plan whose refs
    merely *resolve* but route the wrong (same-shaped) value — the
    nastiest cache-corruption case, structurally valid and numerically
    wrong — is therefore caught too.
    """
    out = verify_plan_quick(plan, g)
    if any(d.is_error for d in out):
        return out  # bound checks below assume a structurally sound plan

    where = {v: ("input", v.name) for v in g.inputs}
    deferred: list[tuple] = []
    for gi, gp in enumerate(plan.groups):
        loc = f"plan.groups[{gi}]"
        members = [g.calls[i] for i in gp.call_indices]
        f = analyse_group(g, members)
        if f is None:
            out.append(diag(
                "RPL211", loc,
                f"calls {gp.call_indices} are not a legal fusion "
                "(iteration-space, phase-chain, convexity or "
                "connectivity rule violated)",
                "recompile — the library semantics changed under a "
                "stale plan"))
            continue
        ok = True
        if len(gp.order_pos) != f.depth or any(
                not 0 <= p < f.depth for p in gp.order_pos):
            out.append(diag(
                "RPL212", f"{loc}.order_pos",
                f"{gp.order_pos} does not index the fusion's "
                f"{f.depth} axis roots"))
            ok = False
        if ok:
            order = tuple(f.axis_roots[p] for p in gp.order_pos)
            for bi, (b, r) in enumerate(zip(gp.blocks, order)):
                size = f.axis_sizes[f.axis_roots.index(r)]
                if b > size:
                    out.append(diag(
                        "RPL213", f"{loc}.blocks[{bi}]",
                        f"block {b} exceeds axis size {size}"))
                    ok = False
        if ok and plan.backend == "cuda":
            im = cost_impl(f, g, order, tuple(gp.blocks), hw)
            out.extend(_cuda_group_checks(g, im, loc, smem_budget))
        # routing reconstruction
        if len(gp.inputs) != len(f.external_inputs):
            out.append(diag(
                "RPL216", f"{loc}.inputs",
                f"{len(gp.inputs)} refs for a fusion with "
                f"{len(f.external_inputs)} external inputs"))
        else:
            for ri, (ref, v) in enumerate(zip(gp.inputs, f.external_inputs)):
                want = where.get(v)
                if want is None:
                    out.append(diag(
                        "RPL216", f"{loc}.inputs[{ri}]",
                        f"external input {v!r} is produced by no earlier "
                        "group", "group order violates the dataflow"))
                elif tuple(ref) != want:
                    out.append(diag(
                        "RPL216", f"{loc}.inputs[{ri}]",
                        f"ref {tuple(ref)!r} routes the wrong value; the "
                        f"graph's dataflow requires {want!r}"))
        if gp.n_outputs != len(f.outputs):
            out.append(diag(
                "RPL216", f"{loc}.n_outputs",
                f"group declares {gp.n_outputs} outputs, fusion has "
                f"{len(f.outputs)}"))
        for oi, v in enumerate(f.outputs):
            where[v] = ("group", gi, oi)
        deferred.append((f, gp))

    if len(plan.outputs) != len(g.outputs):
        out.append(diag(
            "RPL217", "plan.outputs",
            f"{len(plan.outputs)} output refs for a graph with "
            f"{len(g.outputs)} outputs"))
    else:
        for ri, (ref, v) in enumerate(zip(plan.outputs, g.outputs)):
            want = where.get(v)
            if want is not None and tuple(ref) != want:
                out.append(diag(
                    "RPL217", f"plan.outputs[{ri}]",
                    f"ref {tuple(ref)!r} routes the wrong value; graph "
                    f"output {ri} ({v!r}) is at {want!r}"))
    return out


# ---------------------------------------------------------------------------
# pack checks (RPL3xx)
# ---------------------------------------------------------------------------

def verify_pack(packed: PackedPlan,
                graphs: Sequence[Graph] | None = None,
                hw: HardwareModel = V5E) -> list[Diagnostic]:
    """Verify a :class:`PackedPlan`: canonical member order, member
    plan validity, offset-rebased routing, and (when the member graphs
    are supplied) the full per-member graph-bound pass."""
    out: list[Diagnostic] = []
    fps = [plan_fingerprint(p) for p in packed.members]
    if fps != sorted(fps):
        out.append(diag(
            "RPL301", "pack.members",
            "members are not in canonical (sorted-fingerprint) order",
            "use build_packed_plan"))
    backends = {p.backend for p in packed.members}
    if len(backends) > 1:
        out.append(diag(
            "RPL302", "pack.members",
            f"members disagree on backend: {sorted(backends)}"))
    member_errors = False
    for m, p in enumerate(packed.members):
        diags = _located(verify_plan_structural(p), f"pack.members[{m}]")
        member_errors |= any(d.is_error for d in diags)
        out.extend(diags)
        if graphs is not None and m < len(graphs):
            out.extend(_located(verify_plan(p, graphs[m], hw=hw),
                                f"pack.members[{m}]"))
    if graphs is not None and len(graphs) != packed.n_members:
        out.append(diag(
            "RPL304", "pack",
            f"{packed.n_members} members but {len(graphs)} graphs"))
    if member_errors:
        return out  # rebasing over broken members is meaningless

    # offset rebasing: the merged table must resolve, stay inside each
    # member's own slab, and remain topologically ordered
    try:
        flat = packed.merged_groups()
        merged_out = packed.merged_outputs()
    except Exception as e:  # noqa: BLE001 — any failure here is corruption
        out.append(diag("RPL303", "pack",
                        f"offset rebasing failed: {e}"))
        return out
    in_offs = packed.input_offsets + (packed.n_inputs,)
    grp_offs = packed.group_offsets + (sum(len(p.groups)
                                           for p in packed.members),)
    n_groups_total = grp_offs[-1]
    if len(flat) != n_groups_total:
        out.append(diag(
            "RPL303", "pack",
            f"merged table has {len(flat)} groups, members declare "
            f"{n_groups_total}"))

    def check_merged(ref, m: int, gidx: int | None, loc: str):
        if ref[0] == "input":
            p = ref[1]
            if not (in_offs[m] <= p < in_offs[m + 1]):
                out.append(diag(
                    "RPL303", loc,
                    f"rebased input position {p} escapes member {m}'s "
                    f"slab [{in_offs[m]}, {in_offs[m + 1]})"))
        else:
            src = ref[1]
            if not (grp_offs[m] <= src < grp_offs[m + 1]):
                out.append(diag(
                    "RPL303", loc,
                    f"rebased group ref {src} escapes member {m}'s slab "
                    f"[{grp_offs[m]}, {grp_offs[m + 1]})"))
            elif gidx is not None and src >= gidx:
                out.append(diag(
                    "RPL303", loc,
                    f"merged group {gidx} reads group {src} at or after "
                    "itself"))

    for gidx, (m, gp) in enumerate(flat):
        for ri, ref in enumerate(gp.inputs):
            check_merged(ref, m, gidx,
                         f"pack.merged[{gidx}].inputs[{ri}]")
    oidx = 0
    for m, p in enumerate(packed.members):
        for _ in p.outputs:
            check_merged(merged_out[oidx], m, None,
                         f"pack.merged_outputs[{oidx}]")
            oidx += 1

    if graphs is not None:
        for m, (p, g) in enumerate(zip(packed.members, graphs)):
            if graph_signature(g) != p.signature:
                out.append(diag(
                    "RPL304", f"pack.members[{m}]",
                    "member plan/graph signature mismatch"))
    return out
