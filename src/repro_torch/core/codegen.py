"""Code generation: execution plans → executable torch programs (paper §4.3).

Two backends:

* ``torch`` — each fused group runs as plain tensor code, the glued
  elementary ``fn``s over whole operands (the dense path; the decision
  of what one group holds is still the compiler's).
* ``cuda`` — each fused group is one generated CUDA kernel (kernel K1,
  ``core.cuda_codegen``); one ``.cu`` per plan holds all its groups.
  Given CPU tensors a group runs K1's plain tiled version instead.

Execution model: codegen consumes an ``ExecutionPlan`` and returns one
whole-program function; values are routed by the plan's index table.
PyTorch runs eagerly and fuses nothing across groups, so the groups'
boundaries are the compiler's kernel boundaries as they stand.  On a
CUDA device the first call with a set of inputs runs that function
eagerly (the first of all builds the kernels); calls on inputs seen
before replay it as one CUDA graph (``core.graphs``): one dispatch per
plan, as the reference's one jitted function.

Three program kinds, as in the reference:

* ``CompiledProgram`` — one request;
* ``BatchedProgram`` — a batch of same-shape requests, every input and
  output with a leading batch axis; on the ``cuda`` backend each group
  is ONE launch over the whole batch (K1's items are requests x units x
  slices), bitwise equal to launching the requests one by one;
* ``PackedProgram`` — several member plans' batched launches as one
  dispatch (one CUDA graph), bitwise equal to dispatching the members
  one by one; ``PackedDispatch`` maps a caller's member order onto the
  pack's canonical one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .cuda_codegen import GroupKernel, PlanModule, torch_dtype
from .diagnostics import VerificationError
from .fusion import Fusion
from .graph import Graph, Var
from .graphs import GraphRunner
from .plan import ExecutionPlan, PackedPlan, build_plan
from .predictor import V5E, HardwareModel, Impl
from .scheduler import Combination


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA on a machine
    without it raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(x, v: Var, device: torch.device) -> torch.Tensor:
    """One graph input as a tensor of ``v``'s dtype on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch_dtype(v.dtype))
    return torch.as_tensor(np.asarray(x, dtype=v.dtype)).to(device)


# ---------------------------------------------------------------------------
# dense reference (oracle): evaluate the whole graph, no kernel structure
# ---------------------------------------------------------------------------

def execute_dense(g: Graph, env: dict[str, Any]):
    """The whole graph on the CPU, call by call."""
    dev = torch.device("cpu")
    vals: dict[Var, Any] = {v: as_tensor(env[v.name], v, dev) for v in g.inputs}
    for c in g.calls:
        vals[c.out] = c.elem.fn(*[vals[a] for a in c.args])
    outs = tuple(vals[v] for v in g.outputs)
    return outs[0] if len(outs) == 1 else outs


# ---------------------------------------------------------------------------
# group executors
# ---------------------------------------------------------------------------

def _group_dense_fn(f: Fusion) -> Callable:
    """Function (ext_inputs...) -> (outputs...) for one fused group."""

    def run(*ext_vals):
        vals = dict(zip(f.external_inputs, ext_vals))
        for c in f.calls:
            vals[c.out] = c.elem.fn(*[vals[a] for a in c.args])
        return tuple(vals[v] for v in f.outputs)

    run.__name__ = "fused_" + "_".join(c.elem.name for c in f.calls)
    return run


def _batched_dense_fn(f: Fusion) -> Callable:
    """The dense group function over a batch: request by request, then
    stacked, so each request's outputs are the bits of a single call."""
    one = _group_dense_fn(f)

    def run(*ext_vals):
        per = [one(*(v[b] for v in ext_vals))
               for b in range(ext_vals[0].shape[0])]
        return tuple(torch.stack(o) for o in zip(*per))

    run.__name__ = "batched_" + one.__name__
    return run


def _group_fns(g: Graph, plan: ExecutionPlan, impls: list[Impl], label: str,
               batched: bool) -> tuple[list[Callable], PlanModule | None]:
    """One function per plan group, and the plan's generated source on
    the ``cuda`` backend."""
    if plan.backend == "torch":
        make = _batched_dense_fn if batched else _group_dense_fn
        return [make(im.fusion) for im in impls], None
    if plan.backend == "cuda":
        module = PlanModule(g, impls)
        kernels = [GroupKernel(module, gi, label or plan.signature[:8])
                   for gi in range(len(impls))]
        return ([k.batched for k in kernels] if batched else kernels), module
    raise VerificationError.single(
        "RPL401", "plan.backend", f"unknown backend {plan.backend}")


# ---------------------------------------------------------------------------
# whole-program executor
# ---------------------------------------------------------------------------

class _Runs:
    """Eager on the CPU; on a CUDA device through ``GraphRunner``: the
    first call with a set of input tensors runs eagerly (the very first
    also builds the kernels), later ones replay one CUDA graph.  Called
    while the caller captures a graph of its own, the program runs
    eagerly, so its launches land in the caller's graph."""

    fn: Callable
    device: torch.device
    replays: GraphRunner | None

    def run(self, *tensors: torch.Tensor) -> tuple:
        """The program on positional tensors of the program's device."""
        if (self.device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return self.fn(*tensors)
        if self.replays is None:
            self.replays = GraphRunner(self.fn)
        return self.replays(*tensors)

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class CompiledProgram(_Runs):
    """Executable for one plan: ``fn`` runs every group in plan order
    (eagerly); calling the program runs it (``_Runs``)."""

    graph: Graph
    plan: ExecutionPlan
    group_impls: list[Impl]        # topological order, bound to `graph`
    fn: Callable                   # (*input tensors) -> tuple(outputs)
    device: torch.device
    group_fns: list[Callable]      # one per plan group, in plan order
    module: PlanModule | None = None   # the generated source (cuda backend)
    replays: GraphRunner | None = dataclasses.field(default=None, repr=False)

    @property
    def n_groups(self) -> int:
        return len(self.plan.groups)

    def prepare(self, **inputs) -> list[torch.Tensor]:
        """The inputs as positional tensors on the program's device."""
        return [as_tensor(x, v, self.device) for x, v in
                zip(_gather_args(self.plan, inputs), self.graph.inputs)]

    def __call__(self, **inputs):
        outs = self.run(*self.prepare(**inputs))
        return outs[0] if len(outs) == 1 else outs


@dataclasses.dataclass
class BatchedProgram(CompiledProgram):
    """Executable for one plan over a batch of same-shape requests: every
    input carries a leading batch axis (scalars become ``(b,)``
    vectors) and every output comes back with it.  The batch size is a
    launch argument, not baked in; callers quantize it (the serving
    engine rounds to powers of two up to its ``max_batch``), and each
    size gets its own graphs."""


def _gather_args(plan: ExecutionPlan, inputs: dict) -> list:
    unexpected = sorted(set(inputs) - set(plan.input_names))
    if unexpected:
        raise TypeError(
            f"unexpected inputs {unexpected}; "
            f"program takes {sorted(plan.input_names)}")
    args = []
    for name in plan.input_names:
        if name not in inputs:
            raise KeyError(f"missing input {name}")
        args.append(inputs[name])
    return args


def _program_fn(plan: ExecutionPlan, fns: list[Callable]) -> Callable:
    """The whole program as one function, values routed by the plan's
    index table (plan.GroupPlan.inputs / plan.outputs)."""

    def read(ref, inputs, group_outs):
        if ref[0] == "input":
            return inputs[ref[1]]
        return group_outs[ref[1]][ref[2]]

    def program(*input_vals):
        inputs = dict(zip(plan.input_names, input_vals))
        group_outs: list[tuple] = []
        for gp, fn in zip(plan.groups, fns):
            group_outs.append(fn(*[read(r, inputs, group_outs)
                                   for r in gp.inputs]))
        return tuple(read(r, inputs, group_outs) for r in plan.outputs)

    program.__name__ = "program_" + plan.signature[:8]
    return program


def compile_plan(g: Graph, plan: ExecutionPlan, hw: HardwareModel = V5E,
                 device="cuda", label: str = "") -> CompiledProgram:
    """ExecutionPlan -> executable on ``device``.  On the ``cuda``
    backend the plan's kernels are built at their first launch (one
    ``nvcc`` run per plan, cached on disk by source hash), or ahead of
    it by ``CompiledProgram.module.build()``.  ``label`` names the
    kernels in ``LAUNCHES`` (default: the plan signature's head)."""
    dev = resolve_device(device)
    impls = plan.bind(g, hw)
    fns, module = _group_fns(g, plan, impls, label, batched=False)
    return CompiledProgram(graph=g, plan=plan, group_impls=impls,
                           fn=_program_fn(plan, fns), device=dev,
                           group_fns=fns, module=module)


def compile_plan_batched(g: Graph, plan: ExecutionPlan,
                         hw: HardwareModel = V5E, device="cuda",
                         label: str = "") -> BatchedProgram:
    """ExecutionPlan -> batched executable: one dispatch per batch, each
    group one launch over the batch (``torch.vmap`` cannot batch a
    ``ctypes`` launch; K1 takes the batch as its items' outer factor)."""
    dev = resolve_device(device)
    impls = plan.bind(g, hw)
    fns, module = _group_fns(g, plan, impls, label, batched=True)
    program = _program_fn(plan, fns)
    program.__name__ = "batched_" + plan.signature[:8]
    return BatchedProgram(graph=g, plan=plan, group_impls=impls, fn=program,
                          device=dev, group_fns=fns, module=module)


# ---------------------------------------------------------------------------
# packed multi-graph programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedProgram(_Runs):
    """One dispatch over SEVERAL member graphs — the cross-sequence
    horizontal fusion of a mixed serving drain.

    Members are in the pack's canonical order.  Every member input is
    batched; members may carry different batch sizes.  Outputs come back
    per member, batched, bitwise equal to what each member's own
    ``BatchedProgram`` gives: each member keeps its own groups and
    kernels, and on a CUDA device the pack replays as one graph over
    all of them."""

    graphs: tuple[Graph, ...]
    packed: PackedPlan
    member_impls: tuple[tuple[Impl, ...], ...]
    fn: Callable             # (*concat inputs) -> tuple(concat outputs)
    device: torch.device
    group_fns: list[Callable]
    modules: tuple = ()
    replays: GraphRunner | None = dataclasses.field(default=None, repr=False)

    @property
    def n_members(self) -> int:
        return self.packed.n_members

    @property
    def n_groups(self) -> int:
        return sum(len(p.groups) for p in self.packed.members)

    def gather(self, member_inputs: Sequence) -> list[torch.Tensor]:
        """Concatenated positional tensors from per-member input dicts
        (canonical member order)."""
        if len(member_inputs) != self.n_members:
            raise ValueError(f"pack has {self.n_members} members, "
                             f"got {len(member_inputs)} input dicts")
        args = []
        for g, p, inputs in zip(self.graphs, self.packed.members,
                                member_inputs):
            args.extend(as_tensor(x, v, self.device) for x, v in
                        zip(_gather_args(p, dict(inputs)), g.inputs))
        return args

    def split(self, outs: tuple) -> list[tuple]:
        """Concatenated outputs -> one tuple per member."""
        offs = self.packed.output_offsets + (self.packed.n_outputs,)
        return [tuple(outs[offs[m]:offs[m + 1]])
                for m in range(self.n_members)]

    def __call__(self, member_inputs: Sequence) -> list[tuple]:
        return self.split(self.run(*self.gather(member_inputs)))


@dataclasses.dataclass
class PackedDispatch:
    """Caller-order view of a (cached, canonical-order) PackedProgram:
    ``perm`` records how THIS caller's member order maps onto the
    canonical order, so a drain that sees the same sequence mix in a
    different arrival order reuses the program."""

    program: PackedProgram
    perm: tuple[int, ...]          # perm[k] = caller index of canonical k

    @property
    def n_members(self) -> int:
        return self.program.n_members

    def __call__(self, member_inputs: Sequence) -> list[tuple]:
        """Run the pack: ``member_inputs[i]`` is member *i*'s input dict
        in the caller's order; returns per-member output tuples in the
        same order."""
        canon = self.program([member_inputs[i] for i in self.perm])
        outs: list = [None] * len(self.perm)
        for k, i in enumerate(self.perm):
            outs[i] = canon[k]
        return outs


def _packed_program_fn(packed: PackedPlan, fns: list[Callable]) -> Callable:
    """The whole pack as one function over concatenated batched inputs:
    the members' disjoint routing tables merged by offset rebasing
    (``PackedPlan.merged_groups``), each group its member's batched
    function."""
    flat = packed.merged_groups()
    out_refs = packed.merged_outputs()

    def read(ref, input_vals, group_outs):
        if ref[0] == "input":
            return input_vals[ref[1]]
        return group_outs[ref[1]][ref[2]]

    def program(*input_vals):
        group_outs: list[tuple] = []
        for (_, gp), fn in zip(flat, fns):
            group_outs.append(fn(*[read(r, input_vals, group_outs)
                                   for r in gp.inputs]))
        return tuple(read(r, input_vals, group_outs) for r in out_refs)

    program.__name__ = "packed_" + packed.signature[:8]
    return program


def compile_plan_packed(graphs: Sequence[Graph], packed: PackedPlan,
                        hw: HardwareModel = V5E,
                        device="cuda") -> PackedProgram:
    """PackedPlan -> executable: ONE dispatch over N member graphs.

    ``graphs`` must align with ``packed.members`` (canonical order);
    each member plan binds to its graph exactly as in ``compile_plan``,
    so per-graph fusion decisions (and kernel names) are preserved —
    the pack only merges the dispatch."""
    if len(graphs) != packed.n_members:
        raise ValueError(f"pack has {packed.n_members} members, "
                         f"got {len(graphs)} graphs")
    dev = resolve_device(device)
    member_impls, fns, modules = [], [], []
    for g, plan in zip(graphs, packed.members):
        impls = plan.bind(g, hw)
        member_impls.append(tuple(impls))
        member_fns, module = _group_fns(g, plan, impls, "", batched=True)
        fns.extend(member_fns)
        modules.append(module)
    return PackedProgram(graphs=tuple(graphs), packed=packed,
                         member_impls=tuple(member_impls),
                         fn=_packed_program_fn(packed, fns), device=dev,
                         group_fns=fns, modules=tuple(modules))


def compile_combination(g: Graph, combo: Combination, backend: str = "torch",
                        device="cuda", hw: HardwareModel = V5E
                        ) -> CompiledProgram:
    """A Combination straight to an executable (no cache, no search);
    the plan passes ``compiler.check_plan`` first."""
    from .compiler import check_plan
    plan = build_plan(g, combo, backend=backend)
    check_plan(plan, g, hw)
    return compile_plan(g, plan, hw=hw, device=device)
