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
boundaries are the compiler's kernel boundaries as they stand.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .cuda_codegen import GroupKernel, PlanModule, torch_dtype
from .diagnostics import VerificationError
from .fusion import Fusion
from .graph import Graph, Var
from .plan import ExecutionPlan
from .predictor import V5E, HardwareModel, Impl


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


# ---------------------------------------------------------------------------
# whole-program executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledProgram:
    """Executable for one plan: ``fn`` runs every group in plan order."""

    graph: Graph
    plan: ExecutionPlan
    group_impls: list[Impl]        # topological order, bound to `graph`
    fn: Callable                   # (*input tensors) -> tuple(outputs)
    device: torch.device
    group_fns: list[Callable]      # one per plan group, in plan order
    module: PlanModule | None = None   # the generated source (cuda backend)

    @property
    def n_groups(self) -> int:
        return len(self.plan.groups)

    def prepare(self, **inputs) -> list[torch.Tensor]:
        """The inputs as positional tensors on the program's device."""
        return [as_tensor(x, v, self.device) for x, v in
                zip(_gather_args(self.plan, inputs), self.graph.inputs)]

    def __call__(self, **inputs):
        outs = self.fn(*self.prepare(**inputs))
        return outs[0] if len(outs) == 1 else outs

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


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


def _check_groups(plan: ExecutionPlan):
    """Every group must produce an output.  A dead call (one whose
    output nothing reads) forms a zero-output group; this raises RPL204
    as the reference does under full verification."""
    for gi, gp in enumerate(plan.groups):
        if gp.n_outputs < 1:
            raise VerificationError.single(
                "RPL204", f"plan.groups[{gi}].n_outputs",
                f"group must produce >= 1 outputs, has {gp.n_outputs!r}")


def compile_plan(g: Graph, plan: ExecutionPlan, hw: HardwareModel = V5E,
                 device="cuda", label: str = "") -> CompiledProgram:
    """ExecutionPlan -> executable on ``device``.  On the ``cuda``
    backend the plan's kernels are built at their first launch (one
    ``nvcc`` run per plan, cached on disk by source hash), or ahead of
    it by ``CompiledProgram.module.build()``."""
    dev = resolve_device(device)
    impls = plan.bind(g, hw)
    _check_groups(plan)
    module = None
    if plan.backend == "torch":
        fns = [_group_dense_fn(im.fusion) for im in impls]
    elif plan.backend == "cuda":
        module = PlanModule(g, impls)
        label = label or plan.signature[:8]
        fns = [GroupKernel(module, gi, label) for gi in range(len(impls))]
    else:
        raise VerificationError.single(
            "RPL401", "plan.backend", f"unknown backend {plan.backend}")
    return CompiledProgram(graph=g, plan=plan, group_impls=impls,
                           fn=_program_fn(plan, fns), device=dev,
                           group_fns=fns, module=module)
