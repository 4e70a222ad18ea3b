"""``python -m repro_torch.analysis`` — lint the whole pipeline statically.

For every selected REGISTRY program the linter traces the graph, runs
the graph checks, searches each selected mode, builds the plan for each
selected backend, and runs the **full** plan verifier (fusion
re-analysis + routing reconstruction + K1 layout/shared-memory contracts) —
all without codegen, so a registry-wide lint is seconds, not minutes.
It then sweeps the on-disk cache directory (``REPRO_PLAN_CACHE_DIR`` or
``--cache-dir``) and reports unreadable or invalid ``*.plan.json`` /
``*.pack.json`` / ``*.meas.json`` entries as RPL311/312/313 *warnings*
— the compile path self-heals those (drop + recompile), so they are
findings, not failures, and the sweep stays read-only (concurrent
writers undisturbed).

Exit status is 1 iff any **error**-severity diagnostic was reported
(warnings alone exit 0), which is what the CI lint step gates on.
"""
from __future__ import annotations

import argparse
import json as _json
import os

from ..core import graph as graph_mod
from ..core import scheduler
from ..core.diagnostics import (KNOWN_BACKENDS, Diagnostic, VerificationError,
                                diag)
from ..core.plan import ExecutionPlan, PackedPlan, build_plan
from ..core.predictor import V5E, HardwareModel
from .checks import (_located, verify_graph, verify_pack, verify_plan,
                     verify_plan_structural)

#: the search modes the linter can run without measuring (``autotune``
#: plans share the ExecutionPlan schema, so cached ones are still
#: covered by the disk sweep)
LINT_MODES = ("best", "unfused")


def lint_program(prog, n: int, backends, modes,
                 hw: HardwareModel = V5E) -> list[Diagnostic]:
    """Lint one registry program: graph checks, then one full plan
    verification per (mode, backend)."""
    out: list[Diagnostic] = []
    try:
        g = graph_mod.trace(prog.script, prog.shapes(n))
    except Exception as e:  # noqa: BLE001 — a trace crash IS a finding
        return [diag("RPL101", prog.name, f"trace failed: {e}")]
    out.extend(_located(verify_graph(g), prog.name))
    space = scheduler.build_space(g, hw)
    for mode in modes:
        try:
            if mode == "unfused":
                combo = scheduler.unfused_combination(space)
            else:
                combo = scheduler.best_combination(space)
        except VerificationError as e:
            out.extend(_located(e.diagnostics, f"{prog.name}/{mode}"))
            continue
        for backend in backends:
            plan = build_plan(g, combo, backend=backend)
            out.extend(_located(verify_plan(plan, g, hw=hw),
                                f"{prog.name}/{mode}/{backend}"))
    return out


def lint_cache_dir(path: str) -> list[Diagnostic]:
    """Read-only sweep over one on-disk cache directory.  Every
    unreadable or schema-invalid entry is a *warning*: the compile path
    heals them (drop + recompile), the linter only surfaces them."""
    out: list[Diagnostic] = []
    if not os.path.isdir(path):
        return out

    def bad(code, name, msg):
        out.append(diag(code, f"cache:{os.path.join(path, name)}", msg,
                        "healed automatically on next compile (dropped "
                        "and recompiled)"))

    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        try:
            if name.endswith(".plan.json"):
                with open(full) as f:
                    plan = ExecutionPlan.from_json(f.read())
                errs = [d for d in verify_plan_structural(plan) if d.is_error]
                if errs:
                    bad("RPL311", name,
                        f"plan entry invalid: {errs[0].format()}")
            elif name.endswith(".pack.json"):
                with open(full) as f:
                    packed = PackedPlan.from_json(f.read())
                errs = [d for d in verify_pack(packed) if d.is_error]
                if errs:
                    bad("RPL312", name,
                        f"pack entry invalid: {errs[0].format()}")
            elif name.endswith(".meas.json"):
                with open(full) as f:
                    rec = _json.load(f)
                if not isinstance(rec, dict):
                    bad("RPL313", name,
                        f"measurement entry is {type(rec).__name__}, "
                        "not an object")
        except Exception as e:  # noqa: BLE001 — any load failure = corrupt
            kind = ("RPL312" if name.endswith(".pack.json") else
                    "RPL313" if name.endswith(".meas.json") else "RPL311")
            if name.endswith((".plan.json", ".pack.json", ".meas.json")):
                bad(kind, name, f"unreadable entry: {e}")
    return out


def main(argv=None) -> int:
    from ..programs import REGISTRY

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify registry programs, their plans, "
                    "and the on-disk plan cache")
    ap.add_argument("--programs", default=None,
                    help="comma-separated program names (default: all "
                         f"{len(REGISTRY)} registry programs)")
    ap.add_argument("--backends", default=",".join(KNOWN_BACKENDS),
                    help="comma-separated backends (default: %(default)s)")
    ap.add_argument("--modes", default=",".join(LINT_MODES),
                    help="comma-separated search modes "
                         "(default: %(default)s)")
    ap.add_argument("--n", type=int, default=512,
                    help="problem size to trace at (default: %(default)s)")
    ap.add_argument("--cache-dir", default=os.environ.get(
                        "REPRO_PLAN_CACHE_DIR"),
                    help="on-disk cache dir to sweep (default: "
                         "$REPRO_PLAN_CACHE_DIR)")
    ap.add_argument("--quick", action="store_true",
                    help="smoke subset: two small programs at n=128")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON instead of text")
    args = ap.parse_args(argv)

    backends = tuple(b for b in args.backends.split(",") if b)
    modes = tuple(m for m in args.modes.split(",") if m)
    diags: list[Diagnostic] = []
    for b in backends:
        if b not in KNOWN_BACKENDS:
            diags.append(diag("RPL401", "cli.--backends",
                              f"unknown backend {b!r}",
                              f"valid backends: {', '.join(KNOWN_BACKENDS)}"))
    for m in modes:
        if m not in LINT_MODES:
            diags.append(diag("RPL402", "cli.--modes",
                              f"unknown lint mode {m!r}",
                              f"valid modes: {', '.join(LINT_MODES)}"))

    if args.quick:
        names, n = ["AXPYDOT", "VADD"], 128
    elif args.programs:
        names, n = [s for s in args.programs.split(",") if s], args.n
        unknown = [s for s in names if s not in REGISTRY]
        for s in unknown:
            diags.append(diag("RPL402", "cli.--programs",
                              f"unknown program {s!r}",
                              f"registry has {sorted(REGISTRY)}"))
        names = [s for s in names if s in REGISTRY]
    else:
        names, n = sorted(REGISTRY), args.n

    n_plans = 0
    if not any(d.is_error for d in diags):
        for name in names:
            diags.extend(lint_program(REGISTRY[name], n, backends, modes))
            n_plans += len(backends) * len(modes)
        if args.cache_dir:
            diags.extend(lint_cache_dir(args.cache_dir))

    n_err = sum(d.is_error for d in diags)
    n_warn = len(diags) - n_err
    if args.as_json:
        print(_json.dumps({
            "programs": names, "n": n, "backends": list(backends),
            "modes": list(modes), "n_plans": n_plans,
            "n_errors": n_err, "n_warnings": n_warn,
            "diagnostics": [d.as_dict() for d in diags]}, indent=2))
    else:
        for d in diags:
            print(d.format())
        verdict = "FAIL" if n_err else "OK"
        print(f"repro_torch.analysis {verdict}: {len(names)} programs x "
              f"{len(modes)} modes x {len(backends)} backends "
              f"({n_plans} plans verified), {n_err} errors, "
              f"{n_warn} warnings")
    return 1 if n_err else 0
