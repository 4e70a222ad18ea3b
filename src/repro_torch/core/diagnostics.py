"""Stable diagnostic taxonomy for the static plan/IR verifier.

One error vocabulary for the whole pipeline (DESIGN.md §11): every
invariant the compiler assumes — graph well-formedness, plan routing,
fusion legality under a chosen grid order, pack rebasing, cache entry
schemas, configuration — reports through a :class:`Diagnostic` with a
*stable* code, instead of a deep ``ValueError``/``KeyError`` stack
trace from wherever the assumption first broke.  The codes are part of
the project's contract: tests pin them, the CLI prints them, and they
never get renumbered.

Code ranges
===========

========  =================================================
``RPL1xx``  graph (traced IR) checks
``RPL2xx``  plan checks (``ExecutionPlan`` + search results)
``RPL3xx``  pack + cache-entry checks
``RPL4xx``  configuration / CLI checks
========  =================================================

This module is a dependency leaf — it imports nothing from the rest of
``repro_torch`` (and no torch), so every layer (``core.graph`` up to
``launch.serve``) can raise through it without import cycles.  The
checkers that *emit* most of these diagnostics live in
``repro.analysis``.
"""
from __future__ import annotations

import dataclasses

#: The codegen backends the pipeline can emit (``codegen._group_fns``):
#: ``torch`` runs each group as plain tensor code (the dense path),
#: ``cuda`` as one generated CUDA kernel per group (kernel K1).  Lives
#: here (not in ``codegen``) so argument parsers and config validation
#: can check a backend name without importing the codegen stack.
KNOWN_BACKENDS = ("torch", "cuda")

#: severity levels, mild to fatal
SEVERITIES = ("warn", "error")

#: Every stable diagnostic code: ``code -> (default severity, summary)``.
#: Append-only — codes are pinned by tests and external tooling.
CODES: dict[str, tuple[str, str]] = {
    # -- RPL1xx: graph checks ----------------------------------------------
    "RPL101": ("error", "graph dataflow ill-formed (arg produced by a later "
                        "call, or call index out of order)"),
    "RPL102": ("error", "shape/axis inconsistency along a graph edge"),
    "RPL103": ("error", "dtype flow mismatch (call output dtype is not the "
                        "promotion of its argument dtypes)"),
    "RPL104": ("warn",  "identity padding unsound for this graph (serving "
                        "must use per-lane masking)"),
    "RPL105": ("error", "masked graph routes a padded reduce axis into a "
                        "reduction without the matching mask elementary"),
    "RPL130": ("error", "masked-wrapper misuse (no padded dims, independent "
                        "padded extents, or reserved input name)"),
    "RPL131": ("error", "no mask elementary for this (rank, dim)"),
    # -- RPL2xx: plan checks -----------------------------------------------
    "RPL201": ("error", "plan malformed (version/backend/dtype/t_pred "
                        "field invalid)"),
    "RPL202": ("error", "routing ref does not resolve"),
    "RPL203": ("error", "routing ref breaks topological group order"),
    "RPL204": ("error", "group plan malformed (order/blocks/n_outputs "
                        "inconsistent)"),
    "RPL205": ("error", "call coverage broken (duplicate, unordered, or "
                        "out-of-range call indices)"),
    "RPL210": ("error", "plan/graph signature mismatch"),
    "RPL211": ("error", "plan group is not a legal fusion of this graph"),
    "RPL212": ("error", "grid order invalid for the bound fusion"),
    "RPL213": ("error", "block size illegal for the bound fusion axis"),
    "RPL214": ("error", "consumed reduction not accumulable under the "
                        "plan's grid order (pallas phase contract)"),
    "RPL215": ("error", "group VMEM footprint (blocks + consumed-reduction "
                        "scratch) exceeds the budget"),
    "RPL216": ("error", "group input routing disagrees with the graph's "
                        "dataflow"),
    "RPL217": ("error", "plan output routing disagrees with the graph's "
                        "outputs"),
    "RPL218": ("error", "plan does not cover every graph call exactly once"),
    "RPL219": ("error", "plan dtype does not match the graph"),
    "RPL220": ("error", "no legal combination covers the graph"),
    "RPL221": ("error", "unfused baseline impossible (a single-call "
                        "implementation was pruned)"),
    # -- RPL3xx: pack + cache checks ---------------------------------------
    "RPL301": ("error", "pack members not in canonical (sorted-fingerprint) "
                        "order"),
    "RPL302": ("error", "pack member plan invalid"),
    "RPL303": ("error", "pack offset rebasing not disjoint/complete"),
    "RPL304": ("error", "pack does not align with the member graphs"),
    "RPL311": ("warn",  "corrupt plan cache entry on disk (healed: dropped "
                        "and recompiled on next use)"),
    "RPL312": ("warn",  "corrupt pack cache entry on disk (healed: dropped "
                        "and recompiled on next use)"),
    "RPL313": ("warn",  "corrupt or foreign-schema measurement cache entry "
                        "on disk"),
    # -- RPL4xx: configuration ---------------------------------------------
    "RPL401": ("error", "unknown backend"),
    "RPL402": ("error", "unknown search mode"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured verifier finding.

    ``location`` is a stable dotted path into the checked artifact
    (``graph.calls[3]``, ``plan.groups[1].inputs[0]``,
    ``pack.members[2]``, ``cache:/dir/key.plan.json``, ``config``) so a
    reader can find the fault without a stack trace; ``hint`` says how
    to fix it.
    """

    code: str
    severity: str                  # "error" | "warn"
    location: str
    message: str
    hint: str = ""

    def __post_init__(self):
        assert self.code in CODES, f"unregistered diagnostic code {self.code}"
        assert self.severity in SEVERITIES, self.severity

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def format(self) -> str:
        s = f"{self.code} {self.severity} at {self.location}: {self.message}"
        if self.hint:
            s += f" (hint: {self.hint})"
        return s

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def diag(code: str, location: str, message: str, hint: str = "",
         severity: str | None = None) -> Diagnostic:
    """Build a Diagnostic, defaulting severity from the code registry."""
    return Diagnostic(code=code, severity=severity or CODES[code][0],
                      location=location, message=message, hint=hint)


class VerificationError(ValueError):
    """A verifier failure carrying its structured diagnostics.

    Subclasses ``ValueError`` deliberately: every pre-existing error
    site this taxonomy absorbed raised ``ValueError``, so callers (and
    the cache's corrupt-entry healing) keep working unchanged while
    gaining ``.diagnostics``.
    """

    def __init__(self, diagnostics, message: str | None = None):
        if isinstance(diagnostics, Diagnostic):
            diagnostics = [diagnostics]
        self.diagnostics: list[Diagnostic] = list(diagnostics)
        if message is None:
            message = "; ".join(d.format() for d in self.diagnostics) \
                or "verification failed"
        super().__init__(message)

    @classmethod
    def single(cls, code: str, location: str, message: str,
               hint: str = "") -> "VerificationError":
        return cls(diag(code, location, message, hint))

    @property
    def codes(self) -> tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)


class UnsupportedGroupError(VerificationError, NotImplementedError):
    """A plan group the chosen backend cannot emit (e.g. a consumed
    reduction whose reduce axes are not an innermost suffix of the grid
    order).  Doubly inherits ``NotImplementedError`` for compatibility
    with the historical codegen contract (DESIGN.md §2 group-split)."""


def raise_if_errors(diagnostics) -> None:
    """Raise a :class:`VerificationError` when any diagnostic in the
    list is error-severity (warnings alone never raise)."""
    errors = [d for d in diagnostics if d.is_error]
    if errors:
        raise VerificationError(errors)
