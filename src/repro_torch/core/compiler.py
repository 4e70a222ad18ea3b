"""Facade: the source-to-source fusion compiler (paper §4).

Typical use::

    from repro_torch.core import FusionCompiler
    cc = FusionCompiler()                          # cuda backend on the GPU
    prog = cc.compile(script, {"A": (4096, 4096), "p": (4096,), "r": (4096,)})
    q, s = prog(A=A, p=p, r=r)

``compile`` runs the pipeline stages: trace, optimization-space
generation + combination search, plan construction, code generation —
with two cache layers short-circuiting repeat work:

* a **program cache** hit (same script/shapes/dtype/backend/device/mode
  in this process) returns the finished ``CompiledProgram`` — no
  re-trace, no re-search, no re-codegen, no kernel build;
* a **plan cache** hit (same traced graph, possibly from disk across
  processes) skips space generation and search, the expensive stages.

The search runs under the reference's ``V5E`` cost-model constants, so
it picks exactly the plans the JAX reference picks.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Sequence

import numpy as np

from . import codegen, graph, scheduler
from .cache import PlanCache, default_cache
from .diagnostics import KNOWN_BACKENDS, VerificationError
from .plan import build_plan, graph_signature
from .predictor import V5E, HardwareModel
from .scheduler import Combination, OptimizationSpace

#: search modes with names (integer ranks are also accepted)
MODES = ("best", "unfused")


class FusionCompiler:
    def __init__(self, hw: HardwareModel = V5E, backend: str = "cuda",
                 device="cuda", max_impls_per_fusion: int = 64,
                 dtype=np.float32, cache: PlanCache | bool | None = True):
        """``backend`` is ``"cuda"`` (one generated kernel per fused
        group) or ``"torch"`` (plain tensor code per group); ``device``
        is where programs run — asking for ``"cuda"`` on a machine
        without a CUDA device raises."""
        self._check_backend(backend)
        self.device = codegen.resolve_device(device)
        if cache is True:
            self.cache: PlanCache | None = default_cache()
        else:
            self.cache = cache or None
        self.hw = hw
        self.backend = backend
        self.max_impls = max_impls_per_fusion
        self.dtype = np.dtype(dtype)

    @staticmethod
    def _check_backend(backend: str):
        """RPL401 — reject unknown backends at the API boundary."""
        if backend not in KNOWN_BACKENDS:
            raise VerificationError.single(
                "RPL401", "config.backend",
                f"unknown backend {backend!r}",
                f"valid backends: {', '.join(KNOWN_BACKENDS)}")

    # -- stages ------------------------------------------------------------
    def trace(self, script: Callable, input_shapes: dict[str, Sequence[int]]
              ) -> graph.Graph:
        return graph.trace(script, input_shapes, dtype=self.dtype)

    def space(self, g: graph.Graph) -> OptimizationSpace:
        return scheduler.build_space(g, self.hw, self.max_impls)

    def search(self, space: OptimizationSpace, mode) -> Combination:
        """Pick a combination: ``'best'`` / ``'unfused'`` / an integer
        rank into the predicted-order stream."""
        self._mode_key(mode)            # validate (bools, unknown strings)
        if mode == "best":
            return scheduler.best_combination(space)
        if mode == "unfused":
            return scheduler.unfused_combination(space)
        if mode < 0:
            raise VerificationError.single(
                "RPL402", "config.mode",
                f"combination index must be >= 0, got {mode}")
        combos = scheduler.enumerate_combinations(space, limit=mode + 1)
        if not combos:
            raise VerificationError.single(
                "RPL220", "scheduler",
                "no legal combination covers the graph (the "
                "optimization space enumerated empty — every fusion "
                "impl may have been pruned, e.g. by the VMEM budget)")
        if mode >= len(combos):
            raise VerificationError.single(
                "RPL402", "config.mode",
                f"combination index {mode} out of range: the space has "
                f"only {len(combos)} legal combination(s)")
        return combos[mode]

    # -- cache keys --------------------------------------------------------
    def _mode_key(self, mode):
        """Validate ``mode`` and return its cache-key form.  Bools are
        rejected explicitly: ``isinstance(True, int)`` holds."""
        if isinstance(mode, bool) or not isinstance(mode, (str, int)) or \
                (isinstance(mode, str) and mode not in MODES):
            raise VerificationError.single(
                "RPL402", "config.mode",
                f"unknown mode {mode!r}: valid modes are "
                f"{', '.join(repr(m) for m in MODES)}, or an integer "
                f"rank into the predicted-order combination stream")
        return mode

    def _config_key(self, backend: str, mode_key) -> str:
        # full hw repr, not just .name: custom models keep the default name
        return repr((backend, mode_key, self.hw, self.max_impls))

    @classmethod
    def _cell_fingerprint(cls, val, _seen: set | None = None) -> tuple | None:
        """Stable *content* fingerprint of one closure-cell value, or
        None when the value has no address-free identity (default
        object reprs embed a reusable memory address; large ndarray
        reprs elide).

        Recurses structurally: containers fingerprint element-wise,
        dataclass instances field-wise, and functions by bytecode +
        consts + names + their OWN closure cells — so two structurally
        equal closures built at different addresses alias to one
        program-cache entry, while a nested closure whose captured
        value differs can never alias (the earlier bytecode-only
        function fingerprint let it)."""
        if _seen is None:
            _seen = set()
        if id(val) in _seen:
            return ("cycle",)
        code = getattr(val, "__code__", None)
        if code is not None:
            _seen.add(id(val))
            consts = tuple(c.co_code if hasattr(c, "co_code") else repr(c)
                           for c in code.co_consts)
            cells = getattr(val, "__closure__", None) or ()
            prints = [cls._cell_fingerprint(c.cell_contents, _seen)
                      for c in cells]
            if any(p is None for p in prints):
                return None
            return ("fn", code.co_code, repr(consts), repr(code.co_names),
                    repr(prints))
        if isinstance(val, np.ndarray):
            return ("arr", val.shape, str(val.dtype),
                    hashlib.sha256(np.ascontiguousarray(val).tobytes())
                    .hexdigest())
        if isinstance(val, (int, float, complex, str, bytes, bool,
                            type(None))):
            return ("lit", repr(val))
        if isinstance(val, (tuple, list)):
            _seen.add(id(val))
            items = [cls._cell_fingerprint(v, _seen) for v in val]
            if any(p is None for p in items):
                return None
            return (type(val).__name__, repr(items))
        if isinstance(val, dict):
            _seen.add(id(val))
            pairs = []
            for k, v in val.items():
                kp = cls._cell_fingerprint(k, _seen)
                vp = cls._cell_fingerprint(v, _seen)
                if kp is None or vp is None:
                    return None
                pairs.append((kp, vp))
            pairs.sort(key=repr)
            return ("dict", repr(pairs))
        if isinstance(val, (set, frozenset)):
            items = [cls._cell_fingerprint(v, _seen) for v in val]
            if any(p is None for p in items):
                return None
            items.sort(key=repr)
            return ("set", repr(items))
        if dataclasses.is_dataclass(val) and not isinstance(val, type):
            _seen.add(id(val))
            fields = []
            for f in dataclasses.fields(val):
                fp = cls._cell_fingerprint(getattr(val, f.name), _seen)
                if fp is None:
                    return None
                fields.append((f.name, fp))
            return ("dc", type(val).__module__, type(val).__qualname__,
                    repr(fields))
        r = repr(val)
        return None if " at 0x" in r else ("repr", r)

    def _program_key(self, script: Callable,
                     input_shapes: dict[str, Sequence[int]],
                     backend: str, mode_key) -> str | None:
        """Pre-trace content address of a compile request, or None when
        the script is not safely addressable (a closure cell without a
        stable fingerprint) — the caller then skips the program layer
        and relies on the plan layer, which keys on the actual trace."""
        code = getattr(script, "__code__", None)
        if code is not None:
            consts = tuple(c.co_code if hasattr(c, "co_code") else repr(c)
                           for c in code.co_consts)
            ident = (getattr(script, "__module__", ""),
                     getattr(script, "__qualname__", ""),
                     code.co_code, repr(consts), repr(code.co_names))
            cells = getattr(script, "__closure__", None) or ()
            prints = [self._cell_fingerprint(c.cell_contents) for c in cells]
            if any(p is None for p in prints):
                return None
            ident += (repr(prints),)
        else:
            ident = (repr(script),)
        payload = repr((ident,
                        sorted((k, tuple(v)) for k, v in input_shapes.items()),
                        str(self.dtype), str(self.device),
                        self._config_key(backend, mode_key)))
        return hashlib.sha256(payload.encode()).hexdigest()

    def _plan_key(self, g: graph.Graph, backend: str, mode_key) -> str:
        payload = repr((graph_signature(g),
                        self._config_key(backend, mode_key)))
        return hashlib.sha256(payload.encode()).hexdigest()

    def _plan_for(self, g: graph.Graph, mode, backend: str, mode_key):
        """Plan-cache-consulting search."""
        cache = self.cache
        plan = plan_key = None
        if cache is not None:
            plan_key = self._plan_key(g, backend, mode_key)
            plan = cache.get_plan(plan_key)
            if plan is not None and (plan.signature != graph_signature(g)
                                     or plan.backend != backend):
                plan = None              # foreign entry under our key
        if plan is None:
            combo = self.search(self.space(g), mode)
            plan = build_plan(g, combo, backend=backend)
            if cache is not None:
                cache.put_plan(plan_key, plan)
        return plan

    # -- main entry point ----------------------------------------------------
    def compile(self, script: Callable, input_shapes: dict[str, Sequence[int]],
                mode="best", backend: str | None = None,
                label: str = "") -> codegen.CompiledProgram:
        """Compile a sequence script into one whole-program function.

        Args:
          script: a sequence script ``(g, **vars) -> outputs`` built
            from elementary calls (e.g. ``REGISTRY["GEMVER"].script``).
          input_shapes: ``{input name: shape tuple}`` — the trace is
            shape-specialized, like the paper's generated CUDA.
          mode: ``'best'`` (predicted-best combination), ``'unfused'``
            (one kernel per call), or an integer rank into the
            ``t_pred``-sorted combination stream.
          backend: ``'cuda'`` or ``'torch'`` (defaults to the
            compiler's).
          label: names the program's kernels in the launch counter.

        Returns:
          A ``CompiledProgram``; calling it with keyword inputs runs
          every group of the plan on the compiler's device.

        Raises:
          VerificationError: unknown backend (RPL401), unknown or bool
            ``mode`` or a rank past the last combination (RPL402).

        Example::

            cc = FusionCompiler(device="cpu")
            prog = cc.compile(REGISTRY["AXPYDOT"].script,
                              REGISTRY["AXPYDOT"].shapes(1024))
            z, r = prog(w=w, v=v, u=u, alpha=np.float32(0.3))
        """
        backend = backend or self.backend
        self._check_backend(backend)
        mode_key = self._mode_key(mode)
        cache = self.cache
        pkey = None
        if cache is not None:
            pkey = self._program_key(script, input_shapes, backend, mode_key)
            if pkey is not None:
                prog = cache.get_program(pkey)
                if prog is not None:
                    return prog

        g = self.trace(script, input_shapes)
        plan = self._plan_for(g, mode, backend, mode_key)
        prog = codegen.compile_plan(g, plan, hw=self.hw, device=self.device,
                                    label=label)
        if cache is not None and pkey is not None:
            cache.put_program(pkey, prog)
        return prog
