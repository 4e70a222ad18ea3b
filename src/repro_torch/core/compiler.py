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
it picks exactly the plans the JAX reference picks, unless the caller
passes ``hw="calibrate"`` (constants measured on this machine) or a
model of its own.  ``mode="autotune"`` measures the top candidates
(``core.autotune``).  Every cache-served plan is checked by the static
verifier before it runs (``repro_torch.analysis``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Callable, Sequence

import numpy as np

from . import autotune, codegen, graph, scheduler
from .cache import PlanCache, default_cache
from .diagnostics import (KNOWN_BACKENDS, UnsupportedGroupError,
                          VerificationError, raise_if_errors)
from .plan import (build_packed_plan, build_plan, canonical_pack_order,
                   graph_signature, pack_signature, plan_fingerprint)
from .predictor import V5E, HardwareModel
from .scheduler import Combination, OptimizationSpace

log = logging.getLogger("repro_torch.compiler")

#: search modes with names (integer ranks are also accepted)
MODES = ("best", "unfused", "autotune")

#: the verifier's codes for a group the backend cannot emit
UNSUPPORTED_CODES = {"RPL214", "RPL215"}

#: env var switching every compiler to the FULL verification pass
#: (graph-bound plan checks on every compile) — the test suite sets it;
#: the same variable as the reference's
VERIFY_ENV = "REPRO_VERIFY"


def _env_verify() -> bool:
    return os.environ.get(VERIFY_ENV, "").strip().lower() not in (
        "", "0", "false", "no")


def check_plan(plan, g: graph.Graph, hw: HardwareModel = V5E,
               full: bool = False):
    """Raise on a freshly built plan the static verifier rejects: the
    structural pass (a dead call's zero-output group is RPL204), or
    with ``full`` the graph-bound pass.  Such a plan is a compiler bug,
    not a stale cache entry — it is surfaced, never published.  Raises
    ``UnsupportedGroupError`` where only RPL214/215 fire (a group the
    backend cannot emit, as codegen would), else ``VerificationError``."""
    from ..analysis.checks import verify_plan, verify_plan_structural
    errors = [d for d in (verify_plan(plan, g, hw=hw) if full
                          else verify_plan_structural(plan)) if d.is_error]
    if errors:
        unsupported = {d.code for d in errors} <= UNSUPPORTED_CODES
        raise (UnsupportedGroupError if unsupported
               else VerificationError)(errors)


@dataclasses.dataclass
class CompileReport:
    """What one full pipeline run found (``compile(report=True)``)."""

    n_fusions: int
    n_impls: int
    n_combinations: int
    t_trace_s: float
    t_space_s: float
    t_codegen_s: float
    best: Combination
    unfused: Combination

    @property
    def predicted_speedup(self) -> float:
        return self.unfused.t_pred / self.best.t_pred


class FusionCompiler:
    def __init__(self, hw: HardwareModel | str = V5E, backend: str = "cuda",
                 device="cuda", max_impls_per_fusion: int = 64,
                 dtype=np.float32, cache: PlanCache | bool | None = True,
                 autotune_budget: int = 8,
                 autotune_reps: int = autotune.MEAS_REPS,
                 autotune_warmup: int = autotune.MEAS_WARMUP,
                 verify: bool | None = None):
        """``backend`` is ``"cuda"`` (one generated kernel per fused
        group) or ``"torch"`` (plain tensor code per group); ``device``
        is where programs run — asking for ``"cuda"`` on a machine
        without a CUDA device raises.

        ``hw`` takes a HardwareModel or the string ``"calibrate"``
        (micro-benchmark ``device`` against this compiler's cache,
        ``autotune.calibrate_hardware``).  ``autotune_budget`` is how
        many predicted-best candidates ``mode="autotune"`` measures; it
        is part of the autotune cache keys (a bigger budget is a deeper
        search), while reps/warmup are measurement discipline only.

        ``verify`` selects the static-verification depth.  ``False``:
        the cheap always-on subset still runs on every cache-served plan
        (structural + signature — a corrupt entry is dropped and
        recompiled, never executed).  ``True`` (or env ``REPRO_VERIFY=1``
        when ``None``): every compile additionally runs the full
        graph-bound pass — fusion re-analysis, routing reconstruction,
        K1's layout and shared-memory contracts on the ``cuda`` backend
        — and raises ``VerificationError`` on any error diagnostic."""
        self._check_backend(backend)
        self.verify = _env_verify() if verify is None else bool(verify)
        self.device = codegen.resolve_device(device)
        if cache is True:
            self.cache: PlanCache | None = default_cache()
        else:
            self.cache = cache or None
        if isinstance(hw, str):
            if hw != "calibrate":
                raise ValueError(f"unknown hw {hw!r}: pass a HardwareModel "
                                 "or the string 'calibrate'")
            # calibrate against THIS compiler's cache, so processes
            # sharing plans through it share the constants too
            hw = autotune.calibrate_hardware(self.device, cache=self.cache)
        self.hw = hw
        self.backend = backend
        self.max_impls = max_impls_per_fusion
        self.dtype = np.dtype(dtype)
        self.autotune_budget = autotune_budget
        self.autotune_reps = autotune_reps
        self.autotune_warmup = autotune_warmup
        #: report of the most recent autotune *search* this compiler ran
        #: (None until one runs; cache-served compiles don't update it)
        self.last_autotune: autotune.AutotuneReport | None = None

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

    def search(self, space: OptimizationSpace, mode,
               backend: str | None = None) -> Combination:
        """Pick a combination: ``'best'`` / ``'unfused'`` / an integer
        rank into the predicted-order stream / ``'autotune'`` (measure
        the top ``autotune_budget`` candidates and take the measured
        winner)."""
        self._mode_key(mode)            # validate (bools, unknown strings)
        if mode == "autotune":
            combo, _ = self._autotune(space, backend or self.backend)
            return combo
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

    def _autotune(self, space: OptimizationSpace, backend: str):
        """One call site for the measured-cost search (used by both
        ``search`` and ``_plan_for``); records ``last_autotune``."""
        combo, plan, report = autotune.autotune_combination(
            space, hw=self.hw, backend=backend, device=self.device,
            cache=self.cache, budget=self.autotune_budget,
            reps=self.autotune_reps, warmup=self.autotune_warmup)
        self.last_autotune = report
        return combo, plan

    def refit_hardware(self) -> HardwareModel:
        """Recalibrate this compiler's cost model from the cache's
        accumulated per-group measurement records
        (``HardwareModel.refit``) and adopt the result.

        With no cache or an empty/too-small group table this is a
        strict no-op (``self.hw`` unchanged, later compiles produce
        bit-identical plans).  When the refit *does* change the
        constants, the model's repr — a component of every plan and
        program cache key — changes with it, so subsequent compiles
        search fresh plans under the better predictor."""
        if self.cache is not None:
            self.hw = self.hw.refit(self.cache.group_records())
        return self.hw

    # -- cache keys --------------------------------------------------------
    def _mode_key(self, mode):
        """Validate ``mode`` and return its cache-key form.

        ``'autotune'`` keys as ``('autotune', budget)`` — a bigger
        budget is a deeper search, so it must not alias a shallower
        one.  Bools are rejected explicitly: ``isinstance(True, int)``
        holds."""
        if isinstance(mode, bool) or not isinstance(mode, (str, int)) or \
                (isinstance(mode, str) and mode not in MODES):
            raise VerificationError.single(
                "RPL402", "config.mode",
                f"unknown mode {mode!r}: valid modes are "
                f"{', '.join(repr(m) for m in MODES)}, or an integer "
                f"rank into the predicted-order combination stream")
        if mode == "autotune":
            return ("autotune", self.autotune_budget)
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

    # -- shared plan resolution ---------------------------------------------
    def _verify_served_plan(self, plan, g: graph.Graph,
                            plan_key: str | None, backend: str) -> bool:
        """The always-on safety net: every cache-served plan — in-memory
        or disk-deserialized, possibly written by another process — is
        verified BEFORE codegen can execute it.  Default depth is the
        quick subset (structural + signature + coverage, microseconds);
        under ``verify`` it is the full graph-bound pass.  A rejected
        plan (or one for another backend under our key) is *healed*:
        dropped from memory and disk (so first-writer-wins can
        republish) and the caller recompiles — never raises, never
        executes the bad plan."""
        from ..analysis.checks import verify_plan, verify_plan_quick
        diags = (verify_plan(plan, g, hw=self.hw) if self.verify
                 else verify_plan_quick(plan, g))
        errors = [d.format() for d in diags if d.is_error]
        if plan.backend != backend:
            errors.append(f"plan backend {plan.backend!r} under a "
                          f"{backend!r} key")
        if not errors:
            return True
        log.warning(
            "cache-served plan rejected by static verification; healing "
            "(drop + recompile): %s", "; ".join(errors))
        if self.cache is not None and plan_key is not None:
            self.cache.drop_plan(plan_key)
        return False

    def _resolved_plan(self, g: graph.Graph, backend: str,
                       plan_key: str | None, make: Callable):
        """The one way a plan reaches codegen.  A plan the cache serves
        under ``plan_key`` passes ``_verify_served_plan`` (rejected:
        healed, and rebuilt here); else ``make()`` builds one, which
        passes ``check_plan`` (structural, or the full pass under
        ``verify``) and is published under ``plan_key``.  ``plan_key``
        None: no cache.  Returns None where ``make()`` does."""
        cache = self.cache if plan_key is not None else None
        if cache is not None:
            plan = cache.get_plan(plan_key)
            if plan is not None and \
                    self._verify_served_plan(plan, g, plan_key, backend):
                return plan
        plan = make()
        if plan is None:
            return None
        check_plan(plan, g, self.hw, full=self.verify)
        if cache is not None:
            cache.put_plan(plan_key, plan)
        return plan

    def _plan_for(self, g: graph.Graph, mode, backend: str, mode_key):
        """Plan-cache-consulting search shared by every entry point
        (unbatched / batched / packed — they key plans identically, so a
        plan found by one is a hit for all).  A plan-layer hit for
        ``mode='autotune'`` performs zero measurements — the winner was
        already decided (possibly by another process via the disk
        layer)."""
        def search():
            space = self.space(g)
            if mode == "autotune":
                return self._autotune(space, backend)[1]
            return build_plan(g, self.search(space, mode, backend=backend),
                              backend=backend)

        plan_key = (self._plan_key(g, backend, mode_key)
                    if self.cache is not None else None)
        return self._resolved_plan(g, backend, plan_key, search)

    @staticmethod
    def _bucket_label(input_shapes: dict[str, Sequence[int]]) -> str:
        dims = [d for v in input_shapes.values() for d in v]
        return str(max(dims)) if dims else "scalar"

    # -- main entry points ---------------------------------------------------
    def compile(self, script: Callable, input_shapes: dict[str, Sequence[int]],
                mode="best", backend: str | None = None,
                label: str = "", report: bool = False):
        """Compile a sequence script into one whole-program function.

        Args:
          script: a sequence script ``(g, **vars) -> outputs`` built
            from elementary calls (e.g. ``REGISTRY["GEMVER"].script``).
          input_shapes: ``{input name: shape tuple}`` — the trace is
            shape-specialized, like the paper's generated CUDA.
          mode: ``'best'`` (predicted-best combination), ``'unfused'``
            (one kernel per call), ``'autotune'`` (measure the top
            ``autotune_budget`` predicted candidates and take the
            measured winner — the paper's §5.2 empirical search;
            measurements persist in the cache's measured-cost table,
            so a repeat compile measures nothing), or an integer rank
            into the ``t_pred``-sorted combination stream.
          backend: ``'cuda'`` or ``'torch'`` (defaults to the
            compiler's).
          label: names the program's kernels in the launch counter.
          report: diagnostic path — always runs the full pipeline
            (bypassing both cache layers) and returns
            ``(program, CompileReport)``.

        Returns:
          A ``CompiledProgram``; calling it with keyword inputs runs
          every group of the plan on the compiler's device.

        Raises:
          VerificationError: unknown backend (RPL401), unknown or bool
            ``mode`` or a rank past the last combination (RPL402), a
            plan the verifier rejects (a dead call's zero-output group
            is RPL204).

        Example::

            cc = FusionCompiler(device="cpu")
            prog = cc.compile(REGISTRY["AXPYDOT"].script,
                              REGISTRY["AXPYDOT"].shapes(1024))
            z, r = prog(w=w, v=v, u=u, alpha=np.float32(0.3))
        """
        backend = backend or self.backend
        self._check_backend(backend)
        mode_key = self._mode_key(mode)
        if report:
            return self._compile_report(script, input_shapes, mode, backend,
                                        label)
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

    def compile_batched(self, script, input_shapes: dict[str, Sequence[int]],
                        mode="best",
                        backend: str | None = None,
                        bucket: str | None = None
                        ) -> codegen.BatchedProgram:
        """Batched variant of :meth:`compile` for the serving engine.

        Args:
          script, input_shapes, mode, backend: as :meth:`compile`; the
            shapes describe ONE request — the returned program adds a
            leading batch axis to every input and output (scalars
            become ``(b,)`` vectors), running a whole shape bucket of
            requests as one dispatch, each group one launch; the
            batch size is the inputs' leading dimension at call time.
          bucket: label for this compile in ``cache.stats.buckets``;
            defaults to the largest input dimension, e.g. ``"1024"``.

        Returns:
          A ``BatchedProgram``.  The plan layer is shared with the
          unbatched path (same trace, same search, same key); the
          program layer keys the batched program separately.

        Example::

            prog = cc.compile_batched(seq.script, seq.shapes(1024))
            z, r = prog(w=W, v=V, u=U, alpha=np.ones(8, np.float32))
            # W/V/U: (8, 1024); z: (8, 1024); r: (8,)
        """
        backend = backend or self.backend
        self._check_backend(backend)
        mode_key = self._mode_key(mode)
        bucket = bucket or self._bucket_label(input_shapes)
        t0 = time.perf_counter()
        cache = self.cache
        pkey = None
        if cache is not None:
            pkey = self._program_key(script, input_shapes, backend,
                                     ("batched", mode_key))
            if pkey is not None:
                prog = cache.get_program(pkey)
                if prog is not None:
                    cache.stats.record_bucket(
                        bucket, hit=True, seconds=time.perf_counter() - t0)
                    return prog

        g = self.trace(script, input_shapes)
        plan = self._plan_for(g, mode, backend, mode_key)
        prog = codegen.compile_plan_batched(g, plan, hw=self.hw,
                                            device=self.device)
        if cache is not None:
            if pkey is not None:
                cache.put_program(pkey, prog)
            cache.stats.record_bucket(
                bucket, hit=False, seconds=time.perf_counter() - t0)
        return prog

    def compile_sharded(self, script, input_shapes: dict[str, Sequence[int]],
                        mesh, axis: str = "data", max_batch: int = 8,
                        mode="best", backend: str | None = None,
                        bucket: str | None = None):
        """Sharded variant of :meth:`compile_batched` for replica-sharded
        serving: the batched program spread over the ``axis`` replicas
        of ``mesh`` (``dist.sharding.shard_program``), so one global
        batch runs as contiguous per-replica row blocks, each on its
        replica's device, with no communication between them.

        Args:
          script, input_shapes, mode, backend, bucket: as
            :meth:`compile_batched`.
          mesh: a ``launch.mesh.Mesh`` holding the replica axis
            (``make_data_mesh()`` for a pure replica mesh).
          axis: the mesh axis to spread the batch over.
          max_batch: the largest global batch (a cache-key component,
            as the reference's).

        Returns:
          A ``dist.sharding.ShardedProgram`` whose batch sizes must be
          multiples of the replica count (``ShardedServingEngine``
          quantizes its dispatches so), or, when ``axis`` has size 1,
          exactly :meth:`compile_batched`'s program.  The plan layer is
          shared with the other entry points; the program layer keys on
          ``("sharded", mode, max_batch, axis, mesh_fingerprint)``, so
          meshes over other devices never alias.

        Raises:
          ValueError: as :meth:`compile`, or when ``mesh`` lacks
            ``axis``.
        """
        from ..dist.sharding import (mesh_axis_sizes, mesh_fingerprint,
                                     shard_program)

        backend = backend or self.backend
        self._check_backend(backend)
        mode_key = self._mode_key(mode)
        bucket = bucket or self._bucket_label(input_shapes)
        sizes = mesh_axis_sizes(mesh)
        if axis not in sizes:
            raise ValueError(f"mesh {tuple(sizes)} has no {axis!r} axis")
        if sizes[axis] == 1:
            return self.compile_batched(script, input_shapes, mode=mode,
                                        backend=backend, bucket=bucket)
        t0 = time.perf_counter()
        cache = self.cache
        pkey = None
        if cache is not None:
            pkey = self._program_key(
                script, input_shapes, backend,
                ("sharded", mode_key, max_batch, axis,
                 mesh_fingerprint(mesh)))
            if pkey is not None:
                prog = cache.get_program(pkey)
                if prog is not None:
                    cache.stats.record_bucket(
                        bucket, hit=True, seconds=time.perf_counter() - t0)
                    return prog
        base = self.compile_batched(script, input_shapes, mode=mode,
                                    backend=backend, bucket=bucket)
        prog = shard_program(base, mesh, axis)
        if cache is not None and pkey is not None:
            cache.put_program(pkey, prog)
        return prog

    def compile_packed(self, members, mode="best",
                       backend: str | None = None, bucket: str | None = None
                       ) -> codegen.PackedDispatch:
        """Multi-graph packed compile: N member scripts become ONE
        dispatch (one CUDA graph on the card) — the cross-sequence
        horizontal fusion a mixed serving drain needs.

        Args:
          members: sequence of ``(script, input_shapes)`` pairs, one
            per pack member.  Each member runs the normal per-graph
            pipeline (trace → plan, sharing the plan cache with every
            other entry point), so its fusion decisions are exactly
            the unpacked ones; only the dispatch is merged.
          mode, backend: as :meth:`compile_batched`; every
            member input is batched, and members may carry different
            batch sizes at call time.
          bucket: label for ``cache.stats.buckets`` telemetry
            (defaults to a ``pack/``-prefixed signature).

        Returns:
          A ``codegen.PackedDispatch`` — a thin caller-order view over
          the cached canonical ``PackedProgram``.  Program and packed-
          plan layers key on the *sorted* member plan fingerprints, so
          any compile of the same member mix, in any order, is a hit.

        Raises:
          ValueError: empty member list, or as :meth:`compile` per
            member.
        """
        if not members:
            raise ValueError("compile_packed needs at least one member")
        backend = backend or self.backend
        self._check_backend(backend)
        mode_key = self._mode_key(mode)
        t0 = time.perf_counter()
        cache = self.cache

        graphs, plans = [], []
        for script, input_shapes in members:
            g = self.trace(script, input_shapes)
            plans.append(self._plan_for(g, mode, backend, mode_key))
            graphs.append(g)

        perm = canonical_pack_order(plans)
        sorted_graphs = [graphs[i] for i in perm]
        sorted_plans = [plans[i] for i in perm]
        psig = pack_signature([plan_fingerprint(p) for p in plans])
        config = self._config_key(backend, mode_key)
        bucket = bucket or f"pack/{psig[:12]}"

        prog = pkey = None
        if cache is not None:
            pkey = hashlib.sha256(repr((psig, config, str(self.device),
                                        "packed")).encode()
                                  ).hexdigest()
            prog = cache.get_program(pkey)
            if prog is not None:
                cache.stats.record_bucket(
                    bucket, hit=True, seconds=time.perf_counter() - t0)
                return codegen.PackedDispatch(program=prog, perm=perm)

        from ..analysis.checks import verify_pack
        packed = None
        if cache is not None:
            pack_plan_key = hashlib.sha256(
                repr((psig, config, "pack-plan")).encode()).hexdigest()
            packed = cache.get_packed_plan(pack_plan_key)
            if packed is not None:
                # always-on pack verification: member structure + offset
                # rebasing; under ``verify`` also the full per-member
                # graph-bound pass.  A rejected entry, or one whose
                # members are not this compile's plans, is healed
                errors = [d.format() for d in verify_pack(
                    packed, sorted_graphs if self.verify else None,
                    hw=self.hw) if d.is_error]
                if [plan_fingerprint(p) for p in packed.members] != \
                        [plan_fingerprint(p) for p in sorted_plans]:
                    errors.append("members are not this compile's plans")
                if errors:
                    log.warning(
                        "cache-served packed plan rejected by static "
                        "verification; healing (drop + rebuild): %s",
                        "; ".join(errors))
                    cache.drop_packed_plan(pack_plan_key)
                    packed = None
        if packed is None:
            packed = build_packed_plan(plans)
            if self.verify:
                raise_if_errors([d for d in verify_pack(
                    packed, sorted_graphs, hw=self.hw) if d.is_error])
            if cache is not None:
                cache.put_packed_plan(pack_plan_key, packed)
        prog = codegen.compile_plan_packed(sorted_graphs, packed, hw=self.hw,
                                           device=self.device)
        if cache is not None:
            if pkey is not None:
                cache.put_program(pkey, prog)
            cache.stats.record_bucket(
                bucket, hit=False, seconds=time.perf_counter() - t0)
        return codegen.PackedDispatch(program=prog, perm=perm)

    def _compile_report(self, script, input_shapes, mode, backend, label):
        t0 = time.perf_counter()
        g = self.trace(script, input_shapes)
        t1 = time.perf_counter()
        space = self.space(g)
        combo = self.search(space, mode, backend=backend)
        t2 = time.perf_counter()
        plan = build_plan(g, combo, backend=backend)
        check_plan(plan, g, self.hw, full=self.verify)
        prog = codegen.compile_plan(g, plan, hw=self.hw, device=self.device,
                                    label=label)
        t3 = time.perf_counter()
        rep = CompileReport(
            n_fusions=len(space.fusions), n_impls=space.n_impls,
            n_combinations=len(scheduler.enumerate_combinations(space,
                                                                limit=5000)),
            t_trace_s=t1 - t0, t_space_s=t2 - t1, t_codegen_s=t3 - t2,
            best=scheduler.best_combination(space),
            unfused=scheduler.unfused_combination(space))
        return prog, rep

    def compile_all(self, script: Callable,
                    input_shapes: dict[str, Sequence[int]],
                    limit: int = 256, backend: str | None = None):
        """Compile the ``limit`` best combinations (predicted order) —
        the raw material of empirical search (paper §5.2; the managed
        version is ``mode="autotune"``).

        Routed through the shared cache machinery: candidate ``i`` uses
        the same program/plan keys as ``compile(..., mode=i)``, so a
        repeat ``compile_all`` — or a prior integer-mode compile — is
        served from cache, and the optimization space is only rebuilt
        when some candidate misses both layers.

        Returns:
          ``[(Combination, CompiledProgram), ...]`` — at most ``limit``
          entries, fewer when the space has fewer legal combinations.
        """
        backend = backend or self.backend
        self._check_backend(backend)
        cache = self.cache
        g = self.trace(script, input_shapes)
        combos = None
        out = []
        for i in range(limit):
            mode_key = self._mode_key(i)
            prog = pkey = None
            if cache is not None:
                pkey = self._program_key(script, input_shapes, backend,
                                         mode_key)
                if pkey is not None:
                    prog = cache.get_program(pkey)
            if prog is None:
                def candidate(i=i):
                    nonlocal combos
                    if combos is None:
                        combos = scheduler.enumerate_combinations(
                            self.space(g), limit=limit)
                    return (build_plan(g, combos[i], backend=backend)
                            if i < len(combos) else None)

                plan = self._resolved_plan(
                    g, backend, self._plan_key(g, backend, mode_key)
                    if cache is not None else None, candidate)
                if plan is None:
                    break
                prog = codegen.compile_plan(g, plan, hw=self.hw,
                                            device=self.device)
                if cache is not None and pkey is not None:
                    cache.put_program(pkey, prog)
            impls = tuple(prog.group_impls)
            out.append((Combination(impls=impls,
                                    t_pred=sum(im.t_pred for im in impls)),
                        prog))
        return out

    def oracle(self, script: Callable, input_shapes: dict[str, Sequence[int]]
               ) -> Callable:
        """The whole graph call by call on the CPU (``execute_dense``):
        the numerics every plan is held against."""
        g = self.trace(script, input_shapes)

        def run(**inputs):
            return codegen.execute_dense(g, inputs)

        return run
