"""Batched serving engine.

The paper's fusion win is amortizing memory traffic across *calls* that
share data; a serving workload offers the same win across *requests*:
N requests of one shape bucket run as ONE dispatch, each fused group one
kernel launch over the whole batch (K1's items are requests x units x
slices), and the dispatch replays as one CUDA graph.

The engine takes ``(sequence, n, inputs)`` requests off a queue and:

1. **buckets** — rounds ``n`` up to the next power of two (floor
   ``min_bucket``), so at most one plan is ever searched per
   ``(sequence, bucket)`` and one batched program built;
2. **pads** — fills each input up to the bucket shape with a
   *reduction-safe* value: the identity of the graph's reduction monoid
   in the input's dtype (``Monoid.identity_for``), so padded lanes are
   invisible to the reductions; graphs with no safe identity (mixed
   monoids, non-zero-preserving maps into reductions — decode attention
   is both) are re-traced through ``core.masking`` with an extra
   ``_mask`` input, and every reduction ignores padded lanes;
3. **groups** — same-``(sequence, bucket)`` requests form batches of up
   to ``max_batch`` (sizes rounded to powers of two), assembled into
   staging buffers the engine owns, one set per ``(sequence, bucket,
   batch size)``: the graphs were captured on those addresses, so a
   batch costs one copy of its inputs (and one of its outputs, below);
4. **packs** — the batches pending in one drain are packed, equal batch
   sizes together, into one *multi-graph* dispatch
   (``FusionCompiler.compile_packed``): one CUDA graph runs several
   sequences' batched launches, bitwise equal to dispatching them one
   by one.  ``max_pack`` bounds members per pack (1 disables packing);
   a key whose program is still cold dispatches unpacked this drain;
5. **overlaps** — every dispatch of a drain is queued on the device's
   stream before the drain waits for any result, so the host assembles
   batch *k+1* while the device runs batch *k*; stream order keeps a
   staging buffer from being refilled before the dispatch reading it
   has run.

Outputs are sliced back to each request's true ``n`` from a copy of
the dispatch's real rows, queued on the stream right behind it: a
result holds no graph memory, so the next dispatch of its key replays
the same graph, however long the caller keeps its results (``serve``
with a rate keeps every drain's), and no later dispatch overwrites it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..core import FusionCompiler
from ..core.codegen import BatchedProgram, PackedDispatch
from ..core.cuda_codegen import torch_dtype
from ..core.elementary import Monoid
from ..core.graph import Graph, trace
from ..core.masking import MASK_INPUT, masked_wrapper, padded_dims


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

def bucket_of(n: int, min_bucket: int = 128) -> int:
    """Next power of two >= n, floored at ``min_bucket``.

    ``min_bucket`` must itself be a power of two: a non-pow2 floor
    would yield non-pow2 buckets (floor 100 → 100, 200, 400 …),
    fragmenting the plan cache across nearby sizes."""
    if n <= 0:
        raise ValueError(f"request size must be positive, got {n}")
    if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
        raise ValueError(
            f"min_bucket must be a power of two, got {min_bucket} "
            "(valid form: 1, 2, 4, 8, ...)")
    b = min_bucket
    while b < n:
        b *= 2
    return b


def _pow2_batch(k: int, max_batch: int) -> int:
    """Round a batch size up to a power of two, capped at ``max_batch``."""
    b = 1
    while b < k:
        b *= 2
    return min(b, max_batch)


# ---------------------------------------------------------------------------
# reduction-safe padding
# ---------------------------------------------------------------------------

def input_pad_values(g: Graph) -> dict[str, Any]:
    """Safe pad value per graph input.

    Padded lanes must be invisible to every reduction that (transitively)
    consumes them, so inputs are padded with the reduction monoid's
    identity in each input's own dtype (``Monoid.identity_for``).

    * SUM graphs pad with 0, sound through chains of ``pad_safe``
      (zero-preserving) maps: the BLAS library is multilinear in its
      array arguments, so all-zero lanes stay zero on the way into the
      reduction.  A non-``pad_safe`` call (``exp`` maps 0 to 1) feeding
      a reduction voids that.
    * MAX/MIN graphs pad with their identity, which arbitrary maps do
      not preserve (``a*x`` with ``a<0`` flips -inf to +inf), so it is
      only accepted when every reduction reads graph inputs directly.
    * A graph mixing monoids has no single safe pad value.

    Every rejection raises ``ValueError`` mentioning "mask": the engine
    catches it and re-traces the script through the per-lane masking
    rewrite (``core.masking``).
    """
    monoids = {c.elem.monoid for c in g.calls if c.elem.is_reduction}
    if len(monoids) > 1:
        raise ValueError(
            f"graph mixes reduction monoids "
            f"{sorted(m.value for m in monoids)}: no single padding "
            "identity is reduction-safe — mask instead")
    if monoids and monoids != {Monoid.SUM}:
        unsafe = [c for c in g.calls if c.elem.is_reduction
                  and any(not a.is_input for a in c.args)]
        if unsafe:
            names = ", ".join(c.elem.name for c in unsafe)
            raise ValueError(
                f"non-SUM reduction(s) ({names}) consume computed "
                "values: identity padding is not preserved through "
                "maps — mask instead")
    else:
        # SUM-only: identity padding is sound iff every call on a path
        # into a reduction is zero-preserving (pad_safe)
        feeding: set = set()
        for c in reversed(g.calls):
            if c.elem.is_reduction or c.out in feeding:
                feeding.update(c.args)
        unsafe = [c for c in g.calls
                  if not c.elem.pad_safe and c.out in feeding]
        if unsafe:
            names = ", ".join(sorted({c.elem.name for c in unsafe}))
            raise ValueError(
                f"non-pad_safe call(s) ({names}) feed a reduction: "
                "zero padding is not preserved through them — mask "
                "instead")
    m = next(iter(monoids)) if monoids else Monoid.SUM
    return {v.name: m.identity_for(v.dtype) for v in g.inputs}


def pad_to_shape(x: np.ndarray, shape: Sequence[int], fill: float) -> np.ndarray:
    """Embed ``x`` at the origin of a ``fill``-initialized ``shape``."""
    x = np.asarray(x)
    shape = tuple(shape)
    if x.shape == shape:
        return x
    if x.ndim != len(shape) or any(a > b for a, b in zip(x.shape, shape)):
        raise ValueError(f"cannot pad {x.shape} to {shape}")
    out = np.full(shape, fill, dtype=x.dtype)
    out[tuple(slice(s) for s in x.shape)] = x
    return out


def _write_row(row: torch.Tensor, x, fill) -> None:
    """Write one request's input ``x`` (numpy array, scalar or tensor)
    at the origin of staging row ``row``, the rest set to ``fill``."""
    x = torch.as_tensor(x)
    if x.dim() != row.dim() or any(a > b for a, b in zip(x.shape,
                                                        row.shape)):
        raise ValueError(f"cannot pad {tuple(x.shape)} to "
                         f"{tuple(row.shape)}")
    if tuple(x.shape) != tuple(row.shape):
        row.fill_(float(fill))
        row = row[tuple(slice(s) for s in x.shape)]
    row.copy_(x, non_blocking=True)


def _own(outs: Sequence[torch.Tensor], rows: int) -> tuple:
    """The first ``rows`` rows of a dispatch's batched outputs, copied
    (on the device's stream, behind the dispatch) out of the program's
    graph memory, so the results pin none of it."""
    return tuple(o[:rows].clone() for o in outs)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    sequence: str
    n: int
    inputs: Mapping[str, Any]      # numpy arrays or tensors, unpadded
    t_submit: float = 0.0          # perf_counter at submission


@dataclasses.dataclass
class RequestResult:
    rid: int
    sequence: str
    n: int
    bucket: int
    batch_size: int                # real requests in the dispatch
    outputs: tuple[torch.Tensor, ...]  # sliced back to the request's n
    latency_s: float
    queue_wait_s: float = 0.0      # submit -> dispatch wait


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ServingEngine:
    """Single-device batched serving engine.

    Args:
      compiler: the ``FusionCompiler`` to build bucket programs with
        (defaults to a fresh one on the GPU sharing the process-wide
        plan cache); its device is where requests run.
      max_batch: largest requests-per-dispatch; batch sizes quantize to
        powers of two up to this.
      min_bucket: floor of the power-of-two shape buckets.
      registry: ``{name: Program}`` of servable sequences (defaults to
        the paper's ``blas.REGISTRY``).
      mode: search mode for bucket compiles (``"best"`` default;
        ``"autotune"`` measures the compiler's ``autotune_budget`` top
        candidates of each bucket once, the measurements persisting in
        the compiler's cache, so later compiles of the bucket measure
        nothing).
      max_pack: most ``(sequence, bucket)`` batches merged into one
        packed dispatch per drain round; ``1`` disables packing.
      backend: ``'cuda'`` or ``'torch'`` — per-engine override passed to
        every bucket and pack compile; ``None`` uses the compiler's.

    Example::

        engine = ServingEngine(FusionCompiler(device="cpu"), max_batch=8)
        engine.warm("GEMVER", [1000, 2048])
        engine.submit("GEMVER", 1000, inputs)   # any request size
        (result,) = engine.drain()              # sliced back to n=1000
    """

    def __init__(self, compiler: FusionCompiler | None = None,
                 max_batch: int = 8, min_bucket: int = 128,
                 registry: Mapping[str, Any] | None = None,
                 mode: str = "best", max_pack: int = 8,
                 backend: str | None = None):
        if registry is None:
            from ..blas import REGISTRY
            registry = REGISTRY
        if max_pack < 1:
            raise ValueError(f"max_pack must be >= 1, got {max_pack}")
        if backend is not None:
            # RPL401 at the engine boundary, not deep inside a compile
            FusionCompiler._check_backend(backend)
        self.compiler = compiler or FusionCompiler()
        self.device = self.compiler.device
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.mode = mode
        self.max_pack = max_pack
        self.backend = backend
        self.registry = registry
        self._programs: dict[tuple[str, int], BatchedProgram] = {}
        # (script, shapes, pad values, masked?) per key — the masked
        # fallback decision, made once per (sequence, bucket)
        self._specs: dict[tuple[str, int], tuple] = {}
        self._packs: dict[tuple[tuple[str, int], ...], PackedDispatch] = {}
        # staging buffers per (sequence, bucket, batch size)
        self._staging: dict[tuple[str, int, int], dict[str, torch.Tensor]] = {}
        self._queue: list[Request] = []
        self._rid = 0
        # engine-side telemetry (compile telemetry lives on cache.stats)
        self.n_requests = 0
        self.n_dispatches = 0
        self.n_padded_rows = 0     # dummy rows added by pow2 rounding
        self.n_packed_dispatches = 0   # dispatches that were packs
        self.n_packed_members = 0      # member batches those packs carried

    # -- compilation --------------------------------------------------------
    def bucket_of(self, n: int) -> int:
        return bucket_of(n, self.min_bucket)

    def _compile_specs(self, sequence: str, bucket: int) -> tuple:
        """``(script, shapes, pad_values, masked)`` for one key.

        Decides, once per ``(sequence, bucket)``, how padded lanes stay
        invisible to the graph's reductions: a registry entry's explicit
        ``pad_values``; else ``input_pad_values`` on a trace; else the
        per-lane masking rewrite (the shape dict gains the rank-1
        ``_mask`` input and every input zero-fills).
        """
        key = (sequence, bucket)
        spec = self._specs.get(key)
        if spec is None:
            seq = self.registry[sequence]
            shapes = seq.shapes(bucket)
            explicit = getattr(seq, "pad_values", None)
            if explicit is not None:
                spec = (seq.script, shapes, dict(explicit), False)
            else:
                try:
                    pads = input_pad_values(
                        trace(seq.script, shapes, dtype=self.compiler.dtype))
                    spec = (seq.script, shapes, pads, False)
                except ValueError:
                    dims = padded_dims(shapes, seq.shapes(bucket * 2))
                    script, shapes = masked_wrapper(seq.script, shapes, dims)
                    spec = (script, shapes, {n: 0.0 for n in shapes}, True)
            self._specs[key] = spec
        return spec

    def _get_program(self, sequence: str, bucket: int) -> BatchedProgram:
        key = (sequence, bucket)
        prog = self._programs.get(key)
        if prog is None:
            script, shapes, _, _ = self._compile_specs(sequence, bucket)
            prog = self.compiler.compile_batched(
                script, shapes, mode=self.mode, backend=self.backend,
                bucket=f"{sequence}/{bucket}")
            self._programs[key] = prog
        return prog

    def _get_pack(self, members: tuple[tuple[str, int], ...]) -> PackedDispatch:
        """Packed dispatch for an ordered tuple of (sequence, bucket)
        member keys; memoized per exact member tuple (the compiler's
        program cache also collapses reordered mixes)."""
        dispatch = self._packs.get(members)
        if dispatch is None:
            dispatch = self.compiler.compile_packed(
                [self._compile_specs(s, b)[:2] for s, b in members],
                mode=self.mode, backend=self.backend,
                bucket="pack/" + "+".join(f"{s}/{b}" for s, b in members))
            self._packs[members] = dispatch
        return dispatch

    def _form_packs(self, units: list, cold: set) -> tuple[list, list]:
        """Split drain units — ``(key, chunk, batch)`` triples — into
        packs (lists of >= 2 units sharing a batch size) and leftovers
        dispatched unpacked.

        Per batch size the formation is round-robin: one unit per sorted
        ``(sequence, bucket)`` key per round, rounds chunked at
        ``max_pack``; uniform traffic over the warmed keys thus repeats
        the composition ``warm_packs`` builds.  Cold keys always
        dispatch unpacked this drain."""
        if self.max_pack < 2:
            return [], list(units)
        singles = [u for u in units if u[0] in cold]
        by_batch: dict[int, list] = {}
        for u in units:
            if u[0] not in cold:
                by_batch.setdefault(u[2], []).append(u)
        packs = []
        for batch in sorted(by_batch):
            fifo: dict[tuple[str, int], list] = {}
            for u in by_batch[batch]:
                fifo.setdefault(u[0], []).append(u)
            while fifo:
                rnd = [fifo[k].pop(0) for k in sorted(fifo)]
                for k in [k for k, q in fifo.items() if not q]:
                    del fifo[k]
                for i in range(0, len(rnd), self.max_pack):
                    part = rnd[i:i + self.max_pack]
                    if len(part) >= 2:
                        packs.append(part)
                    else:
                        singles.extend(part)
        return packs, singles

    def _dispatch_batch(self, k: int) -> int:
        """Quantized dispatch size for ``k`` queued requests."""
        return _pow2_batch(k, self.max_batch)

    def _note_dispatch(self, n_real: int, batch: int) -> None:
        """Telemetry hook: one dispatch of ``batch`` rows, ``n_real``
        of them real requests (subclasses track replica routing)."""

    def _trace_sizes(self) -> list[int]:
        """Every batch size ``_dispatch_batch`` can produce."""
        sizes, bs = {self.max_batch}, 1
        while bs < self.max_batch:
            sizes.add(bs)
            bs *= 2
        return sorted(sizes)

    def _stage(self, sequence: str, bucket: int, batch: int
               ) -> dict[str, torch.Tensor]:
        """The staging buffers of one (sequence, bucket, batch size), on
        the engine's device, zero-filled when first made."""
        key = (sequence, bucket, batch)
        stage = self._staging.get(key)
        if stage is None:
            g = self._get_program(sequence, bucket).graph
            stage = {v.name: torch.zeros((batch,) + v.shape,
                                         dtype=torch_dtype(v.dtype),
                                         device=self.device)
                     for v in g.inputs}
            self._staging[key] = stage
        return stage

    def _dummy_stage(self, key: tuple[str, int], bs: int):
        """Warm-up batch: zeros, and an all-ones ``_mask`` (an all-masked
        row would divide by an empty softmax sum)."""
        stage = self._stage(*key, bs)
        for name, t in stage.items():
            t.fill_(1.0 if name == MASK_INPUT else 0.0)
        return stage

    def warm(self, sequence: str, ns: Sequence[int],
             trace_batches: bool = True,
             trace_packs: bool = True) -> list[int]:
        """Pre-compile every bucket the sizes ``ns`` map to; returns the
        bucket list.  ``trace_batches`` also runs every batch size
        ``drain`` can dispatch from its staging buffers (twice: the first
        call on a set of buffers runs eagerly, the very first building
        the kernels, and the second captures its graph), so serving never builds or
        captures.  ``trace_packs`` does the same for the packs a drain
        over ALL warmed keys would form (re-run after the last ``warm``
        call: the compositions depend on the whole warmed set)."""
        buckets = sorted({self.bucket_of(n) for n in ns})
        for b in buckets:
            prog = self._get_program(sequence, b)
            if not trace_batches:
                continue
            for bs in self._trace_sizes():
                for _ in range(2):
                    prog(**self._dummy_stage((sequence, b), bs))
        if trace_packs:
            self.warm_packs(trace_batches=trace_batches)
        self._sync()
        return buckets

    def warm_packs(self, trace_batches: bool = True) -> list[tuple]:
        """Pre-build the pack compositions a drain over every warmed
        ``(sequence, bucket)`` key would form — sorted keys, chunked at
        ``max_pack``, ``_form_packs``'s round shape — and (with
        ``trace_batches``) run each at every batch size.  Returns the
        member tuples warmed."""
        if self.max_pack < 2:
            return []
        keys = sorted(self._programs)
        warmed = []
        for i in range(0, len(keys), self.max_pack):
            members = tuple(keys[i:i + self.max_pack])
            if len(members) < 2:
                continue
            dispatch = self._get_pack(members)
            warmed.append(members)
            if not trace_batches:
                continue
            for bs in self._trace_sizes():
                for _ in range(2):
                    dispatch([self._dummy_stage(key, bs) for key in members])
        self._sync()
        return warmed

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request intake -----------------------------------------------------
    def submit(self, sequence: str, n: int, inputs: Mapping[str, Any],
               rid: int | None = None) -> Request:
        if sequence not in self.registry:
            raise KeyError(f"unknown sequence {sequence!r}; "
                           f"choose from {', '.join(self.registry)}")
        if rid is None:
            rid = self._rid
        self._rid = max(self._rid, rid) + 1
        req = Request(rid=rid, sequence=sequence, n=n, inputs=inputs,
                      t_submit=time.perf_counter())
        self._queue.append(req)
        self.n_requests += 1
        return req

    # -- execution ----------------------------------------------------------
    def _assemble(self, chunk: list[Request], sequence: str, bucket: int,
                  batch: int) -> dict[str, torch.Tensor]:
        """Write a chunk's inputs, padded to the bucket, into the staging
        buffers of its batch size.  Rows past the chunk (pow2 rounding)
        keep what they hold: rows are independent, their outputs are
        dropped."""
        _, shapes, pads, masked = self._compile_specs(sequence, bucket)
        stage = self._stage(sequence, bucket, batch)
        self.n_padded_rows += batch - len(chunk)
        for name, buf in stage.items():
            for i, r in enumerate(chunk):
                if masked and name == MASK_INPUT:
                    # synthesized, not taken from the request: 1.0 on
                    # the first n lanes, 0.0 on padding
                    buf[i, :r.n].fill_(1.0)
                    buf[i, r.n:].fill_(0.0)
                else:
                    _write_row(buf[i], r.inputs[name], pads[name])
        return stage

    def _record_waits(self, chunk: list[Request], t_disp: float) -> list[float]:
        """Submit -> dispatch wait per request, mirrored into the cache
        telemetry window (``CacheStats.queue_wait_percentiles``)."""
        waits = [max(0.0, t_disp - r.t_submit) for r in chunk]
        cache = self.compiler.cache
        if cache is not None:
            for w in waits:
                cache.stats.record_queue_wait(w)
        return waits

    def drain(self) -> list[RequestResult]:
        """Run everything queued: group by (sequence, bucket), chunk into
        batches, pack same-size batches across sequences (``max_pack``
        per dispatch), queue ALL of it on the device, then wait once."""
        queue, self._queue = self._queue, []
        groups: dict[tuple[str, int], list[Request]] = collections.OrderedDict()
        for req in queue:
            groups.setdefault((req.sequence, self.bucket_of(req.n)),
                              []).append(req)

        # cold keys (no compiled program yet) dispatch unpacked this
        # drain: packing them would stall the pack behind a fresh member
        # compile; by the next drain they are warm and packable
        cold = {key for key in groups if key not in self._programs}

        # resolve every program before dispatching anything: a compile
        # failure for one group (e.g. an unpaddable graph) must not drop
        # the other queued requests
        try:
            progs = {key: self._get_program(*key) for key in groups}
        except Exception:
            self._queue = queue + self._queue
            raise

        units = []                       # (key, chunk, batch) triples
        for key, reqs in groups.items():
            for i in range(0, len(reqs), self.max_batch):
                chunk = reqs[i:i + self.max_batch]
                units.append((key, chunk, self._dispatch_batch(len(chunk))))
        packs, singles = self._form_packs(units, cold)

        in_flight = []
        for pack_units in packs:
            dispatch = self._get_pack(tuple(u[0] for u in pack_units))
            member_inputs = [self._assemble(chunk, key[0], key[1], batch)
                             for key, chunk, batch in pack_units]
            t_disp = time.perf_counter()
            outs_list = [_own(outs, len(u[1])) for u, outs in    # queued
                         zip(pack_units, dispatch(member_inputs))]
            self.n_dispatches += 1
            self.n_packed_dispatches += 1
            self.n_packed_members += len(pack_units)
            for (key, chunk, batch), outs in zip(pack_units, outs_list):
                self._note_dispatch(len(chunk), batch)
                waits = self._record_waits(chunk, t_disp)
                in_flight.append((key[1], chunk, outs, waits))
        for key, chunk, batch in singles:
            args = self._assemble(chunk, key[0], key[1], batch)
            t_disp = time.perf_counter()
            outs = progs[key](**args)            # queued, no wait
            outs = _own(outs if isinstance(outs, tuple) else (outs,),
                        len(chunk))
            self.n_dispatches += 1
            self._note_dispatch(len(chunk), batch)
            waits = self._record_waits(chunk, t_disp)
            in_flight.append((key[1], chunk, outs, waits))

        self._sync()
        t_done = time.perf_counter()
        results: list[RequestResult] = []
        for bucket, chunk, outs, waits in in_flight:
            for i, req in enumerate(chunk):
                sliced = tuple(
                    o[i][tuple(slice(req.n) if d == bucket else slice(None)
                               for d in o.shape[1:])]
                    for o in outs)
                results.append(RequestResult(
                    rid=req.rid, sequence=req.sequence, n=req.n,
                    bucket=bucket, batch_size=len(chunk), outputs=sliced,
                    latency_s=t_done - req.t_submit,
                    queue_wait_s=waits[i]))
        return results

    def serve(self, requests: Sequence[tuple[str, int, Mapping[str, Any]]],
              rate_hz: float | None = None) -> list[RequestResult]:
        """Serve a workload of ``(sequence, n, inputs)`` tuples.

        ``rate_hz=None`` is closed-loop: everything is queued up front
        and drained in maximal batches.  A rate simulates an open-loop
        arrival process (one request every ``1/rate_hz`` seconds): the
        engine batches whatever has arrived each round.
        """
        if rate_hz is None:
            for sequence, n, inputs in requests:
                self.submit(sequence, n, inputs)
            return self.drain()

        results: list[RequestResult] = []
        t0 = time.perf_counter()
        for i, (sequence, n, inputs) in enumerate(requests):
            t_arrival = t0 + i / rate_hz
            wait = t_arrival - time.perf_counter()
            if wait > 0:
                # the arrival gap: drain what's queued (overlapping with
                # the gap) or idle until the next request lands
                if self._queue:
                    results.extend(self.drain())
                wait = t_arrival - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            self.submit(sequence, n, inputs)
        while self._queue:
            results.extend(self.drain())
        return results

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> dict:
        cache = self.compiler.cache
        occupancy = (self.n_requests / (self.n_requests + self.n_padded_rows)
                     if self.n_requests else 0.0)
        runners = [r for r in [p.replays for p in self._programs.values()]
                   + [d.program.replays for d in self._packs.values()]
                   if r is not None]
        return {
            "n_requests": self.n_requests,
            "n_dispatches": self.n_dispatches,
            "n_padded_rows": self.n_padded_rows,
            "batch_occupancy": occupancy,
            "max_pack": self.max_pack,
            "n_packed_dispatches": self.n_packed_dispatches,
            "n_packed_members": self.n_packed_members,
            # CUDA graphs captured for this engine's programs and packs,
            # the most kept for one input set, and the calls run eagerly
            # because every graph of theirs was held
            "graph_captures": sum(r.n_captures for r in runners),
            "graphs_per_input_set": max((r.most_graphs for r in runners),
                                        default=0),
            "graph_held_calls": sum(r.n_held for r in runners),
            "programs": sorted(f"{s}/{b}" for s, b in self._programs),
            "packs": sorted("+".join(f"{s}/{b}" for s, b in key)
                            for key in self._packs),
            "queue_wait": (cache.stats.queue_wait_percentiles()
                           if cache is not None else None),
            "cache": cache.stats.as_dict() if cache is not None else None,
        }


# ---------------------------------------------------------------------------
# replica-sharded serving
# ---------------------------------------------------------------------------

def replica_fill(n_real: int, batch: int, n_replicas: int) -> list[int]:
    """Real rows landing on each replica of a sharded dispatch.

    A dispatch of ``batch`` rows splits into contiguous blocks of
    ``batch // n_replicas``: replica ``j`` runs rows
    ``[j*batch/R, (j+1)*batch/R)``.  The first ``n_real`` rows are real
    requests, the rest padding, so the fill is front-loaded: with an
    uneven queue one replica runs partly full and later ones may run
    padding alone.

    >>> replica_fill(5, 8, 4)      # 5 requests, 2-row blocks
    [2, 2, 1, 0]
    """
    per = batch // n_replicas
    return [max(0, min(per, n_real - j * per)) for j in range(n_replicas)]


class ShardedServingEngine(ServingEngine):
    """The batched engine with every dispatch spread over the ``data``
    axis of a mesh, from the reference's ``ShardedServingEngine``.

    Same bucketing, padding and batching as ``ServingEngine``; the
    differences are (1) programs come from
    ``FusionCompiler.compile_sharded``, so one global batch runs as
    contiguous per-replica row blocks, each on its replica's device,
    with no communication between replicas, and (2) dispatch sizes
    quantize to ``n_replicas * 2**i`` so every replica gets an equal
    block (``replica_fill`` describes the routing,
    ``stats()['replica_rows']`` tracks it).  On a one-replica mesh this
    is exactly the base engine: the same programs, the same keys.

    Numerics: a row's result does not depend on the block it runs in
    (K1's batched launch computes each request as its single launch
    does; on the CPU the plain version runs request by request), so
    every request is bitwise what the single engine gives.

    Packing is off (``max_pack`` is pinned to 1), as in the reference: a
    packed program is one dispatch over several members' batches, not
    spread over the mesh, so it would bypass the replicas.

    Args:
      mesh: a ``launch.mesh.Mesh`` with the replica axis (default:
        ``make_data_mesh()`` over every GPU present).
      axis: the replica axis (default ``"data"``).
      compiler, max_batch, min_bucket, registry, mode, backend: as
        ``ServingEngine``; ``max_batch`` rounds up to ``n_replicas``
        times a power of two.
    """

    def __init__(self, mesh=None, *, compiler: FusionCompiler | None = None,
                 max_batch: int = 8, min_bucket: int = 128,
                 registry: Mapping[str, Any] | None = None,
                 axis: str = "data", mode: str = "best",
                 backend: str | None = None):
        from ..dist.sharding import mesh_axis_sizes
        if mesh is None:
            from ..launch.mesh import make_data_mesh
            mesh = make_data_mesh()
        sizes = mesh_axis_sizes(mesh)
        if axis not in sizes:
            raise ValueError(f"mesh {tuple(sizes)} has no {axis!r} axis")
        self.mesh = mesh
        self.axis = axis
        self.n_replicas = sizes[axis]
        # per-replica row blocks are powers of two; global batch sizes
        # are n_replicas * block, so every replica gets an equal block
        self.rows_cap = _pow2_batch(
            max(1, -(-max_batch // self.n_replicas)), max_batch)
        super().__init__(compiler=compiler,
                         max_batch=self.n_replicas * self.rows_cap,
                         min_bucket=min_bucket, registry=registry,
                         mode=mode, max_pack=1, backend=backend)
        self.replica_rows = [0] * self.n_replicas

    def _get_program(self, sequence: str, bucket: int):
        if self.n_replicas == 1:             # the base engine's programs
            return super()._get_program(sequence, bucket)
        key = (sequence, bucket)
        prog = self._programs.get(key)
        if prog is None:
            script, shapes, _, _ = self._compile_specs(sequence, bucket)
            prog = self.compiler.compile_sharded(
                script, shapes, mesh=self.mesh, axis=self.axis,
                max_batch=self.max_batch, mode=self.mode,
                backend=self.backend, bucket=f"{sequence}/{bucket}")
            self._programs[key] = prog
        return prog

    def _dispatch_batch(self, k: int) -> int:
        rows = _pow2_batch(max(1, -(-k // self.n_replicas)), self.rows_cap)
        return self.n_replicas * rows

    def _trace_sizes(self) -> list[int]:
        # rows_cap itself may be no power of two (a capped max_batch), so
        # the set starts with it, as the base class starts with max_batch
        rows, r = {self.rows_cap}, 1
        while r < self.rows_cap:
            rows.add(r)
            r *= 2
        return [self.n_replicas * x for x in sorted(rows)]

    def _note_dispatch(self, n_real: int, batch: int) -> None:
        for j, c in enumerate(replica_fill(n_real, batch, self.n_replicas)):
            self.replica_rows[j] += c

    def stats(self) -> dict:
        from ..dist.sharding import mesh_axis_sizes
        st = super().stats()
        runners = [r for p in self._programs.values()
                   for r in getattr(p, "replica_runners", lambda: [])()]
        if runners:        # the replicas' graphs
            st["graph_captures"] += sum(r.n_captures for r in runners)
            st["graphs_per_input_set"] = max(
                st["graphs_per_input_set"],
                max(r.most_graphs for r in runners))
            st["graph_held_calls"] += sum(r.n_held for r in runners)
        st["mesh"] = dict(mesh_axis_sizes(self.mesh))
        st["n_replicas"] = self.n_replicas
        st["replica_rows"] = list(self.replica_rows)
        return st
