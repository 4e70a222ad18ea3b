"""Empirical autotuning (paper §5.2) and hardware calibration.

The paper's headline speedups come from its *empirical search* mode:
candidates are enumerated in predicted order but the winner is chosen by
**measuring** them.  This module is that loop for the port:

* ``measure_group`` — the one seam every fresh measurement goes through:
  ONE fused group in isolation on synthetic inputs.  On a CUDA device
  the group's K1 kernel (its launch and the fold of its ``partial``
  outputs, what a plan pays for it) is captured ``inner`` times into one
  CUDA graph and its replay timed with CUDA events
  (``timing.replay_s``): a served plan replays one graph, so this is the
  cost the plan pays, with no Python path in it.  On the CPU it is timed
  on the host clock, as the reference does (``measure_callable``);
* ``autotune_combination`` — pull the ``budget`` best combinations from
  the exact nondecreasing-``t_pred`` stream
  (``scheduler.enumerate_combinations``), cost every candidate as the
  sum of its groups' timings, pick the measured winner.  The groups no
  table holds are built first, all at once, in parallel threads (one
  ``nvcc`` per distinct group source), and only then timed;
* a **per-group measured-cost table** content-addressed by ``(group
  signature, grid order, blocks, hardware/backend fingerprint)`` and
  persisted through the ``PlanCache`` measurement layer.  Group
  signatures are *localized* (``plan.group_signature``), so timings
  transfer between programs sharing a fusion; a candidate whose groups
  are all in the table is costed without building or timing anything;
* ``calibrate_hardware`` — micro-benchmarks (streaming bandwidth over a
  ≥3-size sweep, the per-kernel cost inside a CUDA graph, the f32
  matmul rate) that replace ``HardwareModel``'s V5E constants with the
  running machine's, so ``t_pred`` (and hence the candidates the budget
  is spent on) ranks for this card.  ``HardwareModel.refit`` regresses
  the constants over the accumulated group table.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import hashlib
import math
import os
import time

import numpy as np
import torch

from ..kernels import _build
from . import codegen, cuda_codegen, scheduler, timing
from .cache import PlanCache
from .graph import Graph
from .plan import ExecutionPlan, build_plan, group_signature, topo_group_order
from .predictor import V5E, HardwareModel, Impl, _round_sig
from .scheduler import Combination, OptimizationSpace

#: default measurement discipline (overridable per call / per compiler)
MEAS_REPS = 3
MEAS_WARMUP = 1
#: calls per timed rep when measuring one group: on the CPU, pipelined
#: host calls that amortize the host sync; on a CUDA device, launches
#: captured into the one graph whose replay is timed
GROUP_INNER = 8


# ---------------------------------------------------------------------------
# timing discipline
# ---------------------------------------------------------------------------

def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_callable(fn, args: tuple, *, reps: int = MEAS_REPS,
                     warmup: int = MEAS_WARMUP, inner: int = 1) -> float:
    """Host-clock seconds per call of ``fn(*args)`` — the per-group
    timing primitive off the card.  Warmup runs absorb first-call
    costs; every timed rep flushes the cyclic GC first and synchronizes
    on the result; ``inner`` calls per rep, min-of-reps."""
    inner = max(inner, 1)
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    for _ in range(max(warmup, 1)):
        fn(*args)
        for d in devices:
            _sync(d)
    best = math.inf
    for _ in range(max(reps, 1)):
        gc.collect()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        for d in devices:
            _sync(d)
        best = min(best, time.perf_counter() - t0)
    return best / inner


def group_inputs(f, seed: int = 0) -> tuple:
    """Concrete random positional inputs matching one fusion's external
    input signature — what a group is timed on.  Timings are value-
    independent (dense map/reduce kernels), so synthetic data is as
    good as the program's."""
    rng = np.random.default_rng(seed)
    vals = []
    for v in f.external_inputs:
        if v.shape == ():
            vals.append(np.dtype(v.dtype).type(rng.uniform(0.5, 1.5)))
        else:
            vals.append(rng.standard_normal(v.shape).astype(v.dtype))
    return tuple(vals)


def group_source(g: Graph, impl: Impl) -> str:
    """The CUDA source a group is measured with: its K1 kernel as a
    one-group module (the code the group has inside its plan's module,
    under the name of group 0), so identical groups share one build."""
    return cuda_codegen.plan_source(g, [impl])


def measure_group(g: Graph, impl: Impl, *, backend: str = "cuda",
                  device="cuda", reps: int = MEAS_REPS,
                  warmup: int = MEAS_WARMUP, inner: int = GROUP_INNER,
                  seed: int = 0) -> float:
    """Time ONE fused group in isolation on synthetic inputs: on the
    ``cuda`` backend its K1 kernel (the wrapper a plan calls: launch and
    fold), on ``torch`` its dense function.  On a CUDA device by graph
    replay (``timing.replay_s``), on the CPU by the host clock
    (``measure_callable``), only when the caller passes ``device="cpu"``.
    A failed build or launch raises, and so does ``"cuda"`` without a
    card."""
    dev = codegen.resolve_device(device)
    f = impl.fusion
    args = tuple(codegen.as_tensor(x, v, dev)
                 for x, v in zip(group_inputs(f, seed), f.external_inputs))
    if backend == "cuda":
        # named by its tiles in the launch counter: autotune[4096x128]/g0[..]
        label = "autotune[" + "x".join(map(str, impl.blocks)) + "]"
        fn = cuda_codegen.GroupKernel(
            cuda_codegen.PlanModule(g, [impl]), 0, label=label)
    else:
        fn = codegen._group_dense_fn(f)
    if dev.type == "cuda":
        # a capture without the group's K1 launches would time as ~0
        return timing.replay_s(lambda: fn(*args), inner=inner, reps=reps,
                               warmup=warmup,
                               launches=inner if backend == "cuda" else 0)
    return measure_callable(fn, args, reps=reps, warmup=warmup, inner=inner)


def build_groups(g: Graph, impls, backend: str, device) -> float:
    """Build the kernels of ``impls`` ahead of timing them: one ``nvcc``
    per distinct source, all in parallel threads (``_build`` caches the
    libraries by source hash).  Only the ``cuda`` backend on a CUDA
    device builds anything; returns the seconds it took.  A failed
    build raises."""
    if backend != "cuda" or torch.device(device).type != "cuda" \
            or not impls:
        return 0.0
    t0 = time.perf_counter()
    sources = sorted({group_source(g, im) for im in impls})
    with concurrent.futures.ThreadPoolExecutor(
            min(len(sources), os.cpu_count() or 4)) as pool:
        for fut in [pool.submit(_build.build, s) for s in sources]:
            fut.result()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# measured-cost table keys
# ---------------------------------------------------------------------------

def combination_key(plan: ExecutionPlan) -> str:
    """Content address of one combination *choice*: which calls fuse
    into which groups, with which grid order and block sizes.  Derived
    from the plan (deterministic topo order), so it is stable across
    re-traces and processes."""
    payload = repr(tuple((gp.call_indices, gp.order_pos, gp.blocks)
                         for gp in plan.groups))
    return hashlib.sha256(payload.encode()).hexdigest()


def _env_fields(device) -> tuple:
    """What makes two measuring environments interchangeable: the torch
    and CUDA versions, and the card's name and compute capability (or
    ``"cpu"``)."""
    dev = codegen.resolve_device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        where: tuple = (torch.cuda.get_device_name(idx), f"sm_{major}{minor}")
    else:
        where = ("cpu",)
    return (torch.__version__, torch.version.cuda) + where


def hw_fingerprint(backend: str = "cuda", device="cuda") -> str:
    """Fingerprint of the measuring environment: the backend, the torch
    and CUDA versions, and the device's name and compute capability (or
    ``"cpu"``).  Two hosts with the same fingerprint are
    interchangeable for the measured-cost table, which is what lets
    processes share one table."""
    return repr((backend,) + _env_fields(device))


def group_key(gsig: str, order_pos, blocks, fingerprint: str) -> str:
    """Per-*group* measured-cost key: localized group signature + the
    impl choice (grid order, block sizes) + environment fingerprint.
    Program-independent by construction — any two programs tracing a
    structurally identical group share this address, which is the
    transfer property the table exists for."""
    payload = repr(("group", gsig, tuple(order_pos), tuple(blocks),
                    fingerprint))
    return hashlib.sha256(payload.encode()).hexdigest()


def _finite_time(x) -> bool:
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x) and x > 0)


# ---------------------------------------------------------------------------
# the autotune loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateTiming:
    """One costed candidate (``rank_pred`` = position in the predicted
    order, i.e. 0 is the model's pick).  ``t_meas`` is the sum of the
    candidate's per-group timings."""

    rank_pred: int
    t_pred: float
    t_meas: float
    from_cache: bool                   # no fresh measurement was needed
    key: str                           # combination_key digest
    source: str = "groups"             # "groups" | "measured"
    n_groups: int = 0
    n_groups_cached: int = 0           # group lookups served by the table

    def describe(self) -> str:
        src = self.source if self.from_cache else "measured"
        return (f"#{self.rank_pred} t_pred={self.t_pred*1e6:.2f}us "
                f"t_meas={self.t_meas*1e6:.2f}us "
                f"({src}, {self.n_groups_cached}/{self.n_groups} "
                f"groups cached)")


@dataclasses.dataclass
class AutotuneReport:
    """What one autotune pass did — candidates in predicted order.

    ``n_measured``/``n_cached`` count *candidates* (needed fresh group
    measurements / served entirely from the table);
    ``n_groups_measured``/``n_groups_cached`` count individual group
    timings, and ``group_table_hit_rate`` is the fraction of group
    lookups the table answered — 1.0 on a warm table means the pass
    measured nothing.  ``build_s`` is the time the pass spent building
    the kernels of the groups it measured."""

    budget: int
    candidates: list[CandidateTiming]
    winner_index: int                  # into ``candidates``
    n_measured: int                    # candidates needing fresh timings
    n_cached: int                      # candidates served from the table
    n_groups_measured: int = 0         # fresh group timings this pass
    n_groups_cached: int = 0           # group lookups served by the table
    build_s: float = 0.0               # parallel kernel builds this pass

    @property
    def winner(self) -> CandidateTiming:
        return self.candidates[self.winner_index]

    @property
    def group_table_hit_rate(self) -> float:
        total = self.n_groups_measured + self.n_groups_cached
        return self.n_groups_cached / total if total else 1.0

    @property
    def measured_speedup(self) -> float:
        """Measured winner vs the predicted-best candidate (== the
        ``mode="best"`` plan): >= 1.0 by construction."""
        return self.candidates[0].t_meas / max(self.winner.t_meas, 1e-12)

    def describe(self) -> str:
        lines = [f"autotune budget={self.budget}: winner #{self.winner_index}"
                 f" ({self.n_measured} measured, {self.n_cached} cached,"
                 f" group hit rate {self.group_table_hit_rate:.2f},"
                 f" {self.measured_speedup:.2f}x vs predicted best,"
                 f" build {self.build_s:.1f}s)"]
        lines += ["  " + c.describe() for c in self.candidates]
        return "\n".join(lines)


def _valid_group_record(rec) -> bool:
    return (isinstance(rec, dict) and rec.get("kind") == "group"
            and _finite_time(rec.get("t_meas")))


def impl_group_key(g: Graph, im: Impl, fingerprint: str) -> str:
    """Per-group table key computed straight from a bound ``Impl``
    (the plan-free form of what ``autotune_combination`` keys)."""
    order_pos = tuple(im.fusion.axis_roots.index(r) for r in im.order)
    return group_key(group_signature(g, im.fusion), order_pos, im.blocks,
                     fingerprint)


def predict_combination(g: Graph, combo: Combination, hw: HardwareModel, *,
                        backend: str = "cuda", device="cuda",
                        cache: PlanCache | None = None) -> float:
    """Predicted seconds for one combination under the **two-phase
    predictor**: a group present in ``cache``'s per-group measured-cost
    table costs its measured time; an unseen group costs
    ``hw.group_cost`` over its traffic/flops features — with ``hw`` a
    refit model, that is the regression trained on the very same
    table.  With ``cache=None`` (or an empty table) this reduces exactly
    to the analytic ``sum(im.t_pred)`` recosted under ``hw``."""
    from .predictor import cost_impl
    fp = hw_fingerprint(backend, device)
    total = 0.0
    for im in combo.impls:              # order is irrelevant to a sum
        t = None
        if cache is not None:
            rec = cache.get_measurement(impl_group_key(g, im, fp))
            if _valid_group_record(rec):
                t = float(rec["t_meas"])
        if t is None:
            t = cost_impl(im.fusion, g, im.order, im.blocks, hw).t_pred
        total += t
    return total


def autotune_combination(space: OptimizationSpace, *,
                         hw: HardwareModel = V5E, backend: str = "cuda",
                         device="cuda", cache: PlanCache | None = None,
                         budget: int = 8, reps: int = MEAS_REPS,
                         warmup: int = MEAS_WARMUP,
                         inner: int = GROUP_INNER, seed: int = 0
                         ) -> tuple[Combination, ExecutionPlan, AutotuneReport]:
    """Measured-cost search over the ``budget`` best-predicted
    combinations; returns ``(winner combination, its plan, report)``.

    Candidates come from the exact nondecreasing-``t_pred`` stream, so
    candidate 0 is exactly the ``mode="best"`` plan — the measured
    winner is therefore never slower than it (same measurement pass).

    Costing is **per group**: each candidate's groups are looked up in
    the per-group measured-cost table (keyed by localized group
    signature + impl choice + environment fingerprint), or the pass's
    own memo when an earlier candidate already needs them; the groups
    nobody holds are built together (``build_groups``), then timed one
    by one through ``measure_group`` and published back to ``cache``.
    A candidate's ``t_meas`` is the sum of its group timings; groups
    are timed on synthetic data matching their signature (``seed``).
    On a CUDA device the pass frees
    the memory it allocated (kernels' buffers, graphs, inputs) from the
    caching allocator when it ends.

    Raises:
      ValueError: no legal combination covers the graph.
      UnsupportedGroupError, BuildError, CudaLaunchError: a candidate's
        group cannot be emitted, built or launched — no candidate is
        dropped without a word.
    """
    g = space.graph
    combos = scheduler.enumerate_combinations(space, limit=max(1, budget))
    if not combos:
        raise ValueError(
            "no legal combination covers the graph (the optimization "
            "space enumerated empty — every fusion impl may have been "
            "pruned, e.g. by the VMEM budget)")
    fp = hw_fingerprint(backend, device)

    # 1. look every candidate's groups up; the ones nobody holds become
    #    pending (measured once, whichever candidate needs them first)
    rows = []
    pending: dict[str, Impl] = {}
    local: dict[str, float] = {}
    for combo in combos:
        plan = build_plan(g, combo, backend=backend)
        ck = combination_key(plan)
        impls = topo_group_order(g, combo)     # same order as plan.groups
        keyed = [(group_key(group_signature(g, im.fusion), gp.order_pos,
                            gp.blocks, fp), im)
                 for gp, im in zip(plan.groups, impls)]
        missing = []
        for k, im in keyed:
            if k in local or k in pending:
                continue
            rec = cache.get_measurement(k) if cache is not None else None
            if rec is not None and not _valid_group_record(rec):
                # wrong-schema record (version drift): drop it from
                # memory and disk so the republish below heals the key
                # instead of poisoning it for every sharing process
                cache.drop_measurement(k)
                rec = None
            if rec is not None:
                local[k] = float(rec["t_meas"])
            else:
                missing.append((k, im))
        pending.update(missing)
        rows.append((combo, plan, ck, keyed, len(missing)))

    # 2. build the pending groups' kernels at once, then time them
    build_s = build_groups(g, list(pending.values()), backend, device)
    for k, im in pending.items():
        t = measure_group(g, im, backend=backend, device=device, reps=reps,
                          warmup=warmup, inner=inner, seed=seed)
        rec = {"kind": "group", "t_meas": t,
               "sig": group_signature(g, im.fusion),
               "traffic_bytes": im.traffic_bytes, "flops": im.flops,
               "elems": "+".join(c.elem.name for c in im.fusion.calls),
               "reps": reps, "warmup": warmup, "inner": inner}
        if cache is not None:
            cache.put_measurement(k, rec)
        local[k] = t

    # 3. cost the candidates
    cands = []
    n_measured = n_cached = n_gmeas = n_gcached = 0
    winner_i, winner_t = 0, math.inf
    for i, (combo, plan, ck, keyed, n_missing) in enumerate(rows):
        t_meas = sum(local[k] for k, _ in keyed)
        source, from_cache = ("measured", False) if n_missing \
            else ("groups", True)
        n_hit = len(keyed) - n_missing
        n_gmeas += n_missing
        n_gcached += n_hit
        if from_cache:
            n_cached += 1
        else:
            n_measured += 1
        cands.append(CandidateTiming(
            rank_pred=i, t_pred=combo.t_pred, t_meas=t_meas,
            from_cache=from_cache, key=ck, source=source,
            n_groups=len(keyed), n_groups_cached=n_hit))
        if t_meas < winner_t:
            winner_i, winner_t = i, t_meas

    if pending and torch.device(device).type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    report = AutotuneReport(budget=budget, candidates=cands,
                            winner_index=winner_i, n_measured=n_measured,
                            n_cached=n_cached, n_groups_measured=n_gmeas,
                            n_groups_cached=n_gcached, build_s=build_s)
    return combos[winner_i], rows[winner_i][1], report


# ---------------------------------------------------------------------------
# hardware calibration
# ---------------------------------------------------------------------------

#: streaming-bandwidth sweep on a CUDA device: f32 element counts of
#: 256 MiB, 512 MiB and 1 GiB arrays, far beyond the H100's 50 MB L2, so
#: the fit sees device memory and not the cache
BW_SWEEP_SIZES_CUDA = (1 << 26, 1 << 27, 1 << 28)
#: ... and on the CPU (the reference's sizes: 2, 8 and 32 MiB arrays)
BW_SWEEP_SIZES = (512 * 1024, 2 * 1024 * 1024, 8 * 1024 * 1024)
#: square f32 matmul that fills the card (8192^3: 1.1 TFLOP)
MATMUL_CUDA = 8192
#: ... and the reference's on the CPU
MATMUL_CPU = 384
#: tiny kernels per graph (or host calls) for the per-kernel cost
N_TINY = 200


def _host_best(fn, reps: int) -> float:
    """Host-clock seconds of one call of ``fn``, warmed, min-of-reps."""
    fn()
    best = math.inf
    for _ in range(max(reps, 1)):
        gc.collect()
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bandwidth_sweep(device="cuda", *, reps: int = 3,
                    sizes=None) -> dict[int, float]:
    """Streaming bandwidth at each of ``sizes`` f32 element counts (by
    default ``BW_SWEEP_SIZES_CUDA`` on a CUDA device, else
    ``BW_SWEEP_SIZES``): an elementwise add into a second buffer (2
    bytes moved per element byte), min-of-``reps``; on a CUDA device
    one launch timed with CUDA events behind a spin
    (``timing.replay_s``), on the CPU by the host clock.  Returns
    ``{bytes_moved: bytes/s}`` — keys derive deterministically from
    ``sizes``, values carry the jitter."""
    dev = codegen.resolve_device(device)
    on_cuda = dev.type == "cuda"
    if sizes is None:
        sizes = BW_SWEEP_SIZES_CUDA if on_cuda else BW_SWEEP_SIZES
    out: dict[int, float] = {}
    for n in sizes:
        x = torch.zeros(int(n), dtype=torch.float32, device=dev)
        y = torch.empty_like(x)

        def add1(x=x, y=y):
            torch.add(x, 1.0, out=y)

        if on_cuda:
            best = timing.replay_s(add1, inner=1, reps=reps)
        else:
            best = _host_best(add1, reps)
        moved = 2 * 4 * int(n)
        out[moved] = moved / max(best, 1e-9)
        del x, y
    if on_cuda:
        torch.cuda.empty_cache()
    return out


_CALIBRATED: dict[tuple, HardwareModel] = {}


def calibration_key(device="cuda") -> str:
    """The measurement-layer key of ``device``'s calibration record."""
    fields = _env_fields(codegen.resolve_device(device))
    return hashlib.sha256(
        repr(("calibration",) + fields).encode()).hexdigest()


def calibrate_hardware(device="cuda", *, force: bool = False, reps: int = 3,
                       cache: PlanCache | None = None) -> HardwareModel:
    """Micro-benchmark ``device`` (default the GPU; without one that
    raises: the CPU is measured only when the caller passes ``"cpu"``)
    into a ``HardwareModel``.

    Three measurements, each min-of-``reps`` after a warm-up:

    * **streaming bandwidth** — elementwise adds over a ≥3-size array
      sweep (``bandwidth_sweep``), roofline-fitted: least squares of
      time against bytes moved, whose slope inverts to ``hbm_bw`` (the
      intercept absorbs fixed per-launch cost);
    * **per-kernel overhead** — on a CUDA device, ``N_TINY`` launches of
      a tiny kernel captured into one CUDA graph, the replay's time per
      kernel: what a plan pays per group when it replays (its eager
      Python path is not what a served plan pays); on the CPU, a loop
      of tiny host calls → ``launch_overhead_s``;
    * **flop rate** — one square f32 matmul, 8192³ on a CUDA device
      with TF32 off (the rate K1's f32 arithmetic can reach; a library
      call, for the measurement only), 384³ on the CPU → ``peak_flops``
      (stored with ``f32_scale=1.0``).

    Results are memoized per device and rounded to 2 significant
    figures so the constants — which feed compiler cache keys — are
    stable across runs.  They are published to the measurement layer of
    ``cache`` (default: the process-wide cache, hence
    ``REPRO_PLAN_CACHE_DIR`` when set), keyed on the environment's
    fields (``hw_fingerprint``'s, less the backend), and the store's
    **first-written** record always wins — a process that loses the
    publish race adopts the winner's constants, so every process
    sharing the dir ends on identical plan-cache keys.  ``force=True``
    re-measures, but a persisted record still governs what is returned.
    ``min_tile`` and ``vmem_bytes`` keep V5E's values: they are pruning
    policy, not speed, so a calibrated model searches the same space
    and only the ranking changes.
    """
    dev = codegen.resolve_device(device)
    platform = dev.type
    fields = _env_fields(dev)
    if cache is None:
        from .cache import default_cache
        cache = default_cache()
    cal_key = calibration_key(dev)

    def from_record(rec) -> HardwareModel | None:
        if not isinstance(rec, dict) or rec.get("kind") != "calibration":
            return None
        try:
            pf, bw, lo = (float(rec[k]) for k in
                          ("peak_flops", "hbm_bw", "launch_overhead_s"))
        except (KeyError, TypeError, ValueError):
            return None
        if not all(math.isfinite(v) and v > 0 for v in (pf, bw, lo)):
            return None
        return HardwareModel(
            name=str(rec.get("name", f"calibrated_{platform}")),
            peak_flops=pf, f32_scale=1.0, hbm_bw=bw,
            vmem_bytes=V5E.vmem_bytes, launch_overhead_s=lo,
            min_tile=V5E.min_tile)

    sweep: dict[int, float] | None = None     # set when THIS process measures
    raw: dict[str, float] = {}                # ... and its unrounded fit

    def record_of(hw: HardwareModel) -> dict:
        rec = {"kind": "calibration", "name": hw.name,
               "peak_flops": hw.peak_flops, "hbm_bw": hw.hbm_bw,
               "launch_overhead_s": hw.launch_overhead_s}
        if sweep:
            # per-size bandwidths behind the fit, keyed by bytes moved
            rec["bw_sweep"] = {str(k): sweep[k] for k in sorted(sweep)}
            rec["unrounded"] = dict(raw)
        return rec

    def adopt(hw: HardwareModel) -> HardwareModel:
        """Publish, then converge on the store's first-written record."""
        cache.put_measurement(cal_key, record_of(hw))
        if cache.disk_dir:
            cache.forget_measurement(cal_key)   # local copy masks disk
            got = from_record(cache.get_measurement(cal_key))
            if got is not None:
                hw = got
            else:                               # unreadable dir: local wins
                cache.put_measurement(cal_key, record_of(hw))
        if _CALIBRATED.get(fields) != hw:       # keep object identity stable
            _CALIBRATED[fields] = hw
        return _CALIBRATED[fields]

    if not force:
        memo = _CALIBRATED.get(fields)
        rec = cache.get_measurement(cal_key)
        got = from_record(rec)
        if got is not None:
            if memo != got:
                _CALIBRATED[fields] = got
            return _CALIBRATED[fields]
        if rec is not None:
            cache.drop_measurement(cal_key)     # schema drift: heal the key
        if memo is not None:
            return adopt(memo)                  # share with this cache too

    # streaming bandwidth: a >=3-size sweep, roofline-fitted
    sweep = bandwidth_sweep(dev, reps=reps)
    moved = np.array(sorted(sweep), dtype=np.float64)
    t_sizes = np.array([b / sweep[b] for b in sorted(sweep)])
    slope = np.linalg.lstsq(
        np.stack([moved, np.ones_like(moved)], axis=1),
        t_sizes, rcond=None)[0][0]
    if math.isfinite(slope) and slope > 0:
        hbm_bw = 1.0 / float(slope)
    else:
        # degenerate fit (jitter-dominated): the largest size's direct
        # measurement is the safest estimate
        hbm_bw = sweep[max(sweep)]

    xt = torch.zeros(8, dtype=torch.float32, device=dev)
    m = MATMUL_CUDA if platform == "cuda" else MATMUL_CPU
    a = torch.ones((m, m), dtype=torch.float32, device=dev)
    c = torch.empty_like(a)
    if platform == "cuda":
        launch = timing.replay_s(lambda: xt.add_(1.0), inner=N_TINY,
                                 reps=reps)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            t_mm = timing.replay_s(lambda: torch.matmul(a, a, out=c),
                                   inner=1, reps=reps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    else:
        def tiny_loop():
            for _ in range(N_TINY):
                xt.add_(1.0)

        launch = _host_best(tiny_loop, reps) / N_TINY
        t_mm = _host_best(lambda: torch.matmul(a, a, out=c), reps)
    flops = 2.0 * m ** 3 / max(t_mm, 1e-9)
    raw.update(peak_flops=flops, hbm_bw=hbm_bw, launch_overhead_s=launch)
    del a, c, xt
    if platform == "cuda":
        torch.cuda.empty_cache()

    return adopt(HardwareModel(
        name=f"calibrated_{platform}",
        peak_flops=_round_sig(flops),
        f32_scale=1.0,
        hbm_bw=_round_sig(hbm_bw),
        vmem_bytes=V5E.vmem_bytes,
        launch_overhead_s=_round_sig(launch),
        min_tile=V5E.min_tile,
    ))
