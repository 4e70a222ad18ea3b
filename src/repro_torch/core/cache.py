"""Plan/program cache: the program, plan, packed-plan and measurement
layers.

Content-addressed layers, all keyed on hex digests computed by the
compiler:

* **program layer** (in-memory LRU only) — maps a *pre-trace* key
  (script code hash, input shapes, dtype, backend, device, hw, mode)
  straight to a finished ``CompiledProgram``.  A hit skips trace, search
  and codegen, kernel build included.
* **plan layer** (in-memory LRU + optional on-disk JSON) — maps a
  *post-trace* key (graph signature, backend, hw, mode) to a serialized
  ``ExecutionPlan``.  A hit skips optimization-space generation and the
  combination search; codegen re-binds the plan to the fresh trace.  The
  disk layer survives process restarts: set ``REPRO_PLAN_CACHE_DIR`` or
  pass ``disk_dir``.
* **packed-plan layer** (in-memory LRU + the same on-disk machinery,
  ``*.pack.json``) — maps a pack key (sorted member-plan fingerprints +
  config) to a serialized ``PackedPlan``, the member concatenation a
  multi-graph program is built from.  The key's order-independence is
  what makes a drain hitting the same sequence mix, in any order, a hit.
* **measurement layer** (in-memory LRU + the same on-disk machinery,
  ``*.meas.json``) — maps a measured-cost key (computed by
  ``core.autotune``: a group's signature, grid order and blocks and the
  hardware/backend fingerprint) to one timing record.  A hit lets
  ``mode="autotune"`` skip re-measuring a group; shared through the
  disk dir, processes measure each group once.  The key pins the
  fingerprint, so first-writer-wins keeps the protocol lock-free at the
  cost of accepting one process's (min-of-reps) sample.

``stats`` also carries the serving engine's telemetry: per-bucket
compile hits and latencies (``BucketStats``) and a bounded window of
request queue waits.

The disk protocol is lock-free because keys are content addresses — two
processes computing the same key computed the same plan, so writes are
idempotent: writers publish with write-to-temp + atomic ``os.replace``;
an existing entry is never rewritten (first writer wins); unreadable
entries are dropped and count as misses.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Any

from .plan import ExecutionPlan, PackedPlan

log = logging.getLogger("repro_torch.cache")

_ENV_DIR = "REPRO_PLAN_CACHE_DIR"

#: window for queue-wait percentiles: big enough for a stable p99 over a
#: serving pass, bounded so a long-lived engine never grows unboundedly
_QUEUE_WAIT_WINDOW = 4096
#: age past which a ``.tmp`` file in the disk dir counts as orphaned
TMP_MAX_AGE_S = 3600.0


@dataclasses.dataclass
class BucketStats:
    """Per-shape-bucket serving telemetry (one bucket = one compiled
    batched program, e.g. ``GEMVER/1024``)."""

    hits: int = 0                 # compile requests served from cache
    misses: int = 0               # compile requests that built the program
    t_compile_s: float = 0.0      # cumulative miss (compile) latency
    t_hit_s: float = 0.0          # cumulative hit (lookup) latency


@dataclasses.dataclass
class CacheStats:
    program_hits: int = 0
    program_misses: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    disk_hits: int = 0
    disk_writes: int = 0
    pack_hits: int = 0
    pack_misses: int = 0
    pack_disk_hits: int = 0
    pack_writes: int = 0
    meas_hits: int = 0
    meas_misses: int = 0
    meas_disk_hits: int = 0
    meas_writes: int = 0
    buckets: dict[str, BucketStats] = dataclasses.field(default_factory=dict)
    # submit -> dispatch wait per request (serving engine): a bounded
    # window of recent samples for percentiles
    queue_waits: list = dataclasses.field(default_factory=list)
    queue_wait_count: int = 0
    queue_wait_total_s: float = 0.0

    def record_bucket(self, label: str, *, hit: bool, seconds: float = 0.0):
        b = self.buckets.setdefault(label, BucketStats())
        if hit:
            b.hits += 1
            b.t_hit_s += seconds
        else:
            b.misses += 1
            b.t_compile_s += seconds

    def record_queue_wait(self, seconds: float):
        """One request's submit -> dispatch wait: a bounded window of
        recent samples (percentiles) plus lifetime count and total."""
        self.queue_wait_count += 1
        self.queue_wait_total_s += seconds
        self.queue_waits.append(seconds)
        if len(self.queue_waits) > _QUEUE_WAIT_WINDOW:
            del self.queue_waits[:len(self.queue_waits) - _QUEUE_WAIT_WINDOW]

    def queue_wait_percentiles(self) -> dict[str, float]:
        """p50/p99 of the recent queue-wait window, in milliseconds."""
        if not self.queue_waits:
            return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0}
        w = sorted(self.queue_waits)
        return {"count": self.queue_wait_count,
                "p50_ms": w[len(w) // 2] * 1e3,
                "p99_ms": w[min(len(w) - 1, int(len(w) * 0.99))] * 1e3}

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        del d["queue_waits"]               # summarize, don't dump the window
        d["queue_wait"] = self.queue_wait_percentiles()
        return d


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: collections.OrderedDict[str, Any] = collections.OrderedDict()

    def get(self, key: str):
        if key not in self._d:
            return None
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: str, value: Any):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def pop(self, key: str):
        return self._d.pop(key, None)

    def items(self):
        """Snapshot of (key, value) pairs, LRU order (no touch)."""
        return list(self._d.items())

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


class PlanCache:
    def __init__(self, capacity: int = 256, disk_dir: str | None = None):
        self._programs = _LRU(capacity)
        self._plans = _LRU(capacity)
        self._packs = _LRU(capacity)
        # measurement records are tiny and an autotune pass produces
        # `budget` of them per graph — give the layer headroom
        self._measurements = _LRU(capacity * 8)
        self.disk_dir = disk_dir if disk_dir is not None else os.environ.get(_ENV_DIR)
        self.stats = CacheStats()

    # -- program layer ------------------------------------------------------
    def get_program(self, key: str):
        prog = self._programs.get(key)
        if prog is None:
            self.stats.program_misses += 1
        else:
            self.stats.program_hits += 1
        return prog

    def put_program(self, key: str, prog: Any):
        self._programs.put(key, prog)

    # -- plan layer ---------------------------------------------------------
    def _disk_path(self, key: str) -> str | None:
        if not self.disk_dir:
            return None
        return os.path.join(self.disk_dir, f"{key}.plan.json")

    def get_plan(self, key: str) -> ExecutionPlan | None:
        plan = self._plans.get(key)
        if plan is not None:
            self.stats.plan_hits += 1
            return plan
        path = self._disk_path(key)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    plan = ExecutionPlan.from_json(f.read())
            except Exception as e:  # noqa: BLE001 — any load failure heals
                plan = None
                log.warning("dropping corrupt plan cache entry %s: %s "
                            "[RPL311]", path, e)
                self._unlink(path)
            if plan is not None:
                self.stats.plan_hits += 1
                self.stats.disk_hits += 1
                self._plans.put(key, plan)
                return plan
        self.stats.plan_misses += 1
        return None

    @staticmethod
    def _unlink(path: str):
        try:
            os.unlink(path)
        except OSError:
            pass

    def _gc_tmp(self, max_age_s: float = TMP_MAX_AGE_S):
        """Remove the ``.tmp`` files older than ``max_age_s`` that writers
        killed between ``mkstemp`` and ``os.replace`` left in the cache
        directory; called on every disk publish (the rare write path)."""
        try:
            names = os.listdir(self.disk_dir)
        except OSError:
            return
        now = time.time()
        for name in names:
            if not name.endswith(".tmp"):
                continue
            p = os.path.join(self.disk_dir, name)
            try:
                if now - os.path.getmtime(p) > max_age_s:
                    os.unlink(p)
            except OSError:
                pass

    def _publish(self, path: str, text: str) -> bool:
        """First-writer-wins atomic disk publish; returns True on a
        fresh write.  A broken cache dir degrades to a no-op, never
        fails the caller."""
        if os.path.exists(path):
            return False
        tmp = None
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            self._gc_tmp()
            fd, tmp = tempfile.mkstemp(dir=self.disk_dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return True
        except OSError:
            if tmp is not None:
                self._unlink(tmp)
            return False

    def put_plan(self, key: str, plan: ExecutionPlan):
        self._plans.put(key, plan)
        path = self._disk_path(key)
        if path and self._publish(path, plan.to_json()):
            self.stats.disk_writes += 1

    # -- packed-plan layer (multi-graph programs) ------------------------------
    def _pack_path(self, key: str) -> str | None:
        if not self.disk_dir:
            return None
        return os.path.join(self.disk_dir, f"{key}.pack.json")

    def get_packed_plan(self, key: str) -> PackedPlan | None:
        """Packed plans ride the plan layer's machinery (same LRU budget,
        same atomic disk protocol, ``*.pack.json``).  A hit brings back
        the member concatenation without consulting N plan entries."""
        packed = self._packs.get(key)
        if packed is not None:
            self.stats.pack_hits += 1
            return packed
        path = self._pack_path(key)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    packed = PackedPlan.from_json(f.read())
            except Exception as e:  # noqa: BLE001 — any load failure heals
                # a member with a missing field raises KeyError, a
                # non-canonical member order raises in __post_init__:
                # all of it reads as a corrupt entry, dropped so that
                # put_packed_plan can republish
                packed = None
                log.warning("dropping corrupt pack cache entry %s: %s "
                            "[RPL312]", path, e)
                self._unlink(path)
            if packed is not None:
                self.stats.pack_hits += 1
                self.stats.pack_disk_hits += 1
                self._packs.put(key, packed)
                return packed
        self.stats.pack_misses += 1
        return None

    def put_packed_plan(self, key: str, packed: PackedPlan):
        self._packs.put(key, packed)
        path = self._pack_path(key)
        if path and self._publish(path, packed.to_json()):
            self.stats.pack_writes += 1

    def drop_plan(self, key: str):
        """Remove a plan from memory and disk — the heal step when the
        verifier rejects a cache-served plan; without the unlink,
        first-writer-wins would keep the bad file and poison the key
        for every process sharing the dir."""
        self._plans.pop(key)
        path = self._disk_path(key)
        if path:
            self._unlink(path)

    def drop_packed_plan(self, key: str):
        """Remove a packed plan from memory and disk (the heal step when
        a cache-served pack is rejected), so that first-writer-wins can
        republish its key."""
        self._packs.pop(key)
        path = self._pack_path(key)
        if path:
            self._unlink(path)

    # -- measurement layer (autotune measured costs) --------------------------
    def _meas_path(self, key: str) -> str | None:
        if not self.disk_dir:
            return None
        return os.path.join(self.disk_dir, f"{key}.meas.json")

    def get_measurement(self, key: str) -> dict | None:
        rec = self._measurements.get(key)
        if rec is not None:
            self.stats.meas_hits += 1
            return rec
        path = self._meas_path(key)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError) as e:
                rec = None
                log.warning("unreadable measurement cache entry %s: %s "
                            "[RPL313]", path, e)
            if not isinstance(rec, dict):
                # stale/corrupt/wrong-shape entry: drop it so the
                # first-writer-wins put_measurement can republish —
                # otherwise a bad file poisons its key fleet-wide
                rec = None
                self._unlink(path)
            if rec is not None:
                self.stats.meas_hits += 1
                self.stats.meas_disk_hits += 1
                self._measurements.put(key, rec)
                return rec
        self.stats.meas_misses += 1
        return None

    def put_measurement(self, key: str, rec: dict):
        self._measurements.put(key, rec)
        path = self._meas_path(key)
        if path and self._publish(path, json.dumps(rec)):
            self.stats.meas_writes += 1

    def forget_measurement(self, key: str):
        """Drop the in-memory copy only (the disk record, if any,
        stands).  Lets a caller re-read the store's first-written
        record after publishing its own — the convergence step of the
        calibration protocol."""
        self._measurements.pop(key)

    def group_records(self) -> list[dict]:
        """Every per-group measurement record visible to this cache —
        the in-memory layer plus (when a disk dir is set) all
        ``*.meas.json`` entries — deduplicated by key.  This is the
        store ``HardwareModel.refit`` regresses over; records of other
        kinds sharing the measurement namespace (whole-program timings,
        calibration) are filtered here AND re-checked by ``refit``, so
        a mixed-generation cache dir never poisons the regression.
        Unreadable disk entries are skipped, not healed: enumeration
        must stay read-only so concurrent writers are undisturbed."""
        recs: dict[str, dict] = {}
        for key, rec in self._measurements.items():
            if isinstance(rec, dict) and rec.get("kind") == "group":
                recs[key] = rec
        if self.disk_dir and os.path.isdir(self.disk_dir):
            suffix = ".meas.json"
            for name in sorted(os.listdir(self.disk_dir)):
                if not name.endswith(suffix):
                    continue
                key = name[:-len(suffix)]
                if key in recs:
                    continue
                try:
                    with open(os.path.join(self.disk_dir, name)) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                if isinstance(rec, dict) and rec.get("kind") == "group":
                    recs[key] = rec
        return list(recs.values())

    def drop_measurement(self, key: str):
        """Remove a measurement from memory AND disk.  For callers that
        found the record invalid for their schema: without the unlink,
        first-writer-wins would keep the bad file and poison the key
        for every cache-sharing process."""
        self._measurements.pop(key)
        path = self._meas_path(key)
        if path:
            self._unlink(path)

    def clear(self):
        """Empty every in-memory layer and reset ``stats``; the disk dir
        is left as it is (other processes share it)."""
        self._programs.clear()
        self._plans.clear()
        self._packs.clear()
        self._measurements.clear()
        self.stats = CacheStats()


_default: PlanCache | None = None


def default_cache() -> PlanCache:
    """Process-wide shared cache (used when a compiler doesn't bring its
    own)."""
    global _default
    if _default is None:
        _default = PlanCache()
    return _default
