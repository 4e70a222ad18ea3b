"""Plan/program cache: the program layer and the plan layer.

Two content-addressed layers, both keyed on hex digests computed by the
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

The disk protocol is lock-free because keys are content addresses — two
processes computing the same key computed the same plan, so writes are
idempotent: writers publish with write-to-temp + atomic ``os.replace``;
an existing entry is never rewritten (first writer wins); unreadable
entries are dropped and count as misses.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import tempfile
from typing import Any

from .plan import ExecutionPlan

log = logging.getLogger("repro_torch.cache")

_ENV_DIR = "REPRO_PLAN_CACHE_DIR"


@dataclasses.dataclass
class CacheStats:
    program_hits: int = 0
    program_misses: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    disk_hits: int = 0
    disk_writes: int = 0

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


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



class PlanCache:
    def __init__(self, capacity: int = 256, disk_dir: str | None = None):
        self._programs = _LRU(capacity)
        self._plans = _LRU(capacity)
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

    def _publish(self, path: str, text: str) -> bool:
        """First-writer-wins atomic disk publish; returns True on a
        fresh write.  A broken cache dir degrades to a no-op, never
        fails the caller."""
        if os.path.exists(path):
            return False
        tmp = None
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
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


_default: PlanCache | None = None


def default_cache() -> PlanCache:
    """Process-wide shared cache (used when a compiler doesn't bring its
    own)."""
    global _default
    if _default is None:
        _default = PlanCache()
    return _default
