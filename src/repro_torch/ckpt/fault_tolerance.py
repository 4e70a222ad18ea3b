"""Fault-tolerance mechanisms, from the reference's
``repro.ckpt.fault_tolerance`` (pure Python, so the port keeps its own
copy): step-time straggler detection (``StepWatchdog``), a per-host
liveness ledger (``Heartbeat``), the elastic re-mesh plan
(``plan_remesh``) and SIGTERM handling (``PreemptionGuard``).

On one card the launcher wires the watchdog and the guard around its
step loop; the heartbeat and the re-mesh plan are the mechanisms a
cluster coordinator would drive, tested against simulated clocks.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time_s: float
    p50: float
    threshold: float


class StepWatchdog:
    """Flags steps slower than max(k × rolling-p50, floor).

    At pod scale a persistent straggler host shows up as a step-time
    regression on *every* step (lockstep SPMD); the mitigation ladder is
    (1) flag, (2) after `evict_after` consecutive flags request an
    elastic re-mesh that drops the slow host's slice."""

    def __init__(self, k: float = 2.0, window: int = 50,
                 floor_s: float = 1e-4, evict_after: int = 10):
        self.k, self.floor = k, floor_s
        self.times: deque[float] = deque(maxlen=window)
        self.flags: list[StragglerReport] = []
        self.consecutive = 0
        self.evict_after = evict_after

    def record(self, step: int, dt: float) -> StragglerReport | None:
        if len(self.times) >= 5:
            p50 = sorted(self.times)[len(self.times) // 2]
            thr = max(self.k * p50, self.floor)
            if dt > thr:
                rep = StragglerReport(step, dt, p50, thr)
                self.flags.append(rep)
                self.consecutive += 1
                self.times.append(dt)
                return rep
        self.consecutive = 0
        self.times.append(dt)
        return None

    @property
    def should_remesh(self) -> bool:
        return self.consecutive >= self.evict_after


class Heartbeat:
    """Per-host liveness ledger (coordinator side)."""

    def __init__(self, hosts: list[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last = {h: clock() for h in hosts}

    def beat(self, host: str):
        self.last[host] = self.clock()

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]


def plan_remesh(n_hosts_alive: int, chips_per_host: int,
                model_parallel: int) -> tuple[int, int] | None:
    """Largest (data, model) mesh that fits the surviving chips.

    Keeps the model axis (param sharding must stay consistent with the
    checkpoint's logical layout is NOT required — restore re-shards — but
    TP size must still divide head/ffn dims, so we keep it), shrinks the
    data axis to the largest divisor-friendly value."""
    chips = n_hosts_alive * chips_per_host
    if chips < model_parallel:
        return None
    data = chips // model_parallel
    # largest power-of-two data axis: keeps global batch divisible
    p = 1
    while p * 2 <= data:
        p *= 2
    return (p, model_parallel)


class PreemptionGuard:
    """SIGTERM → set a flag; the step loop checkpoints and exits cleanly."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def __enter__(self):
        def handler(signum, frame):
            self.requested = True
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
        return False
