"""Device timers of the port (CUDA events on the card).

* ``time_ms`` — calls back to back, events around them: at the host's
  pace where a call's host path outlasts its device work;
* ``replay_s`` — the graph-replay timer: ``inner`` calls captured in one
  CUDA graph, replayed back to back in each timed region behind a spin,
  the cyclic GC flushed before the regions and off during them, the
  least per call kept.
  The autotune times its groups with it at a fixed ``inner``
  (``core.autotune.measure_group``); ``inner=None`` captures about 1 ms
  of calls;
* ``graph_ms`` — ``replay_s`` with ``inner=None``, in ms, or
  ``device_ms`` for a call that cannot be captured;
* ``device_ms`` — calls queued behind a spinning kernel, for what
  cannot be captured.

The spin before a timed region keeps the device busy while the host
queues the region, so the start event does not also time the
submission.  A capture that holds no device work raises
``EmptyCaptureError``: its replay would time as ~0.
"""
from __future__ import annotations

import gc
import math
import time
import warnings

import torch

from ..kernels._launch import LAUNCHES

#: cycles of the spin ahead of a timed region: ~1 ms at the H100's
#: clock, longer than the host takes to queue the region's replays (a
#: 50 us spin left ~45 us of submission inside one replay's events)
SPIN_CYCLES = 2_000_000
#: a timed region replays its graph until it lasts this long: its fixed
#: cost, ~3 us of events and graph launch, then stays near 1 %
MIN_REGION_S = 200e-6
#: ... but no more than this many times
MAX_REPLAYS = 16
#: ``inner=None``: calls captured for about this much device work ...
ADAPTIVE_S = 1e-3
#: ... but no more than this many
MAX_INNER = 64
#: what PyTorch warns when a capture recorded no work
_EMPTY = "The CUDA Graph is empty"


class CaptureError(RuntimeError):
    """``fn`` cannot be captured into a CUDA graph (it synchronises)."""


class EmptyCaptureError(RuntimeError):
    """A capture recorded no device work, or fewer kernel launches than
    the caller expects."""


def time_ms(fn, budget_ms: float = 300.0, max_reps: int = 50,
            warmup: bool = True) -> float:
    """Mean time per call of ``fn`` called back to back (CUDA events),
    after one warm-up call (``warmup``); ``max_reps=1`` times one call.
    Calls whose host path outlasts their device work are timed at the
    host's pace."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    if max_reps == 1:
        return first
    reps = max(1, min(max_reps, int(budget_ms / max(first, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _capture(fn, inner: int, launches: int) -> torch.cuda.CUDAGraph:
    """``inner`` calls of ``fn`` captured into one CUDA graph.  Raises
    ``CaptureError`` where the capture fails, ``EmptyCaptureError``
    where it holds no work or fewer than ``launches`` kernel launches
    of the port's wrappers."""
    graph = torch.cuda.CUDAGraph()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with LAUNCHES.capturing() as captured:  # a capture runs nothing
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    for _ in range(inner):
                        fn()
        except RuntimeError as e:
            raise CaptureError(str(e)) from e
    empty = False
    for w in caught:
        if _EMPTY in str(w.message):
            empty = True
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    if empty or len(captured) < launches:
        raise EmptyCaptureError(
            f"a capture of {inner} calls recorded "
            f"{'no device work' if empty else 'no kernel'}: "
            f"{len(captured)} launches of the port's kernels, "
            f"{launches} expected")
    return graph


def _region_s(graph, n: int, start, end) -> float:
    """Seconds of one timed region: ``n`` replays of ``graph`` queued
    back to back behind the spin, between two events."""
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def replay_s(fn, *, inner: int | None = None, reps: int = 3,
             warmup: int = 1, launches: int = 0) -> float:
    """Seconds of device time per call of ``fn``: ``warmup`` eager calls
    (the first builds and loads kernels), then ``inner`` calls captured
    into one CUDA graph (``None``: as many as make about ``ADAPTIVE_S``
    of device work by one timed call, at most ``MAX_INNER``).  Each of
    ``reps`` timed regions replays the graph back to back behind a spin
    — as many times as bring the region to ``MIN_REGION_S``, at most
    ``MAX_REPLAYS`` — with the cyclic GC flushed before them and off
    during them, and the least per call is kept.  ``fn`` runs as a plan runs it inside the plan's own graph.
    ``launches``: the least number of the port's kernel launches the
    capture must hold (``EmptyCaptureError`` otherwise)."""
    for _ in range(max(warmup, 1)):
        fn()
    torch.cuda.synchronize()
    if inner is None:
        first = time_ms(fn, max_reps=1, warmup=False) / 1e3
        inner = max(1, min(MAX_INNER, int(ADAPTIVE_S / max(first, 1e-6))))
    graph = _capture(fn, max(inner, 1), launches)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    first = _region_s(graph, 1, start, end)
    n = max(1, min(MAX_REPLAYS, math.ceil(MIN_REGION_S / max(first, 1e-9))))
    best = math.inf
    gc.collect()                # no collection inside a timed region
    enabled = gc.isenabled()
    gc.disable()
    try:
        for _ in range(max(reps, 1)):
            best = min(best, _region_s(graph, n, start, end) / n)
    finally:
        if enabled:
            gc.enable()
    del graph
    return best / max(inner, 1)


def graph_ms(fn):
    """(Device ms per call of ``fn`` by ``replay_s`` with about 1 ms of
    calls in one graph, "graph"); a ``fn`` that cannot be captured (a
    library call that synchronises) is timed by ``device_ms`` instead:
    (ms, "spin")."""
    try:
        return replay_s(fn) * 1e3, "graph"
    except CaptureError:
        torch.cuda.synchronize()
        return device_ms(fn), "spin"


def device_ms(fn, budget_ms: float = 300.0, max_reps: int = 100) -> float:
    """Mean device time per call of ``fn``: the calls are queued behind a
    spinning kernel that lasts twice their measured host path, so the
    events see the device run them back to back (while the host keeps
    ahead of the queue: ``graph_ms`` is the robust measure, this one is
    for what cannot be captured)."""
    fn()
    first = time_ms(fn, max_reps=1, warmup=False)
    reps = max(3, min(max_reps, int(budget_ms / max(first, 1e-3))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()                    # enqueue only: the host path of one call
    host_s = (time.perf_counter() - t0) / 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # the spin counts cycles; 2e9 a second is above the H100's clock
    torch.cuda._sleep(int(reps * max(50e-6, 2 * host_s) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
