"""CUDA graphs of the port's programs: one graph per plan.

A program's eager path calls each group's kernel from Python: every
call allocates its buffers, checks its tensors and goes through
``ctypes``, 20-45 µs of host a group.  ``GraphRunner`` captures the
whole program (every group launch, its output and workspace buffers,
the fold of ``partial`` outputs) once into a ``torch.cuda.CUDAGraph``
and replays it, so a request costs one graph launch.

A graph bakes in addresses, so graphs are keyed on their inputs'
addresses, shapes, strides and dtypes (a small LRU): a graph reads its
inputs where they lie when it replays, so the same tensors — or new
ones at the same addresses, as a staging buffer refilled per batch —
replay it.  An input set seen for the first time runs eagerly (the
first call of all also builds the kernels); one seen again is captured
and replayed from then on, so a caller whose inputs move on every call
(each step fed the last one's outputs) pays no capture per call.

Its outputs live in the graph's own memory and a replay writes them
again, so no result a caller still holds may be handed to a replay:
each key keeps up to ``MAX_SLOTS`` *slots*, one captured graph and its
outputs each, and a replay takes a slot none of whose outputs anyone
else references (the storages' use counts are back to the slot's own).
When every slot is held and there is room, one more is captured; when
there is none, the call runs the program eagerly into fresh buffers
(the same kernels, counted in ``n_held``), so a caller that keeps every
result pins at most ``MAX_SLOTS`` graphs' memory and never makes the
runner capture again.  Callers get fresh views of the slot's outputs,
so holding a result, or any view of it, keeps its slot busy; a caller
that keeps results for long (the serving engine) copies them out.

A replay adds the kernels the graph launches to ``LAUNCHES``: the
capture recorded their names and launched nothing.
"""
from __future__ import annotations

import collections
from typing import Callable

import torch

from ..kernels._launch import LAUNCHES

#: input sets a runner keeps graphs for (least recently used dropped)
CAPACITY = 8
#: captured graphs a runner keeps for one input set
MAX_SLOTS = 2


def _uses(t: torch.Tensor) -> int:
    """References to ``t``'s storage (one per tensor that views it)."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


class _Slot:
    """One captured graph, its outputs and the kernels it launches."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs: tuple,
                 launches: list[str], inputs: tuple):
        self.graph, self.outputs, self.launches = graph, outputs, launches
        in_storages = {t.untyped_storage().data_ptr() for t in inputs}
        # outputs that are inputs passed through are the caller's memory
        self._watch = [t for t in outputs
                       if t.untyped_storage().data_ptr() not in in_storages]
        self._base = [_uses(t) for t in self._watch]

    def free(self) -> bool:
        return all(_uses(t) <= n for t, n in zip(self._watch, self._base))

    def replay(self) -> tuple:
        self.graph.replay()
        for name in self.launches:
            LAUNCHES.add(name)
        return tuple(t.detach() for t in self.outputs)


class GraphRunner:
    """Runs ``fn(*inputs) -> tuple of tensors`` on CUDA tensors by graph
    replay (module docstring).  ``fn`` must be capturable: its kernels
    built and loaded, no host synchronisation."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._slots: collections.OrderedDict = collections.OrderedDict()
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self.n_captures = 0
        self.n_held = 0        # calls run eagerly: every slot was held

    @property
    def most_graphs(self) -> int:
        """The most graphs kept for one input set."""
        return max(map(len, self._slots.values()), default=0)

    @staticmethod
    def key(inputs) -> tuple:
        return tuple((t.device.index, t.data_ptr(), tuple(t.shape),
                      t.stride(), t.dtype) for t in inputs)

    def __call__(self, *inputs: torch.Tensor) -> tuple:
        key = self.key(inputs)
        slots = self._slots.get(key)
        if slots is None:
            if key not in self._seen:          # first sighting: eager
                self._seen[key] = None
                while len(self._seen) > 8 * CAPACITY:
                    self._seen.popitem(last=False)
                return tuple(self.fn(*inputs))
            del self._seen[key]
            slots = self._slots[key] = []
            while len(self._slots) > CAPACITY:
                self._slots.popitem(last=False)
        self._slots.move_to_end(key)
        for slot in slots:
            if slot.free():
                return slot.replay()
        if len(slots) >= MAX_SLOTS:
            self.n_held += 1
            return tuple(self.fn(*inputs))
        slot = self._capture(inputs)
        slots.append(slot)
        return slot.replay()

    def _capture(self, inputs) -> _Slot:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(inputs[0].device):
            with LAUNCHES.capturing() as launches:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    outs = tuple(self.fn(*inputs))
        self.n_captures += 1
        return _Slot(graph, outs, launches, inputs)
