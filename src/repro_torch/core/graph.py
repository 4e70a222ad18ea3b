"""Script tracing → data-dependency graph (paper §4.2).

A *script* is a plain Python function calling elementary functions on
traced ``Var`` handles.  Tracing records a DAG whose vertices are
elementary-function calls and whose edges are data dependencies, plus a
union-find over *iteration axes* so the fusion legality check can ask
"do these two calls iterate over the same list?" — the paper's
same-thread-block-mapping requirement (§3.2.1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from .diagnostics import VerificationError
from .elementary import Elementary


@dataclasses.dataclass
class Var:
    """A traced array value (input, intermediate, or output)."""

    name: str
    shape: tuple[int, ...]
    dtype: Any
    producer: "CallNode | None" = None   # None => graph input
    # axis ids (union-find members) per array dimension; scalars: ()
    axis_ids: tuple[int, ...] = ()

    @property
    def is_input(self) -> bool:
        return self.producer is None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"Var({self.name}:{'x'.join(map(str, self.shape))})"


@dataclasses.dataclass
class CallNode:
    """One elementary-function call — a vertex of the dependency DAG."""

    idx: int
    elem: Elementary
    args: tuple[Var, ...]
    out: Var = None  # type: ignore
    # union-find axis id for each formal axis of the elementary
    axis_ids: tuple[int, ...] = ()
    axis_sizes: tuple[int, ...] = ()

    def __hash__(self):
        return self.idx

    def __eq__(self, other):
        return isinstance(other, CallNode) and other.idx == self.idx

    def __repr__(self):
        return f"Call#{self.idx}({self.elem.name})"


class _UnionFind:
    def __init__(self):
        self.parent: list[int] = []

    def make(self) -> int:
        self.parent.append(len(self.parent))
        return len(self.parent) - 1

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class Graph:
    """The traced program: inputs, calls, outputs, unified axes."""

    def __init__(self):
        self.inputs: list[Var] = []
        self.calls: list[CallNode] = []
        self.outputs: list[Var] = []
        self.uf = _UnionFind()
        self.axis_size: dict[int, int] = {}   # root id -> size
        self._counter = 0

    # -- construction -----------------------------------------------------
    def add_input(self, name: str, shape: Sequence[int], dtype=np.float32) -> Var:
        v = Var(name, tuple(shape), np.dtype(dtype))
        v.axis_ids = tuple(self._new_axis(s) for s in v.shape)
        self.inputs.append(v)
        return v

    def _new_axis(self, size: int) -> int:
        a = self.uf.make()
        self.axis_size[a] = size
        return a

    def _unify(self, a: int, b: int):
        ra, rb = self.uf.find(a), self.uf.find(b)
        if ra == rb:
            return
        sa, sb = self.axis_size[ra], self.axis_size[rb]
        if sa != sb:
            raise VerificationError.single(
                "RPL102", "graph", f"axis size mismatch: {sa} vs {sb}")
        self.uf.union(ra, rb)
        self.axis_size[self.uf.find(ra)] = sa

    def apply(self, elem: Elementary, *args: Var, name: str | None = None) -> Var:
        """Record one elementary call; returns its output Var."""
        assert len(args) == len(elem.in_specs), (
            f"{elem.name} expects {len(elem.in_specs)} args, got {len(args)}")
        # establish the call's iteration axes, unifying with arg axes
        call_axes: list[int | None] = [None] * elem.depth
        sizes: list[int | None] = [None] * elem.depth
        for arg, spec in zip(args, elem.in_specs):
            if len(spec.axes) != len(arg.shape):
                raise VerificationError.single(
                    "RPL102", f"graph.calls[{len(self.calls)}]",
                    f"{elem.name}: arg {arg} rank {len(arg.shape)} does not "
                    f"match ArgSpec axes {spec.axes}")
            for dim, ax in enumerate(spec.axes):
                aid = arg.axis_ids[dim]
                if call_axes[ax] is None:
                    call_axes[ax] = aid
                    sizes[ax] = arg.shape[dim]
                else:
                    self._unify(call_axes[ax], aid)
                    if sizes[ax] != arg.shape[dim]:
                        raise VerificationError.single(
                            "RPL102", f"graph.calls[{len(self.calls)}]",
                            f"{elem.name}: axis {ax} size mismatch "
                            f"{sizes[ax]} vs {arg.shape[dim]}")
        if any(a is None for a in call_axes):
            raise VerificationError.single(
                "RPL102", f"graph.calls[{len(self.calls)}]",
                f"{elem.name}: some formal axes unbound by args")
        node = CallNode(idx=len(self.calls), elem=elem, args=tuple(args),
                        axis_ids=tuple(call_axes), axis_sizes=tuple(sizes))
        out_shape = tuple(sizes[a] for a in elem.out_axes)
        out_axes_ids = tuple(call_axes[a] for a in elem.out_axes)
        self._counter += 1
        out_dtype = (np.result_type(*(a.dtype for a in args)) if args
                     else np.dtype(np.float32))
        out = Var(name or f"t{self._counter}", out_shape, out_dtype,
                  producer=node)
        out.axis_ids = out_axes_ids
        node.out = out
        self.calls.append(node)
        return out

    def mark_outputs(self, *vs: Var):
        self.outputs = list(vs)

    # -- queries ----------------------------------------------------------
    def axis_root(self, aid: int) -> int:
        return self.uf.find(aid)

    def call_axis_roots(self, node: CallNode) -> tuple[int, ...]:
        return tuple(self.uf.find(a) for a in node.axis_ids)

    def consumers(self, v: Var) -> list[CallNode]:
        return [c for c in self.calls if v in c.args]

    def escapes(self, v: Var) -> bool:
        """True if ``v`` must exist in global memory (HBM): graph output."""
        return v in self.outputs

    def toposorted(self) -> list[CallNode]:
        return list(self.calls)  # construction order is topological

    def validate(self):
        for c in self.calls:
            for a in c.args:
                assert a.is_input or a.producer.idx < c.idx

    def __repr__(self):
        lines = [f"inputs: {self.inputs}"]
        for c in self.calls:
            lines.append(f"  {c.out} = {c.elem.name}({', '.join(a.name for a in c.args)})"
                         f" axes={self.call_axis_roots(c)} sizes={c.axis_sizes}")
        lines.append(f"outputs: {self.outputs}")
        return "\n".join(lines)


def trace(script: Callable, input_shapes: dict[str, Sequence[int]],
          dtype=np.float32) -> Graph:
    """Trace ``script(g, **input_vars)`` into a Graph.

    The script receives the graph (to call ``g.apply``) via a thin API
    object and the input Vars as keyword arguments; whatever it returns is
    marked as graph outputs.
    """
    g = Graph()
    kwargs = {k: g.add_input(k, shp, dtype) for k, shp in input_shapes.items()}
    result = script(g, **kwargs)
    if isinstance(result, Var):
        result = (result,)
    g.mark_outputs(*result)
    g.validate()
    return g
