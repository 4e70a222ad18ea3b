"""Elementary functions — the unit the fusion compiler operates on.

The paper (Filipovič et al.) restricts fusible kernels to ``map``,
``reduce`` and their nested (depth-2) combinations.  All of them are
modelled with one *blocked iteration-space* abstraction:

* every elementary function iterates over a set of named axes
  (depth 1: ``('i',)``; depth 2: ``('i', 'j')``);
* every argument is indexed by a subset of those axes (``()`` means the
  argument is a broadcast scalar / "invariant" in the paper's terms);
* the output is indexed by a subset of the axes; axes missing from the
  output are *reduce axes* — the output is accumulated over them with the
  elementary's monoid (``+`` by default).

Each elementary carries two bodies of the same function:

* ``fn`` — block-polymorphic torch code: it receives tensors that are
  either the full operands (the dense ``torch`` backend) or one plan tile
  (the tiled plain version of kernel K1) and computes the same thing for
  both;
* ``cuda`` — a per-point CUDA C expression over its arguments, with
  ``{0}``, ``{1}``, ... standing for the arguments' values at one point of
  the iteration space.  For a map it is the output value at that point;
  for a reduction it is the point's term, which the generated kernel
  combines with the monoid over the reduce axes (``gemv`` is the term
  ``{0} * {1}``, i.e. ``A_ij * x_j``, summed over ``j``).  Kernel K1's
  source generator (``core.cuda_codegen``) glues these expressions into
  one kernel per fused group.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Sequence

import torch


class Kind(enum.Enum):
    MAP = "map"                      # depth-1, no reduce axes
    REDUCE = "reduce"                # depth-1, output ()
    NESTED_MAP = "nested_map"        # depth-2, no reduce axes
    NESTED_MAP_REDUCE = "nested_map_reduce"  # depth-2, one reduce axis


class Monoid(enum.Enum):
    SUM = "sum"
    MAX = "max"
    MIN = "min"

    def combine(self, a, b):
        if self is Monoid.SUM:
            return a + b
        if self is Monoid.MAX:
            return torch.maximum(a, b)
        return torch.minimum(a, b)

    def reduce(self, x: torch.Tensor, dims=None) -> torch.Tensor:
        """Reduce ``x`` over ``dims`` (all dims when None)."""
        dims = tuple(range(x.dim())) if dims is None else tuple(dims)
        if not dims:
            return x
        if self is Monoid.SUM:
            return torch.sum(x, dim=dims)
        if self is Monoid.MAX:
            return torch.amax(x, dim=dims)
        return torch.amin(x, dim=dims)


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """How one argument is indexed by the elementary's iteration axes.

    ``axes`` is a tuple of axis *positions* into the elementary's formal
    axis list, in the order they appear as array dimensions.  E.g. for a
    depth-2 function with formal axes ``('i', 'j')``:

    * ``axes=(0, 1)`` — a matrix indexed ``[i, j]``
    * ``axes=(1,)``   — a vector indexed ``[j]`` (invariant over ``i``)
    * ``axes=()``     — a scalar, invariant everywhere
    """

    axes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Elementary:
    """A fusible elementary function (paper §4.3).

    ``fn(*blocks) -> block`` is the torch compute routine and ``cuda``
    the per-point CUDA C expression (see the module docstring); loads
    and stores are synthesized by the code generators from the
    ArgSpecs.
    """

    name: str
    kind: Kind
    formal_axes: tuple[str, ...]
    in_specs: tuple[ArgSpec, ...]
    out_axes: tuple[int, ...]          # positions of formal axes kept in output
    fn: Callable[..., Any]
    monoid: Monoid = Monoid.SUM
    flops_per_point: float = 1.0       # arithmetic ops per iteration-space point
    cuda: str = ""

    def __post_init__(self):
        depth = len(self.formal_axes)
        assert depth >= 1, "elementary needs at least one iteration axis"
        for spec in self.in_specs:
            assert all(0 <= a < depth for a in spec.axes)
        assert all(0 <= a < depth for a in self.out_axes)

    @property
    def depth(self) -> int:
        return len(self.formal_axes)

    @property
    def reduce_axes(self) -> tuple[int, ...]:
        return tuple(a for a in range(self.depth) if a not in self.out_axes)

    @property
    def is_reduction(self) -> bool:
        return bool(self.reduce_axes)

    def flops(self, axis_sizes: Sequence[int]) -> float:
        return self.flops_per_point * math.prod(axis_sizes)

    def cuda_expr(self, *args: str) -> str:
        """The per-point CUDA C expression with ``args`` substituted."""
        return "(" + self.cuda.format(*args) + ")"


# ---------------------------------------------------------------------------
# Constructors for the common kinds (convenience API used by libraries).
# ---------------------------------------------------------------------------

def make_map(name: str, fn: Callable, arity: int, *, scalar_args: Sequence[int] = (),
             flops_per_point: float = 1.0, cuda: str = "") -> Elementary:
    """Depth-1 map over lists; ``scalar_args`` are broadcast () arguments."""
    specs = tuple(
        ArgSpec(() if i in set(scalar_args) else (0,)) for i in range(arity)
    )
    return Elementary(
        name=name, kind=Kind.MAP, formal_axes=("i",), in_specs=specs,
        out_axes=(0,), fn=fn, flops_per_point=flops_per_point, cuda=cuda,
    )


def make_reduce(name: str, monoid: Monoid = Monoid.SUM, *,
                flops_per_point: float = 1.0) -> Elementary:
    return Elementary(
        name=name, kind=Kind.REDUCE, formal_axes=("i",),
        in_specs=(ArgSpec((0,)),), out_axes=(), fn=monoid.reduce,
        monoid=monoid, flops_per_point=flops_per_point, cuda="{0}",
    )


def make_nested_map(name: str, fn: Callable, in_axes: Sequence[Sequence[int]], *,
                    flops_per_point: float = 1.0, cuda: str = "") -> Elementary:
    """Depth-2 map producing a matrix indexed (i, j)."""
    return Elementary(
        name=name, kind=Kind.NESTED_MAP, formal_axes=("i", "j"),
        in_specs=tuple(ArgSpec(tuple(a)) for a in in_axes), out_axes=(0, 1),
        fn=fn, flops_per_point=flops_per_point, cuda=cuda,
    )


def make_nested_map_reduce(name: str, fn: Callable,
                           in_axes: Sequence[Sequence[int]],
                           out_axis: int, *, monoid: Monoid = Monoid.SUM,
                           flops_per_point: float = 2.0,
                           cuda: str = "") -> Elementary:
    """Depth-2 map over ``out_axis`` of a reduce over the other axis.

    E.g. gemv (out_axis=0, reduce over j):  y_i = sum_j A_ij x_j
         gemtv (out_axis=1, reduce over i): s_j = sum_i A_ij r_i
    ``fn`` must compute the *partial* reduction over the block it is given
    (e.g. ``A_blk @ x_blk``); the compiler accumulates partials with the
    monoid across blocks — the paper's "accumulable output" (Alg. 1).
    ``cuda`` is the per-point term (``{0} * {1}`` for both of the above).
    """
    return Elementary(
        name=name, kind=Kind.NESTED_MAP_REDUCE, formal_axes=("i", "j"),
        in_specs=tuple(ArgSpec(tuple(a)) for a in in_axes), out_axes=(out_axis,),
        fn=fn, monoid=monoid, flops_per_point=flops_per_point, cuda=cuda,
    )


# ---------------------------------------------------------------------------
# Non-multilinear map primitives (the ops an LM decode step needs).
# ---------------------------------------------------------------------------

exp_map = make_map("exp", torch.exp, arity=1, flops_per_point=1,
                   cuda="expf({0})")
rsqrt_map = make_map("rsqrt", torch.rsqrt, arity=1, flops_per_point=1,
                     cuda="rsqrtf({0})")
# exp(x - m) with a broadcast (reduce-finished) max — the softmax core
exp_sub = make_map("exp_sub", lambda x, m: torch.exp(x - m), arity=2,
                   scalar_args=(1,), flops_per_point=2,
                   cuda="expf({0} - {1})")
