"""Per-lane masked padding.

``serving.input_pad_values`` pads every input of a bucketed request with
one whole-graph monoid identity.  That is sound exactly when (a) every
reduction shares one monoid and (b) padded lanes reach each reduction
unchanged — through multilinear (``pad_safe``) maps for SUM, or not at
all for MAX/MIN.  LM decode-step graphs break both: softmax mixes a MAX
reduce (over computed scores) with SUM reduces, and routes lanes through
``exp`` — a map that sends a zero-padded lane to 1.0, silently polluting
the normalizer.

This module is the fallback: instead of choosing a magic pad *value*, the
graph itself is rewritten at trace time so every reduction *masks* its
padded lanes.  A single extra rank-1 input ``_mask`` (1.0 = valid lane,
0.0 = padding) rides along with the batch; each array argument of a
reduction that is indexed by a padded reduce axis is first routed through
a ``mask_*`` elementary::

    torch.where(mask != 0, x, monoid.identity_for(x.dtype))

so padded lanes contribute the monoid identity regardless of what the
upstream maps did to them.  The mask elementaries are ordinary library
elementaries — depth-1/2 maps — so the fusion search sees them like any
other call and fuses them into the reduction's group (they are
element-wise on the reduce axis, hence always legal to fuse with their
consumer).

Padded inputs are still *filled* with 0.0 host-side (any finite value
works — masked reductions never look at them; 0.0 keeps speculative
lanes NaN/inf-free through the map chain).

Known edge: all padded axes share the one ``_mask``
input, so masking unifies them in the trace's axis union-find.  For the
registered model sequences those axes are unified by the script anyway
(one request size ``n`` scales every padded dim); a script with two
*independent* padded extents would need one mask per extent.
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .diagnostics import VerificationError
from .elementary import Elementary, Monoid, make_map, make_nested_map
from .graph import Graph, Var

#: Reserved input name carrying per-lane validity (1.0 valid, 0.0 pad).
MASK_INPUT = "_mask"


def mask_row(bucket: int, n: int, dtype=np.float32) -> np.ndarray:
    """The ``_mask`` row a request of true size ``n`` contributes."""
    return (np.arange(bucket) < n).astype(dtype)


#: torch dtype -> numpy dtype, for the identity of a tensor's dtype
_NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
              torch.float64: np.float64, torch.int32: np.int32,
              torch.int64: np.int64}


def _identity(monoid: Monoid, x: torch.Tensor):
    """The monoid identity in ``x``'s dtype, as a Python number (a
    scalar ``torch.where`` operand: no tensor is made, so the call
    stays capturable in a CUDA graph)."""
    return monoid.identity_for(_NP_DTYPES[x.dtype]).item()


@functools.lru_cache(maxsize=None)
def mask_elementary(monoid: Monoid, rank: int, dim: int) -> Elementary:
    """The mask map for one ``(monoid, arg rank, masked dim)`` triple.

    Cached so repeated traces share Elementary instances (plan/program
    cache keys hash the elementary, and ``graph_signature`` keys on the
    name — which therefore encodes all three coordinates).  Its CUDA
    expression keeps the lane where the mask is non-zero and puts the
    monoid's identity elsewhere.
    """
    cuda = f"({{1}} != 0.0f ? {{0}} : {monoid.cuda_identity})"
    # SUM's identity is 0, so the mask output itself is zero-preserving;
    # MAX/MIN masks emit ±inf lanes and are not.
    pad_safe = monoid is Monoid.SUM
    if rank == 1 and dim == 0:
        return make_map(
            f"mask_{monoid.value}_r1",
            lambda x, m: torch.where(m != 0, x, _identity(monoid, x)),
            arity=2, flops_per_point=1, cuda=cuda, pad_safe=pad_safe)
    if rank == 2 and dim == 0:
        return make_nested_map(
            f"mask_{monoid.value}_r2d0",
            lambda x, m: torch.where(m[..., :, None] != 0, x,
                                     _identity(monoid, x)),
            in_axes=[(0, 1), (0,)], flops_per_point=1, cuda=cuda,
            pad_safe=pad_safe)
    if rank == 2 and dim == 1:
        return make_nested_map(
            f"mask_{monoid.value}_r2d1",
            lambda x, m: torch.where(m[..., None, :] != 0, x,
                                     _identity(monoid, x)),
            in_axes=[(0, 1), (1,)], flops_per_point=1, cuda=cuda,
            pad_safe=pad_safe)
    raise VerificationError.single(
        "RPL131", "masking",
        f"no mask elementary for rank {rank}, dim {dim}")


class MaskedTrace:
    """``Graph`` proxy that rewrites reductions to ignore padded lanes.

    Scripts call the same ``g.apply(elem, *args)`` API; non-reduction
    calls pass through untouched (maps are lane-local — garbage stays in
    garbage lanes until a reduction would mix them in).  For reductions,
    every array argument indexed by a *padded* reduce axis is first
    masked with the reduction's monoid identity.  Masking an argument of
    a SUM mapped-reduce with 0 zeroes that lane's partial product (the
    library's partial fns are multilinear), and masking a MAX/MIN input
    with ∓inf makes the lane the identity directly.

    Padded-axis membership is tracked through the union-find: the ids
    recorded at wrap time are compared by *root* at each apply, so axes
    unified into a padded axis later in the trace are masked too.
    """

    def __init__(self, g: Graph, mask: Var, padded_ids: Sequence[int]):
        self._g = g
        self._mask_var = mask
        self._padded = list(padded_ids) + list(mask.axis_ids)
        self._memo: dict[tuple[int, tuple[int, ...], Monoid], Var] = {}

    def __getattr__(self, name):
        return getattr(self._g, name)

    def _masked(self, v: Var, dims: tuple[int, ...], monoid: Monoid) -> Var:
        key = (id(v), dims, monoid)
        out = self._memo.get(key)
        if out is None:
            out = v
            for d in dims:
                elem = mask_elementary(monoid, len(v.shape), d)
                out = self._g.apply(elem, out, self._mask_var)
            self._memo[key] = out
        return out

    def apply(self, elem: Elementary, *args: Var, name: str | None = None) -> Var:
        if elem.is_reduction:
            roots = {self._g.axis_root(a) for a in self._padded}
            reduce_axes = set(elem.reduce_axes)
            masked_args = []
            for arg, spec in zip(args, elem.in_specs):
                dims = tuple(
                    d for d, ax in enumerate(spec.axes)
                    if ax in reduce_axes
                    and self._g.axis_root(arg.axis_ids[d]) in roots)
                masked_args.append(
                    self._masked(arg, dims, elem.monoid) if dims else arg)
            args = tuple(masked_args)
        return self._g.apply(elem, *args, name=name)


def padded_dims(shapes_a: Mapping[str, Sequence[int]],
                shapes_b: Mapping[str, Sequence[int]]
                ) -> dict[str, tuple[int, ...]]:
    """Per-input dims that scale with the bucket.

    Computed structurally: instantiate the registry shape factory at two
    buckets and diff — any dim whose extent changed is padded when a
    smaller request lands in the bucket."""
    return {
        name: tuple(d for d, (x, y) in enumerate(zip(sa, shapes_b[name]))
                    if x != y)
        for name, sa in shapes_a.items()
    }


def masked_wrapper(script: Callable,
                   shapes: Mapping[str, Sequence[int]],
                   dims: Mapping[str, Sequence[int]]
                   ) -> tuple[Callable, dict[str, tuple[int, ...]]]:
    """Wrap ``script`` for per-lane masked serving.

    Returns ``(wrapped, shapes_with_mask)``: the wrapped script traces
    the original through a :class:`MaskedTrace` seeded with the padded
    axis ids of ``dims`` (see :func:`padded_dims`), and the shape dict
    gains the rank-1 ``_mask`` input covering the padded extent.  The
    wrapper closes only over ``script`` and ``dims`` (both content-
    hashable), so masked programs still hit the compiler's program
    cache.
    """
    shapes = {k: tuple(v) for k, v in shapes.items()}
    dims = {k: tuple(v) for k, v in dims.items()}
    sizes = {shapes[name][d] for name, ds in dims.items() for d in ds}
    if not sizes:
        raise VerificationError.single(
            "RPL130", "masking",
            "masked_wrapper: no padded dims — nothing to mask")
    if len(sizes) != 1:
        raise VerificationError.single(
            "RPL130", "masking",
            f"padded dims span extents {sorted(sizes)}: one _mask row "
            "cannot cover independent padded axes")
    (bucket,) = sizes
    if MASK_INPUT in shapes:
        raise VerificationError.single(
            "RPL130", "masking", f"input name {MASK_INPUT!r} is reserved")

    def wrapped(g, **kw):
        mask = kw.pop(MASK_INPUT)
        padded_ids = [kw[name].axis_ids[d]
                      for name, ds in dims.items() for d in ds]
        return script(MaskedTrace(g, mask, padded_ids), **kw)

    return wrapped, {**shapes, MASK_INPUT: (bucket,)}
