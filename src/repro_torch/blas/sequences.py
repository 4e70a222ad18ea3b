"""The paper's 11 BLAS sequences — re-export of ``programs.BLAS`` — and
``make_synthetic_chain``, long synthetic sequences for the search."""
from __future__ import annotations

# importing the registry submodule initializes the programs package,
# which registers the BLAS group
from repro_torch.programs.registry import BLAS as REGISTRY
from repro_torch.programs.registry import Program as Sequence
from repro_torch.programs.registry import make_inputs

from . import elementary_lib as lib

__all__ = ["REGISTRY", "Sequence", "make_inputs", "make_synthetic_chain"]


def make_synthetic_chain(n_calls: int, *, reduce_consume: bool = False,
                         gemv: bool = False, scalar_input: bool = False):
    """A depth-1 map chain of ``n_calls`` elementary calls, from the
    reference's ``repro.blas.make_synthetic_chain``: the same calls in
    the same order, so the same ``graph_signature`` and plans.  Past 20
    calls it drives the search past its exact DP onto the beam.
    Returns ``(script, shapes_fn, reference)`` in the ``Sequence``
    calling convention; ``reference`` runs on numpy arrays.

    Options (all off by default):

    * ``scalar_input`` — a scalar input ``alpha`` scales ``a`` first;
    * ``reduce_consume`` — the chain's tail is sum-reduced and the sum
      consumed by a later ``xpay``;
    * ``gemv`` — ``Aᵀ (A v)`` on the chain's tail, with an (n, n) input
      ``A``: the second matvec consumes the first's reduction.
    """

    def script(g, a, b, **extra):
        if scalar_input:
            a = g.apply(lib.scal, extra["alpha"], a)
        v = g.apply(lib.ew_add, a, b)
        vals = [a, b, v]
        for i in range(n_calls - 1):
            if i % 3 == 2:
                v = g.apply(lib.ew_add, vals[-1], vals[-2])
            else:
                v = g.apply(lib.ew_mul, vals[-1], vals[-3])
            vals.append(v)
        outs = [vals[-1]]
        if reduce_consume:
            s = g.apply(lib.sum_reduce, vals[-1])
            outs.append(g.apply(lib.xpay, s, a, b))
        if gemv:
            t = g.apply(lib.gemv_t, extra["A"], vals[-1])
            outs.append(g.apply(lib.gemtv_t, extra["A"], t))
        return tuple(outs)

    def shapes(n):
        d = {"a": (n,), "b": (n,)}
        if scalar_input:
            d["alpha"] = ()
        if gemv:
            d["A"] = (n, n)
        return d

    def reference(a, b, alpha=None, A=None):
        if scalar_input:
            a = alpha * a
        v = a + b
        vals = [a, b, v]
        for i in range(n_calls - 1):
            if i % 3 == 2:
                v = vals[-1] + vals[-2]
            else:
                v = vals[-1] * vals[-3]
            vals.append(v)
        outs = [vals[-1]]
        if reduce_consume:
            s = vals[-1].sum(dtype=vals[-1].dtype)
            outs.append(s * a + b)
        if gemv:
            t = A @ vals[-1]
            outs.append(A.T @ t)
        return tuple(outs)

    return script, shapes, reference
