"""Program registry.

A *program* is everything the pipeline needs to serve one workload
through the fusion compiler: a script of elementary calls, a shape
factory parameterized by the workload size, a reference implementation,
and optional serving metadata (an input factory for well-conditioned
random instances, explicit per-input pad identities).

The paper's 11 BLAS sequences register here (``programs.blas``) next to
the LM decode-step workloads (``programs.models``); ``repro_torch.blas``
re-exports the BLAS group as ``blas.REGISTRY``.  Inputs are numpy arrays
made from a seed (``make_inputs``), the same generator the JAX reference
uses, so both packages can be fed identical data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class Program:
    """One registered workload.

    The first six fields are the historical ``blas.Sequence`` layout
    (positional compatibility preserved); the rest are serving metadata
    new registrations may carry.
    """

    name: str
    tag: str
    script: Callable                     # (g, **vars) -> outputs
    shapes: Callable[[int], dict]        # n -> {input name: shape}
    reference: Callable                  # numpy oracle, same signature
    flops: Callable[[int], float]        # useful flops at size n
    #: custom input factory ``(n, seed, dtype) -> {name: array}`` for
    #: workloads whose inputs are not well-conditioned as iid normals
    #: (e.g. AdamW's second moment must be non-negative, rmsnorm's
    #: ``inv_d`` must equal 1/n exactly).  None: generic random inputs.
    inputs: Callable[..., dict] | None = None
    #: explicit per-input pad identities, overriding the engine's
    #: whole-graph analysis (``serving.input_pad_values``).  None: let
    #: the engine analyze (and fall back to per-lane masking).
    pad_values: Mapping[str, Any] | None = None


#: Back-compat alias — ``blas.Sequence`` has always been this shape.
Sequence = Program

#: All registered programs, by name.
REGISTRY: dict[str, Program] = {}
#: The paper's 11 BLAS evaluation sequences (Table 1).
BLAS: dict[str, Program] = {}
#: LM decode-step workloads (rmsnorm, decoder block, decode attention,
#: AdamW).
MODELS: dict[str, Program] = {}


def register(prog: Program, group: dict[str, Program] | None = None) -> Program:
    """Register ``prog`` globally (and in ``group`` when given)."""
    if prog.name in REGISTRY:
        raise ValueError(f"program {prog.name!r} already registered")
    REGISTRY[prog.name] = prog
    if group is not None:
        group[prog.name] = prog
    return prog


def make_inputs(prog: Program, n: int, seed: int = 0,
                dtype=np.float32) -> dict[str, np.ndarray]:
    """Random inputs for one instance of ``prog`` at size ``n``.

    Honors the program's own ``inputs`` factory when it has one;
    otherwise scalars draw uniform [0.5, 1.5) (away from 0, so scale
    factors neither vanish nor flip signs) and arrays standard normal.
    """
    factory = getattr(prog, "inputs", None)
    if factory is not None:
        return factory(n, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    out = {}
    for name, shape in prog.shapes(n).items():
        if shape == ():
            out[name] = dtype.type(rng.uniform(0.5, 1.5))
        else:
            out[name] = rng.standard_normal(shape).astype(dtype)
    return out
