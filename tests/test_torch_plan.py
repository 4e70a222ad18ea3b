"""The port's search layers against the JAX reference: same trace, same plans.

For every BLAS program at n in {256, 4096} and every mode (``best``,
``unfused`` and the ranks 0-7), ``repro_torch`` and ``repro`` trace to the
same ``graph_signature`` and build the same plan JSON, apart from the
backend name (``torch``/``cuda`` against ``jnp``/``pallas``); a rank past
the end of the space raises RPL402 in both.  A plan written by the
reference binds and runs in the port (``plan_from_reference``).
Numerics are held to the reference envelope: rtol 1e-4, atol 1e-3.
"""
import json

import numpy as np
import pytest

from repro.core import FusionCompiler as RefCompiler
from repro.core import build_space as ref_build_space
from repro.core import graph_signature as ref_graph_signature
from repro.core import trace as ref_trace
from repro.core.plan import build_plan as ref_build_plan
from repro.programs import BLAS as REF_BLAS
from repro_torch.core import (FusionCompiler, build_plan, build_space,
                              compile_plan, graph_signature,
                              plan_from_reference, trace)
from repro_torch.core.diagnostics import VerificationError
from repro_torch.programs import BLAS, make_inputs

MODES = ("best", "unfused") + tuple(range(8))


def _plans(compiler, space, g, build, backend):
    """mode -> plan dict without its backend, or the error codes."""
    out = {}
    for mode in MODES:
        try:
            combo = compiler.search(space, mode)
        except ValueError as e:
            out[mode] = ("error", tuple(getattr(e, "codes", ())))
            continue
        d = json.loads(build(g, combo, backend=backend).to_json())
        d.pop("backend")
        out[mode] = d
    return out


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("name", sorted(BLAS))
def test_plans_match_reference(name, n):
    prog, ref_prog = BLAS[name], REF_BLAS[name]
    g = trace(prog.script, prog.shapes(n))
    rg = ref_trace(ref_prog.script, ref_prog.shapes(n))
    assert graph_signature(g) == ref_graph_signature(rg)

    port = _plans(FusionCompiler(device="cpu", cache=None), build_space(g),
                  g, build_plan, "cuda")
    ref = _plans(RefCompiler(cache=None), ref_build_space(rg), rg,
                 ref_build_plan, "pallas")
    assert port == ref
    assert not isinstance(port["best"], tuple)
    errors = [m for m, p in port.items() if isinstance(p, tuple)]
    assert all(port[m] == ("error", ("RPL402",)) for m in errors)


@pytest.mark.parametrize("name,backend", [("GEMVER", "pallas"),
                                          ("ATAX", "pallas"),
                                          ("AXPYDOT", "jnp"),
                                          ("BiCGK", "jnp")])
def test_reference_plan_binds_and_runs(name, backend):
    """A plan JSON from the reference binds to the port's trace and runs
    there, on inputs shared as numpy arrays."""
    n = 256
    ref_prog = REF_BLAS[name]
    rg = ref_trace(ref_prog.script, ref_prog.shapes(n))
    ref_plan = ref_build_plan(
        rg, RefCompiler(cache=None).search(ref_build_space(rg), "best"),
        backend=backend)

    plan = plan_from_reference(ref_plan.to_json())
    assert plan.backend == {"pallas": "cuda", "jnp": "torch"}[backend]
    prog = BLAS[name]
    g = trace(prog.script, prog.shapes(n))
    cp = compile_plan(g, plan, device="cpu")
    env = make_inputs(prog, n, seed=5)
    out = cp(**env)
    out = out if isinstance(out, tuple) else (out,)
    for o, r in zip(out, prog.reference(**env)):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-3)


def test_reference_plan_with_unknown_backend_raises():
    prog = BLAS["VADD"]
    g = trace(prog.script, prog.shapes(256))
    plan = build_plan(g, FusionCompiler(device="cpu", cache=None).search(
        build_space(g), "best"), backend="cuda")
    d = json.loads(plan.to_json())
    d["backend"] = "triton"
    with pytest.raises(VerificationError) as ei:
        plan_from_reference(json.dumps(d))
    assert ei.value.codes == ("RPL201",)
