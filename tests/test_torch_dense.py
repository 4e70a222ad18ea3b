"""The port's ``torch`` backend against the JAX ``jnp`` backend and the
numpy references, for all 11 BLAS programs.

Inputs are made once with numpy from a seed (``make_inputs``) and fed to
both packages.  Tolerance: the reference envelope, rtol 1e-4, atol 1e-3
(float32 matvecs summed in another order).
"""
import numpy as np
import pytest

from repro.core import FusionCompiler as RefCompiler
from repro.core import PlanCache as RefPlanCache
from repro.core import codegen as ref_codegen
from repro.core import trace as ref_trace
from repro.programs import BLAS as REF_BLAS
from repro_torch.core import FusionCompiler, PlanCache, execute_dense, trace
from repro_torch.programs import BLAS, make_inputs

N = 256


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("mode", ["best", "unfused"])
@pytest.mark.parametrize("name", sorted(BLAS))
def test_torch_backend_matches_jnp_and_numpy(name, mode):
    prog, ref_prog = BLAS[name], REF_BLAS[name]
    env = make_inputs(prog, N, seed=11)
    want = prog.reference(**env)

    port = FusionCompiler(backend="torch", device="cpu", cache=PlanCache())
    got = _tuple(port.compile(prog.script, prog.shapes(N), mode=mode)(**env))
    ref = RefCompiler(backend="jnp", cache=RefPlanCache())
    jnp_out = _tuple(ref.compile(ref_prog.script, ref_prog.shapes(N),
                                 mode=mode)(**env))
    assert len(got) == len(jnp_out) == len(want)
    for o, j, r in zip(got, jnp_out, want):
        assert tuple(o.shape) == np.shape(r)
        np.testing.assert_allclose(o.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", sorted(BLAS))
def test_execute_dense_matches_reference(name):
    prog, ref_prog = BLAS[name], REF_BLAS[name]
    env = make_inputs(prog, N, seed=3)
    got = _tuple(execute_dense(trace(prog.script, prog.shapes(N)), env))
    want = _tuple(ref_codegen.execute_dense(
        ref_trace(ref_prog.script, ref_prog.shapes(N)), env))
    for o, j in zip(got, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-3)
