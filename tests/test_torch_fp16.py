"""K1 in float16 and at depth 3, the port against the reference.

float16: AXPYDOT and GEMVER at n = 256 through the port's ``torch``
backend and its ``cuda`` backend with CPU tensors (K1's plain tiled
version, the kernel's reference, which computes in float32 as the
kernel does), against the reference's ``pallas``
backend in interpret mode at a norm-relative 2e-2 (float16 keeps 11 bits;
the two round intermediates at different places), and against float64
numpy at 1e-2.  Depth 3: the ``make_tensor_map`` graph of the
reference's ``test_fusion_compiler.py`` compiles to ONE ``cuda`` group
and matches the reference exactly (two float32 products, same order).
"""
import numpy as np
import pytest
import torch

from repro.core import FusionCompiler as RefCompiler
from repro.core.elementary import make_tensor_map as ref_tensor_map
from repro.programs import REGISTRY as REF_REGISTRY

from repro_torch.core import FusionCompiler, PlanCache, make_tensor_map
from repro_torch.core.diagnostics import UnsupportedGroupError
from repro_torch.core.cuda_codegen import GroupLayout
from repro_torch.programs import REGISTRY, make_inputs
from torch_threads import capped_torch_threads  # noqa: F401

N = 256


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["AXPYDOT", "GEMVER"])
def test_float16_programs_match_the_reference(name, backend):
    shapes = REGISTRY[name].shapes(N)
    env = make_inputs(REGISTRY[name], N, seed=4, dtype=np.float16)
    ref64 = REGISTRY[name].reference(
        **{k: np.asarray(v, np.float64) for k, v in env.items()})
    rprog = RefCompiler(backend="pallas", dtype=np.float16,
                        cache=None).compile(REF_REGISTRY[name].script, shapes)
    want = rprog(**env)
    for mode in ("best", "unfused"):
        prog = FusionCompiler(backend=backend, device="cpu", cache=PlanCache(),
                              dtype=np.float16).compile(
            REGISTRY[name].script, shapes, mode=mode)
        got = prog(**env)
        for o, w, r in zip(got, want, ref64):
            assert o.dtype == torch.float16
            assert _rel(o.numpy(), np.asarray(w)) <= 2e-2
            assert _rel(o.numpy(), r) <= 1e-2


def test_float16_plain_version_computes_in_float32():
    """K1's plain tiled version rounds a float16 group where the kernel
    stores, not after every tile: AXPYDOT's dot product over 2**20
    terms keeps float16's precision (1e-3 of float64, about two units
    in the last place), where a sum rounded to float16 tile by tile
    drifts far past it."""
    n = 1 << 20
    env = make_inputs(REGISTRY["AXPYDOT"], n, seed=4, dtype=np.float16)
    ref64 = REGISTRY["AXPYDOT"].reference(
        **{k: np.asarray(v, np.float64) for k, v in env.items()})
    prog = FusionCompiler(backend="cuda", device="cpu", cache=PlanCache(),
                          dtype=np.float16).compile(
        REGISTRY["AXPYDOT"].script, REGISTRY["AXPYDOT"].shapes(n))
    for o, r in zip(prog(**env), ref64):
        assert o.dtype == torch.float16
        assert _rel(o.numpy(), r) <= 1e-3


@pytest.mark.parametrize("name", ["AXPYDOT", "GEMVER", "BiCGK",
                                  "LM_DECODE_ATTN"])
def test_float16_groups_are_emitted_with_half_buffers(name):
    cc = FusionCompiler(backend="cuda", device="cpu", cache=PlanCache(),
                        dtype=np.float16)
    prog = cc.compile(REGISTRY[name].script, REGISTRY[name].shapes(N))
    src = prog.module.source
    assert "const __half* __restrict__ g_in0" in src
    assert "k1::st<__half>" in src and "k1::st<float>" not in src
    for fn in prog.group_fns:
        raw, ws = fn.buffers(torch.device("cpu"))
        assert all(t.dtype == torch.float16 for t in raw)


def test_float64_groups_still_refuse():
    cc = FusionCompiler(backend="cuda", device="cpu", cache=PlanCache(),
                        dtype=np.float64)
    with pytest.raises(UnsupportedGroupError, match="RPL214"):
        cc.compile(REGISTRY["AXPYDOT"].script, REGISTRY["AXPYDOT"].shapes(N))


def _three_axis(make, cuda=None):
    kw = {} if cuda is None else {"cuda": cuda}
    t3 = make("mul3", lambda x, y: x * y, in_axes=[(0, 1, 2), (0, 1, 2)],
              depth=3, **kw)

    def script(g, a, b):
        t = g.apply(t3, a, b, name="t")
        return (g.apply(t3, t, a, name="o"),)
    return script


@pytest.mark.parametrize("shape", [(4, 8, 128), (3, 5, 70)])
def test_depth3_graph_is_one_cuda_group_and_matches_the_reference(shape):
    shapes = {"a": shape, "b": shape}
    prog = FusionCompiler(backend="cuda", device="cpu",
                          cache=PlanCache()).compile(
        _three_axis(make_tensor_map, "{0} * {1}"), shapes)
    assert prog.n_groups == 1
    lay = prog.group_fns[0].layout
    assert isinstance(lay, GroupLayout) and len(lay.extras) == 1
    assert "for (long long ck0 = ck00; ck0 < ck01; ++ck0)" in \
        prog.module.source
    rprog = RefCompiler(backend="pallas", cache=None).compile(
        _three_axis(ref_tensor_map), shapes)
    assert rprog.n_groups == 1
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    got = prog(a=a, b=b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rprog(a=a, b=b)))
    np.testing.assert_array_equal(got.numpy(), a * b * a)
