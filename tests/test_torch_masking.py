"""Per-lane masking (``core.masking``) and the monoid identities and
``pad_safe`` flags it rests on, the port against the reference.

The masked graphs must trace to the reference's ``graph_signature`` (so
the search picks the same plans), and a masked program's live lanes must
match the reference's on the same padded inputs: norm-relative 1e-5 in
float32 (sums over at most 1024 terms, in another order).
"""
import numpy as np
import pytest
import torch

from repro.blas import elementary_lib as rlib
from repro.core import FusionCompiler as RefCompiler
from repro.core import Monoid as RefMonoid
from repro.core import masking as rmask
from repro.core.elementary import exp_sub as ref_exp_sub
from repro.core.graph import trace as ref_trace
from repro.core.plan import graph_signature as ref_signature
from repro.programs import REGISTRY as REF_REGISTRY
from repro.programs import model_lib as rmlib
from repro.serving import input_pad_values as ref_pad_values

from repro_torch.blas import elementary_lib as lib
from repro_torch.core import FusionCompiler, Monoid, PlanCache
from repro_torch.core.diagnostics import VerificationError
from repro_torch.core.elementary import exp_map, exp_sub, rsqrt_map
from repro_torch.core.graph import trace
from repro_torch.core.masking import (MASK_INPUT, mask_elementary, mask_row,
                                      masked_wrapper, padded_dims)
from repro_torch.core.plan import graph_signature
from repro_torch.programs import REGISTRY, make_inputs
from repro_torch.programs import model_lib as mlib
from repro_torch.serving import input_pad_values
from torch_threads import capped_torch_threads  # noqa: F401

RTOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dt", [np.float32, np.float16, np.float64,
                                np.int32, np.int64, np.int8])
def test_identity_for_agrees_with_the_reference(dt):
    for m, rm in zip(Monoid, RefMonoid):
        got, want = m.identity_for(dt), rm.identity_for(dt)
        assert got.dtype == want.dtype and got == want
        assert m.identity == rm.identity
        x = np.asarray(7, dt)
        assert m.combine(torch.as_tensor(np.asarray(got, dt)),
                         torch.as_tensor(x)) == torch.as_tensor(x)


def test_pad_safe_flags_agree_with_the_reference():
    from repro.core import elementary as relem
    for name in ("exp_map", "rsqrt_map", "exp_sub"):
        assert not getattr(relem, name).pad_safe
    for e in (exp_map, rsqrt_map, exp_sub):
        assert not e.pad_safe
    names = [n for n in dir(rlib)
             if isinstance(getattr(rlib, n), relem.Elementary)]
    assert names
    for name in names:
        assert getattr(lib, name).pad_safe == getattr(rlib, name).pad_safe


@pytest.mark.parametrize("name", ["GEMVER", "AXPYDOT", "LM_RMSNORM",
                                  "LM_DECODE_ATTN", "LM_BLOCK"])
def test_input_pad_values_agree_with_the_reference(name):
    shapes = REGISTRY[name].shapes(256)
    g = trace(REGISTRY[name].script, shapes)
    rg = ref_trace(REF_REGISTRY[name].script, shapes)
    try:
        want = ref_pad_values(rg)
    except ValueError as e:
        with pytest.raises(ValueError, match="mask"):
            input_pad_values(g)
        assert "mask" in str(e)
        return
    assert input_pad_values(g) == want


def test_mask_row_and_elementaries():
    np.testing.assert_array_equal(mask_row(8, 3), rmask.mask_row(8, 3))
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    m = torch.tensor([1.0, 0.0])
    assert mask_elementary(Monoid.MAX, 2, 0).fn(x, m).tolist() == [
        [1.0, 2.0], [-np.inf, -np.inf]]
    assert mask_elementary(Monoid.SUM, 2, 1).fn(x, m).tolist() == [
        [1.0, 0.0], [3.0, 0.0]]
    assert mask_elementary(Monoid.MIN, 1, 0).fn(m, m).tolist() == [
        1.0, np.inf]
    assert mask_elementary(Monoid.SUM, 1, 0) is mask_elementary(
        Monoid.SUM, 1, 0)
    for m_, rm in zip(Monoid, RefMonoid):
        for rank, dim in ((1, 0), (2, 0), (2, 1)):
            e, r = mask_elementary(m_, rank, dim), rmask.mask_elementary(
                rm, rank, dim)
            assert (e.name, e.pad_safe, e.in_specs) == (
                r.name, r.pad_safe, tuple(
                    type(e.in_specs[0])(s.axes) for s in r.in_specs))
    with pytest.raises(VerificationError, match="RPL131"):
        mask_elementary(Monoid.SUM, 3, 0)


def test_masked_wrapper_errors_and_padded_dims():
    shapes = {"x": (8,), "y": (4,)}
    assert padded_dims(shapes, {"x": (16,), "y": (4,)}) == \
        rmask.padded_dims(shapes, {"x": (16,), "y": (4,)})
    with pytest.raises(VerificationError, match="RPL130"):
        masked_wrapper(lambda g, x: x, {"x": (8,)}, {"x": ()})
    with pytest.raises(VerificationError, match="RPL130"):
        masked_wrapper(lambda g, x, y: x, shapes, {"x": (0,), "y": (0,)})
    with pytest.raises(VerificationError, match="RPL130"):
        masked_wrapper(lambda g, x: x, {"x": (8,), MASK_INPUT: (8,)},
                       {"x": (0,)})


def _softmax(lb, es, mb):
    def script(g, x):
        mx = g.apply(lb.max_reduce, x, name="mx")
        e = g.apply(es, x, mx, name="e")
        z = g.apply(lb.sum_reduce, e, name="z")
        return (g.apply(mb.div_by, z, e, name="w"),)
    return script


def _masked(script, rscript, shapes, shapes2):
    dims = padded_dims(shapes, shapes2)
    return (masked_wrapper(script, shapes, dims),
            rmask.masked_wrapper(rscript, shapes, dims))


@pytest.mark.parametrize("case", ["softmax", "LM_DECODE_ATTN"])
def test_masked_graphs_trace_to_the_reference_signature(case):
    if case == "softmax":
        shapes, shapes2 = {"x": (64,)}, {"x": (128,)}
        (w, ws), (rw, rws) = _masked(_softmax(lib, exp_sub, mlib),
                                     _softmax(rlib, ref_exp_sub, rmlib),
                                     shapes, shapes2)
    else:
        p, rp = REGISTRY[case], REF_REGISTRY[case]
        (w, ws), (rw, rws) = _masked(p.script, rp.script, p.shapes(512),
                                     p.shapes(1024))
    assert ws == rws
    g, rg = trace(w, ws), ref_trace(rw, rws)
    assert graph_signature(g) == ref_signature(rg)
    assert [c.elem.name for c in g.calls] == [c.elem.name for c in rg.calls]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case,bucket,n", [("softmax", 64, 37),
                                           ("LM_DECODE_ATTN", 512, 300),
                                           ("LM_DECODE_ATTN", 1024, 1000)])
def test_masked_programs_match_the_reference(backend, case, bucket, n):
    """The same padded inputs (garbage-free zeros past ``n``) and the
    same mask through the port and the reference (``jnp``): the live
    lanes agree, and against float64 numpy."""
    if case == "softmax":
        shapes, shapes2 = {"x": (bucket,)}, {"x": (2 * bucket,)}
        (w, ws), (rw, rws) = _masked(_softmax(lib, exp_sub, mlib),
                                     _softmax(rlib, ref_exp_sub, rmlib),
                                     shapes, shapes2)
        x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
        live = {"x": x}
    else:
        p, rp = REGISTRY[case], REF_REGISTRY[case]
        (w, ws), (rw, rws) = _masked(p.script, rp.script, p.shapes(bucket),
                                     p.shapes(2 * bucket))
        live = make_inputs(p, n, seed=5)
    env = {}
    for k, shape in ws.items():
        if k == MASK_INPUT:
            env[k] = mask_row(bucket, n)
            continue
        pad = np.zeros(shape, np.float32)
        pad[tuple(slice(s) for s in np.shape(live[k]))] = live[k]
        env[k] = pad
    got = FusionCompiler(backend=backend, device="cpu",
                         cache=PlanCache()).compile(w, ws)(**env)
    want = RefCompiler(cache=None).compile(rw, rws)(**env)
    got = got[0] if isinstance(got, tuple) else got
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    if case == "softmax":
        got, want = got[:n], want[:n]
        e = np.exp(x.astype(np.float64) - x.max())
        ref64 = e / e.sum()
    else:
        ref64 = REGISTRY[case].reference(
            **{k: np.asarray(v, np.float64) for k, v in live.items()})[0]
    assert _rel(got.numpy(), want) <= RTOL
    assert _rel(got.numpy(), ref64) <= RTOL
    assert torch.isfinite(got).all()
