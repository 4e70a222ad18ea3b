"""The port's LM programs ``LM_RMSNORM``, ``LM_BLOCK``, ``LM_DECODE_ATTN``
and ``FUSED_ADAMW`` against the JAX reference: same inputs, same plans,
same numbers.

* the input factories give the same arrays for the same seed;
* plan JSON equals the reference's, backend apart, for ``best``,
  ``unfused`` and ranks 0-7 at n in {256, 4096}, and K1's generator
  emits every group of those plans;
* the ``torch`` backend against the reference's ``jnp`` backend and the
  numpy references; the ``cuda`` backend on CPU tensors (K1's plain
  tiled version) against numpy;
* ``tiled_reference`` against the reference's Pallas kernel
  ``_group_pallas_fn`` in interpret mode, for every group of the
  enumerated combinations at n = 256 (grids of more than one tile);
* every LM elementary's per-point CUDA expression against its torch
  ``fn`` (maps point by point; the attention contractions as the sum of
  their per-point terms over the reduce axis).

Tolerance: the reference envelope, rtol 1e-4, atol 1e-3 (float32 sums
in another order; ``rsqrtf`` is within 2 ulp).
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import V5E as REF_V5E
from repro.core import FusionCompiler as RefCompiler
from repro.core import PlanCache as RefPlanCache
from repro.core import build_space as ref_build_space
from repro.core import codegen as ref_codegen
from repro.core import graph_signature as ref_graph_signature
from repro.core import trace as ref_trace
from repro.core.plan import build_plan as ref_build_plan
from repro.core.scheduler import \
    enumerate_combinations as ref_enumerate_combinations
from repro.programs import MODELS as REF_MODELS
from repro_torch.core import (V5E, FusionCompiler, PlanCache, build_plan,
                              build_space, graph_signature,
                              plan_from_reference, trace)
from repro_torch.core import elementary as core_elem
from repro_torch.core.cuda_codegen import (GroupLayout, plan_source,
                                           tiled_reference)
from repro_torch.optim import fused as optim_fused
from repro_torch.programs import MODELS, REGISTRY, make_inputs
from repro_torch.programs import model_lib
from torch_threads import capped_torch_threads  # noqa: F401

NAMES = ("FUSED_ADAMW", "LM_BLOCK", "LM_DECODE_ATTN", "LM_RMSNORM")
MODES = ("best", "unfused") + tuple(range(8))
RTOL, ATOL = 1e-4, 1e-3


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def test_models_registered_beside_blas():
    assert sorted(MODELS) == list(NAMES)
    assert all(REGISTRY[n] is MODELS[n] for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_inputs_equal_the_reference_inputs(name):
    ours = make_inputs(MODELS[name], 256, seed=7)
    from repro.programs import make_inputs as ref_make_inputs
    theirs = ref_make_inputs(REF_MODELS[name], 256, seed=7)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert np.asarray(ours[k]).dtype == np.asarray(theirs[k]).dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


def _plans(compiler, space, g, build, backend):
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
@pytest.mark.parametrize("name", NAMES)
def test_plans_match_reference_and_emit(name, n):
    prog, ref_prog = MODELS[name], REF_MODELS[name]
    g = trace(prog.script, prog.shapes(n))
    rg = ref_trace(ref_prog.script, ref_prog.shapes(n))
    assert graph_signature(g) == ref_graph_signature(rg)
    port = _plans(FusionCompiler(device="cpu", cache=None), build_space(g),
                  g, build_plan, "cuda")
    ref = _plans(RefCompiler(cache=None), ref_build_space(rg), rg,
                 ref_build_plan, "pallas")
    assert port == ref
    errors = [m for m, p in port.items() if isinstance(p, tuple)]
    assert all(port[m] == ("error", ("RPL402",)) for m in errors)

    for mode in ("best", "unfused"):
        cp = FusionCompiler(device="cpu", cache=None).compile(
            prog.script, prog.shapes(n), mode=mode)
        src = plan_source(cp.graph, cp.group_impls)
        assert src.count("__global__") == cp.n_groups
    best = FusionCompiler(device="cpu", cache=None).compile(
        prog.script, prog.shapes(n))
    lays = [GroupLayout(best.graph, im) for im in best.group_impls]
    if name in ("LM_RMSNORM", "LM_BLOCK"):
        # the sum of squares is consumed by rms_scale: a two-phase group
        assert lays[0].names == "ew_mul+sum_reduce+rms_scale"
        assert lays[0].n_phases == 2
    if name == "LM_DECODE_ATTN":
        # scores, a three-phase softmax (a MAX, then a SUM, consumed),
        # and the weighted value sum
        assert [(la.names, la.n_phases) for la in lays] == [
            ("attn_score", 1),
            ("scal+max_reduce+exp_sub+sum_reduce+div_by", 3),
            ("attn_out", 1)]
        assert [c.elem.monoid.value for c in lays[1].f.calls
                if c.elem.is_reduction] == ["max", "sum"]
    if name == "FUSED_ADAMW":
        # one streaming pass: four maps, three outputs
        assert len(lays) == 1 and lays[0].n_phases == 1
        assert [lays[0].out_mode[v] for v in lays[0].outputs] == ["map"] * 3
    if n == 4096:
        want = {
            "LM_RMSNORM": [((0, 1, 2), (128,))],
            "LM_BLOCK": [((0, 1, 2), (128,)), ((3,), (4096, 128)),
                         ((4,), (128,))],
            "LM_DECODE_ATTN": [((0,), (4096, 8)), ((1, 2, 3, 4, 5), (128,)),
                               ((6,), (48, 8))],
            "FUSED_ADAMW": [((0, 1, 2, 3), (128,))]}[name]
        assert [(gp.call_indices, gp.blocks)
                for gp in best.plan.groups] == want


@pytest.mark.parametrize("mode", ["best", "unfused"])
@pytest.mark.parametrize("name", NAMES)
def test_backends_match_jnp_and_numpy(name, mode):
    n = 256
    prog, ref_prog = MODELS[name], REF_MODELS[name]
    env = make_inputs(prog, n, seed=11)
    want = _tuple(prog.reference(**{k: np.asarray(v, np.float64)
                                    for k, v in env.items()}))
    jnp_out = _tuple(RefCompiler(backend="jnp", cache=RefPlanCache()).compile(
        ref_prog.script, ref_prog.shapes(n), mode=mode)(**env))
    for backend in ("torch", "cuda"):
        got = _tuple(FusionCompiler(backend=backend, device="cpu",
                                    cache=PlanCache()).compile(
            prog.script, prog.shapes(n), mode=mode)(**env))
        assert len(got) == len(want) == len(jnp_out)
        for o, j, r in zip(got, jnp_out, want):
            assert tuple(o.shape) == np.shape(r)
            np.testing.assert_allclose(o.numpy(), np.asarray(j),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=ATOL)


def _group_inputs(f, seed):
    rng = np.random.default_rng(seed)
    out = []
    for v in f.external_inputs:
        if v.shape == ():
            out.append(np.float32(rng.uniform(0.5, 1.5)))
        else:
            out.append(rng.standard_normal(v.shape).astype(np.float32))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_tiled_reference_matches_pallas_interpret(name):
    n = 256
    rg = ref_trace(REF_MODELS[name].script, REF_MODELS[name].shapes(n))
    g = trace(MODELS[name].script, MODELS[name].shapes(n))
    seen, checked = set(), 0
    for combo in ref_enumerate_combinations(ref_build_space(rg), limit=12):
        rplan = ref_build_plan(rg, combo, backend="pallas")
        pplan = plan_from_reference(rplan.to_json())
        for gp, ri, pi in zip(rplan.groups, rplan.bind(rg, REF_V5E),
                              pplan.bind(g, V5E)):
            key = (gp.call_indices, gp.order_pos, gp.blocks)
            if key in seen:
                continue
            seen.add(key)
            arrs = _group_inputs(pi.fusion, seed=len(seen))
            want = ref_codegen._group_pallas_fn(rg, ri, interpret=True)(
                *[jnp.asarray(x) for x in arrs])
            got = tiled_reference(g, pi, *[torch.from_numpy(np.asarray(x))
                                           for x in arrs])
            assert len(got) == len(want)
            for o, w in zip(got, want):
                assert tuple(o.shape) == tuple(np.shape(w))
                np.testing.assert_allclose(o.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)
            checked += 1
    assert checked >= 2


_FLOAT_SUFFIX = re.compile(r"(\d(?:\.\d*)?(?:e[-+]?\d+)?)f\b")
_CUDA_MATH = {"rsqrtf": torch.rsqrt, "expf": torch.exp, "sqrtf": torch.sqrt}
LM_ELEMENTARIES = [model_lib.rms_scale, core_elem.exp_map,
                   core_elem.rsqrt_map, core_elem.exp_sub, model_lib.div_by,
                   model_lib.attn_score, model_lib.attn_out,
                   model_lib.ema_pm, model_lib.ema_sq_pm, optim_fused.ema,
                   optim_fused.ema_sq, optim_fused.adam_dir,
                   optim_fused.apply_lr]


def test_model_lib_holds_the_reference_elementaries():
    from repro.programs import model_lib as ref_model_lib
    assert sorted(model_lib.ALL) == sorted(ref_model_lib.ALL)
    for name, e in model_lib.ALL.items():
        r = ref_model_lib.ALL[name]
        assert (e.kind.value, [a.axes for a in e.in_specs], e.out_axes,
                e.monoid.value, e.flops_per_point) == (
            r.kind.value, [a.axes for a in r.in_specs], r.out_axes,
            r.monoid.value, r.flops_per_point)
        assert e.cuda, name
    assert model_lib.adam_dir is optim_fused.adam_dir
    assert model_lib.apply_lr is optim_fused.apply_lr


@pytest.mark.parametrize("elem", LM_ELEMENTARIES, ids=lambda e: e.name)
def test_cuda_expression_matches_torch_fn(elem):
    """The per-point CUDA expression, evaluated over the iteration space
    with the CUDA math functions as their torch counterparts, equals the
    elementary's torch ``fn``; for a contraction, the sum of its terms
    over the reduce axis does."""
    rng = np.random.default_rng(0)
    sizes = (5, 7)[:elem.depth]
    args, points = [], []
    for spec in elem.in_specs:
        shape = tuple(sizes[a] for a in spec.axes)
        # positive values: rsqrt's argument and rms_scale's sum of squares
        x = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        args.append(x)
        # the argument at every point of the iteration space
        view = [1] * elem.depth
        for a, n in zip(spec.axes, shape):
            view[a] = n
        points.append(x.reshape(view) if spec.axes else x)
    env = {f"a{k}": a for k, a in enumerate(points)}
    expr = _FLOAT_SUFFIX.sub(r"\1", elem.cuda_expr(*env))
    got = eval(expr, dict(_CUDA_MATH), env).expand(sizes)  # noqa: S307
    if elem.is_reduction:
        got = elem.monoid.reduce(got, dims=elem.reduce_axes)
    want = elem.fn(*args)
    torch.testing.assert_close(got, want.expand(got.shape), rtol=1e-6,
                               atol=1e-6)
