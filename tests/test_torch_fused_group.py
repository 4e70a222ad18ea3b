"""Kernel K1 of the port: the generated-CUDA fused-group kernel.

A CUDA kernel cannot run on the CPU, so this file holds what surrounds
it to the reference:

* K1's plain tiled version (``tiled_reference``, what the ``cuda``
  backend runs for CPU tensors and what the kernel is compared with on
  the card) against the JAX reference's Pallas kernel
  ``_group_pallas_fn`` in interpret mode, as ``tests/test_backend_diff.py``
  runs it: every BLAS program x its enumerated combinations at n = 256
  (grids of more than one tile), plus hand-built impls covering an
  ``acc`` reduce loop over several tiles, ``partial`` outputs with more
  than one lead tile, and two-phase groups (ATAX's, and the
  SGEMVT-/GEMVER-shaped ``A (A^T y)`` chains);
* the generator: it emits every impl the scheduler enumerates for all
  15 programs, gives the same source for the same plan, and refuses
  non-float32 groups with RPL214;
* each elementary's per-point CUDA expression against its torch ``fn``;
* no hidden fallback: a non-CPU tensor never reaches the plain version,
  and a failed build or launch raises.

Tolerance: the reference envelope, rtol 1e-4, atol 1e-3.  The kernels'
own test on the card is in ``tests/test_torch_gpu.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.blas import elementary_lib as ref_lib
from repro.core import V5E as REF_V5E
from repro.core import build_space as ref_build_space
from repro.core import codegen as ref_codegen
from repro.core import trace as ref_trace
from repro.core.fusion import analyse_group as ref_analyse_group
from repro.core.plan import build_plan as ref_build_plan
from repro.core.predictor import cost_impl as ref_cost_impl
from repro.core.scheduler import \
    enumerate_combinations as ref_enumerate_combinations
from repro.programs import BLAS as REF_BLAS
from repro_torch.blas import elementary_lib as lib
from repro_torch.core import V5E, FusionCompiler, plan_from_reference, trace
from repro_torch.core import cuda_codegen
from repro_torch.core.cuda_codegen import (GroupKernel, PlanModule,
                                           group_source, plan_source,
                                           tiled_reference)
from repro_torch.core.diagnostics import UnsupportedGroupError
from repro_torch.core.fusion import analyse_group
from repro_torch.core.predictor import cost_impl
from repro_torch.core.scheduler import build_space
from repro_torch.kernels import _build, _launch
from repro_torch.programs import BLAS, REGISTRY, make_inputs

N = 256
#: enumerated combinations per program (groups deduplicated across them)
COMBO_LIMIT = 12
RTOL, ATOL = 1e-4, 1e-3


def _group_inputs(f, seed):
    rng = np.random.default_rng(seed)
    out = []
    for v in f.external_inputs:
        if v.shape == ():
            out.append(np.float32(rng.uniform(0.5, 1.5)))
        else:
            out.append(rng.standard_normal(v.shape).astype(np.float32))
    return out


def _check_group(rg, ri, g, pi, seed=0):
    arrs = _group_inputs(pi.fusion, seed)
    want = ref_codegen._group_pallas_fn(rg, ri, interpret=True)(
        *[jnp.asarray(x) for x in arrs])
    got = tiled_reference(g, pi, *[torch.from_numpy(np.asarray(x))
                                   for x in arrs])
    assert len(got) == len(want)
    for o, w in zip(got, want):
        assert tuple(o.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(o.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def _enumerated_pairs(name, n=N, limit=COMBO_LIMIT):
    """(ref graph, ref impl, port graph, port impl) for every distinct
    group of the first ``limit`` combinations, paired through the plan
    JSON (the reference's plan, rebound in the port)."""
    rg = ref_trace(REF_BLAS[name].script, REF_BLAS[name].shapes(n))
    g = trace(BLAS[name].script, BLAS[name].shapes(n))
    seen, pairs = set(), []
    for combo in ref_enumerate_combinations(ref_build_space(rg), limit=limit):
        rplan = ref_build_plan(rg, combo, backend="pallas")
        pplan = plan_from_reference(rplan.to_json())
        for gp, ri, pi in zip(rplan.groups, rplan.bind(rg, REF_V5E),
                              pplan.bind(g, V5E)):
            key = (gp.call_indices, gp.order_pos, gp.blocks)
            if key not in seen:
                seen.add(key)
                pairs.append((rg, ri, g, pi))
    return pairs


@pytest.mark.parametrize("name", sorted(BLAS))
def test_tiled_reference_matches_pallas_interpret(name):
    pairs = _enumerated_pairs(name)
    assert pairs
    assert any(pi.grid != (1,) * len(pi.grid) for *_, pi in pairs), \
        f"{name}: no group with more than one tile at n={N}"
    for k, (rg, ri, g, pi) in enumerate(pairs):
        _check_group(rg, ri, g, pi, seed=k)


# ---------------------------------------------------------------------------
# hand-built impls
# ---------------------------------------------------------------------------

def _sgemvt_shaped(L):
    def script(g, A, y):
        t = g.apply(L.gemtv_t, A, y, name="t")
        return (g.apply(L.gemv_t, A, t, name="w"),)
    return script


def _gemver_shaped(L):
    def script(g, A, u1, v1, u2, v2, y):
        B = g.apply(L.rank2_update, A, u1, v1, u2, v2, name="B")
        t = g.apply(L.gemtv_t, B, y, name="t")
        return B, g.apply(L.gemv_t, B, t, name="w")
    return script


def _shapes(names_matrix, names_vector, n=N):
    return {**{k: (n, n) for k in names_matrix},
            **{k: (n,) for k in names_vector}}


HAND = {
    # gemv alone, j innermost with 2 tiles: an acc loop over several tiles
    "acc_loop": (lambda L: REF_BLAS["SGEMV"].script if L is ref_lib
                 else BLAS["SGEMV"].script,
                 BLAS["SGEMV"].shapes(N), (0,), (0, 1), (8, 128)),
    # BiCGK with j outer in 2 tiles: gemv's q is partial with lead 2
    "partial_lead": (lambda L: REF_BLAS["BiCGK"].script if L is ref_lib
                     else BLAS["BiCGK"].script,
                     BLAS["BiCGK"].shapes(N), (0, 1), (1, 0), (128, 8)),
    # ATAX two-phase: t accumulates over 2 tiles, y partial with lead 32
    "atax_two_phase": (lambda L: REF_BLAS["ATAX"].script if L is ref_lib
                       else BLAS["ATAX"].script,
                       BLAS["ATAX"].shapes(N), (0, 1), (0, 1), (8, 128)),
    # A (A^T y): gemtv consumed by gemv, i innermost
    "sgemvt_two_phase": (_sgemvt_shaped, _shapes("A", "y"), (0, 1), (1, 0),
                         (128, 8)),
    # B = A + rank-2; w = B (B^T y): a map recomputed in phase 1
    "gemver_two_phase": (_gemver_shaped,
                         _shapes("A", ("u1", "v1", "u2", "v2", "y")),
                         (0, 1, 2), (1, 0), (128, 8)),
}


def _hand_pair(case):
    make, shapes, calls, order_pos, blocks = HAND[case]
    out = []
    for L, tr, analyse, cost, hw in (
            (ref_lib, ref_trace, ref_analyse_group, ref_cost_impl, REF_V5E),
            (lib, trace, analyse_group, cost_impl, V5E)):
        g = tr(make(L), shapes)
        f = analyse(g, [g.calls[i] for i in calls])
        assert f is not None
        order = tuple(f.axis_roots[p] for p in order_pos)
        out += [g, cost(f, g, order, blocks, hw)]
    return out


@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_built_impls_match_pallas_interpret(case):
    rg, ri, g, pi = _hand_pair(case)
    layout = cuda_codegen.GroupLayout(g, pi)
    if case.endswith("two_phase"):
        assert layout.n_phases == 2
    if case == "acc_loop":
        assert pi.grid[-1] > 1
    if case in ("partial_lead", "atax_two_phase"):
        assert any(layout.out_mode[v] == "partial"
                   and np.prod(layout.lead_shape(v)) > 1
                   for v in layout.outputs)
    group_source(g, pi, "k1_test")           # the generator emits it
    _check_group(rg, ri, g, pi, seed=1)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [N, 4096])
def test_generator_emits_every_enumerated_impl(n):
    """Every impl of every program emits (none is refused, with reduce
    axes cut into slices or not), with one grid barrier per phase
    boundary and one per phase whose reduce axes are cut."""
    emitted = 0
    for name in sorted(REGISTRY):
        g = trace(REGISTRY[name].script, REGISTRY[name].shapes(n))
        space = build_space(g)
        for f in space.fusions:
            for im in space.impls_by_fusion[f.key]:
                src = group_source(g, im, "k1_x")
                assert "k1_x_launch" in src
                lay = cuda_codegen.GroupLayout(g, im)
                cut = sum(ph.S > 1 for ph in lay.phases)
                assert src.count("k1::grid_barrier();") == \
                    lay.n_phases - 1 + cut
                assert ("cudaLaunchCooperativeKernel" in src) == \
                    lay.cooperative
                emitted += 1
    assert emitted >= 120


def test_same_plan_same_source():
    prog = BLAS["GEMVER"]
    srcs = []
    for _ in range(2):
        cp = FusionCompiler(backend="cuda", device="cpu", cache=None).compile(
            prog.script, prog.shapes(N))
        srcs.append(cp.module.source)
        assert plan_source(cp.graph, cp.group_impls) == cp.module.source
    assert srcs[0] == srcs[1]
    assert srcs[0].count("__global__") == 4


def test_non_float32_group_raises_coded_error():
    prog = BLAS["VADD"]
    cc = FusionCompiler(backend="cuda", device="cpu", cache=None,
                        dtype=np.float64)
    with pytest.raises(UnsupportedGroupError) as ei:
        cc.compile(prog.script, prog.shapes(N))
    assert ei.value.codes == ("RPL214",)
    assert "float32" in str(ei.value)


def test_bad_order_raises_rpl214():
    """ATAX's consuming group with j (gemv's reduce axis) outermost: no
    phase can finish the reduction, as in the reference."""
    g = trace(BLAS["ATAX"].script, BLAS["ATAX"].shapes(N))
    f = analyse_group(g, g.calls)
    im = cost_impl(f, g, tuple(reversed(f.axis_roots)), (128, 128), V5E)
    with pytest.raises(UnsupportedGroupError, match=r"gemv\+gemtv") as ei:
        cuda_codegen.GroupLayout(g, im)
    assert ei.value.codes == ("RPL214",)


@pytest.mark.parametrize("name", sorted(lib.ALL))
def test_cuda_expression_matches_torch_fn(name):
    """Each elementary's per-point CUDA expression, evaluated over the
    iteration space (it only uses + - * and names), equals its torch
    ``fn``; for reductions the monoid combines the points' terms."""
    e = lib.ALL[name]
    sizes = (5, 7)[:e.depth]
    rng = np.random.default_rng(0)
    args, points = [], []
    for spec in e.in_specs:
        shape = tuple(sizes[a] for a in spec.axes)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        args.append(x)
        view = [1] * e.depth
        for a, s in zip(spec.axes, shape):
            view[a] = s
        points.append(x.reshape(view) if shape else x)
    env = {f"a{k}": p for k, p in enumerate(points)}
    per_point = eval(e.cuda_expr(*env), {}, env)  # noqa: S307 — + - * only
    per_point = per_point.expand(sizes)
    want = e.fn(*args)
    got = e.monoid.reduce(per_point, dims=e.reduce_axes)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# no hidden fallback
# ---------------------------------------------------------------------------

def _kernel(name="BiCGK"):
    prog = BLAS[name]
    cp = FusionCompiler(backend="cuda", device="cpu", cache=None).compile(
        prog.script, prog.shapes(N))
    kernel = cp.group_fns[0]
    meta = [torch.empty(v.shape, device="meta")
            for v in kernel.layout.f.external_inputs]
    return cp, kernel, meta


def _forbid_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")
    monkeypatch.setattr(cuda_codegen, "tiled_reference", plain)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    _, kernel, meta = _kernel()
    _forbid_plain(monkeypatch)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel(*meta)
    mixed = [torch.zeros(v.shape) for v in kernel.layout.f.external_inputs]
    mixed[0] = meta[0]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kernel(*mixed)
    for fn in (GroupKernel.launch, GroupKernel._launch, GroupKernel._check,
               GroupKernel.buffers, GroupKernel.launch_into):
        assert "tiled_reference" not in inspect.getsource(fn)


def test_build_failure_raises(monkeypatch, tmp_path):
    _, kernel, meta = _kernel()
    _forbid_plain(monkeypatch)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))

    def no_nvcc():
        raise _build.BuildError("nvcc not found")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    with pytest.raises(_build.BuildError):
        kernel._launch(meta)
    with pytest.raises(_build.BuildError):
        PlanModule(kernel.layout.g, [kernel.layout.impl]).build()


def test_nonzero_launch_status_raises(monkeypatch):
    _, kernel, meta = _kernel()
    _forbid_plain(monkeypatch)
    monkeypatch.setattr(kernel.module, "function",
                        lambda gi: (lambda *ptrs: 700))
    monkeypatch.setattr(_launch.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    before = _launch.LAUNCHES.by_kernel[kernel.name]
    with pytest.raises(_launch.CudaLaunchError, match="700"):
        kernel._launch(meta)
    assert _launch.LAUNCHES.by_kernel[kernel.name] == before + 1


def test_cpu_tensors_take_the_plain_version():
    cp, kernel, _ = _kernel("ATAX")
    env = make_inputs(BLAS["ATAX"], N, seed=2)
    before = _launch.LAUNCHES.total
    (y,) = (cp(**env),)
    np.testing.assert_allclose(y.numpy(), BLAS["ATAX"].reference(**env)[0],
                               rtol=RTOL, atol=ATOL)
    assert _launch.LAUNCHES.total == before
