"""The port's kernels on the card: K1's generated kernels against their
plain tiled version, and K2-K7 through ``ops`` against ``kernels.ref``.

This file imports neither JAX nor the reference package, so it runs on
a machine with an NVIDIA GPU and the CUDA toolkit alone:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -q

Every test carries the ``gpu`` marker and skips without a CUDA device.
Tolerance: float32 sums run in another order, so K1's groups are held to
the reference envelope (rtol 1e-4, atol 1e-3) at n = 256, K1's groups
whose reduce axes are cut into slices (sums of up to 2**20 terms) to a
norm-relative error of 1e-4 and to bitwise-equal repeats, and the hand
kernels at (1000, 1531) — dot products of 1531 terms, where a few
outputs near zero lose their relative digits to cancellation — to a
norm-relative error of 1e-4, as ``chip_smoke.py`` holds them.  The
bfloat16 outputs of K5-K7 are held to 1e-3 against their plain versions
(both accumulate in float32 and round once).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FusionCompiler, PlanCache, tiled_reference
from repro_torch.kernels._launch import LAUNCHES
from repro_torch.kernels import adamw as k6
from repro_torch.kernels import decode_attention as k5
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as k4
from repro_torch.kernels import softmax_xent as k7
from repro_torch.optim import fused_adamw_update
from repro_torch.programs import REGISTRY, make_inputs

N = 256
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ATAX", "BiCGK", "GEMVER", "AXPYDOT",
                                  "LM_RMSNORM", "LM_BLOCK", "LM_DECODE_ATTN",
                                  "FUSED_ADAMW"])
def test_kernels_match_tiled_reference_on_gpu(name, cuda):
    prog = REGISTRY[name]
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    for mode in ("best", "unfused"):
        cp = cc.compile(prog.script, prog.shapes(N), mode=mode)
        vals = dict(zip(cp.plan.input_names,
                        cp.prepare(**make_inputs(prog, N, seed=4))))
        outs = []
        for gp, fn, im in zip(cp.plan.groups, cp.group_fns, cp.group_impls):
            args = [vals[r[1]] if r[0] == "input" else outs[r[1]][r[2]]
                    for r in gp.inputs]
            got = fn.launch(*args)
            want = tiled_reference(cp.graph, im, *args)
            for o, w in zip(got, want):
                torch.testing.assert_close(o, w, rtol=RTOL, atol=ATOL)
            outs.append(want)


#: sizes at which K1 cuts reduce axes into slices; 3000, 1_000_003 and
#: 100_003 do not divide into the slices (nor 3000 into lane chunks)
SPLIT_CASES = [("AXPYDOT", 1 << 20), ("AXPYDOT", 1_000_003),
               ("BiCGK", 3000), ("SGEMVT", 3000), ("ATAX", 3000),
               ("GEMVER", 2048), ("LM_DECODE_ATTN", 131072),
               ("LM_DECODE_ATTN", 100_003)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", SPLIT_CASES)
def test_split_groups_match_tiled_reference_and_repeat_bitwise(name, n,
                                                               cuda):
    prog = REGISTRY[name]
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    split = 0
    for mode in ("best", "unfused"):
        cp = cc.compile(prog.script, prog.shapes(n), mode=mode)
        vals = dict(zip(cp.plan.input_names,
                        cp.prepare(**make_inputs(prog, n, seed=8))))
        outs = []
        for gp, fn, im in zip(cp.plan.groups, cp.group_fns, cp.group_impls):
            args = [vals[r[1]] if r[0] == "input" else outs[r[1]][r[2]]
                    for r in gp.inputs]
            want = tiled_reference(cp.graph, im, *args)
            if any(ph.S > 1 for ph in fn.layout.phases):
                split += 1
                got, again = fn.launch(*args), fn.launch(*args)
                for o, a, w in zip(got, again, want):
                    assert _rel(o, w) <= RTOL, fn.name
                    assert torch.equal(o.view(torch.int32),
                                       a.view(torch.int32)), fn.name
            outs.append(want)
    assert split, f"{name} at n={n}: no group cut into slices"


@pytest.mark.gpu
def test_ops_on_cuda_launch_the_kernels_and_match_ref(monkeypatch, cuda):
    rng = np.random.default_rng(5)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).cuda()
    m, n = 1000, 1531
    A = randn(m, n)
    vm = [randn(m) for _ in range(3)]
    vn = [randn(n) for _ in range(3)]
    x, g = randn(7, 33), randn(33)
    args = (A, vm[0], vn[0], vm[1], vn[1], vm[2], vn[2])
    want = (ref.bicgk(A, vn[0], vm[0]) + ref.gemver(*args, 1.3, 0.7)
            + (ref.rmsnorm(x, g),))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("rmsnorm", "bicgk", "gemver", "gemver_k1", "gemver_k2"):
        monkeypatch.setattr(ref, fn, plain)
    LAUNCHES.reset()
    got = (ops.bicgk(A, vn[0], vm[0]) + ops.gemver(*args, 1.3, 0.7)
           + (ops.rmsnorm(x, g),))
    torch.cuda.synchronize()
    assert dict(LAUNCHES.by_kernel) == {
        "K2/bicgk": 1, "K3/gemver_k1": 1, "K3/gemver_k2": 1,
        "K4/rmsnorm_f32": 1}
    for o, w in zip(got, want):
        assert o.shape == w.shape and o.dtype == w.dtype
        err = float((o.double() - w.double()).norm() / w.double().norm())
        assert err <= RTOL, err


def _rel(got, want) -> float:
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm())


def _randn(rng, *shape, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).cuda().to(dtype)


#: K5's shapes (B, Hq, Hkv, S, d): one KV head, odd S and d, a d of 256,
#: and the head layouts of the repository's configs: granite_34b's MQA
#: (G = 48, d = 128, six head groups a KV head), hymba_1p5b's G = 5 and
#: d = 64, and LM_DECODE_ATTN's one head of d = 48 over a 128k context
#: (some 256 chunks for the combine to fold)
K5_SHAPES = [(1, 4, 4, 256, 128), (2, 16, 1, 256, 128), (3, 12, 4, 1000, 80),
             (1, 1, 1, 4099, 48), (2, 8, 2, 70, 256), (1, 48, 1, 1000, 128),
             (2, 25, 5, 777, 64), (1, 1, 1, 131072, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", K5_SHAPES)
def test_decode_attention_kernels_match_ref_on_gpu(B, Hq, Hkv, S, d, dtype,
                                                   cuda):
    rng = np.random.default_rng(S + d)
    q = _randn(rng, B, Hq, d, dtype=dtype, scale=0.5)
    k = _randn(rng, B, S, Hkv, d, dtype=dtype, scale=0.2)
    v = _randn(rng, B, S, Hkv, d, dtype=dtype)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    acc, m, l, length = k5.split(q, k, v)
    want = ref.decode_attention_split(q, k, v, length)
    for got, w in zip((acc, m, l), want):
        assert got.shape == w.shape
        assert _rel(got, w) <= 1e-4
    o = k5.combine(acc, m, l, B, Hq, dtype)
    assert _rel(o, ref.decode_attention_combine(acc, m, l, B, Hq, dtype)) \
        <= tol
    got = k5.decode_attention(q, k, v)
    assert got.dtype == dtype and got.shape == (B, Hq, d)
    assert _rel(got, ref.decode_attention(q, k, v)) <= tol
    cfg = k5.config(Hq // Hkv, d, dtype, q.device)
    assert (acc.shape[0] // (B * Hkv), length) == k5.chunk_plan(
        k5.ctas_per_chunk(B, Hkv, cfg), S, cfg["ctas_per_sm"] * cfg["sms"],
        cfg["tile"])
    assert length % cfg["tile"] == 0


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(8, 32, 8, 2048, 128),
                                          (1, 1, 1, 131072, 48),
                                          (1, 48, 1, 1000, 128)])
def test_decode_attention_repeats_bitwise(B, Hq, Hkv, S, d, dtype, cuda):
    """A second launch of split + combine gives the same bits (no
    atomics; every sum in a fixed order)."""
    rng = np.random.default_rng(B + S)
    q = _randn(rng, B, Hq, d, dtype=dtype, scale=0.5)
    k = _randn(rng, B, S, Hkv, d, dtype=dtype, scale=0.2)
    v = _randn(rng, B, S, Hkv, d, dtype=dtype)
    first = k5.split(q, k, v)
    again = k5.split(q, k, v)
    for a, b in zip(first[:3], again[:3]):
        assert torch.equal(_bits(a), _bits(b))
    o1 = k5.combine(*first[:3], B, Hq, dtype)
    o2 = k5.combine(*again[:3], B, Hq, dtype)
    assert torch.equal(_bits(o1), _bits(o2))


@pytest.mark.gpu
def test_decode_attention_unaligned_views_take_the_element_path(cuda):
    """K and V at an offset of one element are not 16-byte aligned: the
    split takes its element-by-element instance, with the same result."""
    rng = np.random.default_rng(11)
    B, Hq, Hkv, S, d = 2, 8, 2, 300, 64
    q = _randn(rng, B, Hq, d)
    flat = _randn(rng, 2 * B * S * Hkv * d + 1)
    k = flat[1:1 + B * S * Hkv * d].view(B, S, Hkv, d)
    v = flat[1 + B * S * Hkv * d:].view(B, S, Hkv, d)
    assert k.data_ptr() % 16 and k.is_contiguous()
    acc, m, l, length = k5.split(q, k, v)
    for got, w in zip((acc, m, l), ref.decode_attention_split(q, k, v,
                                                              length)):
        assert _rel(got, w) <= 1e-4
    assert _rel(k5.decode_attention(q, k, v),
                ref.decode_attention(q, k, v)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,dtype,path", [
    (64, 4096, torch.float32, "registers"),
    (64, 4096, torch.bfloat16, "registers"),
    (3, 20000, torch.bfloat16, "general_packs"),
    (5, 33, torch.float32, "general_elements"),
    (5, 33, torch.bfloat16, "general_elements"),
    (2, 8, torch.float32, "registers"),
    (2, 8, torch.bfloat16, "registers"),
    (7, 1000, torch.bfloat16, "registers")])
def test_rmsnorm_kernel_paths_match_ref_and_repeat_bitwise(T, D, dtype,
                                                           path, cuda):
    """K4 on its register path (rows of up to 1024 packs) and its general
    path (a row longer than that, an odd D), against its plain version,
    and bitwise equal on a second launch."""
    rng = np.random.default_rng(T * D)
    x, g = _randn(rng, T, D, dtype=dtype), _randn(rng, D)
    assert k4.plan(D, dtype, x.device)["path"] == path
    got = k4.rmsnorm(x, g)
    assert got.dtype == dtype and got.shape == (T, D)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    assert _rel(got, ref.rmsnorm(x, g)) <= tol
    assert torch.equal(_bits(got), _bits(k4.rmsnorm(x, g)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_unaligned_view_matches_ref(dtype, cuda):
    """Rows at an offset of one element take the general element path;
    an unaligned gamma is copied to an aligned one."""
    rng = np.random.default_rng(12)
    T, D = 9, 4096
    flat = _randn(rng, T * D + 1, dtype=dtype)
    x = flat[1:].view(T, D)
    gflat = _randn(rng, D + 1)
    g = gflat[1:]
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    assert k4.plan(D, dtype, x.device, aligned=False)["path"] == \
        "general_elements"
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    assert _rel(k4.rmsnorm(x, g), ref.rmsnorm(x, g)) <= tol
    assert _rel(k4.rmsnorm(x.clone(), g), ref.rmsnorm(x, g)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 1024, 1_000_003])
@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
def test_adamw_kernel_matches_ref_on_gpu(n, pdt, cuda):
    rng = np.random.default_rng(n)
    p, g = _randn(rng, n, dtype=pdt), _randn(rng, n, dtype=pdt)
    m, v = _randn(rng, n) * 0.1, _randn(rng, n).abs() * 0.01
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)
    tol = 1e-3 if pdt == torch.bfloat16 else 1e-4
    for step in (3, torch.tensor(7, device="cuda")):
        for lr in (kw["lr"], torch.tensor(kw["lr"], device="cuda")):
            args = {**kw, "lr": lr, "step": step}
            got = k6.adamw_update(p, g, m, v, **args)
            want = ref.adamw(p, g, m, v, **args)
            for o, w in zip(got, want):
                assert o.dtype == w.dtype and o.shape == w.shape
                assert _rel(o, w) <= tol
    # an offset view takes the element-by-element path
    got = k6.adamw_update(p[1:], g[1:], m[1:], v[1:], step=2, **kw)
    want = ref.adamw(p[1:], g[1:], m[1:], v[1:], step=2, **kw)
    for o, w in zip(got, want):
        assert _rel(o, w) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("T,V", [(7, 1000), (33, 50257), (64, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ldt", [torch.int32, torch.int64])
def test_softmax_xent_kernel_matches_ref_on_gpu(T, V, dtype, ldt, cuda):
    rng = np.random.default_rng(T + V)
    logits = _randn(rng, T, V, dtype=dtype, scale=3.0)
    labels = torch.from_numpy(rng.integers(0, V, T)).cuda().to(ldt)
    rows = k7.softmax_xent_rows(logits, labels)
    assert rows.dtype == torch.float32 and rows.shape == (T,)
    assert _rel(rows, ref.softmax_xent_rows(logits, labels)) <= 1e-5
    mean = k7.softmax_xent(logits, labels)
    want = ref.softmax_xent(logits, labels)
    assert abs(float(mean) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.gpu
def test_ops_k5_k7_launch_their_kernels(monkeypatch, cuda):
    rng = np.random.default_rng(6)
    q, k, v = (_randn(rng, 2, 8, 48), _randn(rng, 2, 300, 2, 48),
               _randn(rng, 2, 300, 2, 48))
    p, g, m = _randn(rng, 5, 7), _randn(rng, 5, 7), _randn(rng, 5, 7)
    vv = m.abs()
    lg, lb = _randn(rng, 9, 100), torch.arange(9, device="cuda")
    want = (ref.decode_attention(q, k, v),
            *ref.adamw(p, g, m, vv, lr=1e-3, beta1=0.9, beta2=0.95,
                       eps=1e-8, weight_decay=0.0, step=1),
            ref.softmax_xent(lg, lb))

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("decode_attention", "adamw", "softmax_xent",
               "softmax_xent_rows"):
        monkeypatch.setattr(ref, fn, plain)
    LAUNCHES.reset()
    got = (ops.decode_attention(q, k, v),
           *ops.adamw_update(p, g, m, vv, lr=1e-3),
           ops.softmax_xent(lg, lb))
    torch.cuda.synchronize()
    assert dict(LAUNCHES.by_kernel) == {
        "K5/split_f32": 1, "K5/combine_f32": 1, "K6/adamw_f32": 1,
        "K7/xent_f32": 1}
    for o, w in zip(got, want):
        assert o.shape == w.shape and o.dtype == w.dtype
        assert _rel(o, w) <= RTOL
    with pytest.raises(ValueError, match="multiple"):
        ops.decode_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="2-D"):
        ops.softmax_xent(lg[None], lb[None])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["best", "unfused"])
def test_fused_adamw_update_on_gpu_matches_ref(mode, cuda):
    rng = np.random.default_rng(7)
    n = 4096
    p, g = _randn(rng, n), _randn(rng, n)
    m, v = torch.zeros(n, device="cuda"), torch.full((n,), 0.05,
                                                     device="cuda")
    kw = dict(lr=2e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              step=7)
    LAUNCHES.reset()
    got = fused_adamw_update(p, g, m, v, mode=mode, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES.total == (1 if mode == "best" else 4)
    for o, w in zip(got, ref.adamw(p, g, m, v, **kw)):
        assert _rel(o, w) <= RTOL
