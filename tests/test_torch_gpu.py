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


#: (B, Hq, Hkv, S, d, kv_len): Llama-3-8B's decode step for 8 sequences
#: at a 1024-token prompt and 32 generated, the cache at its full horizon
#: of 1056 rows, attended up to one row, the first step's 1025, an odd
#: 777 and all 1056; one whole 64-row tile; a single head over 4099 rows
KV_LEN_CASES = [(8, 32, 8, 1056, 128, 1), (8, 32, 8, 1056, 128, 1025),
                (8, 32, 8, 1056, 128, 777), (8, 32, 8, 1056, 128, 1056),
                (2, 8, 2, 256, 64, 64), (1, 1, 1, 4099, 48, 2049),
                # Grok-1's decode step (48 heads over 8, G = 6) at the
                # decode steps' mean KV length
                (8, 48, 8, 1056, 128, 1040),
                # LLaVA-NeXT-34B's (56 heads over 8, G = 7), Hymba-1.5B's
                # ring of 1024 slots after the wrap (G = 5, d 64) and
                # before it, Whisper-medium's self- and cross-attention
                # (G = 1, d 64; the cross K/V over all 1500 frames)
                (8, 56, 8, 1056, 128, 1040), (8, 25, 5, 1024, 64, 1024),
                (8, 25, 5, 1024, 64, 700), (8, 16, 16, 224, 64, 208),
                (8, 16, 16, 1500, 64, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,d,kv_len", KV_LEN_CASES)
def test_decode_attention_kv_len_matches_ref_on_gpu(B, Hq, Hkv, S, d, kv_len,
                                                    dtype, cuda):
    """K5 over the first ``kv_len`` rows of a longer cache against the
    plain version; the rows past ``kv_len`` hold NaN, so a kernel that
    read one would not be finite."""
    rng = np.random.default_rng(S + kv_len)
    q = _randn(rng, B, Hq, d, dtype=dtype, scale=0.5)
    k = _randn(rng, B, S, Hkv, d, dtype=dtype, scale=0.2)
    v = _randn(rng, B, S, Hkv, d, dtype=dtype)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    acc, m, l, length = k5.split(q, k, v, kv_len=kv_len)
    assert acc.shape[0] == B * Hkv * -(-kv_len // length)
    for got, w in zip((acc, m, l), ref.decode_attention_split(
            q, k, v, length, kv_len=kv_len)):
        assert _rel(got, w) <= 1e-4
    got = ops.decode_attention(q, k, v, kv_len)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, ref.decode_attention(q, k, v, kv_len=kv_len)) <= tol
    with pytest.raises(ValueError, match="kv_len"):
        ops.decode_attention(q, k, v, S + 1)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(8, 32, 8, 2048, 128),
                                          (1, 1, 1, 131072, 48),
                                          (1, 48, 1, 1000, 128),
                                          (8, 48, 8, 1056, 128)])
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
    (7, 1000, torch.bfloat16, "registers"),
    # qwen2_7b's rows (d_model 3584) at its decode and prefill
    (8, 3584, torch.bfloat16, "registers"),
    (8192, 3584, torch.bfloat16, "registers"),
    # DeepSeek-V2-Lite's (d_model 2048) and Grok-1's (6144)
    (8, 2048, torch.bfloat16, "registers"),
    (8192, 2048, torch.bfloat16, "registers"),
    (8, 6144, torch.bfloat16, "registers"),
    (8192, 6144, torch.bfloat16, "registers"),
    # LLaVA-NeXT-34B's d_model 7168, Mamba-2-2.7B's 2560 and its gated
    # norm's d_inner 5120, Hymba-1.5B's 1600 and its d_inner 3200
    *[(T, D, torch.bfloat16, "registers") for D in (7168, 5120, 2560, 3200,
                                                    1600) for T in (8, 8192)]])
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
@pytest.mark.parametrize("T,D,n", [(8, 5120, 2), (256, 5120, 2),
                                   (8, 5120, 4), (5, 1001, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_block_entry_matches_ref_and_whole_rows_on_gpu(T, D, n,
                                                               dtype, cuda):
    """K4's block entry (Mamba-2's gated norm over d_inner 5120, its rows
    cut into a rank's SSD heads' columns; an odd width takes the element
    path) on each block, a slice's copy: the sums of squares and the
    scaled block against their plain versions, bitwise on a second
    launch; the blocks' sums added and the blocks joined against the
    whole rows' K4."""
    rng = np.random.default_rng(T + D + n)
    x, g = _randn(rng, T, D, dtype=dtype), _randn(rng, D)
    cuts = [(int(b[0]), int(b[-1]) + 1)
            for b in torch.tensor_split(torch.arange(D), n)]
    blocks = [x[:, lo:hi].contiguous() for lo, hi in cuts]
    before = (LAUNCHES.by_kernel[k4.SUMSQ_NAMES[dtype]],
              LAUNCHES.by_kernel[k4.SCALE_NAMES[dtype]])
    sums = []
    for blk in blocks:
        ss = k4.rmsnorm_block_sumsq(blk)
        assert ss.dtype == torch.float32 and ss.shape == (T,)
        assert _rel(ss, ref.rmsnorm_block_sumsq(blk)) <= 1e-5
        assert torch.equal(ss, k4.rmsnorm_block_sumsq(blk))
        sums.append(ss)
    total = torch.stack(sums).sum(0)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    outs = []
    for blk, (lo, hi) in zip(blocks, cuts):
        got = k4.rmsnorm_block_scale(blk, total, g[lo:hi], D)
        assert got.dtype == dtype and got.shape == blk.shape
        assert _rel(got, ref.rmsnorm_block_scale(blk, total, g[lo:hi],
                                                 D)) <= tol
        assert torch.equal(_bits(got), _bits(k4.rmsnorm_block_scale(
            blk, total, g[lo:hi], D)))
        outs.append(got)
    assert (LAUNCHES.by_kernel[k4.SUMSQ_NAMES[dtype]],
            LAUNCHES.by_kernel[k4.SCALE_NAMES[dtype]]) == \
        (before[0] + 2 * n, before[1] + 2 * n)
    assert _rel(torch.cat(outs, 1), k4.rmsnorm(x, g)) <= tol


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
@pytest.mark.parametrize("n", [2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_xent_block_matches_ref_on_gpu(n, dtype, cuda):
    """K7's block entry on the columns of (64, 50257) logits cut into n
    blocks as ``torch.tensor_split`` cuts them (each read in place as a
    slice, and as a copy): the triple against its plain version, the
    blocks' triples combined against the whole rows' K7; labels of -1
    and outside the vocabulary read no column."""
    T, V = 64, 50257
    rng = np.random.default_rng(n)
    logits = _randn(rng, T, V, dtype=dtype, scale=3.0)
    labels = torch.from_numpy(rng.integers(0, V, T)).cuda()
    labels[::5] = -1
    labels[2::9] = V + 3
    before = LAUNCHES.by_kernel[k7.BLOCK_NAMES[dtype]]
    triples = []
    for b in torch.tensor_split(torch.arange(V), n):
        lo, hi = int(b[0]), int(b[-1]) + 1
        got = k7.softmax_xent_block(logits[:, lo:hi], labels, lo)
        want = ref.softmax_xent_block(logits[:, lo:hi], labels, lo)
        copy = k7.softmax_xent_block(logits[:, lo:hi].contiguous(),
                                     labels.int(), lo)
        for a, w, c in zip(got, want, copy):
            assert a.dtype == torch.float32 and a.shape == (T,)
            assert _rel(a, w) <= 1e-5 and torch.equal(a, c)
        triples.append(got)
    assert LAUNCHES.by_kernel[k7.BLOCK_NAMES[dtype]] == before + 2 * n
    rows = ref.combine_xent_blocks(triples)
    assert _rel(rows, k7.softmax_xent_rows(logits, labels)) <= 1e-5


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


# ---------------------------------------------------------------------------
# one CUDA graph per plan, batched and packed K1, float16, the engine
# ---------------------------------------------------------------------------

def _run_eager_then_graph(cp, ins):
    """(eager outputs, graph-replayed outputs) of one program on the same
    input tensors: the first call runs eagerly, the second captures and
    replays the plan's graph."""
    eager = tuple(o.clone() for o in cp.run(*ins))
    return eager, cp.run(*ins)


#: a cooperative multi-phase group (LM_DECODE_ATTN's softmax), groups cut
#: into slices (AXPYDOT at 2**20, BiCGK at 3000 with a ``partial``
#: output), and plain one-pass groups (GEMVER)
GRAPH_CASES = [("LM_DECODE_ATTN", 4096), ("AXPYDOT", 1 << 20),
               ("BiCGK", 3000), ("GEMVER", 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", GRAPH_CASES)
def test_graph_replay_is_bitwise_equal_to_eager(name, n, cuda):
    prog = REGISTRY[name]
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    coop = []
    for mode in ("best", "unfused"):
        cp = cc.compile(prog.script, prog.shapes(n), mode=mode)
        ins = cp.prepare(**make_inputs(prog, n, seed=3))
        eager, replayed = _run_eager_then_graph(cp, ins)
        assert cp.replays.n_captures == 1
        for a, b in zip(eager, replayed):
            assert torch.equal(_bits(a), _bits(b)), (name, mode)
        coop += [fn for fn in cp.group_fns if fn.layout.cooperative]
    assert coop or name == "GEMVER"


@pytest.mark.gpu
def test_held_results_are_not_overwritten_and_replays_count(cuda):
    prog = REGISTRY["GEMVER"]
    n = 512
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    cp = cc.compile(prog.script, prog.shapes(n), label="held")
    ins = cp.prepare(**make_inputs(prog, n, seed=1))
    cp.run(*ins)                                  # eager, builds
    first = cp.run(*ins)                          # captured, replayed
    kept = tuple(o.clone() for o in first)
    view = first[0][:7]                           # a view keeps it too
    del first
    # new values at the same addresses: the same graph, but a replay
    # into another slot while the caller holds the first result
    for t, x in zip(ins, cp.prepare(**make_inputs(prog, n, seed=2))):
        t.copy_(x)
    LAUNCHES.reset()
    second = cp.run(*ins)
    torch.cuda.synchronize()
    assert cp.replays.n_captures == 2
    assert torch.equal(view, kept[0][:7])
    assert not torch.equal(second[0][:7], view)
    assert dict(LAUNCHES.by_kernel) == {fn.name: 1 for fn in cp.group_fns}
    del view, second
    third = cp.run(*ins)                          # a free slot: no capture
    assert cp.replays.n_captures == 2
    assert LAUNCHES.total == 2 * cp.n_groups
    del third


#: programs whose batched launches are held bitwise to single ones: a
#: ``partial`` output and 2-D slices (BiCGK), slices (AXPYDOT), phases
#: (LM_DECODE_ATTN, LM_RMSNORM), several groups (GEMVER)
BATCH_CASES = [("BiCGK", 3000), ("AXPYDOT", 1 << 20), ("LM_DECODE_ATTN", 4096),
               ("LM_RMSNORM", 4096), ("GEMVER", 512), ("ATAX", 300)]


def _batch_inputs(prog, n, B, seed):
    per = [make_inputs(prog, n, seed=seed + b) for b in range(B)]
    return per, {k: np.stack([np.asarray(p[k]) for p in per])
                 for k in per[0]}


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", BATCH_CASES)
def test_batched_launches_equal_single_launches_bitwise(name, n, cuda):
    prog = REGISTRY[name]
    B = 5
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    for mode in ("best", "unfused"):
        single = cc.compile(prog.script, prog.shapes(n), mode=mode)
        batched = cc.compile_batched(prog.script, prog.shapes(n), mode=mode)
        per, stacked = _batch_inputs(prog, n, B, seed=20)
        ins = batched.prepare(**stacked)
        got = batched.run(*ins)                   # eager
        again = batched.run(*ins)                 # captured and replayed
        assert batched.replays.n_captures == 1
        for b in range(B):
            want = single.fn(*single.prepare(**per[b]))
            for o, a, w in zip(got, again, want):
                assert torch.equal(_bits(o[b]), _bits(w)), (name, mode, b)
                assert torch.equal(_bits(a[b]), _bits(w)), (name, mode, b)


@pytest.mark.gpu
def test_packed_dispatch_equals_its_members_bitwise(cuda):
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    members = [("GEMVER", 512), ("BiCGK", 3000), ("AXPYDOT", 1 << 20),
               ("LM_DECODE_ATTN", 4096)]
    pack = cc.compile_packed([(REGISTRY[s].script, REGISTRY[s].shapes(n))
                              for s, n in members])
    inputs = [{k: torch.from_numpy(v).cuda() for k, v in
               _batch_inputs(REGISTRY[s], n, 2 + k % 2, seed=30 + k)[1]
               .items()} for k, (s, n) in enumerate(members)]
    LAUNCHES.reset()
    first = pack(inputs)                          # eager
    again = pack(inputs)                          # the pack's graph
    torch.cuda.synchronize()
    n_groups = pack.program.n_groups
    assert LAUNCHES.total == 2 * n_groups
    assert pack.program.replays.n_captures == 1
    for (s, n), ins, outs, outs2 in zip(members, inputs, first, again):
        b = cc.compile_batched(REGISTRY[s].script, REGISTRY[s].shapes(n))
        want = b.fn(*b.prepare(**ins))
        for o, o2, w in zip(outs, outs2, want):
            assert torch.equal(_bits(o), _bits(w)), s
            assert torch.equal(_bits(o2), _bits(w)), s


def fp16_inputs(name, n, seed):
    """float16 inputs: ``make_inputs``, with GEMVER's A, u1, v1, u2 and v2
    scaled by n**-0.5 so that B = A + u1 v1ᵀ + u2 v2ᵀ has a norm of O(1)
    and w = α B x stays inside float16's ±65504 at every n (unscaled,
    (v1·x) grows as n and w overflows from n = 1024 on)."""
    env = make_inputs(REGISTRY[name], n, seed=seed, dtype=np.float32)
    if name == "GEMVER":
        for k in ("A", "u1", "v1", "u2", "v2"):
            env[k] = env[k] / np.float32(np.sqrt(n))
    return {k: np.asarray(v).astype(np.float16) for k, v in env.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", [("AXPYDOT", 4096), ("AXPYDOT", 1 << 20),
                                    ("GEMVER", 256), ("GEMVER", 1024),
                                    ("BiCGK", 3000)])
def test_float16_groups_match_their_plain_version(name, n, cuda):
    """float16 loads and stores, float32 maps and sums: held to 1e-2
    norm-relative against the plain version (which rounds every op to
    float16) and against float64 numpy."""
    prog = REGISTRY[name]
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache(),
                        dtype=np.float16)
    for mode in ("best", "unfused"):
        cp = cc.compile(prog.script, prog.shapes(n), mode=mode)
        env = fp16_inputs(name, n, seed=9)
        vals = dict(zip(cp.plan.input_names, cp.prepare(**env)))
        outs = []
        for gp, fn, im in zip(cp.plan.groups, cp.group_fns, cp.group_impls):
            args = [vals[r[1]] if r[0] == "input" else outs[r[1]][r[2]]
                    for r in gp.inputs]
            got = fn.launch(*args)
            want = tiled_reference(cp.graph, im, *args)
            for o, w in zip(got, want):
                assert o.dtype == torch.float16 and o.shape == w.shape
                assert _rel(o, w) <= 1e-2, fn.name
            outs.append(want)
        got = cp(**env)
        got = got if isinstance(got, tuple) else (got,)
        ref64 = prog.reference(**{k: np.asarray(v, np.float64)
                                  for k, v in env.items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        for o, r in zip(got, ref64):
            assert _rel(o, torch.from_numpy(np.asarray(r)).cuda()) <= 1e-2


@pytest.mark.gpu
def test_depth3_group_runs_as_one_kernel(cuda):
    from repro_torch.core.elementary import make_tensor_map
    t3 = make_tensor_map("mul3", lambda x, y: x * y,
                         in_axes=[(0, 1, 2), (0, 1, 2)], depth=3,
                         cuda="{0} * {1}")

    def script(g, a, b):
        t = g.apply(t3, a, b, name="t")
        return (g.apply(t3, t, a, name="o"),)
    shape = (6, 40, 300)
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    cp = cc.compile(script, {"a": shape, "b": shape})
    assert cp.n_groups == 1
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    got = cp(a=a, b=b)
    torch.testing.assert_close(got.cpu(), torch.from_numpy(a * b * a),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_engine_on_a_small_mixed_stream(cuda):
    from repro_torch.serving import ServingEngine
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    engine = ServingEngine(cc, max_batch=4, min_bucket=64, registry=REGISTRY,
                           max_pack=4)
    stream = [("GEMVER", 200), ("BiCGK", 300), ("AXPYDOT", 1000),
              ("LM_DECODE_ATTN", 900), ("GEMVER", 256), ("BiCGK", 500),
              ("AXPYDOT", 1024), ("LM_DECODE_ATTN", 1000)] * 2
    for s in sorted({s for s, _ in stream}):
        engine.warm(s, [n for t, n in stream if t == s], trace_packs=False)
    engine.warm_packs()
    reqs = [(s, n, make_inputs(REGISTRY[s], n, seed=40 + i))
            for i, (s, n) in enumerate(stream)]
    first = engine.serve(reqs)
    kept = [tuple(o.clone() for o in r.outputs) for r in first]
    second = engine.serve(reqs[::-1])            # while `first` is held
    for r, k in zip(first, kept):
        for o, c in zip(r.outputs, k):
            assert torch.equal(_bits(o), _bits(c))
    for res in (first, second):
        by_rid = {r.rid: r for r in res}
        assert len(by_rid) == len(stream)
    for r in first:
        s, n, env = reqs[r.rid]
        ref64 = REGISTRY[s].reference(**{k: np.asarray(v, np.float64)
                                         for k, v in env.items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        for o, w in zip(r.outputs, ref64):
            assert tuple(o.shape) == np.shape(w)
            assert _rel(o, torch.from_numpy(np.asarray(w)).cuda()) <= RTOL
    st = engine.stats()
    assert st["n_packed_dispatches"] >= 1
    assert st["n_dispatches"] < len(stream)


@pytest.mark.gpu
def test_engine_open_loop_keeps_one_graph_per_input_set(cuda):
    """Open loop, every drain's results kept to the end: the results are
    copies, so no drain finds its graph held, and no input set is
    captured twice however many drains the run takes."""
    from repro_torch.launch.serve import engine_stream
    from repro_torch.serving import ServingEngine
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    engine = ServingEngine(cc, max_batch=4, min_bucket=64, registry=REGISTRY,
                           max_pack=4)
    stream = engine_stream({"GEMVER": (200, 512), "AXPYDOT": (1000, 4096)},
                           96, seed=5)
    for s in ("AXPYDOT", "GEMVER"):
        engine.warm(s, [n for t, n in stream if t == s], trace_packs=False)
    engine.warm_packs()
    reqs = [(s, n, make_inputs(REGISTRY[s], n, seed=60 + i))
            for i, (s, n) in enumerate(stream)]
    b0 = engine._rid
    closed = {r.rid - b0: r for r in engine.serve(reqs)}
    b1, drains0 = engine._rid, engine.n_dispatches
    opened = engine.serve(reqs, rate_hz=3000.0)
    torch.cuda.synchronize()
    assert engine.n_dispatches - drains0 > 4
    st = engine.stats()
    assert st["graph_held_calls"] == 0 and st["graphs_per_input_set"] == 1
    assert len(opened) == len(reqs)
    for r in opened:
        for o, k in zip(r.outputs, closed[r.rid - b1].outputs):
            assert torch.equal(_bits(o), _bits(k))


# ---------------------------------------------------------------------------
# autotune and calibration on the card, and the verifier's RPL215
# ---------------------------------------------------------------------------

#: summed group times against the winner's whole-program replay, at the
#: widths the smoke run tunes at (A and the vectors beyond the 50 MB
#: L2): a plan replays its groups back to back in one graph, a group is
#: timed alone in a graph of its own launches, both by ``replay_s``, so
#: the two agree to within this share (both programs agree within 1 %
#: on an H100 80GB)
SUM_VS_REPLAY = 0.10


def _autotuned(name, n, budget=4):
    from repro_torch.core import autotune
    cache = PlanCache()
    cc = FusionCompiler(hw="calibrate", backend="cuda", device="cuda",
                        cache=cache, autotune_budget=budget)
    prog = REGISTRY[name]
    cp = cc.compile(prog.script, prog.shapes(n), mode="autotune")
    return cc, cp, cc.last_autotune, autotune


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["GEMVER", "BiCGK", "AXPYDOT", "LM_BLOCK"])
def test_autotune_on_gpu_matches_float64_and_warm_pass_measures_nothing(
        name, cuda):
    cc, cp, rep, _ = _autotuned(name, N)
    assert rep.n_groups_measured > 0 and rep.build_s >= 0
    assert rep.winner.t_meas <= rep.candidates[0].t_meas
    prog = REGISTRY[name]
    inputs = make_inputs(prog, N, seed=8)
    got = cp(**inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = prog.reference(**{k: np.asarray(v, np.float64)
                             for k, v in inputs.items()})
    want = want if isinstance(want, tuple) else (want,)
    for o, w in zip(got, want):
        assert _rel(o, torch.from_numpy(np.asarray(w)).cuda()) <= RTOL
    cc.search(cc.space(cp.graph), "autotune")
    warm = cc.last_autotune
    assert warm.n_groups_measured == 0
    assert warm.group_table_hit_rate == 1.0
    assert warm.winner_index == rep.winner_index


@pytest.mark.gpu
@pytest.mark.parametrize("name,n", [("GEMVER", 4096), ("AXPYDOT", 1 << 24)])
def test_summed_group_times_track_the_winners_replay(name, n, cuda):
    from repro_torch.core.timing import replay_s
    cc, cp, rep, _ = _autotuned(name, n)
    args = cp.prepare(**make_inputs(REGISTRY[name], n, seed=2))
    replay = replay_s(lambda: cp.fn(*args), inner=8, reps=5)
    assert abs(rep.winner.t_meas / replay - 1) <= SUM_VS_REPLAY


@pytest.mark.gpu
def test_replay_timer_refuses_an_empty_capture(cuda):
    """A capture with no device work, or without the kernel launches the
    caller expects, would time as ~0: ``replay_s`` raises instead."""
    from repro_torch.core.timing import EmptyCaptureError, replay_s
    x = torch.zeros(8, device="cuda")
    with pytest.raises(EmptyCaptureError):
        replay_s(lambda: None)
    with pytest.raises(EmptyCaptureError):
        replay_s(lambda: x.add_(1.0), inner=2, launches=2)
    assert replay_s(lambda: x.add_(1.0), inner=2) > 0


@pytest.mark.gpu
def test_calibration_on_gpu_is_finite_and_below_the_datasheet(cuda):
    from repro_torch.core import autotune
    hw = autotune.calibrate_hardware("cuda", cache=PlanCache(), force=True)
    for v in (hw.hbm_bw, hw.peak_flops, hw.launch_overhead_s):
        assert np.isfinite(v) and v > 0
    assert 1.5e12 <= hw.hbm_bw <= 3.35e12
    assert hw.launch_overhead_s < 20e-6


@pytest.mark.gpu
def test_smem_over_budget_group_gets_rpl215(cuda):
    from repro_torch.analysis import verify_plan
    from repro_torch.core import cuda_codegen
    prog = REGISTRY["GEMVER"]
    cp = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache()
                        ).compile(prog.script, prog.shapes(N))
    assert not [d for d in verify_plan(cp.plan, cp.graph) if d.is_error]
    need = max(cuda_codegen.smem_bytes(k.layout) for k in cp.group_fns)
    codes = {d.code for d in verify_plan(cp.plan, cp.graph,
                                         smem_budget=need - 1)}
    assert codes == {"RPL215"}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_v2_lite", "grok1_314b"])
def test_moe_decode_step_replays_as_one_cuda_graph_bitwise(arch, cuda):
    """An MoE model's decode step (smoke size, bfloat16) moves no value to
    the host, so it is captured as one CUDA graph; the replay's logits
    and cache rows equal the eager step's bitwise, and a second eager
    step repeats them."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import grow_cache, load_model
    from repro_torch.models import decode_step, prefill
    cfg = smoke_config(arch)
    model = load_model(cfg, 0, "cuda")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 33)),
                           dtype=torch.int32, device="cuda")
    _, cache = prefill(cfg, model, toks[:, :32])
    cache = grow_cache(cfg, cache, 40)
    eager, _ = decode_step(cfg, model, cache, toks[:, 32], 32)
    again, _ = decode_step(cfg, model, cache, toks[:, 32], 32)
    assert torch.equal(_bits(eager), _bits(again))
    rows = {k: t[:, :, 32].clone() for k, t in cache.items()}
    for t in cache.values():
        t[:, :, 32] = 0
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):         # warm-up off the capture
        decode_step(cfg, model, cache, toks[:, 32], 32)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed, _ = decode_step(cfg, model, cache, toks[:, 32], 32)
    for t in cache.values():
        t[:, :, 32] = 0
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(replayed), _bits(eager))
    for k, t in cache.items():
        assert torch.equal(_bits(t[:, :, 32]), _bits(rows[k]))


#: the last four families: each decode step's hand-kernel launches (K4 a
#: RMSNorm, K5's split and combine a GQA attention), as ``chip_smoke.py``
#: counts them at full width
FAMILY_ARCHS = ["llava_next_34b", "mamba2_2p7b", "hymba_1p5b",
                "whisper_medium"]


def _family_launches(cfg) -> dict:
    L = cfg.n_layers
    return {"llava_next_34b": {"K4/rmsnorm_bf16": 2 * L + 1,
                               "K5/split_bf16": L, "K5/combine_bf16": L},
            "mamba2_2p7b": {"K4/rmsnorm_bf16": 2 * L + 1},
            "hymba_1p5b": {"K4/rmsnorm_bf16": 5 * L + 1,
                           "K5/split_bf16": L, "K5/combine_bf16": L},
            "whisper_medium": {"K5/split_bf16": 2 * L,
                               "K5/combine_bf16": 2 * L}}[cfg.name[:-6]]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decode_on_the_card(arch, cuda):
    """Each family at its smoke size, bfloat16, B 8: a prefill of 32
    (hymba's window: the ring full), then 8 decode steps (past the wrap),
    each launching the family's K4 and K5 counts, repeated from the same
    cache bitwise (the SSD state restored first), and within 5e-2 of the
    forward over 40 tokens (the same patches or frames)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import draw_inputs, grow_cache, load_model
    from repro_torch.models import decode_step, forward_lm, prefill
    cfg = smoke_config(arch)
    P, steps = 32, 8
    model = load_model(cfg, 0, "cuda")
    x = draw_inputs(cfg, 8, P + steps, 0)
    toks = torch.as_tensor(x["prompts"], device="cuda")
    extra = {k: torch.as_tensor(x[k], device="cuda")
             for k in ("patches", "frames") if x[k] is not None}
    want = forward_lm(cfg, model, toks, **extra)[0].float()
    _, cache = prefill(cfg, model, toks[:, :P], **extra)
    cache = grow_cache(cfg, cache, P + steps)
    for i in range(steps):
        before = {k: t.clone() for k, t in cache.items()}
        LAUNCHES.reset()
        got, _ = decode_step(cfg, model, cache, toks[:, P + i], P + i)
        torch.cuda.synchronize()
        assert dict(LAUNCHES.by_kernel) == _family_launches(cfg), i
        after = {k: t.clone() for k, t in cache.items()}
        for k, t in cache.items():
            t.copy_(before[k])
        again, _ = decode_step(cfg, model, cache, toks[:, P + i], P + i)
        assert torch.equal(_bits(got), _bits(again)), i
        for k, t in cache.items():
            assert torch.equal(_bits(t), _bits(after[k])), (i, k)
        assert _rel(got, want[:, P + i]) <= 5e-2, i


#: K5 with ``kv_len`` in device memory (chunks planned for all S, the
#: ones past ``kv_len`` empty): (B, Hq, Hkv, S, d, kv_len) — Llama-3-8B's
#: step at the horizon 1056 after one row, mid-way and full; Hymba's ring;
#: Whisper's self-attention over 224 rows; one head over 4099 rows
DEVICE_KV_CASES = [(8, 32, 8, 1056, 128, 1), (8, 32, 8, 1056, 128, 300),
                   (8, 32, 8, 1056, 128, 1056), (8, 25, 5, 1024, 64, 130),
                   (8, 16, 16, 224, 64, 17), (1, 1, 1, 4099, 48, 2049)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,d,kv_len", DEVICE_KV_CASES)
def test_decode_attention_device_kv_len_on_gpu(B, Hq, Hkv, S, d, kv_len,
                                               dtype, cuda):
    """K5 reading ``kv_len`` from device memory: its split partials (the
    empty chunks m = -inf, l = 0, acc = 0) and its output against the
    plain versions, NaN rows past ``kv_len`` never read, a bitwise
    repeat, the same output as the host-integer ``kv_len`` within the
    tolerance, and one CUDA graph replayed at another ``kv_len``."""
    rng = np.random.default_rng(S + kv_len)
    q = _randn(rng, B, Hq, d, dtype=dtype, scale=0.5)
    k = _randn(rng, B, S, Hkv, d, dtype=dtype, scale=0.2)
    v = _randn(rng, B, S, Hkv, d, dtype=dtype)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-4
    kn, vn = k.clone(), v.clone()
    kn[:, kv_len:] = float("nan")
    vn[:, kv_len:] = float("nan")
    acc, m, l, length = k5.split(q, kn, vn, kv_len=kl)
    chunks = acc.shape[0] // (B * Hkv)
    assert chunks == -(-S // length)
    for got, w in zip((acc, m, l), ref.decode_attention_split(
            q, k, v, length, kv_len=kl)):
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(got), fin)
        assert torch.equal(got[~fin], w[~fin])
        assert _rel(got[fin], w[fin]) <= 1e-4
    got = ops.decode_attention(q, kn, vn, kl)
    again = ops.decode_attention(q, kn, vn, kl)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(_bits(got), _bits(again))
    assert _rel(got, ref.decode_attention(q, k, v, kv_len=kv_len)) <= tol
    assert _rel(got, ops.decode_attention(q, k, v, kv_len)) <= tol
    # one graph, two positions
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, kl)
    for n in (kv_len, max(1, kv_len // 2), S):
        kl.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert _rel(out, ref.decode_attention(q, k, v, kv_len=n)) <= tol, n


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen2_7b", "granite3_8b",
                                  "granite_34b", "deepseek_v2_lite",
                                  "grok1_314b", "llava_next_34b",
                                  "mamba2_2p7b", "hymba_1p5b",
                                  "whisper_medium"])
def test_generate_replays_one_graph_equal_to_eager(arch, cuda):
    """``generate`` at the smoke size, bfloat16, B 8: one capture, every
    later step replayed, the tokens and the cache equal to the eager
    path's (``graph=False``: the same kernels) bitwise, and each replay
    counting the step's kernels."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import draw_inputs, generate, load_model
    cfg = smoke_config(arch)
    model = load_model(cfg, 0, "cuda")
    x = draw_inputs(cfg, 8, 40, 0)
    kw = dict(patches=x["patches"], frames=x["frames"])
    eager = generate(cfg, model, x["prompts"], 12, graph=False, **kw)
    LAUNCHES.reset()
    replayed = generate(cfg, model, x["prompts"], 12, **kw)
    assert (eager["captures"], replayed["captures"]) == (0, 1)
    assert np.array_equal(replayed["tokens"], eager["tokens"])
    for k, t in replayed["cache"].items():
        assert torch.equal(_bits(t), _bits(eager["cache"][k])), k
    assert LAUNCHES.total > 0 or cfg.norm == "layernorm"


@pytest.mark.gpu
def test_k7_masked_labels_read_no_column_on_gpu(cuda):
    rng = np.random.default_rng(5)
    x = _randn(rng, 64, 1000, dtype=torch.bfloat16)
    labels = torch.as_tensor(rng.integers(-1, 1000, 64), device="cuda")
    labels[::7] = -1
    got = k7.softmax_xent_rows(x, labels)
    want = ref.softmax_xent_rows(x, labels)
    assert _rel(got, want) <= 1e-5
    lse = torch.logsumexp(x.float(), -1)
    assert _rel(got[labels < 0], lse[labels < 0]) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_train_steps_on_gpu(moments, cuda):
    """``launch.train``'s path at the smoke size on the card: K4 and K7
    on the forward (K4 again in the backward's recompute) and K6 once a
    leaf a step; the first step's loss within 1e-2 of the same step on
    the CPU (bfloat16 matmuls); the loss falls over 12 steps."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype=moments)
    h = AdamWHyper(lr=3e-3, warmup_steps=1, total_steps=12)
    get = make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))
    losses = {}
    for dev in ("cpu", "cuda"):
        state = build_state(cfg, 0, "cpu")
        if dev == "cuda":
            state = {"params": {n: t.cuda() for n, t in
                                state["params"].items()},
                     "params_c": state["params_c"].cuda(),
                     "opt": {k: ({n: (t.cuda() if isinstance(t, torch.Tensor)
                                      else {q: u.cuda() for q, u in t.items()})
                                  for n, t in o.items()}
                                 if isinstance(o, dict) else o.cuda())
                             for k, o in state["opt"].items()}}
        step = make_train_step(cfg, h)
        LAUNCHES.reset()
        state, met = step(state, shard_batch(get(0), dev))
        losses[dev] = [float(met["loss"])]
        if dev == "cuda":
            n_leaves = len(state["params"])
            counts = dict(LAUNCHES.by_kernel)
            assert counts.get("K6/adamw_f32") == n_leaves
            assert counts.get("K7/xent_bf16") == 1
            assert counts.get("K4/rmsnorm_bf16", 0) >= 2 * cfg.n_layers + 1
            for i in range(1, 12):
                state, met = step(state, shard_batch(get(i), dev))
                losses[dev].append(float(met["loss"]))
    assert abs(losses["cuda"][0] - losses["cpu"][0]) <= 1e-2 * losses["cpu"][0]
    assert losses["cuda"][-1] < losses["cuda"][0]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _states_equal(a, b) -> list:
    """Keys of the leaves where two train states differ in any bit."""
    from repro_torch.ckpt.checkpoint import _flatten
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    assert fa.keys() == fb.keys()
    return [k for k in fa if not torch.equal(_bits(fa[k]), _bits(fb[k]))]


@pytest.mark.gpu
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_exact_resume_on_gpu_is_bitwise(moments, cuda, tmp_path):
    """5 steps on the card, ``AsyncCheckpointer.save`` (the CUDA leaves
    copied to pinned host memory behind an event), 3 more; a fresh state
    restored at 5 and 3 more: every leaf and loss bitwise, and the
    restored state's tensors are its own, on the card."""
    import dataclasses

    from repro_torch.ckpt import AsyncCheckpointer, restore
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype=moments)
    step = make_train_step(cfg, AdamWHyper(lr=3e-3, warmup_steps=2,
                                           total_steps=60))
    get = make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))
    state = build_state(cfg, 0, "cuda")
    for i in range(5):
        state, _ = step(state, shard_batch(get(i), "cuda"))
    ck = AsyncCheckpointer(tmp_path)
    ck.save(5, state)
    cont = []
    for i in range(5, 8):
        state, m = step(state, shard_batch(get(i), "cuda"))
        cont.append(float(m["loss"]))
    ck.close()
    fresh = build_state(cfg, 1, "cuda")
    ptrs = [p.data_ptr() for p in fresh["params_c"].parameters()]
    fresh, at, _ = restore(tmp_path, fresh)
    assert at == 5
    assert [p.data_ptr() for p in fresh["params_c"].parameters()] == ptrs
    assert fresh["opt"]["step"].device.type == "cuda"
    rest = []
    for i in range(5, 8):
        fresh, m = step(fresh, shard_batch(get(i), "cuda"))
        rest.append(float(m["loss"]))
    assert rest == cont
    assert _states_equal(state, fresh) == []


DETERMINISTIC_SCRIPT = r"""
import dataclasses, json, sys
import torch
torch.use_deterministic_algorithms(True)
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.data import make_batch_fn, shard_batch
from repro_torch.launch.train import build_state
from repro_torch.optim import AdamWHyper
from repro_torch.train.steps import make_train_step

out = {}
for moments in ("float32", "int8"):
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype=moments)
    step = make_train_step(cfg, AdamWHyper(lr=3e-3, warmup_steps=1,
                                           total_steps=10))
    b = shard_batch(make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))(0),
                    "cuda")
    runs = []
    for _ in range(2):
        st, m = step(build_state(cfg, 0, "cuda"), b)
        runs.append((float(m["loss"]), dict(_flatten(st))))
    bits = lambda t: t.detach().view(torch.int16) \
        if t.dtype == torch.bfloat16 else t.detach()
    out[moments] = {"loss_equal": runs[0][0] == runs[1][0],
                    "differ": [k for k in runs[0][1] if not torch.equal(
                        bits(runs[0][1][k]), bits(runs[1][1][k]))]}
print(json.dumps(out))
"""


@pytest.mark.gpu
def test_train_step_is_deterministic_on_gpu(cuda):
    """The train step twice from one state, every leaf bitwise: under
    ``torch.use_deterministic_algorithms(True)`` in a subprocess (which
    raises on an operation with no deterministic algorithm; cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts), and in this process
    as the port runs it."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env["PYTHONPATH"] = os.path.join(root, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-c", DETERMINISTIC_SCRIPT],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for moments, res in out.items():
        assert res == {"loss_equal": True, "differ": []}, moments

    import dataclasses

    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train.steps import make_train_step
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype="int8")
    step = make_train_step(cfg, AdamWHyper(lr=3e-3, warmup_steps=1,
                                           total_steps=10))
    b = shard_batch(make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))(0),
                    "cuda")
    a, ma = step(build_state(cfg, 0, "cuda"), b)
    c, mc = step(build_state(cfg, 0, "cuda"), b)
    assert float(ma["loss"]) == float(mc["loss"])
    assert _states_equal(a, c) == []


@pytest.mark.gpu
def test_two_replicas_on_one_card_equal_the_base_engine(cuda):
    """``make_mesh((2,), ("data",), [cuda:0, cuda:0])``: every request
    of a mixed stream bitwise the base engine's, each replica's row
    block through its own batched K1 launches, the rows front-loaded."""
    from repro_torch.launch.mesh import make_data_mesh, make_mesh
    from repro_torch.serving import ServingEngine, ShardedServingEngine
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    wl = [(nm, n, make_inputs(REGISTRY[nm], n, seed=i))
          for i, (nm, n) in enumerate(
              [("GEMVER", 300), ("AXPYDOT", 5000), ("BiCGK", 256),
               ("GEMVER", 512), ("AXPYDOT", 4096), ("LM_DECODE_ATTN", 900),
               ("AXPYDOT", 3000)])]
    base = ServingEngine(cc, max_batch=8, min_bucket=64, max_pack=1,
                         registry=REGISTRY)
    want = {r.rid: r for r in base.serve(wl)}
    one = ShardedServingEngine(make_data_mesh(), compiler=cc, max_batch=8,
                               min_bucket=64, registry=REGISTRY)
    two = ShardedServingEngine(
        make_mesh((2,), ("data",), devices=["cuda:0", "cuda:0"]),
        compiler=cc, max_batch=8, min_bucket=64, registry=REGISTRY)
    assert one.n_replicas == torch.cuda.device_count()
    for eng in (one, two) if one.n_replicas == 1 else (two,):
        for _ in range(3):          # eager, captured, replayed
            LAUNCHES.reset()
            got = {r.rid - eng._rid + len(wl): r for r in eng.serve(wl)}
            assert sum(LAUNCHES.by_kernel.values()) > 0
            for k, r in want.items():
                assert all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(r.outputs, got[k].outputs)), k
    if one.n_replicas == 1:         # the base engine's programs
        assert all(one._programs[k] is base._programs[k]
                   for k in base._programs)
    # 2 keys of 2 requests ([1, 1] each), 3 of 1 ([1, 0]), served 3 times
    assert two.stats()["replica_rows"] == [3 * 5, 3 * 2]


def _world_one_rank(rank, world, moments, ckdir):
    """An NCCL rank of world 1 (``make_host_mesh(1)``): three steps of the
    smoke config unsharded, then sharded (FSDP2), the sharded state saved
    after step 2; every leaf's bits of both runs' last state, the
    losses, and the counts of the sharded steps."""
    import dataclasses

    from repro_torch.ckpt import save
    from repro_torch.ckpt.checkpoint import _flatten, _leaves
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train.steps import make_train_step, shard_train_state
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype=moments)
    hyper = AdamWHyper(lr=3e-3, warmup_steps=1, total_steps=10)
    get = make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))
    batches = [shard_batch(get(i), "cuda") for i in range(3)]
    out = {}
    for sharded in (False, True):
        state = build_state(cfg, 0, "cuda")
        sh = None
        if sharded:
            state, sh = shard_train_state(cfg, state, make_host_mesh(1))
        step = make_train_step(cfg, hyper, shardings=sh)
        losses = []
        LAUNCHES.reset()
        for i, b in enumerate(batches):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if sharded and i == 1:
                save(ckdir, 2, state, shardings=sh)
        leaves = _leaves(state, sh) if sharded else _flatten(state)
        out[sharded] = {"losses": losses,
                        "launches": dict(LAUNCHES.by_kernel),
                        "bits": {k: _bits(t).cpu() for k, t in leaves}}
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_world_one_sharded_step_is_bitwise_the_unsharded(moments, cuda,
                                                         tmp_path):
    """NCCL at world 1: FSDP2 gathers and reduce-scatters by copies, so
    the sharded steps' losses and every leaf (masters, the bf16 copy,
    moments, ``step``) are bitwise the unsharded steps'; and the sharded
    state saved after step 2 restores onto the card with no process
    group, where step 3 trained from it is bitwise the sharded run's."""
    import dataclasses

    from repro_torch.ckpt import restore
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.dist.spmd import run_ranks
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train.steps import make_train_step
    out = run_ranks(_world_one_rank, 1, moments, str(tmp_path / "ck"),
                    backend="nccl", timeout_s=300, tmpdir=str(tmp_path))[0]
    one, sharded = out[False], out[True]
    assert sharded["losses"] == one["losses"]
    assert one["bits"].keys() == sharded["bits"].keys()
    assert [k for k in one["bits"] if not torch.equal(
        one["bits"][k], sharded["bits"][k])] == []
    for k in ("K4/rmsnorm_bf16", "K6/adamw_f32", "K7/xent_bf16"):
        assert sharded["launches"].get(k), (k, sharded["launches"])
    cfg = dataclasses.replace(smoke_config("llama3_8b"),
                              opt_moment_dtype=moments)
    fresh = build_state(cfg, 1, "cuda")
    fresh, at, _ = restore(tmp_path / "ck", fresh)
    assert at == 2 and fresh["opt"]["step"].device.type == "cuda"
    step = make_train_step(cfg, AdamWHyper(lr=3e-3, warmup_steps=1,
                                           total_steps=10))
    b = shard_batch(make_batch_fn(cfg, ShapeConfig("t", 64, 8, "train"))(2),
                    "cuda")
    fresh, m = step(fresh, b)
    assert float(m["loss"]) == sharded["losses"][2]
    assert [k for k, t in _flatten(fresh) if not torch.equal(
        _bits(t).cpu(), sharded["bits"][k])] == []


@pytest.mark.gpu
def test_tp_serving_on_gloo_ranks_gives_the_one_rank_tokens(cuda, tmp_path):
    """``serve --arch llama3_8b --smoke --model-parallel 2`` on two gloo
    ranks that share the card (the launcher serving over the group
    ``run_ranks`` starts, as ``--nproc 2`` starts one; gloo carries CUDA
    tensors, and its steps run eagerly): the greedy tokens of the run
    on one rank, K4 and K5 launched on each rank."""
    import torch_tp_serve_ranks as ranks
    from repro_torch.dist.spmd import run_ranks
    from repro_torch.launch import serve
    argv = ["--arch", "llama3_8b", "--smoke", "--batch", "2",
            "--prompt-len", "24", "--gen", "6"]
    want = serve.main(argv)
    got = run_ranks(ranks.serve_main, 2, argv + ["--model-parallel", "2"],
                    backend="gloo", timeout_s=300, tmpdir=str(tmp_path))
    for tokens, launches in got:
        np.testing.assert_array_equal(tokens, want)
        for k in ("K4/rmsnorm_bf16", "K5/split_bf16", "K5/combine_bf16"):
            assert launches.get(k), (k, launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_v2_lite", "grok1_314b"])
def test_moe_tp_serving_on_gloo_ranks_gives_the_one_rank_tokens(
        arch, cuda, tmp_path):
    """``serve --arch <MoE> --smoke --model-parallel 2`` on two gloo ranks
    that share the card, as the dense test above: the greedy tokens of
    the run on one rank; K4 launched on each rank, K5 on Grok-1's (GQA)
    and none on DeepSeek-V2-Lite's (MLA's absorbed decode)."""
    import torch_tp_serve_ranks as ranks
    from repro_torch.dist.spmd import run_ranks
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
            "24", "--gen", "6"]
    want = serve.main(argv)
    got = run_ranks(ranks.serve_main, 2, argv + ["--model-parallel", "2"],
                    backend="gloo", timeout_s=300, tmpdir=str(tmp_path))
    for tokens, launches in got:
        np.testing.assert_array_equal(tokens, want)
        assert launches.get("K4/rmsnorm_bf16"), launches
        assert bool(launches.get("K5/split_bf16")) == (arch == "grok1_314b")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "whisper_medium"])
def test_ssm_encdec_tp_serving_on_gloo_ranks_gives_the_one_rank_tokens(
        arch, cuda, tmp_path):
    """``serve --arch mamba2_2p7b|whisper_medium --smoke --model-parallel
    2`` on two gloo ranks that share the card, as the dense test above:
    the greedy tokens of the run on one rank; Mamba-2's ranks launch K4
    whole and its block entry (the gated norm), Whisper's K5 (its
    self- and cross-attention; LayerNorm launches no K4)."""
    import torch_tp_serve_ranks as ranks
    from repro_torch.dist.spmd import run_ranks
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
            "24", "--gen", "6"]
    want = serve.main(argv)
    got = run_ranks(ranks.serve_main, 2, argv + ["--model-parallel", "2"],
                    backend="gloo", timeout_s=300, tmpdir=str(tmp_path))
    names = (("K4/rmsnorm_bf16", "K4/block_sumsq_bf16",
              "K4/block_scale_bf16") if arch == "mamba2_2p7b"
             else ("K5/split_bf16", "K5/combine_bf16"))
    for tokens, launches in got:
        np.testing.assert_array_equal(tokens, want)
        for k in names:
            assert launches.get(k), (k, launches)


@pytest.mark.gpu
@pytest.mark.parametrize("n_experts", [4, 3])
def test_moe_tp_training_on_gloo_ranks_matches_one_card(n_experts, cuda,
                                                        tmp_path):
    """DeepSeek's smoke shapes in float32 on (1, 2), two gloo ranks that
    share the card, ``moe_impl="gspmd"``: 4 experts split over the ranks
    (expert parallelism), 3 experts each split along its hidden columns
    (the F-split).  Three steps: the losses within 1e-5 and every master
    within 1e-4 norm-relative of the steps on one card
    (``tests/test_torch_tp_moe.py``'s bounds); K4, K6 and K7's block
    entry launched on each rank."""
    import torch_tp_moe_ranks as ranks
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.dist.spmd import run_ranks
    from repro_torch.launch.train import build_state
    from repro_torch.optim import AdamWHyper
    from repro_torch.train.steps import make_train_step
    got = run_ranks(ranks.on_the_card, 2, n_experts, backend="gloo",
                    timeout_s=300, tmpdir=str(tmp_path))
    cfg = ranks.config("deepseek_v2_lite", "float32",
                       ranks.MOE | {"n_experts": n_experts})
    state = build_state(cfg, 0, "cuda")
    step = make_train_step(cfg, AdamWHyper(**ranks.HYPER))
    get = ranks.make_batch_fn(cfg, ranks.ShapeConfig("t", ranks.S, ranks.B,
                                                     "train"))
    losses = []
    for i in range(ranks.STEPS):
        state, m = step(state, ranks.shard_batch(get(i), "cuda"))
        losses.append(float(m["loss"]))
    want = {k: t.detach().float().cpu() for k, t in _flatten(state)}
    for l, _, launches in got:
        assert np.allclose(l, losses, rtol=1e-5, atol=0), (l, losses)
        for k in ("K4/rmsnorm_f32", "K6/adamw_f32", "K7/xent_block_f32"):
            assert launches.get(k), (k, launches)
    for k, a in got[0][1].items():
        w = want[k]
        assert float((torch.from_numpy(a) - w).norm() / w.norm()) <= 1e-4, k
