"""The port's hand kernels K2 (BiCGK), K3 (GEMVER), K4 (RMSNorm), K5
(decode attention), K6 (AdamW) and K7 (softmax cross-entropy), their
plain versions and the ``ops`` API, against the JAX reference.

A CUDA kernel cannot run on the CPU, so this file holds what surrounds
it to the reference:

* the plain versions in ``repro_torch.kernels.ref`` (what ``ops`` runs
  for CPU tensors and what the kernels are held to on the card) against
  the reference's Pallas kernels in interpret mode, at the shapes
  ``tests/test_kernels.py`` runs them (K5 also at head dims 48 and 80),
  and against ``repro.kernels.ref``; K5's two plain kernels (split,
  combine) compose to the whole;
* ``ops`` on CPU tensors equals ``ref``, including the shapes the
  reference's dropped gates sent to its plain version (``(7, 33)``,
  ``N = 1000``), and ``Hq % Hkv != 0`` raises;
* no hidden fallback: a non-CPU tensor never reaches ``ref``, and a
  failed build or launch raises;
* the build layer: libraries named after their kernel, keyed by the
  headers their source includes.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances are stated per test: float32 1e-5 where both sides sum the
same terms, 1e-4 for matvecs summed in another order, 2e-2 for bfloat16
outputs (8 bits of mantissa); K5-K7 against the Pallas kernels take the
reference tests' own (3e-4, rtol 1e-5 on the mean loss, rtol 1e-5 and
atol 1e-6 for AdamW).  The kernels' own test on the card is in
``tests/test_torch_gpu.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.adamw import adamw_update as pallas_adamw
from repro.kernels.bicgk import bicgk as pallas_bicgk
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode_attention
from repro.kernels.gemver import gemver as pallas_gemver
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.softmax_xent import softmax_xent as pallas_xent
from repro_torch.core import cuda_codegen
from repro_torch.kernels import _build, _launch
from repro_torch.kernels import adamw as k6
from repro_torch.kernels import bicgk as k2
from repro_torch.kernels import decode_attention as k5
from repro_torch.kernels import gemver as k3
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as k4
from repro_torch.kernels import softmax_xent as k7


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.to(torch.float32) if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# plain K2-K4 against the Pallas kernels (interpret mode) and jnp ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,D", [(8, 128), (64, 256), (128, 512), (32, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(T, D, dtype):
    rng = np.random.default_rng(T * 1000 + D)
    x, g = randn(rng, T, D), randn(rng, D)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_pallas = pallas_rmsnorm(jx, jnp.asarray(g), interpret=True)
    want_ref = jref.rmsnorm(jx, jnp.asarray(g))
    got = ref.rmsnorm(t(x).to(getattr(torch, dtype)), t(g))
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, D)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    close(got, np.asarray(want_pallas, np.float32), tol)
    close(got, np.asarray(want_ref, np.float32), tol)


@pytest.mark.parametrize("m,n,bc", [(128, 256, 128), (256, 128, 64),
                                    (512, 512, 512), (128, 384, 128)])
def test_bicgk_plain_matches_pallas(m, n, bc):
    rng = np.random.default_rng(m + n)
    A, p, r = randn(rng, m, n), randn(rng, n), randn(rng, m)
    want_pallas = pallas_bicgk(jnp.asarray(A), jnp.asarray(p), jnp.asarray(r),
                               block_cols=bc, interpret=True)
    want_ref = jref.bicgk(jnp.asarray(A), jnp.asarray(p), jnp.asarray(r))
    got = ref.bicgk(t(A), t(p), t(r))
    for o, w1, w2 in zip(got, want_pallas, want_ref):
        close(o, w1, 1e-4)
        close(o, w2, 1e-4)


@pytest.mark.parametrize("m,n", [(128, 128), (256, 128), (128, 256)])
def test_gemver_plain_matches_pallas(m, n):
    rng = np.random.default_rng(m * 3 + n)
    A = randn(rng, m, n)
    u1, u2, y = (randn(rng, m) for _ in range(3))
    v1, v2, z = (randn(rng, n) for _ in range(3))
    want_pallas = pallas_gemver(*map(jnp.asarray, (A, u1, v1, u2, v2, y, z)),
                                1.3, 0.7, interpret=True)
    want_ref = jref.gemver(*map(jnp.asarray, (A, u1, v1, u2, v2, y, z)),
                           1.3, 0.7)
    got = ref.gemver(*map(t, (A, u1, v1, u2, v2, y, z)), 1.3, 0.7)
    for o, w1, w2 in zip(got, want_pallas, want_ref):
        close(o, w1, 2e-4)
        close(o, w2, 2e-4)
    # the two kernels' plain pieces compose to the whole
    B, tt = ref.gemver_k1(*map(t, (A, u1, v1, u2, v2, y)))
    torch.testing.assert_close(B, got[0], rtol=0, atol=0)
    close(ref.gemver_k2(B, got[1], 1.3), np.asarray(want_ref[2]), 2e-4)
    close(0.7 * tt + t(z), np.asarray(want_ref[1]), 2e-4)


# ---------------------------------------------------------------------------
# plain K5-K7 against the Pallas kernels (interpret mode) and jnp ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 1024, 4096, 128 * 17])
@pytest.mark.parametrize("step", [1, 10])
def test_adamw_plain_matches_reference(n, step):
    rng = np.random.default_rng(n + step)
    p, g = randn(rng, n), randn(rng, n)
    m, v = randn(rng, n) * 0.1, np.abs(randn(rng, n)) * 0.01
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01,
              step=step)
    want = jref.adamw(*map(jnp.asarray, (p, g, m, v)), **kw)
    want_pallas = pallas_adamw(*map(jnp.asarray, (p, g, m, v)), **kw,
                               interpret=True)
    got = ref.adamw(*map(t, (p, g, m, v)), **kw)
    for a, b, c in zip(got, want, want_pallas):
        close(a, np.asarray(b), 1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("T,V", [(8, 512), (32, 1000), (16, 4096)])
def test_softmax_xent_plain_matches_reference(T, V):
    rng = np.random.default_rng(T + V)
    lg = randn(rng, T, V, scale=3.0)
    lb = rng.integers(0, V, T).astype(np.int32)
    want = jref.softmax_xent(jnp.asarray(lg), jnp.asarray(lb))
    want_pallas = pallas_xent(jnp.asarray(lg), jnp.asarray(lb),
                              interpret=True)
    got = ref.softmax_xent(t(lg), t(lb))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want_pallas), rtol=1e-5)
    rows = ref.softmax_xent_rows(t(lg), t(lb))
    assert rows.shape == (T,) and rows.dtype == torch.float32
    np.testing.assert_allclose(float(rows.mean()), float(want_pallas),
                               rtol=1e-5)


@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(1, 4, 4, 256, 128),
                                          (2, 8, 2, 512, 128),
                                          (2, 16, 1, 256, 128),
                                          (2, 8, 2, 256, 48),
                                          (1, 6, 3, 512, 80)])
def test_decode_attention_plain_matches_reference(B, Hq, Hkv, S, d):
    rng = np.random.default_rng(B * Hq + S)
    q = randn(rng, B, Hq, d, scale=0.5)
    k = randn(rng, B, S, Hkv, d, scale=0.2)
    v = randn(rng, B, S, Hkv, d)
    want = jref.decode_attention(*map(jnp.asarray, (q, k, v)))
    want_pallas = pallas_decode_attention(*map(jnp.asarray, (q, k, v)),
                                          interpret=True)
    got = ref.decode_attention(t(q), t(k), t(v))
    close(got, np.asarray(want), 3e-4)
    close(got, np.asarray(want_pallas), 3e-4)


@pytest.mark.parametrize("B,Hq,Hkv,S,d,length", [(2, 8, 2, 300, 48, 64),
                                                 (1, 1, 1, 1000, 80, 77),
                                                 (3, 12, 4, 1000, 80, 1000),
                                                 (2, 16, 1, 256, 128, 64)])
def test_decode_attention_split_and_combine_compose(B, Hq, Hkv, S, d,
                                                    length):
    """K5's two plain kernels, chunked as the split kernel chunks S (the
    last chunk short), give the whole function."""
    rng = np.random.default_rng(S + length)
    q, k, v = (t(randn(rng, B, Hq, d)), t(randn(rng, B, S, Hkv, d)),
               t(randn(rng, B, S, Hkv, d)))
    acc, m, l = ref.decode_attention_split(q, k, v, length)
    chunks = -(-S // length)
    assert acc.shape == (B * Hkv * chunks, Hq // Hkv, d)
    assert m.shape == l.shape == (B * Hkv * chunks, Hq // Hkv)
    got = ref.decode_attention_combine(acc, m, l, B, Hq)
    torch.testing.assert_close(got, ref.decode_attention(q, k, v),
                               rtol=1e-5, atol=1e-6)
    got16 = ref.decode_attention_combine(acc, m, l, B, Hq, torch.bfloat16)
    assert got16.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# ops on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 33), (8, 128), (3, 5, 40), (33,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_rmsnorm_on_cpu_is_the_plain_version(shape, dtype):
    """Any D and any leading shape, no gate: ``ops`` is ``ref`` exactly."""
    rng = np.random.default_rng(len(shape))
    x = t(randn(rng, *shape)).to(dtype)
    g = t(randn(rng, shape[-1]))
    got = ops.rmsnorm(x, g)
    torch.testing.assert_close(got, ref.rmsnorm(x, g), rtol=0, atol=0)
    want = jref.rmsnorm(jnp.asarray(x.to(torch.float32).numpy(),
                                    getattr(jnp, str(dtype)[6:])),
                        jnp.asarray(g.numpy()))
    close(got, np.asarray(want, np.float32),
          2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("m,n", [(128, 384), (7, 33)])
def test_ops_bicgk_and_gemver_on_cpu_are_the_plain_versions(m, n):
    rng = np.random.default_rng(m * n)
    A = t(randn(rng, m, n))
    vm = [t(randn(rng, m)) for _ in range(3)]
    vn = [t(randn(rng, n)) for _ in range(3)]
    for o, w in zip(ops.bicgk(A, vn[0], vm[0]), ref.bicgk(A, vn[0], vm[0])):
        torch.testing.assert_close(o, w, rtol=0, atol=0)
    args = (A, vm[0], vn[0], vm[1], vn[1], vm[2], vn[2])
    for alpha, beta in ((1.3, 0.7), (np.float32(1.3), np.float32(0.7)),
                        (torch.tensor(1.3), torch.tensor(0.7))):
        got = ops.gemver(*args, alpha, beta)
        want = ref.gemver(*args, alpha, beta)
        for o, w in zip(got, want):
            assert isinstance(o, torch.Tensor)
            torch.testing.assert_close(o, w, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1000, 1024])
def test_ops_adamw_on_cpu_is_the_plain_version(n):
    """Any N (the reference's ``N % 128`` gate is gone), any shape, and
    ``lr``/``step`` as tensors."""
    rng = np.random.default_rng(n)
    p, g = t(randn(rng, n)), t(randn(rng, n))
    m, v = t(randn(rng, n) * 0.1), t(np.abs(randn(rng, n)) * 0.01)
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01)
    for lr, step in ((1e-3, 3), (torch.tensor(1e-3), torch.tensor(3))):
        got = ops.adamw_update(p, g, m, v, lr=lr, step=step, **kw)
        want = ref.adamw(p, g, m, v, lr=lr, step=step, **kw)
        for o, w in zip(got, want):
            torch.testing.assert_close(o, w, rtol=0, atol=0)
    ref_np = jref.adamw(*(jnp.asarray(x.numpy()) for x in (p, g, m, v)),
                        lr=1e-3, step=3, **kw)
    for o, w in zip(ops.adamw_update(p, g, m, v, lr=1e-3, step=3, **kw),
                    ref_np):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    two_d = ops.adamw_update(p.reshape(-1, 8), g.reshape(-1, 8),
                             m.reshape(-1, 8), v.reshape(-1, 8), lr=1e-3,
                             **kw)
    assert two_d[0].shape == (n // 8, 8)


def test_ops_softmax_xent_and_decode_attention_on_cpu_are_plain():
    rng = np.random.default_rng(3)
    lg, lb = t(randn(rng, 7, 1000)), t(rng.integers(0, 1000, 7))
    torch.testing.assert_close(ops.softmax_xent(lg, lb),
                               ref.softmax_xent(lg, lb), rtol=0, atol=0)
    q, k, v = (t(randn(rng, 3, 12, 80)), t(randn(rng, 3, 100, 4, 80)),
               t(randn(rng, 3, 100, 4, 80)))
    torch.testing.assert_close(ops.decode_attention(q, k, v),
                               ref.decode_attention(q, k, v), rtol=0,
                               atol=0)
    want = jref.decode_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    close(ops.decode_attention(q, k, v), np.asarray(want), 3e-4)


def test_decode_attention_heads_not_a_multiple_raise_on_every_device():
    """``Hq % Hkv != 0`` has no answer (the plain version cannot group
    the heads either): ``ValueError`` on the CPU and on any other
    device, before any kernel is built."""
    for dev in ("cpu", "meta"):
        q = torch.empty((1, 6, 16), device=dev)
        kv = torch.empty((1, 8, 4, 16), device=dev)
        with pytest.raises(ValueError, match="not a multiple"):
            ops.decode_attention(q, kv, kv)


def test_adamw_hyper_block():
    """K6's (8,) hyperparameter tensor: [lr, b1, b2, eps, wd, c1, c2, 0];
    c1, c2 in float64 for a Python step, on the device for a tensor
    step, and a tensor lr written in."""
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01,
              device=torch.device("cpu"))
    h = k6.hyper(lr=1e-3, step=3, **kw)
    want = [1e-3, 0.9, 0.95, 1e-8, 0.01, 1 / (1 - 0.9 ** 3),
            1 / (1 - 0.95 ** 3), 0.0]
    assert h.dtype == torch.float32 and h.shape == (8,)
    np.testing.assert_allclose(h.numpy(), np.float32(want), rtol=1e-7)
    ht = k6.hyper(lr=torch.tensor(2e-3), step=torch.tensor(3), **kw)
    np.testing.assert_allclose(ht.numpy(),
                               np.float32([2e-3] + want[1:]), rtol=1e-6)


# ---------------------------------------------------------------------------
# no hidden fallback
# ---------------------------------------------------------------------------

def _forbid_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")
    for name in ("rmsnorm", "bicgk", "gemver", "gemver_k1", "gemver_k2",
                 "adamw", "softmax_xent", "softmax_xent_rows",
                 "decode_attention", "decode_attention_split",
                 "decode_attention_combine"):
        monkeypatch.setattr(ref, name, plain)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    _forbid_plain(monkeypatch)
    m, n = 64, 96
    calls = {
        "rmsnorm": lambda: ops.rmsnorm(_meta(4, n), _meta(n)),
        "bicgk": lambda: ops.bicgk(_meta(m, n), _meta(n), _meta(m)),
        "gemver": lambda: ops.gemver(_meta(m, n), _meta(m), _meta(n),
                                     _meta(m), _meta(n), _meta(m), _meta(n),
                                     1.3, 0.7),
        "mixed": lambda: ops.bicgk(_meta(m, n), torch.zeros(n),
                                   torch.zeros(m)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    for fn in (k2.bicgk, k3.gemver, k3.gemver_k1, k3.gemver_k2, k4.rmsnorm,
               _launch.launch, _launch.check, _launch.grid_query):
        assert "ref." not in inspect.getsource(fn)


def test_non_cpu_tensor_never_takes_the_plain_version_k5_k7(monkeypatch):
    _forbid_plain(monkeypatch)
    n, T, V = 64, 4, 100
    calls = {
        "adamw_update": lambda: ops.adamw_update(
            _meta(n), _meta(n), _meta(n), _meta(n), lr=1e-3),
        "softmax_xent": lambda: ops.softmax_xent(
            _meta(T, V), torch.empty(T, dtype=torch.int64, device="meta")),
        "decode_attention": lambda: ops.decode_attention(
            _meta(2, 8, 48), _meta(2, 16, 2, 48), _meta(2, 16, 2, 48)),
        "mixed": lambda: ops.decode_attention(
            _meta(2, 8, 48), torch.zeros(2, 16, 2, 48),
            torch.zeros(2, 16, 2, 48)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    for fn in (k5.split, k5.combine, k5.decode_attention,
               k6.adamw, k6.adamw_update, k6.hyper, k7.softmax_xent_rows,
               k7.softmax_xent):
        assert "ref." not in inspect.getsource(fn)


def test_softmax_xent_needs_2d_logits_off_the_cpu():
    with pytest.raises(ValueError, match="2-D"):
        ops.softmax_xent(_meta(2, 3, 10),
                         torch.empty((2, 3), dtype=torch.int64,
                                     device="meta"))


@pytest.fixture
def meta_is_cuda(monkeypatch):
    """Let meta tensors pass the device check, to reach the others."""
    monkeypatch.setattr(_launch, "_on_cuda", lambda t: True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_wrong_dtype_raises(dtype, meta_is_cuda):
    with pytest.raises(TypeError, match="dtype"):
        k4.rmsnorm(torch.empty((2, 8), dtype=dtype, device="meta"),
                   _meta(8))
    with pytest.raises(TypeError, match="dtype"):
        k2.bicgk(torch.empty((4, 8), dtype=dtype, device="meta"), _meta(8),
                 _meta(4))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_wrong_dtype_raises_k5_k7(dtype, meta_is_cuda):
    def m(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")
    with pytest.raises(TypeError, match="dtype"):
        k5.decode_attention(m(1, 2, 8), m(1, 4, 2, 8), m(1, 4, 2, 8))
    with pytest.raises(TypeError, match="dtype"):
        k5.decode_attention(_meta(1, 2, 8), m(1, 4, 2, 8), _meta(1, 4, 2, 8))
    with pytest.raises(TypeError, match="dtype"):
        k6.adamw(m(8), _meta(8), _meta(8), _meta(8), _meta(8))
    with pytest.raises(TypeError, match="dtype"):
        k6.adamw(_meta(8), _meta(8), m(8), _meta(8), _meta(8))
    with pytest.raises(TypeError, match="dtype"):
        k7.softmax_xent_rows(m(2, 8), m(2, dt=torch.int64))
    with pytest.raises(TypeError, match="dtype"):
        k7.softmax_xent_rows(_meta(2, 8), m(2))


def test_decode_attention_head_dim_limit(meta_is_cuda):
    """K5 takes any d up to D_MAX (256); a larger d raises."""
    d = k5.D_MAX + 1
    with pytest.raises(ValueError, match="head dim"):
        k5.decode_attention(_meta(1, 2, d), _meta(1, 4, 2, d),
                            _meta(1, 4, 2, d))


def test_wrong_shape_and_layout_raise(meta_is_cuda):
    with pytest.raises(ValueError, match=r"shape \(8,\)"):
        k2.bicgk(_meta(4, 8), _meta(7), _meta(4))
    with pytest.raises(ValueError, match="contiguous"):
        k3.gemver_k2(_meta(8, 4).T, _meta(8), _meta(1))


def test_build_failure_raises(monkeypatch, tmp_path):
    _forbid_plain(monkeypatch)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))

    def no_nvcc():
        raise _build.BuildError("nvcc not found")
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(k2, "_fns", None)
    monkeypatch.setattr(k3, "_fns", None)
    monkeypatch.setattr(k4, "_fn", None)
    monkeypatch.setattr(k5, "_fns", None)
    monkeypatch.setattr(k6, "_fn", None)
    monkeypatch.setattr(k7, "_fn", None)
    for launcher in (k2._launchers, k3._launchers, k4._launcher,
                     k5._launchers, k6._launcher, k7._launcher):
        with pytest.raises(_build.BuildError):
            launcher()


def test_nonzero_launch_status_raises_and_counts(monkeypatch):
    monkeypatch.setattr(_launch.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    before = _launch.LAUNCHES.by_kernel["K2/bicgk"]
    with pytest.raises(_launch.CudaLaunchError, match="700"):
        _launch.launch("K2/bicgk", lambda *a: 700, 1, 2,
                       device=torch.device("cpu"))
    assert _launch.LAUNCHES.by_kernel["K2/bicgk"] == before + 1


# ---------------------------------------------------------------------------
# the build layer and the sources
# ---------------------------------------------------------------------------

def test_library_named_after_its_kernel_and_keyed_by_its_headers(
        monkeypatch, tmp_path):
    src_k2 = (_build.CSRC / "bicgk.cu").read_text()
    src_k1 = '#include "fused_group.cuh"\nint x;\n'
    assert [h.name for h in _build.included_headers(src_k2)] == \
        ["hand_kernels.cuh"]
    assert [h.name for h in _build.included_headers(src_k1)] == \
        ["fused_group.cuh"]
    assert _build.library_path(src_k2, "bicgk").name.startswith("bicgk_")
    assert _build.library_path(src_k1).name.startswith("k1_")

    # an edit to K1's header rebuilds K1, not K2; one to K2's, K2 only
    keys = (_build.source_key(src_k1), _build.source_key(src_k2))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for h in ("fused_group.cuh", "hand_kernels.cuh"):
        (csrc / h).write_text((_build.CSRC / h).read_text())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert (_build.source_key(src_k1), _build.source_key(src_k2)) == keys
    (csrc / "fused_group.cuh").write_text("// edited\n")
    assert _build.source_key(src_k1) != keys[0]
    assert _build.source_key(src_k2) == keys[1]
    (csrc / "hand_kernels.cuh").write_text("// edited\n")
    assert _build.source_key(src_k2) != keys[1]


def test_row_groups_query_is_cached_and_checked(monkeypatch):
    """The grid query runs once per device and shape; a failed one
    raises."""
    monkeypatch.setattr(_launch, "_grids", {})
    calls = []

    def query(m, n, groups, strips):
        calls.append((m, n))
        groups._obj.value, strips._obj.value = 6, 2
        return 0
    dev0, dev1 = torch.device("meta", 0), torch.device("meta", 1)

    def grid(fn, dev):
        return _launch.grid_query("K2/bicgk", fn, 64, 96, device=dev)
    assert grid(query, dev0) == (6, 2)
    assert grid(query, dev0) == (6, 2)
    assert calls == [(64, 96)]
    assert grid(query, dev1) == (6, 2)
    assert calls == [(64, 96)] * 2
    with pytest.raises(_launch.CudaLaunchError, match="occupancy"):
        _launch.grid_query("K2/bicgk", lambda m, n, g, s: 2, 8, 8,
                           device=dev0)


def test_tensors_on_two_devices_raise(meta_is_cuda, monkeypatch):
    """Every tensor of a launch must be on the first one's device."""
    def no_build():
        raise AssertionError("the wrapper got past its device check")
    monkeypatch.setattr(k2, "_launchers", no_build)
    monkeypatch.setattr(k3, "_launchers", no_build)
    monkeypatch.setattr(k4, "_launcher", no_build)
    monkeypatch.setattr(k5, "_launchers", no_build)
    monkeypatch.setattr(k6, "_launcher", no_build)
    monkeypatch.setattr(k7, "_launcher", no_build)
    m, n = 4, 8
    calls = (lambda: k2.bicgk(_meta(m, n), torch.zeros(n), _meta(m)),
             lambda: k3.gemver_k1(_meta(m, n), _meta(m), _meta(n), _meta(m),
                                  _meta(n), torch.zeros(m)),
             lambda: k3.gemver_k2(_meta(m, n), _meta(n), torch.zeros(1)),
             lambda: k4.rmsnorm(_meta(m, n), torch.zeros(n)),
             lambda: k5.decode_attention(_meta(1, 2, n), _meta(1, 3, 2, n),
                                         torch.zeros(1, 3, 2, n)),
             lambda: k6.adamw(_meta(n), _meta(n), _meta(n), torch.zeros(n),
                              _meta(8)),
             lambda: k7.softmax_xent_rows(
                 _meta(m, n), torch.zeros(m, dtype=torch.int64)))
    for call in calls:
        with pytest.raises(ValueError, match="runs on one device"):
            call()


def test_every_source_names_the_tpu_kernel_it_replaces():
    for source, replaces in (("bicgk.cu", "src/repro/kernels/bicgk.py:20"),
                             ("gemver.cu", "src/repro/kernels/gemver.py:26"),
                             ("rmsnorm.cu",
                              "src/repro/kernels/rmsnorm.py:18"),
                             ("decode_attention.cu",
                              "src/repro/kernels/decode_attention.py:20"),
                             ("adamw.cu", "src/repro/kernels/adamw.py:24"),
                             ("softmax_xent.cu",
                              "src/repro/kernels/softmax_xent.py:17")):
        text = (_build.CSRC / source).read_text()
        assert replaces in text and "Bound: bytes" in text
