"""The port's hand kernels K2 (BiCGK), K3 (GEMVER) and K4 (RMSNorm), their
plain versions and the ``ops`` API, against the JAX reference.

A CUDA kernel cannot run on the CPU, so this file holds what surrounds
it to the reference:

* the plain versions in ``repro_torch.kernels.ref`` (what ``ops`` runs
  for CPU tensors and what the kernels are held to on the card) against
  the reference's Pallas kernels in interpret mode, at the shapes
  ``tests/test_kernels.py`` runs them, and against ``repro.kernels.ref``;
  the plain K5–K7 versions against ``repro.kernels.ref``;
* ``ops`` on CPU tensors equals ``ref``, including the ``(7, 33)`` shape
  the reference's dropped ``LANES`` gate sent to its plain version;
* no hidden fallback: a non-CPU tensor never reaches ``ref``, and a
  failed build or launch raises;
* the build layer: libraries named after their kernel, keyed by the
  headers their source includes.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances are stated per test: float32 1e-5 where both sides sum the
same terms, 1e-4 for matvecs summed in another order, 2e-2 for bfloat16
outputs (8 bits of mantissa).  The kernels' own test on the card is in
``tests/test_torch_gpu.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bicgk import bicgk as pallas_bicgk
from repro.kernels.gemver import gemver as pallas_gemver
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.core import cuda_codegen
from repro_torch.kernels import _build, _launch
from repro_torch.kernels import bicgk as k2
from repro_torch.kernels import gemver as k3
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as k4


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
# plain K5-K7 against repro.kernels.ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [128, 1024, 128 * 17])
@pytest.mark.parametrize("step", [1, 10])
def test_adamw_plain_matches_reference(n, step):
    rng = np.random.default_rng(n + step)
    p, g = randn(rng, n), randn(rng, n)
    m, v = randn(rng, n) * 0.1, np.abs(randn(rng, n)) * 0.01
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01,
              step=step)
    want = jref.adamw(*map(jnp.asarray, (p, g, m, v)), **kw)
    got = ref.adamw(*map(t, (p, g, m, v)), **kw)
    for a, b in zip(got, want):
        close(a, np.asarray(b), 1e-5)


@pytest.mark.parametrize("T,V", [(8, 512), (32, 1000), (16, 4096)])
def test_softmax_xent_plain_matches_reference(T, V):
    rng = np.random.default_rng(T + V)
    lg = randn(rng, T, V, scale=3.0)
    lb = rng.integers(0, V, T).astype(np.int32)
    want = jref.softmax_xent(jnp.asarray(lg), jnp.asarray(lb))
    got = ref.softmax_xent(t(lg), t(lb))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(1, 4, 4, 256, 128),
                                          (2, 8, 2, 512, 128),
                                          (2, 16, 1, 256, 128)])
def test_decode_attention_plain_matches_reference(B, Hq, Hkv, S, d):
    rng = np.random.default_rng(B * Hq + S)
    q = randn(rng, B, Hq, d, scale=0.5)
    k = randn(rng, B, S, Hkv, d, scale=0.2)
    v = randn(rng, B, S, Hkv, d)
    want = jref.decode_attention(*map(jnp.asarray, (q, k, v)))
    got = ref.decode_attention(t(q), t(k), t(v))
    close(got, np.asarray(want), 3e-4)


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


# ---------------------------------------------------------------------------
# no hidden fallback
# ---------------------------------------------------------------------------

def _forbid_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")
    for name in ("rmsnorm", "bicgk", "gemver", "gemver_k1", "gemver_k2"):
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
               _launch.launch, _launch.check, _launch.row_groups):
        assert "ref." not in inspect.getsource(fn)


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
    for launcher in (k2._launchers, k3._launchers, k4._launcher):
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
    assert _launch.row_groups("K2/bicgk", query, 64, 96, dev0) == (6, 2)
    assert _launch.row_groups("K2/bicgk", query, 64, 96, dev0) == (6, 2)
    assert calls == [(64, 96)]
    assert _launch.row_groups("K2/bicgk", query, 64, 96, dev1) == (6, 2)
    assert calls == [(64, 96)] * 2
    with pytest.raises(_launch.CudaLaunchError, match="occupancy"):
        _launch.row_groups("K2/bicgk", lambda m, n, g, s: 2, 8, 8, dev0)


def test_tensors_on_two_devices_raise(meta_is_cuda, monkeypatch):
    """Every tensor of a launch must be on the first one's device."""
    def no_build():
        raise AssertionError("the wrapper got past its device check")
    monkeypatch.setattr(k2, "_launchers", no_build)
    monkeypatch.setattr(k3, "_launchers", no_build)
    monkeypatch.setattr(k4, "_launcher", no_build)
    m, n = 4, 8
    calls = (lambda: k2.bicgk(_meta(m, n), torch.zeros(n), _meta(m)),
             lambda: k3.gemver_k1(_meta(m, n), _meta(m), _meta(n), _meta(m),
                                  _meta(n), torch.zeros(m)),
             lambda: k3.gemver_k2(_meta(m, n), _meta(n), torch.zeros(1)),
             lambda: k4.rmsnorm(_meta(m, n), torch.zeros(n)))
    for call in calls:
        with pytest.raises(ValueError, match="runs on one device"):
            call()


def test_every_source_names_the_tpu_kernel_it_replaces():
    for source, replaces in (("bicgk.cu", "src/repro/kernels/bicgk.py:20"),
                             ("gemver.cu", "src/repro/kernels/gemver.py:26"),
                             ("rmsnorm.cu",
                              "src/repro/kernels/rmsnorm.py:18")):
        text = (_build.CSRC / source).read_text()
        assert replaces in text and "Bound: bytes" in text
