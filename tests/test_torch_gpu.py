"""The port's kernels on the card: K1's generated kernels against their
plain tiled version, and K2-K4 through ``ops`` against ``kernels.ref``.

This file imports neither JAX nor the reference package, so it runs on
a machine with an NVIDIA GPU and the CUDA toolkit alone:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -q

Every test carries the ``gpu`` marker and skips without a CUDA device.
Tolerance: float32 sums run in another order, so K1's groups are held to
the reference envelope (rtol 1e-4, atol 1e-3) at n = 256, and the hand
kernels at (1000, 1531) — dot products of 1531 terms, where a few
outputs near zero lose their relative digits to cancellation — to a
norm-relative error of 1e-4, as ``chip_smoke.py`` holds them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import FusionCompiler, PlanCache, tiled_reference
from repro_torch.kernels._launch import LAUNCHES
from repro_torch.kernels import ops, ref
from repro_torch.programs import REGISTRY, make_inputs

N = 256
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ATAX", "BiCGK", "GEMVER", "AXPYDOT",
                                  "LM_RMSNORM", "LM_BLOCK"])
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
