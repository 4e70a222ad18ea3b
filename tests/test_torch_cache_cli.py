"""Three small surfaces of the port against the JAX reference on the CPU:
``PlanCache.clear`` and the sweep of orphaned ``.tmp`` files, the
``serve --engine`` workload (``--sizes``, ``--quick``), and
``blas.make_synthetic_chain`` (the same graphs and plans past the exact
DP's 20 calls)."""
import json
import os
import time

import numpy as np
import pytest

from repro.blas import make_synthetic_chain as ref_chain
from repro.core import FusionCompiler as RefCompiler
from repro.core import PlanCache as RefPlanCache
from repro.core import build_space as ref_build_space
from repro.core import graph_signature as ref_graph_signature
from repro.core import trace as ref_trace
from repro.core.plan import build_plan as ref_build_plan
from repro.launch import serve as ref_serve
from repro.serving import ServingEngine as RefEngine
from repro_torch.blas import make_synthetic_chain
from repro_torch.core import (FusionCompiler, PlanCache, build_plan,
                              build_space, graph_signature, trace)
from repro_torch.launch import serve
from repro_torch.serving import ServingEngine
from torch_threads import capped_torch_threads  # noqa: F401

# ---------------------------------------------------------------------------
# PlanCache.clear and the .tmp sweep
# ---------------------------------------------------------------------------


def _fill(cache, compiler_cls, **kw):
    from repro_torch.programs import BLAS
    prog = BLAS["GEMVER"]
    compiler_cls(cache=cache, **kw).compile(prog.script, prog.shapes(64))
    return cache


def _layers(cache) -> list:
    return [len(getattr(cache, k)) for k in
            ("_programs", "_plans", "_packs", "_measurements")]


def test_plan_cache_clear_matches_reference():
    port = _fill(PlanCache(), FusionCompiler, device="cpu")
    ref = _fill(RefPlanCache(), RefCompiler)
    assert _layers(port) == _layers(ref) != [0, 0, 0, 0]
    port.put_measurement("k", {"kind": "group"})
    ref.put_measurement("k", {"kind": "group"})
    port.clear()
    ref.clear()
    assert _layers(port) == _layers(ref) == [0, 0, 0, 0]
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.get_measurement("k") is None and ref.get_measurement("k") \
        is None


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_publish_sweeps_orphaned_tmp_files(tmp_path, pkg):
    """A ``.tmp`` file older than an hour (a writer killed mid-write) goes
    at the next disk publish; a fresh one (a writer at work) and other
    files stay: the same in both packages."""
    d = tmp_path / pkg
    d.mkdir()
    old, fresh, other = d / "a.tmp", d / "b.tmp", d / "c.txt"
    for p in (old, fresh, other):
        p.write_text("x")
    stale = time.time() - 2 * 3600
    os.utime(old, (stale, stale))
    os.utime(other, (stale, stale))
    cache = (PlanCache if pkg == "port" else RefPlanCache)(disk_dir=str(d))
    cache.put_measurement("key", {"kind": "group", "t": 1.0})
    names = sorted(os.listdir(d))
    assert names == ["b.tmp", "c.txt", "key.meas.json"]
    assert cache.stats.meas_writes == 1


# ---------------------------------------------------------------------------
# serve --engine: the reference's workload
# ---------------------------------------------------------------------------


def _workloads(monkeypatch, argv) -> tuple:
    """The workload each package's ``serve --engine`` hands its engine,
    with the engines' warm-up and serving stubbed out."""
    seen = {}
    for name, cls in (("port", ServingEngine), ("ref", RefEngine)):
        monkeypatch.setattr(cls, "warm", lambda self, nm, sizes, **k: [])
        monkeypatch.setattr(cls, "warm_packs", lambda self, *a, **k: None)
        monkeypatch.setattr(
            cls, "serve", lambda self, w, rate_hz=None, _n=name:
            seen.__setitem__(_n, w) or [])
    serve.main(argv + ["--device", "cpu"])
    ref_serve.main(argv)
    return seen["port"], seen["ref"]


@pytest.mark.parametrize("extra", [[], ["--quick"],
                                   ["--sizes", "300,77,4096"]])
def test_engine_workload_is_the_reference_workload(monkeypatch, extra):
    argv = ["--blas", "GEMVER,AXPYDOT,BiCGK", "--engine", "--requests",
            "10", "--seed", "3"] + extra
    port, ref = _workloads(monkeypatch, argv)
    assert [(nm, n) for nm, n, _ in port] == [(nm, n) for nm, n, _ in ref]
    sizes = {"--quick": [64, 100, 128]}.get(
        extra[0] if extra else None, [256, 1000, 1024, 2048])
    if extra[:1] == ["--sizes"]:
        sizes = [300, 77, 4096]
    assert [n for _, n, _ in port] == [sizes[i % len(sizes)]
                                       for i in range(10)]
    for (_, _, a), (_, _, b) in zip(port, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_engine_requests_rule():
    assert serve.engine_requests(["A", "B"], [1, 2, 3], 5) == [
        ("A", 1), ("B", 2), ("A", 3), ("B", 1), ("A", 2)]


# ---------------------------------------------------------------------------
# make_synthetic_chain
# ---------------------------------------------------------------------------

MODES = ("best", "unfused", 0, 1, 2, 3)


def _plans(compiler, space, g, build, backend) -> dict:
    out = {}
    for mode in MODES:
        d = json.loads(build(g, compiler.search(space, mode),
                             backend=backend).to_json())
        d.pop("backend")
        out[mode] = d
    return out


@pytest.mark.parametrize("n_calls,opts", [
    (21, {}), (22, {}), (25, {}), (30, {}),
    (21, {"reduce_consume": True}), (21, {"gemv": True}),
    (21, {"scalar_input": True}),
    (22, {"reduce_consume": True, "gemv": True, "scalar_input": True})])
def test_synthetic_chain_plans_match_reference(n_calls, opts):
    script, shapes, _ = make_synthetic_chain(n_calls, **opts)
    rscript, rshapes, _ = ref_chain(n_calls, **opts)
    n = 256
    assert shapes(n) == rshapes(n)
    g, rg = trace(script, shapes(n)), ref_trace(rscript, rshapes(n))
    assert len(g.calls) > 20
    assert graph_signature(g) == ref_graph_signature(rg)
    port = _plans(FusionCompiler(device="cpu", cache=None), build_space(g),
                  g, build_plan, "cuda")
    ref = _plans(RefCompiler(cache=None), ref_build_space(rg), rg,
                 ref_build_plan, "pallas")
    assert port == ref


@pytest.mark.parametrize("opts", [{}, {"reduce_consume": True, "gemv": True,
                                       "scalar_input": True}])
def test_synthetic_chain_runs_against_its_reference(opts):
    script, shapes, reference = make_synthetic_chain(21, **opts)
    n = 128
    prog = FusionCompiler(device="cpu", cache=None, backend="torch").compile(
        script, shapes(n))
    rng = np.random.default_rng(0)
    inputs = {k: (rng.standard_normal(v) * 0.1).astype(np.float32)
              for k, v in shapes(n).items()}
    got = prog(**inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = reference(**inputs)
    assert len(got) == len(want)
    for x, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(x), w, rtol=1e-4, atol=1e-4)
