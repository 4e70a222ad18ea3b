"""The port's compiler facade, caches, serving entry point and package
boundary — mirroring ``tests/test_plan_cache.py`` for the cache layers.

Everything here runs on the CPU (``device="cpu"``); asking for CUDA on
a machine without it must raise, never fall back.  Numerics are held to
the reference envelope, rtol 1e-4, atol 1e-3.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import FusionCompiler, PlanCache, graph_signature
from repro_torch.core.diagnostics import VerificationError
from repro_torch.core.plan import ExecutionPlan
from repro_torch.launch import serve
from repro_torch.programs import BLAS, make_inputs
from torch_threads import capped_torch_threads  # noqa: F401

N = 256
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _check(prog, seq, seed=0):
    env = make_inputs(seq, N, seed=seed)
    out = prog(**env)
    out = out if isinstance(out, tuple) else (out,)
    for o, r in zip(out, seq.reference(**env)):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_program_cache_hit_returns_the_same_program(backend):
    seq = BLAS["GEMVER"]
    cache = PlanCache()
    cc = FusionCompiler(backend=backend, device="cpu", cache=cache)
    a = cc.compile(seq.script, seq.shapes(N))
    b = cc.compile(seq.script, seq.shapes(N))
    assert a is b
    assert cache.stats.program_hits == 1 and cache.stats.plan_misses == 1
    _check(a, seq)


def test_plan_cache_hit_skips_the_search():
    seq = BLAS["BiCGK"]
    cache = PlanCache()
    cc = FusionCompiler(backend="cuda", device="cpu", cache=cache)
    a = cc.compile(seq.script, seq.shapes(N))
    cache._programs._d.clear()          # a restarted worker, same process
    b = cc.compile(seq.script, seq.shapes(N))
    assert a is not b and a.plan == b.plan
    assert cache.stats.plan_hits == 1
    _check(b, seq)


def test_modes_and_backends_key_separately():
    seq = BLAS["GEMVER"]
    cache = PlanCache()
    cc = FusionCompiler(device="cpu", cache=cache)
    best = cc.compile(seq.script, seq.shapes(N), mode="best")
    unfused = cc.compile(seq.script, seq.shapes(N), mode="unfused")
    dense = cc.compile(seq.script, seq.shapes(N), backend="torch")
    assert best.n_groups == 4 and unfused.n_groups == 5
    assert dense.plan.backend == "torch" and best.plan.backend == "cuda"
    assert cache.stats.plan_misses == 3


def test_disk_reload_in_a_fresh_cache(tmp_path):
    seq = BLAS["ATAX"]
    c1 = PlanCache(disk_dir=str(tmp_path))
    p1 = FusionCompiler(device="cpu", cache=c1).compile(
        seq.script, seq.shapes(N))
    assert c1.stats.disk_writes == 1
    assert len(list(tmp_path.glob("*.plan.json"))) == 1

    c2 = PlanCache(disk_dir=str(tmp_path))       # another process
    p2 = FusionCompiler(device="cpu", cache=c2).compile(
        seq.script, seq.shapes(N))
    assert c2.stats.disk_hits == 1 and c2.stats.plan_misses == 0
    assert p2.plan == p1.plan
    assert p2.plan.signature == graph_signature(p2.graph)
    _check(p2, seq)


def test_corrupt_disk_entry_heals(tmp_path, caplog):
    seq = BLAS["VADD"]
    FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path))
                   ).compile(seq.script, seq.shapes(N))
    (path,) = tmp_path.glob("*.plan.json")
    path.write_text("{not json")
    c2 = PlanCache(disk_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING):
        prog = FusionCompiler(device="cpu", cache=c2).compile(
            seq.script, seq.shapes(N))
    assert "RPL311" in caplog.text
    assert c2.stats.plan_misses == 1 and c2.stats.disk_writes == 1
    ExecutionPlan.from_json(path.read_text())    # republished, readable
    _check(prog, seq)


def test_unknown_backend_and_mode_raise_coded_errors():
    with pytest.raises(VerificationError) as ei:
        FusionCompiler(backend="pallas", device="cpu")
    assert ei.value.codes == ("RPL401",)
    cc = FusionCompiler(device="cpu", cache=None)
    seq = BLAS["SSCAL"]
    for bad in (True, -1, 5):
        with pytest.raises(VerificationError) as ei:
            cc.compile(seq.script, seq.shapes(N), mode=bad)
        assert ei.value.codes == ("RPL402",)


def test_dead_call_raises_rpl204_as_the_reference_does():
    """A call whose output nothing reads forms a zero-output group; the
    port mirrors the reference's verifier (RPL204) instead of running
    it."""
    from repro_torch.blas import elementary_lib as lib

    def script(g, x0, x1, alpha):
        g.apply(lib.scal, alpha, x0)            # dead
        return (g.apply(lib.scal, alpha, x1),)

    cc = FusionCompiler(device="cpu", cache=None)
    with pytest.raises(VerificationError) as ei:
        cc.compile(script, {"x0": (N,), "x1": (N,), "alpha": ()},
                   mode="unfused")
    assert ei.value.codes == ("RPL204",)


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusionCompiler()
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--blas", "VADD", "--n", str(N), "--requests", "1"])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_serve_blas_on_cpu_end_to_end(backend, capsys):
    res = serve.main(["--blas", "AXPYDOT", "--n", str(N), "--requests", "3",
                      "--device", "cpu", "--backend", backend])
    assert res["device"] == "cpu" and res["n_groups"] == 1
    assert res["us_per_request"] > 0
    assert res["kernel_launches"] == 0          # CPU: no kernel launched
    assert res["cache"]["program_hits"] == 1
    assert "serve AXPYDOT" in capsys.readouterr().out


def test_serve_autotune_refit_on_cpu(capsys):
    """``--autotune`` is the one switch for the measured search: it
    calibrates, measures, refits and recompiles; ``--mode autotune`` is
    refused."""
    res = serve.main(["--blas", "GEMVER", "--autotune", "--refit",
                      "--budget", "2", "--n", "64", "--requests", "2",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "autotune budget=2: winner #" in out and "refit: " in out
    assert "(measured, 0/" in out and res["us_per_request"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--blas", "VADD", "--mode", "autotune",
                    "--device", "cpu"])
    assert "--autotune" in capsys.readouterr().err


def test_serve_rejects_unknown_backend():
    with pytest.raises(VerificationError) as ei:
        serve.main(["--blas", "VADD", "--backend", "jnp", "--device", "cpu"])
    assert ei.value.codes == ("RPL401",)


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port leaves neither ``jax`` nor the
    reference package ``repro`` in ``sys.modules``."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'"
        " or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print(json.dumps({'mods': mods, 'bad': bad}))\n")
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("core.cuda_codegen", "launch.serve", "kernels.ops",
                "kernels.ref", "kernels.bicgk", "kernels.gemver",
                "kernels.rmsnorm", "kernels.decode_attention",
                "kernels.adamw", "kernels.softmax_xent", "optim",
                "optim.fused", "programs.models", "programs.model_lib",
                "configs", "configs.base", "configs.llama3_8b",
                "models.common", "models.model", "models.forward",
                "models.convert", "train.steps", "examples.serve_lm"):
        assert f"repro_torch.{mod}" in res["mods"]
