"""The rest of the compiler surface, the port against the reference:
``compile(report=True)`` and its ``CompileReport``, ``compile_all``,
``oracle``, ``compile_combination``, ``plan_fingerprint`` and the seed's
exhaustive search (the DP's reference), and the ported examples.

Plans and impls are compared by their ``describe()`` text (fusion,
order, blocks, grid, traffic, predicted time); numerics to the reference
envelope, rtol 1e-4, atol 1e-3.
"""
import numpy as np
import pytest

from repro.core import FusionCompiler as RefCompiler
from repro.core import scheduler as rsched
from repro.core.plan import plan_fingerprint as ref_fingerprint
from repro.programs import REGISTRY as REF_REGISTRY

from repro_torch.core import (FusionCompiler, PlanCache, compile_combination,
                              exhaustive_best_combination, plan_fingerprint)
from repro_torch.core import scheduler
from repro_torch.examples import custom_sequence, quickstart
from repro_torch.programs import BLAS, REGISTRY, make_inputs
from torch_threads import capped_torch_threads  # noqa: F401

N = 256


def _desc(combo):
    return [im.describe() for im in combo.impls], combo.t_pred


@pytest.mark.parametrize("name", ["GEMVER", "BiCGK", "AXPYDOT",
                                  "LM_DECODE_ATTN", "GESUMMV"])
def test_compile_report_equals_the_reference(name):
    shapes = REGISTRY[name].shapes(N)
    prog, rep = FusionCompiler(device="cpu", cache=PlanCache()).compile(
        REGISTRY[name].script, shapes, report=True)
    _, rrep = RefCompiler(cache=None).compile(REF_REGISTRY[name].script,
                                              shapes, report=True)
    assert (rep.n_fusions, rep.n_impls, rep.n_combinations) == (
        rrep.n_fusions, rrep.n_impls, rrep.n_combinations)
    assert _desc(rep.best) == _desc(rrep.best)
    assert _desc(rep.unfused) == _desc(rrep.unfused)
    assert rep.predicted_speedup == pytest.approx(rrep.predicted_speedup)
    env = make_inputs(REGISTRY[name], N, seed=2)
    out = prog(**env)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    REGISTRY[name].reference(**env)):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-3)


def test_report_bypasses_the_caches():
    cache = PlanCache()
    cc = FusionCompiler(device="cpu", cache=cache)
    seq = BLAS["ATAX"]
    cc.compile(seq.script, seq.shapes(N), report=True)
    assert cache.stats.program_misses == cache.stats.plan_misses == 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_compile_all_rank_i_is_compile_mode_i(backend):
    seq = BLAS["BiCGK"]
    cache = PlanCache()
    cc = FusionCompiler(backend=backend, device="cpu", cache=cache)
    cands = cc.compile_all(seq.script, seq.shapes(N), limit=6)
    rcands = RefCompiler(cache=None).compile_all(
        REF_REGISTRY["BiCGK"].script, seq.shapes(N), limit=6)
    assert len(cands) == len(rcands) == 6
    for i, ((combo, prog), (rcombo, _)) in enumerate(zip(cands, rcands)):
        assert _desc(combo) == _desc(rcombo)
        assert cc.compile(seq.script, seq.shapes(N), mode=i) is prog
    hits = cache.stats.program_hits
    again = cc.compile_all(seq.script, seq.shapes(N), limit=6)
    assert [p for _, p in again] == [p for _, p in cands]
    assert cache.stats.program_hits == hits + 6
    # a limit past the space stops at its last combination
    small = BLAS["SSCAL"]
    assert len(cc.compile_all(small.script, small.shapes(N), limit=50)) == \
        len(rsched.enumerate_combinations(RefCompiler(cache=None).space(
            RefCompiler(cache=None).trace(REF_REGISTRY["SSCAL"].script,
                                          small.shapes(N))), limit=50))


@pytest.mark.parametrize("name", ["GEMVER", "LM_DECODE_ATTN", "FUSED_ADAMW"])
def test_oracle_agrees_with_the_reference(name):
    shapes = REGISTRY[name].shapes(N)
    env = make_inputs(REGISTRY[name], N, seed=6)
    got = FusionCompiler(device="cpu").oracle(REGISTRY[name].script,
                                              shapes)(**env)
    want = RefCompiler(cache=None).oracle(REF_REGISTRY[name].script,
                                          shapes)(**env)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for o, w in zip(got, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_exhaustive_search_agrees_with_the_dp(name):
    cc = FusionCompiler(device="cpu", cache=None)
    space = cc.space(cc.trace(REGISTRY[name].script,
                              REGISTRY[name].shapes(N)))
    ex = exhaustive_best_combination(space)
    dp = scheduler.best_combination(space)
    assert ex.t_pred == pytest.approx(dp.t_pred, rel=1e-12)
    rc = RefCompiler(cache=None)
    rex = rsched.exhaustive_best_combination(rc.space(rc.trace(
        REF_REGISTRY[name].script, REF_REGISTRY[name].shapes(N))))
    assert _desc(ex) == _desc(rex)


def test_plan_fingerprint_and_compile_combination():
    seq = BLAS["GEMVER"]
    cc = FusionCompiler(device="cpu", cache=None)
    best = cc.compile(seq.script, seq.shapes(N))
    unfused = cc.compile(seq.script, seq.shapes(N), mode="unfused")
    rplan = RefCompiler(cache=None).compile(REF_REGISTRY["GEMVER"].script,
                                            seq.shapes(N)).plan
    assert plan_fingerprint(best.plan) != plan_fingerprint(unfused.plan)
    import dataclasses
    assert plan_fingerprint(dataclasses.replace(best.plan, backend="jnp")) \
        == ref_fingerprint(dataclasses.replace(rplan, backend="jnp"))
    g = cc.trace(seq.script, seq.shapes(N))
    prog = compile_combination(g, cc.search(cc.space(g), "best"),
                               backend="cuda", device="cpu")
    assert prog.plan.to_json() == best.plan.to_json()
    env = make_inputs(seq, N, seed=1)
    for o, r in zip(prog(**env), seq.reference(**env)):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-3)


def test_examples_run_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu", "--n", "256"])
    custom_sequence.main(["--device", "cpu", "--n", "4096"])
    out = capsys.readouterr().out
    assert "matches numpy oracle" in out and "custom fused sequence" in out
