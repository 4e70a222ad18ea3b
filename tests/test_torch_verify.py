"""The port's static verifier (``repro_torch.analysis``) against the JAX
reference's (``repro.analysis``), on the CPU.

On the same plan JSON both verifiers must return the same codes: for the
``best`` and ``unfused`` plans of all 15 programs, and for the
reference's own corruption cases (``tests/test_analysis_verify.py``)
plus the other mutations below.  RPL214 and RPL215 take their Hopper
meaning on the ``cuda`` backend (K1's layout and its shared memory), so
their cases compare a ``pallas`` plan against the same plan on ``cuda``.
The compile path is checked as the reference's is: a corrupt cache
entry is rejected before it runs, dropped and recompiled, with outputs
within 1e-6 of an uncorrupted compile.
"""
import json
import logging

import numpy as np
import pytest

from repro.analysis import verify_plan as ref_verify_plan
from repro.core import build_space as ref_build_space
from repro.core import trace as ref_trace
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.plan import build_plan as ref_build_plan
from repro.core.scheduler import best_combination as ref_best
from repro.core.scheduler import unfused_combination as ref_unfused
from repro.programs import REGISTRY as REF_REGISTRY
from repro_torch.analysis import (VerificationError, verify_pack,
                                  verify_plan, verify_plan_quick)
from repro_torch.analysis.cli import lint_cache_dir, main as cli_main
from repro_torch.core import (ExecutionPlan, FusionCompiler, PlanCache,
                              build_packed_plan, build_plan,
                              compile_combination, plan_from_reference,
                              trace)
from repro_torch.programs import REGISTRY, make_inputs
from torch_threads import capped_torch_threads  # noqa: F401

BACKENDS = {"jnp": "torch", "pallas": "cuda"}


def _ref_plan(name, n=128, mode="best", backend="pallas"):
    prog = REF_REGISTRY[name]
    rg = ref_trace(prog.script, prog.shapes(n))
    space = ref_build_space(rg)
    combo = ref_best(space) if mode == "best" else ref_unfused(space)
    return ref_build_plan(rg, combo, backend=backend), rg


def _codes(diags):
    return sorted(d.code for d in diags)


def _both(d, name, n=128, vmem_budget=None, smem_budget=None):
    """Codes of the reference's and the port's verifier on plan dict
    ``d`` (the reference's JSON; the port reads it with its backend
    renamed)."""
    prog, ref_prog = REGISTRY[name], REF_REGISTRY[name]
    rg = ref_trace(ref_prog.script, ref_prog.shapes(n))
    g = trace(prog.script, prog.shapes(n))
    ref = ref_verify_plan(RefPlan.from_json(json.dumps(d)), rg,
                          vmem_budget=vmem_budget)
    port = verify_plan(plan_from_reference(json.dumps(d)), g,
                       smem_budget=smem_budget)
    return _codes(ref), _codes(port)


@pytest.mark.parametrize("mode", ["best", "unfused"])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_same_codes_as_reference_on_every_plan(name, mode):
    for backend in BACKENDS:
        plan, _ = _ref_plan(name, n=256, mode=mode, backend=backend)
        ref, port = _both(json.loads(plan.to_json()), name, n=256)
        assert ref == port == []


def _swap_inputs(d):
    refs = d["groups"][0]["inputs"]
    a, b = (i for i, r in enumerate(refs)
            if r[0] == "input" and r[1] in ("w", "v"))
    refs[a], refs[b] = refs[b], refs[a]
    return d


def _drop_groups(d):
    d["groups"] = []
    d["outputs"] = [["input", d["input_names"][0]]] * len(d["outputs"])
    return d


def _set(path, value):
    def mutate(d):
        node = d
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
        return d
    return mutate


#: (program, mutation of the reference's plan dict) -> both verifiers
#: must return the same codes, and at least one
CORRUPTIONS = {
    "swapped_routing_ref": ("AXPYDOT", _swap_inputs),
    "dropped_groups": ("AXPYDOT", _drop_groups),
    "group_ref_past_end": ("GEMVER", _set(["outputs", 0], ["group", 9, 0])),
    "group_reads_later_group": ("GEMVER",
                                _set(["groups", 0, "inputs", 0],
                                     ["group", 1, 0])),
    "order_not_a_permutation": ("GEMVER",
                                _set(["groups", 0, "order_pos"], [0, 0])),
    "block_zero": ("GEMVER", _set(["groups", 0, "blocks"], [0, 128])),
    "block_past_axis": ("GEMVER",
                        _set(["groups", 0, "blocks"], [128, 1 << 20])),
    "wrong_dtype": ("VADD", _set(["dtype"], "float64")),
    "negative_t_pred": ("VADD", _set(["t_pred"], -1.0)),
    "inputs_reordered": ("GEMVER", lambda d: _set(
        ["input_names"], list(reversed(d["input_names"])))(d)),
    "zero_output_group": ("VADD", _set(["groups", 0, "n_outputs"], 0)),
    "duplicate_call": ("GEMVER", lambda d: _set(
        ["groups", 1, "calls"], list(d["groups"][0]["calls"]))(d)),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_same_codes_as_reference_on_corrupted_plans(case):
    name, mutate = CORRUPTIONS[case]
    checked = 0
    for mode in ("best", "unfused"):
        plan, _ = _ref_plan(name, mode=mode)
        d = json.loads(plan.to_json())
        try:
            d = mutate(d)
        except (IndexError, ValueError):
            continue                   # one-group plan: no group 1 to edit
        ref, port = _both(d, name)
        assert ref == port
        assert ref, f"{case}/{mode}: no code for a corrupted plan"
        checked += 1
    assert checked


def test_signature_mismatch_rpl210():
    plan, _ = _ref_plan("AXPYDOT")
    g2 = trace(REGISTRY["VADD"].script, REGISTRY["VADD"].shapes(128))
    assert "RPL210" in _codes(
        verify_plan_quick(plan_from_reference(plan.to_json()), g2))


def test_rpl215_is_the_shared_memory_budget_on_cuda():
    plan, _ = _ref_plan("GEMVER", n=256)
    ref, port = _both(json.loads(plan.to_json()), "GEMVER", n=256,
                      vmem_budget=1, smem_budget=1)
    assert "RPL215" in ref and "RPL215" in port
    # and nothing is held to a budget on the dense backend
    plan, _ = _ref_plan("GEMVER", n=256, backend="jnp")
    g = trace(REGISTRY["GEMVER"].script, REGISTRY["GEMVER"].shapes(256))
    assert verify_plan(plan_from_reference(plan.to_json()), g,
                       smem_budget=1) == []


def test_rpl214_is_k1s_layout_on_cuda():
    """ATAX's fused group with gemv's reduce axis outermost: the
    reference's phase contract and K1's layout both refuse it."""
    plan, _ = _ref_plan("ATAX", n=256)
    d = json.loads(plan.to_json())
    fused = [i for i, gp in enumerate(d["groups"])
             if len(gp["calls"]) == 2]
    assert fused
    d["groups"][fused[0]]["order_pos"] = list(
        reversed(d["groups"][fused[0]]["order_pos"]))
    ref, port = _both(d, "ATAX", n=256)
    assert ref == port == ["RPL214"]


# ---------------------------------------------------------------------------
# compile-path wiring: always-on rejection and healing
# ---------------------------------------------------------------------------

def _corrupt_disk_plan(tmp_path, mutate):
    seq = REGISTRY["AXPYDOT"]
    shapes = seq.shapes(64)
    cc = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
                        verify=False)
    inputs = make_inputs(seq, 64, seed=3)
    want = [np.asarray(o) for o in cc.compile(seq.script, shapes)(**inputs)]
    (entry,) = tmp_path.glob("*.plan.json")
    entry.write_text(json.dumps(mutate(json.loads(entry.read_text()))))
    return seq, shapes, inputs, want, entry


@pytest.mark.parametrize("verify", [False, True])
def test_corrupt_disk_plan_rejected_healed_and_recompiled(tmp_path, caplog,
                                                          verify):
    mutate = _drop_groups if not verify else _swap_inputs
    seq, shapes, inputs, want, entry = _corrupt_disk_plan(tmp_path, mutate)
    g = trace(seq.script, shapes)
    bad = ExecutionPlan.from_json(entry.read_text())
    # the swapped refs pass the quick subset: only the full pass sees them
    assert bool(verify_plan_quick(bad, g)) != verify
    cache = PlanCache(disk_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING, logger="repro_torch.compiler"):
        cp = FusionCompiler(device="cpu", cache=cache,
                            verify=verify).compile(seq.script, shapes)
    assert "rejected by static verification" in caplog.text
    for w, o in zip(want, cp(**inputs)):
        np.testing.assert_allclose(np.asarray(o), w, rtol=1e-6)
    assert cache.stats.disk_writes == 1
    assert verify_plan(ExecutionPlan.from_json(entry.read_text()), g) == []


def test_corrupt_pack_entry_self_heals(tmp_path, caplog):
    a, b = REGISTRY["AXPYDOT"], REGISTRY["VADD"]
    members = [(a.script, a.shapes(64)), (b.script, b.shapes(64))]
    cc = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
                        verify=False)
    cc.compile_packed(members)
    (entry,) = tmp_path.glob("*.pack.json")
    d = json.loads(entry.read_text())
    # parses, but a member's output reads a group past its slab
    d["members"][0]["outputs"][0] = ["group", 7, 0]
    entry.write_text(json.dumps(d))
    cache = PlanCache(disk_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING):
        pack = FusionCompiler(device="cpu", cache=cache,
                              verify=False).compile_packed(members)
    assert "rejected by static verification" in caplog.text
    assert cache.stats.pack_writes == 1
    ia, ib = make_inputs(a, 64, seed=1), make_inputs(b, 64, seed=2)
    batch = lambda d_: {k: np.asarray(v)[None] for k, v in d_.items()}
    (za, ra), (xb,) = pack([batch(ia), batch(ib)])
    want = a.reference(**ia)
    np.testing.assert_allclose(np.asarray(za)[0], want[0], rtol=1e-5)


def test_verify_pack_clean_on_a_fresh_pack():
    plans, graphs = [], []
    for name in ("AXPYDOT", "VADD"):
        prog = REGISTRY[name]
        g = trace(prog.script, prog.shapes(64))
        cc = FusionCompiler(device="cpu", cache=None)
        plans.append(build_plan(g, cc.search(cc.space(g), "best"),
                                backend="cuda"))
        graphs.append(g)
    packed = build_packed_plan(plans)
    order = [plans.index(p) for p in packed.members]
    assert verify_pack(packed, [graphs[i] for i in order]) == []


@pytest.mark.parametrize("entry", ["compile", "report", "compile_all",
                                   "compile_combination"])
@pytest.mark.parametrize("verify", [False, True])
def test_dead_call_raises_rpl204_at_any_depth(verify, entry, tmp_path):
    """Every path from a trace to a program checks the plan it builds:
    a dead call's zero-output group is RPL204 on each of them."""
    from repro_torch.blas import elementary_lib as lib

    def script(g, x0, x1, alpha):
        g.apply(lib.scal, alpha, x0)            # dead
        return (g.apply(lib.scal, alpha, x1),)

    shapes = {"x0": (64,), "x1": (64,), "alpha": ()}
    cc = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
                        verify=verify)
    with pytest.raises(VerificationError) as ei:
        if entry == "compile":
            cc.compile(script, shapes, mode="unfused")
        elif entry == "report":
            cc.compile(script, shapes, mode="unfused", report=True)
        elif entry == "compile_all":
            cc.compile_all(script, shapes, limit=2)
        else:
            g = trace(script, shapes)
            compile_combination(g, cc.search(cc.space(g), "unfused"),
                                device="cpu")
    assert ei.value.codes == ("RPL204",)
    assert cc.cache.stats.disk_writes == 0      # never published


def test_corrupt_disk_plan_served_to_compile_all_is_healed(tmp_path, caplog):
    """``compile_all`` serves its candidates' plans through the same
    check as ``compile``: a corrupt disk entry is dropped and rebuilt,
    not run."""
    seq = REGISTRY["AXPYDOT"]
    shapes = seq.shapes(64)
    inputs = make_inputs(seq, 64, seed=3)
    (_, prog), = FusionCompiler(
        device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
        verify=False).compile_all(seq.script, shapes, limit=1)
    want = [np.asarray(o) for o in prog(**inputs)]
    (entry,) = tmp_path.glob("*.plan.json")
    entry.write_text(json.dumps(_drop_groups(json.loads(entry.read_text()))))
    cache = PlanCache(disk_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING, logger="repro_torch.compiler"):
        (_, prog), = FusionCompiler(device="cpu", cache=cache,
                                    verify=False).compile_all(
            seq.script, shapes, limit=1)
    assert "rejected by static verification" in caplog.text
    for w, o in zip(want, prog(**inputs)):
        np.testing.assert_allclose(np.asarray(o), w, rtol=1e-6)
    assert cache.stats.disk_writes == 1
    g = trace(seq.script, shapes)
    assert verify_plan(ExecutionPlan.from_json(entry.read_text()), g) == []


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_quick_clean(capsys):
    assert cli_main(["--quick"]) == 0
    out = capsys.readouterr().out
    assert "repro_torch.analysis OK" in out and "0 errors" in out


def test_cli_json_and_unknown_selectors(capsys):
    assert cli_main(["--quick", "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["n_errors"] == 0 and res["n_plans"] == 8
    assert cli_main(["--programs", "NOPE"]) == 1
    assert "RPL402" in capsys.readouterr().out
    assert cli_main(["--backends", "pallas", "--quick"]) == 1
    assert "RPL401" in capsys.readouterr().out


def test_cli_cache_sweep_reports_corruption(tmp_path):
    seq = REGISTRY["AXPYDOT"]
    FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)),
                   verify=False).compile(seq.script, seq.shapes(64))
    (entry,) = tmp_path.glob("*.plan.json")
    entry.write_text("{not json")
    (tmp_path / "zz.meas.json").write_text("[1, 2, 3]")
    diags = lint_cache_dir(str(tmp_path))
    assert sorted(d.code for d in diags) == ["RPL311", "RPL313"]
    assert not any(d.is_error for d in diags)
    assert cli_main(["--quick", "--cache-dir", str(tmp_path)]) == 0
