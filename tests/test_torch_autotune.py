"""The port's empirical autotune, calibration and refit against the JAX
reference (``repro.core.autotune``), on the CPU.

Measurement is the one thing the two packages cannot share, so the
parity tests patch ``measure_group`` — the seam every fresh measurement
goes through — in both with the same deterministic function of a group's
``(traffic_bytes, flops, order, blocks)``.  The two must then pick the
same candidates (``combination_key``), the same winner and count the
same measurements and table hits, a warm second pass through a shared
disk dir included.  ``refit`` is numpy on both sides and must give equal
constants on the same records.  Numerics are held as the port's other
CPU tests hold them: outputs within 1e-5 of ``best``'s.
"""
import json
import math

import numpy as np
import pytest

import repro.core.autotune as ref_at
from repro.core import PlanCache as RefCache
from repro.core import V5E as REF_V5E
from repro.core import build_space as ref_build_space
from repro.core import trace as ref_trace
from repro.programs import REGISTRY as REF_REGISTRY
from repro_torch.core import (V5E, FusionCompiler, PlanCache, build_space,
                              enumerate_combinations, trace)
from repro_torch.core import autotune
from repro_torch.core.cuda_codegen import GroupLayout
from repro_torch.programs import BLAS, REGISTRY, make_inputs
from repro_torch.serving import ServingEngine
from torch_threads import capped_torch_threads  # noqa: F401

PARITY = sorted(BLAS) + ["LM_RMSNORM"]
N = 256


def _stub_time(traffic, flops, order, blocks) -> float:
    """A deterministic 'measurement': the roofline at round constants
    plus a term that depends on the grid order and the tiles, so that
    candidates with equal traffic still rank apart."""
    wiggle = sum((i + 1) * b for i, b in enumerate(blocks)) % 13
    return (2e-6 + traffic / 1e11 + flops / 1e13 + 1e-8 * wiggle
            + 1e-9 * (sum(order) % 7))


@pytest.fixture
def stubbed(monkeypatch):
    calls = {"ref": 0, "port": 0}

    def make(side):
        def measure(g, im, **kw):
            calls[side] += 1
            return _stub_time(im.traffic_bytes, im.flops, im.order,
                              im.blocks)
        return measure

    monkeypatch.setattr(ref_at, "measure_group", make("ref"))
    monkeypatch.setattr(autotune, "measure_group", make("port"))
    return calls


def _report_view(rep):
    return {"keys": [c.key for c in rep.candidates],
            "t_meas": [c.t_meas for c in rep.candidates],
            "sources": [c.source for c in rep.candidates],
            "groups": [(c.n_groups, c.n_groups_cached)
                       for c in rep.candidates],
            "winner": rep.winner_index, "n_measured": rep.n_measured,
            "n_cached": rep.n_cached,
            "n_groups_measured": rep.n_groups_measured,
            "n_groups_cached": rep.n_groups_cached,
            "hit_rate": rep.group_table_hit_rate}


@pytest.mark.parametrize("name", PARITY)
def test_autotune_matches_reference_under_the_same_stub(name, stubbed,
                                                        tmp_path):
    prog, ref_prog = REGISTRY[name], REF_REGISTRY[name]
    g = trace(prog.script, prog.shapes(N))
    rg = ref_trace(ref_prog.script, ref_prog.shapes(N))
    views = {}
    for warm in (False, True):
        _, _, rep = autotune.autotune_combination(
            build_space(g), hw=V5E, backend="cuda", device="cpu",
            cache=PlanCache(disk_dir=str(tmp_path / "port")), budget=8)
        _, _, rrep = ref_at.autotune_combination(
            ref_build_space(rg), hw=REF_V5E, backend="jnp",
            cache=RefCache(disk_dir=str(tmp_path / "ref")), budget=8)
        views[warm] = _report_view(rep)
        assert views[warm] == _report_view(rrep)
        for c, rc in zip(rep.candidates, rrep.candidates):
            assert math.isclose(c.t_pred, rc.t_pred, rel_tol=1e-12)
    assert views[True]["n_groups_measured"] == 0
    assert views[True]["hit_rate"] == 1.0
    assert views[True]["winner"] == views[False]["winner"]
    # the reference times a group twice when one candidate holds it twice;
    # the port times each distinct group once, and counts as it does
    assert stubbed["ref"] == views[False]["n_groups_measured"]
    assert stubbed["port"] == len(list((tmp_path / "port").glob("*.meas*")))
    assert stubbed["port"] <= stubbed["ref"]


def test_compile_autotune_caches_the_winner_and_measures_once(stubbed):
    prog = REGISTRY["GEMVER"]
    cache = PlanCache()
    cc = FusionCompiler(device="cpu", cache=cache, autotune_budget=4)
    cp = cc.compile(prog.script, prog.shapes(N), mode="autotune")
    rep = cc.last_autotune
    assert rep is not None and rep.budget == 4
    assert cp.plan.backend == "cuda"
    assert stubbed["port"] == rep.n_groups_measured > 0
    cc.compile(prog.script, prog.shapes(N), mode="autotune")
    assert stubbed["port"] == rep.n_groups_measured   # served from cache
    assert cc._mode_key("autotune") == ("autotune", 4)
    assert cache.stats.meas_writes == 0              # no disk dir
    assert len(cache.group_records()) == rep.n_groups_measured


def test_engine_and_packed_compiles_accept_autotune(stubbed):
    cc = FusionCompiler(device="cpu", cache=PlanCache(), autotune_budget=2)
    engine = ServingEngine(cc, max_batch=2, min_bucket=64,
                           registry=REGISTRY, mode="autotune")
    seq = REGISTRY["AXPYDOT"]
    res = engine.serve([("AXPYDOT", 100, make_inputs(seq, 100, seed=1))])
    want = seq.reference(**make_inputs(seq, 100, seed=1))
    for o, w in zip(res[0].outputs, want):
        np.testing.assert_allclose(np.asarray(o), w, rtol=1e-5, atol=1e-5)
    a, b = REGISTRY["AXPYDOT"], REGISTRY["VADD"]
    pack = cc.compile_packed([(a.script, a.shapes(64)),
                              (b.script, b.shapes(64))], mode="autotune")
    assert pack.program.n_members == 2


def test_refit_matches_reference_on_the_same_records(stubbed, tmp_path):
    cache = PlanCache(disk_dir=str(tmp_path))
    for name in ("GEMVER", "BiCGK", "AXPYDOT", "ATAX"):
        g = trace(REGISTRY[name].script, REGISTRY[name].shapes(N))
        autotune.autotune_combination(build_space(g), device="cpu",
                                      cache=cache, budget=4)
    records = cache.group_records()
    assert len(records) >= 3
    got, want = V5E.refit(records), REF_V5E.refit(records)
    for k in ("name", "hbm_bw", "peak_flops", "f32_scale",
              "launch_overhead_s"):
        assert getattr(got, k) == getattr(want, k)
    assert got != V5E
    # a store too small to regress is a no-op, as in the reference
    assert V5E.refit(records[:2]) is V5E
    # and refit_hardware regresses over what the compiler's cache holds
    cc = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
    assert cc.refit_hardware() == got


def test_calibration_on_cpu_is_finite_and_first_writer_wins(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(autotune, "_CALIBRATED", {})
    small = (1 << 14, 1 << 15, 1 << 16)
    real_sweep = autotune.bandwidth_sweep
    monkeypatch.setattr(autotune, "bandwidth_sweep",
                        lambda dev, reps=3: real_sweep(dev, reps=reps,
                                                       sizes=small))
    monkeypatch.setattr(autotune, "MATMUL_CPU", 64)
    first = PlanCache(disk_dir=str(tmp_path))
    hw = autotune.calibrate_hardware("cpu", cache=first)
    assert hw.name == "calibrated_cpu" and hw.f32_scale == 1.0
    for v in (hw.hbm_bw, hw.peak_flops, hw.launch_overhead_s):
        assert math.isfinite(v) and v > 0
    assert (hw.vmem_bytes, hw.min_tile) == (V5E.vmem_bytes, V5E.min_tile)
    rec = json.loads(next(tmp_path.glob("*.meas.json")).read_text())
    assert rec["kind"] == "calibration" and len(rec["bw_sweep"]) == 3
    # a second process measures anew but adopts the first record
    monkeypatch.setattr(autotune, "_CALIBRATED", {})
    second = PlanCache(disk_dir=str(tmp_path))
    hw2 = autotune.calibrate_hardware("cpu", cache=second, force=True)
    assert hw2 == hw
    cc = FusionCompiler(hw="calibrate", device="cpu", cache=second)
    assert cc.hw == hw
    with pytest.raises(ValueError, match="calibrate"):
        FusionCompiler(hw="fast", device="cpu")


def test_calibrate_on_cuda_without_a_gpu_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        autotune.calibrate_hardware("cuda", cache=PlanCache())


def _no_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(autotune, "_CALIBRATED", {})


def _axpydot_impl():
    g = trace(REGISTRY["AXPYDOT"].script, REGISTRY["AXPYDOT"].shapes(N))
    return g, enumerate_combinations(build_space(g))[0].impls[0]


@pytest.mark.parametrize("entry", [
    "calibrate_hardware", "HardwareModel.calibrate", "measure_group",
    "hw_fingerprint", "predict_combination", "autotune_combination"])
def test_measuring_entry_points_without_a_device_need_the_card(entry,
                                                               monkeypatch):
    """Called without a device, every measuring entry point asks for the
    card: on a machine without CUDA it raises and returns no CPU
    numbers.  The CPU is measured only as ``device="cpu"``."""
    _no_card(monkeypatch)
    g, im = _axpydot_impl()
    calls = {
        "calibrate_hardware": lambda: autotune.calibrate_hardware(
            cache=PlanCache()),
        "HardwareModel.calibrate": lambda: type(V5E).calibrate(),
        "measure_group": lambda: autotune.measure_group(g, im),
        "hw_fingerprint": lambda: autotune.hw_fingerprint(),
        "predict_combination": lambda: autotune.predict_combination(
            g, enumerate_combinations(build_space(g))[0], V5E),
        "autotune_combination": lambda: autotune.autotune_combination(
            build_space(g), cache=PlanCache(), budget=1),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[entry]()


def test_measured_search_on_the_cpu_only_when_asked(monkeypatch):
    """``device="cpu"`` still measures on the host: ``measure_group``
    and the compiler's measured search."""
    _no_card(monkeypatch)
    monkeypatch.setattr(autotune, "MEAS_REPS", 1)
    g, im = _axpydot_impl()
    t = autotune.measure_group(g, im, device="cpu", reps=1, warmup=0,
                               inner=1)
    assert math.isfinite(t) and t > 0
    prog = REGISTRY["AXPYDOT"]
    cc = FusionCompiler(device="cpu", cache=PlanCache(), autotune_budget=1)
    cp = cc.compile(prog.script, prog.shapes(N), mode="autotune")
    assert cc.last_autotune.n_groups_measured > 0
    want = prog.reference(**make_inputs(prog, N, seed=2))
    for o, w in zip(cp(**make_inputs(prog, N, seed=2)), want):
        np.testing.assert_allclose(o.numpy(), w, rtol=1e-5, atol=1e-5)


def test_corrupt_measurement_entry_is_healed(stubbed, tmp_path):
    g = trace(REGISTRY["AXPYDOT"].script, REGISTRY["AXPYDOT"].shapes(N))
    cache = PlanCache(disk_dir=str(tmp_path))
    _, _, rep = autotune.autotune_combination(build_space(g), device="cpu",
                                              cache=cache, budget=2)
    entries = sorted(tmp_path.glob("*.meas.json"))
    assert len(entries) == rep.n_groups_measured
    entries[0].write_text("{torn")                   # unreadable
    entries[-1].write_text(json.dumps({"kind": "program"}))   # foreign
    fresh = PlanCache(disk_dir=str(tmp_path))
    _, _, rep2 = autotune.autotune_combination(build_space(g), device="cpu",
                                               cache=fresh, budget=2)
    healed = {entries[0], entries[-1]}
    assert rep2.n_groups_measured == len(healed)
    for e in healed:                                  # republished
        assert json.loads(e.read_text())["kind"] == "group"
    assert rep2.winner_index == rep.winner_index


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_real_autotune_on_cpu_matches_best(backend):
    prog = REGISTRY["GEMVER"]
    n = 64
    cc = FusionCompiler(backend=backend, device="cpu", cache=PlanCache(),
                        autotune_budget=2, autotune_reps=1)
    tuned = cc.compile(prog.script, prog.shapes(n), mode="autotune")
    rep = cc.last_autotune
    assert rep.n_groups_measured > 0
    assert all(c.t_meas > 0 for c in rep.candidates)
    assert rep.winner.t_meas <= rep.candidates[0].t_meas
    best = cc.compile(prog.script, prog.shapes(n), mode="best")
    inputs = make_inputs(prog, n, seed=5)
    for o, w in zip(tuned(**inputs), best(**inputs)):
        np.testing.assert_allclose(np.asarray(o), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


SMOKE_SIZES = {"AXPYDOT": 1 << 24, "VADD": 1 << 24, "WAXPBY": 1 << 24,
               "SSCAL": 1 << 24, "FUSED_ADAMW": 1 << 24,
               "LM_DECODE_ATTN": 131072}


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_every_top8_candidate_group_has_a_cuda_layout(name):
    """Every group of the 8 best predicted candidates of every program, at
    the widths the card's smoke run tunes them at, is one K1 can emit:
    no candidate is left out of a pass on the card."""
    prog = REGISTRY[name]
    g = trace(prog.script, prog.shapes(SMOKE_SIZES.get(name, 4096)))
    combos = enumerate_combinations(build_space(g), limit=8)
    assert combos
    for combo in combos:
        for im in combo.impls:
            GroupLayout(g, im)
