"""Batched and packed programs, and the packed-plan layer, the port
against the reference.

* ``PackedPlan.to_json``, ``pack_signature`` and ``canonical_pack_order``
  equal the reference's for the same member mixes (plans mapped to the
  reference's backend names, which is all that differs).
* Batched and packed programs on the ``torch`` backend and on the
  ``cuda`` backend with CPU tensors (K1's plain tiled version) match the
  reference's ``compile_batched`` / ``compile_packed`` (``jnp``) on the
  same requests: norm-relative 1e-5 in float32 (sums in another order).
* On the CPU a batched program's outputs are bitwise those of B single
  calls, and a pack's bitwise those of its members' batched programs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import FusionCompiler as RefCompiler
from repro.core import PlanCache as RefCache
from repro.core import plan as rplan
from repro.programs import REGISTRY as REF_REGISTRY

from repro_torch.core import (FusionCompiler, PackedPlan, PlanCache,
                              build_packed_plan, canonical_pack_order,
                              pack_signature, plan_fingerprint)
from repro_torch.core.diagnostics import VerificationError
from repro_torch.programs import REGISTRY, make_inputs
from torch_threads import capped_torch_threads  # noqa: F401

RTOL = 1e-5
#: port backend -> the reference's name for it
TO_REF = {"torch": "jnp", "cuda": "pallas"}
MIXES = [["AXPYDOT", "VADD"], ["GEMVER", "BiCGK", "AXPYDOT", "SSCAL"],
         ["LM_RMSNORM", "ATAX", "GESUMMV"]]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got - want))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _plans(names, n=128, backend="torch"):
    cc = FusionCompiler(backend=backend, device="cpu", cache=None)
    rc = RefCompiler(backend=TO_REF[backend], cache=None)
    ours, ref = [], []
    for nm in names:
        shapes = REGISTRY[nm].shapes(n)
        ours.append(cc.compile(REGISTRY[nm].script, shapes).plan)
        ref.append(rc.compile(REF_REGISTRY[nm].script, shapes).plan)
    return ours, ref


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("names", MIXES)
def test_packed_plan_equals_the_reference(names, backend):
    ours, ref = _plans(names, backend=backend)
    mapped = [dataclasses.replace(p, backend=TO_REF[backend]) for p in ours]
    for order in (list(range(len(names))), list(range(len(names)))[::-1]):
        mine = [mapped[i] for i in order]
        theirs = [ref[i] for i in order]
        assert canonical_pack_order(mine) == rplan.canonical_pack_order(
            theirs)
        assert build_packed_plan(mine).to_json() == \
            rplan.build_packed_plan(theirs).to_json()
        assert pack_signature([plan_fingerprint(p) for p in mine]) == \
            rplan.pack_signature([rplan.plan_fingerprint(p) for p in theirs])
    pk, rpk = build_packed_plan(mapped), rplan.build_packed_plan(ref)
    assert pk.signature == rpk.signature
    assert (pk.input_offsets, pk.group_offsets, pk.output_offsets) == (
        rpk.input_offsets, rpk.group_offsets, rpk.output_offsets)
    assert pk.merged_outputs() == rpk.merged_outputs()
    assert [(m, g.to_dict()) for m, g in pk.merged_groups()] == \
        [(m, g.to_dict()) for m, g in rpk.merged_groups()]


def test_packed_plan_validates_order_and_version():
    ours, _ = _plans(["AXPYDOT", "VADD", "SSCAL"])
    pk = build_packed_plan(ours)
    assert PackedPlan.from_json(pk.to_json()).to_json() == pk.to_json()
    with pytest.raises(VerificationError, match="RPL301"):
        PackedPlan(members=pk.members[::-1])
    bad = json.loads(pk.to_json())
    bad["version"] = 99
    with pytest.raises(VerificationError, match="RPL302"):
        PackedPlan.from_json(json.dumps(bad))


def _batch(name, n, B, seed):
    per = [make_inputs(REGISTRY[name], n, seed=seed + b) for b in range(B)]
    return per, {k: np.stack([np.asarray(p[k]) for p in per])
                 for k in per[0]}


CASES = [("GEMVER", 128), ("BiCGK", 100), ("AXPYDOT", 300),
         ("LM_RMSNORM", 256), ("LM_DECODE_ATTN", 256), ("ATAX", 64)]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name,n", CASES)
def test_batched_program_matches_the_reference_and_single_calls(name, n,
                                                                backend):
    B = 3
    cc = FusionCompiler(backend=backend, device="cpu", cache=PlanCache())
    prog = cc.compile_batched(REGISTRY[name].script, REGISTRY[name].shapes(n))
    single = cc.compile(REGISTRY[name].script, REGISTRY[name].shapes(n))
    ref = RefCompiler(cache=RefCache()).compile_batched(
        REF_REGISTRY[name].script, REF_REGISTRY[name].shapes(n))
    per, stacked = _batch(name, n, B, seed=11)
    got = _as_tuple(prog(**stacked))
    want = _as_tuple(ref(**stacked))
    assert len(got) == len(want)
    for o, w in zip(got, want):
        assert tuple(o.shape) == np.shape(w)
        assert _rel(o.numpy(), w) <= RTOL
    for b in range(B):
        for o, s in zip(got, _as_tuple(single(**per[b]))):
            assert torch.equal(o[b], s)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_packed_program_matches_the_reference_and_its_members(backend):
    members = [("GEMVER", 128), ("LM_DECODE_ATTN", 256), ("AXPYDOT", 300),
               ("BiCGK", 100)]
    cc = FusionCompiler(backend=backend, device="cpu", cache=PlanCache())
    rc = RefCompiler(cache=RefCache())
    pack = cc.compile_packed([(REGISTRY[s].script, REGISTRY[s].shapes(n))
                              for s, n in members])
    rpack = rc.compile_packed([(REF_REGISTRY[s].script,
                                REF_REGISTRY[s].shapes(n))
                               for s, n in members])
    # (the canonical orders differ only because fingerprints hash the
    # backend name: test_packed_plan_equals_the_reference maps it)
    assert sorted(pack.perm) == sorted(rpack.perm) == [0, 1, 2, 3]
    assert pack.program.packed.n_members == 4
    # members may carry different batch sizes
    inputs = [_batch(s, n, 1 + k % 3, seed=20 + k)[1]
              for k, (s, n) in enumerate(members)]
    got, want = pack(inputs), rpack(inputs)
    for (s, n), ins, outs, routs in zip(members, inputs, got, want):
        batched = cc.compile_batched(REGISTRY[s].script, REGISTRY[s].shapes(n))
        for o, ro, bo in zip(outs, routs, _as_tuple(batched(**ins))):
            assert _rel(o.numpy(), ro) <= RTOL
            assert torch.equal(o, bo)


def test_reordered_members_hit_the_program_cache():
    cc = FusionCompiler(backend="cuda", device="cpu", cache=PlanCache())

    def members(names):
        return [(REGISTRY[s].script, REGISTRY[s].shapes(128)) for s in names]
    d1 = cc.compile_packed(members(["AXPYDOT", "VADD", "SSCAL"]))
    hits0 = cc.cache.stats.program_hits
    d2 = cc.compile_packed(members(["SSCAL", "AXPYDOT", "VADD"]))
    assert cc.cache.stats.program_hits == hits0 + 1
    assert d2.program is d1.program
    a, v, s = (_batch(nm, 128, 2, seed=k)[1]
               for k, nm in enumerate(["AXPYDOT", "VADD", "SSCAL"]))
    o1, o2 = d1([a, v, s]), d2([s, a, v])
    for x, y in zip(o1[0], o2[1]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="at least one"):
        cc.compile_packed([])


def test_packed_plan_disk_layer(tmp_path):
    def members():
        return [(REGISTRY[s].script, REGISTRY[s].shapes(128))
                for s in ("AXPYDOT", "VADD")]
    c1 = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
    c1.compile_packed(members())
    assert c1.cache.stats.pack_writes == 1
    (path,) = tmp_path.glob("*.pack.json")
    c2 = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
    d = c2.compile_packed(members())
    assert c2.cache.stats.pack_disk_hits == 1
    assert len(d([_batch("AXPYDOT", 128, 2, 0)[1],
                  _batch("VADD", 128, 2, 1)[1]])) == 2
    # a corrupt entry is dropped and republished, never served
    path.write_text("{not json")
    c3 = FusionCompiler(device="cpu", cache=PlanCache(disk_dir=str(tmp_path)))
    c3.compile_packed(members())
    assert c3.cache.stats.pack_disk_hits == 0
    assert c3.cache.stats.pack_writes == 1
    assert PackedPlan.from_json(path.read_text()).n_members == 2
    c3.cache.drop_packed_plan(path.name[:-len(".pack.json")])
    assert not path.exists()
