"""The port's replica-sharded serving on the CPU (``launch.mesh``,
``dist.sharding``, ``FusionCompiler.compile_sharded``,
``ShardedServingEngine``, ``serve --engine --sharded``), mirroring the
reference's replica tests (``tests/test_dist.py``) in one process: a
mesh of CPU replicas stands for XLA's forced host devices.

Tolerances: a sharded request is held bitwise to the single engine's
(each row's result does not depend on its block), and to the float64
numpy oracle within the reference test's 1e-4 (rtol, and atol 1e-4 of
the output's largest magnitude: float32 sums over a request run in
another order than numpy's).
"""
import types

import numpy as np
import pytest
import torch

from repro.core import FusionCompiler as RefCompiler
from repro.core import PlanCache as RefCache
from repro.serving import ShardedServingEngine as RefShardedEngine
from repro.serving import replica_fill as ref_replica_fill
from repro_torch.blas import REGISTRY, make_inputs
from repro_torch.core import FusionCompiler, PlanCache
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.serving import (ServingEngine, ShardedServingEngine,
                                 replica_fill)
from torch_threads import capped_torch_threads  # noqa: F401


def cpu_compiler(cache=None):
    return FusionCompiler(device="cpu",
                          cache=PlanCache() if cache is None else cache)


def bitwise(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


# ---------------------------------------------------------------------------
# routing, as the reference's
# ---------------------------------------------------------------------------

def test_replica_fill_even():
    assert replica_fill(8, 8, 4) == [2, 2, 2, 2]
    assert replica_fill(8, 8, 8) == [1] * 8
    assert replica_fill(16, 16, 1) == [16]


def test_replica_fill_uneven():
    assert replica_fill(5, 8, 4) == [2, 2, 1, 0]
    assert replica_fill(1, 8, 8) == [1, 0, 0, 0, 0, 0, 0, 0]
    assert replica_fill(9, 16, 4) == [4, 4, 1, 0]
    assert replica_fill(3, 8, 2) == [3, 0]
    assert all(sum(replica_fill(k, 16, 8)) == k for k in range(1, 17))
    for R in (1, 2, 4, 8):
        for batch in (R, 2 * R, 4 * R, 8 * R):
            for k in range(batch + 1):
                assert replica_fill(k, batch, R) == \
                    ref_replica_fill(k, batch, R)


@pytest.mark.parametrize("R,max_batch", [(1, 8), (2, 8), (8, 8), (8, 16),
                                         (4, 6), (3, 8)])
def test_dispatch_sizes_are_the_references(R, max_batch):
    """Dispatch sizes ``n_replicas * 2**i``, the trace sizes and the
    rounded ``max_batch`` against the reference engine's (which reads
    only the mesh's axis sizes)."""
    ref = RefShardedEngine(types.SimpleNamespace(shape={"data": R},
                                                 axis_names=("data",)),
                           compiler=RefCompiler(cache=RefCache()),
                           max_batch=max_batch, min_bucket=64)
    ours = ShardedServingEngine(mesh_lib.make_data_mesh(R, device="cpu"),
                                compiler=cpu_compiler(),
                                max_batch=max_batch, min_bucket=64)
    assert (ours.n_replicas, ours.rows_cap, ours.max_batch, ours.max_pack) \
        == (ref.n_replicas, ref.rows_cap, ref.max_batch, ref.max_pack)
    assert ours._trace_sizes() == ref._trace_sizes()
    assert [ours._dispatch_batch(k) for k in range(1, ours.max_batch + 1)] \
        == [ref._dispatch_batch(k) for k in range(1, ref.max_batch + 1)]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_meshes_and_their_fingerprints():
    cpu8 = mesh_lib.make_data_mesh(8, device="cpu")
    assert (cpu8.axis_names, cpu8.shape) == (("data",), (8,))
    assert set(cpu8.devices) == {torch.device("cpu")}
    a = mesh_lib.make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    b = mesh_lib.make_mesh((2,), ("data",), devices=["cuda:2", "cuda:3"])
    same = mesh_lib.make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    twice = mesh_lib.make_mesh((2,), ("data",), devices=["cuda:0"] * 2)
    fp = sharding.mesh_fingerprint
    assert fp(a) != fp(b) and fp(a) != fp(twice)
    assert fp(a) == fp(same)
    assert fp(mesh_lib.make_data_mesh(2, device="cpu")) != fp(a)
    grid = mesh_lib.make_mesh((2, 3), ("data", "model"),
                              devices=[f"cuda:{i}" for i in range(6)])
    assert sharding.mesh_axis_sizes(grid) == {"data": 2, "model": 3}
    assert sharding.dp_axes(grid) == ("data",)
    assert sharding.axis_product(grid, ("data", "model")) == 6
    assert grid.along("data") == (torch.device("cuda:0"),
                                  torch.device("cuda:3"))
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh_lib.make_mesh((4,), ("data",), devices=["cpu"] * 3)


def test_meshes_on_the_card_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a CUDA device")
    with pytest.raises(ValueError, match="CUDA"):
        mesh_lib.make_data_mesh()
    with pytest.raises(ValueError, match="has 0"):
        mesh_lib.make_data_mesh(2, device="cuda")
    # the training meshes span a process group's ranks: none here
    with pytest.raises(ValueError, match="needs a world of 256"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_host_mesh(2)


def test_compile_sharded_keys_and_the_one_replica_program():
    seq = REGISTRY["AXPYDOT"]
    cc = cpu_compiler()
    one = mesh_lib.make_data_mesh(1, device="cpu")
    base = cc.compile_batched(seq.script, seq.shapes(128))
    assert cc.compile_sharded(seq.script, seq.shapes(128), one) is base
    m4 = mesh_lib.make_data_mesh(4, device="cpu")
    prog = cc.compile_sharded(seq.script, seq.shapes(128), m4)
    assert isinstance(prog, sharding.ShardedProgram)
    assert prog.n_replicas == 4 and prog.plan is base.plan
    assert cc.compile_sharded(seq.script, seq.shapes(128), m4) is prog
    assert cc.compile_sharded(seq.script, seq.shapes(128), m4,
                              max_batch=16) is not prog
    with pytest.raises(ValueError, match="no 'model' axis"):
        cc.compile_sharded(seq.script, seq.shapes(128), m4, axis="model")
    x = make_inputs(seq, 128, seed=1)
    batch = {k: np.stack([v] * 6) for k, v in x.items()}
    with pytest.raises(ValueError, match="does not split"):
        prog(**batch)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_sharded_engine_single_replica_is_the_base_engine():
    """On a one-replica mesh the sharded engine is the base engine: the
    same programs under the same keys, the same results."""
    cc = cpu_compiler()
    base = ServingEngine(compiler=cc, max_batch=4, min_bucket=64)
    shd = ShardedServingEngine(mesh_lib.make_data_mesh(1, device="cpu"),
                               compiler=cc, max_batch=4, min_bucket=64)
    assert shd.n_replicas == 1 and shd.max_batch == 4
    wl = [("AXPYDOT", 100, make_inputs(REGISTRY["AXPYDOT"], 100, seed=i))
          for i in range(6)] + \
        [("GEMVER", 70, make_inputs(REGISTRY["GEMVER"], 70, seed=9))]
    r1 = {r.rid: r for r in base.serve(wl)}
    r2 = {r.rid: r for r in shd.serve(wl)}
    for k in r1:
        assert all(bitwise(a, b) for a, b in zip(r1[k].outputs,
                                                 r2[k].outputs))
    assert shd._programs.keys() == base._programs.keys()
    assert all(shd._programs[k] is base._programs[k] for k in base._programs)
    st = shd.stats()
    assert st["programs"] == base.stats()["programs"]
    assert st["replica_rows"] == [7] and st["mesh"] == {"data": 1}


def test_sharded_engine_bitwise_equal_all_sequences():
    """Every REGISTRY sequence through 8 CPU replicas, 16 requests a
    sequence (2-row blocks): bitwise the single engine's results, and
    within 1e-4 of the float64 oracle."""
    wl, i = [], 0
    for name in REGISTRY:
        for _ in range(16):
            wl.append((name, 100, make_inputs(REGISTRY[name], 100, seed=i)))
            i += 1
    cc = cpu_compiler()
    single = ServingEngine(compiler=cc, max_batch=16, min_bucket=64)
    shard = ShardedServingEngine(mesh_lib.make_data_mesh(8, device="cpu"),
                                 compiler=cc, max_batch=16, min_bucket=64)
    r1 = {r.rid: r for r in single.serve(wl)}
    r2 = {r.rid: r for r in shard.serve(wl)}
    assert len(r2) == 16 * len(REGISTRY)
    mismatch = sorted({r1[k].sequence for k in r1 if not all(
        bitwise(a, b) for a, b in zip(r1[k].outputs, r2[k].outputs))})
    assert not mismatch, f"bitwise mismatch: {mismatch}"
    bad = []
    for rid, (name, n, inputs) in enumerate(wl):
        ref = REGISTRY[name].reference(
            **{k: np.asarray(v, np.float64) for k, v in inputs.items()})
        ref = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(r2[rid].outputs, ref):
            if not np.allclose(o.numpy().astype(np.float64), r, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(r).max())):
                bad.append(name)
    assert not bad, f"oracle mismatch: {sorted(set(bad))}"
    st = shard.stats()
    assert st["n_replicas"] == 8 and all(r > 0 for r in st["replica_rows"])
    assert all(isinstance(p, sharding.ShardedProgram)
               for p in shard._programs.values())


def test_sharded_engine_uneven_routing():
    """5 requests over 8 replicas: one padded 8-row dispatch, 1-row
    blocks filled front to back, every result right; a single request
    alone gives the same bits."""
    eng = ShardedServingEngine(mesh_lib.make_data_mesh(8, device="cpu"),
                               compiler=cpu_compiler(), max_batch=8,
                               min_bucket=64)
    wl = [("AXPYDOT", 100, make_inputs(REGISTRY["AXPYDOT"], 100, seed=i))
          for i in range(5)]
    for name, n, inputs in wl:
        eng.submit(name, n, inputs)
    res = {r.rid: r for r in eng.drain()}
    for rid, (name, n, inputs) in enumerate(wl):
        ref = REGISTRY[name].reference(
            **{k: np.asarray(v, np.float64) for k, v in inputs.items()})
        for o, r in zip(res[rid].outputs, ref):
            assert np.allclose(o.numpy().astype(np.float64), r, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(r).max()))
    st = eng.stats()
    assert st["n_dispatches"] == 1
    assert st["replica_rows"] == [1, 1, 1, 1, 1, 0, 0, 0]
    (one,) = eng.serve([wl[0]])
    assert all(bitwise(a, b) for a, b in zip(one.outputs, res[0].outputs))


def test_serve_cli_sharded_on_the_cpu(capsys):
    out = serve.main(["--blas", "GEMVER", "--engine", "--sharded",
                      "--devices", "8", "--requests", "32", "--quick",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert "sharded engine: 8 replicas, max_batch 8" in text
    assert "replica rows: [" in text
    rows = out["stats"]["replica_rows"]
    assert len(rows) == 8 and sum(rows) == 32
    with pytest.raises(SystemExit):
        serve.main(["--blas", "GEMVER", "--engine", "--devices", "2",
                    "--device", "cpu"])
