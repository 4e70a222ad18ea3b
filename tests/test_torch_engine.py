"""The port's ``ServingEngine`` against the reference's on the same
request stream: mixed sequences, sizes off the bucket grid, and
``LM_DECODE_ATTN`` at ragged KV lengths (served through per-lane
masking).  Both engines must form the same dispatches and packs and
compile the same buckets; per-request outputs agree to a norm-relative
1e-5 in float32 (sums in another order), on the ``torch`` backend and on
the ``cuda`` backend with CPU tensors (K1's plain tiled version).
"""
import numpy as np
import pytest
import torch

from repro.core import FusionCompiler as RefCompiler
from repro.core import PlanCache as RefCache
from repro.programs import REGISTRY as REF_REGISTRY
from repro.serving import ServingEngine as RefEngine

from repro_torch.blas import elementary_lib as lib
from repro_torch.core import FusionCompiler, PlanCache
from repro_torch.launch import serve
from repro_torch.programs import REGISTRY, Sequence, make_inputs
from repro_torch.serving import (ServingEngine, bucket_of, input_pad_values,
                                 pad_to_shape)
from torch_threads import capped_torch_threads  # noqa: F401

RTOL = 1e-5
#: (sequence, n): off-grid sizes, two buckets each, ragged KV lengths
STREAM = [("GEMVER", 100), ("BiCGK", 200), ("AXPYDOT", 300),
          ("LM_DECODE_ATTN", 300), ("GEMVER", 128), ("BiCGK", 100),
          ("AXPYDOT", 513), ("LM_DECODE_ATTN", 700), ("GEMVER", 90),
          ("AXPYDOT", 260), ("LM_DECODE_ATTN", 512), ("BiCGK", 129)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _engines(backend, max_batch=2, max_pack=4):
    ours = ServingEngine(FusionCompiler(backend=backend, device="cpu",
                                        cache=PlanCache()),
                         max_batch=max_batch, min_bucket=64,
                         registry=REGISTRY, max_pack=max_pack)
    ref = RefEngine(RefCompiler(cache=RefCache()), max_batch=max_batch,
                    min_bucket=64, registry=REF_REGISTRY, max_pack=max_pack)
    return ours, ref


def _requests(seed=0, stream=STREAM):
    return [(s, n, make_inputs(REGISTRY[s], n, seed=seed + i))
            for i, (s, n) in enumerate(stream)]


def _counts(st):
    return (st["n_requests"], st["n_dispatches"], st["n_packed_dispatches"],
            st["n_packed_members"], st["n_padded_rows"], st["programs"],
            st["packs"],
            {k: (b["hits"], b["misses"])
             for k, b in st["cache"]["buckets"].items()})


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_matches_the_reference_engine(backend):
    ours, ref = _engines(backend)
    reqs = _requests()
    # first drain: every key cold, so nothing packs; second drain: warm
    # keys, same-size batches of different sequences pack
    for round_ in range(2):
        got = {r.rid: r for r in ours.serve(reqs)}
        want = {r.rid: r for r in ref.serve(reqs)}
        assert _counts(ours.stats()) == _counts(ref.stats()), round_
        assert sorted(got) == sorted(want)
        for rid, r in got.items():
            w = want[rid]
            assert (r.sequence, r.n, r.bucket, r.batch_size) == (
                w.sequence, w.n, w.bucket, w.batch_size)
            for o, wo in zip(r.outputs, w.outputs):
                assert tuple(o.shape) == np.shape(wo)
                assert _rel(o.numpy(), wo) <= RTOL, (r.sequence, r.n)
            s, n, env = reqs[rid - round_ * len(reqs)]
            ref64 = REGISTRY[s].reference(
                **{k: np.asarray(v, np.float64) for k, v in env.items()})
            for o, w64 in zip(r.outputs, ref64 if isinstance(ref64, tuple)
                              else (ref64,)):
                assert _rel(o.numpy(), w64) <= RTOL
    assert ours.stats()["n_packed_dispatches"] >= 1


def test_warm_then_serve_never_compiles():
    """Uniform traffic over the warmed keys (two requests a key) forms
    exactly the pack ``warm_packs`` built: serving compiles nothing."""
    ours, ref = _engines("cuda", max_batch=4)
    stream = [("AXPYDOT", 300), ("AXPYDOT", 700), ("LM_DECODE_ATTN", 300),
              ("LM_DECODE_ATTN", 700)] * 2
    for eng in (ours, ref):
        for s in ("AXPYDOT", "LM_DECODE_ATTN"):
            eng.warm(s, [n for t, n in stream if t == s], trace_packs=False)
        eng.warm_packs()
    st0 = ours.stats()["cache"]["buckets"]
    assert _counts(ours.stats())[-1] == _counts(ref.stats())[-1]
    results = ours.serve(_requests(stream=stream))
    assert len(results) == len(stream)
    st1 = ours.stats()["cache"]["buckets"]
    assert sum(b["misses"] for b in st1.values()) == \
        sum(b["misses"] for b in st0.values())
    assert ours.stats()["n_packed_dispatches"] >= 1


def test_drain_preserves_queue_on_compile_failure():
    """A poison request (unpaddable and unmaskable: two independent
    padded extents) must not drop the other queued requests: drain()
    restores the queue and re-raises."""

    def bad_script(g, x, y, alpha):
        s = g.apply(lib.scal, alpha, x)
        t = g.apply(lib.max_reduce, s)
        return (g.apply(lib.axpy, t, y, y),)

    bad = Sequence("BAD", "", bad_script,
                   lambda n: {"x": (n,), "y": (n // 2,), "alpha": ()},
                   lambda x, y, alpha: (np.max(alpha * x) * y + y,),
                   lambda n: float(n))
    engine = ServingEngine(FusionCompiler(device="cpu", cache=PlanCache()),
                           max_batch=4, min_bucket=64,
                           registry={**REGISTRY, "BAD": bad})
    engine.submit("VADD", 100, make_inputs(REGISTRY["VADD"], 100, seed=0))
    engine.submit("BAD", 100, {"x": np.ones(100, np.float32),
                               "y": np.ones(50, np.float32),
                               "alpha": np.float32(2.0)})
    with pytest.raises(Exception, match="RPL130|mask"):
        engine.drain()
    assert [r.sequence for r in engine._queue] == ["VADD", "BAD"]
    engine._queue = [r for r in engine._queue if r.sequence == "VADD"]
    (res,) = engine.drain()
    assert res.sequence == "VADD" and res.n == 100


def test_engine_takes_tensor_inputs_and_pads_them():
    """Requests may arrive as tensors: the same results as numpy."""
    eng = ServingEngine(FusionCompiler(device="cpu", cache=PlanCache()),
                        max_batch=4, min_bucket=64, registry=REGISTRY)
    env = make_inputs(REGISTRY["BiCGK"], 100, seed=3)
    a = eng.serve([("BiCGK", 100, env)])[0]
    b = eng.serve([("BiCGK", 100, {k: torch.as_tensor(v)
                                   for k, v in env.items()})])[0]
    for x, y in zip(a.outputs, b.outputs):
        assert torch.equal(x, y)


def test_helpers_agree_with_the_reference():
    from repro.core.graph import trace as ref_trace
    from repro.serving import engine as reng
    from repro_torch.core.graph import trace
    for n in (1, 63, 64, 65, 1000):
        assert bucket_of(n, 64) == reng.bucket_of(n, 64)
    with pytest.raises(ValueError):
        bucket_of(10, 100)
    with pytest.raises(ValueError):
        bucket_of(0)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(pad_to_shape(x, (4, 4), -1.0),
                                  reng.pad_to_shape(x, (4, 4), -1.0))
    for name in ("GEMVER", "SSCAL", "LM_RMSNORM"):
        shapes = REGISTRY[name].shapes(128)
        assert input_pad_values(trace(REGISTRY[name].script, shapes)) == \
            reng.input_pad_values(ref_trace(REF_REGISTRY[name].script,
                                            shapes))


def test_serve_cli_engine_on_the_cpu(capsys):
    res = serve.main(["--blas", "AXPYDOT,BiCGK", "--engine", "--sizes",
                      "100,200", "--requests", "8", "--device", "cpu",
                      "--max-batch", "2"])
    assert res["n_results"] == 8
    assert res["stats"]["n_dispatches"] < 8
    assert "dispatches" in capsys.readouterr().out


def test_engine_stream_draws_every_bucket_of_each_range():
    ranges = {"GEMVER": (1000, 4096), "AXPYDOT": (100, 200)}
    stream = serve.engine_stream(ranges, 64, seed=3)
    assert stream == serve.engine_stream(ranges, 64, seed=3)
    assert [s for s, _ in stream] == ["GEMVER", "AXPYDOT"] * 32
    for s, n in stream:
        lo, hi = ranges[s]
        assert lo <= n <= hi
    assert {bucket_of(n, 64) for s, n in stream if s == "GEMVER"} == \
        {1024, 2048, 4096}
    assert {bucket_of(n, 64) for s, n in stream if s == "AXPYDOT"} == \
        {128, 256}


class _ReplayOnTheCPU:
    """Stands in for a captured CUDA graph: a replay runs the function
    again and writes its outputs into the slot's, as a graph does."""

    def __init__(self, fn, inputs, outs):
        self.fn, self.inputs, self.outs = fn, inputs, outs

    def replay(self):
        for o, x in zip(self.outs, self.fn(*self.inputs)):
            o.copy_(x)


def test_graph_runner_caps_its_graphs_and_never_overwrites_held_results():
    from repro_torch.core.graphs import MAX_SLOTS, GraphRunner, _Slot
    from repro_torch.core import LAUNCHES

    class Runner(GraphRunner):
        def _capture(self, inputs):
            outs = tuple(t.clone() for t in self.fn(*inputs))
            self.n_captures += 1
            return _Slot(_ReplayOnTheCPU(self.fn, inputs, outs), outs,
                         ["k"], inputs)

    x = torch.zeros(4)
    run = Runner(lambda t: (t * 2,))
    held = []
    for i in range(10):                  # the caller keeps every result
        x.fill_(i)
        held.append(run(x)[0])
    assert run.n_captures == run.most_graphs == MAX_SLOTS  # 1st: eager
    assert run.n_held == 10 - 1 - MAX_SLOTS
    for i, r in enumerate(held):
        assert torch.equal(r, torch.full((4,), 2.0 * i))
    del held[1]                          # frees the first graph's result
    LAUNCHES.reset()
    x.fill_(20)
    again = run(x)[0]
    assert torch.equal(again, torch.full((4,), 40.0))
    assert run.n_captures == MAX_SLOTS and LAUNCHES.by_kernel["k"] == 1
    assert torch.equal(held[1], torch.full((4,), 4.0))
