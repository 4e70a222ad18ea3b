"""K1's device time per group on the card, for an A/B of two trees.

    python tools/k1_ab.py src new                   # this checkout
    python tools/k1_ab.py /path/to/other/src parent # another tree's port

Compiles GEMVER, BiCGK, ATAX and SGEMV at n = 4096, AXPYDOT at 2**24 and
LM_DECODE_ATTN at 131072, ``best`` and ``unfused``, through the ``cuda``
backend of the ``repro_torch`` found under the given ``src`` directory,
and prints one JSON line ``<label> {kernel: µs}``: each group's launch
(``launch_into``, no allocation) and each program's whole eager function
(``<program>/<mode>/fn``), 20 calls captured in one CUDA graph, the best
of 5 rounds of 10 replays.  Run trees in turns in one call (parent,
new, new, parent) and compare within the call.
"""
import json
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.core import FusionCompiler, PlanCache  # noqa: E402
from repro_torch.programs import REGISTRY, make_inputs  # noqa: E402

CASES = [("GEMVER", 4096), ("BiCGK", 4096), ("AXPYDOT", 1 << 24),
         ("LM_DECODE_ATTN", 131072), ("ATAX", 4096), ("SGEMV", 4096)]


def graph_us(fn, calls: int = 20, replays: int = 10, rounds: int = 5):
    """Device µs per call: ``calls`` calls in one graph, best round."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        start.record()
        for _ in range(replays):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / (calls * replays))
    return best * 1e3


def main():
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    out = {}
    for name, n in CASES:
        for mode in ("best", "unfused"):
            p = cc.compile(REGISTRY[name].script, REGISTRY[name].shapes(n),
                           mode=mode, label=f"{name}/{mode}")
            p.module.build()
            ins = p.prepare(**make_inputs(REGISTRY[name], n, seed=0))
            vals = dict(zip(p.plan.input_names, ins))
            outs = []
            for gp, fn in zip(p.plan.groups, p.group_fns):
                a = [vals[r[1]] if r[0] == "input" else outs[r[1]][r[2]]
                     for r in gp.inputs]
                raw, ws = fn.buffers(a[0].device)
                out[fn.name] = graph_us(lambda: fn.launch_into(a, raw, ws))
                outs.append(fn.launch(*a))
            out[f"{name}/{mode}/fn"] = graph_us(lambda: p.fn(*ins))
    print(sys.argv[2], json.dumps(out))


if __name__ == "__main__":
    main()
