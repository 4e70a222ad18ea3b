"""Summed group times against the whole program's replay, on the card.

    python tools/sum_vs_replay.py [--cases LM_DECODE_ATTN:131072,GEMVER:4096]

For each case, compiles the program's ``best`` plan (``cuda`` backend)
and times, all by ``core.timing.replay_s`` at the autotune's discipline
(``GROUP_INNER`` calls captured in one graph, least of ``MEAS_REPS``
regions):

* ``replay_us``: the whole program, as ``chip_smoke.py``'s autotune
  phase times a winner;
* ``measured_us``: each group as the autotune measures it
  (``autotune.measure_group``: synthetic inputs, the same every call);
* ``flushed_us``: each group on the plan's own inputs with the L2
  flushed before every call (a write of ``FLUSH_BYTES``), less the
  flush timed alone: what the group costs when its inputs come from
  device memory.

Prints one JSON line per case and, first, the card's name and power
limit.  Needs one CUDA device.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import FusionCompiler, PlanCache, autotune  # noqa: E402
from repro_torch.core.timing import replay_s  # noqa: E402
from repro_torch.programs import REGISTRY, make_inputs  # noqa: E402

#: bytes written to evict the 50 MB L2 before a flushed call
FLUSH_BYTES = 256 << 20


def timed(fn, launches: int = 0) -> float:
    return replay_s(fn, inner=autotune.GROUP_INNER, reps=autotune.MEAS_REPS,
                    launches=launches) * 1e6


def case(name: str, n: int) -> dict:
    prog = REGISTRY[name]
    cp = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache()
                        ).compile(prog.script, prog.shapes(n))
    args = cp.prepare(**make_inputs(prog, n, seed=0))
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    flush_us = timed(flush.zero_)
    vals = dict(zip(cp.plan.input_names, args))
    outs, groups = [], []
    for gp, fn, im in zip(cp.plan.groups, cp.group_fns, cp.group_impls):
        a = [vals[r[1]] if r[0] == "input" else outs[r[1]][r[2]]
             for r in gp.inputs]

        def flushed(fn=fn, a=a):
            flush.zero_()
            fn(*a)

        groups.append({
            "group": fn.name,
            "measured_us": autotune.measure_group(
                cp.graph, im, device="cuda") * 1e6,
            "flushed_us": timed(flushed, launches=autotune.GROUP_INNER)
            - flush_us})
        outs.append(fn(*a))
    replay_us = timed(lambda: cp.fn(*args), launches=autotune.GROUP_INNER)
    measured = sum(g["measured_us"] for g in groups)
    flushed = sum(g["flushed_us"] for g in groups)
    return {"program": name, "n": n, "replay_us": replay_us,
            "sum_measured_us": measured, "measured_vs_replay":
            measured / replay_us, "sum_flushed_us": flushed,
            "flushed_vs_replay": flushed / replay_us, "flush_us": flush_us,
            "groups": groups}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="LM_DECODE_ATTN:131072,GEMVER:4096")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    for spec in args.cases.split(","):
        name, n = spec.split(":")
        print(json.dumps(case(name, int(n))), flush=True)


if __name__ == "__main__":
    main()
