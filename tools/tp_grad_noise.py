"""How far the tensor-parallel step's gradients lie from the unsharded
step's, leaf by leaf, against pure FSDP over the same ranks, on the CPU.

    python3 tools/tp_grad_noise.py      # from the root of a checkout, ~1 min

Four gloo ranks (``dist.spmd.run_ranks``) take the first train step of
``llama3_8b``'s smoke config (``launch.train.build_state`` at seed 0,
the synthetic batch of 4 x 32 tokens) on a (2, 2) mesh, once with the
forward split over ``model`` (tensor and sequence parallelism) and
once with tensor parallelism off (FSDP over all four ranks), in float32
and in bfloat16 compute; rank 0 takes the unsharded step from the same
state and compares the gradients AdamW receives
(``tests/torch_tp_ranks.py`` ``first_grads``).  Prints one JSON line a
(compute dtype, tensor parallelism): the largest and the median
norm-relative error over the leaves and the leaf of the largest.

In bfloat16 the tensor-parallel step rounds each rank's partial sum of
a row-split matmul (``wo``, ``wd``) and each rank's partial gradient of
the gathered stream to bfloat16 before the ranks add them, where one
device rounds the whole sum once; FSDP rounds each rank's gradients of
its rows.  In float32 both are the unsharded gradients up to the order
of the sums.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]


def ranks(rank, world, dtypes):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import build_state
    from torch_tp_ranks import first_grads
    out = []
    for dtype in dtypes:
        cfg = dataclasses.replace(smoke_config("llama3_8b"),
                                  compute_dtype=dtype)
        for tp in (True, False):
            errs = first_grads(rank, cfg, 2,
                               lambda c: build_state(c, 0, "cpu"), tp=tp)
            out.append((dtype, tp, errs))
    return out


def main():
    from repro_torch.dist.spmd import run_ranks
    with tempfile.TemporaryDirectory() as d:
        res = run_ranks(ranks, 4, ("float32", "bfloat16"), timeout_s=600,
                        tmpdir=d)
    for dtype, tp, errs in res[0]:
        worst = max(errs, key=errs.get)
        print(json.dumps({"compute_dtype": dtype, "mesh": [2, 2],
                          "tensor_parallel": tp, "max": errs[worst],
                          "median": statistics.median(errs.values()),
                          "worst_leaf": worst, "leaves": len(errs)}))


if __name__ == "__main__":
    main()
