"""Decode against forward for an MoE model at several depths, on one
NVIDIA GPU: how the gap of the two passes grows with depth.

    python3 tools/moe_decode_vs_forward.py              # DeepSeek-V2-Lite
    python3 tools/moe_decode_vs_forward.py --arch grok1_314b --depths 1,2

For each depth (the config's first layers; random weights from
``--seed``) and each ``--dtypes`` entry, ``chip_smoke.decode_vs_forward``
at the ``lm`` phase's shape (8 prompts of 1024 tokens): the error as the
reference computes it, with the prefill's ``kr`` roped (MLA), and with
the decode routed to the forward's experts, beside the last token's
routing flips between the two passes.  Prints one JSON line a (depth,
dtype), the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek_v2_lite")
    ap.add_argument("--depths", default="3,9,18,27")
    ap.add_argument("--dtypes", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("moe_decode_vs_forward: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import load_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for dtype in args.dtypes.split(","):
        for depth in map(int, args.depths.split(",")):
            cfg = dataclasses.replace(get_config(args.arch),
                                      n_layers=depth, compute_dtype=dtype)
            model = load_model(cfg, args.seed, "cuda")
            prompts = np.random.default_rng(args.seed).integers(
                0, cfg.vocab, (cs.LM_BATCH, cs.LM_PROMPT)).astype(np.int32)
            print(json.dumps({"arch": args.arch, "n_layers": depth,
                              "dtype": dtype,
                              **cs.decode_vs_forward(cfg, model, prompts)}),
                  flush=True)
            del model
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
