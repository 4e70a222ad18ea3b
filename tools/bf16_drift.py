"""How far bfloat16 serving drifts from float32 as a model deepens, on one
NVIDIA GPU: the decode-against-forward gap beside each bfloat16 pass's
own distance from float32.

    python3 tools/bf16_drift.py --arch mamba2_2p7b --depths 2,8,16,32,64
    python3 tools/bf16_drift.py --arch llava_next_34b --depths 2,8,16

For each depth (the config's first layers, Whisper's encoder cut alike;
random weights from ``--seed`` drawn as ``serve --arch`` draws them, in
bfloat16) the ``lm`` phase's check (``chip_smoke.decode_vs_forward``:
8 prompts of ``chip_smoke``'s length, one decode step, or the 32 steps
of a recurrent state's family over random continuation tokens), and
with the same bfloat16 weights held in float32 (where they fit in 60
GB): the float32 forward's logits at the same positions against the
bfloat16 forward's (``forward_bf16_vs_f32``) and the bfloat16 decode's
(``decode_bf16_vs_f32``), and float32 decode against float32 forward.
When the bfloat16 forward is as far from float32 as the bfloat16 decode
is from it, the two bfloat16 passes differ by the model's amplification
of bfloat16 rounding, not by their algorithms.  Prints one JSON line a
depth, the card's name and power limit first.
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

#: the largest float32 copy of the weights held beside the bfloat16 ones
F32_BYTES = 60e9


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2_2p7b")
    ap.add_argument("--depths", default="2,8,16,32,64")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bf16_drift: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (draw_inputs, grow_cache,
                                          load_model)
    from repro_torch.models import (cast_params, decode_step, forward_lm,
                                    prefill)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    for depth in map(int, args.depths.split(",")):
        cfg, reduced = cs.lm_config(get_config(args.arch), depth)
        P = cs.LM_PROMPTS.get(args.arch, cs.LM_PROMPT)
        x = draw_inputs(cfg, cs.LM_BATCH, P, args.seed)
        seq, steps = x["prompts"], 1
        if cfg.family in cs.STATEFUL:
            seq = np.concatenate([seq, np.random.default_rng(
                args.seed + 1).integers(0, cfg.vocab, (cs.LM_BATCH,
                                                       cs.LM_GEN))
                .astype(np.int32)], axis=1)
            steps = cs.LM_GEN
        extra = {k: x[k] for k in ("patches", "frames")}
        model = load_model(cfg, args.seed, "cuda")
        rec = {"arch": args.arch, "n_layers": depth, "reduced": reduced,
               **cs.decode_vs_forward(cfg, model, seq, steps, **extra)}
        n_params = sum(p.numel() for p in model.parameters())
        if 4 * n_params <= F32_BYTES:
            dev = model.device
            tens = {k: torch.as_tensor(a, device=dev)
                    for k, a in extra.items() if a is not None}
            toks = torch.as_tensor(seq, device=dev)
            Pf = toks.shape[1] - steps
            f32 = dataclasses.replace(cfg, compute_dtype="float32")
            want = forward_lm(f32, cast_params(f32, load_model(
                cfg, args.seed, "cuda")), toks, **tens)[0][:, Pf:].float()
            got = forward_lm(cfg, model, toks, **tens)[0][:, Pf:].float()
            _, cache = prefill(cfg, model, toks[:, :Pf], **tens)
            cache = grow_cache(cfg, cache, Pf + cs.LM_GEN)
            dec = torch.stack([decode_step(cfg, model, cache,
                                           toks[:, Pf + i], Pf + i)[0]
                               for i in range(steps)], 1).float()
            rec["forward_bf16_vs_f32"] = [cs.tensor_err(got[:, i],
                                                        want[:, i])[0]
                                          for i in range(steps)]
            rec["decode_bf16_vs_f32"] = [cs.tensor_err(dec[:, i],
                                                       want[:, i])[0]
                                         for i in range(steps)]
            del cache, dec, got, want
        del model
        torch.cuda.empty_cache()
        if 4 * n_params <= F32_BYTES:
            model = cast_params(f32, load_model(cfg, args.seed, "cuda"))
            rec["float32"] = cs.decode_vs_forward(f32, model, seq, steps,
                                                  **extra)[
                "decode_vs_forward_checked"]
            del model
            torch.cuda.empty_cache()
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
