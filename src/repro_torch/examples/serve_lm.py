"""Serving example: batched prefill and greedy decode against a KV cache
for a GQA model with QKV bias (qwen2_7b at its smoke size); on the card
K4 runs its RMSNorms and K5 its decode attention.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The reference's example also serves mamba2_2p7b, an attention-free SSM;
the port's SSM family is still to come (``ROADMAP.md``).
"""
import argparse

from repro_torch.launch import serve as serve_launcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    for arch in ("qwen2_7b",):
        print(f"=== {arch} ===")
        serve_launcher.main([
            "--arch", arch, "--smoke", "--batch", "4",
            "--prompt-len", "32", "--gen", "16", "--device", args.device,
        ])


if __name__ == "__main__":
    main()
