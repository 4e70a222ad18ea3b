"""Serving example: batched prefill and greedy decode for a GQA model
with QKV bias against a KV cache (qwen2_7b) and for an attention-free SSM
with an O(1) state (mamba2_2p7b), each at its smoke size; on the card K4
runs their RMSNorms and K5 qwen2's decode attention.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse

from repro_torch.launch import serve as serve_launcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    for arch in ("qwen2_7b", "mamba2_2p7b"):
        print(f"=== {arch} ===")
        serve_launcher.main([
            "--arch", arch, "--smoke", "--batch", "4",
            "--prompt-len", "32", "--gen", "16", "--device", args.device,
        ])


if __name__ == "__main__":
    main()
