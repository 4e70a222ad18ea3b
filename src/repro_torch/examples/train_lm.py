"""Training example: a llama-family model at its smoke size trained for
a few hundred steps on the synthetic pipeline, with K4 and K7 on the
forward and K6 on every AdamW leaf on the card; the loss must fall.
Checkpointing and resume (the reference's ``--ckpt-dir`` and
``--resume``) come with the port's next slice.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu
"""
import argparse

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    history = train_launcher.main([
        "--arch", "llama3_8b", "--smoke",
        "--steps", str(args.steps),
        "--batch", "16", "--seq", "128", "--log-every", "25",
        "--device", args.device,
    ])
    losses = [h["loss"] for h in history]
    assert losses[-1] < losses[0], "training must reduce loss"
    print("OK: loss decreased from %.3f to %.3f" % (losses[0], losses[-1]))
    return history


if __name__ == "__main__":
    main()
