"""Training example: a llama-family model at its smoke size trained for
a few hundred steps on the synthetic pipeline, with K4 and K7 on the
forward and K6 on every AdamW leaf on the card; the loss must fall.
With ``--ckpt-dir`` it checkpoints every ``--ckpt-every`` steps and
resumes from the newest checkpoint there, as the reference's example
does; a run that finds its last step already checkpointed trains 0
steps and says so.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        --ckpt-dir ck
"""
import argparse

from repro_torch.launch import train as train_launcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here and resume from it")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    ckpt = (["--ckpt-dir", args.ckpt_dir, "--ckpt-every",
             str(args.ckpt_every), "--resume"] if args.ckpt_dir else [])
    history = train_launcher.main([
        "--arch", "llama3_8b", "--smoke",
        "--steps", str(args.steps),
        "--batch", "16", "--seq", "128", "--log-every", "25",
        "--device", args.device, *ckpt,
    ])
    if not history:
        print(f"trained 0 steps: the checkpoint under {args.ckpt_dir} is "
              f"at step {args.steps} already")
        return history
    losses = [h["loss"] for h in history]
    assert losses[-1] < losses[0], "training must reduce loss"
    print("OK: loss decreased from %.3f to %.3f" % (losses[0], losses[-1]))
    return history


if __name__ == "__main__":
    main()
