"""Training launcher, from the reference's ``repro.launch.train``: random
initialisation from ``--seed``, the synthetic data pipeline, the train
step (K4 every RMSNorm and K7 the loss on the forward, K6 each AdamW
leaf), the straggler watchdog and the preemption guard around the step
loop, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --device cpu

Runs on the GPU unless ``--device cpu``.  Not yet here: ``--mesh pod`` /
``multipod`` and ``--model-parallel`` > 1 (the port's ``dist`` slice),
``--ckpt-dir`` and ``--resume`` (its ``ckpt/checkpoint.py`` slice); each
raises, naming the slice that brings it.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_state(cfg, seed: int, device) -> dict:
    """The reference's ``build_state``: random parameters at the config's
    shapes from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (in ``cfg.param_dtype``), as ``train.steps.init_train_state``."""
    import torch

    from repro_torch.core.codegen import resolve_device
    from repro_torch.models import init_params
    from repro_torch.train.steps import init_train_state
    dev = resolve_device(device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    return init_train_state(cfg, model)


def _refuse(args):
    """Raise for the flags whose slice of the port has not landed."""
    if args.mesh != "host":
        raise ValueError(f"--mesh {args.mesh}: the production meshes come "
                         f"with the port's dist slice (ROADMAP.md); this "
                         f"path trains on one device (--mesh host)")
    if args.model_parallel > 1:
        raise ValueError(f"--model-parallel {args.model_parallel}: sharded "
                         f"training comes with the port's dist slice "
                         f"(ROADMAP.md); this path runs on one device")
    if args.ckpt_dir or args.resume:
        raise ValueError("--ckpt-dir and --resume: checkpointing and exact "
                         "resume come with the port's ckpt/checkpoint.py "
                         "slice (ROADMAP.md)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the config's reduced smoke size (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    _refuse(args)

    from repro_torch.ckpt import PreemptionGuard, StepWatchdog
    from repro_torch.configs import ShapeConfig, get_config, smoke_config
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.optim import AdamWHyper
    from repro_torch.train import steps as steps_lib

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hyper = AdamWHyper(lr=args.lr, warmup_steps=max(1, args.steps // 20),
                       total_steps=args.steps)
    state = build_state(cfg, args.seed, args.device)
    dev = state["params_c"].device
    print(f"device: {dev}  params: "
          f"{sum(p.numel() for p in state['params'].values())}")
    train_step = steps_lib.make_train_step(cfg, hyper, accum=args.accum)
    get_batch = make_batch_fn(cfg, shape)

    watchdog = StepWatchdog()
    history = []
    with PreemptionGuard() as guard:
        for step in range(args.steps):
            t0 = time.perf_counter()
            batch = shard_batch(get_batch(step), dev)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            flagged = watchdog.record(step, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms"
                      + (" [straggler]" if flagged else ""))
            history.append({"step": step, "loss": loss, "dt": dt})
            if guard.requested:
                print("preemption requested: exit")
                break
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    first = np.mean([h["loss"] for h in history[:5]]) if history \
        else float("nan")
    last = np.mean([h["loss"] for h in history[-5:]]) if history \
        else float("nan")
    print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps")
    return history


if __name__ == "__main__":
    main()
