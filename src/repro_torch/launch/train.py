"""Training launcher, from the reference's ``repro.launch.train``: random
initialisation from ``--seed``, the synthetic data pipeline, the train
step (K4 every RMSNorm and K7 the loss on the forward, K6 each AdamW
leaf), asynchronous checkpoints, the straggler watchdog and the
preemption guard around the step loop, exact resume, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ck --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --device cpu

``--ckpt-dir`` saves the state every ``--ckpt-every`` steps (at step + 1)
and when a preemption signal arrives, before the loop exits;
``--resume`` restores the newest checkpoint there and trains on from its
step (the learning rate follows from the restored optimizer step, the
batches are keyed on (seed, step)).  Runs on the GPU unless ``--device
cpu``.  Not yet here: ``--mesh pod`` / ``multipod`` and
``--model-parallel`` > 1 (the port's SPMD slice); each raises, naming
the slice that brings it.
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
                         f"with the port's SPMD slice of dist (ROADMAP.md); "
                         f"this path trains on one device (--mesh host)")
    if args.model_parallel > 1:
        raise ValueError(f"--model-parallel {args.model_parallel}: sharded "
                         f"training comes with the port's SPMD slice of "
                         f"dist (ROADMAP.md); this path runs on one device")


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

    from repro_torch.ckpt import (AsyncCheckpointer, PreemptionGuard,
                                  StepWatchdog, latest_step, restore)
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
    start = 0
    if args.resume and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        state, start, _ = restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")
    train_step = steps_lib.make_train_step(cfg, hyper, accum=args.accum)
    get_batch = make_batch_fn(cfg, shape)

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = StepWatchdog()
    history = []
    with PreemptionGuard() as guard:
        for step in range(start, args.steps):
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
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, {"arch": cfg.name})
            if guard.requested:
                print("preemption requested: checkpointing + exit")
                if ckpt:
                    ckpt.save(step + 1, state, {"arch": cfg.name})
                break
    if ckpt:
        ckpt.close()
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
