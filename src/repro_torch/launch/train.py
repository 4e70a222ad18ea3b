"""Training launcher, from the reference's ``repro.launch.train``: random
initialisation from ``--seed``, the synthetic data pipeline, the train
step (K4 every RMSNorm and K7 the loss on the forward, K6 each AdamW
leaf), asynchronous checkpoints, the straggler watchdog and the
preemption guard around the step loop, exact resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ck --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3_8b --smoke --device cpu --model-parallel 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --device cpu --model-parallel 2 --nproc 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch \
        deepseek_v2_lite --smoke --device cpu --model-parallel 2 --nproc 2

Sharded training runs over a process group: one started by ``torchrun``
(NCCL on the card, rank r on ``cuda:<LOCAL_RANK>``; gloo with
``--device cpu``), or ``--nproc N``, which starts N ranks itself
(``dist.spmd.run_ranks`` over a ``FileStore``).  The mesh is
``--mesh host`` (``make_host_mesh(--model-parallel)``), ``pod`` or
``multipod`` (``make_production_mesh``: 256 or 512 ranks); the state is
sharded by ``train.steps.shard_train_state`` and rank 0 prints.  A dense
or MoE config on ``--model-parallel`` > 1 splits its forward over the
``model`` ranks (tensor and sequence parallelism: heads, MLP columns,
the experts or their hidden columns, and the vocabulary; the axis must
divide ``n_heads`` and the columns it cuts), or with
``--no-tensor-parallel`` trains as pure FSDP over the whole mesh (a
MoE config with ``--moe-impl shard_map`` keeps its experts over
``model``).  The other families under tensor parallelism come with a
later slice and raise.  Without a process group (and with ``--mesh host
--model-parallel 1``) it trains on one device.

``--ckpt-dir`` saves the state every ``--ckpt-every`` steps (at step + 1)
and when a preemption signal arrives, before the loop exits;
``--resume`` restores the newest checkpoint there and trains on from its
step (the learning rate follows from the restored optimizer step, the
batches are keyed on (seed, step)), onto whatever mesh this run has.
Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
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


def _refuse(args, cfg):
    """Raise, before any rank starts, for what a later tensor-parallel
    slice brings: with tensor parallelism on a ``model`` axis, a family
    other than dense and MoE, or a split the axis does not divide (heads,
    MLP columns, experts' hidden columns: ``train.steps.
    tensor_parallel_split``)."""
    if args.model_parallel <= 1:
        return
    from repro_torch.models.common import tensor_parallel_enabled
    from repro_torch.train.steps import tensor_parallel_split
    if tensor_parallel_enabled() and not args.no_tensor_parallel:
        try:
            tensor_parallel_split(cfg, args.model_parallel)
        except NotImplementedError as e:
            raise ValueError(f"--model-parallel {args.model_parallel}: "
                             f"{e}; --no-tensor-parallel trains it as pure "
                             f"FSDP over the mesh") from None


def _spawned(rank: int, world: int, argv: list):
    return main(argv)


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
    ap.add_argument("--no-tensor-parallel", action="store_true",
                    help="models.common.set_tensor_parallel(False): 'dp' "
                         "absorbs 'model' (pure FSDP over the mesh)")
    ap.add_argument("--moe-impl", choices=["gspmd", "shard_map"],
                    default=None, help="override the config's moe_impl")
    ap.add_argument("--nproc", type=int, default=0,
                    help="start this many ranks (gloo with --device cpu, "
                         "NCCL one a GPU) and train over them")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.common import (set_tensor_parallel,
                                           tensor_parallel_enabled)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    _refuse(args, cfg)
    if args.nproc:
        from repro_torch.dist.spmd import run_ranks
        from repro_torch.launch.mesh import without_nproc
        rest = without_nproc(list(sys.argv[1:] if argv is None else argv))
        return run_ranks(_spawned, args.nproc, rest,
                         backend="gloo" if args.device == "cpu" else "nccl",
                         timeout_s=24 * 3600.0)[0]

    tp = tensor_parallel_enabled()
    if args.no_tensor_parallel:
        set_tensor_parallel(False)
    try:
        return _train(args, cfg)
    finally:
        set_tensor_parallel(tp)


def _train(args, cfg):
    """``main``'s run, on the parsed flags and the config."""
    from repro_torch.ckpt import (AsyncCheckpointer, PreemptionGuard,
                                  StepWatchdog, latest_step, restore)
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import make_batch_fn, shard_batch
    from repro_torch.launch.mesh import (join_process_group, make_host_mesh,
                                         make_production_mesh)
    from repro_torch.optim import AdamWHyper
    from repro_torch.train import steps as steps_lib

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hyper = AdamWHyper(lr=args.lr, warmup_steps=max(1, args.steps // 20),
                       total_steps=args.steps)
    sharded = join_process_group(args.device)
    if not sharded and (args.mesh != "host" or args.model_parallel > 1):
        if args.mesh != "host":
            make_production_mesh(multi_pod=args.mesh == "multipod")
        raise ValueError(
            f"--model-parallel {args.model_parallel}: sharded training "
            f"runs over a process group; start it with torchrun or "
            f"--nproc N")
    state = build_state(cfg, args.seed, args.device)
    dev = state["params_c"].device
    rank0, sh = True, None
    if sharded:
        import torch.distributed as dist
        mesh = {"host": lambda: make_host_mesh(args.model_parallel),
                "pod": lambda: make_production_mesh(),
                "multipod": lambda: make_production_mesh(multi_pod=True)
                }[args.mesh]()
        rank0 = dist.get_rank() == 0
        state, sh = steps_lib.shard_train_state(cfg, state, mesh)
        if rank0:
            print(f"mesh: {sh.spmd.describe()}  devices={sh.spmd.world}")
    else:
        print(f"device: {dev}  params: "
              f"{sum(p.numel() for p in state['params'].values())}")
    start = 0
    if args.resume and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        state, start, _ = restore(args.ckpt_dir, state, shardings=sh)
        if rank0:
            print(f"resumed from step {start}")
    train_step = steps_lib.make_train_step(cfg, hyper, accum=args.accum,
                                           shardings=sh)
    get_batch = make_batch_fn(cfg, shape)

    ckpt = AsyncCheckpointer(args.ckpt_dir, shardings=sh) \
        if args.ckpt_dir else None
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
            if rank0 and (step % args.log_every == 0
                          or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms"
                      + (" [straggler]" if flagged else ""))
            history.append({"step": step, "loss": loss, "dt": dt})
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state, {"arch": cfg.name})
            if _any_rank(guard.requested, sharded, dev):
                if rank0:
                    print("preemption requested: checkpointing + exit")
                if ckpt:
                    ckpt.save(step + 1, state, {"arch": cfg.name})
                break
    if ckpt:
        ckpt.close()
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    first = np.mean([h["loss"] for h in history[:5]]) if history \
        else float("nan")
    last = np.mean([h["loss"] for h in history[-5:]]) if history \
        else float("nan")
    if rank0:
        print(f"loss {first:.4f} -> {last:.4f} over {len(history)} steps")
    return history


def _any_rank(flag: bool, sharded: bool, dev) -> bool:
    """``flag`` on any rank (every rank stops at the same step)."""
    if not sharded:
        return flag
    import torch
    import torch.distributed as dist
    t = torch.tensor(int(flag), device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


if __name__ == "__main__":
    main()
