"""Serving launcher: LM serving (``--arch``) and BLAS-sequence serving
through the fusion compiler (``--blas``).

A language model: batched prefill of random prompts, then greedy decode
against a KV cache at the full horizon (prompt + generated tokens), the
weights random from ``--seed`` at the config's shapes and cast once to
its compute dtype (every family: dense, MoE, ``llava_next_34b``'s vlm
with patch embeddings, ``mamba2_2p7b``'s SSD, ``hymba_1p5b``'s hybrid,
``whisper_medium``'s encoder-decoder over frame embeddings); K4 runs every
RMSNorm and K5 every GQA decode attention on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --smoke --device cpu

Tensor-parallel serving of the dense, vlm, MoE, ssm and encdec
families: ``--model-parallel N`` splits each layer over N ranks of a
process group (``torchrun``, NCCL one rank a GPU or gloo with ``--device
cpu``; or ``--nproc R``, which starts R ranks itself), on
``make_host_mesh(N)`` (the other ranks serving their rows of the batch):
each rank holds its blocks of the weights (heads, MLP columns, experts
or their hidden columns, SSD heads, vocabulary) and of the decode cache
(its KV heads, Whisper's cross K/V too; MLA's latent whole; its SSD
heads' state), and rank 0 prints.  On NCCL the decode step, collectives
included, replays as one CUDA graph; gloo's steps run eagerly.  The
hybrid family is refused (its heads split over no axis yet):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --smoke --device cpu --model-parallel 2 --nproc 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        deepseek_v2_lite --smoke --device cpu --model-parallel 2 --nproc 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \
        --smoke --device cpu --model-parallel 2 --nproc 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        whisper_medium --smoke --device cpu --model-parallel 4 --nproc 4
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch llava_next_34b --batch 8 --prompt-len 608 --model-parallel 4

BLAS sequences:

One sequence, one size: compile through the plan cache, then a request
loop where each request runs every group of the plan — on the ``cuda``
backend one generated kernel per group, replayed as one CUDA graph per
request (and, beside it, the eager path that calls each group from
Python):

    PYTHONPATH=src python -m repro_torch.launch.serve --blas GEMVER \
        --n 4096 --requests 100

Mixed sequences and sizes through the batched ``ServingEngine`` (shape
buckets, padding or masking, batched and packed dispatches), the
reference's workload: request i is sequence i mod their count at size i
mod the ``--sizes`` count (default 256,1000,1024,2048; ``--quick``
64,100,128):

    PYTHONPATH=src python -m repro_torch.launch.serve --blas GEMVER,BiCGK \
        --engine --sizes 1000,4096 --requests 64

Replica-sharded serving: ``--engine --sharded`` spreads every dispatch
over the ``data`` axis of a replica mesh (``launch.mesh.make_data_mesh``)
of ``--devices`` replicas on ``--device`` (default every GPU present;
on the CPU, one), each replica running its contiguous row block of the
batch:

    PYTHONPATH=src python -m repro_torch.launch.serve --blas GEMVER \
        --engine --sharded --devices 8 --requests 32 --quick --device cpu

Empirical search: ``--autotune`` compiles under constants calibrated on
the device (``hw="calibrate"``) and measures the ``--budget`` best
predicted candidates, timing each group of each one on the card; with
``--refit`` the cost model is then regressed over those timings and the
sequence recompiled with ``best`` under the refit model:

    PYTHONPATH=src python -m repro_torch.launch.serve --blas GEMVER \
        --autotune --refit --budget 4 --n 4096

Runs on the GPU by default; ``--device cpu`` runs the same paths on the
CPU (the kernels' plain versions stand in for them there).  On the GPU,
requests and decode steps are timed with CUDA events.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _mode(text: str):
    """``--mode``: 'best', 'unfused' or an integer rank.  The measured
    search is ``--autotune`` alone: it also calibrates the cost model
    it ranks the candidates with."""
    if text == "autotune":
        raise argparse.ArgumentTypeError(
            "use --autotune for the measured search")
    return int(text) if text.lstrip("-").isdigit() else text


def serve_blas(args) -> dict:
    """Request loop over one compiled BLAS sequence.

    Compile #1 populates the plan cache, compile #2 is served from the
    program cache, and each request launches one kernel per plan
    group."""
    import torch

    from repro_torch.blas import REGISTRY, make_inputs
    from repro_torch.core import V5E, LAUNCHES, FusionCompiler, PlanCache

    if args.blas not in REGISTRY:
        raise SystemExit(f"unknown sequence {args.blas!r}; "
                         f"choose from {', '.join(REGISTRY)}")
    seq = REGISTRY[args.blas]
    cache = PlanCache()
    mode = "autotune" if args.autotune else args.mode
    # calibrated constants make the predicted candidate ordering (which
    # the autotune budget is spent on) rank for this device
    hw = "calibrate" if args.autotune else V5E
    cc = FusionCompiler(cache=cache, hw=hw, backend=args.backend,
                        device=args.device, autotune_budget=args.budget)
    label = f"serve/{args.blas}/{mode}"

    t0 = time.perf_counter()
    prog = cc.compile(seq.script, seq.shapes(args.n), mode=mode, label=label)
    t_compile = time.perf_counter() - t0
    if args.autotune and cc.last_autotune is not None:
        print(cc.last_autotune.describe())
    if args.refit:
        # two-phase flow: the autotune pass populated the per-group
        # measured-cost table; regress the predictor over it and
        # recompile mode="best" under the refit model — the hw repr is
        # a cache-key component, so this searches a fresh plan
        hw_before = cc.hw
        cc.refit_hardware()
        print(f"refit: {hw_before.name} -> {cc.hw.name} "
              f"(bw {hw_before.hbm_bw:.3g} -> {cc.hw.hbm_bw:.3g} B/s, "
              f"launch {hw_before.launch_overhead_s:.3g} -> "
              f"{cc.hw.launch_overhead_s:.3g} s, "
              f"{len(cache.group_records())} group records)")
        mode, label = "best", f"serve/{args.blas}/refit"
        prog = cc.compile(seq.script, seq.shapes(args.n), mode=mode,
                          label=label)
    t0 = time.perf_counter()
    cc.compile(seq.script, seq.shapes(args.n), mode=mode, label=label)
    t_recompile = time.perf_counter() - t0

    inputs = prog.prepare(**make_inputs(seq, args.n, seed=args.seed))
    prog.run(*inputs)             # first call: eager, builds the kernels
    prog.run(*inputs)             # second: captures the plan's graph
    prog.synchronize()

    def loop(fn) -> tuple[float, int]:
        """Seconds for ``args.requests`` calls, and the launches made."""
        launches0 = LAUNCHES.total
        if prog.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.requests):
                fn(*inputs)
            end.record()
            torch.cuda.synchronize(prog.device)
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(args.requests):
                fn(*inputs)
            t = time.perf_counter() - t0
        return t, LAUNCHES.total - launches0

    t_graph, launches = loop(prog.run)
    t_eager, eager_launches = loop(prog.fn)
    n = max(args.requests, 1)
    us_per_req, eager_us = t_graph / n * 1e6, t_eager / n * 1e6
    stats = cache.stats.as_dict()
    print(f"serve {args.blas} n={args.n} mode={mode} "
          f"backend={args.backend} device={prog.device}: compile "
          f"{t_compile*1e3:.1f} ms, recompile {t_recompile*1e6:.0f} us "
          f"(cache hit), {args.requests} requests at {us_per_req:.1f} "
          f"us/req replayed, {eager_us:.1f} us/req eager ({prog.n_groups} "
          f"groups, {launches} kernel launches)")
    print(f"cache stats: {stats}")
    return {"t_compile_s": t_compile, "t_recompile_s": t_recompile,
            "us_per_request": us_per_req, "eager_us_per_request": eager_us,
            "n_groups": prog.n_groups, "kernel_launches": launches,
            "eager_kernel_launches": eager_launches,
            "device": str(prog.device), "hw": cc.hw.name, "cache": stats}


#: the cache leaves whose axis 2 is the sequence (a hybrid's ``k`` and
#: ``v`` are its ring, which keeps its W slots)
GROWN = ("k", "v", "ckv", "kr")


def grow_cache(cfg, cache, horizon: int) -> dict:
    """The prefill's cache of KV length P at the full ``horizon``: each
    leaf of ``GROWN`` (but a hybrid's ring) as zeros at the horizon with
    its P positions copied in; the SSD ``state``, the ring and Whisper's
    cross ``xk``/``xv`` as they are.  The reference pads every leaf whose
    axis 2 is P long, outside the hybrid family (ROADMAP.md §3)."""
    import torch
    out = dict(cache)
    for name, t in cache.items():
        if name in GROWN and cfg.family != "hybrid":
            full = torch.zeros(t.shape[:2] + (horizon,) + t.shape[3:],
                               dtype=t.dtype, device=t.device)
            full[:, :, :t.shape[2]] = t
            out[name] = full
    return out


def generate(cfg, model, prompts, gen: int, patches=None, frames=None, *,
             graph: bool = True, spmd=None) -> dict:
    """The reference's ``--arch`` loop on ``model`` (cast to the compute
    dtype): prefill the prompts (B, P) (with a VLM's ``patches`` and an
    encoder-decoder's ``frames``, numpy or tensors), grow the cache to P
    + gen, take the greedy token, then ``gen - 1`` decode steps with the
    position on the device (``train.steps.DecodeReplay``).  On the card
    the first step runs eagerly and the rest replay it as one CUDA graph,
    captured once; ``graph=False`` runs every step eagerly (the same
    kernels; the CPU always does).  Returns the (B, gen) tokens (numpy
    int32), the cache, the prefill's milliseconds (with the grow), each
    decode step's (CUDA events on the card, so a step's time includes
    the device waiting for the host; the capture lies outside them),
    the number of captures, whether the steps replayed a graph
    (``graph``) and the process group's backend (``backend``, None off
    one).

    ``spmd`` (``train.steps.serving_spmd``, the model this rank's blocks,
    ``load_model``): the steps run under it, each rank on its rows of
    the batch (``dist.sharding.serving_rows``; where they differ over
    the data-parallel ranks, ``spmd.rows`` says so, and the MoE layer
    groups the whole batch's tokens, ``models.model.moe_groups``) and,
    over ``model``, its blocks; the cache is this rank's.  On NCCL the
    step is captured with its collectives; gloo's cannot be, and every
    step runs eagerly, decided from the backend before the first step.
    Every rank returns the whole batch's tokens."""
    import torch

    from repro_torch.train import steps

    B, P = prompts.shape
    on_cuda = model.device.type == "cuda"
    backend = None
    rows = (0, B)
    if spmd is not None:
        import torch.distributed as dist

        from repro_torch.dist.sharding import serving_rows
        from repro_torch.dist.spmd import RowGroup
        backend = dist.get_backend(spmd.model_group)
        rows = serving_rows(cfg, B, spmd)
        if rows[1] - rows[0] < B:
            spmd.rows = RowGroup(spmd.dp_group, spmd.dpn)
    capture = graph and on_cuda and gen > 2 and backend in (None, "nccl")
    spans = []

    def span():
        """A (start, stop) pair of marks: CUDA events or host clocks."""
        if on_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            spans.append(ev)
            ev[0].record()
            return ev[1].record
        spans.append([time.perf_counter(), None])
        return lambda s=spans[-1]: s.__setitem__(1, time.perf_counter())

    lo, hi = rows
    batch = {"tokens": torch.as_tensor(
        np.asarray(prompts, np.int32)[lo:hi], device=model.device)}
    for name, a in (("patches", patches), ("frames", frames)):
        if a is not None:
            batch[name] = torch.as_tensor(a[lo:hi], device=model.device)
    stop = span()
    logits, cache = steps.make_prefill_step(cfg, spmd)(model, batch)
    cache = grow_cache(cfg, cache, P + gen)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    stop()
    del logits
    out = [tok]
    replay = steps.DecodeReplay(cfg, model, cache, tok, P, spmd)
    for i in range(gen - 1):
        stop = span()
        out.append(replay())
        stop()
        if i == 0 and capture:
            replay.capture()
    if on_cuda:
        spans[-1][1].synchronize()
        ms = [a.elapsed_time(b) for a, b in spans]
    else:
        ms = [(b - a) * 1e3 for a, b in spans]
    tokens = torch.stack(out, dim=1)
    if hi - lo < B:
        from repro_torch.dist.spmd import all_gather_cat
        tokens = all_gather_cat(tokens, 0, spmd.dp_group, spmd.dpn)
    return {"tokens": tokens.cpu().numpy(), "cache": cache,
            "prefill_ms": ms[0], "step_ms": ms[1:],
            "captures": replay.captures, "graph": replay.captures > 0,
            "backend": backend}


def draw_inputs(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """The reference's ``--arch`` inputs from ``np.random.default_rng(
    seed)``: the prompts (B, P) int32, then a VLM's ``patches`` (B,
    n_patches, D) and an encoder-decoder's ``frames`` (B, encoder_frames,
    D), float32 standard normal, in that order (``None`` for the other
    families)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    patches = frames = None
    if cfg.family == "vlm":
        patches = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        frames = rng.standard_normal(
            (batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return {"prompts": prompts, "patches": patches, "frames": frames}


def load_model(cfg, seed: int, device, tp=None):
    """Random parameters from a ``torch.Generator`` on ``device`` seeded
    with ``seed``, each leaf drawn in ``cfg.param_dtype`` and cast to
    ``cfg.compute_dtype`` as it is drawn (the peak is the cast model and
    one leaf in ``param_dtype``).  ``tp`` (a serving rank's
    ``TensorParallel``): every leaf is drawn as the one-device run draws
    it and this rank keeps its block (``dist.sharding.param_block``), so
    its peak is its blocks and one whole leaf, and its numbers are the
    unsharded model's."""
    import torch

    from repro_torch.core.codegen import resolve_device
    from repro_torch.dist.sharding import param_block, take_block
    from repro_torch.models import init_params
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = None if tp is None else (
        lambda name, t: take_block(t, param_block(cfg, name, t.shape, tp)))
    return init_params(cfg, gen, dev,
                       dtype=getattr(torch, cfg.compute_dtype), keep=keep)


def refuse_model_parallel(cfg, model_parallel: int, prompt_len: int):
    """Raise ``ValueError``, before any rank starts, for what a later
    tensor-parallel slice brings to ``--model-parallel``: the hybrid
    family, head, SSD-head, ``d_ff``, expert-column or KV-head counts the
    axis does not divide, ranks reading part of two KV groups
    (``train.steps.tensor_parallel_split(..., serving=True)``), and a
    prompt the axis does not divide (the prefill cuts the sequence over
    it)."""
    from repro_torch.train.steps import tensor_parallel_split
    if model_parallel <= 1:
        return
    try:
        tensor_parallel_split(cfg, model_parallel, serving=True)
    except NotImplementedError as e:
        raise ValueError(f"--model-parallel {model_parallel}: {e}") from None
    if prompt_len % model_parallel:
        raise ValueError(
            f"--model-parallel {model_parallel}: a prompt of {prompt_len} "
            f"positions does not split over {model_parallel} "
            f"tensor-parallel ranks (the prefill cuts the sequence); a "
            f"split the axis does not divide comes with a later "
            f"tensor-parallel slice (ROADMAP.md)")


def serve_arch(args, argv=None):
    """``--arch``: prompts (and a VLM's patches, an encoder-decoder's
    frames) drawn as the reference draws them (``draw_inputs``), a model
    from ``load_model``, then ``generate``; prints the reference's three
    lines and returns the (B, gen) tokens.

    Over a process group (``torchrun``, or the ``--nproc`` ranks it
    starts, each running ``argv`` without ``--nproc``) it serves on
    ``make_host_mesh(--model-parallel)``, as the reference serves under
    that mesh: each rank holds its blocks of the weights
    (``load_model``'s ``tp``) and of the cache, and rank 0 prints.
    ``--model-parallel`` > 1 without a process group raises."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.mesh import join_process_group, make_host_mesh
    from repro_torch.train.steps import serving_spmd
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    B, P, G = args.batch, args.prompt_len, args.gen
    refuse_model_parallel(cfg, args.model_parallel, P)
    if args.nproc:
        import sys

        from repro_torch.dist.spmd import run_ranks
        from repro_torch.launch.mesh import without_nproc
        rest = without_nproc(list(sys.argv[1:] if argv is None else argv))
        return run_ranks(_spawned, args.nproc, rest,
                         backend="gloo" if args.device == "cpu" else "nccl",
                         timeout_s=24 * 3600.0)[0]
    spmd, rank0 = None, True
    if join_process_group(args.device):
        import torch
        import torch.distributed as dist
        spmd = serving_spmd(cfg, make_host_mesh(
            args.model_parallel, torch.device(args.device).type))
        rank0 = dist.get_rank() == 0
    elif args.model_parallel > 1:
        raise ValueError(
            f"--model-parallel {args.model_parallel}: tensor-parallel "
            f"serving runs over a torch.distributed process group: start "
            f"it with --nproc N or torchrun")
    inputs = draw_inputs(cfg, B, P, args.seed)
    model = load_model(cfg, args.seed, args.device,
                       None if spmd is None else spmd.tp)
    res = generate(cfg, model, inputs["prompts"], G,
                   patches=inputs["patches"], frames=inputs["frames"],
                   spmd=spmd)
    t_decode = sum(res["step_ms"]) / 1e3
    tput = B * (G - 1) / max(t_decode, 1e-9)
    if rank0:
        if spmd is not None:
            print(f"mesh: {spmd.describe()}  devices={spmd.world}  "
                  f"backend={res['backend']}  graph={res['graph']}")
        print(f"prefill {P} toks x{B}: {res['prefill_ms']:.1f} ms")
        print(f"decode  {G-1} steps x{B}: {t_decode*1e3:.1f} ms "
              f"({tput:.1f} tok/s)")
        print("sample generation (first sequence):",
              res["tokens"][0][:16].tolist())
    return res["tokens"]


def _spawned(rank: int, world: int, argv: list):
    return main(argv)


def engine_stream(ranges, requests: int, seed: int = 0) -> list:
    """The stream of ``chip_smoke.py``'s engine phase (``--engine``
    serves ``engine_requests``): ``(sequence, n)`` pairs, the
    sequences of ``ranges`` (``{name: (lo, hi)}``) in turn.  Each request
    draws, from ``seed``, its power-of-two bucket uniformly among those
    its sequence's range reaches, then n uniformly inside that bucket
    and the range, so every bucket of a range is served and most sizes
    fall off the bucket grid."""
    rng = np.random.default_rng(seed)
    names = list(ranges)
    out = []
    for i in range(requests):
        name = names[i % len(names)]
        lo, hi = ranges[name]
        buckets = [1 << k for k in range((lo - 1).bit_length(),
                                         (hi - 1).bit_length() + 1)]
        b = int(buckets[rng.integers(len(buckets))])
        out.append((name, int(rng.integers(max(lo, b // 2 + 1),
                                           min(hi, b) + 1))))
    return out


def engine_workload(stream, seed: int = 0) -> list:
    """``(sequence, n, inputs)`` tuples for a stream of ``(sequence,
    n)`` (``engine_requests``, ``engine_stream``), request i's numpy
    inputs made from ``seed + i`` (host arrays, as users send them)."""
    from repro_torch.programs import REGISTRY, make_inputs
    return [(nm, n, make_inputs(REGISTRY[nm], n, seed=seed + i))
            for i, (nm, n) in enumerate(stream)]


#: ``--engine``'s request sizes: the reference's defaults, and ``--quick``'s
ENGINE_SIZES = (256, 1000, 1024, 2048)
QUICK_SIZES = (64, 100, 128)


def engine_requests(names, sizes, requests: int) -> list:
    """The reference's ``--engine`` workload: request i is
    ``(names[i % len(names)], sizes[i % len(sizes)])`` (its inputs come
    from ``seed + i``, ``engine_workload``)."""
    return [(names[i % len(names)], sizes[i % len(sizes)])
            for i in range(requests)]


def serve_engine(args) -> dict:
    """A mixed-size workload through the batched ``ServingEngine``: the
    reference's (``engine_requests`` over ``--sizes``, the exact list of
    sizes, or the defaults or ``--quick``'s)."""
    from repro_torch.core import V5E, FusionCompiler
    from repro_torch.programs import REGISTRY
    from repro_torch.serving import ServingEngine, ShardedServingEngine

    names = [s.strip() for s in args.blas.split(",")]
    for nm in names:
        if nm not in REGISTRY:
            raise SystemExit(f"unknown sequence {nm!r}; "
                             f"choose from {', '.join(REGISTRY)}")
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        sizes = list(QUICK_SIZES if args.quick else ENGINE_SIZES)
    lo = min(sizes)
    stream = engine_requests(names, sizes, args.requests)
    mode = "autotune" if args.autotune else args.mode
    cc = FusionCompiler(backend=args.backend, device=args.device,
                        hw="calibrate" if args.autotune else V5E,
                        autotune_budget=args.budget)
    min_bucket = 1 << (min(64, lo).bit_length() - 1)
    if args.sharded:
        from repro_torch.launch.mesh import make_data_mesh
        # the sharded engine pins max_pack to 1 (ShardedServingEngine)
        engine = ShardedServingEngine(
            make_data_mesh(args.devices or None, device=args.device),
            compiler=cc, max_batch=args.max_batch, min_bucket=min_bucket,
            registry=REGISTRY, mode=mode)
        print(f"sharded engine: {engine.n_replicas} replicas, "
              f"max_batch {engine.max_batch}")
    else:
        engine = ServingEngine(compiler=cc, max_batch=args.max_batch,
                               min_bucket=min_bucket, registry=REGISTRY,
                               max_pack=args.max_pack, mode=mode)
    t0 = time.perf_counter()
    # warm packs once over the full key set, not per sequence
    buckets = {nm: engine.warm(nm, sizes, trace_packs=False) for nm in names}
    if not args.sharded:
        engine.warm_packs()
    t_warm = time.perf_counter() - t0

    workload = engine_workload(stream, args.seed)
    t0 = time.perf_counter()
    results = engine.serve(workload, rate_hz=args.rate or None)
    t_serve = time.perf_counter() - t0

    lat = np.sort([r.latency_s for r in results])
    p50 = float(lat[len(lat) // 2]) if len(lat) else 0.0
    p99 = float(lat[min(len(lat) - 1, int(len(lat) * 0.99))]) if len(lat) \
        else 0.0
    rps = len(results) / max(t_serve, 1e-9)
    st = engine.stats()
    print(f"engine {','.join(names)} sizes={sizes} buckets={buckets} "
          f"device={engine.device}: warm {t_warm*1e3:.1f} ms, "
          f"{len(results)} requests in {t_serve*1e3:.1f} ms "
          f"({t_serve / max(len(results), 1) * 1e6:.1f} us/req)")
    print(f"  throughput {rps:.1f} req/s | latency p50 {p50*1e3:.2f} ms "
          f"p99 {p99*1e3:.2f} ms | {st['n_dispatches']} dispatches, "
          f"batch occupancy {st['batch_occupancy']:.2f}")
    qw = st["queue_wait"]
    if qw and qw["count"]:
        print(f"  queue wait p50 {qw['p50_ms']:.2f} ms "
              f"p99 {qw['p99_ms']:.2f} ms ({qw['count']} waits)")
    if st["n_packed_dispatches"]:
        print(f"  packed dispatches: {st['n_packed_dispatches']} carrying "
              f"{st['n_packed_members']} member batches "
              f"(max_pack {st['max_pack']})")
    print(f"  bucket stats: {st['cache']['buckets']}")
    if args.sharded:
        print(f"  replica rows: {st['replica_rows']}")
    return {"throughput_rps": rps, "p50_s": p50, "p99_s": p99,
            "t_warm_s": t_warm, "t_serve_s": t_serve,
            "n_results": len(results), "stats": st}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help="serve a language model of "
                    "repro_torch.configs (e.g. llama3_8b)")
    ap.add_argument("--blas",
                    help="BLAS sequence to serve (e.g. GEMVER), or with "
                    "--engine a comma-separated list (GEMVER,BiCGK)")
    ap.add_argument("--engine", action="store_true",
                    help="batched ServingEngine (shape buckets, batched "
                    "and packed dispatches) over a mixed-size workload")
    ap.add_argument("--backend", default="cuda",
                    help="'cuda' (generated kernels) or 'torch' (plain "
                    "tensor code per group)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' or 'cpu'")
    ap.add_argument("--mode", type=_mode, default="best",
                    help="'best', 'unfused' or an integer rank")
    ap.add_argument("--autotune", action="store_true",
                    help="calibrate the cost model on the device and "
                    "measure the --budget best predicted candidates "
                    "(mode 'autotune')")
    ap.add_argument("--refit", action="store_true",
                    help="after --autotune: refit the cost model to the "
                    "measured groups and recompile with 'best' under it")
    ap.add_argument("--budget", type=int, default=8,
                    help="candidates --autotune measures (default 8)")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--sizes",
                    help="with --engine: comma-separated request sizes, "
                    "request i of size i mod their count (default "
                    "256,1000,1024,2048; --quick: 64,100,128)")
    ap.add_argument("--quick", action="store_true",
                    help="with --engine: the small sizes 64,100,128")
    ap.add_argument("--sharded", action="store_true",
                    help="with --engine: spread every dispatch over a "
                    "replica mesh of --devices replicas")
    ap.add_argument("--devices", type=int, default=0,
                    help="with --engine --sharded: replicas on --device "
                    "(default: every GPU present; on the CPU, 1)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-pack", type=int, default=8,
                    help="with --engine: most (sequence, bucket) batches "
                    "merged into one packed dispatch per drain round (1 "
                    "disables packing)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in req/s for --engine "
                    "(0 = closed loop)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the config's reduced smoke size")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="with --arch: split each layer over this many "
                    "ranks of a process group (torchrun, or --nproc)")
    ap.add_argument("--nproc", type=int, default=0,
                    help="with --arch: start this many ranks (gloo with "
                    "--device cpu, NCCL one a GPU) and serve over them")
    args = ap.parse_args(argv)

    from repro_torch.core.diagnostics import KNOWN_BACKENDS, VerificationError
    if args.backend not in KNOWN_BACKENDS:
        raise VerificationError.single(
            "RPL401", "cli.--backend",
            f"unknown backend {args.backend!r}",
            f"valid backends: {', '.join(KNOWN_BACKENDS)}")
    if (args.sharded or args.devices) and not (args.engine and args.sharded):
        ap.error("--sharded and --devices go with --engine --sharded")
    if args.blas:
        return serve_engine(args) if args.engine else serve_blas(args)
    if not args.arch:
        ap.error("one of --arch or --blas is required")
    return serve_arch(args, argv)


if __name__ == "__main__":
    main()
