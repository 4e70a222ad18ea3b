"""BLAS-sequence serving: compile one paper sequence through the plan
cache, then serve a request loop where each request runs every group of
the plan — on the ``cuda`` backend one generated kernel per group.

    PYTHONPATH=src python -m repro_torch.launch.serve --blas GEMVER \
        --n 4096 --requests 100

Runs on the GPU by default; ``--device cpu`` runs the same path on the
CPU (K1's plain tiled version stands in for the kernels there).
Requests on the GPU are timed with CUDA events around the whole loop.
"""
from __future__ import annotations

import argparse
import time


def _mode(text: str):
    return int(text) if text.lstrip("-").isdigit() else text


def serve_blas(args) -> dict:
    """Request loop over one compiled BLAS sequence.

    Compile #1 populates the plan cache, compile #2 is served from the
    program cache, and each request launches one kernel per plan
    group."""
    import torch

    from repro_torch.blas import REGISTRY, make_inputs
    from repro_torch.core import LAUNCHES, FusionCompiler, PlanCache

    if args.blas not in REGISTRY:
        raise SystemExit(f"unknown sequence {args.blas!r}; "
                         f"choose from {', '.join(REGISTRY)}")
    seq = REGISTRY[args.blas]
    cache = PlanCache()
    cc = FusionCompiler(cache=cache, backend=args.backend, device=args.device)
    label = f"serve/{args.blas}/{args.mode}"

    t0 = time.perf_counter()
    prog = cc.compile(seq.script, seq.shapes(args.n), mode=args.mode,
                      label=label)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc.compile(seq.script, seq.shapes(args.n), mode=args.mode, label=label)
    t_recompile = time.perf_counter() - t0

    inputs = prog.prepare(**make_inputs(seq, args.n, seed=args.seed))
    prog.fn(*inputs)                              # warm-up
    prog.synchronize()

    launches0 = LAUNCHES.total
    if prog.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.requests):
            prog.fn(*inputs)
        end.record()
        torch.cuda.synchronize(prog.device)
        t_serve = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            prog.fn(*inputs)
        t_serve = time.perf_counter() - t0
    launches = LAUNCHES.total - launches0

    us_per_req = t_serve / max(args.requests, 1) * 1e6
    stats = cache.stats.as_dict()
    print(f"serve {args.blas} n={args.n} mode={args.mode} "
          f"backend={args.backend} device={prog.device}: compile "
          f"{t_compile*1e3:.1f} ms, recompile {t_recompile*1e6:.0f} us "
          f"(cache hit), {args.requests} requests at {us_per_req:.1f} "
          f"us/req ({prog.n_groups} groups, {launches} kernel launches)")
    print(f"cache stats: {stats}")
    return {"t_compile_s": t_compile, "t_recompile_s": t_recompile,
            "us_per_request": us_per_req, "n_groups": prog.n_groups,
            "kernel_launches": launches, "device": str(prog.device),
            "cache": stats}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blas", required=True,
                    help="BLAS sequence to serve (e.g. GEMVER)")
    ap.add_argument("--backend", default="cuda",
                    help="'cuda' (generated kernels) or 'torch' (plain "
                    "tensor code per group)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' or 'cpu'")
    ap.add_argument("--mode", type=_mode, default="best",
                    help="'best', 'unfused' or an integer rank")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core.diagnostics import KNOWN_BACKENDS, VerificationError
    if args.backend not in KNOWN_BACKENDS:
        raise VerificationError.single(
            "RPL401", "cli.--backend",
            f"unknown backend {args.backend!r}",
            f"valid backends: {', '.join(KNOWN_BACKENDS)}")
    return serve_blas(args)


if __name__ == "__main__":
    main()
