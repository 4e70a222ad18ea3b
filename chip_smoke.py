#!/usr/bin/env python3
"""Smoke run of the port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path — ``FusionCompiler.compile`` (trace, fusion
search, plan) and execution through one generated CUDA kernel (K1) per
fused group — for all 11 BLAS sequences of the paper, in modes ``best``
and ``unfused``, at the data scale users run: BLAS-2 sequences at
n = 4096 (A is 64 MiB in float32, above the 50 MB L2) and BLAS-1
sequences at n = 2**24 (64 MiB a vector).  Inputs are random, made from
a seed with numpy.  Phases, each printed as one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), and the
   build of every plan's kernels (one ``nvcc`` per plan, in parallel);
2. kernel: every group's kernel against K1's plain tiled version on the
   same inputs on the card;
3. main path: every program's outputs against the sequence's numpy
   reference in float64, and the launch counts of that run, which must
   show every group of every plan launched once;
4. serving: ``serve_blas`` for GEMVER at n = 4096, 100 requests, in
   ``best`` and ``unfused`` (CUDA events);
5. times: each group's kernel time beside its bound (compulsory bytes
   over 3.35 TB/s, or float32 operations over 67 TFLOP/s), the plain
   version's time, and one PyTorch call computing the same function
   where there is one (checked against the kernel once, timed here
   only, never used by the port).  ``ms`` and ``library_ms`` are device
   times: the launches are queued behind a spinning kernel, so the host
   path between them is hidden, and ``ms`` excludes the combine of
   ``partial`` outputs after the kernel.  ``wrapper_ms`` is the
   wrapper's whole path per call, launched back to back (checks, output
   allocation, the ctypes call, the combine): where it exceeds ``ms``,
   the host is the limit.

Tolerances: float32 sums over 4096 to 2**24 terms run in another order
in the kernel, the plain version and numpy, so results are held to a
norm-relative error of 1e-4 (``||got - want|| <= 1e-4 * ||want||``).

The last lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``; the card's ``nvidia-smi`` line is in
the first (``device``) record.  Any failed
phase ends the run with exit code 1 and no result line; so does a
machine without CUDA, or a directory without the repository.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

MODES = ("best", "unfused")
BLAS1 = ("AXPYDOT", "VADD", "WAXPBY", "SSCAL")
RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
REPLACES = "src/repro/core/codegen.py:96"
SOURCE = "src/repro_torch/core/cuda_codegen.py"


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def norm_rel(got, want) -> float:
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = float(np.linalg.norm(want.ravel()))
    num = float(np.linalg.norm((got - want).ravel()))
    return num / den if den > 0 else num


def time_ms(fn, budget_ms: float = 300.0, max_reps: int = 50,
            warmup: bool = True) -> float:
    """Mean time per call of ``fn`` called back to back (CUDA events),
    after one warm-up call (``warmup``); ``max_reps=1`` times one call.
    Calls whose host path outlasts their device work are timed at the
    host's pace."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    first = start.elapsed_time(end)
    if max_reps == 1:
        return first
    reps = max(1, min(max_reps, int(budget_ms / max(first, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, budget_ms: float = 300.0, max_reps: int = 100) -> float:
    """Mean device time per call of ``fn``: the calls are queued behind a
    spinning kernel long enough to cover their host path (50 us a call),
    so the events see the device run them back to back."""
    import torch
    fn()
    first = time_ms(fn, max_reps=1, warmup=False)
    reps = max(3, min(max_reps, int(budget_ms / max(first, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(reps * 50e-6 * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_call(im, args):
    """One PyTorch call computing a lone group's function, or None."""
    import torch
    calls = im.fusion.calls
    if len(calls) != 1:
        return None
    name = calls[0].elem.name
    if name == "gemv":
        return lambda: torch.mv(args[0], args[1])
    if name == "gemtv":
        return lambda: torch.mv(args[0].T, args[1])
    if name in ("ew_add", "madd"):
        return lambda: torch.add(args[0], args[1])
    if name in ("scal", "ew_mul"):
        return lambda: torch.mul(args[0], args[1])
    if name in ("axpy", "xpay"):                  # a*x + y
        return lambda: torch.addcmul(args[2], args[0], args[1])
    if name == "axmy":                            # w - a*v
        return lambda: torch.addcmul(args[1], args[0], args[2], value=-1)
    if name == "sum_reduce":
        return lambda: torch.sum(args[0])
    return None


def bound(im):
    """Least time for the group's work: each input read once, each output
    written once, against the float32 operations it does."""
    f = im.fusion
    nbytes = sum(v.nbytes for v in f.external_inputs) + \
        sum(v.nbytes for v in f.outputs)
    ops = sum(c.elem.flops(c.axis_sizes) for c in f.calls)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None):
    ap = argparse.ArgumentParser(description="port smoke run on one GPU")
    ap.add_argument("--n2", type=int, default=4096,
                    help="size of the BLAS-2 sequences")
    ap.add_argument("--n1", type=int, default=1 << 24,
                    help="size of the BLAS-1 sequences")
    ap.add_argument("--requests", type=int, default=100)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    try:
        from repro_torch.core import (LAUNCHES, FusionCompiler, PlanCache,
                                      tiled_reference)
        from repro_torch.launch.serve import serve_blas
        from repro_torch.programs import BLAS, make_inputs
    except ImportError as e:
        fail(f"cannot import the port from {ROOT}/src: {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
           for m in sys.modules):
        fail("the port imported jax or the reference package")
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    dev_name = torch.cuda.get_device_name(0)
    failures: list[str] = []

    def size(name):
        return args.n1 if name in BLAS1 else args.n2

    # -- 1. plan every sequence, build every plan's kernels in parallel -----
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    keys = [(name, mode) for name in BLAS for mode in MODES]
    t0 = time.perf_counter()
    progs = {k: cc.compile(BLAS[k[0]].script, BLAS[k[0]].shapes(size(k[0])),
                           mode=k[1], label=f"{k[0]}/{k[1]}") for k in keys}
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        futs = {k: pool.submit(p.module.build) for k, p in progs.items()}
        for k, fut in futs.items():
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — reported, then fail
                failures.append(f"build {k}: {e}")
    t_build = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi_line, "device": dev_name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "plans": len(keys), "plan_s": t_plan, "build_s": t_build,
          "n_blas2": args.n2, "n_blas1": args.n1})
    if failures:
        fail("; ".join(failures))

    inputs = {name: make_inputs(BLAS[name], size(name), seed=0)
              for name in BLAS}
    dev_inputs = {k: progs[k].prepare(**inputs[k[0]]) for k in keys}

    def group_args(prog, outs_so_far, gp, ins):
        vals = dict(zip(prog.plan.input_names, ins))
        return [vals[r[1]] if r[0] == "input" else outs_so_far[r[1]][r[2]]
                for r in gp.inputs]

    # -- 2. kernel phase: each group against the plain tiled version ---------
    kernel_err, group_in, kernel_out = {}, {}, {}
    for k in keys:
        prog = progs[k]
        outs_so_far = []
        for gi, (gp, fn, im) in enumerate(zip(prog.plan.groups,
                                              prog.group_fns,
                                              prog.group_impls)):
            a = group_args(prog, outs_so_far, gp, dev_inputs[k])
            try:
                got = fn.launch(*a)
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001
                failures.append(f"kernel {fn.name}: {e}")
                got = None
            want = tiled_reference(prog.graph, im, *a)
            if got is not None:
                errs = [norm_rel(x.cpu().numpy(), y.cpu().numpy())
                        for x, y in zip(got, want)]
                mabs = max(float((x - y).abs().max()) for x, y in
                           zip(got, want))
                kernel_err[fn.name] = mabs
                kernel_out[fn.name] = got
                emit({"phase": "kernel", "kernel": fn.name,
                      "max_abs_err": mabs, "norm_rel_err": max(errs)})
                if not max(errs) <= RTOL:
                    failures.append(f"kernel {fn.name}: norm-relative error "
                                    f"{max(errs):.3g} > {RTOL}")
            group_in[fn.name] = (prog, im, a)
            outs_so_far.append(want)
    if failures:
        fail("; ".join(failures))

    # -- 3. main path: programs against float64 numpy, counting launches -----
    outs = {}
    LAUNCHES.reset()
    for k in keys:
        outs[k] = progs[k](**inputs[k[0]])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES.by_kernel)
    for k in keys:
        name, mode = k
        prog = progs[k]
        got = outs[k] if isinstance(outs[k], tuple) else (outs[k],)
        ref = BLAS[name].reference(**{n: np.asarray(x, np.float64)
                                      for n, x in inputs[name].items()})
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [norm_rel(x.cpu().numpy(), r) for x, r in zip(got, ref)]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = all(tuple(x.shape) == np.shape(r) for x, r in zip(got, ref))
        counts = [launches.get(fn.name, 0) for fn in prog.group_fns]
        emit({"phase": "main", "program": name, "mode": mode,
              "n": size(name), "groups": prog.n_groups, "launches": counts,
              "norm_rel_err": max(errs), "finite": finite})
        if not (max(errs) <= RTOL and finite and shapes):
            failures.append(f"main {name}/{mode}: error {max(errs):.3g}, "
                            f"finite {finite}, shapes {shapes}")
        if counts != [1] * prog.n_groups:
            failures.append(f"main {name}/{mode}: launch counts {counts}, "
                            f"want one per group")
    if failures:
        fail("; ".join(failures))

    # -- 4. serving ------------------------------------------------------------
    for mode in MODES:
        res = serve_blas(argparse.Namespace(
            blas="GEMVER", n=args.n2, requests=args.requests, mode=mode,
            backend="cuda", device="cuda", seed=0))
        emit({"phase": "serve", "program": "GEMVER", "n": args.n2,
              "mode": mode, "requests": args.requests,
              "us_per_request": res["us_per_request"],
              "kernel_launches": res["kernel_launches"],
              "groups": res["n_groups"]})
        if res["kernel_launches"] != args.requests * res["n_groups"]:
            failures.append(f"serve GEMVER/{mode}: "
                            f"{res['kernel_launches']} launches")
    if failures:
        fail("; ".join(failures))

    # -- 5. times ------------------------------------------------------------
    records = []
    for k in keys:
        for fn in progs[k].group_fns:
            prog, im, a = group_in[fn.name]
            raw, ws = fn.buffers(a[0].device)
            ms = device_ms(lambda: fn.launch_into(a, raw, ws))
            wrapper_ms = time_ms(lambda: fn.launch(*a))
            plain_ms = time_ms(lambda: tiled_reference(prog.graph, im, *a),
                               max_reps=1, warmup=False)
            lib = library_call(im, a)
            lib_ms = lib_err = None
            if lib is not None:
                lib_err = norm_rel(lib().cpu().numpy(),
                                   kernel_out[fn.name][0].cpu().numpy())
                if not lib_err <= RTOL:
                    failures.append(f"library call for {fn.name} disagrees "
                                    f"with the kernel: {lib_err:.3g}")
                lib_ms = device_ms(lib)
            b_ms, b_by = bound(im)
            rec = {"name": fn.name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES, "launches": launches.get(fn.name, 0),
                   "max_abs_err": kernel_err[fn.name], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
            records.append(rec)
            emit({"phase": "time", **rec, "wrapper_ms": wrapper_ms,
                  "library_norm_rel_err": lib_err, "grid": list(im.grid),
                  "blocks": list(im.blocks),
                  "units": fn.layout.units, "bound_share": b_ms / ms})
    if failures:
        fail("; ".join(failures))

    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
