#!/usr/bin/env python3
"""Smoke run of the port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's two paths at the data scale users run, with random
inputs made from a seed:

* the compiler's main path — ``FusionCompiler.compile`` (trace, fusion
  search, plan) and execution through one generated CUDA kernel (K1) per
  fused group — for the paper's 11 BLAS sequences and the LM programs
  ``LM_RMSNORM`` and ``LM_BLOCK``, in modes ``best`` and ``unfused``:
  BLAS-2 and LM programs at n = 4096 (A is 64 MiB in float32, above the
  50 MB L2), BLAS-1 sequences at n = 2**24 (64 MiB a vector);
* the hand kernels through ``repro_torch.kernels.ops``: K2 (BiCGK) and
  K3 (GEMVER) at n = 4096, K4 (RMSNorm) on one 4096-wide row as
  ``LM_RMSNORM`` and on a (8192, 4096) prefill (the ``d_model`` of
  Llama-3-8B) in float32 and bfloat16.

Phases, each printed as JSON lines:

1. device: the card's name and power limit (``nvidia-smi``), and the
   build of every plan's kernels and of the hand kernels (one ``nvcc``
   per source, in parallel);
2. kernel: every K1 group's kernel against K1's plain tiled version on
   the same inputs on the card;
3. main: every program's outputs against its numpy reference in
   float64, and the launch counts of that run, which must show every
   group of every plan launched once;
4. hand: K2, K3 and K4 against their plain versions (``kernels.ref``) on
   the card, at the main shapes and at a non-square (4096, 6144), an odd
   (1000, 1531), and RMSNorm rows of (1, 4096) and (7, 33);
5. hand_main: the ``ops`` path, counts set to 0 just before it and read
   just after: every hand kernel launched, outputs against float64
   numpy;
6. serve: ``serve_blas`` for GEMVER at n = 4096, 100 requests, in
   ``best`` and ``unfused`` (CUDA events);
7. series: the paper's comparison for GEMVER, BiCGK and LM_RMSNORM at
   n = 4096 — compiler ``best`` and ``unfused``, the hand kernels, the
   ``torch`` backend, and the library-call sequence the paper measures
   against (cuBLAS matvecs and rank-1 updates; ``F.rms_norm``), timed
   only, never used by the port — outputs cross-checked first, then µs
   per request back to back (``*_us``) and as device time
   (``*_device_us``), beside each hand kernel's bound;
8. time: each kernel's time beside its bound (compulsory bytes over
   3.35 TB/s, or float32 operations over 67 TFLOP/s), the plain
   version's time, and one PyTorch call computing the same function
   where there is one (checked against the kernel once, timed here
   only, never used by the port).  ``ms`` and ``library_ms`` are device
   times: the launches are queued behind a spinning kernel, so the host
   path between them is hidden.  For K1 ``ms`` excludes the combine of
   ``partial`` outputs after the kernel; for K2-K4 it is the wrapper's
   whole device work (the kernel and the sum of its partials).
   ``wrapper_ms`` is the wrapper's whole path per call, launched back
   to back (checks, output allocation, the ctypes call, the combine):
   where it exceeds ``ms``, the host is the limit.

Tolerances: float32 sums over 4096 to 2**24 terms run in another order
in the kernels, the plain versions and numpy, so float32 results are
held to a norm-relative error of 1e-4 (``||got - want|| <= 1e-4 *
||want||``).  The bfloat16 RMSNorm kernel and its plain version both
accumulate in float32 and round once to bfloat16, so they differ only
where the rounding of an output flips by one unit: that kernel is held
to 1e-3 against its plain version.  Against float64, and against the
library's ``rms_norm`` (which takes gamma in bfloat16), bfloat16
outputs (8 bits of mantissa) are held to 2e-2.

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
LM = ("LM_RMSNORM", "LM_BLOCK")
#: the paper's three-way comparison (``benchmarks/fused_kernels.py``)
SERIES = ("GEMVER", "BiCGK", "LM_RMSNORM")
RTOL = 1e-4
#: bfloat16 kernel against its plain version (one rounding each)
BF16_KERNEL_RTOL = 1e-3
#: bfloat16 output against float64 or another bfloat16 computation
BF16_RTOL = 2e-2
#: GEMVER's scalars in the hand phase
ALPHA, BETA = 1.3, 0.7
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
REPLACES = "src/repro/core/codegen.py:96"
SOURCE = "src/repro_torch/core/cuda_codegen.py"
#: hand kernels by launch-counter name: (CUDA source, TPU kernel replaced)
HAND = {
    "K2/bicgk": ("src/repro_torch/csrc/bicgk.cu",
                 "src/repro/kernels/bicgk.py:20"),
    "K3/gemver_k1": ("src/repro_torch/csrc/gemver.cu",
                     "src/repro/kernels/gemver.py:26"),
    "K3/gemver_k2": ("src/repro_torch/csrc/gemver.cu",
                     "src/repro/kernels/gemver.py:38"),
    "K4/rmsnorm_f32": ("src/repro_torch/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:18"),
    "K4/rmsnorm_bf16": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:18"),
}
#: RMSNorm prefill rows: 8192 tokens at Llama-3-8B's d_model
#: (src/repro/configs/llama3_8b.py:6)
PREFILL = (8192, 4096)


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
    spinning kernel that lasts twice their measured host path, so the
    events see the device run them back to back."""
    import torch
    fn()
    first = time_ms(fn, max_reps=1, warmup=False)
    reps = max(3, min(max_reps, int(budget_ms / max(first, 1e-3))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()                    # enqueue only: the host path of one call
    host_s = (time.perf_counter() - t0) / 3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # the spin counts cycles; 2e9 a second is above the H100's clock
    torch.cuda._sleep(int(reps * max(50e-6, 2 * host_s) * 2e9))
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
    ext = list(im.fusion.external_inputs)     # x*x reads x once
    args = [args[ext.index(v)] for v in calls[0].args]
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


def bound_of(nbytes: float, ops: float):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the float32 operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(im):
    """Least time for the group's work: each input read once, each output
    written once, against the float32 operations it does."""
    f = im.fusion
    nbytes = sum(v.nbytes for v in f.external_inputs) + \
        sum(v.nbytes for v in f.outputs)
    return bound_of(nbytes, sum(c.elem.flops(c.axis_sizes) for c in f.calls))


def hand_bound(kernel: str, shape):
    """Least time for a hand kernel's function at ``shape``: its inputs
    read once and its outputs written once (float32 vectors and scalars),
    against its float32 operations."""
    a, b = shape
    if kernel == "K2/bicgk":                # A, p, r -> q, s
        return bound_of(4 * (a * b + 2 * a + 2 * b), 4 * a * b)
    if kernel == "K3/gemver_k1":            # A, u1, v1, u2, v2, y -> B, t
        return bound_of(4 * (2 * a * b + 3 * a + 3 * b), 6 * a * b)
    if kernel == "K3/gemver_k2":            # B, x, alpha -> w
        return bound_of(4 * (a * b + b + 1 + a), 2 * a * b + a)
    es = 2 if kernel.endswith("bf16") else 4    # x -> out, gamma float32
    return bound_of(2 * es * a * b + 4 * b, 4 * a * b)


def tensor_err(got, want):
    """(norm-relative error, max abs error) of tensors, in float64 on
    their device."""
    g, w = got.double(), want.double()
    den = float(w.norm())
    num = float((g - w).norm())
    return (num / den if den > 0 else num), float((g - w).abs().max())


def hand_calls(name, d):
    """The ``ops`` call serving program ``name`` on device inputs ``d``,
    with the program's outputs in order."""
    from repro_torch.kernels import ops
    if name == "GEMVER":
        return lambda: ops.gemver(d["A"], d["u1"], d["v1"], d["u2"], d["v2"],
                                  d["y"], d["z"], d["alpha"], d["beta"])
    if name == "BiCGK":
        return lambda: ops.bicgk(d["A"], d["p"], d["r"])
    return lambda: (ops.rmsnorm(d["x"][None], d["gamma"])[0],)


def library_sequence(name, d):
    """The library calls the paper measures a program against: cuBLAS
    matvecs and rank-1 updates, or one ``F.rms_norm``.  Timed here only;
    the port never calls them.  None where the library has no call."""
    import torch
    if name == "GEMVER":
        alpha, beta = float(d["alpha"]), float(d["beta"])

        def gemver():
            B = torch.addr(d["A"], d["u1"], d["v1"])
            B = torch.addr(B, d["u2"], d["v2"])
            x = torch.addmv(d["z"], B.T, d["y"], alpha=beta)
            return B, x, torch.mv(B, x).mul_(alpha)
        return gemver
    if name == "BiCGK":
        return lambda: (torch.mv(d["A"], d["p"]), torch.mv(d["A"].T, d["r"]))
    if not hasattr(torch.nn.functional, "rms_norm"):
        return None
    n = d["x"].shape[0]
    return lambda: (torch.nn.functional.rms_norm(
        d["x"][None], (n,), d["gamma"], eps=1e-6)[0],)


def main(argv=None):
    ap = argparse.ArgumentParser(description="port smoke run on one GPU")
    ap.add_argument("--n2", type=int, default=4096,
                    help="size of the BLAS-2 sequences, the LM programs "
                         "and the hand kernels' square matrices")
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
        from repro_torch.kernels import bicgk as k2
        from repro_torch.kernels import gemver as k3
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import rmsnorm as k4
        from repro_torch.launch.serve import serve_blas
        from repro_torch.programs import BLAS, REGISTRY, make_inputs
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
    n2 = args.n2

    def size(name):
        return args.n1 if name in BLAS1 else n2

    # -- 1. plan every program, build every kernel in parallel ---------------
    cc = FusionCompiler(backend="cuda", device="cuda", cache=PlanCache())
    keys = [(name, mode) for name in list(BLAS) + list(LM) for mode in MODES]
    t0 = time.perf_counter()
    progs = {k: cc.compile(REGISTRY[k[0]].script,
                           REGISTRY[k[0]].shapes(size(k[0])),
                           mode=k[1], label=f"{k[0]}/{k[1]}") for k in keys}
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        futs = {k: pool.submit(p.module.build) for k, p in progs.items()}
        for src, launcher in (("bicgk.cu", k2._launchers),
                              ("gemver.cu", k3._launchers),
                              ("rmsnorm.cu", k4._launcher)):
            futs[src] = pool.submit(launcher)
        for k, fut in futs.items():
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — reported, then fail
                failures.append(f"build {k}: {e}")
    t_build = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi_line, "device": dev_name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "plans": len(keys), "hand_sources": 3, "plan_s": t_plan,
          "build_s": t_build, "n_blas2": n2, "n_blas1": args.n1})
    if failures:
        fail("; ".join(failures))

    names = list(BLAS) + list(LM)
    inputs = {name: make_inputs(REGISTRY[name], size(name), seed=0)
              for name in names}
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
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in inputs[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        errs = [norm_rel(x.cpu().numpy(), r) for x, r in zip(got, ref64)]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = all(tuple(x.shape) == np.shape(r) for x, r in zip(got, ref64))
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

    # -- 4. hand kernels against their plain versions ------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def check(kernel, shape, dtype, got, want, tol=RTOL):
        errs = [tensor_err(x, y) for x, y in zip(got, want)]
        rel, mabs = max(e[0] for e in errs), max(e[1] for e in errs)
        emit({"phase": "hand", "kernel": kernel, "shape": list(shape),
              "dtype": dtype, "max_abs_err": mabs, "norm_rel_err": rel})
        if not rel <= tol:
            failures.append(f"hand {kernel} {shape} {dtype}: norm-relative "
                            f"error {rel:.3g} > {tol}")
        return mabs

    alpha = torch.tensor(ALPHA, device="cuda")
    beta = torch.tensor(BETA, device="cuda")
    hand_err, hand_in = {}, {}
    for shape in ((n2, n2), (4096, 6144), (1000, 1531)):
        m, n = shape
        A, p, r = randn(m, n), randn(n), randn(m)
        u1, u2, y, v1, v2, z = (randn(m), randn(m), randn(m), randn(n),
                                randn(n), randn(n))
        err = {
            "K2/bicgk": check("K2/bicgk", shape, "float32",
                              k2.bicgk(A, p, r), ref.bicgk(A, p, r)),
            "K3/gemver_k1": check(
                "K3/gemver_k1", shape, "float32",
                k3.gemver_k1(A, u1, v1, u2, v2, y),
                ref.gemver_k1(A, u1, v1, u2, v2, y)),
        }
        B, x, _ = ref.gemver(A, u1, v1, u2, v2, y, z, alpha, beta)
        err["K3/gemver_k2"] = check("K3/gemver_k2", shape, "float32",
                                    (k3.gemver_k2(B, x, alpha),),
                                    (ref.gemver_k2(B, x, alpha),))
        check("K3/gemver", shape, "float32",
              k3.gemver(A, u1, v1, u2, v2, y, z, alpha, beta),
              ref.gemver(A, u1, v1, u2, v2, y, z, alpha, beta))
        if shape == (n2, n2):
            hand_err.update(err)
            k1_in = (A, u1, v1, u2, v2, y)
            hand_in["K2/bicgk"] = (
                shape, lambda a=(A, p, r): k2.bicgk(*a),
                lambda a=(A, p, r): ref.bicgk(*a), None)
            hand_in["K3/gemver_k1"] = (
                shape, lambda a=k1_in: k3.gemver_k1(*a),
                lambda a=k1_in: ref.gemver_k1(*a), None)
            w0 = torch.zeros(m, device="cuda")    # ignored at beta=0
            hand_in["K3/gemver_k2"] = (
                shape, lambda a=(B, x, alpha): k3.gemver_k2(*a),
                lambda a=(B, x, alpha): ref.gemver_k2(*a),
                lambda a=(w0, B, x): torch.addmv(*a, beta=0, alpha=ALPHA))
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    for T, D, dt in ((*PREFILL, "float32"), (*PREFILL, "bfloat16"),
                     (1, n2, "float32"), (7, 33, "float32"),
                     (7, 33, "bfloat16")):
        xx, g = randn(T, D, dtype=getattr(torch, dt)), randn(D)
        kernel = k4.NAMES[xx.dtype]
        mabs = check(kernel, (T, D), dt, (k4.rmsnorm(xx, g),),
                     (ref.rmsnorm(xx, g),),
                     BF16_KERNEL_RTOL if dt == "bfloat16" else RTOL)
        if (T, D) == PREFILL:
            hand_err[kernel] = mabs
            g_lib = g.to(xx.dtype)      # the library takes gamma in x's type
            hand_in[kernel] = (
                (T, D), lambda xx=xx, g=g: k4.rmsnorm(xx, g),
                lambda xx=xx, g=g: ref.rmsnorm(xx, g),
                None if rms_norm is None else
                lambda xx=xx, g=g_lib, D=D: rms_norm(xx, (D,), g, eps=1e-6))
    torch.cuda.synchronize()
    if failures:
        fail("; ".join(failures))

    # -- 5. the hand kernels' path through ops, counting launches -----------
    series_dev = {name: {k: torch.as_tensor(np.asarray(v)).cuda()
                         for k, v in inputs[name].items()} for name in SERIES}
    prefill = {dt: randn(*PREFILL, dtype=getattr(torch, dt))
               for dt in ("float32", "bfloat16")}
    gamma = randn(PREFILL[1])
    LAUNCHES.reset()
    hand_out = {name: hand_calls(name, series_dev[name])() for name in SERIES}
    prefill_out = {dt: ops.rmsnorm(x, gamma) for dt, x in prefill.items()}
    torch.cuda.synchronize()
    hand_launches = dict(LAUNCHES.by_kernel)
    want_counts = {"K2/bicgk": 1, "K3/gemver_k1": 1, "K3/gemver_k2": 1,
                   "K4/rmsnorm_f32": 2, "K4/rmsnorm_bf16": 1}
    for name in SERIES:
        got = hand_out[name]
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in inputs[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        errs = [norm_rel(x.cpu().numpy(), r) for x, r in zip(got, ref64)]
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = all(tuple(x.shape) == np.shape(r) for x, r in zip(got, ref64))
        emit({"phase": "hand_main", "program": name, "n": n2,
              "norm_rel_err": max(errs), "finite": finite})
        if not (max(errs) <= RTOL and finite and shapes):
            failures.append(f"hand_main {name}: error {max(errs):.3g}, "
                            f"finite {finite}, shapes {shapes}")
    for dt, x in prefill.items():
        x64, g64 = x.double(), gamma.double()
        want = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-6) \
            * g64
        rel, _ = tensor_err(prefill_out[dt], want)
        finite = bool(torch.isfinite(prefill_out[dt]).all())
        tol = BF16_RTOL if dt == "bfloat16" else RTOL
        emit({"phase": "hand_main", "program": "rmsnorm", "shape":
              list(PREFILL), "dtype": dt, "norm_rel_err": rel,
              "finite": finite})
        if not (rel <= tol and finite
                and prefill_out[dt].dtype == x.dtype):
            failures.append(f"hand_main rmsnorm {dt}: error {rel:.3g}, "
                            f"finite {finite}")
    emit({"phase": "hand_main", "launches": hand_launches})
    if hand_launches != want_counts:
        failures.append(f"hand_main: launch counts {hand_launches}, want "
                        f"{want_counts}")
    if failures:
        fail("; ".join(failures))

    # -- 6. serving ------------------------------------------------------------
    for mode in MODES:
        res = serve_blas(argparse.Namespace(
            blas="GEMVER", n=n2, requests=args.requests, mode=mode,
            backend="cuda", device="cuda", seed=0))
        emit({"phase": "serve", "program": "GEMVER", "n": n2,
              "mode": mode, "requests": args.requests,
              "us_per_request": res["us_per_request"],
              "kernel_launches": res["kernel_launches"],
              "groups": res["n_groups"]})
        if res["kernel_launches"] != args.requests * res["n_groups"]:
            failures.append(f"serve GEMVER/{mode}: "
                            f"{res['kernel_launches']} launches")
    if failures:
        fail("; ".join(failures))

    # -- 7. the three-way series, with the library sequence ------------------
    series_kernels = {"GEMVER": (("K3/gemver_k1", (n2, n2)),
                                 ("K3/gemver_k2", (n2, n2))),
                      "BiCGK": (("K2/bicgk", (n2, n2)),),
                      "LM_RMSNORM": (("K4/rmsnorm_f32", (1, n2)),)}
    for name in SERIES:
        tprog = FusionCompiler(backend="torch", device="cuda",
                               cache=PlanCache()).compile(
            REGISTRY[name].script, REGISTRY[name].shapes(n2))
        t_in = tprog.prepare(**inputs[name])
        runs = {
            "compiler_best": lambda p=progs[(name, "best")],
            a=dev_inputs[(name, "best")]: p.fn(*a),
            "compiler_unfused": lambda p=progs[(name, "unfused")],
            a=dev_inputs[(name, "unfused")]: p.fn(*a),
            "hand": hand_calls(name, series_dev[name]),
            "torch": lambda p=tprog, a=t_in: p.fn(*a),
        }
        lib = library_sequence(name, series_dev[name])
        if lib is not None:
            runs["library_seq"] = lib
        want = runs["torch"]()
        rec = {"phase": "series", "program": name, "n": n2,
               "groups_best": progs[(name, "best")].n_groups}
        for key, fn in runs.items():
            got = fn()
            rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
            rec[f"{key}_norm_rel_err"] = rel
            if not rel <= RTOL:
                failures.append(f"series {name} {key}: disagrees with the "
                                f"torch backend, {rel:.3g}")
        for key, fn in runs.items():
            rec[f"{key}_us"] = time_ms(fn) * 1e3
            rec[f"{key}_device_us"] = device_ms(fn) * 1e3
        if lib is None:
            rec["library_seq_us"] = rec["library_seq_device_us"] = None
        rec["hand_bound_us"] = {k: hand_bound(k, shp)[0] * 1e3
                                for k, shp in series_kernels[name]}
        emit(rec)
    if failures:
        fail("; ".join(failures))

    # -- 8. times ------------------------------------------------------------
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
    for kernel, (shape, wrapper, plain, lib) in hand_in.items():
        ms = device_ms(wrapper)
        wrapper_ms = time_ms(wrapper)
        plain_ms = time_ms(plain)
        lib_ms = lib_err = None
        if lib is not None:
            lib_err, _ = tensor_err(lib(), wrapper())
            if not lib_err <= (BF16_RTOL if kernel.endswith("bf16")
                               else RTOL):
                failures.append(f"library call for {kernel} disagrees with "
                                f"the kernel: {lib_err:.3g}")
            lib_ms = device_ms(lib)
        b_ms, b_by = hand_bound(kernel, shape)
        source, replaces = HAND[kernel]
        rec = {"name": kernel, "route": "cuda", "source": source,
               "replaces": replaces, "launches": hand_launches.get(kernel, 0),
               "max_abs_err": hand_err[kernel], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        records.append(rec)
        emit({"phase": "time", **rec, "shape": list(shape),
              "wrapper_ms": wrapper_ms, "library_norm_rel_err": lib_err,
              "bound_share": b_ms / ms})
    if failures:
        fail("; ".join(failures))

    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
