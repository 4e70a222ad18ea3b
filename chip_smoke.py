#!/usr/bin/env python3
"""Smoke run of the port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's two paths at the data scale users run, with random
inputs made from a seed:

* the compiler's main path — ``FusionCompiler.compile`` (trace, fusion
  search, plan) and execution through one generated CUDA kernel (K1) per
  fused group — for the paper's 11 BLAS sequences and the LM programs
  ``LM_RMSNORM``, ``LM_BLOCK``, ``LM_DECODE_ATTN`` and ``FUSED_ADAMW``, in
  modes ``best`` and ``unfused``: BLAS-2, ``LM_RMSNORM`` and
  ``LM_BLOCK`` at n = 4096 (A is 64 MiB in float32, above the 50 MB
  L2), BLAS-1 sequences and ``FUSED_ADAMW`` at n = 2**24 (64 MiB a
  vector), ``LM_DECODE_ATTN`` at n = 131072 (a 128k-token context, one
  head of d = 48: K + V are 48 MiB);
* the hand kernels through ``repro_torch.kernels.ops``: K2 (BiCGK) and
  K3 (GEMVER) at n = 4096; K4 (RMSNorm) on one 4096-wide row as
  ``LM_RMSNORM`` and on a (8192, 4096) prefill (the ``d_model`` of
  Llama-3-8B) in float32 and bfloat16; K5 (decode attention) on one
  Llama-3-8B layer's decode step, (B, Hq, Hkv, S, d) = (8, 32, 8, 8192,
  128), in bfloat16 and float32; K6 (AdamW) over one Llama-3-8B decoder
  layer's N = 218,103,808 parameters, p in float32 and p, g in bfloat16;
  K7 (softmax cross-entropy) on (T, V) = (8192, 128256), 8192 tokens over
  Llama-3-8B's vocabulary, in float32 and bfloat16.

Phases, each printed as JSON lines:

1. device: the card's name and power limit (``nvidia-smi``), and the
   build of every plan's kernels and of the hand kernels (one ``nvcc``
   per source, in parallel);
2. kernel: every K1 group's kernel against K1's plain tiled version on
   the same inputs on the card, and a second launch of it bitwise equal
   to the first (the groups whose reduce axes K1 cuts into slices
   combine their partials in a fixed order, with no atomics); each
   record gives the group's work units and slices per phase;
3. main: every program's outputs against its numpy reference in
   float64, and the launch counts of that run, which must show every
   group of every plan launched once;
4. hand: K2-K7 against their plain versions (``kernels.ref``) on the
   card, at the main shapes and at odd ones: K2/K3 at a non-square
   (4096, 6144) and an odd (1000, 1531); RMSNorm rows of (1, 4096) and
   (7, 33); K5 at (2, 16, 1, 256, 128) (one KV head), (3, 12, 4, 1000,
   80) (odd S and d) and (1, 1, 1, 131072, 48) (``LM_DECODE_ATTN``'s
   shape), its split and combine kernels each against their own plain
   versions too; K6 at steps 3 and 7 and at N = 1,000,003; K7 at
   (7, 1000) and (33, 50257), per-row losses and their mean;
5. hand_main: the ``ops`` path, counts set to 0 just before it and read
   just after: every hand kernel launched, outputs against float64;
6. serve: ``serve_blas`` for GEMVER at n = 4096, 100 requests, in
   ``best`` and ``unfused`` (CUDA events);
7. series: the paper's comparison for GEMVER, BiCGK, LM_RMSNORM (n =
   4096), AXPYDOT, FUSED_ADAMW (n = 2**24) and LM_DECODE_ATTN (n =
   131072) — compiler ``best`` and ``unfused``, the hand kernels (none
   for AXPYDOT), the ``torch`` backend, for FUSED_ADAMW the port's
   ``optim.fused_adamw_update``, and the library calls the paper
   measures against (cuBLAS matvecs and rank-1 updates; ``addcmul`` and
   ``dot``; ``F.rms_norm``; ``F.scaled_dot_product_attention``;
   ``torch.optim.AdamW(fused=True)``), timed only, never used by the
   port — outputs cross-checked first, then µs per request back to back
   (``*_us``) and as device time (``*_device_us``), beside the hand
   kernels' bounds;
8. time: each kernel's time beside its bound (compulsory bytes over
   3.35 TB/s, or float32 operations over 67 TFLOP/s), the plain
   version's time, and one PyTorch call computing the same function
   where there is one (checked against the kernel once, timed here
   only, never used by the port).  ``ms`` and ``library_ms`` are device
   times: the launches are queued behind a spinning kernel, so the host
   path between them is hidden.  For K1 ``ms`` excludes the combine of
   ``partial`` outputs after the kernel; for K2-K4 it is the wrapper's
   whole device work (the kernel and the sum of its partials); K5's
   split and combine kernels are timed one by one, and K5 as a whole
   (both, with ``F.scaled_dot_product_attention`` as its library call)
   on a line of its own.  ``wrapper_ms`` is the wrapper's whole path per
   call, launched back to back (checks, output allocation, the ctypes
   call, the combine): where it exceeds ``ms``, the host is the limit.

Tolerances: float32 sums over 4096 to 2**24 terms run in another order
in the kernels, the plain versions and numpy, so float32 results are
held to a norm-relative error of 1e-4 (``||got - want|| <= 1e-4 *
||want||``).  The bfloat16 outputs of K4-K6 and their plain versions
both accumulate in float32 and round once to bfloat16, so they differ
only where the rounding of an output flips by one unit: they are held to
1e-3 against their plain versions.  K7's mean loss is held to 1e-5
relative.  Against float64, and against the library's bfloat16 calls,
bfloat16 outputs (8 bits of mantissa) are held to 2e-2.

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
#: programs over 2**24-long vectors
BLAS1 = ("AXPYDOT", "VADD", "WAXPBY", "SSCAL", "FUSED_ADAMW")
LM = ("LM_RMSNORM", "LM_BLOCK", "LM_DECODE_ATTN", "FUSED_ADAMW")
#: the paper's three-way comparison (``benchmarks/fused_kernels.py``)
SERIES = ("GEMVER", "BiCGK", "AXPYDOT", "LM_RMSNORM", "LM_DECODE_ATTN",
          "FUSED_ADAMW")
#: the series programs with a hand kernel behind ``ops``
HANDED = tuple(name for name in SERIES if name != "AXPYDOT")
RTOL = 1e-4
#: bfloat16 kernel against its plain version (one rounding each)
BF16_KERNEL_RTOL = 1e-3
#: K7's mean loss against its plain version and float64
MEAN_RTOL = 1e-5
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
    **{f"K5/{k}_{dt}": ("src/repro_torch/csrc/decode_attention.cu",
                        "src/repro/kernels/decode_attention.py:20")
       for k in ("split", "combine") for dt in ("f32", "bf16")},
    **{f"K6/adamw_{dt}": ("src/repro_torch/csrc/adamw.cu",
                          "src/repro/kernels/adamw.py:24")
       for dt in ("f32", "bf16")},
    **{f"K7/xent_{dt}": ("src/repro_torch/csrc/softmax_xent.cu",
                         "src/repro/kernels/softmax_xent.py:17")
       for dt in ("f32", "bf16")},
}
#: RMSNorm prefill rows: 8192 tokens at Llama-3-8B's d_model
#: (src/repro/configs/llama3_8b.py:6)
PREFILL = (8192, 4096)
#: decode attention (B, Hq, Hkv, S, d): one Llama-3-8B layer (32 heads, 8
#: KV heads, d 128; src/repro/configs/llama3_8b.py:5-8) decoding 8
#: sequences at an 8k context
DECODE = (8, 32, 8, 8192, 128)
#: AdamW over one Llama-3-8B decoder layer's parameters:
#: 4096 (2 4096 + 2 1024) attention + 3 4096 14336 MLP
ADAMW_N = 4096 * (2 * 4096 + 2 * 1024) + 3 * 4096 * 14336
#: the hyperparameters of ``FUSED_ADAMW``'s inputs, the step apart
K6_HYPERS = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                 weight_decay=0.01)
#: cross-entropy (T, V): 8192 tokens over Llama-3-8B's vocabulary
XENT = (8192, 128256)
ES = {"float32": 4, "bfloat16": 2}
SHORT = {"float32": "f32", "bfloat16": "bf16"}


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
    if name == "max_reduce":
        return lambda: torch.amax(args[0])
    if name == "attn_score":                      # K q
        return lambda: torch.mv(args[0], args[1])
    if name == "attn_out":                        # V^T w
        return lambda: torch.mv(args[0].T, args[1])
    if name == "div_by":                          # e / z
        return lambda: torch.div(args[1], args[0])
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
    """Least time for K2-K4's function at ``shape``: its inputs read
    once and its outputs written once (float32 vectors and scalars),
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


def k5_bounds(shape, dtype: str, chunks: int):
    """Least times of K5's split kernel (q, K, V -> float32 partials per
    chunk), its combine kernel (partials -> o) and the whole function (q,
    K, V -> o), with ``chunks`` chunks of S per (b, h_kv)."""
    B, Hq, Hkv, S, d = shape
    es, G = ES[dtype], Hq // Hkv
    q_o = B * Hq * d * es
    kv = 2 * B * S * Hkv * d * es
    part = B * Hkv * chunks * (G * d + 2 * G) * 4
    ops = 4 * B * Hq * S * d + 4 * B * Hq * S     # q.k, p v; the softmax
    return (bound_of(q_o + kv + part, ops),
            bound_of(part + q_o, 3 * B * Hq * chunks * d),
            bound_of(2 * q_o + kv, ops))


def k6_bound(n: int, dtype: str):
    """AdamW with p and g in ``dtype``: p, g, m, v read, p', m', v'
    written; 16 float32 operations a parameter."""
    es = ES[dtype]
    return bound_of(n * (3 * es + 16), 16 * n)


def k7_bound(T: int, V: int, dtype: str, label_bytes: int = 8):
    """Softmax cross-entropy: the logits and labels read, T losses
    written; a max, an exp, a sum and a compare a logit."""
    return bound_of(T * V * ES[dtype] + T * (label_bytes + 4), 4 * T * V)


def tensor_err(got, want):
    """(norm-relative error, max abs error) of tensors, in float64 on
    their device."""
    g, w = got.double(), want.double()
    den = float(w.norm())
    num = float((g - w).norm())
    return (num / den if den > 0 else num), float((g - w).abs().max())


def hand_calls(name, d):
    """The ``ops`` call serving program ``name`` (one of ``HANDED``) on
    device inputs ``d``, with the program's outputs in order."""
    from repro_torch.kernels import ops
    if name == "GEMVER":
        return lambda: ops.gemver(d["A"], d["u1"], d["v1"], d["u2"], d["v2"],
                                  d["y"], d["z"], d["alpha"], d["beta"])
    if name == "BiCGK":
        return lambda: ops.bicgk(d["A"], d["p"], d["r"])
    if name == "LM_DECODE_ATTN":        # Hq = Hkv = 1, B = 1
        return lambda: (ops.decode_attention(
            d["q"][None, None], d["K"][None, :, None],
            d["V"][None, :, None])[0, 0],)
    if name == "FUSED_ADAMW":
        from repro_torch.programs.models import ADAMW_HYPERS as H
        return lambda: ops.adamw_update(
            d["p"], d["grad"], d["m"], d["v"], lr=H["lr"],
            beta1=H["beta1"], beta2=H["beta2"], eps=H["eps"],
            weight_decay=H["weight_decay"], step=H["step"])
    return lambda: (ops.rmsnorm(d["x"][None], d["gamma"])[0],)


def fused_adamw_step(p, g, m, v, step: int):
    """One step of ``torch.optim.AdamW(fused=True)`` from (p, g, m, v) at
    ``step`` with ``ADAMW_HYPERS``, as a function returning (p', m', v').
    It updates its own copies in place, so only its first call gives
    the step's result; later calls are for timing."""
    import torch
    from repro_torch.programs.models import ADAMW_HYPERS as H
    pl = p.clone()
    pl.grad = g.clone()
    opt = torch.optim.AdamW([pl], lr=H["lr"], betas=(H["beta1"], H["beta2"]),
                            eps=H["eps"], weight_decay=H["weight_decay"],
                            fused=True)
    st = opt.state[pl]
    st["step"] = torch.tensor(float(step - 1), device=p.device)
    st["exp_avg"], st["exp_avg_sq"] = m.clone(), v.clone()

    def run():
        opt.step()
        return pl, st["exp_avg"], st["exp_avg_sq"]
    return run


def library_sequence(name, d):
    """The library calls the paper measures a program against: cuBLAS
    matvecs and rank-1 updates, ``addcmul`` and ``dot``, one
    ``F.rms_norm``, one ``F.scaled_dot_product_attention``, or one step of
    ``torch.optim.AdamW(fused=True)`` (the same update: decoupled decay,
    then ``lr c1 m / (sqrt(v c2) + eps)``; it updates its own copies in
    place).  Timed here only; the port never calls them.  None where the
    library has no call."""
    import torch
    F = torch.nn.functional
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
    if name == "AXPYDOT":               # z = w - alpha v; r = z . u
        def axpydot():
            z = torch.addcmul(d["w"], d["alpha"], d["v"], value=-1)
            return z, torch.dot(z, d["u"])
        return axpydot
    if name == "LM_DECODE_ATTN":        # (B, Hkv, S, d) views
        return lambda: (F.scaled_dot_product_attention(
            d["q"][None, None, None], d["K"][None, None],
            d["V"][None, None], enable_gqa=True)[0, 0, 0],)
    if name == "FUSED_ADAMW":
        from repro_torch.programs.models import ADAMW_HYPERS as H
        return fused_adamw_step(d["p"], d["grad"], d["m"], d["v"],
                                H["step"])
    if not hasattr(F, "rms_norm"):
        return None
    n = d["x"].shape[0]
    return lambda: (F.rms_norm(d["x"][None], (n,), d["gamma"], eps=1e-6)[0],)


def main(argv=None):
    ap = argparse.ArgumentParser(description="port smoke run on one GPU")
    ap.add_argument("--n2", type=int, default=4096,
                    help="size of the BLAS-2 sequences, the LM programs "
                         "and the hand kernels' square matrices")
    ap.add_argument("--n1", type=int, default=1 << 24,
                    help="size of the BLAS-1 sequences and FUSED_ADAMW")
    ap.add_argument("--n-attn", type=int, default=131072,
                    help="KV length of LM_DECODE_ATTN")
    ap.add_argument("--requests", type=int, default=100)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    try:
        from repro_torch.core import (LAUNCHES, FusionCompiler, PlanCache,
                                      tiled_reference)
        from repro_torch.kernels import adamw as k6
        from repro_torch.kernels import bicgk as k2
        from repro_torch.kernels import decode_attention as k5
        from repro_torch.kernels import gemver as k3
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import rmsnorm as k4
        from repro_torch.kernels import softmax_xent as k7
        from repro_torch.launch.serve import serve_blas
        from repro_torch.optim import fused_adamw_update
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
        if name == "LM_DECODE_ATTN":
            return args.n_attn
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
        hand_sources = (("bicgk.cu", k2._launchers),
                        ("gemver.cu", k3._launchers),
                        ("rmsnorm.cu", k4._launcher),
                        ("decode_attention.cu", k5._launchers),
                        ("adamw.cu", k6._launcher),
                        ("softmax_xent.cu", k7._launcher))
        for src, launcher in hand_sources:
            futs[src] = pool.submit(launcher)
        for k, fut in futs.items():
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 — reported, then fail
                failures.append(f"build {k}: {e}")
    t_build = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi_line, "device": dev_name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "plans": len(keys), "hand_sources": len(hand_sources),
          "plan_s": t_plan, "build_s": t_build, "n_blas2": n2,
          "n_blas1": args.n1, "n_attn": args.n_attn})
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
                again = fn.launch(*a)
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
                bitwise = all(torch.equal(x.view(torch.int32),
                                          y.view(torch.int32))
                              for x, y in zip(got, again))
                kernel_err[fn.name] = mabs
                kernel_out[fn.name] = got
                emit({"phase": "kernel", "kernel": fn.name,
                      "max_abs_err": mabs, "norm_rel_err": max(errs),
                      "repeat_bitwise": bitwise,
                      "units": [ph.units for ph in fn.layout.phases],
                      "slices": [ph.S for ph in fn.layout.phases]})
                if not max(errs) <= RTOL:
                    failures.append(f"kernel {fn.name}: norm-relative error "
                                    f"{max(errs):.3g} > {RTOL}")
                if not bitwise:
                    failures.append(f"kernel {fn.name}: a second launch "
                                    f"differs from the first")
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
    F = torch.nn.functional
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

    def kernel_tol(dt):
        return BF16_KERNEL_RTOL if dt == "bfloat16" else RTOL

    #: the timed hand kernels, by launch-counter name: shape, dtype, the
    #: wrapper, its plain version, a library call or None (with the
    #: tolerance it is held to against the wrapper), the bound and the
    #: error against the plain version
    hand_in: dict[str, dict] = {}
    #: K5 as a whole (split and combine), timed on lines of their own
    whole_in: dict[str, dict] = {}
    #: the full-width inputs the ``ops`` path of phase 5 reuses
    hand_data: dict = {}
    alpha = torch.tensor(ALPHA, device="cuda")
    beta = torch.tensor(BETA, device="cuda")
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
            k1_in = (A, u1, v1, u2, v2, y)
            w0 = torch.zeros(m, device="cuda")    # ignored at beta=0
            for kernel, wrapper, plain, lib in (
                    ("K2/bicgk", lambda a=(A, p, r): k2.bicgk(*a),
                     lambda a=(A, p, r): ref.bicgk(*a), None),
                    ("K3/gemver_k1", lambda a=k1_in: k3.gemver_k1(*a),
                     lambda a=k1_in: ref.gemver_k1(*a), None),
                    ("K3/gemver_k2", lambda a=(B, x, alpha): k3.gemver_k2(*a),
                     lambda a=(B, x, alpha): ref.gemver_k2(*a),
                     lambda a=(w0, B, x): torch.addmv(*a, beta=0,
                                                      alpha=ALPHA))):
                hand_in[kernel] = dict(
                    shape=shape, dtype="float32", wrapper=wrapper,
                    plain=plain, lib=lib, lib_tol=RTOL,
                    bound=hand_bound(kernel, shape), err=err[kernel])
    rms_norm = getattr(F, "rms_norm", None)
    for T, D, dt in ((*PREFILL, "float32"), (*PREFILL, "bfloat16"),
                     (1, n2, "float32"), (7, 33, "float32"),
                     (7, 33, "bfloat16")):
        xx, g = randn(T, D, dtype=getattr(torch, dt)), randn(D)
        kernel = k4.NAMES[xx.dtype]
        mabs = check(kernel, (T, D), dt, (k4.rmsnorm(xx, g),),
                     (ref.rmsnorm(xx, g),), kernel_tol(dt))
        if (T, D) == PREFILL:
            g_lib = g.to(xx.dtype)      # the library takes gamma in x's type
            hand_in[kernel] = dict(
                shape=(T, D), dtype=dt,
                wrapper=lambda xx=xx, g=g: k4.rmsnorm(xx, g),
                plain=lambda xx=xx, g=g: ref.rmsnorm(xx, g),
                lib=None if rms_norm is None else
                lambda xx=xx, g=g_lib, D=D: rms_norm(xx, (D,), g, eps=1e-6),
                lib_tol=BF16_RTOL if dt == "bfloat16" else RTOL,
                bound=hand_bound(kernel, (T, D)), err=mabs)

    # K5: each kernel against its own plain version, then the whole
    for shape, dt in ((DECODE, "bfloat16"), (DECODE, "float32"),
                      ((2, 16, 1, 256, 128), "float32"),
                      ((3, 12, 4, 1000, 80), "float32"),
                      ((3, 12, 4, 1000, 80), "bfloat16"),
                      ((1, 1, 1, 131072, 48), "float32")):
        B, Hq, Hkv, S, d = shape
        tdt = getattr(torch, dt)
        q, kk, vv = (randn(B, Hq, d, dtype=tdt),
                     randn(B, S, Hkv, d, dtype=tdt),
                     randn(B, S, Hkv, d, dtype=tdt))
        split_name, comb_name = k5.NAMES[tdt]
        acc, mm, ll, length = k5.split(q, kk, vv)
        e_split = check(split_name, shape, dt, (acc, mm, ll),
                        ref.decode_attention_split(q, kk, vv, length))
        e_comb = check(comb_name, shape, dt,
                       (k5.combine(acc, mm, ll, B, Hq, tdt),),
                       (ref.decode_attention_combine(acc, mm, ll, B, Hq,
                                                     tdt),),
                       kernel_tol(dt))
        e_whole = check("K5", shape, dt, (k5.decode_attention(q, kk, vv),),
                        (ref.decode_attention(q, kk, vv),), kernel_tol(dt))
        if shape != DECODE:
            continue
        chunks = acc.shape[0] // (B * Hkv)
        b_split, b_comb, b_whole = k5_bounds(shape, dt, chunks)
        qkv = (q, kk, vv)
        hand_in[split_name] = dict(
            shape=shape, dtype=dt, chunks=chunks, chunk_len=length,
            wrapper=lambda a=qkv: k5.split(*a),
            plain=lambda a=qkv, n=length: ref.decode_attention_split(*a, n),
            lib=None, bound=b_split, err=e_split)
        part = (acc, mm, ll, B, Hq, tdt)
        hand_in[comb_name] = dict(
            shape=shape, dtype=dt, chunks=chunks,
            wrapper=lambda a=part: k5.combine(*a),
            plain=lambda a=part: ref.decode_attention_combine(*a),
            lib=None, bound=b_comb, err=e_comb)
        whole_in[f"K5/split+combine_{SHORT[dt]}"] = dict(
            shape=shape, dtype=dt, chunks=chunks,
            wrapper=lambda a=qkv: k5.decode_attention(*a),
            plain=lambda a=qkv: ref.decode_attention(*a),
            lib=lambda q=q, kk=kk, vv=vv: F.scaled_dot_product_attention(
                q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
                enable_gqa=True)[:, :, 0],
            lib_tol=BF16_RTOL if dt == "bfloat16" else RTOL,
            bound=b_whole, err=e_whole)
        hand_data["K5", dt] = qkv

    # K6: steps 3 and 7; p' against its plain version at the type's
    # tolerance, m' and v' (float32) at RTOL
    for n, dt in ((ADAMW_N, "float32"), (ADAMW_N, "bfloat16"),
                  (1_000_003, "float32"), (1_000_003, "bfloat16")):
        tdt = getattr(torch, dt)
        p, g = randn(n, dtype=tdt), randn(n, dtype=tdt)
        mm, vv = randn(n).mul_(0.1), randn(n).abs_().mul_(0.01)
        name = k6.NAMES[tdt]
        mabs = 0.0
        for step in (3, 7):
            got = k6.adamw_update(p, g, mm, vv, step=step, **K6_HYPERS)
            want = ref.adamw(p, g, mm, vv, step=step, **K6_HYPERS)
            mabs = max(mabs, check(name, (n,), dt, got[:1], want[:1],
                                   kernel_tol(dt)),
                       check(name, (n,), dt, got[1:], want[1:]))
            del got, want
        if n != ADAMW_N:
            continue
        args4 = (p, g, mm, vv)
        hand_in[name] = dict(
            shape=(n,), dtype=dt,
            wrapper=lambda a=args4: k6.adamw_update(*a, step=7,
                                                    **K6_HYPERS),
            plain=lambda a=args4: ref.adamw(*a, step=7, **K6_HYPERS),
            # the library keeps m and v in p's type: float32 only
            lib=fused_adamw_step(*args4, 7) if dt == "float32" else None,
            lib_tol=RTOL, bound=k6_bound(n, dt), err=mabs)
        hand_data["K6", dt] = args4

    # K7: per-row losses against the plain version, and their mean
    for (T, V), dt in ((XENT, "float32"), (XENT, "bfloat16"),
                       ((7, 1000), "float32"), ((33, 50257), "float32"),
                       ((33, 50257), "bfloat16")):
        tdt = getattr(torch, dt)
        logits = randn(T, V).mul_(3.0).to(tdt)
        labels = torch.randint(0, V, (T,), generator=gen, device="cuda")
        name = k7.NAMES[tdt]
        mabs = check(name, (T, V), dt,
                     (k7.softmax_xent_rows(logits, labels),),
                     (ref.softmax_xent_rows(logits, labels),))
        got, want = (float(k7.softmax_xent(logits, labels)),
                     float(ref.softmax_xent(logits, labels)))
        rel = abs(got - want) / abs(want)
        emit({"phase": "hand", "kernel": name, "shape": [T, V],
              "dtype": dt, "mean": got, "mean_rel_err": rel})
        if not rel <= MEAN_RTOL:
            failures.append(f"hand {name} {(T, V)} {dt}: mean loss "
                            f"relative error {rel:.3g} > {MEAN_RTOL}")
        if (T, V) != XENT:
            continue
        lg_lb = (logits, labels)
        hand_in[name] = dict(
            shape=(T, V), dtype=dt,
            wrapper=lambda a=lg_lb: k7.softmax_xent_rows(*a),
            plain=lambda a=lg_lb: ref.softmax_xent_rows(*a),
            lib=lambda a=lg_lb: F.cross_entropy(*a, reduction="none"),
            lib_tol=BF16_RTOL if dt == "bfloat16" else RTOL,
            bound=k7_bound(T, V, dt), err=mabs)
        hand_data["K7", dt] = lg_lb
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
    hand_out = {name: hand_calls(name, series_dev[name])()
                for name in HANDED}
    prefill_out = {dt: ops.rmsnorm(x, gamma) for dt, x in prefill.items()}
    attn_out = ops.decode_attention(*hand_data["K5", "bfloat16"])
    adamw_out = ops.adamw_update(*hand_data["K6", "bfloat16"], step=7,
                                 **K6_HYPERS)
    xent_out = {dt: ops.softmax_xent(*hand_data["K7", dt])
                for dt in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    hand_launches = dict(LAUNCHES.by_kernel)
    want_counts = {"K2/bicgk": 1, "K3/gemver_k1": 1, "K3/gemver_k2": 1,
                   "K4/rmsnorm_f32": 2, "K4/rmsnorm_bf16": 1,
                   "K5/split_f32": 1, "K5/combine_f32": 1,
                   "K5/split_bf16": 1, "K5/combine_bf16": 1,
                   "K6/adamw_f32": 1, "K6/adamw_bf16": 1,
                   "K7/xent_f32": 1, "K7/xent_bf16": 1}

    def hand_main(rec, got, want, tol):
        rel = max(tensor_err(x, y)[0] for x, y in zip(got, want))
        finite = all(bool(torch.isfinite(x).all()) for x in got)
        shapes = all(x.shape == y.shape for x, y in zip(got, want))
        emit({"phase": "hand_main", **rec, "norm_rel_err": rel,
              "finite": finite})
        if not (rel <= tol and finite and shapes):
            failures.append(f"hand_main {rec}: error {rel:.3g}, finite "
                            f"{finite}, shapes {shapes}")

    for name in HANDED:
        ref64 = REGISTRY[name].reference(
            **{n: np.asarray(x, np.float64) for n, x in inputs[name].items()})
        ref64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        hand_main({"program": name, "n": size(name)}, hand_out[name],
                  [torch.from_numpy(np.asarray(r)).cuda() for r in ref64],
                  RTOL)
    for dt, x in prefill.items():
        x64, g64 = x.double(), gamma.double()
        want = x64 * torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-6) \
            * g64
        hand_main({"program": "rmsnorm", "shape": list(PREFILL),
                   "dtype": dt}, (prefill_out[dt],), (want,),
                  BF16_RTOL if dt == "bfloat16" else RTOL)
        if prefill_out[dt].dtype != x.dtype:
            failures.append(f"hand_main rmsnorm {dt}: output dtype "
                            f"{prefill_out[dt].dtype}")
    q, kk, vv = (t.double() for t in hand_data["K5", "bfloat16"])
    B, Hq, Hkv, S, d = DECODE
    w = torch.softmax(torch.einsum(
        "bhgd,bshd->bhgs", q.reshape(B, Hkv, Hq // Hkv, d), kk) / d ** 0.5,
        dim=-1)
    want = torch.einsum("bhgs,bshd->bhgd", w, vv).reshape(B, Hq, d)
    hand_main({"program": "decode_attention", "shape": list(DECODE),
               "dtype": "bfloat16"}, (attn_out,), (want,), BF16_RTOL)
    del q, kk, vv, w, want
    p, g, mm, vv = (t.double() for t in hand_data["K6", "bfloat16"])
    H = K6_HYPERS
    m2 = H["beta1"] * mm + (1 - H["beta1"]) * g
    v2 = H["beta2"] * vv + (1 - H["beta2"]) * g * g
    p2 = p - H["lr"] * ((m2 / (1 - H["beta1"] ** 7))
                        / (torch.sqrt(v2 / (1 - H["beta2"] ** 7)) + H["eps"])
                        + H["weight_decay"] * p)
    hand_main({"program": "adamw_update", "shape": [ADAMW_N],
               "dtype": "bfloat16", "output": "p"}, adamw_out[:1], (p2,),
              BF16_RTOL)
    hand_main({"program": "adamw_update", "shape": [ADAMW_N],
               "dtype": "bfloat16", "output": "m, v"}, adamw_out[1:],
              (m2, v2), RTOL)
    del p, g, mm, vv, m2, v2, p2
    for dt, mean in xent_out.items():
        logits, labels = hand_data["K7", dt]
        rows = torch.cat([torch.logsumexp(c.double(), dim=-1)
                          for c in logits.split(1024)])
        rows -= torch.gather(logits, 1, labels[:, None])[:, 0].double()
        want = float(rows.mean())
        rel = abs(float(mean) - want) / abs(want)
        emit({"phase": "hand_main", "program": "softmax_xent",
              "shape": list(XENT), "dtype": dt, "mean_rel_err": rel})
        if not rel <= MEAN_RTOL:
            failures.append(f"hand_main softmax_xent {dt}: mean loss "
                            f"relative error {rel:.3g} > {MEAN_RTOL}")
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

    # -- 7. the series: compiler, hand, torch backend, library -------------
    series_bounds = {
        "GEMVER": {k: hand_bound(k, (n2, n2))[0]
                   for k in ("K3/gemver_k1", "K3/gemver_k2")},
        "BiCGK": {"K2/bicgk": hand_bound("K2/bicgk", (n2, n2))[0]},
        # no hand kernel: the program's own bound (w, v, u read; z written)
        "AXPYDOT": {"program": bound_of(16 * args.n1, 4 * args.n1)[0]},
        "LM_RMSNORM": {"K4/rmsnorm_f32":
                       hand_bound("K4/rmsnorm_f32", (1, n2))[0]},
        "LM_DECODE_ATTN": {"K5": k5_bounds((1, 1, 1, args.n_attn, 48),
                                           "float32", 1)[2][0]},
        "FUSED_ADAMW": {"K6/adamw_f32": k6_bound(args.n1, "float32")[0]},
    }
    for name in SERIES:
        tprog = FusionCompiler(backend="torch", device="cuda",
                               cache=PlanCache()).compile(
            REGISTRY[name].script, REGISTRY[name].shapes(size(name)))
        t_in = tprog.prepare(**inputs[name])
        d = series_dev[name]
        runs = {
            "compiler_best": lambda p=progs[(name, "best")],
            a=dev_inputs[(name, "best")]: p.fn(*a),
            "compiler_unfused": lambda p=progs[(name, "unfused")],
            a=dev_inputs[(name, "unfused")]: p.fn(*a),
            "torch": lambda p=tprog, a=t_in: p.fn(*a),
        }
        if name in HANDED:
            runs["hand"] = hand_calls(name, d)
        if name == "FUSED_ADAMW":       # the port's optimizer entry point
            runs["optim_fused"] = lambda d=d: fused_adamw_update(
                d["p"], d["grad"], d["m"], d["v"], step=3, **K6_HYPERS)
        lib = library_sequence(name, d)
        if lib is not None:
            runs["library_seq"] = lib
        want = runs["torch"]()
        rec = {"phase": "series", "program": name, "n": size(name),
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
        for key in ("hand", "library_seq"):
            if key not in runs:
                rec[f"{key}_us"] = rec[f"{key}_device_us"] = None
        rec["hand_bound_us"] = {k: ms * 1e3
                                for k, ms in series_bounds[name].items()}
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
                  "units": [ph.units for ph in fn.layout.phases],
                  "slices": [ph.S for ph in fn.layout.phases],
                  "bound_share": b_ms / ms})

    def tensors_of(x):
        return tuple(t for t in (x if isinstance(x, tuple) else (x,))
                     if isinstance(t, torch.Tensor))

    def time_hand(kernel, e):
        """The time record of one hand-kernel entry."""
        ms = device_ms(e["wrapper"])
        wrapper_ms = time_ms(e["wrapper"])
        plain_ms = time_ms(e["plain"])
        lib_ms = lib_err = None
        if e["lib"] is not None:
            lib_err = max(tensor_err(x, y)[0] for x, y in
                          zip(tensors_of(e["lib"]()),
                              tensors_of(e["wrapper"]())))
            if not lib_err <= e["lib_tol"]:
                failures.append(f"library call for {kernel} disagrees with "
                                f"the kernel: {lib_err:.3g}")
            lib_ms = device_ms(e["lib"])
        b_ms, b_by = e["bound"]
        source, replaces = HAND[kernel.replace("split+combine", "split")]
        rec = {"name": kernel, "route": "cuda", "source": source,
               "replaces": replaces, "launches": hand_launches.get(kernel, 0),
               "max_abs_err": e["err"], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        extra = {k: e[k] for k in ("chunks", "chunk_len") if k in e}
        emit({"phase": "time", **rec, "shape": list(e["shape"]),
              "dtype": e["dtype"], "wrapper_ms": wrapper_ms,
              "library_norm_rel_err": lib_err, "bound_share": b_ms / ms,
              **extra})
        return rec

    for kernel, e in hand_in.items():
        records.append(time_hand(kernel, e))
    for kernel, e in whole_in.items():      # lines only: two launches each
        time_hand(kernel, e)
    if failures:
        fail("; ".join(failures))

    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
