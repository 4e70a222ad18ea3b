"""LM decode-step workloads as registered programs.

* ``LM_RMSNORM`` — square → sum → scale; the norm a decoder applies
  before every sublayer (oracle: ``kernels.ref.rmsnorm`` on one row).
* ``LM_BLOCK`` — rmsnorm → matvec → residual add; one projection of a
  decoder sublayer at batch size 1.
* ``LM_DECODE_ATTN`` — score → softmax → weighted value sum over the KV
  length; a MAX reduction feeding SUM reductions (oracle:
  ``kernels.ref.decode_attention`` at Hq = Hkv = 1, whose hand kernel is
  K5).
* ``FUSED_ADAMW`` — the optimizer step of ``repro_torch.optim.fused``
  with the scalars ``1 - beta`` and the bias corrections as inputs
  (oracle: ``kernels.ref.adamw``, whose hand kernel is K6).

The input factories are copies of the JAX reference's, so one seed
gives the same arrays in both packages.  The attention head dim is 48,
off the power-of-two grid, so the kernels' tails along it are exercised.
"""
from __future__ import annotations

import numpy as np

from repro_torch.blas import elementary_lib as lib

from . import model_lib as mlib
from .registry import MODELS, Program, register

#: Attention head dim, kept off the power-of-two grid (module docstring).
HEAD_DIM = 48


def _register(prog: Program) -> Program:
    return register(prog, MODELS)


# --- LM_RMSNORM:  y = x * rsqrt(mean(x^2) + eps) * gamma ---------------------

def _rmsnorm_script(g, x, gamma, inv_d):
    sq = g.apply(lib.ew_mul, x, x, name="sq")
    ss = g.apply(lib.sum_reduce, sq, name="ss")
    y = g.apply(mlib.rms_scale, ss, inv_d, x, gamma, name="y")
    return (y,)


def _rmsnorm_ref(x, gamma, inv_d):
    ss = np.sum(x * x)
    return (x / np.sqrt(ss * inv_d + 1e-6) * gamma,)


def _rmsnorm_inputs(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    return {
        "x": rng.standard_normal(n).astype(dtype),
        "gamma": rng.standard_normal(n).astype(dtype),
        # exact 1/n in f32, so sum * inv_d is the mean of the reference
        "inv_d": np.float32(1.0) / np.float32(n),
    }


_register(Program(
    "LM_RMSNORM", "M", _rmsnorm_script,
    lambda n: {"x": (n,), "gamma": (n,), "inv_d": ()},
    _rmsnorm_ref,
    lambda n: 6.0 * n,
    inputs=_rmsnorm_inputs))


# --- LM_BLOCK:  out = x + W @ rmsnorm(x) -------------------------------------
#
# The residual stream enters as its own input ``x_res`` (callers pass
# the same array as ``x``).  Adding ``x`` itself would unify the
# matvec's output-row axis with its column axis in the trace, collapsing
# the square W onto one iteration axis, which no backend can schedule.

def _block_script(g, x, x_res, gamma, W, inv_d):
    sq = g.apply(lib.ew_mul, x, x, name="sq")
    ss = g.apply(lib.sum_reduce, sq, name="ss")
    y = g.apply(mlib.rms_scale, ss, inv_d, x, gamma, name="y")
    t = g.apply(lib.gemv_t, W, y, name="t")
    out = g.apply(lib.ew_add, x_res, t, name="out")
    return (out,)


def _block_ref(x, x_res, gamma, W, inv_d):
    (y,) = _rmsnorm_ref(x, gamma, inv_d)
    return (x_res + W @ y,)


def _block_inputs(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    out = _rmsnorm_inputs(n, seed=seed, dtype=dtype)
    out["x_res"] = out["x"]
    out["W"] = rng.standard_normal((n, n)).astype(dtype)
    return out


_register(Program(
    "LM_BLOCK", "M", _block_script,
    lambda n: {"x": (n,), "x_res": (n,), "gamma": (n,), "W": (n, n),
               "inv_d": ()},
    _block_ref,
    lambda n: 2.0 * n * n + 7.0 * n,
    inputs=_block_inputs))


# --- LM_DECODE_ATTN:  o = softmax(K q * scale) @ V ---------------------------

def _attn_script(g, q, K, V, scale):
    s_raw = g.apply(mlib.attn_score, K, q, name="s_raw")
    s = g.apply(lib.scal, scale, s_raw, name="s")
    mx = g.apply(lib.max_reduce, s, name="mx")
    e = g.apply(mlib.exp_sub, s, mx, name="e")
    z = g.apply(lib.sum_reduce, e, name="z")
    w = g.apply(mlib.div_by, z, e, name="w")
    o = g.apply(mlib.attn_out, V, w, name="o")
    return (o,)


def _attn_ref(q, K, V, scale):
    s = (K @ q) * scale
    e = np.exp(s - np.max(s))
    w = e / np.sum(e)
    return (w @ V,)


def _attn_inputs(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    return {
        "q": rng.standard_normal(HEAD_DIM).astype(dtype),
        "K": rng.standard_normal((n, HEAD_DIM)).astype(dtype),
        "V": rng.standard_normal((n, HEAD_DIM)).astype(dtype),
        "scale": np.float32(1.0) / np.sqrt(np.float32(HEAD_DIM)),
    }


_register(Program(
    "LM_DECODE_ATTN", "M", _attn_script,
    lambda n: {"q": (HEAD_DIM,), "K": (n, HEAD_DIM), "V": (n, HEAD_DIM),
               "scale": ()},
    _attn_ref,
    lambda n: 4.0 * HEAD_DIM * n + 6.0 * n,
    inputs=_attn_inputs))


# --- FUSED_ADAMW:  one optimizer step over a flat parameter vector -----------

#: The hyperparameters ``_adamw_inputs`` instantiates (step pre-baked
#: into c1/c2); tests compare against ``kernels.ref.adamw`` with these.
ADAMW_HYPERS = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                    weight_decay=0.01, step=3)


def _adamw_script(g, p, grad, m, v, lr, b1, omb1, b2, omb2, eps, wd, c1, c2):
    m2 = g.apply(mlib.ema_pm, b1, omb1, m, grad, name="m2")
    v2 = g.apply(mlib.ema_sq_pm, b2, omb2, v, grad, name="v2")
    u = g.apply(mlib.adam_dir, c1, c2, eps, wd, m2, v2, p, name="u")
    p2 = g.apply(mlib.apply_lr, lr, p, u, name="p2")
    return p2, m2, v2


def _adamw_ref(p, grad, m, v, lr, b1, omb1, b2, omb2, eps, wd, c1, c2):
    m2 = b1 * m + omb1 * grad
    v2 = b2 * v + omb2 * (grad * grad)
    u = (m2 * c1) / (np.sqrt(v2 * c2) + eps) + wd * p
    return p - lr * u, m2, v2


def _adamw_inputs(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    h = ADAMW_HYPERS
    b1, b2, step = h["beta1"], h["beta2"], h["step"]
    return {
        "p": rng.standard_normal(n).astype(dtype),
        "grad": rng.standard_normal(n).astype(dtype),
        "m": rng.standard_normal(n).astype(dtype),
        # the second moment is a running mean of squares: non-negative
        "v": np.abs(rng.standard_normal(n)).astype(dtype),
        "lr": np.float32(h["lr"]),
        "b1": np.float32(b1),
        # 1 - beta and the bias corrections rounded from Python floats
        # (model_lib's docstring says why)
        "omb1": np.float32(1.0 - b1),
        "b2": np.float32(b2),
        "omb2": np.float32(1.0 - b2),
        "eps": np.float32(h["eps"]),
        "wd": np.float32(h["weight_decay"]),
        "c1": np.float32(1.0 / (1.0 - b1 ** step)),
        "c2": np.float32(1.0 / (1.0 - b2 ** step)),
    }


_register(Program(
    "FUSED_ADAMW", "M", _adamw_script,
    lambda n: {"p": (n,), "grad": (n,), "m": (n,), "v": (n,),
               "lr": (), "b1": (), "omb1": (), "b2": (), "omb2": (),
               "eps": (), "wd": (), "c1": (), "c2": ()},
    _adamw_ref,
    lambda n: 15.0 * n,
    inputs=_adamw_inputs,
    # pure maps: no reduction constrains the pad, so it is declared
    pad_values={"p": 0.0, "grad": 0.0, "m": 0.0, "v": 0.0, "lr": 0.0,
                "b1": 0.0, "omb1": 0.0, "b2": 0.0, "omb2": 0.0,
                "eps": 0.0, "wd": 0.0, "c1": 0.0, "c2": 0.0}))
