"""LM decode-step workloads as registered programs.

* ``LM_RMSNORM`` — square → sum → scale; the norm a decoder applies
  before every sublayer (oracle: ``kernels.ref.rmsnorm`` on one row).
* ``LM_BLOCK`` — rmsnorm → matvec → residual add; one projection of a
  decoder sublayer at batch size 1.

The input factories are copies of the JAX reference's, so one seed
gives the same arrays in both packages.  ``LM_DECODE_ATTN`` and
``FUSED_ADAMW`` register with the kernels that serve them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.blas import elementary_lib as lib

from . import model_lib as mlib
from .registry import MODELS, Program, register


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
