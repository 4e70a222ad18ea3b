"""Elementary functions for LM decode-step workloads.

These extend ``blas.elementary_lib`` with the non-multilinear pieces a
decoder step needs: the rmsnorm scale map, the softmax stages, the
attention contractions and the AdamW moment updates.  Each carries its
torch ``fn`` and its per-point CUDA expression (``core.elementary``).

AdamW takes ``1 - beta`` and the bias corrections as *inputs* (``omb*``,
``c*``) rather than computing them from ``beta`` in float32: ``1 -
f32(0.9)`` is 0.100000024, while the reference rounds the Python float
0.1 once, so feeding the pre-rounded scalars makes both multiply by the
same constant.
"""
from __future__ import annotations

import torch

from repro_torch.core.elementary import (exp_map, exp_sub, make_map,
                                         make_nested_map_reduce, rsqrt_map)
# the direction and lr-apply maps are shared with the optimizer verbatim
from repro_torch.optim.fused import adam_dir, apply_lr

# --- rmsnorm -----------------------------------------------------------------

# y_i = x_i * rsqrt(ss * inv_d + eps) * gamma_i with the reduce-finished
# sum of squares ``ss`` and exact 1/n as broadcast scalars.
rms_scale = make_map(
    "rms_scale",
    lambda ss, inv_d, x, gamma: x * torch.rsqrt(ss * inv_d + 1e-6) * gamma,
    arity=4, scalar_args=(0, 1), flops_per_point=4,
    cuda="{2} * rsqrtf({0} * {1} + 1e-6f) * {3}")

# --- softmax stages ----------------------------------------------------------

# w_i = e_i / z with the reduce-finished normalizer z broadcast
div_by = make_map("div_by", lambda z, e: e / z, arity=2, scalar_args=(0,),
                  flops_per_point=1, cuda="{1} / {0}")

# --- attention contractions --------------------------------------------------

# s_s = sum_d K_sd q_d — the decode score row (a tile's partial: K_blk q_blk)
attn_score = make_nested_map_reduce(
    "attn_score", lambda K, q: torch.mv(K, q),
    in_axes=[(0, 1), (1,)], out_axis=0, flops_per_point=2, cuda="{0} * {1}")

# o_d = sum_s w_s V_sd — the weighted value sum (a tile's partial: V_blkᵀ w_blk)
attn_out = make_nested_map_reduce(
    "attn_out", lambda V, w: torch.mv(V.T, w),
    in_axes=[(0, 1), (0,)], out_axis=1, flops_per_point=2, cuda="{0} * {1}")

# --- AdamW moments with 1 - beta as an input ---------------------------------

ema_pm = make_map(
    "ema_pm", lambda b, omb, m, g: b * m + omb * g, arity=4,
    scalar_args=(0, 1), flops_per_point=3, cuda="{0} * {2} + {1} * {3}")
ema_sq_pm = make_map(
    "ema_sq_pm", lambda b, omb, v, g: b * v + omb * (g * g), arity=4,
    scalar_args=(0, 1), flops_per_point=4,
    cuda="{0} * {2} + {1} * ({3} * {3})")

ALL = {e.name: e for e in [
    rms_scale, exp_map, exp_sub, rsqrt_map, div_by, attn_score, attn_out,
    ema_pm, ema_sq_pm, adam_dir, apply_lr,
]}
