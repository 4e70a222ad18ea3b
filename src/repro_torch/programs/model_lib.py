"""Elementary functions for LM decode-step workloads.

These extend ``blas.elementary_lib`` with the non-multilinear pieces a
decoder step needs.  So far only the rmsnorm scale map; the softmax
stages, attention contractions and AdamW moment updates come with the
programs that use them.
"""
from __future__ import annotations

import torch

from repro_torch.core.elementary import make_map

# y_i = x_i * rsqrt(ss * inv_d + eps) * gamma_i with the reduce-finished
# sum of squares ``ss`` and exact 1/n as broadcast scalars.
rms_scale = make_map(
    "rms_scale",
    lambda ss, inv_d, x, gamma: x * torch.rsqrt(ss * inv_d + 1e-6) * gamma,
    arity=4, scalar_args=(0, 1), flops_per_point=4,
    cuda="{2} * rsqrtf({0} * {1} + 1e-6f) * {3}")

ALL = {e.name: e for e in [rms_scale]}
