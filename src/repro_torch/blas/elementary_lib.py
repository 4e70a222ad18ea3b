"""Library of BLAS elementary functions (paper §3.3).

Each entry is a fusible ``Elementary``: BLAS-1 operations are depth-1
maps/reduces over vectors; BLAS-2 operations are depth-2 nested
map/reduce over (row-block, col-block) tiles, exactly the paper's
``y = map(reduce(+, map(*, A_i, x)), A)`` formulation (eq. 2).

The ``fn`` bodies are block-polymorphic torch code: the same code
computes a full dense result (``torch`` backend) or one plan tile's
partial (the tiled plain version of kernel K1).  The ``cuda`` strings
are the same functions at one point of the iteration space, for the
generated CUDA kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.elementary import (Monoid, make_map, make_nested_map,
                                         make_nested_map_reduce, make_reduce)

# ---------------------------------------------------------------------------
# BLAS-1: depth-1 maps / reduces over vectors
# ---------------------------------------------------------------------------

# x * alpha                       (SSCAL)
scal = make_map("scal", lambda a, x: a * x, arity=2, scalar_args=(0,),
                flops_per_point=1, cuda="{0} * {1}")
# a*x + y                         (SAXPY)
axpy = make_map("axpy", lambda a, x, y: a * x + y, arity=3, scalar_args=(0,),
                flops_per_point=2, cuda="{0} * {1} + {2}")
# w - a*v                         (AXPYDOT step 1)
axmy = make_map("axmy", lambda a, w, v: w - a * v, arity=3, scalar_args=(0,),
                flops_per_point=2, cuda="{1} - {0} * {2}")
# a*x + b*y                       (WAXPBY)
waxpby = make_map("waxpby", lambda a, x, b, y: a * x + b * y, arity=4,
                  scalar_args=(0, 2), flops_per_point=3,
                  cuda="{0} * {1} + {2} * {3}")
# elementwise product             (DOT step 1)
ew_mul = make_map("ew_mul", lambda x, y: x * y, arity=2, flops_per_point=1,
                  cuda="{0} * {1}")
# elementwise add of 2/3 vectors  (VADD)
ew_add = make_map("ew_add", lambda x, y: x + y, arity=2, flops_per_point=1,
                  cuda="{0} + {1}")
ew_add3 = make_map("ew_add3", lambda x, y, z: x + y + z, arity=3,
                   flops_per_point=2, cuda="{0} + {1} + {2}")
# a*x + b*y applied to reduce-finished scalars comes via scalar_args
axpby = make_map("axpby", lambda a, x, b, y: a * x + b * y, arity=4,
                 scalar_args=(0, 2), flops_per_point=3,
                 cuda="{0} * {1} + {2} * {3}")
# a*x + y with scalar a           (SGEMVT/GEMVER "beta*t + z" step)
xpay = make_map("xpay", lambda a, x, y: a * x + y, arity=3, scalar_args=(0,),
                flops_per_point=2, cuda="{0} * {1} + {2}")
# sum-reduction                   (DOT step 2, ASUM core)
sum_reduce = make_reduce("sum_reduce", Monoid.SUM, flops_per_point=1)
max_reduce = make_reduce("max_reduce", Monoid.MAX, flops_per_point=1)

# ---------------------------------------------------------------------------
# BLAS-2: depth-2 nested map/reduce over tiles
# ---------------------------------------------------------------------------

# y_i = sum_j A_ij x_j  — partial over a tile: A_blk @ x_blk
gemv_t = make_nested_map_reduce(
    "gemv", lambda A, x: torch.mv(A, x),
    in_axes=[(0, 1), (1,)], out_axis=0, flops_per_point=2, cuda="{0} * {1}")

# s_j = sum_i A_ij r_i  — partial over a tile: A_blk^T @ r_blk
gemtv_t = make_nested_map_reduce(
    "gemtv", lambda A, r: torch.mv(A.T, r),
    in_axes=[(0, 1), (0,)], out_axis=1, flops_per_point=2, cuda="{0} * {1}")

# B_ij = A_ij + u1_i v1_j + u2_i v2_j   (GEMVER rank-2 update, nested map)
rank2_update = make_nested_map(
    "rank2_update",
    lambda A, u1, v1, u2, v2: A + u1[..., :, None] * v1[..., None, :]
    + u2[..., :, None] * v2[..., None, :],
    in_axes=[(0, 1), (0,), (1,), (0,), (1,)], flops_per_point=4,
    cuda="{0} + {1} * {2} + {3} * {4}")

# C_ij = A_ij + B_ij                    (MADD, nested map)
madd = make_nested_map(
    "madd", lambda A, B: A + B, in_axes=[(0, 1), (0, 1)], flops_per_point=1,
    cuda="{0} + {1}")

# outer product u v^T                   (GER building block)
outer = make_nested_map(
    "outer", lambda u, v: u[..., :, None] * v[..., None, :],
    in_axes=[(0,), (1,)], flops_per_point=1, cuda="{0} * {1}")

ALL = {e.name: e for e in [
    scal, axpy, axmy, waxpby, ew_mul, ew_add, ew_add3, axpby, xpay, sum_reduce,
    max_reduce, gemv_t, gemtv_t, rank2_update, madd, outer,
]}
