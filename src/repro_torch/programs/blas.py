"""The 11 BLAS sequences of the paper's evaluation (Table 1).

Each sequence is a *script*: a Python function calling elementary
functions through ``g.apply`` on traced Vars.  Sequences whose CUBLAS
realization needs several calls (VADD, WAXPBY) are expressed with the
same call granularity CUBLAS would use, so the fusion win is measured
against the honest baseline (paper §5.1).

Tags (paper Table 1): F = improvable by fusion, S = by specialization,
B = has a direct CUBLAS equivalent.

Registration lives in the ``repro_torch.programs`` registry;
``repro_torch.blas.sequences`` re-exports this group as
``blas.REGISTRY``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.blas import elementary_lib as lib

from .registry import BLAS, Program, register


def _register(seq: Program) -> Program:
    return register(seq, BLAS)


# --- AXPYDOT:  z = w - a*v ; r = z^T u  --------------------------------------
def _axpydot_script(g, w, v, u, alpha):
    z = g.apply(lib.axmy, alpha, w, v, name="z")
    m = g.apply(lib.ew_mul, z, u)
    r = g.apply(lib.sum_reduce, m, name="r")
    return z, r


_register(Program(
    "AXPYDOT", "FS", _axpydot_script,
    lambda n: {"w": (n,), "v": (n,), "u": (n,), "alpha": ()},
    lambda w, v, u, alpha: ((w - alpha * v), np.dot(w - alpha * v, u)),
    lambda n: 4.0 * n))


# --- ATAX:  y = A^T (A x)  ---------------------------------------------------
def _atax_script(g, A, x):
    t = g.apply(lib.gemv_t, A, x, name="t")
    y = g.apply(lib.gemtv_t, A, t, name="y")
    return (y,)


_register(Program(
    "ATAX", "", _atax_script,
    lambda n: {"A": (n, n), "x": (n,)},
    lambda A, x: (A.T @ (A @ x),),
    lambda n: 4.0 * n * n))


# --- BiCGK:  q = A p ; s = A^T r  --------------------------------------------
def _bicgk_script(g, A, p, r):
    q = g.apply(lib.gemv_t, A, p, name="q")
    s = g.apply(lib.gemtv_t, A, r, name="s")
    return q, s


_register(Program(
    "BiCGK", "F", _bicgk_script,
    lambda n: {"A": (n, n), "p": (n,), "r": (n,)},
    lambda A, p, r: (A @ p, A.T @ r),
    lambda n: 4.0 * n * n))


# --- SGEMV:  z = a*A*x + b*y  ------------------------------------------------
def _sgemv_script(g, A, x, y, alpha, beta):
    t = g.apply(lib.gemv_t, A, x, name="t")
    z = g.apply(lib.axpby, alpha, t, beta, y, name="z")
    return (z,)


_register(Program(
    "SGEMV", "B", _sgemv_script,
    lambda n: {"A": (n, n), "x": (n,), "y": (n,), "alpha": (), "beta": ()},
    lambda A, x, y, alpha, beta: (alpha * (A @ x) + beta * y,),
    lambda n: 2.0 * n * n + 3.0 * n))


# --- SGEMVT:  x = b*A^T*y + z ; w = a*A*x  -----------------------------------
def _sgemvt_script(g, A, y, z, alpha, beta):
    t = g.apply(lib.gemtv_t, A, y, name="t")
    x = g.apply(lib.xpay, beta, t, z, name="x")
    t2 = g.apply(lib.gemv_t, A, x, name="t2")
    w = g.apply(lib.scal, alpha, t2, name="w")
    return x, w


def _sgemvt_ref(A, y, z, alpha, beta):
    x = beta * (A.T @ y) + z
    return x, alpha * (A @ x)


_register(Program(
    "SGEMVT", "(S)", _sgemvt_script,
    lambda n: {"A": (n, n), "y": (n,), "z": (n,), "alpha": (), "beta": ()},
    _sgemvt_ref,
    lambda n: 4.0 * n * n + 4.0 * n))


# --- SSCAL:  x = a*x  --------------------------------------------------------
def _sscal_script(g, x, alpha):
    return (g.apply(lib.scal, alpha, x, name="xs"),)


_register(Program(
    "SSCAL", "B", _sscal_script,
    lambda n: {"x": (n,), "alpha": ()},
    lambda x, alpha: (alpha * x,),
    lambda n: 1.0 * n))


# --- GEMVER:  B = A + u1 v1^T + u2 v2^T ; x = b*B^T*y + z ; w = a*B*x --------
def _gemver_script(g, A, u1, v1, u2, v2, y, z, alpha, beta):
    B = g.apply(lib.rank2_update, A, u1, v1, u2, v2, name="B")
    t = g.apply(lib.gemtv_t, B, y, name="t")
    x = g.apply(lib.xpay, beta, t, z, name="x")
    t2 = g.apply(lib.gemv_t, B, x, name="t2")
    w = g.apply(lib.scal, alpha, t2, name="w")
    return B, x, w


def _gemver_ref(A, u1, v1, u2, v2, y, z, alpha, beta):
    B = A + np.outer(u1, v1) + np.outer(u2, v2)
    x = beta * (B.T @ y) + z
    w = alpha * (B @ x)
    return B, x, w


_register(Program(
    "GEMVER", "FS", _gemver_script,
    lambda n: {"A": (n, n), "u1": (n,), "v1": (n,), "u2": (n,), "v2": (n,),
               "y": (n,), "z": (n,), "alpha": (), "beta": ()},
    _gemver_ref,
    lambda n: 8.0 * n * n + 4.0 * n))


# --- GESUMMV:  y = a*A*x + b*B*x  --------------------------------------------
def _gesummv_script(g, A, B, x, alpha, beta):
    t1 = g.apply(lib.gemv_t, A, x, name="t1")
    t2 = g.apply(lib.gemv_t, B, x, name="t2")
    y = g.apply(lib.axpby, alpha, t1, beta, t2, name="y")
    return (y,)


_register(Program(
    "GESUMMV", "(F)", _gesummv_script,
    lambda n: {"A": (n, n), "B": (n, n), "x": (n,), "alpha": (), "beta": ()},
    lambda A, B, x, alpha, beta: (alpha * (A @ x) + beta * (B @ x),),
    lambda n: 4.0 * n * n + 3.0 * n))


# --- MADD:  C = A + B  -------------------------------------------------------
def _madd_script(g, A, B):
    return (g.apply(lib.madd, A, B, name="C"),)


_register(Program(
    "MADD", "S", _madd_script,
    lambda n: {"A": (n, n), "B": (n, n)},
    lambda A, B: (A + B,),
    lambda n: 1.0 * n * n))


# --- VADD:  x = w + y + z  (CUBLAS: two axpy-like calls) ---------------------
def _vadd_script(g, w, y, z):
    t = g.apply(lib.ew_add, w, y, name="t")
    x = g.apply(lib.ew_add, t, z, name="x")
    return (x,)


_register(Program(
    "VADD", "FS", _vadd_script,
    lambda n: {"w": (n,), "y": (n,), "z": (n,)},
    lambda w, y, z: (w + y + z,),
    lambda n: 2.0 * n))


# --- WAXPBY:  w = a*x + b*y  (CUBLAS: scal + axpy) ---------------------------
def _waxpby_script(g, x, y, alpha, beta):
    t = g.apply(lib.scal, beta, y, name="t")
    w = g.apply(lib.axpy, alpha, x, t, name="w")
    return (w,)


_register(Program(
    "WAXPBY", "F", _waxpby_script,
    lambda n: {"x": (n,), "y": (n,), "alpha": (), "beta": ()},
    lambda x, y, alpha, beta: (alpha * x + beta * y,),
    lambda n: 3.0 * n))
