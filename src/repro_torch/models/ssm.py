"""The Mamba-2 SSD (state-space duality) mixer, from the reference's
``repro.models.ssm``: the chunked prefill path and the O(1)-state decode
step (arXiv:2405.21060, minimal formulation, ngroups = 1).

Plain PyTorch, as the reference's is plain JAX: no Pallas kernel stands
behind the scan.  The gated norm runs through ``common.rmsnorm``, so it is
K4 on the card, at D = d_inner (on a tensor-parallel serving rank, K4's
block entry over its heads' columns).  The reference writes the
within-chunk and state terms as 3- and 4-operand einsums; here they are
pairwise contractions in a fixed order, since ``torch.einsum`` without
``opt_einsum`` contracts left to right and can build a (b, nc, c, c, h,
p) intermediate.  The inter-chunk ``lax.scan`` is a loop over chunks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import partial_matmul, rmsnorm, rmsnorm_over_model


def _segsum(a):
    """a: (..., l) log-decay per step -> (..., l, l) lower-triangular
    cumulative sums ``segsum(a)[i, j] = sum_{k=j+1..i} a_k`` (-inf above
    the diagonal)."""
    cum = a.cumsum(-1)
    diff = cum[..., :, None] - cum[..., None, :]
    n = a.shape[-1]
    below = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~below, float("-inf"))


def chunk_of(s: int, chunk: int) -> int:
    """The reference's chunk length for a sequence of s: ``chunk`` (at
    most s) halved until it divides s, which falls to 1 at an odd s."""
    c = min(chunk, s)
    while s % c:
        c //= 2
    return c


def ssd_forward(xdt, a_log, B, C, chunk: int):
    """Chunked SSD.

    xdt: (b, s, h, p) inputs pre-multiplied by dt; a_log: (b, s, h)
    per-step log decay (``-exp(A_log) · dt``); B, C: (b, s, n) input and
    output projections, shared across heads.  Returns y (b, s, h, p) in
    xdt's dtype and the final state (b, h, p, n) in float32; every term
    is computed in float32, as the reference's.
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    c = chunk_of(s, chunk)
    nc = s // c
    f32 = torch.float32
    xc = xdt.reshape(b, nc, c, h, p).to(f32)
    ac = a_log.reshape(b, nc, c, h).to(f32)
    Bc = B.reshape(b, nc, c, n).to(f32)
    Cc = C.reshape(b, nc, c, n).to(f32)
    acum = ac.cumsum(2)                                    # (b, nc, c, h)
    xh = xc.permute(0, 1, 3, 2, 4)                         # (b, nc, h, c, p)

    # within a chunk (quadratic in c): y[l] = sum_s (C_l . B_s) L_ls x_s
    L = torch.exp(_segsum(ac.movedim(-1, 2)))              # (b, nc, h, l, s)
    CB = Cc @ Bc.transpose(-1, -2)                         # (b, nc, l, s)
    y_diag = (L * CB[:, :, None]) @ xh                     # (b, nc, h, l, p)

    # each chunk's state: sum_s x_s decay_s B_s^T
    decay_to_end = torch.exp(acum[:, :, -1:] - acum)       # (b, nc, c, h)
    xd = xh * decay_to_end.permute(0, 1, 3, 2)[..., None]  # (b, nc, h, s, p)
    states = xd.transpose(-1, -2) @ Bc[:, :, None]         # (b, nc, h, p, n)

    # the recurrence across chunks: the state entering each one
    a_tot = torch.exp(acum[:, :, -1])                      # (b, nc, h)
    entering = torch.empty_like(states)
    state = torch.zeros((b, h, p, n), dtype=f32, device=xdt.device)
    for z in range(nc):
        entering[:, z] = state
        state = state * a_tot[:, z, :, None, None] + states[:, z]

    # the entering state read out at each step of the chunk
    y_off = (Cc[:, :, None] @ entering.transpose(-1, -2))  # (b, nc, h, l, p)
    y_off = y_off * torch.exp(acum).permute(0, 1, 3, 2)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s, h, p)
    return y.to(xdt.dtype), state


def ssm_mixer(cfg, x, p, state=None, tp=None):
    """The full SSD mixer on x (B, S, D).

    p: ``in_proj`` (D, 2 d_inner + 2 N + H), ``dt_bias``, ``A_log``,
    ``D_skip`` (H,), ``norm_g`` (d_inner,), ``out_proj`` (d_inner, D).
    Without ``state``: the chunked scan over the S steps; returns (out,
    final state (B, H, P, N) float32).  With ``state`` (decode, S == 1):
    one step of the recurrence ``state · exp(a) + x_dt Bᵀ`` in float32,
    written into ``state`` in place; returns (out, state).

    ``tp`` (a serving rank's ``TensorParallel``, ``tp.blocks``): ``p``
    holds this rank's block h0:h1 of the H SSD heads
    (``dist.sharding.param_block``): ``in_proj``'s columns of z and xs
    (its heads' P columns each), B and C whole (ngroups = 1: every head
    reads them) and dt (its heads), in that order; its heads' ``dt_bias``,
    ``A_log``, ``D_skip`` and ``norm_g`` and its rows of ``out_proj``.
    The scan or the state update runs on its heads alone (the state (B,
    h1 - h0, P, N)), the gated norm over the whole d_inner through K4's
    block entry (``common.rmsnorm_over_model``: a rank's block alone
    would give its own mean), and the result is this rank's float32
    partial sum (``common.partial_matmul``).
    """
    Bsz, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    if tp is not None:
        h0, h1 = tp.block(H)
        H = h1 - h0
        di = H * P
    f32 = torch.float32
    z, xs, Bv, Cv, dt = torch.split(x @ p["in_proj"], [di, di, N, N, H],
                                    dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                   # (B, S, H)
    a_log = -torch.exp(p["A_log"]) * dt
    xh = xs.reshape(Bsz, S, H, P)
    xdt = xh * dt[..., None].to(xh.dtype)

    if state is None:
        y, state = ssd_forward(xdt, a_log, Bv, Cv, cfg.ssm_chunk)
    else:
        a = torch.exp(a_log[:, 0])                               # (B, H)
        state.mul_(a[..., None, None]).add_(
            xdt[:, 0, :, :, None].to(f32) * Bv[:, 0, None, None, :].to(f32))
        y = (state @ Cv[:, 0, None, :, None].to(f32))[..., 0]   # (B, H, P)
        y = y[:, None].to(x.dtype)

    y = y + xh * p["D_skip"][None, None, :, None].to(xh.dtype)
    gated = y.reshape(Bsz, S, di) * F.silu(z)
    if tp is None:
        return rmsnorm(gated, p["norm_g"]) @ p["out_proj"], state
    y = rmsnorm_over_model(gated, p["norm_g"], cfg.d_inner, tp)
    return partial_matmul(y, p["out_proj"], tp), state


def ssm_param_shapes(cfg) -> dict:
    di, N, H, D = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.d_model
    return {"in_proj": (D, 2 * di + 2 * N + H), "dt_bias": (H,),
            "A_log": (H,), "D_skip": (H,), "norm_g": (di,),
            "out_proj": (di, D)}
