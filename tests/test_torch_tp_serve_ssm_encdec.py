"""The pieces of tensor-parallel serving that the ssm and encdec families
add, on the CPU and without a process group: K4's block entry (the
plain versions ``kernels.ops`` runs on the CPU) against the reference's
``rmsnorm`` over whole rows, a Mamba-2 rank's blocks of ``ssm_in_proj``
(four ranges of one leaf) and of the tied vocabulary, the split
``tensor_parallel_split`` admits and refuses, and ``costmodel.
tp_decode``'s state and cross-attention cache bytes.  The rank cases
(prefill, decode steps and greedy tokens against the reference, on gloo
ranks) are in ``test_torch_tp_serve.py``.

Tolerance: the blocks' float32 sums of squares add in another order
than one row's mean, so the combined blocks lie within 1e-6 of the
whole rows, float32 rounding.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.configs import get_config, smoke_config
from repro_torch.dist.sharding import param_block, take_block
from repro_torch.dist.spmd import TensorParallel
from repro_torch.kernels import ops, ref
from repro_torch.launch.costmodel import tp_decode
from repro_torch.models import init_params
from repro_torch.models.forward import unembed
from repro_torch.train.steps import tensor_parallel_split
from torch_threads import capped_torch_threads  # noqa: F401


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_k4_block_entries_combined_are_the_whole_rows(n):
    """K4's block entry over ``n`` blocks of a row (Mamba-2's gated norm,
    a rank's SSD heads' columns): each block's float32 sum of squares
    (``rmsnorm_block_sumsq``), summed over the blocks as the ranks' all-
    reduce sums them, then each block scaled (``rmsnorm_block_scale``);
    the blocks joined equal ``ref.rmsnorm`` and the reference's
    ``rmsnorm`` on the whole rows within 1e-6, float32."""
    rng = np.random.default_rng(n)
    T, D = 12, 640
    x = rng.standard_normal((3, T, D)).astype(np.float32) * 3.0
    g = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    cuts = [(int(c[0]), int(c[-1]) + 1)
            for c in np.array_split(np.arange(D), n)]
    ss = sum(ops.rmsnorm_block_sumsq(xt[..., lo:hi]) for lo, hi in cuts)
    assert ss.shape == (3, T) and ss.dtype == torch.float32
    got = torch.cat([ops.rmsnorm_block_scale(xt[..., lo:hi], ss,
                                             gt[lo:hi], D)
                     for lo, hi in cuts], -1)
    assert _rel(got, ref.rmsnorm(xt, gt)) <= 1e-6
    assert _rel(got, jax_ref.rmsnorm(jnp.asarray(x), jnp.asarray(g))) <= 1e-6
    # bf16 blocks: float32 statistics, one rounding, as the whole row's
    xb = xt.to(torch.bfloat16)
    ssb = sum(ref.rmsnorm_block_sumsq(xb[..., lo:hi]) for lo, hi in cuts)
    gotb = torch.cat([ref.rmsnorm_block_scale(xb[..., lo:hi], ssb,
                                              gt[lo:hi], D)
                      for lo, hi in cuts], -1)
    assert gotb.dtype == torch.bfloat16
    assert _rel(gotb.float(), ref.rmsnorm(xb, gt).float()) <= 1e-2


@pytest.mark.parametrize("mp", [2, 4])
def test_a_rank_holds_its_pieces_of_ssm_in_proj(mp):
    """A Mamba-2 rank's ``ssm_in_proj`` (``param_block``: four ranges of
    one dim) is the whole leaf's z, xs, B, C and dt columns, in that
    order: its heads' P columns of z and of xs, B and C whole, its
    heads' dt; the vectors and ``out_proj`` their heads' block."""
    cfg = dataclasses.replace(smoke_config("mamba2_2p7b"),
                              compute_dtype="float32")
    lp = dict(init_params(cfg, torch.Generator().manual_seed(0),
                          "cpu").layers[0].items())
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    whole = lp["ssm_in_proj"]
    z, xs, B, C, dt = torch.split(whole, [di, di, N, N, H], dim=1)
    pieces = []
    for r in range(mp):
        tp = TensorParallel(None, mp, r, blocks=True)
        h0, h1 = tp.block(H)
        held = take_block(whole, param_block(cfg, "ssm_in_proj",
                                             whole.shape, tp))
        want = torch.cat([z[:, h0 * P:h1 * P], xs[:, h0 * P:h1 * P], B, C,
                          dt[:, h0:h1]], 1)
        assert torch.equal(held, want)
        assert held.is_contiguous()
        pieces.append(torch.split(held, [di // mp, di // mp, N, N, H // mp],
                                  dim=1))
        for name, want in (("ssm_A_log", lp["ssm_A_log"][h0:h1]),
                           ("ssm_norm_g", lp["ssm_norm_g"][h0 * P:h1 * P]),
                           ("ssm_out_proj",
                            lp["ssm_out_proj"][h0 * P:h1 * P])):
            t = lp[name]
            assert torch.equal(take_block(t, param_block(cfg, name, t.shape,
                                                         tp)), want)
        assert param_block(cfg, "ln1_g", lp["ln1_g"].shape, tp) is None
    # the ranks' z, xs and dt columns cover the whole leaf's once
    assert torch.equal(torch.cat([p[0] for p in pieces], 1), z)
    assert torch.equal(torch.cat([p[4] for p in pieces], 1), dt)


@pytest.mark.parametrize("mp", [2, 4])
def test_a_tied_models_logits_are_the_ranks_vocabulary_block(mp):
    """Mamba-2 ties its unembedding to ``embed``, which every rank holds
    whole: under a serving rank's ``TensorParallel`` (``tp.blocks``) its
    logits are the rank's block of the vocabulary, from its rows of
    ``embed``, not all of it; the blocks joined are the whole logits."""
    cfg = dataclasses.replace(smoke_config("mamba2_2p7b"),
                              compute_dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert cfg.tie_embeddings and param_block(
        cfg, "embed", model["embed"].shape,
        TensorParallel(None, mp, 0, blocks=True)) is None
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    whole = unembed(cfg, model, x)
    blocks = []
    for r in range(mp):
        tp = TensorParallel(None, mp, r, blocks=True)
        lo, hi = tp.block(cfg.vocab)
        got = unembed(cfg, model, x, tp)
        assert got.shape == (2, 3, hi - lo)
        torch.testing.assert_close(got, x @ model["embed"][lo:hi].T,
                                   rtol=0, atol=0)
        blocks.append(got)
    torch.testing.assert_close(torch.cat(blocks, -1), whole, rtol=1e-6,
                               atol=1e-6)


def test_tensor_parallel_split_admits_mamba_and_whisper_serving():
    """Serving splits Mamba-2-2.7B's 80 SSD heads and Whisper-medium's 16
    heads (16 KV heads) and ``d_ff`` 4096 over 2, 4, 8 and 16 ranks; an
    axis that does not divide them raises ``ValueError`` naming the
    dimension (``ssm_heads``, ``n_heads``); the hybrid family stays
    refused and names the uneven-split item; training under tensor
    parallelism still refuses the ssm, hybrid, encdec and vlm
    families."""
    mamba, whisper = get_config("mamba2_2p7b"), get_config("whisper_medium")
    for mp in (2, 4, 8, 16):
        tensor_parallel_split(mamba, mp, serving=True)
        tensor_parallel_split(whisper, mp, serving=True)
    with pytest.raises(ValueError, match=r"ssm_heads = 80 does not split "
                       r"over a 'model' axis of 32"):
        tensor_parallel_split(mamba, 32, serving=True)
    with pytest.raises(ValueError, match=r"n_heads = 16 does not split"):
        tensor_parallel_split(whisper, 32, serving=True)
    with pytest.raises(ValueError, match=r"ssm_heads = 8 does not split"):
        tensor_parallel_split(smoke_config("mamba2_2p7b"), 16, serving=True)
    with pytest.raises(NotImplementedError,
                       match=r"hybrid family comes with a later "
                       r"tensor-parallel slice \(the uneven-split item"):
        tensor_parallel_split(get_config("hymba_1p5b"), 2, serving=True)
    for arch in ("mamba2_2p7b", "hymba_1p5b", "whisper_medium",
                 "llava_next_34b"):
        with pytest.raises(NotImplementedError,
                           match=r"family comes with a later"):
            tensor_parallel_split(get_config(arch), 2)


def test_costmodel_counts_the_state_and_the_cross_cache():
    """``costmodel.tp_decode`` by shape arithmetic, bf16, B 8 at 48
    cached positions: Mamba-2's cache is a rank's float32 SSD state, L ·
    rows · (H/mp) · P · N · 4 whatever ``kv_len``, written back too, and
    its tied logits read the rank's vocabulary rows of ``embed``; 2
    collectives a layer (the gated norm's sums, the output's) and the
    gather.  Whisper's cache adds the cross K/V over its 1500 frames,
    its decode reads none of the encoder's weights, and it has 3
    collectives a layer."""
    mamba, whisper = get_config("mamba2_2p7b"), get_config("whisper_medium")
    L, D, V = mamba.n_layers, mamba.d_model, mamba.vocab
    for mp in (1, 2, 4):
        got = tp_decode(mamba, 8, 48, mp)
        state = L * 8 * (80 // mp) * 64 * 128 * 4
        assert got["cache_bytes"] == state == tp_decode(mamba, 8, 4096,
                                                        mp)["cache_bytes"]
        assert got["cache_write_bytes"] == state
        vrows = -(-V // mp)
        assert got["weight_bytes"] == got["held_weight_bytes"] \
            - V * D * 2 + (8 + vrows) * D * 2
        assert got["collectives"] == (2 * L + 1 if mp > 1 else 0)
        if mp > 1:
            assert got["collective_payload_bytes"] == \
                L * 8 * 4 + L * 8 * D * 4 + 8 * vrows * mp * 2
    Lw, Dw, F = whisper.n_layers, whisper.d_model, whisper.encoder_frames
    one, two = tp_decode(whisper, 8, 48, 1), tp_decode(whisper, 8, 48, 2)
    for got, heads in ((one, 16), (two, 8)):
        assert got["cache_bytes"] == Lw * 8 * 48 * 2 * heads * 64 * 2 \
            + Lw * 8 * F * 2 * heads * 64 * 2
        assert got["cache_write_bytes"] == 0
    assert two["collectives"] == 3 * Lw + 1
    # the decode reads the decoder's blocks: the encoder's are not read
    from repro_torch.dist.sharding import rank_param_bytes
    tp = TensorParallel(None, 2, 0)
    enc = rank_param_bytes(whisper, tp, 2) - rank_param_bytes(
        whisper, tp, 2, ("enc_layers", "enc_pos", "encf_g", "encf_b"))
    assert enc > 0
    assert two["weight_bytes"] == two["held_weight_bytes"] - enc \
        - whisper.vocab * Dw * 2 + 8 * Dw * 2
