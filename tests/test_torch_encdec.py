"""The port's encdec family (whisper_medium: a bidirectional encoder over
precomputed frame embeddings, a decoder with causal self-attention with
rope and cross-attention to the encoder's output, LayerNorm and GELU)
against the JAX reference on the CPU, at the smoke config (30 frames)
with B = 2; the helpers and tolerances are ``torch_lm_parity``'s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as lp
from repro.models import common as ref_common
from repro.models import forward as ref_forward
from repro_torch.models import common, forward
from torch_threads import capped_torch_threads  # noqa: F401

ARCH = "whisper_medium"
P, STEPS = 24, 4


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_model_and_cache_shapes_equal_the_reference(size):
    lp.check_shapes(ARCH, size)


@pytest.mark.parametrize("Sk,block_kv", [(30, 8), (30, 1024), (45, 16),
                                         (45, 1024), (1500, 1024)])
def test_bidirectional_blockwise_attention_matches_the_reference(Sk,
                                                                 block_kv):
    """``causal=False`` over Sk keys (the smoke's 30 frames, 45 with no
    power-of-two divisor, Whisper's 1500, where the reference's blocks
    halve to 4 rows and the port's last block is ragged), float32."""
    rng = np.random.default_rng(Sk + block_kv)
    q = rng.standard_normal((1, 7, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, Sk, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = ref_common.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), causal=False, block_kv=block_kv)
    got = common.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=False, block_kv=block_kv)
    assert lp.rel(got, want) <= lp.TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encode_matches_the_reference(dtype):
    cfg, rcfg, model, tree = lp.both(ARCH, dtype)
    frames = lp.inputs(cfg, P)["frames"]
    want = ref_forward.whisper_encode(
        rcfg, ref_forward._cast(rcfg, tree), jnp.asarray(frames))
    got = forward.whisper_encode(cfg, model, torch.from_numpy(frames))
    assert got.shape == (lp.B, cfg.encoder_frames, cfg.d_model)
    assert lp.rel(got, want) <= lp.TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_lm_matches_the_reference(dtype):
    lp.check_forward(ARCH, dtype, P + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cross_kv_match_the_reference(dtype):
    """Self K/V at the prompt's length, cross K/V over the 30 frames."""
    cache, _ = lp.check_prefill(ARCH, dtype, P)
    assert set(cache) == {"k", "v", "xk", "xv"}
    assert cache["k"].shape[2] == P and cache["xk"].shape[2] == 30


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_the_reference(dtype):
    """Cross-attention reads every frame (the reference's
    ``kv_valid_len`` of F - 1 keeps all F)."""
    lp.check_decode(ARCH, dtype, P, STEPS)


def test_greedy_tokens_equal_the_reference_loop():
    lp.check_greedy(ARCH)


def test_decode_matches_forward_in_bfloat16():
    lp.check_decode_vs_forward(ARCH, P, steps=2)


def test_grow_cache_grows_self_kv_and_keeps_cross_kv():
    """The reference pads every leaf whose axis 2 is P long, so a prompt
    of ``encoder_frames`` tokens would pad its cross K/V too (ROADMAP.md
    §3); the port grows ``k`` and ``v`` alone."""
    cfg, _, model, _ = lp.both(ARCH, "float32")
    x = lp.inputs(cfg, cfg.encoder_frames)
    _, cache = lp.prefill(cfg, model, torch.from_numpy(x["prompts"]),
                          frames=torch.from_numpy(x["frames"]))
    grown = lp.serve.grow_cache(cfg, cache, cfg.encoder_frames + 6)
    assert grown["xk"] is cache["xk"] and grown["xv"] is cache["xv"]
    assert grown["k"].shape[2] == cfg.encoder_frames + 6
    assert torch.equal(grown["k"][:, :, :cfg.encoder_frames], cache["k"])


def test_frames_are_required():
    cfg, _, model, _ = lp.both(ARCH, "float32")
    with pytest.raises(ValueError, match="frames"):
        lp.prefill(cfg, model, torch.zeros((lp.B, 4), dtype=torch.int32))


def test_serve_arch_cli_on_the_cpu(capsys):
    lp.check_serve_cli(ARCH, capsys)
