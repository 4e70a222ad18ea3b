"""The port's hybrid family (hymba_1p5b: sliding-window GQA beside the
SSD mixer in every layer, their outputs each normalised and averaged; a
ring cache of W = ``window`` slots) against the JAX reference on the CPU,
at the smoke config (W = 32) with B = 2; the helpers and tolerances are
``torch_lm_parity``'s.  Both ring branches of the prefill are held: P =
24 < W (the ring padded) and P = 40 >= W (the last W positions rolled
by 8), and decode steps on both sides of the wrap."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as lp
from repro.models import common as ref_common
from repro.models import forward as ref_forward
from repro_torch.models import common, forward
from repro_torch.models.model import decode_gqa_attention
from torch_threads import capped_torch_threads  # noqa: F401

ARCH = "hymba_1p5b"
W = 32


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_model_and_cache_shapes_equal_the_reference(size):
    lp.check_shapes(ARCH, size)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,block_kv", [(8, 16), (8, 1024), (5, 7),
                                             (40, 16)])
def test_windowed_blockwise_attention_matches_the_reference(window, block_kv,
                                                            causal):
    """The sliding window over several KV blocks (Sk = 40, G = 2),
    float32; the port's last block is ragged where ``block_kv`` does not
    divide 40, the reference's halved."""
    rng = np.random.default_rng(window + block_kv)
    q = rng.standard_normal((lp.B, 40, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((lp.B, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = ref_common.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        block_kv=block_kv)
    got = common.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window,
                                     block_kv=block_kv)
    assert lp.rel(got, want) <= lp.TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [24, 48])
def test_forward_lm_matches_the_reference(dtype, S):
    """Within the window (24) and past it (48)."""
    lp.check_forward(ARCH, dtype, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [24, 40])
def test_prefill_logits_and_ring_match_the_reference(dtype, P):
    """The padded ring (P = 24: positions in slots 0..23, zeros after) and
    the rolled one (P = 40: the last 32 positions, position i in slot i
    mod 32), and the float32 state."""
    cache, _ = lp.check_prefill(ARCH, dtype, P)
    assert tuple(cache["k"].shape[2:3]) == (W,)
    assert cache["state"].dtype == torch.float32
    if P < W:
        assert not cache["k"][:, :, P:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,steps", [(28, 8), (40, 4)])
def test_decode_steps_match_the_reference(dtype, P, steps):
    """From the padded ring across the wrap (positions 28..35, the ring
    full at 31, slot 0 overwritten at 32) and from the rolled one."""
    lp.check_decode(ARCH, dtype, P, steps)


def test_greedy_tokens_equal_the_reference_loop():
    """Prompt 24, 12 tokens: the loop wraps the ring at position 32."""
    lp.check_greedy(ARCH, P=24, G=12)


def test_decode_matches_forward_in_bfloat16():
    """A prefill of 32 (= W) and 8 steps past the wrap, against the
    windowed forward over 40."""
    lp.check_decode_vs_forward(ARCH, P=32, steps=8)


@pytest.mark.parametrize("pos", [0, 5, 31, 32, 45, 70])
def test_k5_over_the_ring_prefix_is_the_reference_ring_attention(pos):
    """K5 (its plain version here) over the first ``min(pos + 1, W)``
    ring rows against the reference's ``_ring_attention``, which masks
    the W slots by their positions: equal before and after the wrap."""
    cfg, rcfg, model, tree = lp.both(ARCH, "float32")
    rng = np.random.default_rng(pos)
    h = rng.standard_normal((lp.B, 1, cfg.d_model)).astype(np.float32)
    ring = (rng.standard_normal((lp.B, W, cfg.n_kv_heads, cfg.dh))
            .astype(np.float32) for _ in range(2))
    ck, cv = ring
    # slots never written hold garbage the mask must skip
    if pos < W:
        ck[:, pos + 1:] = 1e3
        cv[:, pos + 1:] = 1e3
    lpr = {k: jnp.asarray(a[0]) for k, a in tree["layers"].items()}
    k_positions = pos - ((pos - jnp.arange(W)) % W)
    want = ref_forward._ring_attention(rcfg, jnp.asarray(h), lpr,
                                       jnp.asarray(ck), jnp.asarray(cv),
                                       k_positions, pos)
    assert forward.ring_slots(pos, W) == min(pos + 1, W)
    got = decode_gqa_attention(cfg, torch.from_numpy(h), model.layers[0],
                               torch.from_numpy(ck), torch.from_numpy(cv),
                               pos, kv_len=forward.ring_slots(pos, W))
    assert lp.rel(got, want) <= lp.TOL["float32"]


def test_grow_cache_keeps_the_ring_and_state():
    cfg, _, model, _ = lp.both(ARCH, "float32")
    x = lp.inputs(cfg, 24)
    _, cache = lp.prefill(cfg, model, torch.from_numpy(x["prompts"]))
    grown = lp.serve.grow_cache(cfg, cache, 40)
    assert all(grown[k] is cache[k] for k in cache)


def test_a_window_outside_the_hybrid_family_is_refused():
    cfg = dataclasses.replace(lp.smoke_config("mamba2_2p7b"), window=8)
    with pytest.raises(NotImplementedError, match="hybrid"):
        lp.model_shapes(cfg)


def test_serve_arch_cli_on_the_cpu(capsys):
    lp.check_serve_cli(ARCH, capsys)
