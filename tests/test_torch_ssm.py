"""The port's ssm family (mamba2_2p7b: the SSD mixer alone, tied
embeddings, an O(1) float32 state) against the JAX reference on the CPU,
at the smoke config with B = 2; the helpers and tolerances are
``torch_lm_parity``'s.  The chunked scan is also held to the step-by-step
recurrence it is dual to, in float32 at 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as lp
from repro.models import ssm as ref_ssm
from repro_torch.models import ssm
from repro_torch.models.model import ssm_params
from torch_threads import capped_torch_threads  # noqa: F401

ARCH = "mamba2_2p7b"
P, STEPS = 24, 4


def ssd_inputs(S, seed=0):
    cfg = lp.smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f = np.float32
    return (0.3 * rng.standard_normal((lp.B, S, H, Pd))).astype(f), \
        (-0.1 * np.abs(rng.standard_normal((lp.B, S, H)))).astype(f), \
        (0.3 * rng.standard_normal((lp.B, S, N))).astype(f), \
        (0.3 * rng.standard_normal((lp.B, S, N))).astype(f)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_model_and_cache_shapes_equal_the_reference(size):
    """Includes the float32 ``state`` leaf of a bfloat16 model."""
    lp.check_shapes(ARCH, size)


@pytest.mark.parametrize("S,chunk,c", [(40, 32, 8), (32, 32, 32),
                                       (24, 4, 4), (7, 4, 1)])
def test_ssd_forward_matches_the_reference(S, chunk, c):
    """The chunk halves until it divides S (40 -> 8; at an odd S it falls
    to 1): outputs and final state against the reference's."""
    assert ssm.chunk_of(S, chunk) == c
    xdt, a_log, Bv, Cv = ssd_inputs(S)
    want_y, want_state = ref_ssm.ssd_forward(
        *map(jnp.asarray, (xdt, a_log, Bv, Cv)), chunk=chunk)
    y, state = ssm.ssd_forward(*map(torch.from_numpy, (xdt, a_log, Bv, Cv)),
                               chunk=chunk)
    assert state.dtype == torch.float32
    assert lp.rel(y, want_y) <= lp.TOL["float32"]
    assert lp.rel(state, want_state) <= lp.TOL["float32"]


def test_ssd_chunked_matches_stepwise():
    """The chunked scan against the per-token recurrence it is dual to
    (the port's counterpart of the reference's own duality test)."""
    S = 16
    xdt, a_log, Bv, Cv = map(torch.from_numpy, ssd_inputs(S, seed=1))
    y, state = ssm.ssd_forward(xdt, a_log, Bv, Cv, chunk=4)
    st = torch.zeros(state.shape)
    ys = []
    for t in range(S):
        st = st * torch.exp(a_log[:, t])[..., None, None] \
            + xdt[:, t, :, :, None] * Bv[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cv[:, t]))
    assert lp.rel(y, torch.stack(ys, 1).numpy()) <= lp.TOL["float32"]
    assert lp.rel(state, st.numpy()) <= lp.TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixer_prefill_and_step_match_the_reference(dtype):
    """``ssm_mixer`` over a sequence (chunked) and one decode step from
    its final state, against the reference's on the same layer."""
    cfg, rcfg, model, tree = lp.both(ARCH, dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((lp.B, 40, cfg.d_model)).astype(np.float32)
    rp = {k[4:]: jnp.asarray(a[0]).astype(rcfg.compute_dtype)
          for k, a in tree["layers"].items() if k.startswith("ssm_")}
    p = ssm_params(model.layers[0])
    xr = jnp.asarray(x).astype(rcfg.compute_dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want, wstate = ref_ssm.ssm_mixer(rcfg, xr[:, :39], rp)
    got, state = ssm.ssm_mixer(cfg, xt[:, :39], p)
    assert lp.rel(got, want) <= lp.TOL[dtype]
    assert lp.rel(state, wstate) <= lp.TOL[dtype]
    want, wstate = ref_ssm.ssm_mixer(rcfg, xr[:, 39:], rp, state=wstate)
    got, state2 = ssm.ssm_mixer(cfg, xt[:, 39:], p, state=state)
    assert state2 is state                      # advanced in place
    assert lp.rel(got, want) <= lp.TOL[dtype]
    assert lp.rel(state, wstate) <= lp.TOL[dtype]


def test_mixer_chunked_matches_its_decode_steps():
    """The mixer over S tokens at once against S single-token steps from
    a zero state, float32: outputs and final state."""
    cfg, _, model, _ = lp.both(ARCH, "float32")
    p = ssm_params(model.layers[1])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (lp.B, 12, cfg.d_model)).astype(np.float32))
    want, wstate = ssm.ssm_mixer(cfg, x, p)
    state = torch.zeros(wstate.shape)
    got = torch.cat([ssm.ssm_mixer(cfg, x[:, t:t + 1], p, state=state)[0]
                     for t in range(12)], 1)
    assert lp.rel(got, want.numpy()) <= lp.TOL["float32"]
    assert lp.rel(state, wstate.numpy()) <= lp.TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [P + 1, 40])
def test_forward_lm_matches_the_reference(dtype, S):
    """At 25 tokens (chunk 32 -> 1) and 40 (chunk 8)."""
    lp.check_forward(ARCH, dtype, S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_state_match_the_reference(dtype):
    cache, _ = lp.check_prefill(ARCH, dtype, P)
    assert set(cache) == {"state"} and cache["state"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_the_reference(dtype):
    lp.check_decode(ARCH, dtype, P, STEPS)


def test_greedy_tokens_equal_the_reference_loop():
    lp.check_greedy(ARCH)


def test_decode_matches_forward_in_bfloat16():
    """Four steps after a prefill of 32 (chunk 32), against the forward
    over 36 (chunk 4)."""
    lp.check_decode_vs_forward(ARCH, P=32, steps=4)


def test_grow_cache_keeps_the_state():
    """The state has no sequence axis: the grown cache holds the
    prefill's tensor as it is (the reference pads it where its
    ``ssm_heads`` equals the prompt length, ROADMAP.md §3)."""
    cfg, _, model, _ = lp.both(ARCH, "float32")
    x = lp.inputs(cfg, cfg.ssm_heads)
    _, cache = lp.prefill(cfg, model, torch.from_numpy(x["prompts"]))
    grown = lp.serve.grow_cache(cfg, cache, cfg.ssm_heads + 4)
    assert grown["state"] is cache["state"]


def test_serve_arch_cli_on_the_cpu(capsys):
    lp.check_serve_cli(ARCH, capsys)


def test_serve_lm_example_serves_the_ssm_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== qwen2_7b ===" in out and "=== mamba2_2p7b ===" in out
    assert out.count("decode  15 steps x4") == 2
