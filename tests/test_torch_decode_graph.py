"""The decode step with its position on the device (a 0-d int32 tensor),
on the CPU: against the host-integer path and against the reference's
``decode_step`` (which traces ``pos``), for every family; K5's plain
split and combine with ``kv_len`` on the device (chunks planned for all
S, the ones past ``kv_len`` empty) against the whole function;
``DecodeReplay`` against a loop of steps; MLA's masked horizon against
the sliced form.

Tolerances, float32, norm-relative: 1e-6 between the tensor and the
integer position (the same arithmetic: masks in place of slices), 1e-4
against the reference (as ``torch_lm_parity``); K5's pieces 1e-6 in
float32, 1e-3 in bfloat16 (one rounding of the output).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import decode_attention as k5
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import decode_step, prefill
from repro_torch.models import model as port_model
from repro_torch.models.forward import ring_slots
from repro_torch.train import steps
from torch_lm_parity import both, extras, grow_ref, inputs
from torch_lm_parity import rel as _rel
from torch_threads import capped_torch_threads  # noqa: F401


def rel(got, want) -> float:
    """Norm-relative error; either side may be a tensor of any dtype."""
    return _rel(got, want.float() if isinstance(want, torch.Tensor)
                else want)


P, STEPS = 20, 4


def dpos(i: int) -> torch.Tensor:
    return torch.tensor(i, dtype=torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_device_position_matches_host_position_and_reference(arch):
    cfg, rcfg, model, tree = both(arch, "float32")
    x = inputs(cfg, P + STEPS)
    toks = x["prompts"]
    _, c_int = prefill(cfg, model, torch.from_numpy(toks[:, :P]),
                       **extras(x, "port"))
    c_int = serve.grow_cache(cfg, c_int, P + STEPS)
    c_dev = {k: v.clone() for k, v in c_int.items()}
    _, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks[:, :P]),
                                   **extras(x, "ref"))
    wcache = grow_ref(rcfg, wcache, P, P + STEPS)
    ref_step = jax.jit(ref_models.decode_step, static_argnums=0)
    for i in range(STEPS):
        t = torch.from_numpy(toks[:, P + i])
        a, _ = decode_step(cfg, model, c_int, t, P + i)
        b, _ = decode_step(cfg, model, c_dev, t, dpos(P + i))
        want, wcache = ref_step(rcfg, tree, wcache,
                                jnp.asarray(toks[:, P + i]), jnp.int32(P + i))
        assert rel(b, a) <= 1e-6, i
        assert rel(b, want) <= 1e-4, i
    for k in c_int:
        assert rel(c_dev[k], c_int[k]) <= 1e-6, k
        assert rel(c_dev[k], wcache[k]) <= 1e-4, k


def test_decode_step_refuses_a_position_it_cannot_trace():
    cfg, _, model, _ = both("llama3_8b", "float32")
    _, cache = prefill(cfg, model, torch.zeros((2, 4), dtype=torch.int32))
    tok = torch.zeros(2, dtype=torch.int32)
    for bad in (torch.tensor([4], dtype=torch.int32),
                torch.tensor(4, dtype=torch.int64)):
        with pytest.raises(ValueError, match="0-d int32"):
            decode_step(cfg, model, cache, tok, bad)


@pytest.mark.parametrize("arch", ["llama3_8b", "hymba_1p5b", "mamba2_2p7b",
                                  "deepseek_v2_lite", "whisper_medium"])
def test_decode_replay_matches_a_loop_of_steps(arch):
    """``DecodeReplay`` (tokens and position advanced on the device)
    gives the greedy tokens of a loop of ``decode_step`` at host
    positions, and its counters."""
    cfg, _, model, _ = both(arch, "float32")
    x = inputs(cfg, P)
    ex = extras(x, "port")
    logits, c1 = prefill(cfg, model, torch.from_numpy(x["prompts"]), **ex)
    c1 = serve.grow_cache(cfg, c1, P + 8)
    c2 = {k: v.clone() for k, v in c1.items()}
    tok = torch.argmax(logits, -1).to(torch.int32)
    replay = steps.DecodeReplay(cfg, model, c2, tok, P)
    step = steps.make_decode_step(cfg)
    t = tok
    for i in range(6):
        t, _, c1 = step(model, c1, t, P + i)
        got = replay()
        assert torch.equal(got, t), i
        assert int(replay.pos) == P + i + 1
    assert replay.captures == 0
    for k in c1:        # the plain K5 masks where the host path slices
        assert rel(c2[k], c1[k]) <= 1e-6, k


def test_generate_on_the_cpu_runs_the_eager_replay():
    cfg = dataclasses.replace(smoke_config("qwen2_7b"),
                              compute_dtype="float32")
    model = serve.load_model(cfg, 0, "cpu")
    x = serve.draw_inputs(cfg, 2, 12, 0)
    a = serve.generate(cfg, model, x["prompts"], 6)
    b = serve.generate(cfg, model, x["prompts"], 6, graph=False)
    assert a["captures"] == b["captures"] == 0
    assert np.array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 6) and len(a["step_ms"]) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [1, 33, 64, 65, 200, 256])
def test_plain_split_with_empty_chunks_matches_the_whole_function(kv_len,
                                                                  dtype):
    """K5's plain split with a device ``kv_len`` (chunks of 32 over all
    256 rows: up to 7 empty), then its plain combine, against the plain
    whole function and against the host-integer split; the empty chunks
    hold m = -inf, l = 0, acc = 0."""
    rng = np.random.default_rng(kv_len)
    B, Hq, Hkv, S, d, length = 2, 6, 2, 256, 16, 32

    def rnd(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float32
                            ).to(dtype)
    q, k, v = rnd(B, Hq, d), rnd(B, S, Hkv, d), rnd(B, S, Hkv, d)
    kl = dpos(kv_len)
    acc, m, l = ref.decode_attention_split(q, k, v, length, kv_len=kl)
    assert acc.shape == (B * Hkv * (S // length), Hq // Hkv, d)
    chunk = torch.arange(acc.shape[0]) % (S // length)
    empty = chunk * length >= kv_len
    assert int(empty.sum()) == B * Hkv * (S // length - -(-kv_len // length))
    assert bool((m[empty] == -torch.inf).all())
    assert bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
    assert bool(torch.isfinite(m[~empty]).all())
    got = ref.decode_attention_combine(acc, m, l, B, Hq, dtype)
    tol = 1e-6 if dtype == torch.float32 else 1e-3
    assert rel(got, ref.decode_attention(q, k, v, kv_len=kv_len)) <= tol
    assert rel(ops.decode_attention(q, k, v, kl),
               ref.decode_attention(q, k, v, kv_len=kv_len)) <= tol
    host = ref.decode_attention_split(q, k, v, length, kv_len=kv_len)
    n = host[0].shape[0] // (B * Hkv)
    full = ~empty.reshape(B * Hkv, -1)
    for a, h in zip((acc, m, l), host):
        a = a.reshape(B * Hkv, S // length, *a.shape[1:])[full]
        assert rel(a, h.reshape(B * Hkv * n, *h.shape[1:])) <= 1e-6


def test_device_kv_len_is_checked():
    q, k = torch.zeros(1, 2, 8), torch.zeros(1, 10, 1, 8)
    for bad in (torch.tensor([3], dtype=torch.int32),
                torch.tensor(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="0-d int32"):
            ops.decode_attention(q, k, k, bad)
    assert k5.check_kv_len(dpos(4), 10) is not None


@pytest.mark.parametrize("pos", [0, 5, 31, 32, 77])
def test_ring_slots_on_the_device(pos):
    assert int(ring_slots(dpos(pos), 32)) == ring_slots(pos, 32)


@pytest.mark.parametrize("pos", [0, 17, 39])
def test_mla_masked_horizon_matches_the_sliced_form(pos):
    """The absorbed MLA decode over all 40 rows with those after ``pos``
    masked (the device position's form) against the same function on
    the first ``pos + 1`` rows alone."""
    cfg, _, model, _ = both("deepseek_v2_lite", "float32")
    lp = model.layers[0]
    rng = np.random.default_rng(pos)
    x = torch.tensor(rng.standard_normal((2, 1, cfg.d_model)),
                     dtype=torch.float32)
    ckv = torch.tensor(rng.standard_normal((2, 40, cfg.kv_lora_rank)),
                       dtype=torch.float32)
    kr = torch.tensor(rng.standard_normal((2, 40, cfg.qk_rope_dim)),
                      dtype=torch.float32)
    full = port_model.mla_decode_attention(cfg, x, lp, ckv, kr, dpos(pos))
    cut = port_model.mla_decode_attention(cfg, x, lp, ckv[:, :pos + 1],
                                          kr[:, :pos + 1], pos)
    assert rel(full, cut) <= 1e-6
