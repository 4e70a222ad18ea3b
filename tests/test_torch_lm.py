"""The port's LM serving path (``repro_torch.models``, ``train.steps``,
``launch.serve --arch``) against the JAX reference on the CPU.

Both packages run on the same parameters: the reference's
``init_params`` tree as numpy arrays, its biases and norm gains drawn at
random (the reference initialises them to 0 and 1, which would leave
their code paths untested), handed to the port through
``models.convert.params_from_reference``.  The four dense configs use
RMSNorm, SwiGLU and an untied unembedding; the dense path's other
branches (LayerNorm, GELU, tied embeddings) run on llama3_8b's smoke
config with the one field replaced, on both sides.  Inputs are made from a seed
with numpy.  The reference's model path has no Pallas call; on the CPU
the port's RMSNorms and decode attention run K4's and K5's plain
versions.

Tolerances, norm-relative (``||got - want|| / ||want||``) on logits and
caches:

* 1e-4 with ``compute_dtype="float32"``: the same arithmetic, summed in
  another order; greedy tokens equal;
* 2e-2 in bfloat16: both round every matmul and activation to bfloat16,
  the reference its RMSNorm products too where K4 rounds once;
* 5e-2 for the port's own decode against its forward in bfloat16, the
  reference's bound for the same check (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.train import steps as ref_steps
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import (cast_params, decode_step, forward_lm,
                                init_params, model_shapes, prefill,
                                zero_cache)
from repro_torch.models.convert import params_from_reference
from repro_torch.train import steps
from torch_threads import capped_torch_threads  # noqa: F401

DENSE = ["llama3_8b", "qwen2_7b", "granite3_8b", "granite_34b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_VS_FORWARD = 5e-2
B, P, STEPS = 2, 24, 4


def rel(got, want) -> float:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def configs(arch, dtype):
    return (dataclasses.replace(smoke_config(arch), compute_dtype=dtype),
            dataclasses.replace(ref_smoke_config(arch), compute_dtype=dtype))


def reference_tree(rcfg, seed=0) -> dict:
    """The reference's parameters as numpy float32 arrays, biases and
    norm gains drawn from ``seed``."""
    tree = jax.tree_util.tree_map(
        np.asarray, ref_models.init_params(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(name, a):
        if name.endswith("_g"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name.startswith("b") or name.endswith("_b"):
            return (0.02 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    out = {k: draw(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: draw(k, v) for k, v in tree["layers"].items()}
    return out


def both(arch, dtype, seed=0, **replace):
    """(port cfg, reference cfg, the port's cast model, the reference's
    tree) on the same numbers; ``replace``: config fields changed on
    both sides."""
    cfg, rcfg = configs(arch, dtype)
    cfg = dataclasses.replace(cfg, **replace)
    rcfg = dataclasses.replace(rcfg, **replace)
    tree = reference_tree(rcfg, seed)
    model = params_from_reference(cfg, tree, device="cpu")
    return cfg, rcfg, cast_params(cfg, model), tree


def tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def grow_ref(cache, S):
    return jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, S - a.shape[2]), (0, 0),
                              (0, 0)]), cache)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_model_and_cache_shapes_equal_the_reference(arch, size):
    get = smoke_config if size == "smoke" else get_config
    rget = ref_smoke_config if size == "smoke" else ref_get_config
    cfg, rcfg = get(arch), rget(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.params_count() == rcfg.params_count()
    assert model_shapes(cfg) == ref_models.model_shapes(rcfg)
    if size == "smoke":
        cache = zero_cache(cfg, B, 40, device="cpu")
        want = ref_models.abstract_cache(rcfg, B, 40)
        assert set(cache) == set(want)
        for k, a in want.items():
            assert tuple(cache[k].shape) == a.shape
            assert str(cache[k].dtype).split(".")[-1] == str(a.dtype)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for name, shape in model_shapes(cfg).items():
            if name != "layers":
                assert tuple(model[name].shape) == shape
        for lp in model.layers:
            assert {k: (cfg.n_layers,) + tuple(t.shape)
                    for k, t in lp.items()} == model_shapes(cfg)["layers"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_lm_matches_the_reference(arch, dtype):
    cfg, rcfg, model, tree = both(arch, dtype)
    toks = tokens(cfg, P + 1)
    want, _, _ = ref_models.forward_lm(rcfg, tree, jnp.asarray(toks))
    got, aux, _ = forward_lm(cfg, model, torch.from_numpy(toks))
    assert got.shape == (B, P + 1, cfg.vocab) and aux == 0.0
    assert got.dtype == getattr(torch, dtype)
    assert rel(got, want.astype(jnp.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_the_reference(arch, dtype):
    cfg, rcfg, model, tree = both(arch, dtype)
    toks = tokens(cfg, P)
    want, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks))
    got, cache = prefill(cfg, model, torch.from_numpy(toks))
    assert got.shape == (B, cfg.vocab)
    assert rel(got, want.astype(jnp.float32)) <= TOL[dtype]
    assert set(cache) == set(wcache) == {"k", "v"}
    for k in cache:
        assert tuple(cache[k].shape) == wcache[k].shape
        assert rel(cache[k], wcache[k].astype(jnp.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_the_reference(arch, dtype):
    """Four decode steps after a prefill, fed the same tokens on both
    sides: every step's logits and the final cache."""
    cfg, rcfg, model, tree = both(arch, dtype)
    toks = tokens(cfg, P + STEPS)
    _, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks[:, :P]))
    wcache = grow_ref(wcache, P + STEPS)
    _, cache = prefill(cfg, model, torch.from_numpy(toks[:, :P]))
    cache = serve.grow_cache(cfg, cache, P + STEPS)
    ref_step = jax.jit(ref_models.decode_step, static_argnums=0)
    for i in range(STEPS):
        want, wcache = ref_step(rcfg, tree, wcache,
                                jnp.asarray(toks[:, P + i]), P + i)
        got, cache = decode_step(cfg, model, cache,
                                 torch.from_numpy(toks[:, P + i]), P + i)
        assert rel(got, want.astype(jnp.float32)) <= TOL[dtype], i
    for k in cache:
        assert rel(cache[k], wcache[k].astype(jnp.float32)) <= TOL[dtype]


VARIANTS = {"layernorm": {"norm": "layernorm"}, "gelu": {"act": "gelu"},
            "tied": {"tie_embeddings": True}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_variants_match_the_reference(variant, dtype):
    """LayerNorm (gain and bias), GELU (tanh form) and the tied
    unembedding, each on llama3_8b's smoke config: the shapes, the
    forward's logits, prefill's logits and cache, and two decode steps."""
    cfg, rcfg, model, tree = both("llama3_8b", dtype, **VARIANTS[variant])
    assert model_shapes(cfg) == ref_models.model_shapes(rcfg)
    toks = tokens(cfg, P + 2)
    want, _, _ = ref_models.forward_lm(rcfg, tree, jnp.asarray(toks))
    got, _, _ = forward_lm(cfg, model, torch.from_numpy(toks))
    assert rel(got, want.astype(jnp.float32)) <= TOL[dtype]
    want, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks[:, :P]))
    got, cache = prefill(cfg, model, torch.from_numpy(toks[:, :P]))
    assert rel(got, want.astype(jnp.float32)) <= TOL[dtype]
    for k in cache:
        assert rel(cache[k], wcache[k].astype(jnp.float32)) <= TOL[dtype]
    wcache = grow_ref(wcache, P + 2)
    cache = serve.grow_cache(cfg, cache, P + 2)
    ref_step = jax.jit(ref_models.decode_step, static_argnums=0)
    for i in range(2):
        want, wcache = ref_step(rcfg, tree, wcache,
                                jnp.asarray(toks[:, P + i]), P + i)
        got, cache = decode_step(cfg, model, cache,
                                 torch.from_numpy(toks[:, P + i]), P + i)
        assert rel(got, want.astype(jnp.float32)) <= TOL[dtype], i


@pytest.mark.parametrize("block_kv", [4, 8, 1024])
def test_blockwise_attention_matches_the_reference(block_kv):
    """The online softmax across several KV blocks (G = 3 query heads a
    KV head; Sk = 24 in blocks of 4, 8 or one of 24), float32, causal."""
    from repro.models import common as ref_common
    from repro_torch.models import common
    rng = np.random.default_rng(block_kv)
    q = rng.standard_normal((B, 24, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, 24, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = ref_common.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, block_kv=block_kv)
    got = common.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                     block_kv=block_kv)
    assert rel(got, want) <= TOL["float32"]


def test_sliding_window_is_refused():
    """Decode against a window runs over the ring cache of the hybrid
    family; a dense config given a window is refused, not served
    unwindowed."""
    cfg = dataclasses.replace(smoke_config("llama3_8b"), window=8)
    toks = torch.zeros((B, 4), dtype=torch.int32)
    for call in (lambda: model_shapes(cfg),
                 lambda: forward_lm(cfg, None, toks),
                 lambda: zero_cache(cfg, B, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_equal_the_reference_loop(arch):
    """``launch.serve.generate`` against the reference's ``--arch`` loop
    (prefill, the cache grown, ``make_decode_step`` jitted), float32:
    the same greedy tokens."""
    cfg, rcfg, model, tree = both(arch, "float32")
    G = 8
    prompts = tokens(cfg, P, seed=3)
    logits, wcache = ref_steps.make_prefill_step(rcfg)(
        tree, {"tokens": jnp.asarray(prompts)})
    wcache = grow_ref(wcache, P + G)
    step = jax.jit(ref_steps.make_decode_step(rcfg))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(G - 1):
        tok, _, wcache = step(tree, wcache, tok, jnp.int32(P + i))
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], axis=1)
    res = serve.generate(cfg, model, prompts, G)
    assert res["tokens"].shape == (B, G) and res["tokens"].dtype == np.int32
    np.testing.assert_array_equal(res["tokens"], want)
    assert len(res["step_ms"]) == G - 1


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_in_bfloat16(arch):
    """The reference's serving invariant on the port alone: prefill(P) and
    one decode step (K5's plain version over the first P + 1 rows of a
    longer cache) against the forward over P + 1 tokens (the blockwise
    attention) at the last position."""
    cfg = smoke_config(arch)
    assert cfg.compute_dtype == "bfloat16"
    model = cast_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    toks = torch.from_numpy(tokens(cfg, P + 1, seed=1))
    want = forward_lm(cfg, model, toks)[0][:, P]
    _, cache = prefill(cfg, model, toks[:, :P])
    cache = serve.grow_cache(cfg, cache, P + 8)
    got, _ = decode_step(cfg, model, cache, toks[:, P], P)
    assert rel(got, want.float()) <= DECODE_VS_FORWARD


def test_steps_greedy_argmax_and_cache_in_place():
    cfg, _, model, _ = both("llama3_8b", "float32")
    toks = torch.from_numpy(tokens(cfg, P))
    logits, cache = steps.make_prefill_step(cfg)(model, {"tokens": toks})
    cache = serve.grow_cache(cfg, cache, P + 2)
    k0 = cache["k"]
    ids, step_logits, cache2 = steps.make_decode_step(cfg)(
        model, cache, torch.argmax(logits, -1).to(torch.int32), P)
    assert cache2 is cache and cache2["k"] is k0
    assert ids.dtype == torch.int32
    assert torch.equal(ids, torch.argmax(step_logits, -1).to(torch.int32))
    assert bool(cache["k"][:, :, P].abs().sum() > 0)
    assert bool(cache["k"][:, :, P + 1].abs().sum() == 0)


def test_the_model_path_hands_the_kernels_what_they_take(monkeypatch):
    """On the card K4 and K5 take contiguous tensors of one dtype: the
    plain versions that stand in for them here check it, and count the
    calls — one decode step makes 2 L + 1 RMSNorms and L GQA attentions
    (none with MLA), for a dense config and one MoE config of each
    branch (grok1_314b's GQA, deepseek_v2_lite's MLA)."""
    from repro_torch.kernels import ref
    calls = {"rmsnorm": 0, "decode_attention": 0}

    def checked(name):
        plain = getattr(ref, name)

        def call(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), name
            assert len({t.dtype for t in tensors[:3 if name != "rmsnorm"
                                                 else 1]}) == 1, name
            calls[name] += 1
            return plain(*args, **kw)
        return call

    for name in calls:
        monkeypatch.setattr(ref, name, checked(name))
    for arch in ("qwen2_7b", "grok1_314b", "deepseek_v2_lite"):
        cfg, _, model, _ = both(arch, "bfloat16")
        L = cfg.n_layers
        toks = torch.from_numpy(tokens(cfg, P))
        calls.update(rmsnorm=0, decode_attention=0)
        _, cache = prefill(cfg, model, toks)
        assert calls == {"rmsnorm": 2 * L + 1, "decode_attention": 0}, arch
        cache = serve.grow_cache(cfg, cache, P + 2)
        calls.update(rmsnorm=0)
        decode_step(cfg, model, cache, toks[:, -1], P)
        assert calls == {"rmsnorm": 2 * L + 1, "decode_attention":
                         0 if cfg.kv_lora_rank else L}, arch


def test_every_config_is_the_reference_config():
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        for get, rget in ((get_config, ref_get_config),
                          (smoke_config, ref_smoke_config)):
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(rget(arch))
            assert get(arch).active_params_count() == \
                rget(arch).active_params_count()


def test_a_model_that_was_not_cast_is_refused():
    cfg = smoke_config("llama3_8b")            # float32 params, bf16 compute
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="cast_params"):
        forward_lm(cfg, model, torch.zeros((1, 4), dtype=torch.int32))
    assert cast_params(cfg, model).embed.dtype == torch.bfloat16


def test_converter_refuses_a_tree_of_other_shapes():
    cfg, rcfg = configs("llama3_8b", "float32")
    tree = reference_tree(rcfg)
    tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(cfg, tree, device="cpu")
    del tree["unembed"]
    with pytest.raises(ValueError, match="leaves"):
        params_from_reference(cfg, tree, device="cpu")


def test_converter_without_a_device_needs_the_card(monkeypatch):
    """Called without a device, the converter puts the model on the card:
    on a machine without CUDA it raises and builds no CPU model."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, rcfg = configs("llama3_8b", "float32")
    with pytest.raises(RuntimeError, match="is_available"):
        params_from_reference(cfg, reference_tree(rcfg))


def test_serve_arch_cli_on_the_cpu(capsys):
    gen = serve.main(["--arch", "llama3_8b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "5"])
    assert gen.shape == (2, 5)
    out = capsys.readouterr().out
    assert "prefill 16 toks x2" in out and "decode  4 steps x2" in out
    assert "sample generation (first sequence):" in out
    # the same seed draws the same model and tokens
    again = serve.main(["--arch", "llama3_8b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "5"])
    np.testing.assert_array_equal(gen, again)
    with pytest.raises(ValueError, match="dist"):
        serve.main(["--arch", "llama3_8b", "--smoke", "--device", "cpu",
                    "--model-parallel", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])


def test_serve_lm_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "=== qwen2_7b ===" in out and "decode  15 steps x4" in out
