"""The port's MoE family (``repro_torch.models`` with ``moe_layer`` and
DeepSeek's MLA) against the JAX reference on the CPU.

Two configs cover the family's branches: ``deepseek_v2_lite`` (MLA, a
dense head layer, routed experts top-k plus shared experts) and
``grok1_314b`` (GQA, routed experts only).  Both packages run on the same
parameters: the reference's ``init_params`` tree as numpy arrays, its
norm gains drawn at random, handed to the port through
``models.convert.params_from_reference``.  Inputs are made from a seed
with numpy.  The reference's MoE and MLA are plain JAX (no Pallas call);
on the CPU the port's RMSNorms and GQA decode attention run K4's and
K5's plain versions.

Tolerances, norm-relative (``||got - want|| / ||want||``):

* 1e-4 with ``compute_dtype="float32"``: the same arithmetic, summed in
  another order; the routing is identical (asserted), greedy tokens
  equal;
* 2e-2 in bfloat16 under the routing rule: the router reads x, which
  differs from the reference's by bfloat16 rounding, so a token whose
  top-k choice is a near tie may pick another expert.  Each MoE layer's
  choices are compared first; a token may disagree only where the
  reference's k-th and (k+1)-th probabilities lie within bfloat16's
  resolution (2**-7 relative) of each other (asserted), and it is left
  out of the 2e-2 hold;
* 5e-2 max-relative for the port's decode against its forward, the
  reference's bound (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro.train import steps as ref_steps
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import (cache_shapes, cast_params, decode_step,
                                forward_lm, init_params, model_shapes,
                                prefill, zero_cache)
from repro_torch.models import common, model as port_model
from repro_torch.models.convert import params_from_reference
from torch_threads import capped_torch_threads  # noqa: F401

MOE = ["deepseek_v2_lite", "grok1_314b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: bfloat16's resolution: a near tie of two router probabilities
BF16_RES = 2.0 ** -7
DECODE_VS_FORWARD = 5e-2
B, P, STEPS = 2, 24, 4


def rel(got, want) -> float:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def configs(arch, dtype, **replace):
    return (dataclasses.replace(smoke_config(arch), compute_dtype=dtype,
                                **replace),
            dataclasses.replace(ref_smoke_config(arch), compute_dtype=dtype,
                                **replace))


def reference_tree(rcfg, seed=0) -> dict:
    """The reference's parameters as numpy float32 arrays, norm gains
    drawn from ``seed`` (the reference initialises them to 1)."""
    tree = jax.tree_util.tree_map(
        np.asarray, ref_models.init_params(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(name, a):
        if name.endswith("_g"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return {k: ({n: draw(n, a) for n, a in v.items()}
                if isinstance(v, dict) else draw(k, v))
            for k, v in tree.items()}


def both(arch, dtype, seed=0, **replace):
    """(port cfg, reference cfg, the port's cast model, the reference's
    tree) on the same numbers; ``replace``: fields changed on both
    sides."""
    cfg, rcfg = configs(arch, dtype, **replace)
    tree = reference_tree(rcfg, seed)
    model = params_from_reference(cfg, tree, device="cpu")
    return cfg, rcfg, cast_params(cfg, model), tree


def tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def grow_ref(cache, S):
    return jax.tree_util.tree_map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, S - a.shape[2])]
                          + [(0, 0)] * (a.ndim - 3)), cache)


def layer_params(tree, stack="layers", l=0):
    """One layer of a stacked reference tree: numpy for the reference,
    torch for the port."""
    lp = {k: a[l] for k, a in tree[stack].items()}
    return lp, {k: torch.from_numpy(np.array(a)) for k, a in lp.items()}


@pytest.fixture
def routes(monkeypatch):
    """Records each MoE layer's routing on both sides, in call order: the
    reference's router probabilities (G, Tg, E) through a debug callback
    (its layers run under ``lax.scan``), the port's expert ids (G, Tg,
    k)."""
    got = {"ref": [], "port": []}
    ref_moe, port_moe = ref_model.moe_layer, port_model.moe_layer

    def ref_tap(cfg, x, p):
        probs = jax.nn.softmax(jnp.einsum(
            "gtd,de->gte", x.astype(jnp.float32),
            p["router"].astype(jnp.float32)), axis=-1)
        jax.debug.callback(lambda a: got["ref"].append(np.asarray(a)),
                           probs, ordered=True)
        return ref_moe(cfg, x, p)

    def port_tap(cfg, x, p):
        got["port"].append(common.route(cfg, x, p["router"])[2].numpy())
        return port_moe(cfg, x, p)

    monkeypatch.setattr(ref_model, "moe_layer", ref_tap)
    monkeypatch.setattr(port_model, "moe_layer", port_tap)
    return got


def agreeing(cfg, got, S, exact: bool) -> np.ndarray:
    """(B, S) mask of the tokens held to the tolerance, from the routing
    records of one call over B sequences of S tokens: those whose experts
    equal the reference's in every layer.  A token that differs must be
    a near tie of the reference's k-th and (k+1)-th probabilities;
    ``exact``: no token may differ (float32)."""
    k = cfg.topk
    # the reference's callbacks run with its computation, which JAX
    # dispatches asynchronously: wait for them before reading
    jax.effects_barrier()
    assert len(got["ref"]) == len(got["port"]) > 0
    agree = np.ones((B, S), bool)
    for probs, idx in zip(got["ref"], got["port"]):
        ps = -np.sort(-probs, axis=-1).reshape(B, S, -1)
        ref_set = np.sort(np.argsort(-probs, axis=-1)[..., :k], -1)
        differ = np.any(ref_set != np.sort(idx, -1), -1).reshape(B, S)
        assert not (exact and differ.any())
        gap = ps[..., k - 1] - ps[..., k]
        assert np.all(gap[differ] <= BF16_RES * ps[..., k - 1][differ]), \
            "a routing flip that is not a near tie"
        agree &= ~differ
    got["ref"].clear()
    got["port"].clear()
    return agree


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", MOE)
def test_model_and_cache_shapes_equal_the_reference(arch, size):
    get = smoke_config if size == "smoke" else get_config
    rget = ref_smoke_config if size == "smoke" else ref_get_config
    cfg, rcfg = get(arch), rget(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert model_shapes(cfg) == ref_models.model_shapes(rcfg)
    want = ref_models.abstract_cache(rcfg, B, 40)
    assert cache_shapes(cfg, B, 40) == {k: a.shape for k, a in want.items()}
    if size == "smoke":
        cache = zero_cache(cfg, B, 40, device="cpu")
        for k, a in want.items():
            assert tuple(cache[k].shape) == a.shape
            assert str(cache[k].dtype).split(".")[-1] == str(a.dtype)
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        counts = {"layers": cfg.n_layers - cfg.first_dense_layers,
                  "head_layers": cfg.first_dense_layers}
        for stack, n in counts.items():
            assert len(getattr(model, stack)) == n
            for lp in getattr(model, stack):
                assert {k: (n,) + tuple(t.shape) for k, t in lp.items()} \
                    == model_shapes(cfg)[stack]


@pytest.mark.parametrize("arch", MOE + ["llama3_8b"])
def test_init_casts_each_leaf_as_it_is_drawn(arch):
    """``init_params(..., dtype=)`` casts each leaf right after drawing
    it: bitwise the parameters of drawing all of them and then casting."""
    cfg = smoke_config(arch)
    cast = init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                       dtype=torch.bfloat16)
    want = cast_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))
    names = [n for n, _ in want.named_parameters()]
    assert names == [n for n, _ in cast.named_parameters()]
    for (n, a), b in zip(want.named_parameters(), cast.parameters()):
        assert a.dtype == b.dtype == torch.bfloat16, n
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
    model = serve.load_model(cfg, 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 want.parameters()))


#: (B, S, router scale): 48 tokens in 16 groups of 3, 2 in one group, and
#: a router skewed towards expert 0 so that it overflows its capacity:
#: 50 tokens in one group (C = 31 for grok's smoke config) and 192 in 16
#: groups of 12 (C = 8)
MOE_CASES = {"16_groups": (2, 24, False), "1_group": (2, 1, False),
             "overflow_1_group": (2, 25, True),
             "overflow_16_groups": (2, 96, True)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_the_reference(arch, case):
    """``_moe_or_mlp`` on an MoE layer's parameters in float32: the output
    and ``aux`` within 1e-4, the same groups, and in the overflow cases
    at least one assignment dropped (counted by the port's
    ``dispatch``)."""
    cfg, rcfg = configs(arch, "float32")
    tree = reference_tree(rcfg)
    Bx, S, skew = MOE_CASES[case]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((Bx, S, cfg.d_model)).astype(np.float32)
    ref_p, p = layer_params(tree)
    if skew:
        x += 1.0
        ref_p["router"] = ref_p["router"].copy()
        ref_p["router"][:, 0] += 0.05
        p["router"] = torch.from_numpy(ref_p["router"].copy())
    want, waux = ref_model._moe_or_mlp(rcfg, jnp.asarray(x), ref_p, True)
    got, aux = port_model._moe_or_mlp(cfg, torch.from_numpy(x), p, True)
    assert got.shape == (Bx, S, cfg.d_model)
    assert rel(got, want) <= TOL["float32"]
    assert abs(float(aux) - float(waux)) <= TOL["float32"] * abs(float(waux))
    T = Bx * S
    groups = 16 if T % 16 == 0 and T >= 16 else 1
    xg = torch.from_numpy(x).reshape(groups, T // groups, cfg.d_model)
    _, _, idx = common.route(cfg, xg, p["router"])
    C, *_, keep = common.dispatch(cfg, idx)
    assert keep.shape == (groups, T // groups * cfg.topk)
    assert bool(keep.all()) != skew, f"C {C}: a drop iff the router skews"


def test_moe_layer_repeats_bitwise_and_leaves_its_inputs():
    cfg, rcfg = configs("deepseek_v2_lite", "bfloat16")
    _, p = layer_params(reference_tree(rcfg))
    p = {k: t.to(torch.bfloat16) for k, t in p.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (16, 12, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    x0 = x.clone()
    a, aux_a = common.moe_layer(cfg, x, p)
    b, aux_b = common.moe_layer(cfg, x, p)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert float(aux_a) == float(aux_b) and torch.equal(x, x0)


def test_mla_attention_and_its_cache_pieces_match_the_reference():
    """The expanded MLA over a sequence (float32): the output, the latent
    and the rope key *before* rope, as the reference returns them."""
    cfg, rcfg = configs("deepseek_v2_lite", "float32")
    ref_p, p = layer_params(reference_tree(rcfg), "head_layers")
    x = np.random.default_rng(7).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32)
    want, (wckv, wkr) = ref_model.mla_attention(rcfg, jnp.asarray(x), ref_p)
    got, (ckv, kr) = port_model.mla_attention(cfg, torch.from_numpy(x), p)
    assert got.shape == (B, P, cfg.d_model)
    assert ckv.shape == (B, P, cfg.kv_lora_rank)
    assert kr.shape == (B, P, cfg.qk_rope_dim)
    for g, w in ((got, want), (ckv, wckv), (kr, wkr)):
        assert rel(g, w) <= TOL["float32"]
    # kr is the projection itself: no rope
    assert rel(kr, x @ ref_p["w_kr"]) <= 1e-6


@pytest.mark.parametrize("pos", [0, 17, 39])
def test_mla_decode_attention_matches_the_reference(pos):
    """The absorbed MLA decode against a latent cache of 40 rows whose
    rows past ``pos`` hold NaN on the port's side: the port reads the
    first ``pos + 1`` rows only, where the reference masks the rest."""
    cfg, rcfg = configs("deepseek_v2_lite", "float32")
    ref_p, p = layer_params(reference_tree(rcfg), "layers")
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, 40, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, 40, cfg.qk_rope_dim)).astype(np.float32)
    want = ref_model.mla_decode_attention(
        rcfg, jnp.asarray(x), ref_p, jnp.asarray(ckv), jnp.asarray(kr), pos)
    # copies: the reference's arrays may alias the numpy buffers and be
    # computed after the NaNs are written
    ckv_t, kr_t = torch.tensor(ckv), torch.tensor(kr)
    ckv_t[:, pos + 1:] = float("nan")
    kr_t[:, pos + 1:] = float("nan")
    got = port_model.mla_decode_attention(cfg, torch.from_numpy(x), p,
                                          ckv_t, kr_t, pos)
    assert got.shape == (B, 1, cfg.d_model)
    assert rel(got, want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_lm_matches_the_reference(arch, dtype, routes):
    """Logits (under the routing rule) and ``aux``, the MoE layers'
    load-balance terms summed."""
    cfg, rcfg, model, tree = both(arch, dtype)
    toks = tokens(cfg, P + 1)
    want, waux, _ = ref_models.forward_lm(rcfg, tree, jnp.asarray(toks))
    got, aux, _ = forward_lm(cfg, model, torch.from_numpy(toks))
    assert got.shape == (B, P + 1, cfg.vocab)
    assert got.dtype == getattr(torch, dtype)
    rows = agreeing(cfg, routes, P + 1, exact=dtype == "float32")
    assert rel(got[torch.from_numpy(rows)], f32(want)[rows]) <= TOL[dtype]
    assert abs(float(aux) - float(waux)) <= TOL[dtype] * abs(float(waux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_logits_and_cache_match_the_reference(arch, dtype, routes):
    """The last position's logits and every cache leaf (``ckv``, ``kr``
    before rope; ``k``, ``v``), under the routing rule."""
    cfg, rcfg, model, tree = both(arch, dtype)
    toks = tokens(cfg, P)
    want, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks))
    got, cache = prefill(cfg, model, torch.from_numpy(toks))
    rows = agreeing(cfg, routes, P, exact=dtype == "float32")
    assert got.shape == (B, cfg.vocab)
    last = rows[:, -1]
    assert rel(got[torch.from_numpy(last)], f32(want)[last]) <= TOL[dtype]
    names = {"ckv", "kr"} if cfg.kv_lora_rank else {"k", "v"}
    assert set(cache) == set(wcache) == names
    for k in cache:
        assert tuple(cache[k].shape) == wcache[k].shape
        mask = torch.from_numpy(rows)
        assert rel(cache[k][:, mask], f32(wcache[k])[:, rows]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_the_reference(arch, dtype, routes):
    """Four decode steps after a prefill, fed the same tokens on both
    sides: every step's logits and the final cache, under the routing
    rule (each step's and each cache row's token)."""
    cfg, rcfg, model, tree = both(arch, dtype)
    exact = dtype == "float32"
    toks = tokens(cfg, P + STEPS)
    _, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks[:, :P]))
    _, cache = prefill(cfg, model, torch.from_numpy(toks[:, :P]))
    rows = [agreeing(cfg, routes, P, exact)]
    wcache = grow_ref(wcache, P + STEPS)
    cache = serve.grow_cache(cfg, cache, P + STEPS)
    ref_step = jax.jit(lambda *a: ref_models.decode_step(rcfg, *a))
    for i in range(STEPS):
        want, wcache = ref_step(tree, wcache, jnp.asarray(toks[:, P + i]),
                                P + i)
        got, cache = decode_step(cfg, model, cache,
                                 torch.from_numpy(toks[:, P + i]), P + i)
        rows.append(agreeing(cfg, routes, 1, exact))
        step = rows[-1][:, 0]
        assert rel(got[torch.from_numpy(step)], f32(want)[step]) \
            <= TOL[dtype], i
    rows = np.concatenate(rows, axis=1)
    for k in cache:
        mask = torch.from_numpy(rows)
        assert rel(cache[k][:, mask], f32(wcache[k])[:, rows]) <= TOL[dtype]


@pytest.mark.parametrize("arch", MOE)
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
    np.testing.assert_array_equal(res["tokens"], want)
    assert set(res["cache"]) == set(cache_shapes(cfg, B, P + G))


@pytest.mark.parametrize("setup", ["reference", "no_drops"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_in_bfloat16(arch, setup):
    """The reference's serving check on the port alone: prefill(S - 1)
    and one decode step against the forward over S tokens at the last
    position, max-relative within 5e-2.  ``reference``: the check as
    ``tests/test_models.py`` runs it (the reference's parameters from
    key 0, B = 2, S = 32, the config's capacity factor).  ``no_drops``:
    the port's own parameters at S = P + 1 with the capacity factor
    replaced by E / k, so that C = Tg and no pass drops an assignment;
    at the config's 1.25 the forward's one group of 50 tokens drops
    assignments that the prefill's 16 groups and the decode keep, which
    moves grok's logits by 0.09 (a reference behaviour: capacity depends
    on the grouping)."""
    cfg = smoke_config(arch)
    if setup == "reference":
        S, seed = 32, 0
        tree = jax.tree_util.tree_map(np.asarray, ref_models.init_params(
            ref_smoke_config(arch), jax.random.PRNGKey(0)))
        model = params_from_reference(cfg, tree, device="cpu")
    else:
        S, seed = P + 1, 1
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.topk)
        model = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    model = cast_params(cfg, model)
    toks = torch.from_numpy(tokens(cfg, S, seed=seed))
    want = forward_lm(cfg, model, toks)[0][:, S - 1].float()
    _, cache = prefill(cfg, model, toks[:, :S - 1])
    cache = serve.grow_cache(cfg, cache, S + 7)
    got = decode_step(cfg, model, cache, toks[:, S - 1], S - 1)[0].float()
    assert float((got - want).abs().max() / want.abs().max()) \
        < DECODE_VS_FORWARD


def test_prefill_kr_is_unroped_and_roping_it_closes_decode_to_forward():
    """The reference's MLA prefill caches ``kr`` before rope while decode
    writes it after; the port mirrors that.  With no assignment dropped
    (capacity factor E / k on both passes) and the prefill's ``kr`` rows
    roped in place by the check, decode meets the forward in float32."""
    cfg, rcfg, model, tree = both("deepseek_v2_lite", "float32")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.topk)
    rcfg = dataclasses.replace(rcfg,
                               capacity_factor=cfg.n_experts / cfg.topk)
    toks = tokens(cfg, P + 1, seed=2)
    _, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks[:, :P]))
    _, cache = prefill(cfg, model, torch.from_numpy(toks[:, :P]))
    assert rel(cache["kr"], wcache["kr"]) <= TOL["float32"]
    want = forward_lm(cfg, model, torch.from_numpy(toks))[0][:, P]
    as_is = serve.grow_cache(cfg, cache, P + 1)
    got = decode_step(cfg, model, as_is, torch.from_numpy(toks[:, P]), P)[0]
    roped = serve.grow_cache(cfg, cache, P + 1)
    positions = torch.arange(P)[None, :]
    for l in range(cfg.n_layers):
        roped["kr"][l, :, :P] = common.rope(
            roped["kr"][l, :, :P, None, :], positions, cfg.rope_theta)[
                ..., 0, :]
    fixed = decode_step(cfg, model, roped, torch.from_numpy(toks[:, P]),
                        P)[0]
    assert rel(fixed, want) <= TOL["float32"] < rel(got, want)


def test_mla_outside_the_moe_family_is_refused():
    """The reference's dense cache has no latent leaves, so a dense
    config given an MLA rank is refused, not served half MLA."""
    cfg = dataclasses.replace(smoke_config("llama3_8b"), kv_lora_rank=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model_shapes(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zero_cache(cfg, B, 8, device="cpu")


def test_shard_map_moe_impl_raises():
    """``moe_impl="shard_map"`` off a mesh is ``moe_layer``, as the
    reference falls through when ``moe_ep.supported`` fails.  The GSPMD
    expert split on a ``model`` axis larger than 1, once refused, runs:
    with no tensor-parallel split of the step (``dist.spmd``'s), each
    rank runs the whole layer on its rows, bitwise ``moe_layer`` off the
    mesh (``tests/test_torch_tp_moe.py`` holds the split)."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    cfg, _, model, _ = both("grok1_314b", "float32", moe_impl="shard_map")
    toks = torch.from_numpy(tokens(cfg, 4))
    got = forward_lm(cfg, model, toks)
    want = forward_lm(dataclasses.replace(cfg, moe_impl="gspmd"), model,
                      toks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gcfg = dataclasses.replace(cfg, moe_impl="gspmd")
    with use_mesh(make_mesh((1, 2), ("data", "model"),
                            devices=["cpu"] * 2)):
        again = forward_lm(gcfg, model, toks)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])


def test_serve_arch_cli_runs_the_moe_family_on_the_cpu(capsys):
    gen = serve.main(["--arch", "deepseek_v2_lite", "--smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                      "5"])
    assert gen.shape == (2, 5)
    out = capsys.readouterr().out
    assert "prefill 16 toks x2" in out and "decode  4 steps x2" in out
    again = serve.main(["--arch", "grok1_314b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert again.shape == (2, 3)


def test_converter_takes_the_head_layers():
    cfg, rcfg = configs("deepseek_v2_lite", "float32")
    tree = reference_tree(rcfg)
    model = params_from_reference(cfg, tree, device="cpu")
    assert len(model.head_layers) == cfg.first_dense_layers
    assert len(model.layers) == cfg.n_layers - cfg.first_dense_layers
    assert torch.equal(model.head_layers[0]["w_dkv"], torch.from_numpy(
        np.array(tree["head_layers"]["w_dkv"][0])))
    del tree["head_layers"]
    with pytest.raises(ValueError, match="leaves"):
        params_from_reference(cfg, tree, device="cpu")
