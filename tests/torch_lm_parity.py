"""Shared helpers of the family parity tests (``test_torch_vlm.py``,
``test_torch_ssm.py``, ``test_torch_hybrid.py``, ``test_torch_encdec.py``):
both packages on the same parameters and inputs, on the CPU.

The reference's ``init_params`` tree goes to the port through
``models.convert.params_from_reference`` as numpy arrays.  The leaves the
reference initialises to constants are drawn at random from the seed, so
that their code paths are tested: norm gains (``*_g``) near 1, biases
(``b*``, ``*_b``) near 0, the SSD mixer's ``ssm_D_skip`` near 1,
``ssm_dt_bias`` near 0 and ``ssm_A_log`` spread around 0.  Inputs are
made from a seed with numpy.

Tolerances, norm-relative (``||got - want|| / ||want||``) on logits and
caches: 1e-4 with ``compute_dtype="float32"`` (the same arithmetic,
summed in another order), 2e-2 in bfloat16 (both round every matmul and
activation to bfloat16, the reference its RMSNorm products too where K4
rounds once), 5e-2 for the port's own decode against its forward in
bfloat16, the reference's bound (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.train import steps as ref_steps
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models import (cache_shapes, cast_params, decode_step,
                                forward_lm, init_params, model_shapes,
                                prefill)
from repro_torch.models.convert import params_from_reference
from repro_torch.models.forward import cache_dtype

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_VS_FORWARD = 5e-2
B = 2


def rel(got, want) -> float:
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32)
                   if not isinstance(want, np.ndarray) else want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def configs(arch, dtype, **replace):
    return (dataclasses.replace(smoke_config(arch), compute_dtype=dtype,
                                **replace),
            dataclasses.replace(ref_smoke_config(arch), compute_dtype=dtype,
                                **replace))


def _draw(rng, name, a):
    if name.endswith("_g") or name == "ssm_D_skip":
        return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    if name.startswith("b") or name.endswith("_b") or name == "ssm_dt_bias":
        return (0.02 * rng.standard_normal(a.shape)).astype(a.dtype)
    if name == "ssm_A_log":
        return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def reference_tree(rcfg, seed=0) -> dict:
    """The reference's parameters as numpy float32 arrays, its constant
    leaves drawn from ``seed``."""
    tree = jax.tree_util.tree_map(
        np.asarray, ref_models.init_params(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return {k: ({n: _draw(rng, n, a) for n, a in v.items()}
                if isinstance(v, dict) else _draw(rng, k, v))
            for k, v in tree.items()}


def both(arch, dtype, seed=0, **replace):
    """(port cfg, reference cfg, the port's cast model, the reference's
    tree) on the same numbers; ``replace``: fields changed on both
    sides."""
    cfg, rcfg = configs(arch, dtype, **replace)
    tree = reference_tree(rcfg, seed)
    model = params_from_reference(cfg, tree, device="cpu")
    return cfg, rcfg, cast_params(cfg, model), tree


def inputs(cfg, S, seed=0) -> dict:
    """Prompts (B, S) and, where the family takes them, patches or frames,
    drawn as ``serve --arch`` draws them: numpy arrays under
    ``prompts``, ``patches``, ``frames``."""
    return serve.draw_inputs(cfg, B, S, seed)


def extras(x: dict, lib: str) -> dict:
    """The keyword inputs (``patches``, ``frames``) of ``inputs``' dict
    for ``lib``: ``"ref"`` (jax arrays) or ``"port"`` (tensors)."""
    wrap = jnp.asarray if lib == "ref" else torch.from_numpy
    return {k: wrap(x[k]) for k in ("patches", "frames")
            if x.get(k) is not None}


def grow_ref(rcfg, cache, P, S):
    """The reference's ``serve --arch`` grow: every leaf whose axis 2 is P
    long padded to S, outside the hybrid family."""
    def grow(a):
        if a.ndim >= 3 and a.shape[2] == P and rcfg.family != "hybrid":
            pad = [(0, 0)] * a.ndim
            pad[2] = (0, S - P)
            return jnp.pad(a, pad)
        return a
    return jax.tree_util.tree_map(grow, cache)


# --------------------------------------------------------------------------
# the checks every family runs
# --------------------------------------------------------------------------

def check_shapes(arch, size):
    """Configs, model shapes, cache shapes and dtypes, and (at the smoke
    size) the port's parameters against the reference's."""
    get = smoke_config if size == "smoke" else get_config
    rget = ref_smoke_config if size == "smoke" else ref_get_config
    cfg, rcfg = get(arch), rget(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert model_shapes(cfg) == ref_models.model_shapes(rcfg)
    want = ref_models.abstract_cache(rcfg, B, 40)
    assert cache_shapes(cfg, B, 40) == {k: a.shape for k, a in want.items()}
    for k, a in want.items():
        assert str(cache_dtype(cfg, k)).split(".")[-1] == str(a.dtype), k
    if size == "smoke":
        model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        shapes = model_shapes(cfg)
        for stack in ("layers", "head_layers", "enc_layers"):
            lps, want = getattr(model, stack), shapes.get(stack, {})
            assert len(lps) == (next(iter(want.values()))[0] if want else 0)
            for lp in lps:
                assert {k: (len(lps),) + tuple(t.shape)
                        for k, t in lp.items()} == want
        for name, shape in shapes.items():
            if not isinstance(shape, dict):
                assert tuple(model[name].shape) == shape


def check_forward(arch, dtype, S):
    cfg, rcfg, model, tree = both(arch, dtype)
    x = inputs(cfg, S)
    want, _, _ = ref_models.forward_lm(rcfg, tree, jnp.asarray(x["prompts"]),
                                       **extras(x, "ref"))
    got, aux, _ = forward_lm(cfg, model, torch.from_numpy(x["prompts"]),
                             **extras(x, "port"))
    assert got.shape == (B, S, cfg.vocab) and aux == 0.0
    assert got.dtype == getattr(torch, dtype)
    assert rel(got, want) <= TOL[dtype]


def check_prefill(arch, dtype, P, **replace):
    """Prefill's logits and every cache leaf (shape, dtype, values);
    returns the two caches."""
    cfg, rcfg, model, tree = both(arch, dtype, **replace)
    x = inputs(cfg, P)
    want, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(x["prompts"]),
                                      **extras(x, "ref"))
    got, cache = prefill(cfg, model, torch.from_numpy(x["prompts"]),
                         **extras(x, "port"))
    assert got.shape == (B, cfg.vocab)
    assert rel(got, want) <= TOL[dtype]
    assert set(cache) == set(wcache)
    for k in cache:
        assert tuple(cache[k].shape) == wcache[k].shape, k
        assert str(cache[k].dtype).split(".")[-1] == str(wcache[k].dtype), k
        assert rel(cache[k], wcache[k]) <= TOL[dtype], k
    return cache, wcache


def check_decode(arch, dtype, P, steps, **replace):
    """``steps`` decode steps after a prefill of P, fed the same tokens on
    both sides: every step's logits and the final cache."""
    cfg, rcfg, model, tree = both(arch, dtype, **replace)
    x = inputs(cfg, P + steps)
    toks = x["prompts"]
    _, wcache = ref_models.prefill(rcfg, tree, jnp.asarray(toks[:, :P]),
                                   **extras(x, "ref"))
    wcache = grow_ref(rcfg, wcache, P, P + steps)
    _, cache = prefill(cfg, model, torch.from_numpy(toks[:, :P]),
                       **extras(x, "port"))
    cache = serve.grow_cache(cfg, cache, P + steps)
    ref_step = jax.jit(ref_models.decode_step, static_argnums=0)
    for i in range(steps):
        want, wcache = ref_step(rcfg, tree, wcache,
                                jnp.asarray(toks[:, P + i]), P + i)
        got, cache = decode_step(cfg, model, cache,
                                 torch.from_numpy(toks[:, P + i]), P + i)
        assert rel(got, want) <= TOL[dtype], i
    for k in cache:
        assert rel(cache[k], wcache[k]) <= TOL[dtype], k


def check_greedy(arch, P=24, G=8):
    """``launch.serve.generate`` against the reference's ``--arch`` loop
    (prefill with the same patches or frames, the cache grown by the
    reference's rule, ``make_decode_step`` jitted), float32: the same
    greedy tokens."""
    cfg, rcfg, model, tree = both(arch, "float32")
    x = inputs(cfg, P, seed=3)
    batch = {"tokens": jnp.asarray(x["prompts"]), **extras(x, "ref")}
    logits, wcache = ref_steps.make_prefill_step(rcfg)(tree, batch)
    wcache = grow_ref(rcfg, wcache, P, P + G)
    step = jax.jit(ref_steps.make_decode_step(rcfg))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = [tok]
    for i in range(G - 1):
        tok, _, wcache = step(tree, wcache, tok, jnp.int32(P + i))
        want.append(tok)
    want = np.stack([np.asarray(t) for t in want], axis=1)
    res = serve.generate(cfg, model, x["prompts"], G, patches=x["patches"],
                         frames=x["frames"])
    assert res["tokens"].shape == (B, G) and res["tokens"].dtype == np.int32
    np.testing.assert_array_equal(res["tokens"], want)
    assert len(res["step_ms"]) == G - 1


def check_decode_vs_forward(arch, P=24, steps=1):
    """The reference's serving invariant on the port alone, bfloat16:
    prefill(P) and ``steps`` decode steps against the forward over P +
    steps tokens (the same patches or frames) at each step's position."""
    cfg = smoke_config(arch)
    assert cfg.compute_dtype == "bfloat16"
    model = cast_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(1), "cpu"))
    x = inputs(cfg, P + steps, seed=1)
    toks = torch.from_numpy(x["prompts"])
    want = forward_lm(cfg, model, toks, **extras(x, "port"))[0]
    _, cache = prefill(cfg, model, toks[:, :P], **extras(x, "port"))
    cache = serve.grow_cache(cfg, cache, P + steps)
    for i in range(steps):
        got, _ = decode_step(cfg, model, cache, toks[:, P + i], P + i)
        assert rel(got, want[:, P + i].float().numpy()) \
            <= DECODE_VS_FORWARD, i


def check_serve_cli(arch, capsys):
    """``serve --arch <arch> --smoke --device cpu``: the reference's three
    lines; the same seed draws the same model, inputs and tokens."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "24", "--gen", "5"]
    gen = serve.main(argv)
    assert gen.shape == (2, 5)
    out = capsys.readouterr().out
    assert "prefill 24 toks x2" in out and "decode  4 steps x2" in out
    assert "sample generation (first sequence):" in out
    np.testing.assert_array_equal(gen, serve.main(argv))
