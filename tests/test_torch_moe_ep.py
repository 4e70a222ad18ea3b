"""The port's expert-parallel MoE (``dist.moe_ep``) against its own
``moe_layer`` and the reference's ``moe_layer_ep``, on the CPU; and the
repair of ``moe_impl="shard_map"`` off a mesh.

The layer runs on 4 gloo ranks of a (1, 4) mesh (``dist.spmd.run_ranks``
in ``tmp_path``, what they run in ``torch_spmd_ranks.py``), on the EP
path (4 experts, 1 a rank) and the replica path (2 experts, each on 2
ranks), with the experts given whole and, on the EP path, as each
rank's own.  The reference's ``moe_layer_ep`` runs on its explicit
(2, 4) mesh in a subprocess with 8 forced host devices (its ambient-mesh
test fails on this jax, ``ROADMAP.md`` §3).  The inputs are the
reference test's (``tests/test_dist.py``).

Tolerances: y and the load-balance term 1e-5 norm-relative to the port's
``moe_layer`` (the same math group by group; the expert matmuls run on
other batch shapes), 1e-4 to the reference's; the gradients of
sum(y²) + aux 1e-4 to the unsharded layer's.  ``shard_map`` off a mesh is
``moe_layer``: bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_spmd_ranks as ranks
from repro_torch.dist import moe_ep
from repro_torch.dist.sharding import use_mesh
from repro_torch.dist.spmd import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import forward_lm, lm_loss
from repro_torch.models.convert import params_from_reference
from repro_torch.models.forward import cast_params
from torch_lm_parity import configs, reference_tree
from torch_threads import capped_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"ep": (4, 2), "replica": (2, 1)}

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs import smoke_config
from repro.launch.mesh import make_mesh
from repro.dist import moe_ep

src, dst = sys.argv[1], sys.argv[2]
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for tag, (E, k) in json.loads(sys.argv[3]).items():
    a = np.load(f"{src}/{tag}.npz")
    cfg = dataclasses.replace(smoke_config("grok1_314b"), n_experts=E,
                              topk=k, capacity_factor=4.0,
                              n_shared_experts=0)
    x = jnp.asarray(a["x"])
    p = {n: jnp.asarray(a[n]) for n in ("router", "wg", "wu", "wd")}

    def f(x, p):
        y, aux = moe_ep.moe_layer_ep(cfg, x, p, mesh=mesh)
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (y, aux)), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                  has_aux=True))(x, p)
    np.savez(f"{dst}/{tag}.npz", y=np.asarray(y), aux=np.asarray(aux),
             gx=np.asarray(g[0]), **{"g" + n: np.asarray(v)
                                     for n, v in g[1].items()})
print("ok")
"""


def rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    for tag, (E, k) in CASES.items():
        _, x, p = ranks.moe_inputs(E, k)
        np.savez(d / f"{tag}.npz", x=x, **p)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(d),
                            str(d), json.dumps(CASES)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        port = run_ranks(ranks.moe_ep_ranks, 4, CASES, timeout_s=120,
                         tmpdir=str(d))
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    refs = {tag: dict(np.load(d / f"{tag}.npz")) for tag in CASES}
    return port, refs


@pytest.mark.parametrize("tag", list(CASES))
def test_moe_layer_ep_matches_moe_layer_and_the_reference(layer_runs, tag):
    port, refs = layer_runs
    E, k = CASES[tag]
    y1, aux1, g1 = ranks.unsharded_moe(E, k)
    ref = refs[tag]
    runs = [tag] + ([tag + "_local"] if E % 4 == 0 else [])
    for r, out in enumerate(port):
        for run in runs:
            y, aux, g = out[run]
            assert rel(y, y1) <= 1e-5 and abs(aux - aux1) <= 1e-5 * aux1
            assert rel(y, ref["y"]) <= 1e-4
            assert abs(aux - float(ref["aux"])) <= 1e-4 * abs(aux1)
            assert rel(g["x"], g1["x"]) <= 1e-4
            assert rel(g["x"], ref["gx"]) <= 1e-4
            assert rel(g["router"], g1["router"]) <= 1e-4
            for n in ("wg", "wu", "wd"):
                if run.endswith("_local"):
                    El = E // 4   # this rank's experts only
                    want = g1[n][r * El:(r + 1) * El]
                else:
                    want = g1[n]
                    assert rel(g[n], ref["g" + n]) <= 1e-4, n
                assert rel(g[n], want) <= 1e-4, (run, n)
                assert np.abs(g[n]).max() > 0, (run, n)
        # every model rank holds the same replicated output
        np.testing.assert_array_equal(out[tag][0], port[0][tag][0])


def test_supported_and_the_refusal_off_a_mesh():
    cfg = dataclasses.replace(ranks.config("grok1_314b"), n_experts=4)
    assert not moe_ep.supported(cfg)                   # no ambient mesh
    with pytest.raises(ValueError, match="supported"):
        moe_ep.moe_layer_ep(cfg, torch.zeros(1, 8, cfg.d_model), {})
    for (data, model), E, want in [((2, 4), 4, True), ((1, 4), 2, True),
                                   ((2, 4), 8, True), ((4, 2), 3, False),
                                   ((8, 1), 4, False), ((1, 4), 6, False)]:
        mesh = make_mesh((data, model), ("data", "model"),
                         devices=["cpu"] * (data * model))
        c = dataclasses.replace(cfg, n_experts=E)
        assert moe_ep.supported(c, mesh) is want
        with use_mesh(mesh):
            assert moe_ep.supported(c) is want
    assert not moe_ep.supported(ranks.config("llama3_8b"), mesh)


def test_shard_map_off_a_mesh_is_gspmd_bitwise():
    """The repaired fault: ``moe_impl="shard_map"`` without a mesh runs
    ``moe_layer``, as the reference falls through when
    ``moe_ep.supported`` fails: the forward, the loss and its gradients
    bitwise those of ``moe_impl="gspmd"``."""
    cfg, rcfg = configs("deepseek_v2_lite", "float32", moe_impl="shard_map")
    tree = reference_tree(rcfg)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16),
                                           dtype=np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    out = {}
    for impl in ("shard_map", "gspmd"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        model = cast_params(c, params_from_reference(c, tree, "cpu"))
        logits, aux, _ = forward_lm(c, model, tokens)
        train = model.map(lambda t: t.clone(), requires_grad=True)
        loss, _ = lm_loss(c, train, batch)
        loss.backward()
        out[impl] = (logits, aux, loss.detach(),
                     {n: p.grad for n, p in train.named_parameters()})
    a, b = out["shard_map"], out["gspmd"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])
    for n in a[3]:
        assert torch.equal(a[3][n], b[3][n]), n
