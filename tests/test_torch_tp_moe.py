"""The port's tensor-parallel training of the MoE family (DeepSeek-V2-Lite
with MLA, Grok-1 with GQA) against the JAX reference on the CPU: the
sharded train step with the forward split over the ``model`` ranks
(heads, the dense layer's and the shared experts' columns, the experts
or their hidden columns, the vocabulary; the residual stream cut along
the sequence), under ``moe_impl="gspmd"`` (expert parallelism where the
axis divides the experts, the F-split where it does not) and
``"shard_map"``; each rank's masters and moments as the reference's
spec cuts them; the launcher's refusals.

No process group is started in the pytest process: the ranks run in
processes of their own (``dist.spmd.run_ranks``, one thread a rank, a
timeout), what they run in ``torch_tp_moe_ranks.py``, which imports no
JAX; every rank case shares one group of 4 (``suite``), which runs the
cases on 4 ranks, then the cases on 2 in two groups of 2, then the step
on one rank.

Tolerances (``test_torch_tp.py``'s and ``test_torch_spmd.py``'s, the
reasons there): the sharded steps, float32, against the reference's
unsharded step: losses and ``grad_norm`` 1e-5 relative at every step;
masters 1e-4 norm-relative (or twice the port's own unsharded step's
distance where that is more), and 1e-4 against the port's unsharded
step on the same inputs; float32 moments 1e-4; int8 moments: q within
one step, dequantized within one level and their blocks' scales'
difference.  With int8 moments the masters are held step by step to
the port's unsharded step from the same state (1e-4), not after three
steps to the reference's: a gradient that differs in its last bits
(5e-7 here, the sums over the ranks in another order) flips an int8
level now and then, and the step after it moves that element by the
learning rate times one level over its ``sqrt(v)``: on Grok-1's
(1, 2) run one element of ``layers.1.wq`` by 1.8e-4, the leaf 1.5e-4
norm-relative, from the reference and from the port's own unsharded
run alike.  The first step's gradients, summed over the ranks, within
1e-5 of the unsharded step's, leaf by leaf.  On one rank the step is
bitwise the unsharded step.  A checkpoint restores bitwise on another
mesh.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_spmd_ranks as spmd_ranks
import torch_tp_moe_ranks as ranks
from repro import models as ref_models
from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_sharding
from repro.train import steps as ref_steps
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.dist.spmd import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import train_state_from_reference
from repro_torch.train import steps
from test_torch_spmd import (_ref_specs, _ref_state, check_metrics,
                             check_state, rel)
from torch_lm_parity import reference_tree
from torch_threads import capped_torch_threads  # noqa: F401


def _key(case):
    """The reference run a case is held to: its arch, moments and the
    overrides that change the unsharded step (``moe_impl`` and
    ``fsdp_only`` do not)."""
    arch, _, moments, over = case
    over = {k: v for k, v in over.items()
            if k not in ("moe_impl", "fsdp_only")}
    return arch, moments, tuple(sorted(over.items()))


def _ref_run(arch, moments, over):
    """The reference's unsharded float32 step, three times: (initial state
    as numpy, metrics, final state)."""
    rcfg = dataclasses.replace(ref_smoke_config(arch),
                               compute_dtype="float32",
                               opt_moment_dtype=moments, **dict(over))
    st = _ref_state(rcfg, reference_tree(rcfg))
    init = jax.tree_util.tree_map(np.asarray, st)
    step = jax.jit(ref_steps.make_train_step(
        rcfg, ref_optim.AdamWHyper(**ranks.HYPER)))
    get = spmd_ranks.make_batch_fn(
        ranks.config(arch, moments, dict(over)),
        ShapeConfig("t", ranks.S, ranks.B, "train"))
    metrics = []
    for i in range(ranks.STEPS):
        st, m = step(st, {k: jnp.asarray(v) for k, v in get(i).items()})
        metrics.append({k: float(m[k]) for k in
                        ("loss", "xent", "lr", "grad_norm")})
    return init, metrics, jax.tree_util.tree_map(np.asarray, st)


@pytest.fixture(scope="module")
def reference():
    runs = {}
    for case in ranks.CASES.values():
        if _key(case) not in runs:
            runs[_key(case)] = _ref_run(*_key(case))
    return {name: runs[_key(case)] for name, case in ranks.CASES.items()}


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's own unsharded step from the same states, three times:
    its state by checkpoint key."""
    from repro_torch.ckpt.checkpoint import _flatten
    out, runs = {}, {}
    for name, case in ranks.CASES.items():
        if _key(case) not in runs:
            arch, _, moments, over = case
            cfg = ranks.config(arch, moments, over)
            state = train_state_from_reference(cfg, reference[name][0],
                                               "cpu")
            step = steps.make_train_step(cfg, spmd_ranks.AdamWHyper(
                **ranks.HYPER))
            get = spmd_ranks.make_batch_fn(
                cfg, ShapeConfig("t", ranks.S, ranks.B, "train"))
            for i in range(ranks.STEPS):
                state, _ = step(state, spmd_ranks.shard_batch(get(i), "cpu"))
            runs[_key(case)] = {k: spmd_ranks._np(t)
                                for k, t in _flatten(state)}
        out[name] = runs[_key(case)]
    return out


@pytest.fixture(scope="module")
def suite(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_moe")
    inits = {name: r[0] for name, r in reference.items()}
    return run_ranks(ranks.tp_moe_suite, 4, inits, str(d), timeout_s=300,
                     tmpdir=str(d))


def _ranks_of(case):
    """The suite's ranks that ran a case, in the rank order of its
    group."""
    (dpn, mp) = ranks.CASES[case][1]
    if dpn * mp == 4:
        return [0, 1, 2, 3]
    pair = next(i for i, names in enumerate(ranks.PAIRS) if case in names)
    return [2 * pair, 2 * pair + 1]


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_moe_tp_steps_match_the_reference(suite, reference, unsharded,
                                          case):
    """Three float32 steps with the forward split over ``model`` against
    the reference's unsharded step and the port's (module docstring):
    DeepSeek-V2-Lite's MLA and 4 experts on (1, 4), (2, 2) and (1, 2),
    6 experts on (1, 4) (each rank a block of every expert's columns),
    Grok-1's GQA heads with int8 moments on (1, 2),
    ``moe_impl="shard_map"`` with the attention split on (1, 2); and
    with tensor parallelism off, the rows over ``model`` (``gspmd``) and
    ``shard_map``'s experts over it, each rank computing the rest whole,
    their masters and moments on the spec's ``model`` dims all the
    same."""
    _, want_metrics, want_state = reference[case]
    out = [suite[r]["cases"][case] for r in _ranks_of(case)]
    dpn, mp = ranks.CASES[case][1]
    assert out[0]["mesh"] == {"data": dpn, "model": mp}
    assert [o["tensor_parallel"] for o in out] == [
        None if case in ranks.NO_TP else (mp, r % mp)
        for r in range(dpn * mp)]
    check_metrics([o["metrics"] for o in out], want_metrics)
    if ranks.CASES[case][2] != "int8":
        check_state(out[0]["state"], want_state, unsharded[case], False,
                    near_one=True)
        return
    # int8: the moments after three steps against the reference's; the
    # masters step by step against the port's unsharded step from the
    # same state (module docstring)
    check_state({k: v for k, v in out[0]["state"].items()
                 if not k.startswith("params")}, want_state,
                unsharded[case], True)
    assert len(out[0]["forced"]) == ranks.STEPS
    for got, one in out[0]["forced"]:
        assert got.keys() == one.keys()
        for key, a in got.items():
            if key.startswith("params"):
                assert rel(a, one[key]) <= 1e-4, key
            elif key.endswith("/q"):
                assert np.abs(a.astype(int) - one[key].astype(int)).max() \
                    <= 1, key


@pytest.mark.parametrize("case", ranks.GRADS)
def test_moe_tp_gradients_match_the_unsharded_step_leaf_by_leaf(suite,
                                                                case):
    """The first step's float32 gradients, summed over the ranks, against
    the unsharded step's from the same state, every leaf within 1e-5
    norm-relative: each leaf's partial gradients counted once over
    ``model`` (the router's and the load-balance term's too, which every
    rank computes whole; AdamW's update would not see a leaf's gradient
    counted twice)."""
    r = _ranks_of(case)[0]
    errs = suite[r]["grads"][case]
    assert errs and max(errs.values()) <= 1e-5, errs


def _flat_shapes(tree) -> dict:
    """{path: shape} of a reference tree of ``ShapeDtypeStruct``s."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            tuple(leaf.shape) for path, leaf in flat}


def _spec_pieces(rcfg, mesh_shape) -> dict:
    """The bytes of one rank's piece of every leaf of ``rcfg``'s masters
    and moments under the reference's specs on a (data, model) mesh of
    ``mesh_shape``, by the port's checkpoint key (a stacked leaf's
    pieces a layer: its layer entry dropped)."""
    amesh = AbstractMesh(mesh_shape, ("data", "model"))
    aps = ref_models.abstract_params(rcfg)
    opt = ref_optim.abstract_opt_state(rcfg, aps)
    sizes = dict(zip(("data", "model"), mesh_shape))
    out = {}
    for tree, specs, shapes in (
            ("params", ref_sharding.param_pspecs(rcfg, aps, amesh), aps),
            ("opt", ref_sharding.opt_pspecs(rcfg, opt, amesh, aps), opt)):
        shapes = _flat_shapes(shapes)
        for path, spec in _ref_specs(specs).items():
            if path == "step":
                continue
            parts = path.split("/")
            at = 1 if tree == "opt" else 0          # the leaf's name
            stacked = parts[at] in ("layers", "head_layers")
            item = 1 if parts[-1] == "q" else 4
            shape = shapes[path]
            if stacked:
                spec, shape, L = spec[1:], shape[1:], shapes[path][0]
            cut = math.prod(sizes[a] for e in spec if e
                            for a in ((e,) if isinstance(e, str) else e))
            n = math.prod(shape) // cut * item
            if not stacked:
                out[f"{tree}/{path}"] = n
                continue
            for layer in range(L):
                name = f"{parts[at]}.{layer}.{parts[at + 1]}"
                key = parts[:at] + [name] + parts[at + 2:]
                out[f"{tree}/" + "/".join(key)] = n
    return out


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_each_rank_holds_the_spec_pieces(suite, case):
    """Each rank's masters and moments, leaf by leaf, hold the bytes of
    the reference's spec's piece (the leaves that are not experts cut
    over the data-parallel ranks and ``model`` as the spec says, the
    experts over ``model`` along E, or along F for the F-split); the
    non-expert leaves on the spec's own dims."""
    arch, mesh_shape, moments, over = ranks.CASES[case]
    cfg = ranks.config(arch, moments, over)
    want = _spec_pieces(dataclasses.replace(
        ref_smoke_config(arch), opt_moment_dtype=moments, **over),
        mesh_shape)
    for r in _ranks_of(case):
        pieces = suite[r]["cases"][case]["pieces"]
        assert pieces.keys() == want.keys()
        for key, (shape, dp_dim, model_dim, nbytes) in pieces.items():
            assert nbytes == want[key], key
            name = key.split("/")[2 if key.startswith("opt/") else 1]
            leaf = name.split(".")
            if key.endswith(("/q", "/scale")) or not (
                    leaf[0] == "layers" and leaf[2] in ("wg", "wu", "wd")):
                continue
            # an expert leaf a step splits: along E where the axis divides
            # the experts, along F for the F-split; the spec's dim where
            # each rank computes with it whole (rows over ``model``)
            if case == "deepseek_rows_1x2":
                continue
            along_e = cfg.n_experts % mesh_shape[1] == 0
            assert model_dim == (0 if along_e else
                                 {"wg": 2, "wu": 2, "wd": 1}[leaf[2]]), key


def test_one_rank_is_bitwise_the_unsharded_step(suite):
    """On a (1, 1) mesh, tensor parallelism on, DeepSeek's sharded step
    is the unsharded step bit for bit: losses, gradient norms and every
    leaf."""
    one = suite[0]["one"]
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["metrics_equal"] and one["differ"] == []
    assert one["leaves"] > 0


def test_checkpoint_of_a_moe_tp_state_restores_on_another_mesh(suite):
    """DeepSeek's state after three steps on (2, 2), its non-expert leaves
    cut over ``model`` too, saved and restored on (1, 4): bitwise."""
    res = suite[0]["restored"]
    assert res["at"] == ranks.STEPS and res["mesh"] == {"data": 1,
                                                        "model": 4}
    saved = suite[0]["cases"][ranks.SAVED]["state"]
    assert res["state"].keys() == saved.keys()
    for k, a in saved.items():
        np.testing.assert_array_equal(res["state"][k], a, err_msg=k)


def test_deepseek_bytes_a_rank_on_the_production_mesh():
    """DeepSeek-V2-Lite at full size (float32 masters and moments) on the
    16 × 16 mesh: one rank's pieces of ``train.steps.state_shardings``
    (no process group: the shapes alone) hold the bytes of the
    reference's spec's pieces, 1/256 of nearly every leaf.  The figures
    CHANGES.md quotes: 736,320,000 bytes of masters and moments a rank,
    61,561,344 of them for the leaves that are not experts (1.31 × 10⁹
    parameters, whose masters, bf16 copy and moments took 1.148 GB a
    rank while they lay whole over ``model``), and 163,952,384 bytes of
    their bf16 compute copy, whole over ``model``, cut over ``data``."""
    cfg = get_config("deepseek_v2_lite")
    mesh = mesh_lib.make_mesh((16, 16), ("data", "model"),
                              devices=["cpu"] * 256)
    spmd = types.SimpleNamespace(source=mesh, dpn=16, mp=16,
                                 model_group=None, model_rank=0)
    tree = steps.state_shardings(cfg, spmd).tree

    def held(part, names=None, itemsize=4):
        return itemsize * sum(math.prod(lay.local_shape(spmd))
                              for n, lay in part.items()
                              if names is None or n in names)
    parts = (tree["params"], tree["opt"]["m"], tree["opt"]["v"])
    got = sum(held(p) for p in parts)
    want = _spec_pieces(ref_get_config("deepseek_v2_lite"), (16, 16))
    assert got == sum(want.values()) == 736_320_000
    dense = {n for n in tree["params"] if not steps._EXPERT.match(n)}
    assert sum(held(p, dense) for p in parts) == 61_561_344
    assert held(tree["params_c"], dense, 2) == 163_952_384


@pytest.mark.parametrize("argv,match", [
    (["--arch", "deepseek_v2_lite", "--model-parallel", "32"],
     r"deepseek_v2_lite: n_heads = 16 does not split .* of 32.*later"),
    (["--arch", "grok1_314b", "--model-parallel", "16"],
     r"grok1_314b: n_kv_heads = 8 does not split .* of 16.*later")])
def test_moe_serving_on_model_parallel_is_still_refused(argv, match):
    """``serve --arch --model-parallel`` serves the MoE family, but still
    refuses, before any rank starts, the splits a later tensor-parallel
    slice brings: DeepSeek-V2-Lite's 16 heads over 32 ranks, and
    Grok-1's 8 KV heads over 16 (each rank's decode cache would hold
    every KV head)."""
    with pytest.raises(ValueError, match=match):
        serve_launcher.main(argv + ["--device", "cpu", "--nproc", "2"])


@pytest.mark.parametrize("n_experts,mp", [(4, 2), (4, 4), (6, 4)])
def test_serving_blocks_are_the_training_layers_cuts(n_experts, mp):
    """Each serving rank's block of every MoE and MLA leaf
    (``dist.sharding.param_block``) is the slice the tensor-parallel
    training layers cut from the whole weight: on DeepSeek's smoke
    shapes in float32
    (MLA, a dense first layer, shared experts; 4 experts over 2 and 4
    ranks, expert parallelism, 6 over 4, the F-split), ``mla_attention``,
    ``moe_layer`` and ``mlp`` on ``head_layers`` give rank by rank the
    same partial sums from the rank's blocks (``TensorParallel.blocks``)
    as from the whole weights they cut themselves, and the ranks' sums
    are the unsplit layer's; the blocks' shapes are those cuts'."""
    from repro_torch.dist.sharding import param_block, take_block
    from repro_torch.dist.spmd import TensorParallel
    from repro_torch.models import common, model as mm
    from repro_torch.models import init_params
    cfg = ranks.config("deepseek_v2_lite",
                       overrides={"n_experts": n_experts})
    gen = torch.Generator().manual_seed(0)
    lm = init_params(cfg, gen, "cpu")
    dense, moe = dict(lm.head_layers[0].items()), dict(lm.layers[0].items())
    x = torch.randn(2, 8, cfg.d_model, generator=gen)  # 2 groups of 8

    def mlp_of(p, tp):
        return common.mlp(cfg, x, p["wg"], p["wu"], p["wd"], tp)

    def attention_of(p, tp):
        return mm.mla_attention(cfg, x, p, tp)[0]

    def moe_of(p, tp):
        return common.moe_layer(cfg, x, p, tp)[0]

    E, F = n_experts, cfg.d_ff_moe
    for layer, fn in ((dense, mlp_of), (dense, attention_of),
                      (moe, moe_of)):
        whole = fn(layer, None)
        total = torch.zeros_like(whole)
        for r in range(mp):
            train, serve = (TensorParallel(None, mp, r, blocks=b)
                            for b in (False, True))
            blocks = {k: take_block(t, param_block(cfg, k, t.shape, serve))
                      for k, t in layer.items()}
            got, want = fn(blocks, serve), fn(layer, train)
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
            total += got
            if layer is moe:
                e0, e1 = serve.block(E)
                f0, f1 = serve.block(F)
                want_wg = (layer["wg"][e0:e1] if E % mp == 0
                           else layer["wg"][..., f0:f1])
                want_wd = (layer["wd"][e0:e1] if E % mp == 0
                           else layer["wd"][:, f0:f1])
                assert torch.equal(blocks["wg"], want_wg)
                assert torch.equal(blocks["wd"], want_wd)
                for k in ("router", "ln1_g", "w_dkv", "w_kr"):
                    assert blocks[k] is layer[k], k
                fs = F * cfg.n_shared_experts
                s0, s1 = serve.block(fs)
                assert torch.equal(blocks["wd_s"], layer["wd_s"][s0:s1])
            else:
                h0, h1 = serve.block(cfg.n_heads)
                nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
                assert torch.equal(blocks["wq"], layer["wq"][
                    :, h0 * (nd + rd):h1 * (nd + rd)])
                assert torch.equal(blocks["wo"], layer["wo"][
                    h0 * cfg.v_head_dim:h1 * cfg.v_head_dim])
                c0, c1 = serve.block(cfg.d_ff)
                assert torch.equal(blocks["wg"], layer["wg"][:, c0:c1])
        torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-6)


def test_costmodel_counts_mla_latent_whole_on_every_rank():
    """``costmodel.tp_decode`` for DeepSeek-V2-Lite at B 8, 48 cached
    positions: every rank reads the whole latent cache, L · rows ·
    kv_len · (kv_lora_rank + qk_rope_dim) bf16 elements, on one card as
    on 2 ranks; a rank's weights are ``rank_param_bytes``'s; 2
    collectives a layer and the vocabulary's gather."""
    from repro_torch.dist.sharding import rank_param_bytes
    from repro_torch.dist.spmd import TensorParallel
    from repro_torch.launch.costmodel import tp_decode
    cfg = get_config("deepseek_v2_lite")
    one, two = tp_decode(cfg, 8, 48, 1), tp_decode(cfg, 8, 48, 2)
    assert one["cache_bytes"] == two["cache_bytes"] \
        == 27 * 8 * 48 * (512 + 64) * 2
    assert two["held_weight_bytes"] == rank_param_bytes(
        cfg, TensorParallel(None, 2, 0), 2) < one["held_weight_bytes"]
    assert two["collectives"] == 2 * 27 + 1


@pytest.mark.parametrize("flags,match", [
    (["--arch", "grok1_314b", "--model-parallel", "32"],
     r"grok1_314b: n_heads = 48 does not split .* of 32.*later"),
    (["--arch", "deepseek_v2_lite", "--model-parallel", "32"],
     r"deepseek_v2_lite: n_heads = 16 does not split .* of 32.*later"),
    (["--arch", "hymba_1p5b", "--smoke", "--model-parallel", "2"],
     r"hybrid family comes with a later tensor-parallel slice"),
    (["--arch", "whisper_medium", "--smoke", "--model-parallel", "2"],
     r"encdec family comes with a later tensor-parallel slice")])
def test_launcher_still_refuses_what_a_later_tp_slice_brings(flags, match):
    """Before any rank starts: head and column counts the ``model`` axis
    does not divide, and the hybrid and encoder-decoder families under
    tensor parallelism (the ssm family: ``test_torch_tp.py``)."""
    with pytest.raises(ValueError, match=match):
        train_launcher.main(flags + ["--device", "cpu", "--steps", "1",
                                     "--nproc", "4"])


def test_tensor_parallel_split_names_the_moe_dimensions():
    """The MoE dims a split needs: the shared experts' columns, and
    ``d_ff_moe`` where the axis does not divide the experts (the
    F-split; ``moe_impl="shard_map"``'s replica path needs neither); the
    full configs' splits that divide pass, in serving too, which refuses
    ``moe_impl="shard_map"``."""
    base = ranks.config("deepseek_v2_lite", overrides=ranks.MOE)
    with pytest.raises(ValueError, match=r"d_ff = 150 does not split"):
        steps.tensor_parallel_split(dataclasses.replace(base, d_ff=150), 4)
    with pytest.raises(ValueError, match=r"d_ff_moe · n_shared_experts = 34"):
        steps.tensor_parallel_split(dataclasses.replace(base, d_ff_moe=34),
                                    4)
    six = dataclasses.replace(base, n_experts=6, d_ff_moe=34,
                              n_shared_experts=0)
    with pytest.raises(ValueError, match=r"d_ff_moe = 34 does not split"):
        steps.tensor_parallel_split(six, 4)
    steps.tensor_parallel_split(dataclasses.replace(six, d_ff_moe=36), 4)
    steps.tensor_parallel_split(dataclasses.replace(
        six, n_experts=2, moe_impl="shard_map"), 4)
    steps.tensor_parallel_split(get_config("deepseek_v2_lite"), 16)
    steps.tensor_parallel_split(get_config("grok1_314b"), 16)
    steps.tensor_parallel_split(get_config("deepseek_v2_lite"), 16,
                                serving=True)
    with pytest.raises(NotImplementedError, match=r"moe_impl='shard_map'"):
        steps.tensor_parallel_split(dataclasses.replace(
            base, moe_impl="shard_map"), 2, serving=True)
