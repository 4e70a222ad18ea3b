"""The port's tensor-parallel serving of the dense, vlm, MoE, ssm and
encdec families (``serve --arch --model-parallel``) against the JAX
reference on the CPU: each rank holds its blocks of the weights (heads,
MLP columns, experts or their hidden columns, SSD heads, vocabulary) and
of the decode cache (its KV heads, Whisper's cross K/V too; MLA's latent
whole; its SSD heads' state), the decode step's row-split outputs are
summed over ``model`` in float32, and the logits come back whole.

No process group is started in the pytest process: the ranks run in
processes of their own (``dist.spmd.run_ranks``, one thread a rank, a
timeout), what they run in ``torch_tp_serve_ranks.py``, which imports no
JAX; every rank case shares one group of 4 (``suite``), which runs the
cases on 4 ranks, then the cases on 2 in two groups of 2.

Each case is float32 at the smoke size (DeepSeek-V2-Lite's with 4
experts on (1, 2) and (1, 4), expert parallelism, and with 6 on (1, 4),
the F-split; Grok-1's GQA 4/2 with 4 experts on (1, 2); Mamba-2's 8 SSD
heads and Whisper's 4 heads over 30 frames on (1, 2) and (1, 4)), B 2, a
prompt of 24 (the smoke vlm's 16 patches first), 8 greedy tokens,
against the reference's
prefill and its jitted ``make_decode_step`` on one CPU device (as
``torch_lm_parity.check_greedy``): the greedy tokens equal; the
prefill's logits and every step's, teacher-forced on the reference's
tokens, within 1e-4 norm-relative (``TOL["float32"]``: the ranks'
partial sums add in another order); each rank's cache leaves, shaped
as ``cache_pspecs`` gives them, within 1e-4 of the unsharded port's
cache at the rank's heads and rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_serve_ranks as ranks
from repro.configs import smoke_config as ref_smoke_config
from repro.train import steps as ref_steps
from repro_torch.dist.sharding import cache_pspecs, rank_param_bytes
from repro_torch.dist.spmd import TensorParallel, run_ranks
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cast_params, model_shapes, zero_cache
from repro_torch.models.convert import params_from_reference
from torch_lm_parity import TOL, grow_ref, reference_tree
from torch_threads import capped_torch_threads  # noqa: F401

MODELS = sorted({ranks.model_of(c) for c in ranks.CASES.values()})


def _ref_run(model):
    """The reference's tree (numpy), its greedy tokens (B, G), and the
    prefill's and each step's logits (G, B, V), float32, for ``model``
    (``ranks.model_of``)."""
    arch, over = model
    rcfg = dataclasses.replace(ref_smoke_config(arch),
                               compute_dtype="float32", **dict(over))
    tree = reference_tree(rcfg)
    x = ranks.inputs(ranks.config(*model))
    batch = {"tokens": jnp.asarray(x["prompts"])}
    for name in ("patches", "frames"):
        if x[name] is not None:
            batch[name] = jnp.asarray(x[name])
    logits, cache = ref_steps.make_prefill_step(rcfg)(tree, batch)
    cache = grow_ref(rcfg, cache, ranks.P, ranks.P + ranks.G)
    step = jax.jit(ref_steps.make_decode_step(rcfg))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, out = [tok], [logits]
    for i in range(ranks.G - 1):
        tok, logits, cache = step(tree, cache, tok,
                                  jnp.int32(ranks.P + i))
        toks.append(tok)
        out.append(logits)
    return (tree, np.stack([np.asarray(t) for t in toks], axis=1),
            np.stack([np.asarray(a) for a in out]))


@pytest.fixture(scope="module")
def reference():
    return {model: _ref_run(model) for model in MODELS}


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port on one device, the same model and inputs: its tokens and
    its cache after ``generate``."""
    out = {}
    for m in MODELS:
        cfg = ranks.config(*m)
        model = cast_params(cfg, params_from_reference(
            cfg, reference[m][0], "cpu"))
        x = ranks.inputs(cfg)
        res = serve.generate(cfg, model, x["prompts"], ranks.G,
                             patches=x["patches"], frames=x["frames"])
        out[m] = {"tokens": res["tokens"],
                  "cache": {k: v.numpy() for k, v in res["cache"].items()}}
    return out


@pytest.fixture(scope="module")
def suite(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    trees = {m: r[0] for m, r in reference.items()}
    tokens = {m: r[1] for m, r in reference.items()}
    return run_ranks(ranks.serve_suite, 4, trees, tokens, str(d),
                     timeout_s=300, tmpdir=str(d))


def _ranks_of(case):
    """The suite's ranks that ran a case, in the rank order of its
    group."""
    dpn, mp = ranks.CASES[case][1]
    if dpn * mp == 4:
        return [0, 1, 2, 3]
    pair = next(i for i, names in enumerate(ranks.PAIRS) if case in names)
    return [2 * pair, 2 * pair + 1]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_tp_serving_matches_the_reference(suite, reference, case):
    """Every rank's greedy tokens equal the reference's; its prefill and
    step logits (its rows, teacher-forced) within 1e-4 of the
    reference's; gloo runs the steps eagerly and says so."""
    model = ranks.model_of(ranks.CASES[case])
    _, want_tokens, want_logits = reference[model]
    for r in _ranks_of(case):
        got = suite[r][case]
        np.testing.assert_array_equal(got["tokens"], want_tokens)
        assert (got["backend"], got["graph"]) == ("gloo", False)
        lo, hi = got["rows"]
        for i in range(ranks.G):
            assert rel(got["logits"][i], want_logits[i, lo:hi]) \
                <= TOL["float32"], (r, i)


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_each_rank_holds_its_block_of_the_cache(suite, unsharded, case):
    """Each rank's cache leaves are shaped as ``cache_pspecs`` puts them
    on the (data, model) mesh (the batch over ``data``, the KV heads over
    ``model`` where they divide, else whole, Whisper's cross ``xk`` and
    ``xv`` too; MLA's ``ckv`` and ``kr`` whole; the SSD ``state``'s heads
    over ``model``) and equal the unsharded port's cache there, its rows
    and heads."""
    _, (dpn, mp), _ = ranks.CASES[case]
    model = ranks.model_of(ranks.CASES[case])
    cfg = ranks.config(*model)
    full = unsharded[model]["cache"]
    mesh = Mesh(("data", "model"), (dpn, mp),
                (torch.device("cpu"),) * (dpn * mp))
    specs = cache_pspecs(cfg, {k: v.shape for k, v in full.items()}, mesh)
    sizes = {"data": dpn, "model": mp}
    for r in _ranks_of(case):
        got = suite[r][case]
        coords = dict(zip(("data", "model"), got["coords"]))
        assert set(got["cache"]) == set(full)
        rows = got["rows"][1] - got["rows"][0]
        tp = TensorParallel(None, mp, coords["model"], blocks=True)
        assert {k: tuple(t.shape) for k, t in zero_cache(
            cfg, rows, ranks.P + ranks.G, "cpu", tp).items()} == \
            {k: a.shape for k, a in got["cache"].items()}
        for k, want in full.items():
            for d, entry in enumerate(specs[k].spec):
                if entry is not None:
                    want = np.split(want, sizes[entry], axis=d)[
                        coords[entry]]
            assert got["cache"][k].shape == want.shape, (k, r)
            assert rel(got["cache"][k], want) <= TOL["float32"], (k, r)
        if dpn > 1:
            assert got["rows"] == (coords["data"], coords["data"] + 1)


DENSE = [c for c, (arch, _, _) in ranks.CASES.items()
         if ranks.config(arch).family in ("dense", "vlm")]
MOE = [c for c, (arch, _, _) in ranks.CASES.items()
       if ranks.config(arch).family == "moe"]
SSM_ENCDEC = [c for c, (arch, _, _) in ranks.CASES.items()
              if ranks.config(arch).family in ("ssm", "encdec")]


@pytest.mark.parametrize("case", DENSE)
def test_a_rank_holds_only_its_blocks_of_the_weights(suite, case):
    """A rank holds its block of each split leaf (the query heads, the
    KV heads its queries read, the MLP's columns, the vocabulary), the
    rest whole: its bytes are the model's split ones over ``model``
    plus the leaves kept whole, as ``rank_param_bytes`` counts them."""
    arch, (_, mp), _ = ranks.CASES[case]
    cfg = ranks.config(arch)
    whole = rank_param_bytes(cfg, None, 4)
    # the leaves every rank holds whole: the embedding, the norms, and
    # Granite-34B's one KV head
    kept = 4 * (cfg.vocab * cfg.d_model + cfg.d_model
                + cfg.n_layers * 2 * cfg.d_model)
    if cfg.n_kv_heads == 1:
        kept += 4 * cfg.n_layers * 2 * cfg.d_model * cfg.dh
    for r in _ranks_of(case):
        got = suite[r][case]
        assert got["param_bytes"] == got["param_bytes_want"]
        assert got["param_bytes"] == (whole - kept) // mp + kept
        shapes = got["leaf_shapes"]
        heads = cfg.n_heads // mp * cfg.dh
        assert shapes["layers.0.wq"] == (cfg.d_model, heads)
        assert shapes["layers.0.wo"] == (heads, cfg.d_model)
        assert shapes["layers.0.wd"] == (cfg.d_ff // mp, cfg.d_model)
        assert shapes["unembed"] == (cfg.d_model, cfg.vocab // mp)
        assert shapes["embed"] == tuple(model_shapes(cfg)["embed"])


def _moe_rank_bytes(cfg, mp: int) -> int:
    """A hand count of the float32 bytes one rank of a ``model`` axis of
    ``mp`` holds of a smoke MoE config, from its fields: the embedding,
    the norms, the router and MLA's ``w_dkv`` and ``w_kr`` whole; its
    heads' blocks; its block of the vocabulary, of the dense layer's and
    the shared experts' columns; and its mp-th of the experts, E/mp of
    them whole or every one's F/mp columns (the same count)."""
    D, V, E, F = cfg.d_model, cfg.vocab, cfg.n_experts, cfg.d_ff_moe
    h = cfg.n_heads // mp
    if cfg.kv_lora_rank:
        nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                         cfg.kv_lora_rank)
        attn = (D * h * (nd + rd) + D * r + D * rd + r * h * nd
                + r * h * vd + h * vd * D)
    else:
        dh, kv = cfg.dh, cfg.n_kv_heads // mp
        attn = D * h * dh + 2 * D * kv * dh + h * dh * D
    mats = 3 if cfg.act == "swiglu" else 2
    moe = (D * E + mats * E * D * F // mp
           + mats * D * F * cfg.n_shared_experts // mp)
    dense = mats * D * cfg.d_ff // mp
    L, Ld = cfg.n_layers, cfg.first_dense_layers
    return 4 * (V * D + D * V // mp + D + 2 * D * L + L * attn + Ld * dense
                + (L - Ld) * moe)


@pytest.mark.parametrize("case", MOE)
def test_a_moe_rank_holds_its_heads_experts_and_blocks(suite, case):
    """A MoE serving rank holds its block of the heads (MLA's ``wq``,
    ``w_uk``, ``w_uv`` and ``wo``; GQA's and the KV heads they read), of
    the experts (E/mp of them where the axis divides E, else every
    expert's F/mp hidden columns), of the dense layer's and the shared
    experts' columns and of the vocabulary, the rest whole: its bytes
    are ``rank_param_bytes``'s and a hand count's."""
    _, (_, mp), _ = ranks.CASES[case]
    cfg = ranks.config(*ranks.model_of(ranks.CASES[case]))
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_moe
    for r in _ranks_of(case):
        got = suite[r][case]
        assert got["param_bytes"] == got["param_bytes_want"] \
            == _moe_rank_bytes(cfg, mp)
        shapes = got["leaf_shapes"]
        want = {"layers.0.router": (D, E)}
        if E % mp == 0:
            want |= {"layers.0.wg": (E // mp, D, F),
                     "layers.0.wd": (E // mp, F, D)}
        else:
            want |= {"layers.0.wg": (E, D, F // mp),
                     "layers.0.wd": (E, F // mp, D)}
        h = cfg.n_heads // mp
        if cfg.kv_lora_rank:
            nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            r = cfg.kv_lora_rank
            want |= {"layers.0.wq": (D, h * (nd + rd)),
                     "layers.0.w_uk": (r, h * nd),
                     "layers.0.w_uv": (r, h * vd),
                     "layers.0.wo": (h * vd, D),
                     "layers.0.w_dkv": (D, r),
                     "head_layers.0.wd": (cfg.d_ff // mp, D),
                     "layers.0.wd_s": (F * cfg.n_shared_experts // mp, D)}
        else:
            want |= {"layers.0.wq": (D, h * cfg.dh),
                     "layers.0.wk": (D, cfg.n_kv_heads // mp * cfg.dh)}
        for name, shape in want.items():
            assert shapes[name] == shape, (name, r)


def _ssm_encdec_rank_bytes(cfg, mp: int) -> int:
    """A hand count of the float32 bytes one rank of a ``model`` axis of
    ``mp`` holds of the smoke Mamba-2 or Whisper, from its fields: the
    embedding (Mamba-2's tied: whole, its logits from the rank's rows),
    the norms, Whisper's ``enc_pos`` whole; Mamba-2's block of the SSD
    heads (``in_proj``'s z, xs and dt columns of them, its B and C
    whole; their ``dt_bias``, ``A_log``, ``D_skip``, ``norm_g`` and
    ``out_proj`` rows); Whisper's heads' blocks of the encoder's
    attention, the decoder's self- and cross-attention, the MLPs'
    columns and the vocabulary's."""
    D, V = cfg.d_model, cfg.vocab
    if cfg.family == "ssm":
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        layer = (D + D * (2 * di // mp + 2 * N + H // mp) + 3 * H // mp
                 + di // mp + di // mp * D)
        return 4 * (V * D + D + cfg.n_layers * layer)
    hd = cfg.n_heads // mp * cfg.dh
    attn = 4 * D * hd                   # wq, wk, wv, wo: 16 KV heads
    mlp = 2 * D * cfg.d_ff // mp        # GELU: wu, wd
    dec = 6 * D + 2 * attn + mlp        # ln1, lnx, ln2 (gamma and beta)
    enc = 4 * D + attn + mlp
    return 4 * (V * D + D * V // mp + 2 * D + cfg.n_layers * dec
                + cfg.encoder_layers * enc + cfg.encoder_frames * D
                + 2 * D)


@pytest.mark.parametrize("case", SSM_ENCDEC)
def test_an_ssm_or_encdec_rank_holds_its_blocks(suite, case):
    """A Mamba-2 serving rank holds its block of the SSD heads and the
    whole tied embedding; a Whisper rank its heads of every attention
    (the encoder's, the decoder's self- and cross-attention), its MLP
    columns and vocabulary block: its bytes are ``rank_param_bytes``'s
    and a hand count's, its leaves the blocks' shapes."""
    arch, (_, mp), _ = ranks.CASES[case]
    cfg = ranks.config(arch)
    D = cfg.d_model
    for r in _ranks_of(case):
        got = suite[r][case]
        assert got["param_bytes"] == got["param_bytes_want"] \
            == _ssm_encdec_rank_bytes(cfg, mp)
        shapes = got["leaf_shapes"]
        assert shapes["embed"] == (cfg.vocab, D)
        if cfg.family == "ssm":
            di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            want = {"layers.0.ssm_in_proj": (D, 2 * di // mp + 2 * N
                                             + H // mp),
                    "layers.0.ssm_A_log": (H // mp,),
                    "layers.0.ssm_norm_g": (di // mp,),
                    "layers.0.ssm_out_proj": (di // mp, D)}
            assert "unembed" not in shapes
        else:
            hd = cfg.n_heads // mp * cfg.dh
            want = {"layers.0.x_wq": (D, hd), "layers.0.x_wk": (D, hd),
                    "layers.0.x_wo": (hd, D), "enc_layers.0.wq": (D, hd),
                    "enc_layers.0.wd": (cfg.d_ff // mp, D),
                    "enc_pos": (cfg.encoder_frames, D),
                    "unembed": (D, cfg.vocab // mp)}
        for name, shape in want.items():
            assert shapes[name] == shape, (name, r)


def test_tp_serve_cli_prints_the_same_tokens(capfd):
    """``serve --arch --model-parallel 2 --nproc 2`` on the CPU: rank 0
    prints the reference's three lines (and the mesh), with the tokens
    of the run on one device."""
    argv = ["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "24", "--gen", "5"]
    want = serve.main(argv)
    capfd.readouterr()
    got = serve.main(argv + ["--model-parallel", "2", "--nproc", "2"])
    np.testing.assert_array_equal(got, want)
    out = capfd.readouterr().out
    assert out.count("prefill 24 toks x2") == 1
    assert out.count("decode  4 steps x2") == 1
    assert "mesh: {'data': 1, 'model': 2}  devices=2  backend=gloo  " \
        "graph=False" in out
    assert f"sample generation (first sequence): {want[0].tolist()}" in out


def test_moe_tp_serve_cli_prints_the_one_device_tokens(capfd):
    """``serve --arch deepseek_v2_lite --smoke --model-parallel 2 --nproc
    2`` on the CPU (bf16, the launcher's defaults): rank 0 prints the
    mesh and the tokens of the run on one device, which serves the same
    random model."""
    argv = ["--arch", "deepseek_v2_lite", "--smoke", "--device", "cpu"]
    want = serve.main(argv)
    capfd.readouterr()
    got = serve.main(argv + ["--model-parallel", "2", "--nproc", "2"])
    np.testing.assert_array_equal(got, want)
    out = capfd.readouterr().out
    assert "mesh: {'data': 1, 'model': 2}  devices=2  backend=gloo  " \
        "graph=False" in out
    assert f"sample generation (first sequence): {want[0][:16].tolist()}" \
        in out


@pytest.mark.parametrize("ssm_encdec_argv", [
    ["--arch", "mamba2_2p7b", "--model-parallel", "2", "--nproc", "2"],
    ["--arch", "whisper_medium", "--model-parallel", "2", "--nproc", "2"],
    ["--arch", "whisper_medium", "--model-parallel", "4", "--nproc", "4"]])
def test_ssm_encdec_tp_serve_cli_prints_the_one_device_tokens(
        ssm_encdec_argv, capfd):
    """``serve --arch mamba2_2p7b|whisper_medium --smoke --model-parallel
    N --nproc N`` on the CPU (bf16, the launcher's defaults; Whisper's
    frames drawn as the reference draws them): rank 0 prints the mesh
    and the tokens of the run on one device, which serves the same
    random model."""
    arch, mp = ssm_encdec_argv[1], int(ssm_encdec_argv[3])
    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    want = serve.main(argv)
    capfd.readouterr()
    got = serve.main(argv + ssm_encdec_argv[2:])
    np.testing.assert_array_equal(got, want)
    out = capfd.readouterr().out
    assert f"mesh: {{'data': 1, 'model': {mp}}}  devices={mp}  " \
        "backend=gloo  graph=False" in out
    assert f"sample generation (first sequence): {want[0][:16].tolist()}" \
        in out


@pytest.mark.parametrize("flags,match", [
    (["--arch", "mamba2_2p7b", "--model-parallel", "32", "--nproc", "32"],
     r"ssm_heads = 80 does not split"),
    (["--arch", "hymba_1p5b", "--smoke", "--model-parallel", "2",
      "--nproc", "2"],
     r"hybrid family comes with a later tensor-parallel slice"),
    (["--arch", "llama3_8b", "--smoke", "--model-parallel", "2",
      "--prompt-len", "25", "--nproc", "2"],
     r"a prompt of 25 positions does not split over 2"),
    (["--arch", "llama3_8b", "--smoke", "--model-parallel", "4",
      "--nproc", "4"],
     r"n_kv_heads = 2 does not split over a 'model' axis of 4"),
    (["--arch", "qwen2_7b", "--model-parallel", "8", "--nproc", "8"],
     r"n_heads = 28 does not split"),
    (["--arch", "llama3_8b", "--smoke", "--model-parallel", "2"],
     r"runs over a torch.distributed process group: start it with "
     r"--nproc N or torchrun")])
def test_serve_refuses_what_a_later_tp_slice_brings(flags, match):
    """Before any rank starts: an SSD-head count the axis does not divide
    (Mamba-2's 80 over 32), the hybrid family, a prompt or a KV-head
    count the axis does not divide, a head count it does not divide; and
    ``--model-parallel`` with no process group."""
    with pytest.raises(ValueError, match=match):
        serve.main(flags + ["--device", "cpu"])


def test_vocabulary_blocks_gather_whole():
    """``gather_vocab``'s cut: the vocabulary's blocks as
    ``TensorParallel.block`` cuts them, the ranks' padded blocks cut
    back, joined in rank order (Granite-3's 49155 over 2 and 8)."""
    from repro_torch.dist import spmd
    for V, n in ((49155, 2), (49155, 8), (256, 4)):
        x = torch.arange(V, dtype=torch.float32)[None]
        blocks = [x[:, slice(*TensorParallel(None, n, r).block(V))]
                  for r in range(n)]
        width = -(-V // n)
        padded = torch.cat([torch.nn.functional.pad(b, (0, width
                                                        - b.shape[1]))
                            for b in blocks], 1)

        def fake_gather(t, dim, group, k, padded=padded):
            return padded
        real = spmd.all_gather_cat
        spmd.all_gather_cat = fake_gather
        try:
            got = spmd.gather_vocab(blocks[0], TensorParallel(None, n, 0),
                                    V)
        finally:
            spmd.all_gather_cat = real
        assert torch.equal(got, x), (V, n)


def test_costmodel_bounds_a_tp_decode_step():
    """``costmodel.tp_decode``: Llama-3-8B at B 8 on a ``model`` axis of 2
    reads half its split weights and half the cache a step, 65
    collectives (2 a layer and the vocabulary's gather), the float32
    sums' and the bf16 logits' bytes; memory bounds it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.costmodel import HBM_BW, tp_decode
    cfg = get_config("llama3_8b")
    one, two = tp_decode(cfg, 8, 48, 1), tp_decode(cfg, 8, 48, 2)
    embed = cfg.vocab * cfg.d_model * 2
    norms = (2 * cfg.n_layers + 1) * cfg.d_model * 2
    kept = embed + norms
    assert two["held_weight_bytes"] == \
        (one["held_weight_bytes"] - kept) // 2 + kept
    assert two["weight_bytes"] == two["held_weight_bytes"] - embed \
        + 8 * cfg.d_model * 2
    assert two["cache_bytes"] * 2 == one["cache_bytes"] == \
        32 * 8 * 48 * 2 * 8 * 128 * 2
    assert (one["collectives"], two["collectives"]) == (0, 65)
    reduce, gather = 64 * 8 * 4096 * 4, 8 * 128256 * 2
    assert two["collective_payload_bytes"] == reduce + gather
    assert two["collective_wire_bytes"] == reduce + gather / 2
    assert two["t_memory_s"] == (two["weight_bytes"]
                                 + two["cache_bytes"]) / HBM_BW
    assert two["dominant"] == "memory"
    assert two["step_lower_bound_s"] == two["t_memory_s"]
    # two data groups of two: each serves 4 rows
    assert tp_decode(cfg, 8, 48, 2, 2)["rows"] == 4
