"""The port's tensor-parallel training of the dense family against the
JAX reference on the CPU: the sharded train step with the forward split
over the ``model`` ranks (heads, MLP columns, the vocabulary; the
residual stream cut along the sequence between the layers), K7's block
entry, and the launcher's refusals.

No process group is started in the pytest process: the ranks run in
processes of their own (``dist.spmd.run_ranks``, one thread a rank, a
timeout), what they run in ``torch_tp_ranks.py``, which imports no JAX;
every rank case shares one group of 4 (``suite``), which runs the cases
on 4 ranks, then the cases on 2 in two groups of 2, then the step on
one rank.

Tolerances (``test_torch_spmd.py``'s, the reason there): the sharded
steps, float32, against the reference's unsharded step: losses and
``grad_norm`` 1e-5 relative at every step; masters 1e-4 norm-relative,
and 1e-4 against the port's unsharded step on the same inputs (the
partial sums of the heads, columns and vocabulary blocks add in another
order); float32 moments 1e-4; int8 moments: q within one step,
dequantized within one level and their blocks' scales' difference.
One exception against the reference: a master whose unsharded port run
already lies more than 5e-5 from it may lie up to twice that far.
Granite-34B's ``embed`` is such a leaf: the port's unsharded step lies
9.94e-5 from the reference, nearly all of it in one element whose
AdamW update nearly cancels over the three steps, and a change of
summation order moves that element again (the tensor-parallel run:
1.12e-4 from the reference, 1.26e-5 from the unsharded run).  On
one rank (``model`` = 1) the step is bitwise the unsharded step.  K7's
block entry: the combined triples of its plain version within 2e-6 of
the whole rows' losses (float32 logits of magnitude ~3 over up to 255
columns; the sums are taken in another order), its gradient 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spmd_ranks as spmd_ranks
import torch_tp_ranks as ranks
from repro import optim as ref_optim
from repro.configs import smoke_config as ref_smoke_config
from repro.train import steps as ref_steps
from repro_torch.configs import ShapeConfig
from repro_torch.dist.spmd import TensorParallel, run_ranks
from repro_torch.kernels import ref
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import train_state_from_reference
from repro_torch.train import steps
from test_torch_spmd import _ref_state, check_metrics, check_state
from torch_lm_parity import reference_tree


def _key(case):
    arch, _, moments, over = case
    return arch, moments, tuple(sorted(over.items()))


def _ref_run(arch, moments, over):
    """The reference's unsharded float32 step, three times: (initial state
    as numpy, metrics, final state)."""
    over = dict(over)
    rcfg = dataclasses.replace(ref_smoke_config(arch),
                               compute_dtype="float32",
                               opt_moment_dtype=moments, **over)
    st = _ref_state(rcfg, reference_tree(rcfg))
    init = jax.tree_util.tree_map(np.asarray, st)
    step = jax.jit(ref_steps.make_train_step(
        rcfg, ref_optim.AdamWHyper(**ranks.HYPER)))
    get = spmd_ranks.make_batch_fn(
        ranks.config(arch, moments, over),
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
    out = {}
    for name, (arch, _, moments, over) in ranks.CASES.items():
        cfg = ranks.config(arch, moments, over)
        state = train_state_from_reference(cfg, reference[name][0], "cpu")
        step = steps.make_train_step(cfg, spmd_ranks.AdamWHyper(
            **ranks.HYPER))
        get = spmd_ranks.make_batch_fn(
            cfg, ShapeConfig("t", ranks.S, ranks.B, "train"))
        for i in range(ranks.STEPS):
            state, _ = step(state, spmd_ranks.shard_batch(get(i), "cpu"))
        out[name] = {k: spmd_ranks._np(t) for k, t in _flatten(state)}
    return out


@pytest.fixture(scope="module")
def suite(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inits = {name: r[0] for name, r in reference.items()}
    return run_ranks(ranks.tp_suite, 4, inits, str(d), timeout_s=300,
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
def test_tp_steps_match_the_reference(suite, reference, unsharded, case):
    """Three float32 steps with the forward split over ``model`` against
    the reference's unsharded step and the port's (module docstring):
    Llama on (2, 2), on (1, 4) (a KV head read by two ranks, each
    computing it), on (1, 2), with 255 columns (blocks of 128 and 127)
    and with int8 moments; Qwen2's QKV bias and Granite-34B's one KV
    head (MQA) on (1, 2)."""
    _, want_metrics, want_state = reference[case]
    out = [suite[r]["cases"][case] for r in _ranks_of(case)]
    assert out[0]["mesh"] == dict(zip(("data", "model"),
                                      ranks.CASES[case][1]))
    check_metrics([o["metrics"] for o in out], want_metrics)
    check_state(out[0]["state"], want_state, unsharded[case],
                ranks.CASES[case][2] == "int8", near_one=True)


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_each_rank_holds_its_blocks(suite, case):
    """Between the layers each rank holds its block of the sequence of
    its rows, (B / data, S / model, D); its logits are its block of the
    vocabulary, as ``torch.tensor_split`` cuts it."""
    arch, (dpn, mp), moments, over = ranks.CASES[case]
    cfg = ranks.config(arch, moments, over)
    splits = [len(b) for b in torch.tensor_split(torch.arange(cfg.vocab),
                                                 mp)]
    bounds = np.cumsum([0] + splits)
    for r in _ranks_of(case):
        got = suite[r]["cases"][case]
        dp_rank, model_rank = got["coords"]
        lo, hi = got["vocab_block"]
        assert (lo, hi) == (bounds[model_rank], bounds[model_rank + 1])
        rows = ranks.B // dpn
        assert got["residual"] == [(rows, ranks.S // mp, cfg.d_model)] \
            * cfg.n_layers
        assert got["logits"] == (rows, ranks.S, hi - lo)


@pytest.mark.parametrize("case", ranks.GRADS)
def test_tp_gradients_match_the_unsharded_step_leaf_by_leaf(suite, case):
    """The first step's float32 gradients, summed over the ranks, against
    the unsharded step's from the same state, every leaf within 1e-5
    norm-relative (the same sums in another order).  AdamW's update
    does not see a leaf's gradient scaled by a constant, and the
    gradient norm hardly sees a small leaf's: this holds every leaf's
    sum over ``model`` to counting its blocks once."""
    errs = suite[0]["grads"][case]
    assert errs and max(errs.values()) <= 1e-5, errs


def test_one_rank_is_bitwise_the_unsharded_step(suite):
    """On a (1, 1) mesh, tensor parallelism on, the sharded step is the
    unsharded step bit for bit: losses, gradient norms and every leaf."""
    one = suite[0]["one"]
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["metrics_equal"] and one["differ"] == []
    assert one["leaves"] > 0


def _logits(T, V, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, V, generator=g) * 3
    labels = torch.randint(0, V, (T,), generator=g)
    labels[::7] = -1                  # no target
    labels[3::11] = V + 5             # outside the vocabulary
    return x, labels


@pytest.mark.parametrize("V,n", [(256, 2), (256, 16), (255, 2), (255, 4),
                                 (49155, 8)])
def test_k7_block_triples_combine_to_the_whole_rows(V, n):
    """Each block's triple of ``ref.softmax_xent_block`` (the blocks as
    ``torch.tensor_split`` cuts them, labels of -1 and outside the
    vocabulary, and labels in other blocks than a triple's), combined
    as the ranks combine them, equals ``ref.softmax_xent_rows`` on the
    whole rows; the blocks' gradients side by side equal the whole
    rows' gradient."""
    x, labels = _logits(33, V)
    want = ref.softmax_xent_rows(x, labels)
    triples, grads = [], []
    cuts = [TensorParallel(None, n, r).block(V) for r in range(n)]
    assert [hi - lo for lo, hi in cuts] == [
        len(b) for b in torch.tensor_split(torch.arange(V), n)]
    for lo, hi in cuts:
        m, s, xl = ref.softmax_xent_block(x[:, lo:hi], labels, lo)
        inside = (labels >= lo) & (labels < hi)
        picked = x[torch.arange(33), labels.clamp(0, V - 1)]
        assert torch.equal(xl, torch.where(inside, picked, 0.0))
        triples.append((m, s, xl))
    got = ref.combine_xent_blocks(triples)
    assert torch.allclose(got, want, rtol=0, atol=2e-6)
    lse = got + sum(t[2] for t in triples)
    dloss = torch.linspace(0.5, 1.5, 33)
    for lo, hi in cuts:
        grads.append(ref.softmax_xent_block_backward(x[:, lo:hi], labels,
                                                     lo, lse, dloss))
    whole = ref.softmax_xent_rows_backward(x, labels, dloss)
    assert torch.allclose(torch.cat(grads, 1), whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags,match", [
    (["--arch", "qwen2_7b", "--model-parallel", "8"],
     r"qwen2_7b: n_heads = 28 does not split .* of 8.*later"),
    (["--arch", "granite_34b", "--model-parallel", "32"],
     r"granite_34b: n_heads = 48 does not split .* of 32.*later"),
    (["--arch", "mamba2_2p7b", "--smoke", "--model-parallel", "2"],
     r"ssm family comes with a later tensor-parallel slice"),
    (["--arch", "llava_next_34b", "--smoke", "--model-parallel", "2"],
     r"vlm family comes with a later tensor-parallel slice")])
def test_launcher_refuses_what_a_later_tp_slice_brings(flags, match):
    """Before any rank starts: a head count the ``model`` axis does not
    divide, and a family other than dense under tensor parallelism."""
    with pytest.raises(ValueError, match=match):
        train_launcher.main(flags + ["--device", "cpu", "--steps", "1",
                                     "--nproc", "4"])


def test_tensor_parallel_split_names_the_dimension():
    """The MLP's columns are held as the heads are, and so is a block of
    query heads that would read part of two KV heads' groups; the dense
    configs' splits that divide pass."""
    cfg = dataclasses.replace(ranks.config("llama3_8b"), d_ff=130)
    with pytest.raises(ValueError, match="d_ff = 130 does not split"):
        steps.tensor_parallel_split(cfg, 4)
    # 12 heads over 2 KV heads on 3 ranks: rank 1 reads heads 4-7,
    # part of each group of 6
    cfg = dataclasses.replace(ranks.config("llama3_8b"), n_heads=12,
                              d_model=96, d_ff=96)
    with pytest.raises(ValueError, match="4 query heads a rank over "
                                         "groups of 6"):
        steps.tensor_parallel_split(cfg, 3)
    steps.tensor_parallel_split(ranks.config("llama3_8b"), 4)
    for arch in ("llama3_8b", "granite3_8b", "granite_34b"):
        from repro_torch.configs import get_config
        steps.tensor_parallel_split(get_config(arch), 16)
