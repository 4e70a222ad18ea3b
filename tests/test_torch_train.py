"""The port's training path (``repro_torch.optim``, ``models.lm_loss``,
``train.steps.make_train_step``, ``data``, ``ckpt.fault_tolerance``,
``launch.train``) against the JAX reference on the CPU.

Both packages run on the same numbers: the reference's parameter tree
(its constant leaves drawn at random, ``torch_lm_parity.reference_tree``)
and train state go to the port through ``models.convert``; batches come
from the synthetic pipeline, which is bitwise the reference's.  On the
CPU the port's K4, K6 and K7 run their plain versions, through the same
``autograd.Function`` as the kernels on the card (``kernels.grad``).

Tolerances, float32, norm-relative (``||got - want|| / ||want||``): the
loss 1e-5, each gradient leaf 1e-4 (the same arithmetic summed in
another order); the masters after three steps 1e-4; int8 moments within
one quantization step.  The accumulated step against the single one
uses the reference's own bound (5e-3 absolute,
``tests/test_train_infra.py``).
"""
import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro import optim as ref_optim
from repro.ckpt import fault_tolerance as ref_ft
from repro.configs import ShapeConfig as RefShapeConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.data import DataConfig as RefDataConfig
from repro.data import make_batch_fn as ref_make_batch_fn
from repro.train import steps as ref_steps
from repro_torch import optim
from repro_torch.ckpt import fault_tolerance as ft
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.data import (DataConfig, SyntheticLM, make_batch_fn,
                              shard_batch)
from repro_torch.kernels import grad, ref
from repro_torch.launch import train as train_launcher
from repro_torch.models import cast_params, lm_loss
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.train import steps
from torch_lm_parity import configs, reference_tree
from torch_threads import capped_torch_threads  # noqa: F401

B, S = 2, 32


def rel(got, want) -> float:
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float64)
    w = np.asarray(want, np.float64)
    den = np.linalg.norm(w)
    return float(np.linalg.norm(g - w) / (den if den > 0 else 1.0))


def stacked(cfg, flat: dict) -> dict:
    """The port's leaves by name (``layers.0.wq``) stacked as the
    reference's tree (``layers`` -> ``wq`` (L, ...)), numpy."""
    out: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        a = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
        if len(parts) == 1:
            out[name] = a
        else:
            out.setdefault(parts[0], {}).setdefault(parts[2], []).append(a)
    return {k: ({n: np.stack(v) for n, v in d.items()}
                if isinstance(d, dict) else d) for k, d in out.items()}


def leaves(tree, prefix=""):
    """(path, array) of a nested dict of arrays."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def batch_for(cfg, seed_step=0, B=B, S=S):
    return make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))(seed_step)


# ---------------------------------------------------------------------------
# the loss and its gradients, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    cfg, rcfg = configs(arch, "float32")
    tree = reference_tree(rcfg)
    b = batch_for(cfg)
    (want, wmet), wgrads = jax.value_and_grad(
        lambda p: ref_models.lm_loss(rcfg, p, {k: jnp.asarray(v)
                                               for k, v in b.items()}),
        has_aux=True)(tree)
    model = cast_params(cfg, params_from_reference(cfg, tree, "cpu"))
    model.requires_grad_(True)
    loss, met = lm_loss(cfg, model, shard_batch(b, "cpu"))
    names, ps = zip(*model.named_parameters())
    gs = torch.autograd.grad(loss, ps)
    assert rel(loss, want) <= 1e-5
    assert rel(met["xent"], wmet["xent"]) <= 1e-5
    if cfg.family == "moe":
        assert rel(met["aux"], wmet["aux"]) <= 1e-5
    got = dict(leaves(stacked(cfg, dict(zip(names, gs)))))
    want_g = dict(leaves(wgrads))
    assert got.keys() == want_g.keys()
    for k in want_g:
        assert rel(got[k], want_g[k]) <= 1e-4, k


def test_masked_label_reads_no_column_and_takes_no_gradient():
    """A label of -1 gives the row's logsumexp (no column read) and, once
    masked out by ``lm_loss``, a zero gradient row."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((5, 11)), dtype=torch.float32,
                     requires_grad=True)
    labels = torch.tensor([3, -1, 0, 10, -1])
    rows = grad.softmax_xent_rows(x, labels)
    lse = torch.logsumexp(x.detach(), -1)
    assert torch.equal(rows[labels < 0], lse[labels < 0])
    mask = (labels >= 0).float()
    (rows * mask).sum().backward()
    assert torch.equal(x.grad[labels < 0], torch.zeros(2, 11))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_and_k7_backward_match_autograd_of_plain_versions(dtype):
    """``ref.rmsnorm_backward`` and ``ref.softmax_xent_rows_backward``
    (the kernels' backward) against autograd through K4's and K7's plain
    versions, in float32 inside."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((6, 3, 40)), dtype=dtype)
    g = torch.tensor(1 + 0.1 * rng.standard_normal(40), dtype=dtype)
    dy = torch.tensor(rng.standard_normal((6, 3, 40)), dtype=dtype)
    xr = x.detach().float().clone().requires_grad_()
    gr = g.detach().float().clone().requires_grad_()
    ref.rmsnorm(xr, gr).backward(dy.float())
    xg, gg = x.clone().requires_grad_(), g.clone().requires_grad_()
    grad.rmsnorm(xg, gg).backward(dy)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert xg.grad.dtype == dtype and gg.grad.dtype == dtype
    assert rel(xg.grad, xr.grad) <= tol and rel(gg.grad, gr.grad) <= tol
    logits = torch.tensor(rng.standard_normal((2100, 50)), dtype=dtype)
    labels = torch.tensor(rng.integers(-1, 50, 2100))
    dl = torch.tensor(rng.standard_normal(2100), dtype=torch.float32)
    lr_ = logits.detach().float().clone().requires_grad_()
    ref.softmax_xent_rows(lr_, labels).backward(dl)
    lg = logits.clone().requires_grad_()
    grad.softmax_xent_rows(lg, labels).backward(dl)
    assert lg.grad.dtype == dtype
    assert rel(lg.grad, lr_.grad) <= tol


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_inputs(rcfg, seed=0):
    """A small parameter tree, its gradients and nonzero moments after
    one reference step, as numpy trees."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 200)).astype(np.float32),
              "b": rng.standard_normal((130,)).astype(np.float32),
              "layers": {"w": rng.standard_normal((2, 5, 64))
                         .astype(np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.3,
        params)
    h = ref_optim.AdamWHyper(lr=1e-2, warmup_steps=2, total_steps=10)
    opt = ref_optim.init_opt_state(rcfg, params)
    _, opt, _ = ref_optim.apply_adamw(rcfg, h, params, grads, opt)
    grads = jax.tree_util.tree_map(lambda g: g * 1.7, grads)
    return params, grads, opt, h


def _flat(tree):
    """Port names for ``_opt_inputs``' tree: ``a``, ``b``, ``layers.l.w``."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for n, a in v.items():
                if isinstance(a, dict):
                    for l in range(np.asarray(a["q"]).shape[0]):
                        out[f"layers.{l}.{n}"] = {
                            q: torch.from_numpy(np.array(x)[l])
                            for q, x in a.items()}
                else:
                    for l in range(np.asarray(a).shape[0]):
                        out[f"layers.{l}.{n}"] = torch.from_numpy(
                            np.array(a)[l])
        elif isinstance(v, dict):
            out[k] = {q: torch.from_numpy(np.array(x)) for q, x in v.items()}
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_apply_adamw_matches_reference(moments):
    _, rcfg = configs("llama3_8b", "float32", opt_moment_dtype=moments)
    params, grads, opt, h = _opt_inputs(rcfg)
    wp, wopt, wmet = ref_optim.apply_adamw(rcfg, h, params, grads, opt)
    hp = optim.AdamWHyper(**dataclasses.asdict(h))
    popt = {"m": _flat(opt["m"]), "v": _flat(opt["v"]),
            "step": torch.tensor(int(opt["step"]), dtype=torch.int32)}
    gp, gopt, gmet = optim.apply_adamw(rcfg, hp, _flat(params),
                                       _flat(grads), popt)
    assert int(gopt["step"]) == int(wopt["step"]) == 2
    assert rel(gmet["lr"], wmet["lr"]) <= 1e-6
    assert rel(gmet["grad_norm"], wmet["grad_norm"]) <= 1e-6
    for n, t in _flat(wp).items():
        assert rel(gp[n], t.numpy()) <= 1e-6, n
    for key in ("m", "v"):
        for n, t in _flat(wopt[key]).items():
            got = gopt[key][n]
            if moments == "float32":
                assert rel(got, t.numpy()) <= 1e-6, (key, n)
            else:      # within one quantization step
                assert rel(got["scale"], t["scale"].numpy()) <= 1e-6
                assert int((got["q"].int() - t["q"].int()).abs().max()) <= 1


def test_schedule_and_quantization_match_reference():
    h = optim.AdamWHyper(lr=1e-3, warmup_steps=5, total_steps=50)
    rh = ref_optim.AdamWHyper(lr=1e-3, warmup_steps=5, total_steps=50)
    for s in (0, 1, 4, 5, 6, 27, 50, 80):
        assert rel(optim.schedule(h, torch.tensor(s, dtype=torch.int32)),
                   ref_optim.schedule(rh, jnp.int32(s))) <= 1e-6
    x = np.random.default_rng(2).standard_normal((3, 300)).astype(
        np.float32)
    q, sc = optim.quantize(torch.from_numpy(x))
    wq, wsc = ref_optim.quantize(jnp.asarray(x))
    assert torch.equal(q, torch.from_numpy(np.array(wq)))
    assert rel(sc, wsc) <= 1e-7
    assert rel(optim.dequantize(q, sc, 300),
               ref_optim.dequantize(wq, wsc, 300)) <= 1e-7


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _ref_state(rcfg, tree):
    cd = jnp.dtype(rcfg.compute_dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return {"params": params,
            "params_c": jax.tree_util.tree_map(lambda x: x.astype(cd),
                                               params),
            "opt": ref_optim.init_opt_state(rcfg, params)}


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_three_train_steps_match_reference(moments):
    cfg, rcfg = configs("llama3_8b", "float32", opt_moment_dtype=moments)
    tree = reference_tree(rcfg)
    wstate = _ref_state(rcfg, tree)
    state = train_state_from_reference(cfg, jax.tree_util.tree_map(
        np.asarray, wstate), "cpu")
    h = ref_optim.AdamWHyper(lr=3e-3, warmup_steps=1, total_steps=10)
    ref_step = jax.jit(ref_steps.make_train_step(rcfg, h))
    step = steps.make_train_step(cfg, optim.AdamWHyper(
        **dataclasses.asdict(h)))
    get = make_batch_fn(cfg, ShapeConfig("t", S, 4, "train"))
    for i in range(3):
        b = get(i)
        wstate, wm = ref_step(wstate, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        state, m = step(state, shard_batch(b, "cpu"))
        for k in ("loss", "xent", "lr", "grad_norm"):
            assert rel(m[k], wm[k]) <= 1e-5, (i, k)
    got = dict(leaves(stacked(cfg, state["params"])))
    want = dict(leaves(wstate["params"]))
    for k in want:
        assert rel(got[k], want[k]) <= 1e-4, k
    # the compute copy is the masters, refreshed
    for n, p in state["params_c"].named_parameters():
        assert torch.equal(p.detach(), state["params"][n])


def test_grad_accumulation_equivalence():
    """accum=2 over a batch against accum=1 (the reference's bound), and
    against the reference's accum=2 (1e-4)."""
    cfg, rcfg = configs("llama3_8b", "float32")
    tree = reference_tree(rcfg)
    h = optim.AdamWHyper(lr=1e-3, warmup_steps=1, total_steps=10,
                         grad_clip=1e9)
    b = make_batch_fn(cfg, ShapeConfig("t", 32, 8, "train"))(0)
    out = {}
    for accum in (1, 2):
        st = train_state_from_reference(cfg, jax.tree_util.tree_map(
            np.asarray, _ref_state(rcfg, tree)), "cpu")
        out[accum], _ = steps.make_train_step(cfg, h, accum=accum)(
            st, shard_batch(b, "cpu"))
    d = max(float((out[1]["params"][n] - out[2]["params"][n]).abs().max())
            for n in out[1]["params"])
    assert d < 5e-3
    wst, _ = jax.jit(ref_steps.make_train_step(
        rcfg, ref_optim.AdamWHyper(**dataclasses.asdict(h)), accum=2))(
        _ref_state(rcfg, tree), {k: jnp.asarray(v) for k, v in b.items()})
    got = dict(leaves(stacked(cfg, out[2]["params"])))
    for k, w in leaves(wst["params"]):
        assert rel(got[k], w) <= 1e-4, k


# ---------------------------------------------------------------------------
# data, fault tolerance, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structure", [True, False])
def test_synthetic_batches_are_the_reference_batches(structure):
    a = SyntheticLM(DataConfig(vocab=300, seq_len=17, global_batch=3, seed=5,
                               structure=structure))
    b = RefSyntheticLM(RefDataConfig(vocab=300, seq_len=17, global_batch=3,
                                     seed=5, structure=structure))
    for step in (0, 1, 9):
        x, y = a.batch(step), b.batch(step)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    it, rit = a.iterator(3), b.iterator(3)
    np.testing.assert_array_equal(next(it)["tokens"], next(rit)["tokens"])


@pytest.mark.parametrize("arch", ["llava_next_34b", "whisper_medium",
                                  "llama3_8b"])
def test_make_batch_fn_is_the_reference_batch_fn(arch):
    cfg, rcfg = configs(arch, "float32")
    got = make_batch_fn(cfg, ShapeConfig("t", 24, 2, "train"))(4)
    want = ref_make_batch_fn(rcfg, RefShapeConfig("t", 24, 2, "train"))(4)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    dev = shard_batch(got, "cpu")
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in dev.values())


def test_fault_tolerance_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 3.5, 1.0, 4.0, 4.2, 1.0]
    a, b = ft.StepWatchdog(evict_after=2), ref_ft.StepWatchdog(evict_after=2)
    for i, t in enumerate(times):
        ra, rb = a.record(i, t), b.record(i, t)
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
        assert a.should_remesh == b.should_remesh
    clock = iter([0.0, 0.0, 50.0, 100.0]).__next__
    rclock = iter([0.0, 0.0, 50.0, 100.0]).__next__
    h = ft.Heartbeat(["h0", "h1"], timeout_s=60.0, clock=clock)
    rh = ref_ft.Heartbeat(["h0", "h1"], timeout_s=60.0, clock=rclock)
    h.beat("h1"), rh.beat("h1")
    assert h.dead_hosts() == rh.dead_hosts() == ["h0"]
    for args in ((3, 4, 2), (1, 4, 8), (5, 8, 4), (0, 4, 1)):
        assert ft.plan_remesh(*args) == ref_ft.plan_remesh(*args)
    with ft.PreemptionGuard() as g:
        signal.raise_signal(signal.SIGTERM)
        assert g.requested


def test_launch_train_smoke_loss_decreases(capsys):
    """``launch.train --smoke --device cpu`` for 20 steps: the loss falls,
    as the reference's ``test_loss_decreases``."""
    hist = train_launcher.main(["--arch", "llama3_8b", "--smoke", "--steps",
                                "20", "--device", "cpu", "--log-every",
                                "5"])
    losses = [h["loss"] for h in hist]
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "over 20 steps" in out


@pytest.mark.parametrize("flags,slice_", [
    (["--mesh", "multipod"], "needs a world of 512"),
    (["--model-parallel", "4"], "runs over a process group"),
    (["--model-parallel", "2"], "runs over a process group"),
    (["--mesh", "pod"], "needs a world of 256")])
def test_launch_train_refuses_what_a_later_slice_brings(flags, slice_):
    with pytest.raises(ValueError, match=slice_):
        train_launcher.main(["--arch", "llama3_8b", "--smoke", "--device",
                             "cpu", "--steps", "1"] + flags)


def test_train_example_runs_on_the_cpu():
    from repro_torch.examples import train_lm
    hist = train_lm.main(["--steps", "30", "--device", "cpu"])
    assert hist[-1]["loss"] < hist[0]["loss"]
