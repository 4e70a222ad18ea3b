"""The port's SPMD slice against the JAX reference on the CPU: the
sharding builders (``dist.sharding``), the training meshes
(``launch.mesh``), the sharded train step (``train.steps``, FSDP2 over
gloo ranks), the re-sharding checkpoint (``ckpt.checkpoint``) and
``launch.train`` over a process group.

No process group is started in the pytest process: the ranks run in
processes of their own (``dist.spmd.run_ranks``, a ``FileStore`` in
``tmp_path``, one thread a rank, a timeout each), what they run in
``torch_spmd_ranks.py``, which imports no JAX; the checks that need
ranks share one group of 4 (``suite``).  The builders take the
reference's own abstract trees and a ``jax.sharding.AbstractMesh``.

Tolerances: the specs are equal.  The sharded steps, float32, against
the reference's unsharded step: losses and ``grad_norm`` 1e-5 relative
at every step; masters 1e-4 norm-relative (the port's unsharded step
itself lies up to ~3e-5 from the reference after three steps,
``test_torch_train.py`` holds it to 1e-4), and 1e-4 against the port's
unsharded step on the same inputs (the same sums in another order over
the ranks; an int8 moment crossing a rounding boundary moves one
quantization level); float32 moments 1e-4; int8
moments: q within one step, dequantized within one level and their
blocks' scales' difference.  Checkpoints
are bitwise.
"""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_spmd_ranks as ranks
from repro import models as ref_models
from repro import optim as ref_optim
from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import smoke_config as ref_smoke_config
from repro.dist import sharding as ref_sharding
from repro.train import steps as ref_steps
from repro_torch.ckpt import restore, save
from repro_torch.configs import ARCHS, ShapeConfig, smoke_config
from repro_torch.dist import sharding
from repro_torch.dist.spmd import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_launcher
from repro_torch.models import cache_shapes, init_params, model_shapes
from repro_torch.models.convert import train_state_from_reference
from repro_torch.models.forward import cache_pspec_rules
from repro_torch.optim import adamw as port_adamw
from repro_torch.train import steps
from torch_lm_parity import reference_tree
from torch_threads import capped_torch_threads  # noqa: F401

MESHES = [((8,), ("data",)), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MOMENTS = ("float32", "int8")


def rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(w)
    return float(np.linalg.norm(g - w) / (den if den > 0 else 1.0))


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference NamedSharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            tuple(leaf.spec) for path, leaf in flat}


def _port_specs(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _port_specs(v, f"{prefix}{k}/")
        else:
            out[prefix + str(k)] = v.spec
    return out


def _port_opt_shapes(cfg, shapes):
    def moment(s):
        if isinstance(s, dict):
            return {k: moment(v) for k, v in s.items()}
        if cfg.opt_moment_dtype != "int8":
            return s
        last = port_adamw._pad_to_block(s[-1]) if s else port_adamw.QBLOCK
        return {"q": s[:-1] + (last,),
                "scale": s[:-1] + (last // port_adamw.QBLOCK,)}
    return {"m": moment(shapes), "v": moment(shapes), "step": ()}


@pytest.mark.parametrize("mesh_shape,axes", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_builders_give_the_reference_specs(arch, mesh_shape, axes):
    """param/opt (float32 and int8)/batch/cache specs of every leaf, on
    the port's trees and on the reference's, equal the reference's."""
    amesh = AbstractMesh(mesh_shape, axes)
    pmesh = mesh_lib.make_mesh(mesh_shape, axes,
                               devices=["cpu"] * int(np.prod(mesh_shape)))
    for moments in MOMENTS:
        rcfg = dataclasses.replace(ref_smoke_config(arch),
                                   opt_moment_dtype=moments)
        cfg = dataclasses.replace(smoke_config(arch),
                                  opt_moment_dtype=moments)
        aps = ref_models.abstract_params(rcfg)
        want = _ref_specs(ref_sharding.param_pspecs(rcfg, aps, amesh))
        shapes = model_shapes(cfg)
        assert _port_specs(sharding.param_pspecs(cfg, shapes, pmesh)) == want
        assert _port_specs(sharding.param_pspecs(cfg, aps, pmesh)) == want
        oabs = ref_optim.abstract_opt_state(rcfg, aps)
        want = _ref_specs(ref_sharding.opt_pspecs(rcfg, oabs, amesh, aps))
        got = sharding.opt_pspecs(cfg, _port_opt_shapes(cfg, shapes), pmesh)
        assert _port_specs(got) == want
        # the port's leaves by name take their stacked leaf's spec
        pw = _ref_specs(ref_sharding.param_pspecs(rcfg, aps, amesh))
        flat = sharding.param_pspecs(cfg, init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), pmesh)
        for name, ns in flat.items():
            parts = name.split(".")
            want = pw[name] if len(parts) == 1 else \
                pw[f"{parts[0]}/{parts[2]}"][1:]
            assert ns.spec == want, name
    shape = RefShapeConfig("t", 64, 8, "train")
    babs = ref_steps.abstract_batch(rcfg, shape)
    want = _ref_specs(ref_sharding.batch_pspecs(rcfg, babs, amesh))
    pb = steps.abstract_batch(cfg, ShapeConfig("t", 64, 8, "train"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in pb.items()} == {
        k: (tuple(v.shape), getattr(torch, str(v.dtype)))
        for k, v in babs.items()}
    assert _port_specs(sharding.batch_pspecs(cfg, pb, pmesh)) == want
    for B in (8, 3):
        cabs = ref_models.abstract_cache(rcfg, B, 64)
        want = _ref_specs(ref_sharding.cache_pspecs(rcfg, cabs, amesh))
        got = sharding.cache_pspecs(cfg, cache_shapes(cfg, B, 64), pmesh)
        assert _port_specs(got) == want


def test_fsdp_entry_matches_the_reference_cases():
    """The reference's own cases (``tests/test_dist.py``), and a sweep of
    shapes and meshes against its ``_fsdp_entry``."""
    e = sharding._fsdp_entry
    dp = ("pod", "data")
    assert e((6, 64, 128), dp, 4, 1, False) == (None, None, dp)
    assert e((3, 5), dp, 4, 1, False) == (None, None)
    assert e((6, 64, 128), dp, 4, 2, True) == (None, "model", dp)
    assert e((8,), ("data",), 2, 1, False) == ("data",)
    rng = np.random.default_rng(0)
    for _ in range(200):
        shape = tuple(int(s) for s in rng.choice(
            [1, 2, 3, 4, 6, 8, 12, 16, 64, 100, 128], rng.integers(0, 4)))
        dpa = (("data",), ("pod", "data"))[rng.integers(2)]
        args = (dpa, int(rng.choice([1, 2, 4, 8])),
                int(rng.choice([1, 2, 4])), bool(rng.integers(2)))
        assert e(shape, *args) == tuple(ref_sharding._fsdp_entry(
            shape, *args)), (shape, args)


def test_mesh_helpers_take_both_kinds_and_the_ambient_mesh():
    m = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"),
                           devices=["cpu"] * 8)
    assert sharding.mesh_axis_sizes(m) == {"pod": 2, "data": 2, "model": 2}
    assert sharding.dp_axes(m) == ("pod", "data")
    assert sharding.axis_product(m, ("pod", "data")) == 4
    assert sharding.current_mesh() is None
    with sharding.use_mesh(m):
        assert sharding.current_mesh() is m
        from repro_torch.models import common
        assert common.pspec("dp", "tp", None) == (("pod", "data"), "model",
                                                  None)
        assert common.logical_axis_size("dp") == 4
        common.set_tensor_parallel(False)
        try:
            assert common.pspec("dp", "tp") == (("pod", "data", "model"),
                                                None)
            assert common.logical_axis_size("dp") == 8
        finally:
            common.set_tensor_parallel(True)
        x = torch.ones(3)
        assert common.constrain(x, "dp") is x
    assert sharding.current_mesh() is None
    assert common.logical_axis_size("dp") == 1


def test_cache_pspec_rules_are_the_reference_rules():
    from repro.models.forward import cache_pspec_rules as ref_rules
    for arch in ARCHS:
        assert cache_pspec_rules(smoke_config(arch)) == ref_rules(
            ref_smoke_config(arch))


# ---------------------------------------------------------------------------
# the sharded step, the checkpoint and the meshes on 4 gloo ranks
# ---------------------------------------------------------------------------

def _ref_state(rcfg, tree):
    cd = jnp.dtype(rcfg.compute_dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return {"params": params,
            "params_c": jax.tree_util.tree_map(lambda x: x.astype(cd),
                                               params),
            "opt": ref_optim.init_opt_state(rcfg, params)}


def _ref_run(arch, moments, accum=1):
    """The reference's unsharded step, three times: (initial state as
    numpy, metrics, final state)."""
    rcfg = dataclasses.replace(ref_smoke_config(arch),
                               compute_dtype="float32",
                               opt_moment_dtype=moments)
    st = _ref_state(rcfg, reference_tree(rcfg))
    init = jax.tree_util.tree_map(np.asarray, st)
    h = ref_optim.AdamWHyper(**ranks.HYPER)
    step = jax.jit(ref_steps.make_train_step(rcfg, h, accum=accum))
    cfg = ranks.config(arch, moments)
    get = ranks.make_batch_fn(cfg, ShapeConfig("t", ranks.S, ranks.B,
                                               "train"))
    metrics = []
    for i in range(ranks.STEPS):
        st, m = step(st, {k: jnp.asarray(v) for k, v in get(i).items()})
        metrics.append({k: float(m[k]) for k in
                        ("loss", "xent", "lr", "grad_norm")})
    return init, metrics, jax.tree_util.tree_map(np.asarray, st)


@pytest.fixture(scope="module")
def reference():
    runs = {}
    out = {}
    for name, (arch, _, _, moments, _) in ranks.CASES.items():
        key = (arch, moments, ranks.ACCUM.get(name, 1))
        if key not in runs:
            runs[key] = _ref_run(*key)
        out[name] = runs[key]
    return out


@pytest.fixture(scope="module")
def suite(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    inits = {name: r[0] for name, r in reference.items()}
    res = run_ranks(ranks.spmd_suite, 4, inits, str(d), timeout_s=240,
                    tmpdir=str(d))
    return res, d, inits


def _ref_leaf(tree, key: str):
    """The reference's array for a port checkpoint key
    (``params/layers.0.wq``, ``opt/m/layers.0.wq/q``, ``opt/step``)."""
    parts = key.split("/")
    node, rest = tree, parts
    if parts[0] == "opt" and parts[1] == "step":
        return np.asarray(tree["opt"]["step"])
    if parts[0] == "opt":
        node, rest = tree["opt"][parts[1]], parts[2:]
    else:
        node, rest = tree[parts[0]], parts[1:]
    name = rest[0].split(".")
    a = node[name[0]] if len(name) == 1 else node[name[0]][name[2]]
    if len(rest) > 1:
        a = a[rest[1]]
    a = np.asarray(a)
    return a if len(name) == 1 else a[int(name[1])]


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's own unsharded step from the same state, three times:
    its state by checkpoint key."""
    from repro_torch.ckpt.checkpoint import _flatten
    out = {}
    for name, (arch, _, _, moments, impl) in ranks.CASES.items():
        cfg = ranks.config(arch, moments, impl)
        state = train_state_from_reference(cfg, reference[name][0], "cpu")
        step = steps.make_train_step(cfg, ranks.AdamWHyper(**ranks.HYPER),
                                     accum=ranks.ACCUM.get(name, 1))
        get = ranks.make_batch_fn(cfg, ShapeConfig("t", ranks.S, ranks.B,
                                                   "train"))
        for i in range(ranks.STEPS):
            state, _ = step(state, ranks.shard_batch(get(i), "cpu"))
        out[name] = {k: ranks._np(t) for k, t in _flatten(state)}
    return out


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_sharded_steps_match_the_reference(suite, reference, unsharded,
                                           case):
    """Three float32 steps on gloo ranks against the reference's unsharded
    step: losses and ``grad_norm`` 1e-5 relative; masters 1e-4
    norm-relative to the reference (the port's unsharded step itself
    lies up to ~3e-5 from it after three steps: AdamW's normalised
    update magnifies the gradients' rounding where they are small) and
    to the port's unsharded step (measured up to 1.4e-5, the experts of
    the (2, 2) MoE run); float32 moments 1e-4 (the gradients' bound in
    ``test_torch_train.py``); int8 moments: q within
    one step, dequantized within one level and their scales'
    difference."""
    res, _, _ = suite
    _, want_metrics, want_state = reference[case]
    out = [r["cases"][case] for r in res]
    check_metrics([o["metrics"] for o in out], want_metrics)
    check_state(out[0]["state"], want_state, unsharded[case],
                ranks.CASES[case][3] == "int8")


def check_metrics(per_rank: list, want_metrics: list):
    """Every rank's metrics equal, and within 1e-5 of the reference's."""
    for i, (got, want) in enumerate(zip(per_rank[0], want_metrics)):
        for k in ("loss", "xent", "grad_norm", "lr"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (i, k)
    assert all(m == per_rank[0] for m in per_rank)


def check_state(state: dict, want_state, one: dict, int8: bool,
                near_one: bool = False):
    """A sharded run's gathered state (by checkpoint key) against the
    reference's and the port's unsharded run's (``one``), with the
    tolerances of ``test_sharded_steps_match_the_reference``.
    ``near_one``: a master may also lie as far from the reference as
    twice the port's unsharded run does, where that is more than 1e-4
    (``test_torch_tp.py``)."""
    for key, got in state.items():
        want = _ref_leaf(want_state, key)
        if key.startswith("params"):
            bound = max(1e-4, 2 * rel(one[key], want)) if near_one \
                else 1e-4
            assert rel(got, want) <= bound, key
            assert rel(got, one[key]) <= 1e-4, key
        elif key == "opt/step":
            assert int(got) == int(want) == ranks.STEPS
        elif not int8:
            assert rel(got, want) <= 1e-4, key
        elif key.endswith("/q"):
            # q within one step; dequantized, within one level plus what
            # the blocks' own scales differ by
            scale = _ref_leaf(want_state, key[:-2] + "/scale")
            gscale = state[key[:-2] + "/scale"]
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            blocks = lambda q: q.reshape(*q.shape[:-1], -1, 128).astype(
                np.float64)
            diff = np.abs(blocks(got) * gscale[..., None]
                          - blocks(want) * scale[..., None])
            bound = np.maximum(gscale, scale)[..., None] + np.abs(
                blocks(want)) * np.abs(gscale - scale)[..., None]
            assert np.all(diff <= 1.0001 * bound + 1e-12), key


@pytest.mark.parametrize("case", list(ranks.CASES))
def test_each_rank_stores_its_share_and_no_more(suite, case):
    """Each rank's piece of a leaf is the spec's share: the dims the
    data-parallel axes cut divided by their ranks (the experts' by the
    model ranks on the EP path), every other dim whole."""
    res, _, _ = suite
    arch, (dpn, mp), _, moments, impl = ranks.CASES[case]
    cfg = ranks.config(arch, moments, impl)
    amesh = AbstractMesh((dpn, mp), ("data", "model"))
    rcfg = dataclasses.replace(ref_smoke_config(arch),
                               opt_moment_dtype=moments)
    aps = ref_models.abstract_params(rcfg)
    pspec = _ref_specs(ref_sharding.param_pspecs(rcfg, aps, amesh))
    for r in res:
        got = r["cases"][case]
        for key, (shape, dp_dim, model_dim, local) in got["layouts"].items():
            assert got["local"][key] == tuple(local), key
            assert int(np.prod(local)) * (dpn if dp_dim is not None else 1) \
                * (mp if model_dim is not None else 1) == int(np.prod(shape))
            if key.startswith("params/"):
                name = key.split("/")[1].split(".")
                spec = pspec[name[0]] if len(name) == 1 else \
                    pspec[f"{name[0]}/{name[2]}"][1:]
                want = next((d for d, e in enumerate(spec)
                             if e == "data"), None)
                assert dp_dim == want, key
                expert = len(name) == 3 and name[0] == "layers" and \
                    name[2] in ("wg", "wu", "wd") and cfg.n_experts > 0
                assert model_dim == (0 if expert and mp > 1 else None), key


def test_checkpoint_reshards_and_its_files_are_an_unsharded_save(
        suite, tmp_path):
    res, d, inits = suite
    ck = res[0]["ckpt"]
    assert ck["at"] == 1 and ck["extra"] == {"arch": "llama3_8b_smoke"}
    saved, restored = ck["saved"], ck["restored"]
    assert saved.keys() == restored.keys()
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)

    def same_files(a, b):
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        match, mismatch, errors = filecmp.cmpfiles(a, b, names,
                                                   shallow=False)
        assert not mismatch and not errors, mismatch

    # re-saved from (4, 1): the same bytes
    same_files(d / "a" / "step_00000001", d / "b" / "step_00000001")
    # world 1, no process group: restored into an unsharded state, bitwise
    cfg = ranks.config("llama3_8b", "int8")
    state = train_state_from_reference(cfg, inits["llama_2x2_int8"], "cpu")
    state, at, extra = restore(d / "a", state)
    from repro_torch.ckpt.checkpoint import _flatten
    for k, t in _flatten(state):
        np.testing.assert_array_equal(ranks._np(t), saved[k], err_msg=k)
    save(tmp_path / "c", at, state, extra)
    same_files(d / "a" / "step_00000001", tmp_path / "c" / "step_00000001")


def test_meshes_placements_and_the_refused_dense_split(suite):
    """The meshes and placements; a dense config on a ``model`` axis of 2
    with tensor parallelism on, once refused, now takes a step split
    over the axis (each rank its block of the vocabulary), every rank
    with the same loss."""
    res, _, _ = suite
    for r, out in enumerate(res):
        m = out["meshes"]
        assert m["host3"] == (("data", "model"), (2, 2))
        assert m["host1"] == (("data", "model"), (4, 1))
        assert "needs a world of 256" in m["production"]
        tp = m["dense_tp"]
        assert tp["tensor_parallel"] == (2, r % 2)
        assert tp["vocab_block"] == [(0, 128), (128, 256)][r % 2]
        assert np.isfinite(tp["loss"])
        assert tp["loss"] == res[0]["meshes"]["dense_tp"]["loss"]
        assert m["placements"] == ["Shard(dim=0)", "Shard(dim=0)",
                                   "Replicate()"]
        assert m["placement_piece"] and m["dp_rank"] == r


# ---------------------------------------------------------------------------
# the launcher over a process group
# ---------------------------------------------------------------------------

def test_launch_train_over_four_ranks_resumes_on_another_mesh(tmp_path,
                                                              capfd):
    """``--nproc 4``: FSDP over (2, 2) with tensor parallelism off, a
    checkpoint every 3 steps; the run resumed from step 3 on (4, 1)
    trains steps 3-5 as the first did, within bfloat16's rounding (the
    smoke config computes in bfloat16, and the ranks sum its gradients
    in another order on the other mesh)."""
    flags = ["--arch", "llama3_8b", "--smoke", "--device", "cpu",
             "--steps", "6", "--batch", "4", "--seq", "32", "--log-every",
             "1", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3",
             "--nproc", "4"]
    first = train_launcher.main(flags + ["--model-parallel", "2",
                                         "--no-tensor-parallel"])
    out = capfd.readouterr().out
    assert "mesh: {'data': 2, 'model': 2}  devices=4" in out
    assert out.count("step     0 loss") == 1        # rank 0 prints
    assert len(first) == 6 and first[-1]["loss"] < first[0]["loss"]
    import shutil
    shutil.rmtree(tmp_path / "ck" / "step_00000006")
    again = train_launcher.main(flags + ["--resume"])
    out = capfd.readouterr().out
    assert "mesh: {'data': 4, 'model': 1}  devices=4" in out
    assert "resumed from step 3" in out
    assert [h["step"] for h in again] == [3, 4, 5]
    for a, b in zip(again, first[3:]):
        assert abs(a["loss"] - b["loss"]) <= 1e-3 * abs(b["loss"])


def test_launch_train_refuses_the_dense_split_with_tensor_parallelism(
        capfd):
    """The dense split, once refused, trains with tensor parallelism on
    over (2, 2); so does ``moe_impl="gspmd"`` on a ``model`` axis, once
    refused too: DeepSeek's smoke config over (1, 2)."""
    hist = train_launcher.main(["--arch", "llama3_8b", "--smoke", "--device",
                                "cpu", "--steps", "2", "--batch", "4",
                                "--seq", "32", "--model-parallel", "2",
                                "--nproc", "4"])
    out = capfd.readouterr().out
    assert "mesh: {'data': 2, 'model': 2}  devices=4" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    hist = train_launcher.main(["--arch", "deepseek_v2_lite", "--smoke",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "4", "--seq", "32",
                                "--model-parallel", "2", "--nproc", "2"])
    out = capfd.readouterr().out
    assert "mesh: {'data': 1, 'model': 2}  devices=2" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
