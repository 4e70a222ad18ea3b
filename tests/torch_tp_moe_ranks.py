"""What the ranks of ``tests/test_torch_tp_moe.py`` run: the MoE family's
tensor-parallel train step on gloo ranks (``dist.spmd.run_ranks``), so
this module imports neither JAX nor the reference.

One group of 4 runs ``tp_moe_suite``: the cases on 4 ranks and a
checkpoint saved on (2, 2) and restored on (1, 4); then two groups of 2
(ranks 0-1 and 2-3, each over a ``FileStore`` of its own) the cases on
2; then rank 0 alone the step on one rank (``model`` = 1).  Each case
returns plain values and numpy arrays.
"""
import os

import torch

import torch_spmd_ranks as spmd_ranks
import torch_tp_ranks as tp_ranks
from repro_torch.configs import ShapeConfig
from repro_torch.data import make_batch_fn, shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import train_state_from_reference
from repro_torch.optim import AdamWHyper
from repro_torch.train import steps

B, S, STEPS, HYPER = (spmd_ranks.B, spmd_ranks.S, spmd_ranks.STEPS,
                      spmd_ranks.HYPER)
#: the reference's own MoE configs place a second dim of every leaf on
#: ``model`` (``fsdp_only=False``); their smoke configs keep the default
MOE = {"fsdp_only": False}

#: the cases: (arch, mesh (data, model), moments, config overrides); the
#: first three run on 4 ranks, the rest on 2
CASES = {
    # 4 experts, one a rank: expert parallelism
    "deepseek_1x4": ("deepseek_v2_lite", (1, 4), "float32", MOE),
    "deepseek_2x2": ("deepseek_v2_lite", (2, 2), "float32", MOE),
    # 6 experts on 4 ranks: each rank its block of every expert's columns
    "deepseek_e6_fsplit_1x4": ("deepseek_v2_lite", (1, 4), "float32",
                               MOE | {"n_experts": 6}),
    "deepseek_1x2": ("deepseek_v2_lite", (1, 2), "float32", MOE),
    # GQA heads, int8 moments (its config's)
    "grok_int8_1x2": ("grok1_314b", (1, 2), "int8", MOE),
    "deepseek_shard_map_1x2": ("deepseek_v2_lite", (1, 2), "float32",
                               MOE | {"moe_impl": "shard_map"}),
    # tensor parallelism off (``NO_TP``): the rows over ``model``, and
    # ``shard_map``'s experts over it with the rest computed whole
    "deepseek_rows_1x2": ("deepseek_v2_lite", (1, 2), "float32", MOE),
    "deepseek_shard_map_no_tp_1x2": ("deepseek_v2_lite", (1, 2), "float32",
                                     MOE | {"moe_impl": "shard_map"}),
}
#: the cases that run with tensor parallelism off
NO_TP = ("deepseek_rows_1x2", "deepseek_shard_map_no_tp_1x2")
#: the cases on 2 ranks, by the pair that runs them
PAIRS = (("deepseek_1x2", "grok_int8_1x2"),
         ("deepseek_shard_map_1x2", "deepseek_rows_1x2",
          "deepseek_shard_map_no_tp_1x2"))
#: the cases whose first step's gradients are held leaf by leaf
GRADS = ("deepseek_1x4", "deepseek_e6_fsplit_1x4", "deepseek_1x2",
         "deepseek_shard_map_1x2")
#: the step on one rank, held bitwise to the unsharded step
ONE = ("deepseek_v2_lite", (1, 1), "float32", MOE)
#: the checkpoint: saved from this case's state, restored on (1, 4)
SAVED = "deepseek_2x2"


def config(arch, moments="float32", overrides=None):
    return tp_ranks.config(arch, moments, overrides)


def _pieces(state, sh) -> dict:
    """Each leaf of this rank's masters and moments, by checkpoint key:
    (its layout's global shape, dp dim, model dim, the bytes it holds)."""
    from repro_torch.ckpt.checkpoint import _flatten, _local, _lookup
    out = {}
    for k, t in _flatten(state):
        if k.startswith(("params/", "opt/m/", "opt/v/")):
            lay = _lookup(sh, k)
            t = _local(t)
            out[k] = (lay.shape, lay.dp_dim, lay.model_dim,
                      t.numel() * t.element_size())
    return out


def run_case(rank, case, ref_state, save_to=None, d=None, tp=True):
    """Three sharded float32 steps from the reference's state: metrics,
    the state gathered (rank 0 of the group), the mesh, this rank's
    pieces, its tensor-parallel block; ``save_to``: the state saved
    there after the steps; ``tp``: tensor parallelism on (else off, as
    ``launch.train --no-tensor-parallel``).  With int8 moments also
    ``forced``: for each step, the state after it gathered, beside the
    port's unsharded step from the same state before it (saved into
    ``d`` and restored on rank 0 with no shardings)."""
    from repro_torch.models import common
    common.set_tensor_parallel(tp)
    try:
        return _run_case(rank, case, ref_state, save_to, d)
    finally:
        common.set_tensor_parallel(True)


def _run_case(rank, case, ref_state, save_to, d):
    from repro_torch.ckpt import restore, save
    arch, shape, moments, over = case
    cfg = config(arch, moments, over)
    state = train_state_from_reference(cfg, ref_state, "cpu")
    mesh = make_host_mesh(shape[1])
    assert tuple(mesh.shape) == shape, (tuple(mesh.shape), shape)
    state, sh = steps.shard_train_state(cfg, state, mesh)
    step = steps.make_train_step(cfg, AdamWHyper(**HYPER), shardings=sh)
    get = make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))
    metrics, forced = [], []
    for i in range(STEPS):
        if moments == "int8":
            save(os.path.join(d, "forced"), i, state, {}, shardings=sh)
        state, m = step(state, shard_batch(get(i), "cpu"))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "xent", "lr", "grad_norm")})
        if moments == "int8":
            got = spmd_ranks.gathered(state, sh)
            if rank == 0:
                one = train_state_from_reference(cfg, ref_state, "cpu")
                one, _, _ = restore(os.path.join(d, "forced"), one, step=i)
                one, _ = steps.make_train_step(cfg, AdamWHyper(**HYPER))(
                    one, shard_batch(get(i), "cpu"))
                forced.append((got, _flat_np(one)))
    tp = sh.tp
    out = {"metrics": metrics, "mesh": sh.spmd.describe(),
           "pieces": _pieces(state, sh), "forced": forced,
           "tensor_parallel": None if tp is None else (tp.n, tp.rank)}
    if save_to is not None:
        save(save_to, STEPS, state, {"arch": cfg.name}, shardings=sh)
    full = spmd_ranks.gathered(state, sh)
    if rank == 0:
        out["state"] = full
    return out


def _flat_np(state) -> dict:
    from repro_torch.ckpt.checkpoint import _flatten
    return {k: spmd_ranks._np(t) for k, t in _flatten(state)}


def restored(rank, case, ref_state, path):
    """The checkpoint at ``path`` restored into a fresh state sharded on
    (1, 4), gathered (rank 0)."""
    from repro_torch.ckpt import restore
    arch, _, moments, over = case
    cfg = config(arch, moments, over)
    state = train_state_from_reference(cfg, ref_state, "cpu")
    state, sh = steps.shard_train_state(cfg, state, make_host_mesh(4))
    state, at, _ = restore(path, state, shardings=sh)
    full = spmd_ranks.gathered(state, sh)
    return {"at": at, "mesh": sh.spmd.describe(),
            "state": full if rank == 0 else None}


def grads(rank, name, ref_states):
    arch, shape, moments, over = CASES[name]
    return tp_ranks.first_grads(
        rank, config(arch, moments, over), shape[1],
        lambda cfg: train_state_from_reference(cfg, ref_states[name], "cpu"))


def one_rank(ref_state):
    """The step on a (1, 1) mesh, tensor parallelism on, and the
    unsharded step from the same state, in this process: whether every
    loss, gradient norm and leaf is bitwise equal."""
    arch, shape, moments, over = ONE
    cfg = config(arch, moments, over)
    got = run_case(0, ONE, ref_state)
    state = train_state_from_reference(cfg, ref_state, "cpu")
    step = steps.make_train_step(cfg, AdamWHyper(**HYPER))
    get = make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))
    metrics = []
    for i in range(STEPS):
        state, m = step(state, shard_batch(get(i), "cpu"))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "xent", "lr", "grad_norm")})
    want = _flat_np(state)
    differ = [k for k, a in got["state"].items()
              if a.tobytes() != want[k].tobytes()]
    return {"mesh": got["mesh"], "metrics_equal": got["metrics"] == metrics,
            "differ": differ, "leaves": len(want)}


def tp_moe_suite(rank, world, ref_states, d):
    """Every rank check of ``test_torch_tp_moe.py``: the cases on 4 ranks
    and the checkpoint; the group ended, the cases on 2 in two groups of
    2; the group ended, the step on rank 0 alone."""
    import torch.distributed as dist
    torch.manual_seed(0)
    out = {"cases": {}, "grads": {}}
    ck = os.path.join(d, "ck")
    for name, case in CASES.items():
        if case[1][0] * case[1][1] == world:
            out["cases"][name] = run_case(
                rank, case, ref_states[name],
                ck if name == SAVED else None, d)
    out["restored"] = restored(rank, CASES[SAVED], ref_states[SAVED], ck)
    for name in GRADS:
        if CASES[name][1][1] == world:
            out["grads"][name] = grads(rank, name, ref_states)
    dist.barrier()
    dist.destroy_process_group()
    pair, prank = divmod(rank, 2)
    tp_ranks._group(prank, 2, os.path.join(d, f"pair{pair}"))
    for name in PAIRS[pair]:
        out["cases"][name] = run_case(prank, CASES[name], ref_states[name],
                                      d=os.path.join(d, f"pair{pair}_ck"),
                                      tp=name not in NO_TP)
        if name in GRADS:
            out["grads"][name] = grads(prank, name, ref_states)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        tp_ranks._group(0, 1, os.path.join(d, "one"))
        out["one"] = one_rank(ref_states["deepseek_1x2"])
        dist.destroy_process_group()
    return out


def on_the_card(rank, world, n_experts):
    """DeepSeek's smoke shapes in float32 with ``n_experts`` experts,
    three steps on the card over (1, ``world``) gloo ranks that share
    it, from ``launch.train.build_state``'s seed-0 state: (losses, the
    masters gathered on rank 0, this rank's launches)."""
    from repro_torch.core import LAUNCHES
    from repro_torch.launch.train import build_state
    cfg = config("deepseek_v2_lite", "float32",
                 MOE | {"n_experts": n_experts})
    state, sh = steps.shard_train_state(cfg, build_state(cfg, 0, "cuda"),
                                        make_host_mesh(world, "cuda"))
    step = steps.make_train_step(cfg, AdamWHyper(**HYPER), shardings=sh)
    get = make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))
    LAUNCHES.reset()
    losses = []
    for i in range(STEPS):
        state, m = step(state, shard_batch(get(i), "cuda"))
        losses.append(float(m["loss"]))
    launches = dict(LAUNCHES.by_kernel)
    full = spmd_ranks.gathered(state, sh)
    masters = {k: v for k, v in full.items() if k.startswith("params/")}
    return losses, masters if rank == 0 else None, launches
