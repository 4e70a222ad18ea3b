"""What the ranks of ``tests/test_torch_tp.py`` run: the tensor-parallel
train step of the dense family on gloo ranks (``dist.spmd.run_ranks``),
so this module imports neither JAX nor the reference.

One group of 4 runs ``tp_suite``: the cases on 4 ranks, then two groups
of 2 (ranks 0-1 and 2-3, each over a ``FileStore`` of its own) the
cases on 2, then rank 0 alone the step on one rank (``model`` = 1).
Each case returns plain values and numpy arrays.
"""
import dataclasses
import os

import torch

import torch_spmd_ranks as spmd_ranks
from repro_torch.configs import ShapeConfig
from repro_torch.data import make_batch_fn, shard_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import forward
from repro_torch.models.convert import train_state_from_reference
from repro_torch.optim import AdamWHyper
from repro_torch.train import steps

B, S, STEPS, HYPER = (spmd_ranks.B, spmd_ranks.S, spmd_ranks.STEPS,
                      spmd_ranks.HYPER)

#: the cases: (arch, mesh (data, model), moments, config overrides); the
#: first run on 4 ranks, the rest on 2
CASES = {
    "llama_2x2": ("llama3_8b", (2, 2), "float32", {}),
    # one query head a rank: 4 ranks read 2 KV heads, two ranks each
    "llama_1x4": ("llama3_8b", (1, 4), "float32", {}),
    "llama_2x2_int8": ("llama3_8b", (2, 2), "int8", {}),
    "llama_1x2": ("llama3_8b", (1, 2), "float32", {}),
    "qwen_bias_1x2": ("qwen2_7b", (1, 2), "float32", {}),
    "granite34_mqa_1x2": ("granite_34b", (1, 2), "float32", {}),
    # 255 columns over 2 ranks: blocks of 128 and 127
    "llama_vocab255_1x2": ("llama3_8b", (1, 2), "float32", {"vocab": 255}),
}
#: the cases on 2 ranks, by the pair that runs them
PAIRS = (("llama_1x2", "qwen_bias_1x2"),
         ("granite34_mqa_1x2", "llama_vocab255_1x2"))
#: the cases whose first step's gradients are held leaf by leaf
GRADS = ("llama_2x2", "llama_1x4")
#: the step on one rank, held bitwise to the unsharded step
ONE = ("llama3_8b", (1, 1), "float32", {})


def config(arch, moments="float32", overrides=None):
    return dataclasses.replace(spmd_ranks.config(arch, moments),
                               **(overrides or {}))


class held_shapes:
    """Within the block, the shapes of the residual stream each decoder
    layer returns and of the logits ``forward.unembed`` returns, on the
    first forward."""

    def __init__(self, model):
        self.model, self.residual, self.logits = model, [], None

    def __enter__(self):
        def layer(mod, args, out):
            if len(self.residual) < len(self.model.layers):
                self.residual.append(tuple(out[0].shape))
        self.hooks = [lp.register_forward_hook(layer)
                      for lp in self.model.layers]
        self.unembed = forward.unembed

        def unembed(*a, **k):
            out = self.unembed(*a, **k)
            if self.logits is None:
                self.logits = tuple(out.shape)
            return out
        forward.unembed = unembed
        return self

    def __exit__(self, *exc):
        forward.unembed = self.unembed
        for h in self.hooks:
            h.remove()


def run_case(rank, case, ref_state):
    """Three sharded float32 steps from the reference's state: metrics,
    the state gathered (rank 0 of the group), the mesh coordinates, the
    tensor-parallel block of this rank's vocabulary and the shapes it
    held."""
    arch, shape, moments, over = case
    cfg = config(arch, moments, over)
    state = train_state_from_reference(cfg, ref_state, "cpu")
    mesh = make_host_mesh(shape[1])
    assert tuple(mesh.shape) == shape, (tuple(mesh.shape), shape)
    state, sh = steps.shard_train_state(cfg, state, mesh)
    step = steps.make_train_step(cfg, AdamWHyper(**HYPER), shardings=sh)
    get = make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))
    metrics = []
    with held_shapes(state["params_c"]) as held:
        for i in range(STEPS):
            state, m = step(state, shard_batch(get(i), "cpu"))
            metrics.append({k: float(m[k]) for k in
                            ("loss", "xent", "lr", "grad_norm")})
    tp = sh.tp
    out = {"metrics": metrics, "residual": held.residual,
           "logits": held.logits, "mesh": sh.spmd.describe(),
           "coords": (sh.spmd.dp_rank, sh.spmd.model_rank),
           "vocab_block": None if tp is None else tp.block(cfg.vocab)}
    full = spmd_ranks.gathered(state, sh)
    if rank == 0:
        out["state"] = full
    return out


class captured_grads:
    """Within the block, the float32 gradients each train step hands
    ``optim.apply_adamw`` (after every sum over the ranks), the last
    step's in ``grads`` (this rank's pieces)."""

    def __enter__(self):
        self.apply, self.grads = steps.apply_adamw, None

        def apply(cfg, hyper, params, grads, opt, shardings=None):
            self.grads = {n: g.clone() for n, g in grads.items()}
            return self.apply(cfg, hyper, params, grads, opt,
                              shardings=shardings)
        steps.apply_adamw = apply
        return self

    def __exit__(self, *exc):
        steps.apply_adamw = self.apply


def first_grads(rank, cfg, model_parallel: int, make_state, tp=True):
    """The gradients of ``cfg``'s first step on ``make_host_mesh(
    model_parallel)`` (tensor parallelism on or off) from the state
    ``make_state(cfg)`` builds, gathered; on rank 0 of the group each
    leaf's norm-relative distance from the unsharded step's gradients
    from the same state, taken in this process."""
    from repro_torch.models import common
    batch = shard_batch(make_batch_fn(cfg, ShapeConfig("t", S, B,
                                                       "train"))(0), "cpu")
    common.set_tensor_parallel(tp)
    try:
        state, sh = steps.shard_train_state(cfg, make_state(cfg),
                                            make_host_mesh(model_parallel))
        with captured_grads() as got:
            steps.make_train_step(cfg, AdamWHyper(**HYPER),
                                  shardings=sh)(state, batch)
        grads = {n: sh.tree["params"][n].gather(g, sh.spmd)
                 for n, g in got.grads.items()}
    finally:
        common.set_tensor_parallel(True)
    if rank:
        return None
    with captured_grads() as want:
        steps.make_train_step(cfg, AdamWHyper(**HYPER))(make_state(cfg),
                                                        batch)
    return {n: float((grads[n] - w).norm() / w.norm().clamp_min(1e-30))
            for n, w in want.grads.items()}


def _group(rank, world, path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)


def one_rank(ref_state):
    """The step on a (1, 1) mesh, tensor parallelism on, and the
    unsharded step from the same state, in this process: whether every
    loss, gradient norm and leaf is bitwise equal."""
    from repro_torch.ckpt.checkpoint import _flatten
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
    want = {k: spmd_ranks._np(t) for k, t in _flatten(state)}
    differ = [k for k, a in got["state"].items()
              if a.tobytes() != want[k].tobytes()]
    return {"mesh": got["mesh"], "metrics_equal": got["metrics"] == metrics,
            "differ": differ, "leaves": len(want)}


def tp_suite(rank, world, ref_states, d):
    """Every rank check of ``test_torch_tp.py``: the cases on 4 ranks;
    the group ended, the cases on 2 in two groups of 2; the group ended,
    the step on rank 0 alone."""
    import torch.distributed as dist
    torch.manual_seed(0)
    out = {"cases": {}, "grads": {}}
    for name, case in CASES.items():
        if case[1][0] * case[1][1] == world:
            out["cases"][name] = run_case(rank, case, ref_states[name])
    for name in GRADS:
        arch, shape, moments, over = CASES[name]
        out["grads"][name] = first_grads(
            rank, config(arch, moments, over), shape[1],
            lambda cfg: train_state_from_reference(cfg, ref_states[name],
                                                   "cpu"))
    dist.barrier()
    dist.destroy_process_group()
    pair, prank = divmod(rank, 2)
    _group(prank, 2, os.path.join(d, f"pair{pair}"))
    for name in PAIRS[pair]:
        out["cases"][name] = run_case(prank, CASES[name], ref_states[name])
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        _group(0, 1, os.path.join(d, "one"))
        out["one"] = one_rank(ref_states["llama_1x2"])
        dist.destroy_process_group()
    return out
