"""What the ranks of the SPMD tests run (``tests/test_torch_spmd.py``,
``tests/test_torch_moe_ep.py``): functions ``dist.spmd.run_ranks`` starts
in processes of their own over gloo, so this module imports neither JAX
nor the reference.  Each returns numpy arrays and plain values.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, smoke_config
from repro_torch.data import make_batch_fn, shard_batch
from repro_torch.dist import moe_ep
from repro_torch.dist.sharding import NamedSharding
from repro_torch.dist.spmd import Layout, Spmd
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import common
from repro_torch.models.common import moe_layer
from repro_torch.models.convert import train_state_from_reference
from repro_torch.optim import AdamWHyper
from repro_torch.train import steps

#: the step cases: (arch, mesh (data, model), tensor parallel, moments,
#: moe_impl)
CASES = {
    "llama_2x2": ("llama3_8b", (2, 2), False, "float32", "gspmd"),
    "llama_4x1": ("llama3_8b", (4, 1), True, "float32", "gspmd"),
    "llama_2x2_int8": ("llama3_8b", (2, 2), False, "int8", "gspmd"),
    "deepseek_ep_1x4": ("deepseek_v2_lite", (1, 4), True, "float32",
                        "shard_map"),
    "deepseek_ep_2x2": ("deepseek_v2_lite", (2, 2), True, "float32",
                        "shard_map"),
}
#: the cases that split each step's batch into microbatches
ACCUM = {"llama_2x2_accum2": 2}
CASES["llama_2x2_accum2"] = ("llama3_8b", (2, 2), False, "float32", "gspmd")
B, S, STEPS = 4, 32, 3
HYPER = dict(lr=3e-3, warmup_steps=1, total_steps=10)


def config(arch, moments="float32", moe_impl="gspmd"):
    return dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                               opt_moment_dtype=moments, moe_impl=moe_impl)


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def gathered(state, sh) -> dict:
    """Every leaf of a sharded state as the global numpy array, by its
    checkpoint key."""
    from repro_torch.ckpt.checkpoint import _leaves
    return {k: _np(v) for k, v in _leaves(state, sh)}


def local_shapes(state) -> dict:
    from repro_torch.ckpt.checkpoint import _flatten, _local
    return {k: tuple(_local(v).shape) for k, v in _flatten(state)}


def _mesh(shape):
    mesh = make_host_mesh(shape[1])
    assert tuple(mesh.shape) == shape, (tuple(mesh.shape), shape)
    return mesh


def run_case(rank, arch, shape, tp, moments, impl, ref_state, accum=1):
    """Three sharded float32 steps from the reference's state: metrics,
    the state gathered, each leaf's layout and this rank's shapes."""
    common.set_tensor_parallel(tp)
    try:
        cfg = config(arch, moments, impl)
        state = train_state_from_reference(cfg, ref_state, "cpu")
        state, sh = steps.shard_train_state(cfg, state, _mesh(shape))
        step = steps.make_train_step(cfg, AdamWHyper(**HYPER), accum=accum,
                                     shardings=sh)
        get = make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))
        metrics = []
        for i in range(STEPS):
            state, m = step(state, shard_batch(get(i), "cpu"))
            metrics.append({k: float(m[k]) for k in
                            ("loss", "xent", "lr", "grad_norm")})
        layouts = {}
        from repro_torch.ckpt.checkpoint import _flatten, _lookup
        for k, _ in _flatten(state):
            lay = _lookup(sh, k)
            layouts[k] = (lay.shape, lay.dp_dim, lay.model_dim,
                          lay.local_shape(sh.spmd))
        out = {"metrics": metrics, "local": local_shapes(state),
               "layouts": layouts,
               "coords": (sh.spmd.dp_rank, sh.spmd.model_rank)}
        full = gathered(state, sh)
        if rank == 0:
            out["state"] = full
        return out
    finally:
        common.set_tensor_parallel(True)


def checkpoint_round_trip(rank, ref_state, d):
    """A state saved on (2, 2) (llama, int8, tensor parallelism off,
    after one step) into ``d/a``; restored on (4, 1) into a fresh state
    and saved again into ``d/b``."""
    from repro_torch.ckpt import restore, save
    common.set_tensor_parallel(False)
    try:
        cfg = config("llama3_8b", "int8")
        state = train_state_from_reference(cfg, ref_state, "cpu")
        state, sh = steps.shard_train_state(cfg, state, _mesh((2, 2)))
        step = steps.make_train_step(cfg, AdamWHyper(**HYPER), shardings=sh)
        get = make_batch_fn(cfg, ShapeConfig("t", S, B, "train"))
        state, _ = step(state, shard_batch(get(0), "cpu"))
        save(f"{d}/a", 1, state, {"arch": cfg.name}, shardings=sh)
        saved = gathered(state, sh)
        fresh = train_state_from_reference(cfg, ref_state, "cpu")
        fresh, sh41 = steps.shard_train_state(cfg, fresh, _mesh((4, 1)))
        fresh, at, extra = restore(f"{d}/a", fresh, shardings=sh41)
        save(f"{d}/b", 1, fresh, extra, shardings=sh41)
        restored = gathered(fresh, sh41)
        return {"at": at, "extra": extra,
                "saved": saved if rank == 0 else None,
                "restored": restored if rank == 0 else None}
    finally:
        common.set_tensor_parallel(True)


def meshes_and_placements(rank):
    """``make_host_mesh``'s best-effort rule, ``make_production_mesh``'s
    refusal, a dense config refused on a ``model`` axis with tensor
    parallelism on, and ``NamedSharding.placements`` against
    ``Layout``'s pieces (``distribute_tensor``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    out = {}
    m3 = make_host_mesh(3)
    out["host3"] = (tuple(m3.mesh_dim_names), tuple(m3.shape))
    m1 = make_host_mesh(1)
    out["host1"] = (tuple(m1.mesh_dim_names), tuple(m1.shape))
    try:
        make_production_mesh()
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    try:
        steps.shard_train_state(config("llama3_8b"),
                                steps.init_train_state(
                                    config("llama3_8b"), _model()), m3)
        out["dense_tp"] = None
    except NotImplementedError as e:
        out["dense_tp"] = str(e)
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    ns = NamedSharding(mesh, (("pod", "data"), None))
    pieces = distribute_tensor(full, mesh, ns.placements).to_local()
    spmd = Spmd(mesh)
    out["placements"] = [repr(p) for p in ns.placements]
    out["placement_piece"] = torch.equal(
        pieces, Layout((8, 6), 0, None).local(full, spmd))
    out["dp_rank"] = spmd.dp_rank
    return out


def _model():
    from repro_torch.models import init_params
    return init_params(config("llama3_8b"), torch.Generator().manual_seed(0),
                       "cpu")


def spmd_suite(rank, world, ref_states, d):
    """Every check of ``test_torch_spmd.py`` that needs ranks, in one
    group of 4."""
    out = {"cases": {}}
    for name, (arch, shape, tp, moments, impl) in CASES.items():
        out["cases"][name] = run_case(rank, arch, shape, tp, moments, impl,
                                      ref_states[name], ACCUM.get(name, 1))
    out["ckpt"] = checkpoint_round_trip(rank, ref_states["llama_2x2_int8"],
                                        d)
    out["meshes"] = meshes_and_placements(rank)
    return out


# ---------------------------------------------------------------------------
# the expert-parallel layer
# ---------------------------------------------------------------------------

def moe_inputs(E, k, seed=0):
    """The reference test's EP inputs (``tests/test_dist.py``): Grok's
    smoke config with E experts, top k, capacity factor 4, no shared
    experts, G 4 groups of 64 tokens."""
    cfg = dataclasses.replace(smoke_config("grok1_314b"), n_experts=E,
                              topk=k, capacity_factor=4.0,
                              n_shared_experts=0, compute_dtype="float32")
    rng = np.random.default_rng(seed)
    G, Tg, D, F = 4, 64, cfg.d_model, cfg.d_ff_moe
    x = (rng.standard_normal((G, Tg, D)) * 0.3).astype(np.float32)
    p = {"router": (rng.standard_normal((D, E)) * 0.3).astype(np.float32),
         "wg": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
         "wu": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
         "wd": (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32)}
    return cfg, x, p


def moe_layer_grads(cfg, x, p, layer):
    """(y, aux, gradients of sum(y²) + aux for x and every leaf of p)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    y, aux = layer(cfg, xt, pt)
    (torch.sum(y * y) + aux).backward()
    grads = {"x": _np(xt.grad)} | {n: _np(t.grad) for n, t in pt.items()}
    return _np(y), float(aux.detach()), grads


def moe_ep_ranks(rank, world, cases):
    """``moe_layer_ep`` on a (1, 4) mesh for each case (E, k): its output,
    load-balance term and gradients on this rank, with the experts given
    whole (replicated) and, on the EP path, as this rank's experts."""
    from repro_torch.dist.sharding import use_mesh
    mesh = make_host_mesh(world)
    out = {}
    with use_mesh(mesh):
        for tag, (E, k) in cases.items():
            cfg, x, p = moe_inputs(E, k)
            assert moe_ep.supported(cfg)
            out[tag] = moe_layer_grads(cfg, x, p, moe_ep.moe_layer_ep)
            if E % world == 0:
                El = E // world
                mine = {n: (a[rank * El:(rank + 1) * El]
                            if n in ("wg", "wu", "wd") else a)
                        for n, a in p.items()}
                out[tag + "_local"] = moe_layer_grads(
                    cfg, x, mine, moe_ep.moe_layer_ep)
    return out


def unsharded_moe(E, k):
    cfg, x, p = moe_inputs(E, k)
    return moe_layer_grads(cfg, x, p, moe_layer)
