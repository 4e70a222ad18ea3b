"""What the ranks of ``tests/test_torch_tp_serve.py`` run: tensor-parallel
serving of the dense, vlm, MoE, ssm and encdec families on gloo ranks
(``dist.spmd.run_ranks``), so this module imports neither JAX nor the
reference.

One group of 4 runs ``serve_suite``: the cases on 4 ranks, then two
groups of 2 (ranks 0-1 and 2-3, each over a ``FileStore`` of its own)
the cases on 2.  Each case returns plain values and numpy arrays.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.dist.sharding import rank_param_bytes, serving_rows
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.models.forward import cast_params
from repro_torch.train import steps

#: sequences, prompt length (the smoke vlm's 16 patches and 8 tokens),
#: greedy tokens
B, P, G = 2, 24, 8

#: the cases: (arch, mesh (data, model), config overrides); those on
#: (1, 4) and (2, 2) run on 4 ranks, the rest on 2
CASES = {
    # Granite-34B's one KV head on every rank, 1 query head a rank
    "granite34_mqa_1x4": ("granite_34b", (1, 4), {}),
    # two data groups of two model ranks, one row of the batch each
    "llama_2x2": ("llama3_8b", (2, 2), {}),
    # MLA heads, 4 experts, one a rank (expert parallelism)
    "deepseek_1x4": ("deepseek_v2_lite", (1, 4), {}),
    # 6 experts on 4 ranks: each its block of every expert's hidden
    # columns (the F-split)
    "deepseek_e6_fsplit_1x4": ("deepseek_v2_lite", (1, 4),
                               {"n_experts": 6}),
    # Mamba-2's 8 SSD heads, 2 a rank: its gated norm over the ranks
    "mamba_1x4": ("mamba2_2p7b", (1, 4), {}),
    # Whisper's 4 heads, one a rank, encoder and cross-attention split
    "whisper_1x4": ("whisper_medium", (1, 4), {}),
    "llama_1x2": ("llama3_8b", (1, 2), {}),
    "qwen_bias_1x2": ("qwen2_7b", (1, 2), {}),
    "granite3_1x2": ("granite3_8b", (1, 2), {}),
    "granite34_mqa_1x2": ("granite_34b", (1, 2), {}),
    "llava_1x2": ("llava_next_34b", (1, 2), {}),
    "deepseek_1x2": ("deepseek_v2_lite", (1, 2), {}),
    # GQA 4/2 heads, 4 experts, two a rank
    "grok_1x2": ("grok1_314b", (1, 2), {}),
    "mamba_1x2": ("mamba2_2p7b", (1, 2), {}),
    "whisper_1x2": ("whisper_medium", (1, 2), {}),
}
#: the cases on 2 ranks, by the pair that runs them
PAIRS = (("llama_1x2", "qwen_bias_1x2", "granite3_1x2", "deepseek_1x2",
          "mamba_1x2"),
         ("granite34_mqa_1x2", "llava_1x2", "grok_1x2", "whisper_1x2"))


def model_of(case) -> tuple:
    """The model a case serves: (arch, its config overrides as sorted
    items), the key of its reference run."""
    arch, _, over = case
    return arch, tuple(sorted(over.items()))


def config(arch, over=()):
    """The float32 smoke config of ``arch``, with ``over`` (items)."""
    return dataclasses.replace(smoke_config(arch), compute_dtype="float32",
                               **dict(over))


def inputs(cfg) -> dict:
    """The prompts (and a vlm's patches, an encoder-decoder's frames),
    drawn as ``serve --arch`` draws them."""
    return serve.draw_inputs(cfg, B, P, 3)


def forced_logits(cfg, model, x, tokens, spmd=None) -> np.ndarray:
    """The prefill's logits and each decode step's, the steps fed
    ``tokens`` (B, G) (teacher forcing): (G, rows, V) for this rank's
    rows of the batch."""
    lo, hi = (0, B) if spmd is None else serving_rows(cfg, B, spmd)
    batch = {"tokens": torch.from_numpy(x["prompts"][lo:hi])}
    for name in ("patches", "frames"):
        if x[name] is not None:
            batch[name] = torch.from_numpy(x[name][lo:hi])
    logits, cache = steps.make_prefill_step(cfg, spmd)(model, batch)
    cache = serve.grow_cache(cfg, cache, P + G)
    step = steps.make_decode_step(cfg, spmd)
    out = [logits]
    for i in range(G - 1):
        _, logits, cache = step(model, cache,
                                torch.from_numpy(tokens[lo:hi, i]), P + i)
        out.append(logits)
    return np.stack([t.numpy() for t in out])


def run_case(case, tree, want_tokens) -> dict:
    """One case on this group's ranks: the model from the reference's
    ``tree`` at this rank's blocks, ``serve.generate`` (tokens, backend,
    graph, the cache this rank holds), the logits teacher-forced on the
    reference's tokens, the weight bytes held and the rank's place."""
    _, (dpn, mp), _ = case
    cfg = config(*model_of(case))
    mesh = make_host_mesh(mp)
    assert tuple(mesh.shape) == (dpn, mp), tuple(mesh.shape)
    spmd = steps.serving_spmd(cfg, mesh)
    model = cast_params(cfg, params_from_reference(cfg, tree, "cpu",
                                                   spmd.tp))
    x = inputs(cfg)
    res = serve.generate(cfg, model, x["prompts"], G, patches=x["patches"],
                         frames=x["frames"], spmd=spmd)
    return {"tokens": res["tokens"], "backend": res["backend"],
            "graph": res["graph"], "mesh": spmd.describe(),
            "coords": (spmd.dp_rank, spmd.model_rank),
            "rows": serving_rows(cfg, B, spmd),
            "cache": {k: v.numpy() for k, v in res["cache"].items()},
            "logits": forced_logits(cfg, model, x, want_tokens, spmd),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "param_bytes_want": rank_param_bytes(cfg, spmd.tp, 4),
            "leaf_shapes": {n: tuple(p.shape)
                            for n, p in model.named_parameters()}}


def _group(rank, world, path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)


def serve_suite(rank, world, trees, tokens, d):
    """Every rank check of ``test_torch_tp_serve.py``: the cases on 4
    ranks; the group ended, the cases on 2 in two groups of 2."""
    import torch.distributed as dist
    out = {}
    for name, case in CASES.items():
        if case[1][0] * case[1][1] == world:
            key = model_of(case)
            out[name] = run_case(case, trees[key], tokens[key])
    dist.barrier()
    dist.destroy_process_group()
    pair, prank = divmod(rank, 2)
    _group(prank, 2, os.path.join(d, f"pair{pair}"))
    for name in PAIRS[pair]:
        key = model_of(CASES[name])
        out[name] = run_case(CASES[name], trees[key], tokens[key])
    dist.barrier()
    dist.destroy_process_group()
    return out


def serve_main(rank, world, argv):
    """``launch.serve.main(argv)`` on a rank of a group ``run_ranks``
    started (the launcher serves over it): its tokens, and the kernels
    it launched."""
    from repro_torch.kernels._launch import LAUNCHES
    LAUNCHES.reset()
    tokens = serve.main(argv)
    return tokens, dict(LAUNCHES.by_kernel)
