"""The decoders of every family, driven by the config: parameter shapes,
initialisation, attention (GQA, with cross-attention, a sliding window
and no rope where asked, and DeepSeek's MLA) and the layer body, from the
reference's ``repro.models.model``.

The reference keeps its parameters in a nested dict whose ``layers`` (and
``head_layers``, an MoE model's dense layers ahead of its MoE stack, and
``enc_layers``, Whisper's encoder) are stacked ``(L, ...)`` for
``lax.scan``; the port keeps them in an ``LM`` module under the same leaf
names, unstacked: one ``nn.ParameterDict`` a layer, walked by a Python
loop.  The functions read parameters as the reference does (``p["wq"]``).
The parameters take no gradient, but in a training copy (``LM.map``,
``train.steps.init_train_state``).

On the card, ``decode_gqa_attention`` runs K5 over the layer's cache slab
in place, attending its first ``kv_len`` rows.  MLA's absorbed decode
(``mla_decode_attention``) attends a latent of r + rd = 576 columns
against values of r = 512 (DeepSeek-V2-Lite), which K5 (d ≤ 256, equal
key and value widths) does not take: it is plain PyTorch, as the
reference's is plain JAX.

Every family of the reference runs (``dense``, ``vlm``, ``moe``, ``ssm``,
``hybrid``, ``encdec``).  MLA outside the MoE family and a sliding window
outside the hybrid family (no config uses either) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..core.codegen import resolve_device
from ..kernels import ops
from . import ssm as ssm_lib
from .common import (apply_norm, blockwise_attention, mlp, moe_layer, rmsnorm,
                     rope, tensor_parallel)

#: the kind of a family's main stack of layers
KINDS = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
         "hybrid": "hybrid", "encdec": "dec"}


def check_family(cfg):
    """Raise for a config the port has no path for: an unknown family
    (``ValueError``, as the reference's ``model_shapes``), MLA outside the
    MoE family or a sliding window outside the hybrid family
    (``NotImplementedError``): the one gate of the model's entry points."""
    if cfg.family not in KINDS:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.kv_lora_rank and cfg.family != "moe":
        raise NotImplementedError(
            f"{cfg.name}: MLA runs in the moe family only (ROADMAP.md)")
    if cfg.window and cfg.family != "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention (window {cfg.window}) "
            f"runs in the hybrid family only, over its ring cache; no "
            f"{cfg.family} config uses one (ROADMAP.md)")


def main_kind(cfg) -> str:
    """The kind of the main stack's layers: ``dense``, ``moe``, ``ssm``,
    ``hybrid`` or ``dec`` (Whisper's decoder)."""
    return KINDS[cfg.family]


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------

def _attn_shapes(cfg):
    D, dh, Hq, Hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    if cfg.kv_lora_rank:                                  # MLA
        r = cfg.kv_lora_rank
        return {"wq": (D, Hq * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
                "w_dkv": (D, r), "w_kr": (D, cfg.qk_rope_dim),
                "w_uk": (r, Hq * cfg.qk_nope_dim),
                "w_uv": (r, Hq * cfg.v_head_dim),
                "wo": (Hq * cfg.v_head_dim, D)}
    s = {"wq": (D, Hq * dh), "wk": (D, Hkv * dh), "wv": (D, Hkv * dh),
         "wo": (Hq * dh, D)}
    if cfg.qkv_bias:
        s |= {"bq": (Hq * dh,), "bk": (Hkv * dh,), "bv": (Hkv * dh,)}
    return s


def _mlp_shapes(cfg, ff):
    D = cfg.d_model
    if cfg.act == "swiglu":
        return {"wg": (D, ff), "wu": (D, ff), "wd": (ff, D)}
    return {"wu": (D, ff), "wd": (ff, D)}


def _norm_shapes(cfg, prefix):
    if cfg.norm == "layernorm":
        return {f"{prefix}_g": (cfg.d_model,), f"{prefix}_b": (cfg.d_model,)}
    return {f"{prefix}_g": (cfg.d_model,)}


def _moe_shapes(cfg):
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_moe
    s = {"router": (D, E), "wg": (E, D, F), "wu": (E, D, F), "wd": (E, F, D)}
    if cfg.n_shared_experts:
        fs = F * cfg.n_shared_experts
        s |= {"wg_s": (D, fs), "wu_s": (D, fs), "wd_s": (fs, D)}
    return s


def layer_shapes(cfg, kind: str = "dense"):
    """One layer's leaves; ``kind``: ``dense`` (the MLP), ``moe``,
    ``ssm`` (the SSD mixer alone, ``ssm_*``), ``hybrid`` (attention and
    the mixer side by side, ``mix_*_g`` their norms), ``enc`` (Whisper's
    encoder) or ``dec`` (its decoder: ``lnx_*`` and cross-attention
    ``x_*``)."""
    s = _norm_shapes(cfg, "ln1")
    ssm = {f"ssm_{k}": v for k, v in ssm_lib.ssm_param_shapes(cfg).items()}
    if kind == "ssm":
        return s | ssm
    s |= _attn_shapes(cfg)
    if kind == "hybrid":
        s |= ssm | {"mix_attn_g": (cfg.d_model,), "mix_ssm_g": (cfg.d_model,)}
    if kind == "dec":
        s |= _norm_shapes(cfg, "lnx")
        s |= {f"x_{k}": v for k, v in _attn_shapes(cfg).items()}
    s |= _norm_shapes(cfg, "ln2")
    return s | (_moe_shapes(cfg) if kind == "moe"
                else _mlp_shapes(cfg, cfg.d_ff))


def model_shapes(cfg) -> dict:
    """The reference's shape tree: ``embed``, ``unembed`` (unless tied),
    the final norm, ``layers`` stacked ``(L - first_dense_layers, ...)``,
    where ``cfg.first_dense_layers`` the dense ``head_layers`` stacked
    ``(first_dense_layers, ...)``, and for Whisper the encoder's
    ``enc_layers`` stacked ``(encoder_layers, ...)``, its positions
    ``enc_pos`` (encoder_frames, D) and its final norm ``encf_*``."""
    check_family(cfg)
    D = cfg.d_model
    tree: dict[str, Any] = {"embed": (cfg.vocab, D)}
    if not cfg.tie_embeddings:
        tree["unembed"] = (D, cfg.vocab)
    tree |= _norm_shapes(cfg, "final")
    n_main = cfg.n_layers - cfg.first_dense_layers
    tree["layers"] = {k: (n_main,) + v
                      for k, v in layer_shapes(cfg, main_kind(cfg)).items()}
    if cfg.first_dense_layers:
        tree["head_layers"] = {
            k: (cfg.first_dense_layers,) + v
            for k, v in layer_shapes(cfg, "dense").items()}
    if cfg.family == "encdec":
        tree["enc_layers"] = {k: (cfg.encoder_layers,) + v
                              for k, v in layer_shapes(cfg, "enc").items()}
        tree["enc_pos"] = (cfg.encoder_frames, D)
        tree |= {f"encf_{k[6:]}": v
                 for k, v in _norm_shapes(cfg, "final").items()}
    return tree


# ---------------------------------------------------------------------------
# the parameters
# ---------------------------------------------------------------------------

def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.ParameterDict):
    """One layer's parameters by leaf name, callable: ``layer(fn, *args)``
    runs ``fn(layer, *args)`` through ``nn.Module.__call__``, so that a
    module hook (FSDP's gather of the layer's shards before and its
    reduction of their gradients after) wraps the layer's use."""

    __call__ = nn.Module.__call__

    def forward(self, fn, *args):
        return fn(self, *args)


class LM(nn.Module):
    """A model's parameters under the reference's leaf names: ``embed``,
    ``unembed`` (unless tied), ``final_g`` (and ``final_b`` for
    layernorm), ``layers``, one ``nn.ParameterDict`` a layer (``ln1_g``;
    ``wq``, ``wk``, ``wv``, ``wo``, ``bq``/``bk``/``bv`` or MLA's ``wq``,
    ``w_dkv``, ``w_kr``, ``w_uk``, ``w_uv``, ``wo``; the SSD mixer's
    ``ssm_*`` and a hybrid's ``mix_attn_g``/``mix_ssm_g``; a Whisper
    decoder's ``lnx_*`` and ``x_wq``/``x_wk``/``x_wv``/``x_wo``;
    ``ln2_g``; ``wg``, ``wu``, ``wd`` or the MoE's ``router``,
    ``wg``/``wu``/``wd`` of (E, ·, ·) and ``wg_s``/``wu_s``/``wd_s``),
    ``head_layers``, the dense layers ahead of an MoE stack, and
    ``enc_layers``, Whisper's encoder, with its ``enc_pos`` and
    ``encf_*`` (none for the other families).  ``model["embed"]`` reads
    a top-level leaf as the reference reads its tree."""

    def __init__(self, cfg, top: dict, layers: list, head_layers=(),
                 enc_layers=()):
        super().__init__()
        self.cfg = cfg
        for name, t in top.items():
            self.register_parameter(name, _frozen(t))

        def stack(lps):
            return nn.ModuleList(
                Layer({k: _frozen(t) for k, t in lp.items()})
                for lp in lps)
        self.head_layers = stack(head_layers)
        self.layers = stack(layers)
        self.enc_layers = stack(enc_layers)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def forward(self, fn, *args):
        """``model(fn, *args)`` runs ``fn(model, *args)`` through
        ``nn.Module.__call__`` (as ``Layer``)."""
        return fn(self, *args)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def stacks(self):
        """Every decoder layer with its kind, in the order of the cache's
        index: the dense head layers, then the main stack."""
        return ([(lp, "dense") for lp in self.head_layers]
                + [(lp, main_kind(self.cfg)) for lp in self.layers])

    def leaves(self) -> dict:
        """Every parameter's tensor by name (``named_parameters``):
        ``embed``, ``layers.0.wq``, ..."""
        return {n: p.data for n, p in self.named_parameters()}

    def map(self, fn, requires_grad: bool = False) -> "LM":
        """A new ``LM`` of the same config whose leaves are ``fn(leaf)``,
        taking gradients where ``requires_grad`` (a training copy)."""
        def stack(lps):
            return [{k: fn(t.data) for k, t in lp.items()} for lp in lps]
        out = LM(self.cfg, {n: fn(getattr(self, n).data)
                            for n, _ in self.named_parameters(recurse=False)},
                 stack(self.layers), stack(self.head_layers),
                 stack(self.enc_layers))
        return out.requires_grad_(requires_grad)


def _stack_sizes(cfg) -> dict:
    """The stacks of the parameter tree, by name, with their layer
    counts."""
    return {"layers": cfg.n_layers - cfg.first_dense_layers,
            "head_layers": cfg.first_dense_layers,
            "enc_layers": cfg.encoder_layers if cfg.family == "encdec"
            else 0}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(cfg, generator: torch.Generator, device="cuda",
                dtype=None) -> LM:
    """Random parameters at the config's shapes on ``device``: ones for
    ``*_g`` and ``ssm_D_skip``, zeros for biases (``*_b``, ``b*``),
    ``ssm_dt_bias`` and ``ssm_A_log``, ``0.02 · N(0, 1)`` from
    ``generator`` (on ``device``) otherwise, as the reference's
    ``init_params``, each drawn in ``cfg.param_dtype`` and, where
    ``dtype`` is given, cast to it at once: the same numbers as drawing
    them all and then casting (``forward.cast_params``), with one leaf
    in ``param_dtype`` at a time.  The numbers are not the reference's:
    its ``jax.random`` key draws others."""
    dev = resolve_device(device)
    drawn = _dtype(cfg.param_dtype)
    dtype = drawn if dtype is None else dtype

    def leaf(name, shape):
        if name.endswith("_g") or name == "ssm_D_skip":
            t = torch.ones(shape, dtype=drawn, device=dev)
        elif (name.endswith("_b") or name.startswith("b")
              or name in ("ssm_dt_bias", "ssm_A_log")):
            t = torch.zeros(shape, dtype=drawn, device=dev)
        else:
            t = torch.randn(shape, generator=generator, dtype=drawn,
                            device=dev).mul_(0.02)
        return t.to(dtype)

    shapes = model_shapes(cfg)
    sizes = _stack_sizes(cfg)
    stacked = {name: shapes.pop(name, {}) for name in sizes}
    top = {k: leaf(k, s) for k, s in shapes.items()}
    stacks = {name: [{k: leaf(k, s[1:]) for k, s in stacked[name].items()}
                     for _ in range(sizes[name])]
              for name in ("head_layers", "layers", "enc_layers")}
    return LM(cfg, top, **stacks)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def step_positions(pos, B: int, device) -> torch.Tensor:
    """The (B, 1) positions of a decode step at ``pos``: a host integer,
    or a 0-d integer tensor on the device, expanded (its value never
    reaches the host, so a captured step serves every position)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1, 1).expand(B, 1)
    return torch.full((B, 1), pos, device=device)


def tp_heads(cfg, tp):
    """A tensor-parallel rank's block of the query heads, (q0, q1), and
    the KV heads those read, (kv0, kv1) (``train.steps.
    tensor_parallel_split`` holds the block to whole groups of G query
    heads a KV head, or to part of one)."""
    G = cfg.n_heads // cfg.n_kv_heads
    q0, q1 = tp.block(cfg.n_heads)
    return (q0, q1), (q0 // G, (q1 - 1) // G + 1)


def gqa_attention(cfg, x, p, *, kv_x=None, causal=True, window=0,
                  use_rope=True, prefix="", tp=None):
    """(G)QA attention over the sequence from position 0 (prefill):
    queries from x, keys and values from ``kv_x`` (x unless given: a
    Whisper decoder's cross-attention reads the encoder's output), the
    ``prefix``'s weights (``x_`` for cross-attention; the QKV bias only
    without one), rope where ``use_rope``, a ``causal`` mask and a
    sliding ``window`` where asked.  Returns (out, (k, v)), k after
    rope, for the cache.

    ``tp`` (a ``TensorParallel``, self-attention): this rank's block of
    the query heads (the reference's ``tp`` on q's heads), K and V for
    the KV heads those read alone (all of them on each rank that reads
    one: MQA computes its one head everywhere), ``wo``'s rows of those
    heads; the result is this rank's partial sum, the cache pieces its
    heads'."""
    B, S, _ = x.shape
    dh, Hq, Hkv = cfg.dh, cfg.n_heads, cfg.n_kv_heads
    kv_x = x if kv_x is None else kv_x
    wq, wk, wv, wo = (p[prefix + n] for n in ("wq", "wk", "wv", "wo"))
    bias = cfg.qkv_bias and not prefix
    if bias:
        bq, bk, bv = p["bq"], p["bk"], p["bv"]
    if tp is not None:
        (q0, q1), (kv0, kv1) = tp_heads(cfg, tp)
        cq, ckv = slice(q0 * dh, q1 * dh), slice(kv0 * dh, kv1 * dh)
        wq, wk, wv, wo = wq[:, cq], wk[:, ckv], wv[:, ckv], wo[cq]
        if bias:
            bq, bk, bv = bq[cq], bk[ckv], bv[ckv]
        Hq, Hkv = q1 - q0, kv1 - kv0
    q, k, v = x @ wq, kv_x @ wk, kv_x @ wv
    if bias:
        q, k, v = q + bq, k + bk, v + bv
    q = _split_heads(q, Hq, dh)
    k = _split_heads(k, Hkv, dh)
    v = _split_heads(v, Hkv, dh)
    if use_rope:
        positions = torch.arange(S, device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=causal, window=window)
    return o.reshape(B, S, Hq * dh) @ wo, (k, v)


def decode_gqa_attention(cfg, x, p, cache_k, cache_v, pos, *,
                         kv_len=None, use_rope=True, prefix=""):
    """One token's attention at position ``pos`` (a host integer or a 0-d
    int32 device tensor) against the layer's cache ``cache_k``,
    ``cache_v`` (B, S, Hkv, dh), which already holds this step's k and
    v: K5 over its first ``kv_len`` rows (``pos + 1`` unless given; a
    tensor where ``pos`` is one, so K5 reads it from device memory),
    read in place, where the reference masks the rest (the rows after
    ``pos``; a hybrid ring's unfilled slots; nothing of a Whisper
    decoder's cross K/V, whose ``kv_valid_len`` of F - 1 keeps all F
    frames).  ``prefix`` and ``use_rope`` as in ``gqa_attention``."""
    B = x.shape[0]
    dh, Hq = cfg.dh, cfg.n_heads
    q = _split_heads(x @ p[prefix + "wq"], Hq, dh)
    if cfg.qkv_bias and not prefix:
        q = q + p["bq"].reshape(1, 1, Hq, dh)
    if use_rope:
        q = rope(q, step_positions(pos, B, x.device), cfg.rope_theta)
    o = ops.decode_attention(q.reshape(B, Hq, dh), cache_k, cache_v,
                             pos + 1 if kv_len is None else kv_len)
    return o.reshape(B, 1, Hq * dh).to(x.dtype) @ p[prefix + "wo"]


def new_kv(cfg, x, p, pos):
    """This step's k (after rope) and v, (B, 1, Hkv, dh) each."""
    B = x.shape[0]
    dh, Hkv = cfg.dh, cfg.n_kv_heads
    k = _split_heads(x @ p["wk"], Hkv, dh)
    v = _split_heads(x @ p["wv"], Hkv, dh)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(1, 1, Hkv, dh)
        v = v + p["bv"].reshape(1, 1, Hkv, dh)
    k = rope(k, step_positions(pos, B, x.device), cfg.rope_theta)
    return k, v


def mla_attention(cfg, x, p):
    """DeepSeek's MLA over the sequence from position 0 (prefill), in its
    expanded form: returns (out, (c_kv, k_rope)), the latent (B, S, r)
    and the rope key (B, S, rd) for the cache.  ``k_rope`` is the
    projection *before* rope, as the reference returns it; the attention
    itself uses the roped key, and ``decode_step`` writes roped keys (a
    reference behaviour, ``ROADMAP.md`` §3)."""
    B, S, _ = x.shape
    Hq = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = _split_heads(x @ p["wq"], Hq, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    c_kv = x @ p["w_dkv"]
    k_rope = x @ p["w_kr"]
    k_nope = _split_heads(c_kv @ p["w_uk"], Hq, nd)
    v = _split_heads(c_kv @ p["w_uv"], Hq, vd)
    positions = torch.arange(S, device=x.device)[None, :]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    k_rope_r = rope(k_rope[..., None, :], positions, cfg.rope_theta)
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope_r.expand(B, S, Hq, rd)], -1)
    o = blockwise_attention(qf, kf, v, scale=(nd + rd) ** -0.5)
    return o.reshape(B, S, Hq * vd) @ p["wo"], (c_kv, k_rope)


def mla_decode_attention(cfg, x, p, cache_ckv, cache_kr, pos):
    """One token's MLA against the layer's latent cache ``cache_ckv`` (B,
    S, r) and rope keys ``cache_kr`` (B, S, rd), which already hold this
    step's rows at ``pos`` (a host integer or a 0-d device tensor): the
    absorbed form (``w_uk`` folded into the query, ``w_uv`` applied
    after), scores and values in float32 over all S rows, those after
    ``pos`` masked, as the reference computes it (no shape depends on
    ``pos``), and never read into the output."""
    B = x.shape[0]
    Hq = cfg.n_heads
    nd, rd, vd, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    f32 = torch.float32
    q = _split_heads(x @ p["wq"], Hq, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = rope(q_rope, step_positions(pos, B, x.device), cfg.rope_theta)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope,
                         p["w_uk"].reshape(r, Hq, nd))      # (B, 1, Hq, r)
    # the rows after pos are masked out of the scores and zeroed in the
    # values, so whatever they hold never reaches the output
    after = torch.arange(cache_ckv.shape[1], device=x.device) > pos
    ckv = cache_ckv.to(f32).masked_fill(after[:, None], 0.0)
    scores = (torch.einsum("bshr,btr->bhst", q_lat.to(f32), ckv)
              + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                             cache_kr.to(f32)))
    w = torch.softmax((scores * (nd + rd) ** -0.5).masked_fill(
        after, -torch.inf), dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", w, ckv)
    o = torch.einsum("bshr,rhd->bshd", o_lat,
                     p["w_uv"].reshape(r, Hq, vd).to(f32))
    return o.reshape(B, 1, Hq * vd).to(x.dtype) @ p["wo"]


def new_latent(cfg, x, p, pos):
    """This step's MLA cache rows: the latent (B, 1, r) and the rope key
    after rope (B, 1, rd)."""
    B = x.shape[0]
    kr = rope((x @ p["w_kr"])[..., None, :],
              step_positions(pos, B, x.device), cfg.rope_theta)
    return x @ p["w_dkv"], kr[..., 0, :]


# ---------------------------------------------------------------------------
# the layer body
# ---------------------------------------------------------------------------

def moe_groups(T: int) -> int:
    """The token groups of the MoE layer on T tokens, as the reference
    groups them: 16 where the batch's tokens divide into 16, else 1.
    Where the ranks of a sharded step (``dist.spmd``) hold n different
    row blocks of the batch, T is one block's, the 16 groups are the
    batch's, and each rank runs its n-th of them (the same groups of the
    same tokens); ``NotImplementedError`` where they do not split."""
    from ..dist.spmd import current_spmd
    spmd = current_spmd()
    n = spmd.rows.n if spmd is not None and spmd.rows is not None else 1
    Tn = T * n
    groups = 16 if Tn % 16 == 0 and Tn >= 16 else 1
    if groups % n:
        raise NotImplementedError(
            f"the MoE layer's {groups} token groups of {Tn} tokens do not "
            f"split over {n} row blocks of the batch (ROADMAP.md)")
    return groups // n


def _moe_or_mlp(cfg, x, p, is_moe: bool):
    """The layer's feed-forward on x (B, S, D): the MLP, or the MoE layer
    over the B·S tokens in their groups (``moe_groups``); returns (out,
    aux).  ``moe_impl="shard_map"`` runs ``dist.moe_ep.moe_layer_ep``
    where ``moe_ep.supported`` holds on the ambient mesh, ``moe_layer``
    otherwise (off a mesh, or on a ``model`` axis of 1), as the
    reference; ``moe_layer`` on a ``model`` axis larger than 1 comes
    with a later tensor-parallel slice and raises."""
    if not is_moe:
        return mlp(cfg, x, p.get("wg"), p["wu"], p["wd"]), 0.0
    B, S, D = x.shape
    T = B * S
    groups = moe_groups(T)
    xg = x.reshape(groups, T // groups, D)
    from ..dist import moe_ep
    if cfg.moe_impl == "shard_map" and moe_ep.supported(cfg):
        y, aux = moe_ep.moe_layer_ep(cfg, xg, p)
        return y.reshape(B, S, D), aux
    from ..dist.sharding import current_mesh, mesh_axis_sizes
    mesh = current_mesh()
    mp = mesh_axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    if mp > 1:
        raise NotImplementedError(
            f"{cfg.name}: moe_impl={cfg.moe_impl!r} with {cfg.n_experts} "
            f"experts on a 'model' axis of {mp}: the expert split GSPMD "
            f"places comes with a later tensor-parallel slice of dist "
            f"(ROADMAP.md); moe_impl='shard_map' runs it where the expert "
            f"count and the axis divide")
    y, aux = moe_layer(cfg, xg, p)
    return y.reshape(B, S, D), aux


def ssm_params(lp) -> dict:
    """A layer's SSD mixer parameters under the mixer's own names."""
    return {k[4:]: v for k, v in lp.items() if k.startswith("ssm_")}


def hybrid_mix(ao, so, lp):
    """A hybrid layer's output: the attention's and the mixer's each
    normalised (two K4 launches on the card), then averaged."""
    return 0.5 * (rmsnorm(ao, lp["mix_attn_g"]) + rmsnorm(so, lp["mix_ssm_g"]))


def decoder_layer(cfg, x, lp, kind: str = "dense"):
    """One layer over the sequence (prefill); returns (x', cache pieces,
    aux): (k, v), MLA's (c_kv, k_rope), the SSD mixer's (final state,)
    or a hybrid's (k, v, final state).

    On a sharded step's ``TensorParallel`` (a dense layer), the
    reference's sequence parallelism: x is this rank's block of the
    sequence (B, S/n, D) and so is x'; each norm (K4) runs on it, its
    output is gathered over the sequence (``gather_seq``) for the
    rank's heads and columns, and their partial sums are
    reduce-scattered back onto the block (``scatter_seq``)."""
    tp = tensor_parallel()
    if tp is not None:
        if kind != "dense":
            raise NotImplementedError(
                f"{cfg.name}: a {kind} layer under tensor parallelism comes "
                f"with a later slice (ROADMAP.md)")
        from ..dist.spmd import gather_seq, scatter_seq
        h = gather_seq(apply_norm(cfg, x, lp, "ln1"), tp)
        o, cache = gqa_attention(cfg, h, lp, tp=tp)
        x = x + scatter_seq(o, tp)
        h2 = gather_seq(apply_norm(cfg, x, lp, "ln2"), tp)
        return x + scatter_seq(mlp(cfg, h2, lp.get("wg"), lp["wu"],
                                   lp["wd"], tp=tp), tp), cache, 0.0
    h = apply_norm(cfg, x, lp, "ln1")
    if kind == "ssm":
        o, state = ssm_lib.ssm_mixer(cfg, h, ssm_params(lp))
        return x + o, (state,), 0.0
    if kind == "hybrid":
        ao, cache = gqa_attention(cfg, h, lp, window=cfg.window)
        so, state = ssm_lib.ssm_mixer(cfg, h, ssm_params(lp))
        o, cache = hybrid_mix(ao, so, lp), cache + (state,)
    elif cfg.kv_lora_rank:
        o, cache = mla_attention(cfg, h, lp)
    else:
        o, cache = gqa_attention(cfg, h, lp)
    x = x + o
    h2 = apply_norm(cfg, x, lp, "ln2")
    m, aux = _moe_or_mlp(cfg, h2, lp, kind == "moe")
    return x + m, cache, aux
