"""Closed-form per-step cost model, from the reference's
``repro.launch.costmodel``: plain arithmetic on a config and a shape,
with the reference's numbers, and the card's constants in place of the
TPU's.

``estimate(cfg, shape)`` splits one step into

  * ``model_flops``  — useful flops, 6·N_active·tokens (train) /
                       2·N_active·tokens (prefill/decode);
  * ``impl_flops``   — what the implementation executes (full-mask
                       attention, the MoE capacity factor, SSD chunk
                       terms, the forward + backward 3x rule);
  * ``hbm_bytes``    — device-memory traffic a step (parameter and
                       optimizer streams, recompute activation streams,
                       KV-cache streams).

All quantities are global (the whole job); ``CostEstimate.terms(chips)``
divides them over the cards and gives the step's lower bound.

``tp_decode(cfg, batch, kv_len, mp)`` is one rank's side of a
tensor-parallel decode step (``serve --arch --model-parallel``): the
rank's weight and cache bytes (its KV heads; MLA's latent whole; its
SSD heads' float32 state; a Whisper decoder's cross K/V heads; a tied
model's vocabulary rows of the embedding) over the card's memory rate,
beside the bytes of the step's collectives over NVLink.
"""
from __future__ import annotations

import dataclasses

# --- NVIDIA H100 SXM5 80GB, one card: data-sheet values, which assume its
# full 700 W power limit (a card read as "H100 80GB HBM3, 700.00 W" by
# nvidia-smi).  chip_smoke.py's calibrate phase measured a streaming rate
# of 3.049e12 B/s on such a card (autotune.calibrate_hardware).
PEAK_FLOPS_BF16 = 989e12       # dense bf16 on the tensor cores
HBM_BW = 3.35e12               # device memory, bytes a second
LINK_BW = 450e9                # NVLink 4, bytes a second each way
HBM_PER_CARD = 80e9            # device memory, bytes


@dataclasses.dataclass
class CostEstimate:
    model_flops: float
    impl_flops: float
    hbm_bytes: float
    params_bytes: float
    notes: dict

    def terms(self, chips: int, collective_wire_bytes_per_dev: float = 0.0):
        """The three roofline terms over ``chips`` cards, in seconds (the
        collective term: ``collective_wire_bytes_per_dev`` over one
        NVLink direction)."""
        t_compute = self.impl_flops / (chips * PEAK_FLOPS_BF16)
        t_memory = self.hbm_bytes / (chips * HBM_BW)
        t_coll = collective_wire_bytes_per_dev / LINK_BW
        useful = self.model_flops / (chips * PEAK_FLOPS_BF16)
        dominant = max(("compute", t_compute), ("memory", t_memory),
                       ("collective", t_coll), key=lambda kv: kv[1])
        bound = max(t_compute, t_memory, t_coll)
        return {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "dominant": dominant[0],
            "step_lower_bound_s": bound,
            "useful_compute_s": useful,
            "roofline_fraction": useful / bound if bound else 0.0,
            "flops_utilization": (self.model_flops / self.impl_flops
                                  if self.impl_flops else 0.0),
        }


def _attn_flops_token(cfg, ctx: int, *, causal_useful: bool):
    """QK^T + AV flops per token per attention layer at context ``ctx``."""
    if not cfg.n_heads:
        return 0.0
    dh = cfg.dh if not cfg.kv_lora_rank else (cfg.qk_nope_dim
                                              + cfg.qk_rope_dim)
    dv = cfg.v_head_dim if cfg.kv_lora_rank else cfg.dh
    eff = ctx / 2 if causal_useful else ctx
    return 2.0 * cfg.n_heads * (dh + dv) * eff


def _ssd_flops_token(cfg):
    """SSD per token per mixer: within-chunk quadratic + state terms."""
    if not cfg.ssm_state:
        return 0.0
    c = cfg.ssm_chunk
    di, N = cfg.d_inner, cfg.ssm_state
    within = 2.0 * c * di            # (L ∘ CBᵀ)X over chunk, both einsums
    state = 6.0 * di * N             # B-outer, C-contract, carry
    return within + state


def _active_matmul_params(cfg):
    """Active matmul parameters (the embedding gather excluded; the
    unembedding, or its tied reuse, is a matmul)."""
    return cfg.active_params_count() - cfg.vocab * cfg.d_model


def estimate(cfg, shape) -> CostEstimate:
    """The step's flops and bytes for ``cfg`` at ``shape``
    (``configs.ShapeConfig``: train, prefill or decode)."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    tokens = B * S
    n_active = _active_matmul_params(cfg)
    cap = cfg.capacity_factor if cfg.n_experts else 1.0

    # decoder self-attention everywhere but the SSM family (an
    # encoder-decoder's cross-attention is counted apart)
    attn_layers = cfg.n_layers if cfg.family != "ssm" else 0
    ssm_layers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0

    if kind in ("train", "prefill"):
        ctx = min(S, cfg.window) if (cfg.family == "hybrid" and cfg.window) else S
        useful_attn = tokens * attn_layers * _attn_flops_token(
            cfg, ctx, causal_useful=True)
        impl_attn = tokens * attn_layers * _attn_flops_token(
            cfg, ctx, causal_useful=False)
        cross = 0.0
        if cfg.family == "encdec":
            cross = tokens * cfg.n_layers * _attn_flops_token(
                cfg, cfg.encoder_frames, causal_useful=False)
            enc_tokens = B * cfg.encoder_frames
            useful_attn += enc_tokens * cfg.encoder_layers * _attn_flops_token(
                cfg, cfg.encoder_frames, causal_useful=False)
            impl_attn += enc_tokens * cfg.encoder_layers * _attn_flops_token(
                cfg, cfg.encoder_frames, causal_useful=False)
        ssd = tokens * ssm_layers * _ssd_flops_token(cfg)
        fwd_impl = 2.0 * n_active * cap * tokens + impl_attn + cross + ssd
        mult = 3.0 if kind == "train" else 1.0      # fwd + 2x bwd
        model_flops = (6.0 if kind == "train" else 2.0) * n_active * tokens
        impl_flops = mult * fwd_impl

        # device-memory traffic
        pb = cfg.params_count()
        if kind == "train":
            quant = cfg.opt_moment_dtype == "int8"
            opt_stream = (2 + 2) * (1 if quant else 4)      # m,v r+w
            param_stream = 4 + 4 + 2 + 4 + 4                # p r/w, cast, g r/w
            params_bytes = pb * (param_stream + opt_stream)
        else:
            params_bytes = pb * 2.0                          # bf16 stream
        act_layers = cfg.n_layers + cfg.encoder_layers
        act_factor = 6.0 if kind == "train" else 3.0         # remat streams
        act_bytes = act_factor * act_layers * tokens * cfg.d_model * 2.0
        logit_bytes = (4.0 if kind == "train" else 2.0) * tokens * cfg.vocab * 2.0
        if kind == "prefill":
            logit_bytes = 2.0 * B * cfg.vocab * 2.0          # last-token only
        hbm = params_bytes + act_bytes + logit_bytes
        notes = {"attn_impl_flops": impl_attn, "ssd_flops": ssd,
                 "act_bytes": act_bytes, "params_bytes": params_bytes}
        return CostEstimate(model_flops, impl_flops, hbm, pb, notes)

    # ---- decode: one token, KV cache of length S ---------------------------
    new_tokens = B
    # parameters streamed once a step (MoE: every expert is hit at
    # batch >= E·k)
    pb = cfg.params_count()
    params_stream = pb * 2.0
    # attention: read the cache
    cache_bytes = 0.0
    attn_ctx = min(S, cfg.window) if (cfg.family == "hybrid" and cfg.window) else S
    if cfg.kv_lora_rank:
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        cache_bytes = cfg.n_layers * B * S * per_tok * 2.0
        attn_flops = 2.0 * new_tokens * cfg.n_layers * cfg.n_heads * S * (
            cfg.kv_lora_rank + cfg.qk_rope_dim + cfg.kv_lora_rank)
    elif cfg.n_heads:
        per_tok = 2 * cfg.n_kv_heads * cfg.dh
        cache_bytes = attn_layers * B * attn_ctx * per_tok * 2.0
        attn_flops = new_tokens * attn_layers * _attn_flops_token(
            cfg, attn_ctx, causal_useful=False)
        if cfg.family == "encdec":
            cache_bytes += cfg.n_layers * B * cfg.encoder_frames * per_tok * 2.0
            attn_flops += new_tokens * cfg.n_layers * _attn_flops_token(
                cfg, cfg.encoder_frames, causal_useful=False)
    else:
        attn_flops = 0.0
    state_bytes = 0.0
    if cfg.ssm_state:
        state_bytes = (cfg.n_layers * B * cfg.ssm_heads * cfg.ssm_head_dim
                       * cfg.ssm_state * 4.0 * 2.0)          # r+w f32
        attn_flops += new_tokens * cfg.n_layers * 6.0 * cfg.d_inner * cfg.ssm_state

    model_flops = 2.0 * n_active * new_tokens + attn_flops
    # an MoE decode reads every (hit) expert's weights but computes only
    # the routed ones, at the capacity factor
    impl_flops = 2.0 * n_active * cap * new_tokens + attn_flops
    hbm = params_stream + cache_bytes + state_bytes \
        + 4.0 * new_tokens * cfg.vocab * 2.0
    notes = {"cache_bytes": cache_bytes, "state_bytes": state_bytes,
             "attn_flops": attn_flops}
    return CostEstimate(model_flops, impl_flops, hbm, pb, notes)


#: the leaves of an encoder-decoder's encoder, which a decode step does not
#: read (``models.model.model_shapes``)
ENCODER_LEAVES = ("enc_layers", "enc_pos", "encf_g", "encf_b")


def tp_decode(cfg, batch: int, kv_len: int, mp: int, dpn: int = 1) -> dict:
    """One rank's bound for a decode step served over a ``model`` axis of
    ``mp`` (and ``dpn`` data-parallel groups, each serving its rows where
    they divide ``batch``), at ``kv_len`` cached positions: the bytes it
    reads, its weights' blocks (``dist.sharding.rank_param_bytes``, rank
    0's: the longest vocabulary block) and its rows of the cache, over
    ``HBM_BW``; beside them the step's collectives and the vocabulary's
    gather, their payload and the bytes a ring moves between ranks (an
    all-reduce 2 (n - 1) / n of its payload, an all-gather (n - 1) / n
    of its result) over one NVLink direction.

    The cache a rank reads: its KV heads' K and V at ``kv_len``; MLA's
    latent and rope key whole, L · rows · kv_len · (r + rd); the ssm
    family's float32 SSD state of its heads, L · rows · (H/mp) · P ·
    N_state · 4 whatever ``kv_len``, which the step also writes back
    (``cache_write_bytes``, counted in the bound; a KV row's write is
    not); a Whisper decoder's cross K/V besides, L · rows · frames · 2 ·
    (heads/mp) · dh.  The collectives: 2 a layer (the float32 sums
    after the attention and the MLP or MoE layer); a Whisper decoder
    layer 3 (the cross-attention's too); a Mamba-2 layer 2 (its gated
    norm's (rows,) float32 sums of squares, then the mixer's output).
    The embedding, held whole, is read at the step's rows alone, and a
    tied model's logits read the rank's vocabulary rows of it; an
    encoder's weights (``ENCODER_LEAVES``) are not read.  A MoE
    rank's experts all count as read: a decode step at B tokens touches
    up to B · k of them (DeepSeek-V2-Lite at B 8, top-6: up to 48 of
    its 64), so the bound is a step that reaches every one."""
    from ..dist.sharding import rank_param_bytes
    from ..dist.spmd import TensorParallel
    item = 2 if cfg.compute_dtype == "bfloat16" else 4
    rows = batch // dpn if dpn > 1 and batch % dpn == 0 else batch
    tp = TensorParallel(None, mp, 0) if mp > 1 else None
    L, D = cfg.n_layers, cfg.d_model
    held = rank_param_bytes(cfg, tp, item)
    # a decode step runs no encoder: Whisper's are the prefill's alone
    enc = held - rank_param_bytes(cfg, tp, item, ENCODER_LEAVES)
    vocab_rows = (tp.block(cfg.vocab)[1] if tp is not None else cfg.vocab) \
        if cfg.tie_embeddings else 0
    weights = held - enc - cfg.vocab * D * item \
        + (rows + vocab_rows) * D * item
    heads = cfg.n_kv_heads if mp == 1 or cfg.n_kv_heads % mp \
        else cfg.n_kv_heads // mp
    if cfg.kv_lora_rank:
        cache = L * rows * kv_len * (cfg.kv_lora_rank + cfg.qk_rope_dim) \
            * item
    elif cfg.family == "ssm":
        cache = L * rows * (cfg.ssm_heads // mp) * cfg.ssm_head_dim \
            * cfg.ssm_state * 4
    else:
        cache = L * rows * kv_len * 2 * heads * cfg.dh * item
    if cfg.family == "encdec":
        cache += L * rows * cfg.encoder_frames * 2 * heads * cfg.dh * item
    # a layer's (rows, D) float32 sums over model; Mamba-2's gated norm
    # adds one of (rows,) sums of squares
    ssm = cfg.family == "ssm"
    sums = 3 if cfg.family == "encdec" else 1 if ssm else 2
    n_coll = (sums + ssm) * L + 1 if mp > 1 else 0
    reduce_payload = sums * L * rows * D * 4 + ssm * L * rows * 4
    gather_payload = rows * -(-cfg.vocab // mp) * mp * item
    wire = (2 * (mp - 1) / mp * reduce_payload
            + (mp - 1) / mp * gather_payload) if mp > 1 else 0.0
    written = cache if ssm else 0
    t_memory = (weights + cache + written) / HBM_BW
    t_coll = wire / LINK_BW
    return {"model_parallel": mp, "rows": rows, "held_weight_bytes": held,
            "weight_bytes": weights,
            "cache_bytes": cache, "cache_write_bytes": written,
            "t_memory_s": t_memory,
            "collectives": n_coll,
            "collective_payload_bytes": (reduce_payload + gather_payload
                                         if mp > 1 else 0),
            "collective_wire_bytes": wire, "t_collective_s": t_coll,
            "step_lower_bound_s": max(t_memory, t_coll),
            "dominant": "memory" if t_memory >= t_coll else "collective"}
