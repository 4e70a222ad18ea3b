"""Model + shape configuration registry.

One ``<arch>.py`` per assigned architecture imports from here; the
launcher resolves ``--arch <id> --shape <id>`` through ``get_config`` /
``SHAPES``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    d_ff_moe: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- hybrid (hymba) ---
    window: int = 0                # sliding-window size for attn heads
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # --- vlm (llava) ---
    n_patches: int = 0
    # --- parallelism policy (P7, EXPERIMENTS.md §Perf) ---
    # Training default: pure FSDP/ZeRO-3 — on the assigned 16x16 mesh,
    # parameter-gather wire bytes (~3x params) beat TP+SP activation
    # resharding (which XLA currently materializes in f32) by ~10x for
    # every assigned arch.  Serving always keeps TP (KV-cache sharding).
    fsdp_only: bool = True
    moe_impl: str = "gspmd"       # gspmd | shard_map (explicit EP a2a, P10)
    # --- numerics / memory ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"   # float32 | int8 (block-quantized)
    remat: bool = True

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:       # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def params_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        dh, Hq, Hkv = self.dh, self.n_heads, self.n_kv_heads
        total = V * D * (1 if self.tie_embeddings else 2)

        def attn_params():
            if not Hq:
                return 0
            if self.kv_lora_rank:
                qd = Hq * (self.qk_nope_dim + self.qk_rope_dim)
                r = self.kv_lora_rank
                return (D * qd + D * (r + self.qk_rope_dim)
                        + r * Hq * (self.qk_nope_dim + self.v_head_dim)
                        + Hq * self.v_head_dim * D)
            return D * Hq * dh + 2 * D * Hkv * dh + Hq * dh * D

        def ssm_params():
            return (D * (2 * self.d_inner + 2 * self.ssm_state
                         + self.ssm_heads) + self.d_inner * D)

        def mlp_params(ff):
            mult = 3 if self.act == "swiglu" else 2
            return mult * D * ff

        for li in range(L):
            if self.family == "ssm":
                total += ssm_params()
                continue
            total += attn_params()
            if self.family == "hybrid":
                total += ssm_params()
            if self.family == "encdec":
                total += attn_params()                    # cross-attention
            if self.n_experts and li >= self.first_dense_layers:
                total += D * self.n_experts               # router
                total += self.n_experts * mlp_params(self.d_ff_moe)
                if self.n_shared_experts:
                    total += mlp_params(self.d_ff_moe * self.n_shared_experts)
            elif self.d_ff:
                total += mlp_params(F)
        for _ in range(self.encoder_layers):
            total += attn_params() + mlp_params(F)
        return total

    def active_params_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if not self.n_experts:
            return self.params_count()
        D = self.d_model
        mult = 3 if self.act == "swiglu" else 2
        moe_layers = self.n_layers - self.first_dense_layers
        all_experts = moe_layers * self.n_experts * mult * D * self.d_ff_moe
        active = moe_layers * self.topk * mult * D * self.d_ff_moe
        return self.params_count() - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCHS = [
    "whisper_medium", "mamba2_2p7b", "hymba_1p5b", "granite_34b",
    "granite3_8b", "llama3_8b", "qwen2_7b", "deepseek_v2_lite",
    "grok1_314b", "llava_next_34b",
]

# long_500k needs sub-quadratic sequence mixing; only SSM/hybrid qualify
SUBQUADRATIC = {"mamba2_2p7b", "hymba_1p5b"}


def supported_cells(arch: str) -> list[str]:
    out = []
    for s in SHAPES:
        if s == "long_500k" and arch not in SUBQUADRATIC:
            continue
        out.append(s)
    return out


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE
