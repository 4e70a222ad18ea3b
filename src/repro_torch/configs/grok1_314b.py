"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072 — 8 experts top-2 [hf:xai-org/grok-1].

Memory note: 314B params x (4B master + moments) does not fit 256 chips
with f32 Adam moments, so this config enables the 8-bit block-quantized
moment feature (DESIGN.md §6)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok1_314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=32768, vocab=131072,
    n_experts=8, topk=2, d_ff_moe=32768,
    opt_moment_dtype="int8",
    fsdp_only=False,  # MoE needs the model axis: FSDP-only measured 40TB/step of expert gathers (P7)
    # moe_impl="shard_map": validated explicit-EP a2a path (P10); default
    # stays gspmd — on the CPU lowering backend the shard_map boundary
    # replicates f32 token tensors (XLA b/433785288 class), negating the win.
)

SMOKE = ModelConfig(
    name="grok1_314b_smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    n_experts=4, topk=2, d_ff_moe=128, opt_moment_dtype="int8",
)
