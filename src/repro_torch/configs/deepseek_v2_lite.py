"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (kv=16 via MLA)
d_ff(moe)=1408 vocab=102400 — MLA kv_lora=512, 64 routed experts top-6
+ 2 shared experts, first layer dense (d_ff=10944) [arXiv:2405.04434; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_v2_lite", family="moe", n_layers=27, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=10944, vocab=102400,
    n_experts=64, n_shared_experts=2, topk=6, d_ff_moe=1408,
    first_dense_layers=1,
    kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    fsdp_only=False,  # MoE needs the model axis for EP (P7)
    # moe_impl="shard_map": validated explicit-EP a2a path (P10); default
    # stays gspmd — on the CPU lowering backend the shard_map boundary
    # replicates f32 token tensors (XLA b/433785288 class), negating the win.
)

SMOKE = ModelConfig(
    name="deepseek_v2_lite_smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab=256,
    n_experts=4, n_shared_experts=1, topk=2, d_ff_moe=32,
    first_dense_layers=1,
    kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
)
