"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer;
attention heads use a sliding window so long_500k decode stays
sub-quadratic [arXiv:2411.13676; hf].

Stub note (DESIGN.md §4): hymba's learnable meta-tokens are omitted —
they are a prompt-side feature orthogonal to the compute path."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba_1p5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, window=1024,
)

SMOKE = ModelConfig(
    name="hymba_1p5b_smoke", family="hybrid", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=32, window=32,
)
