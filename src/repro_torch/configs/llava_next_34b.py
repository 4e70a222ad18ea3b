"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; vision frontend is a STUB per assignment
(input_specs supplies precomputed patch embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, n_patches=576,
)

SMOKE = ModelConfig(
    name="llava_next_34b_smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, n_patches=16,
)
