"""whisper-medium [audio]: enc-dec, 24L each side, d_model=1024 16H
d_ff=4096 vocab=51865 — conv frontend is a STUB per assignment
(input_specs supplies precomputed 1500-frame embeddings)
[arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    norm="layernorm", act="gelu", encoder_layers=24, encoder_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper_medium_smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    norm="layernorm", act="gelu", encoder_layers=2, encoder_frames=30,
)
