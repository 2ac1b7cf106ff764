"""Qwen3-1.7B — dense GQA with qk-norm. [hf:Qwen/Qwen3-8B family; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=32, qk_norm=True, dtype="float32",
)

SHAPE_SKIPS = {"long_500k": "pure full-attention arch — skipped per "
                            "instructions"}
