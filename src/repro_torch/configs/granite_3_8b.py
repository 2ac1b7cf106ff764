"""Granite-3 8B — dense GQA. [hf:ibm-granite/granite-3.0 family; hf]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49155, head_dim=128,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=16, dtype="float32",
)

SHAPE_SKIPS = {"long_500k": "pure full-attention arch — skipped per "
                            "instructions"}
