"""Falcon-Mamba-7B — pure Mamba-1 SSM (attention-free).

[arXiv:2410.05355; unverified] 64L d_model=4096, d_inner=8192 (expand=2),
ssm_state=16, vocab=65024.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    attention_type="none", mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", family="ssm",
    num_layers=4, d_model=96, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=512,
    attention_type="none", mamba_d_state=8, dtype="float32",
)

# SSM: O(1) decode state -> long_500k is the showcase shape.
SHAPE_SKIPS = {}
