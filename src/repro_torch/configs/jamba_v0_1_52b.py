"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 with MoE every 2nd layer.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16 experts top-2, vocab=65536, mamba d_state=16. Layer pattern per the
HF config: attn_layer_period=8 offset=4; expert_layer_period=2 offset=1 —
an 8-layer period scanned 4 times.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    attn_layer_period=8, attn_layer_offset=4,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    moe_num_experts=16, moe_top_k=2, moe_d_ff=14336,
    moe_layer_period=2, moe_layer_offset=1,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=32,
    attn_layer_period=8, attn_layer_offset=4,
    mamba_d_state=8, moe_num_experts=4, moe_top_k=2, moe_d_ff=96,
    moe_layer_period=2, moe_layer_offset=1, dtype="float32",
)

# hybrid: only 4/32 layers hold KV -> long_500k eligible (context-parallel).
SHAPE_SKIPS = {}
