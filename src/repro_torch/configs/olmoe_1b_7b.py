"""OLMoE-1B-7B — 64-expert top-8 MoE. [arXiv:2409.02060; hf]
16L d_model=2048 16H (kv=16) expert d_ff=1024, vocab=50304.

The most SpGEMM-like assigned arch (64 experts, top-8 routing => high
fan-out sparse dispatch) — the representative cell for Ocean's
estimation-guided MoE capacity sizing.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    moe_num_experts=64, moe_top_k=8, moe_d_ff=1024,
    qk_norm=True,
)

SMOKE = ModelConfig(
    name="olmoe-smoke", family="moe",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512, head_dim=24,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=96, qk_norm=True,
    dtype="float32",
)

SHAPE_SKIPS = {"long_500k": "pure full-attention arch — skipped per "
                            "instructions"}
