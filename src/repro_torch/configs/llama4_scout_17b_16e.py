"""Llama-4-Scout 17B-active / 16 experts — MoE top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H
(GQA kv=8) expert d_ff=8192, MoE 16e top-1, vocab=202048. Every layer MoE
with one shared expert (the early-fusion multimodal frontend is out of
scope for the LM backbone per the assignment — token inputs only).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    moe_num_experts=16, moe_top_k=1, moe_d_ff=8192,
    moe_shared_expert=True, rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=32,
    moe_num_experts=4, moe_top_k=1, moe_d_ff=96, moe_shared_expert=True,
    dtype="float32",
)

SHAPE_SKIPS = {"long_500k": "pure full-attention arch — skipped per "
                            "instructions"}
