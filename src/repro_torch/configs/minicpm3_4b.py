"""MiniCPM3-4B — dense transformer with Multi-head Latent Attention.

[hf:openbmb/MiniCPM3-4B; hf] 62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA dims follow the HF config: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64 (40 x 64 = 2560).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=96,
    attention_type="mla", q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="minicpm3-smoke", family="dense",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, head_dim=48,
    attention_type="mla", q_lora_rank=64, kv_lora_rank=32,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    dtype="float32",
)

# MLA is still full (quadratic) attention — latent compression shrinks the
# KV cache, not the attention span cost.
SHAPE_SKIPS = {"long_500k": "pure full-attention arch (MLA compresses KV, "
                            "not attention cost) — skipped per instructions"}
