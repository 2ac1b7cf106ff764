"""Qwen2-VL-72B — VLM backbone with M-RoPE. [arXiv:2409.12191; hf]
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

The vision frontend (dynamic-resolution ViT) is a STUB per the assignment:
``input_specs()`` provides token ids (text stream) and the M-RoPE position
streams; patch embeddings would enter through the same embedding interface.
M-RoPE sections (temporal/height/width) follow the HF config (16, 24, 24)
over head_dim/2 = 64.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, head_dim=32,
    mrope_sections=(4, 6, 6), dtype="float32", tie_embeddings=False,
)

SHAPE_SKIPS = {"long_500k": "pure full-attention arch — skipped per "
                            "instructions"}
