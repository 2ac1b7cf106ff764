"""Gemma3-1B — dense GQA with 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified] 26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, head_dim=256, sliding window 512 on local layers.
26 = 4 x (5 local + 1 global) + 2 local tail — exercised by the period
decomposition (period 6, n_scan 4, tail 2).
"""
from repro_torch.models.config import ModelConfig

LOCAL_WINDOW = 512

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
    d_ff=6912, vocab_size=262144, head_dim=256,
    window_pattern=(LOCAL_WINDOW,) * 5 + (0,),
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    num_layers=8, d_model=96, num_heads=4, num_kv_heads=1,
    d_ff=192, vocab_size=512, head_dim=32,
    window_pattern=(64,) * 5 + (0,), dtype="float32",
)

# 5:1 sliding-window:global — only 5/26 layers hold full-length KV; eligible
# for long_500k with context-parallel KV sharding.
SHAPE_SKIPS = {}
