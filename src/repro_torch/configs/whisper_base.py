"""Whisper-base — encoder-decoder audio backbone. [arXiv:2212.04356;
unverified] 6L d_model=512 8H d_ff=2048 vocab=51865.

The conv frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S_enc, d_model). Whisper-base is 6 encoder
+ 6 decoder layers; the assignment's "6L" is read as 6 per stack. The
assigned shapes drive the *encoder* sequence length (32k frames is far
beyond Whisper's natural 1500-frame regime — exercised structurally as
specified); decoder length is seq_len/8 capped at 448 (the model's maximum
target length) for train/prefill and the KV-cache length for decode.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    is_encoder_decoder=True, encoder_layers=6, decoder_layers=6,
    max_source_positions=32768,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    is_encoder_decoder=True, encoder_layers=2, decoder_layers=2,
    dtype="float32",
)

SHAPE_SKIPS = {
    "long_500k": "enc-dec full attention; decoder max target length 448 — "
                 "skipped per instructions",
}

# decode shapes use the decoder with a seq_len-long *encoder* memory and a
# decoder KV cache of length min(448, seq)-ish; see launch.dryrun.
DECODER_LEN = 448
