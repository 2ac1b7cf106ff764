"""Model configuration covering all assigned architecture families.

The port's copy of ``repro.models.config``: the same fields and derived
properties; ``compute_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 -> d_model // num_heads

    # attention
    attention_type: str = "gqa"      # gqa | mla | none (ssm)
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE stub (Qwen2-VL)
    window_pattern: Tuple[int, ...] = ()   # per-layer cycle; 0=global, w>0=local
    attn_logit_softcap: float = 0.0

    # MLA (MiniCPM3 / DeepSeek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 0     # every k-th layer is MoE (offset below)
    moe_layer_offset: int = 0
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25

    # Mamba / hybrid
    mamba_d_state: int = 0
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0        # 0 -> ceil(d_model / 16)
    attn_layer_period: int = 0    # hybrid: attention every k layers ...
    attn_layer_offset: int = 0    # ... at this offset (Jamba: 8 / 4)

    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_source_positions: int = 0

    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ---------------- derived ----------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank_(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe_num_experts:
            return False
        if not self.moe_layer_period:
            return True
        return i % self.moe_layer_period == self.moe_layer_offset

    def is_attn_layer(self, i: int) -> bool:
        if self.attention_type == "none":
            return False
        if not self.attn_layer_period:
            return True
        return i % self.attn_layer_period == self.attn_layer_offset

    def window_of(self, i: int) -> int:
        if not self.window_pattern:
            return 0
        return self.window_pattern[i % len(self.window_pattern)]

    def param_count(self) -> int:
        """Total parameter count (for MODEL_FLOPS and reporting)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        dh = self.head_dim_
        for i in range(self.num_layers):
            if self.is_attn_layer(i):
                if self.attention_type == "mla":
                    qk_d = self.qk_nope_dim + self.qk_rope_dim
                    total += d * self.q_lora_rank
                    total += self.q_lora_rank * self.num_heads * qk_d
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    total += self.num_heads * self.v_head_dim * d
                else:
                    total += d * self.num_heads * dh          # q
                    total += 2 * d * self.num_kv_heads * dh   # k, v
                    total += self.num_heads * dh * d          # o
            else:  # mamba mixer
                di, ds = self.mamba_d_inner, self.mamba_d_state
                dt = self.mamba_dt_rank_
                total += d * 2 * di           # in_proj
                total += self.mamba_d_conv * di
                total += di * (dt + 2 * ds)   # x_proj
                total += dt * di + di         # dt_proj
                total += di * ds + di         # A_log, D
                total += di * d               # out_proj
            if self.is_moe_layer(i):
                e = self.moe_num_experts
                ff = self.moe_d_ff or self.d_ff
                total += d * e                # router
                total += e * 3 * d * ff       # gated mlp experts
                if self.moe_shared_expert:
                    total += 3 * d * self.d_ff
            elif self.d_ff:
                total += 3 * d * self.d_ff    # gated mlp
            total += 2 * d                    # norms
        total += d                            # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of experts)."""
        if not self.moe_num_experts:
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        inactive = 0
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                inactive += (self.moe_num_experts - self.moe_top_k) * 3 * d * ff
        return self.param_count() - inactive
