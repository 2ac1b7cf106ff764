"""Shared layer primitives: parameters, norms, RoPE, the dense projection.

The port of ``repro.models.layers``. Parameters are ``nn.Parameter``s in
the reference's layout (``(d_in, d_out)`` for a projection), so a tree of
the reference's arrays loads by name (``models/convert.py``). Each
parameter carries the reference's tuple of *logical axis names* as its
``axes`` attribute (the counterpart of ``P`` and ``split_tree``), for
example ``("embed", "mlp")``; ``repro_torch.launch.sharding`` maps them to
mesh axes per parallelism policy. The port keeps one module a layer, so a
layer's axes have no leading ``"layers"`` name.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def tagged(value: torch.Tensor, axes: Tuple[str, ...]) -> nn.Parameter:
    """``value`` as a parameter carrying the logical ``axes``, one name a
    dimension."""
    if len(axes) != value.ndim:
        raise ValueError(f"axes {axes} for a {value.ndim}-d parameter")
    p = nn.Parameter(value)
    p.axes = tuple(axes)
    return p


def make_param(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device,
               generator: Optional[torch.Generator] = None,
               scale: Optional[float] = None) -> nn.Parameter:
    """Normal(0, scale) f32 parameter; ``scale`` defaults to
    ``1 / sqrt(shape[0])``, the reference's fan-in. On the ``meta`` device
    nothing is allocated (``convert.from_reference`` fills such a model)."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        scale = 1.0 / np.sqrt(fan_in)
    value = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale
    return tagged(value, axes)


def ones_param(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
               device) -> nn.Parameter:
    return tagged(torch.ones(shape, device=device, dtype=torch.float32), axes)


def zeros_param(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                device) -> nn.Parameter:
    return tagged(torch.zeros(shape, device=device, dtype=torch.float32),
                  axes)


def param_axes(module: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """``{parameter name: logical axes}`` of a model."""
    return {n: p.axes for n, p in module.named_parameters()}


def set_param_axes(module: nn.Module, axes: Dict[str, Tuple[str, ...]]):
    """Tag ``module``'s parameters with ``axes`` again: a
    ``load_state_dict(..., assign=True)`` puts new ``nn.Parameter``s in
    place of the tagged ones."""
    for n, p in module.named_parameters():
        p.axes = axes[n]
    return module


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``. A Python scalar that multiplies a
    bf16 array in JAX is rounded to bf16 first; torch keeps it in f32
    unless it is rounded here."""
    return float(torch.tensor(value, dtype=dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """Scales by ``1 + weight``: callers pass the stored norm minus one,
    as the reference does (``ln - 1.0``)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + sectioned M-RoPE stub)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """In float64 numpy, as the reference; callers cast to f32 (computing
    the powers in f32 changes the bits)."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half) * 2.0 / head_dim))


def apply_rope(x, positions, theta: float = 1e4, sections: tuple = ()):
    """x: (..., L, H, Dh); positions: (..., L) int or (3, ..., L) for M-RoPE.

    ``sections`` (M-RoPE, Qwen2-VL): splits the Dh/2 frequency bands into
    temporal/height/width groups, each rotated by its own position stream.
    With a single position stream the sectioned form is numerically the
    standard RoPE (text-only stub frontend).
    """
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.as_tensor(rope_frequencies(dh, theta).astype(np.float32),
                            device=x.device)
    if positions.ndim == x.ndim - 1 and positions.shape[0] == 3 and sections:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} do not sum to "
                             f"head_dim / 2 = {half}")
        parts = []
        start = 0
        for s_idx, sec in enumerate(sections):
            f = freqs[start:start + sec]
            parts.append(positions[s_idx][..., None].float() * f)
            start += sec
        angles = torch.cat(parts, dim=-1)           # (..., L, half)
    else:
        angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]           # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def dense(x, w):
    """x (..., d_in) @ w (d_in, d_out) in x's dtype; the product
    accumulates in f32 and is rounded to x's dtype once."""
    return torch.matmul(x, w.to(x.dtype))

