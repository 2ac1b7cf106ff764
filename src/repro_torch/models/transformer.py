"""Transformer assembly: the decoder-only stack.

The port of the decoder half of ``repro.models.transformer``. The
reference stacks each position of the repeating layer *period* over its
repeats and runs the stack under one ``lax.scan``; here the layers are an
``nn.ModuleList`` in layer order, and ``StackPlan`` only says which
reference block a layer's parameters come from (``models/convert.py``).
Caches are a list with one ``{'k', 'v'}`` dict a layer. Rematerialisation
(``remat``) wraps each layer in its own checkpoint region.

Mamba layers (Falcon-Mamba, Jamba), MLA (MiniCPM3) and the
encoder-decoder (Whisper) wait for their port (ROADMAP queue 1, item 8d)
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import attention as attn_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import make_param, ones_param, rms_norm, scalar_in

UNPORTED = {
    "mamba": "Mamba layers (falcon-mamba, jamba) wait for the port of "
             "models/mamba.py (ROADMAP queue 1, item 8d)",
    "mla": "MLA attention (minicpm3) waits for its port (ROADMAP queue 1, "
           "item 8d)",
    "encdec": "the encoder-decoder (whisper) waits for its port (ROADMAP "
              "queue 1, item 8d)",
}


class LayerKind(NamedTuple):
    mixer: str    # 'attn' | 'mamba'
    window: int   # 0 = global attention; >0 = sliding window
    ff: str       # 'dense' | 'moe' | 'none'


def layer_kinds(cfg: ModelConfig) -> Tuple[LayerKind, ...]:
    kinds = []
    for i in range(cfg.num_layers):
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        window = cfg.window_of(i) if mixer == "attn" else 0
        if cfg.is_moe_layer(i):
            ff = "moe"
        elif cfg.d_ff:
            ff = "dense"
        else:
            ff = "none"  # e.g. Falcon-Mamba: the mixer is the whole layer
        kinds.append(LayerKind(mixer, window, ff))
    return tuple(kinds)


def find_period(kinds: Tuple[LayerKind, ...]) -> int:
    """Smallest cycle length of the layer-kind pattern."""
    n = len(kinds)
    for p in range(1, n + 1):
        if all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return n


@dataclasses.dataclass(frozen=True)
class StackPlan:
    period: int
    n_scan: int              # number of scanned periods
    tail: Tuple[LayerKind, ...]   # leftover layers, unrolled
    period_kinds: Tuple[LayerKind, ...]

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "StackPlan":
        kinds = layer_kinds(cfg)
        p = find_period(kinds)
        n_scan = len(kinds) // p
        return cls(period=p, n_scan=n_scan, tail=kinds[n_scan * p:],
                   period_kinds=kinds[:p])


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One decoder layer's parameters (the reference's ``init_layer``);
    ``forward`` is :func:`apply_layer`."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind, *, device,
                 generator=None):
        super().__init__()
        if kind.mixer != "attn":
            raise NotImplementedError(UNPORTED["mamba"])
        if cfg.attention_type == "mla":
            raise NotImplementedError(UNPORTED["mla"])
        self.cfg, self.kind = cfg, kind
        kw = dict(device=device, generator=generator)
        self.ln1 = ones_param((cfg.d_model,), device=device)
        self.mixer = attn_mod.GQA(cfg, **kw)
        if kind.ff != "none":
            self.ln2 = ones_param((cfg.d_model,), device=device)
        if kind.ff == "moe":
            self.ff = moe_mod.MoE(cfg, **kw)
        elif kind.ff == "dense":
            self.ff = moe_mod.MLP(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, x, **kw):
        return apply_layer(self, x, self.cfg, self.kind, **kw)


def apply_layer(params: Layer, x, cfg: ModelConfig, kind: LayerKind, *,
                positions, cache=None, cache_len=None, mode: str = "train"):
    """Returns (x, new_cache, aux); aux is the MoE's load stats or None."""
    h = rms_norm(x, params.ln1 - 1.0, cfg.norm_eps)
    h, new_cache = attn_mod.apply_gqa(
        params.mixer, h, cfg, window=kind.window, positions=positions,
        cache=cache, cache_len=cache_len, mode=mode)
    x = x + h
    aux = None
    if kind.ff != "none":
        h = rms_norm(x, params.ln2 - 1.0, cfg.norm_eps)
        if kind.ff == "moe":
            h, aux = moe_mod.apply_moe(params.ff, h, cfg)
        else:
            h = moe_mod.apply_mlp(params.ff, h)
        x = x + h
    return x, new_cache, aux


def init_layer_cache(cfg: ModelConfig, kind: LayerKind, batch: int,
                     max_len: int, dtype, device):
    if kind.mixer != "attn":
        raise NotImplementedError(UNPORTED["mamba"])
    if cfg.attention_type == "mla":
        raise NotImplementedError(UNPORTED["mla"])
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Decoder-only model
# ---------------------------------------------------------------------------

class Decoder(nn.Module):
    """The decoder's parameters (the reference's ``init_decoder``): the
    embedding, one :class:`Layer` a layer in layer order, the final norm
    and, untied, the LM head. All f32, drawn from ``generator`` on
    ``device``; on ``meta`` nothing is allocated."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        if cfg.is_encoder_decoder:
            raise NotImplementedError(UNPORTED["encdec"])
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.embed = make_param((cfg.vocab_size, cfg.d_model),
                                scale=cfg.d_model ** -0.5, **kw)
        self.final_norm = ones_param((cfg.d_model,), device=device)
        if not cfg.tie_embeddings:
            self.lm_head = make_param((cfg.d_model, cfg.vocab_size), **kw)
        self.layers = nn.ModuleList(Layer(cfg, kind, **kw)
                                    for kind in layer_kinds(cfg))

    def forward(self, inputs, **kw):
        return apply_decoder(self, inputs, self.cfg, **kw)


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device="cuda"):
    return [init_layer_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in layer_kinds(cfg)]


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``:
    keep the outputs of products without batch dims (the projections,
    ``mm`` / ``addmm``), recompute the rest (``bmm``: the attention and
    expert einsums; norms, RoPE, casts)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str, *args):
    """``fn(*args)`` in a checkpoint region: ``'full'`` keeps only its
    inputs, ``'dots'`` also the outputs of :func:`_save_dots`."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _save_dots))
    raise ValueError(f"unknown remat mode {remat!r}")


def apply_decoder(params: Decoder, inputs, cfg: ModelConfig, *,
                  mode: str = "train", caches=None, cache_len=None,
                  positions=None, return_hidden: bool = False,
                  remat: str = "none"):
    """inputs: (B, L) int tokens, or (B, L, D) float embeddings (stub
    frontends). Returns (logits, new_caches, aux_loss_sum); with
    ``return_hidden`` the first element is the final hidden state.
    ``remat`` ('none' | 'full' | 'dots', the reference's modes; train mode
    only) recomputes each layer in the backward pass; values do not
    change."""
    cd = cfg.compute_dtype
    if not inputs.is_floating_point():
        # gather, then cast: the same values as casting the whole table
        x = params.embed[inputs].to(cd)
        x = x * scalar_in(cfg.d_model ** 0.5, cd)
    else:
        x = inputs.to(cd)
    b, l = x.shape[0], x.shape[1]
    dev = x.device
    if positions is None:
        if mode == "decode":
            positions = torch.as_tensor(cache_len, device=dev).reshape(
                -1, 1).expand(b, 1)
        else:
            positions = torch.arange(l, device=dev).expand(b, l)
        if cfg.mrope_sections:
            positions = positions[None].expand((3,) + positions.shape)

    if remat != "none" and mode != "train":
        raise ValueError("remat applies to the train mode only")

    def run(layer, x, cache):
        x, nc, aux = apply_layer(layer, x, cfg, layer.kind,
                                 positions=positions, cache=cache,
                                 cache_len=cache_len, mode=mode)
        return x, nc, (aux["aux_loss"] if aux is not None else None)

    aux_total = torch.zeros((), device=dev)
    new_caches = [] if caches is not None else None
    for i, layer in enumerate(params.layers):
        x, nc, aux = _remat(run, remat, layer, x,
                            caches[i] if caches is not None else None)
        if aux is not None:
            aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)

    x = rms_norm(x, params.final_norm - 1.0, cfg.norm_eps)
    if return_hidden:
        return x, new_caches, aux_total
    return unembed(params, x, cfg), new_caches, aux_total


def unembed(params: Decoder, x, cfg: ModelConfig):
    """Final projection to vocab logits, f32: compute-dtype operands
    (the weights rounded to x's dtype) multiplied with f32 accumulation
    and an f32 output, as the reference's ``preferred_element_type``."""
    if cfg.tie_embeddings:
        w = params.embed.to(x.dtype).float().t()
    else:
        w = params.lm_head.to(x.dtype).float()
    return torch.matmul(x.float(), w)
