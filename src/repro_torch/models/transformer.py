"""Transformer assembly: the decoder-only stack and the encoder-decoder.

The port of ``repro.models.transformer``. The reference stacks each
position of the repeating layer *period* over its repeats and runs the
stack under one ``lax.scan``; here the layers are an ``nn.ModuleList`` in
layer order, and ``StackPlan`` only says which reference block a layer's
parameters come from (``models/convert.py``). A layer's mixer is GQA,
MLA or Mamba, by its kind and the config's ``attention_type``. Caches are
a list with one dict a layer (``{'k', 'v'}``, ``{'kv_lat', 'k_rope'}`` or
``{'conv', 'ssm'}``). Rematerialisation (``remat``) wraps each layer in
its own checkpoint region.

The encoder-decoder (Whisper) is :class:`EncDec`: unrolled encoder and
decoder stacks, cross-attention in every decoder layer, the embedding
tied to the output projection; its caches are ``{'self': [...],
'cross': [...]}``, the cross K/V computed once at prefill.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import make_param, ones_param, rms_norm, scalar_in


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
        self.cfg, self.kind = cfg, kind
        kw = dict(device=device, generator=generator)
        self.ln1 = ones_param((cfg.d_model,), ("embed",), device=device)
        if kind.mixer != "attn":
            self.mixer = mamba_mod.Mamba(cfg, **kw)
        elif cfg.attention_type == "mla":
            self.mixer = attn_mod.MLA(cfg, **kw)
        else:
            self.mixer = attn_mod.GQA(cfg, **kw)
        if kind.ff != "none":
            self.ln2 = ones_param((cfg.d_model,), ("embed",),
                                  device=device)
        if kind.ff == "moe":
            self.ff = moe_mod.MoE(cfg, **kw)
        elif kind.ff == "dense":
            self.ff = moe_mod.MLP(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, x, **kw):
        return apply_layer(self, x, self.cfg, self.kind, **kw)


def apply_layer(params: Layer, x, cfg: ModelConfig, kind: LayerKind, *,
                positions, cache=None, cache_len=None, mode: str = "train",
                causal: bool = True):
    """Returns (x, new_cache, aux); aux is the MoE's load stats or None.
    ``causal`` reaches GQA only (the encoder's layers pass False)."""
    h = rms_norm(x, params.ln1 - 1.0, cfg.norm_eps)
    if kind.mixer != "attn":
        h, new_cache = mamba_mod.apply_mamba(params.mixer, h, cfg,
                                             cache=cache, mode=mode)
    elif cfg.attention_type == "mla":
        h, new_cache = attn_mod.apply_mla(
            params.mixer, h, cfg, positions=positions, cache=cache,
            cache_len=cache_len, mode=mode, window=kind.window)
    else:
        h, new_cache = attn_mod.apply_gqa(
            params.mixer, h, cfg, window=kind.window, positions=positions,
            cache=cache, cache_len=cache_len, mode=mode, causal=causal)
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
        return mamba_mod.init_mamba_cache(cfg, batch, dtype, device)
    if cfg.attention_type == "mla":
        return {"kv_lat": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                      dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                      dtype=dtype, device=device)}
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
            raise ValueError(f"{cfg.name} is an encoder-decoder: its model "
                             "is EncDec (lm.init_model builds either)")
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        self.embed = make_param((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"),
                                scale=cfg.d_model ** -0.5, **kw)
        self.final_norm = ones_param((cfg.d_model,), ("embed",),
                                     device=device)
        if not cfg.tie_embeddings:
            self.lm_head = make_param((cfg.d_model, cfg.vocab_size),
                                      ("embed", "vocab"), **kw)
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


# ---------------------------------------------------------------------------
# Encoder-decoder (Whisper): unrolled (small layer counts)
# ---------------------------------------------------------------------------

ENCDEC_KIND = LayerKind("attn", 0, "dense")


class EncDec(nn.Module):
    """The encoder-decoder's parameters (the reference's
    ``init_encdec``): the embedding (also the output projection), the two
    final norms, the encoder and decoder :class:`Layer` lists, and a
    decoder layer's cross-attention and its norm."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        enc_l = cfg.encoder_layers or cfg.num_layers
        dec_l = cfg.decoder_layers or cfg.num_layers
        kw = dict(device=device, generator=generator)
        self.embed = make_param((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"),
                                scale=cfg.d_model ** -0.5, **kw)
        self.enc_final = ones_param((cfg.d_model,), ("embed",),
                                    device=device)
        self.dec_final = ones_param((cfg.d_model,), ("embed",),
                                    device=device)
        self.encoder = nn.ModuleList(Layer(cfg, ENCDEC_KIND, **kw)
                                     for _ in range(enc_l))
        self.decoder = nn.ModuleList(Layer(cfg, ENCDEC_KIND, **kw)
                                     for _ in range(dec_l))
        self.cross = nn.ModuleList(attn_mod.CrossAttention(cfg, **kw)
                                   for _ in range(dec_l))
        self.cross_ln = nn.ParameterList(
            ones_param((cfg.d_model,), ("embed",), device=device)
            for _ in range(dec_l))


def model_class(cfg: ModelConfig):
    """:class:`EncDec` for an encoder-decoder config, else :class:`Decoder`."""
    return EncDec if cfg.is_encoder_decoder else Decoder


def apply_encoder(params: EncDec, audio_embeds, cfg: ModelConfig, *,
                  remat: str = "full"):
    """audio_embeds: (B, S, D) precomputed frame embeddings (stub
    frontend). Non-causal layers, each its own checkpoint region under
    ``remat``."""
    x = audio_embeds.to(cfg.compute_dtype)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def layer(lp, x):
        return apply_layer(lp, x, cfg, ENCDEC_KIND, positions=positions,
                           mode="train", causal=False)[0]

    for lp in params.encoder:
        x = _remat(layer, remat, lp, x)
    return rms_norm(x, params.enc_final - 1.0, cfg.norm_eps)


def apply_encdec(params: EncDec, audio_embeds, tokens, cfg: ModelConfig, *,
                 mode: str = "train", caches=None, cache_len=None):
    """Returns (logits f32, new_caches, aux = 0). caches: {'self': [...],
    'cross': [...]}: prefill writes the self caches and returns the cross
    K/V it computed from the encoder; decode reads ``caches['cross']``
    and runs no encoder. Train makes every encoder and decoder layer a
    checkpoint region ('full'); the other modes make none."""
    remat = "full" if mode == "train" else "none"
    from_caches = mode == "decode" and caches is not None
    enc_out = None if from_caches else apply_encoder(
        params, audio_embeds, cfg, remat=remat)
    cd = cfg.compute_dtype
    x = params.embed[tokens].to(cd)      # the same values as the table cast
    b, l = tokens.shape
    dev = x.device
    if mode == "decode":
        positions = torch.as_tensor(cache_len, device=dev).reshape(
            -1, 1).expand(b, 1)
    else:
        positions = torch.arange(l, device=dev).expand(b, l)

    def dec_layer(lp, cross_p, cross_ln, x, cache_i, cross_kv):
        h = rms_norm(x, lp.ln1 - 1.0, cfg.norm_eps)
        h, nc = attn_mod.apply_gqa(lp.mixer, h, cfg, window=0,
                                   positions=positions, cache=cache_i,
                                   cache_len=cache_len, mode=mode)
        x = x + h
        h = rms_norm(x, cross_ln - 1.0, cfg.norm_eps)
        x = x + attn_mod.apply_cross_attention(cross_p, h, cross_kv, cfg)
        h = rms_norm(x, lp.ln2 - 1.0, cfg.norm_eps)
        x = x + moe_mod.apply_mlp(lp.ff, h)
        return x, nc

    new_self = [] if caches is not None else None
    cross_kvs = []
    for i, lp in enumerate(params.decoder):
        cache_i = caches["self"][i] if caches is not None else None
        if from_caches:
            cross_kv = caches["cross"][i]
        else:
            cross_kv = attn_mod.encode_cross_kv(params.cross[i], enc_out, cfg)
        cross_kvs.append(cross_kv)
        x, nc = _remat(dec_layer, remat, lp, params.cross[i],
                       params.cross_ln[i], x, cache_i, cross_kv)
        if new_self is not None:
            new_self.append(nc)
    x = rms_norm(x, params.dec_final - 1.0, cfg.norm_eps)
    logits = torch.matmul(x.float(), params.embed.to(x.dtype).float().t())
    new_caches = None
    if caches is not None:
        new_caches = {"self": new_self, "cross": cross_kvs}
    return logits, new_caches, torch.zeros((), device=dev)


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      src_len: int, dtype=torch.bfloat16, device="cuda"):
    dec_l = cfg.decoder_layers or cfg.num_layers
    shape = (batch, src_len, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "self": [init_layer_cache(cfg, ENCDEC_KIND, batch, max_len, dtype,
                                  device) for _ in range(dec_l)],
        "cross": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}
                  for _ in range(dec_l)],
    }
