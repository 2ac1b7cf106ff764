"""Model-level entry points for serving: init, caches, prefill and decode
steps, the cross-entropy loss.

The port of the serving half of ``repro.models.lm``. Parameters are a
:class:`~repro_torch.models.transformer.Decoder`; caches a list with one
``{'k', 'v'}`` dict a layer. The train-step factories and the chunked
loss wait for the training half of the LM substrate (ROADMAP queue 1,
item 8).
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import resolve_device
from . import transformer as tf
from .config import ModelConfig

# the weights every call casts to the compute dtype before its matmul
# (``dense``, the expert einsums, the embedding gather and ``unembed``);
# norms and everything else stay f32
MATMUL_WEIGHTS = ("embed", "lm_head", "wq", "wk", "wv", "wo", "wi", "wg",
                  "router")


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> tf.Decoder:
    """f32 parameters drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``; raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tf.Decoder(cfg, device=dev, generator=gen)


def cast_weights(params: tf.Decoder, dtype: torch.dtype) -> tf.Decoder:
    """A model whose matmul weights are held in ``dtype``, the values each
    call would cast them to, made once; the other parameters are shared
    with ``params``. ``params`` itself when nothing needs a cast."""
    state = params.state_dict()
    if all(t.dtype == dtype for n, t in state.items()
           if n.rsplit(".", 1)[-1] in MATMUL_WEIGHTS):
        return params
    out = tf.Decoder(params.cfg, device="meta")
    out.load_state_dict({n: t.to(dtype)
                         if n.rsplit(".", 1)[-1] in MATMUL_WEIGHTS else t
                         for n, t in state.items()}, assign=True)
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4):
    """logits (B, L, V) f32, labels (B, L) int."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig):
    """prefill(params, caches, tokens) -> (logits_last, caches).

    Only the last position is projected to vocab.
    """

    @torch.no_grad()
    def prefill(params, caches, tokens):
        hidden, caches, _ = tf.apply_decoder(params, tokens, cfg,
                                             mode="prefill", caches=caches,
                                             return_hidden=True)
        return tf.unembed(params, hidden[:, -1], cfg), caches

    return prefill


def make_decode_step(cfg: ModelConfig):
    """decode(params, caches, token (B,1), cache_len) -> (logits, caches)."""

    @torch.no_grad()
    def decode(params, caches, token, cache_len):
        logits, caches, _ = tf.apply_decoder(params, token, cfg,
                                             mode="decode", caches=caches,
                                             cache_len=cache_len)
        return logits[:, 0], caches

    return decode


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda"):
    if cfg.is_encoder_decoder:
        raise NotImplementedError(tf.UNPORTED["encdec"])
    return tf.init_decoder_cache(cfg, batch, max_len, dtype,
                                 resolve_device(device))


def slice_caches(caches, start: int, size: int):
    """Batch rows ``start:start+size`` of every layer's cache, as views."""
    return [{n: c.narrow(0, start, size) for n, c in layer.items()}
            for layer in caches]


def update_caches(caches, row, start: int):
    """Write a batch slice back into the caches, in place, converted to
    the caches' dtype; returns ``caches``."""
    for layer, layer_row in zip(caches, row):
        for n, c in layer.items():
            c.narrow(0, start, layer_row[n].shape[0]).copy_(layer_row[n])
    return caches
