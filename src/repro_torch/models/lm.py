"""Model-level entry points: init, the losses, the train step, caches,
prefill and decode steps.

The port of ``repro.models.lm``. Parameters are a
:class:`~repro_torch.models.transformer.Decoder`, or an
:class:`~repro_torch.models.transformer.EncDec` for the encoder-decoder;
a decoder's caches a list with one dict a layer; gradients and optimizer
moments dicts keyed by the parameters' names. The serving steps run
under ``no_grad``; the train steps take their gradients with autograd and
update the parameters in place. The encoder-decoder has its own train
and decode steps; its prefill is ``transformer.apply_encdec(...,
mode="prefill")``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.core.formats import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_update, compress_grads,
                               cosine_schedule)
from . import transformer as tf
from .config import ModelConfig
from .layers import param_axes, set_param_axes

# the weights every call casts to the compute dtype before its matmul
# (``dense``, the expert einsums, the embedding gather and ``unembed``);
# norms and everything else stay f32
MATMUL_WEIGHTS = ("embed", "lm_head", "wq", "wk", "wv", "wo", "wi", "wg",
                  "router", "in_proj", "x_proj", "dt_proj", "out_proj",
                  "conv_w", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b")


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """A :class:`~.transformer.Decoder`, or an :class:`~.transformer.EncDec`
    for an encoder-decoder config, of f32 parameters drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; raises when
    CUDA is asked for and absent."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tf.model_class(cfg)(cfg, device=dev, generator=gen)


def cast_weights(params, dtype: torch.dtype):
    """A model whose matmul weights are held in ``dtype``, the values each
    call would cast them to, made once; the other parameters are shared
    with ``params``. ``params`` itself when nothing needs a cast."""
    state = params.state_dict()
    if all(t.dtype == dtype for n, t in state.items()
           if n.rsplit(".", 1)[-1] in MATMUL_WEIGHTS):
        return params
    out = type(params)(params.cfg, device="meta")
    axes = param_axes(out)
    out.load_state_dict({n: t.to(dtype)
                         if n.rsplit(".", 1)[-1] in MATMUL_WEIGHTS else t
                         for n, t in state.items()}, assign=True)
    return set_param_axes(out, axes)


def init_specs(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """``{parameter name: logical axes}``, the reference's logical specs
    (``src/repro/models/lm.py:40-55``) with the stacked layers' leading
    ``"layers"`` name dropped, as the port keeps one module a layer."""
    return param_axes(tf.model_class(cfg)(cfg, device="meta"))


def abstract_params(cfg: ModelConfig):
    """``(model on the meta device, init_specs(cfg))``: shapes and
    logical axes, nothing allocated (the dry-run's path; the counterpart
    of ``src/repro/models/lm.py:31-61``)."""
    model = tf.model_class(cfg)(cfg, device="meta")
    return model, param_axes(model)


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


def chunked_cross_entropy(params, hidden, labels, cfg: ModelConfig, *,
                          chunk: int = 512, z_loss: float = 1e-4):
    """CE over sequence chunks so (B, L, vocab) logits never materialize.

    Each chunk's unembed and loss run in a checkpoint region, so only one
    chunk's (B, chunk, V) f32 logits (and the f32 copy of a tied
    embedding that ``unembed`` makes) are live at a time, in the forward
    and again in the backward pass. L is padded to a multiple of the
    chunk, the padded labels masked; the chunks' sums add up in order and
    the total is divided by B * L, as the reference's scan.
    """
    b, l, d = hidden.shape
    if l <= chunk:
        logits = tf.unembed(params, hidden, cfg)
        return cross_entropy(logits.float(), labels, z_loss=z_loss)
    n = -(-l // chunk)
    pad = n * chunk - l
    hidden = F.pad(hidden, (0, 0, 0, pad))
    labels = F.pad(labels, (0, pad))
    valid = F.pad(torch.ones((b, l), device=hidden.device), (0, pad))

    def chunk_loss(h, lab, v):
        logits = tf.unembed(params, h, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (logz - gold + z_loss * torch.square(logz)) * v
        return torch.sum(nll)

    total = torch.zeros((), device=hidden.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        total = total + ckpt.checkpoint(
            chunk_loss, hidden[:, part], labels[:, part], valid[:, part],
            use_reentrant=False)
    return total / (b * l)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def loss_fn(params, tokens, cfg: ModelConfig, *, remat: str = "dots",
            aux_weight: float = 0.01):
    """(loss + aux_weight * aux, loss, aux) of ``tokens`` (B, L+1): inputs
    and labels shifted here."""
    tokens = tokens.long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, _, aux = tf.apply_decoder(params, inputs, cfg, mode="train",
                                      remat=remat, return_hidden=True)
    loss = chunked_cross_entropy(params, hidden, labels, cfg)
    return loss + aux_weight * aux, loss, aux


def _grads(params, fn):
    """(grads by parameter name, loss, aux) of ``fn() -> (total, loss,
    aux)``; the grad of a parameter the total does not reach is zeros, as
    JAX's."""
    named = dict(params.named_parameters())
    with torch.enable_grad():
        total, loss, aux = fn()
        gs = torch.autograd.grad(total, list(named.values()),
                                 allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), gs)}
    return grads, loss.detach(), aux.detach()


def grads_of(params, tokens, cfg: ModelConfig, *, remat: str = "dots",
             aux_weight: float = 0.01):
    """(grads by parameter name, loss, aux) of ``loss_fn``."""
    return _grads(params, lambda: loss_fn(params, tokens, cfg, remat=remat,
                                          aux_weight=aux_weight))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    remat: str = "dots", microbatch: int = 0,
                    schedule_kwargs: Optional[dict] = None,
                    aux_weight: float = 0.01):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); batch: {'tokens' (B, L+1) int}. The parameters and the
    moments are updated in place. ``microbatch`` > 0 accumulates the
    gradients of B // microbatch slices in order (the remainder rows are
    dropped), keeping activation memory at the microbatch size; grads,
    loss and aux are then divided by the slice count.
    """
    schedule_kwargs = schedule_kwargs or {"warmup": 100, "total": 10_000}
    grads_fn = functools.partial(grads_of, cfg=cfg, remat=remat,
                                 aux_weight=aux_weight)

    def train_step(params, opt_state, batch):
        tokens = batch["tokens"]
        if microbatch and microbatch < tokens.shape[0]:
            n = tokens.shape[0] // microbatch
            grads, loss, aux = grads_fn(params, tokens[:microbatch])
            for i in range(1, n):
                g, l_, a = grads_fn(
                    params, tokens[i * microbatch:(i + 1) * microbatch])
                for name, acc in grads.items():
                    acc.add_(g[name])
                loss, aux = loss + l_, aux + a
                del g
            for acc in grads.values():
                acc.div_(n)
            loss, aux = loss / n, aux / n
        else:
            grads, loss, aux = grads_fn(params, tokens)
        grads = compress_grads(grads, opt_cfg.grad_compression)
        lr_scale = cosine_schedule(opt_state.step, **schedule_kwargs)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr_scale)
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                   "lr_scale": lr_scale}
        return params, opt_state, metrics

    return train_step


def encdec_grads_of(params, batch, cfg: ModelConfig):
    """(grads by parameter name, loss, aux = 0) of an encoder-decoder batch
    {'audio_embeds' (B, S, D), 'tokens' (B, L+1)}: the plain cross entropy
    over full logits, remat 'full', as the reference's (which does not add
    its aux)."""
    def fn():
        tokens = batch["tokens"].long()
        logits, _, aux = tf.apply_encdec(params, batch["audio_embeds"],
                                         tokens[:, :-1], cfg, mode="train")
        loss = cross_entropy(logits.float(), tokens[:, 1:])
        return loss, loss, aux
    return _grads(params, fn)


def make_encdec_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                           schedule_kwargs: Optional[dict] = None):
    """Whisper-style: train_step(params, opt_state, batch) -> (params,
    opt_state, {'loss', 'grad_norm'}); batch = {'audio_embeds' (B,S,D),
    'tokens' (B,L+1)}. No microbatches and no gradient compression, as
    the reference's; the parameters and moments are updated in place."""
    schedule_kwargs = schedule_kwargs or {"warmup": 100, "total": 10_000}

    def train_step(params, opt_state, batch):
        grads, loss, _ = encdec_grads_of(params, batch, cfg)
        lr_scale = cosine_schedule(opt_state.step, **schedule_kwargs)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg, lr_scale)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig):
    """prefill(params, caches, tokens) -> (logits_last, caches).

    Only the last position is projected to vocab. An encoder-decoder has
    no such step: the reference's passes the tokens as the audio
    (``src/repro/models/lm.py:190-195``) and fails; its prefill is
    ``transformer.apply_encdec(..., mode="prefill", caches=...)``.
    """
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: the reference's prefill "
            "step passes the tokens as the audio (src/repro/models/"
            "lm.py:190-195) and fails; prefill with transformer."
            "apply_encdec(params, audio_embeds, tokens, cfg, "
            "mode=\"prefill\", caches=...)")

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


def make_encdec_decode_step(cfg: ModelConfig):
    """decode(params, caches, token (B,1), cache_len) -> (logits, caches)
    of an encoder-decoder whose caches a prefill filled."""

    @torch.no_grad()
    def decode(params, caches, token, cache_len):
        logits, caches, _ = tf.apply_encdec(params, None, token, cfg,
                                            mode="decode", caches=caches,
                                            cache_len=cache_len)
        return logits[:, 0], caches

    return decode


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda", src_len: int = 0):
    """A decoder's per-layer cache list, or an encoder-decoder's
    ``{'self', 'cross'}`` caches (cross K/V ``src_len`` frames long,
    ``max_len`` when 0)."""
    dev = resolve_device(device)
    if cfg.is_encoder_decoder:
        return tf.init_encdec_cache(cfg, batch, max_len, src_len or max_len,
                                    dtype, dev)
    return tf.init_decoder_cache(cfg, batch, max_len, dtype, dev)


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
