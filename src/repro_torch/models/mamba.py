"""Mamba-1 selective SSM block (Falcon-Mamba / Jamba mixer).

The port of ``repro.models.mamba``. Training and prefill run a chunked
scan: a loop over sequence chunks of ``SCAN_CHUNK`` steps carrying the
(B, d_inner, d_state) f32 state, with an associative scan inside each
chunk, written with the recursion of ``jax.lax.associative_scan`` (pairs
combined, the odd prefixes scanned recursively, the even ones filled in)
so that the products group as the reference's, at log depth. Under
autograd each chunk is a checkpoint region, as the reference's
``jax.checkpoint`` on ``chunk_step``: the backward pass recomputes one
chunk's (B, chunk, d_inner, d_state) history at a time. Decode is the
single-step recurrence over the ``{'conv', 'ssm'}`` cache.

The scan is PyTorch ops, as the reference's is XLA (no Pallas kernel); a
fused selective-scan kernel is later work.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from .config import ModelConfig
from .layers import dense, make_param, ones_param, tagged, zeros_param

SCAN_CHUNK = 256

# cost mode (see attention.py and ``launch/dryrun.py``): one scan chunk the
# length of the sequence
_UNCHUNKED_FOR_COST = False


def set_unchunked_for_cost(flag: bool):
    global _UNCHUNKED_FOR_COST
    _UNCHUNKED_FOR_COST = flag


class Mamba(nn.Module):
    """The parameters of one Mamba mixer (the reference's ``init_mamba``);
    ``forward`` is :func:`apply_mamba`."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
        dtr, dc = cfg.mamba_dt_rank_, cfg.mamba_d_conv
        kw = dict(device=device, generator=generator)
        self.in_proj = make_param((d, 2 * di), ("embed", "mlp"), **kw)
        self.conv_w = make_param((dc, di), ("conv", "mlp"), scale=0.5, **kw)
        self.conv_b = zeros_param((di,), ("mlp",), device=device)
        self.x_proj = make_param((di, dtr + 2 * ds), ("mlp", "lora"), **kw)
        self.dt_proj = make_param((dtr, di), ("lora", "mlp"), **kw)
        self.dt_bias = tagged(torch.full(
            (di,), float(np.log(np.expm1(np.float32(0.01)))),
            dtype=torch.float32, device=device), ("mlp",))
        self.a_log = tagged(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=device)).expand(
                di, ds).contiguous(), ("mlp", "state"))
        self.d_skip = ones_param((di,), ("mlp",), device=device)
        self.out_proj = make_param((di, d), ("mlp", "embed"), **kw)

    def forward(self, x, **kw):
        return apply_mamba(self, x, self.cfg, **kw)


def softplus(x):
    """``jax.nn.softplus``: ``log(exp(x) + 1)`` everywhere
    (``F.softplus`` returns x itself past its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_params(params: Mamba, x, cfg: ModelConfig):
    """x: (B, L, di) -> (dt (B,L,di), B_ (B,L,ds), C (B,L,ds)), f32."""
    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank_
    proj = dense(x, params.x_proj)
    dt_low, b_mat, c_mat = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = dense(dt_low, params.dt_proj) + params.dt_bias.to(x.dtype)
    return softplus(dt.float()), b_mat.float(), c_mat.float()


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd, dim: int):
    """[e0, o0, e1, o1, ...] along ``dim``; ``even`` may be one longer."""
    n = odd.shape[dim]
    pairs = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, even.narrow(dim, n, 1)], dim=dim)
    return out


def associative_scan(elems, dim: int = 1):
    """Inclusive scan of ``(a, b)`` pairs under :func:`_combine` along
    ``dim``, with the recursion of ``jax.lax.associative_scan``."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = _combine([sl(e, 0, n - 1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _chunk_scan(x, dt, b_mat, c_mat, a, h0):
    """One chunk: x (B,C,di), dt (B,C,di), b/c (B,C,ds), a (di,ds),
    h0 (B,di,ds). Returns (y (B,C,di), h_final)."""
    da = torch.exp(dt[..., None] * a)                       # (B,C,di,ds)
    dbx = dt[..., None] * b_mat[:, :, None, :] * x.float()[..., None]
    # include h0 by folding it into the first element
    dbx0 = torch.cat([dbx[:, :1] + (da[:, 0] * h0)[:, None], dbx[:, 1:]],
                     dim=1)
    _, h_all = associative_scan((da, dbx0), dim=1)
    y = torch.sum(h_all * c_mat[:, :, None, :], dim=-1)     # (B,C,di)
    # a copy: a view would keep the whole (B,C,di,ds) history alive in
    # the caller's cache and in the next chunk's saved inputs
    return y, h_all[:, -1].clone()


def apply_mamba(params: Mamba, x, cfg: ModelConfig, *, cache=None,
                mode: str = "train"):
    """x: (B, L, D). cache: {'conv' (B, dc-1, di), 'ssm' (B, di, ds)}.
    Returns (out (B, L, D), new_cache); prefill ignores the cache it is
    given and returns the state after the last token, decode a new one."""
    b, l, _ = x.shape
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    xz = dense(x, params.in_proj)
    xs, z = torch.chunk(xz, 2, dim=-1)                     # (B, L, di) each
    a = -torch.exp(params.a_log.float())

    if mode == "decode":
        conv_st = cache["conv"].to(xs.dtype)
        window = torch.cat([conv_st, xs], dim=1)            # (B, dc, di)
        conv_w = params.conv_w.to(xs.dtype)                 # (dc, di)
        xc = torch.sum(window * conv_w[None], dim=1, keepdim=True) \
            + params.conv_b.to(xs.dtype)
        xc = F.silu(xc)
        dt, b_mat, c_mat = _ssm_params(params, xc, cfg)
        h0 = cache["ssm"].float()
        da = torch.exp(dt[:, 0, :, None] * a)
        h1 = da * h0 + dt[:, 0, :, None] * b_mat[:, 0, None, :] * \
            xc.float()[:, 0, :, None]
        y = torch.sum(h1 * c_mat[:, 0, None, :], dim=-1)[:, None]
        y = y + xc.float() * params.d_skip.float()
        out = y.to(x.dtype) * F.silu(z)
        new_cache = {"conv": window[:, 1:].to(cache["conv"].dtype),
                     "ssm": h1.to(cache["ssm"].dtype)}
        return dense(out, params.out_proj), new_cache
    if mode not in ("train", "prefill"):
        raise ValueError(mode)

    # train / prefill: causal depthwise conv over the full sequence
    conv_w = params.conv_w.to(xs.dtype)
    xp = F.pad(xs, (0, 0, dc - 1, 0))
    xc = sum(xp[:, i:i + l] * conv_w[i] for i in range(dc))
    xc = F.silu(xc + params.conv_b.to(xs.dtype))
    dt, b_mat, c_mat = _ssm_params(params, xc, cfg)

    # pad to whole chunks; dt = 0 on the padded steps (after the softplus)
    # carries the state through them unchanged
    chunk = l if _UNCHUNKED_FOR_COST else min(SCAN_CHUNK, l)
    n_chunks = -(-l // chunk)
    pad = n_chunks * chunk - l
    xc_p, dt_p = (F.pad(t, (0, 0, 0, pad)) for t in (xc, dt))
    b_p, c_p = (F.pad(t, (0, 0, 0, pad)) for t in (b_mat, c_mat))
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n_chunks):
        part = (t[:, i * chunk:(i + 1) * chunk]
                for t in (xc_p, dt_p, b_p, c_p))
        if torch.is_grad_enabled():
            y, h = ckpt.checkpoint(_chunk_scan, *part, a, h,
                                   use_reentrant=False)
        else:
            y, h = _chunk_scan(*part, a, h)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :l]
    y = y + xc.float() * params.d_skip.float()
    out = y.to(x.dtype) * F.silu(z)
    out = dense(out, params.out_proj)

    new_cache = None
    if mode == "prefill":
        # xp is xs after dc - 1 zeros; a copy of its tail, not a view
        new_cache = {"conv": xp[:, -(dc - 1):].clone(), "ssm": h}
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    """``conv`` in ``dtype``, ``ssm`` always f32."""
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": torch.zeros((batch, dc - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                               device=device)}
