"""Attention: GQA (+qk-norm, sliding window, softcap, M-RoPE), MLA and
cross-attention.

The port of ``repro.models.attention``. The core is the
reference's arithmetic in torch ops: scores in f32 from compute-dtype
operands, ``NEG_INF`` masking, softmax in f32, probabilities rounded to
the value dtype before the weighted sum. Inputs of at most 1024 query and
key positions take the direct path; longer ones the chunked online
softmax (flash-style, 1024 x 1024 chunks), as in the reference, so the
score matrix never exceeds one chunk pair. Decode takes the direct path
over the KV cache.

``torch.nn.functional.scaled_dot_product_attention`` is not used: it has
no softcap and scales at another point, so its bits differ.

MLA follows MiniCPM3/DeepSeek-V2: low-rank Q and KV projections with a
decoupled RoPE branch. Train and prefill rebuild the full K/V and reuse
the shared core (causal; like the reference, they take no window);
decode uses the *absorbed* form, scores against the latent cache
``{'kv_lat', 'k_rope'}`` directly. Cross-attention (Whisper's decoder)
attends to K/V computed once from the encoder output.

Each of the reference's ``preferred_element_type=f32`` products is an
f32 product of operands already rounded to the compute dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .layers import apply_rope, dense, make_param, ones_param, rms_norm, \
    scalar_in

NEG_INF = -1e30

# Cost mode (``launch/dryrun.py``): the dry-run counts FLOPs and bytes of
# its cost artifacts with one chunk the size of the sequence, as the
# reference's (whose XLA cost analysis counts a loop body once); the
# chunked program is what it traces for memory.
_UNCHUNKED_FOR_COST = False


def set_unchunked_for_cost(flag: bool):
    global _UNCHUNKED_FOR_COST
    _UNCHUNKED_FOR_COST = flag


# ---------------------------------------------------------------------------
# Core attention
# ---------------------------------------------------------------------------

def _mask(pq, pk, *, causal: bool, window: int, kv_len):
    m = torch.ones((pq.shape[0], pk.shape[0]), dtype=torch.bool,
                   device=pq.device)
    if causal:
        m &= pk[None, :] <= pq[:, None]
    if window:
        m &= pq[:, None] - pk[None, :] < window
    if kv_len is not None:
        m &= pk[None, :] < kv_len
    return m


def _scores(qc, kc, softcap):
    """(B, Lq, Hkv, G, Dh) x (B, Lk, Hkv, Dh) -> (B, Hkv, G, Lq, Lk) f32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kc.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s


def _weighted_values(p, v, spec: str):
    """The probabilities rounded to v's dtype, times v, summed in f32."""
    return torch.einsum(spec, p.to(v.dtype).float(), v.float())


def attention_core(q, k, v, *, causal: bool = True, window: int = 0,
                   q_start=0, kv_len=None, softcap: float = 0.0,
                   q_chunk: int = 1024, kv_chunk: int = 1024):
    """q: (B, Lq, Hq, Dh); k, v: (B, Lkv, Hkv, Dh). Returns (B, Lq, Hq, Dh).

    kv_len: None or a scalar / (B,) int — valid KV prefix length.
    q_start: scalar offset of q positions within the KV timeline.
    Query head ``h`` reads KV head ``h // (Hq // Hkv)``.
    """
    b, lq, hq, dh = q.shape
    lkv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[3]
    g = hq // hkv
    dev = q.device
    if _UNCHUNKED_FOR_COST:
        q_chunk, kv_chunk = max(q_chunk, lq), max(kv_chunk, lkv)
    qg = (q * scalar_in(dh ** -0.5, q.dtype)).reshape(b, lq, hkv, g, dh)
    kv_len_b = None
    if kv_len is not None:
        kv_len_b = torch.as_tensor(kv_len, device=dev).reshape(-1).expand(b)

    if lq <= q_chunk and lkv <= kv_chunk:
        s = _scores(qg, k, softcap)                 # (B, Hkv, G, Lq, Lkv)
        pq = q_start + torch.arange(lq, device=dev)
        pk = torch.arange(lkv, device=dev)
        m = _mask(pq, pk, causal=causal, window=window, kv_len=None)
        s = s.masked_fill(~m[None, None, None], NEG_INF)
        if kv_len_b is not None:
            lm = pk[None, :] < kv_len_b[:, None]    # (B, Lkv)
            s = s.masked_fill(~lm[:, None, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = _weighted_values(p, v, "bhgqk,bkhd->bqhgd")
        return o.reshape(b, lq, hq, dv).to(q.dtype)

    # pad to chunk multiples
    nq, nk = -(-lq // q_chunk), -(-lkv // kv_chunk)
    qg_p = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0,
                                        0, nq * q_chunk - lq))
    k_p = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * kv_chunk - lkv))
    v_p = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * kv_chunk - lkv))
    valid_kv = kv_len_b if kv_len_b is not None else torch.full(
        (b,), lkv, device=dev)
    chunks = []
    for qi in range(nq):
        qc = qg_p[:, qi * q_chunk:(qi + 1) * q_chunk]
        pq = q_start + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_run = torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev)
        l_run = torch.zeros((b, hkv, g, q_chunk), device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, dv), device=dev)
        for ki in range(nk):
            kc = k_p[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = v_p[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            pk = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = _scores(qc, kc, softcap)
            msk = _mask(pq, pk, causal=causal, window=window, kv_len=None)
            s = s.masked_fill(~msk[None, None, None], NEG_INF)
            lm = pk[None, :] < valid_kv[:, None]
            s = s.masked_fill(~lm[:, None, None, None, :], NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            pv = _weighted_values(p, vc, "bhgqk,bkhd->bhgqd")
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-20)[..., None]
        chunks.append(out.permute(0, 3, 1, 2, 4))   # (B, qc, Hkv, G, Dv)
    out = torch.cat(chunks, dim=1)[:, :lq]
    return out.reshape(b, lq, hq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """The parameters of one GQA layer (the reference's ``init_gqa``);
    ``forward`` is :func:`apply_gqa`."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        d, dh = cfg.d_model, cfg.head_dim_
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        kw = dict(device=device, generator=generator)
        self.wq = make_param((d, hq * dh), ("embed", "heads"), **kw)
        self.wk = make_param((d, hkv * dh), ("embed", "kv"), **kw)
        self.wv = make_param((d, hkv * dh), ("embed", "kv"), **kw)
        self.wo = make_param((hq * dh, d), ("heads", "embed"), **kw)
        if cfg.qk_norm:
            self.q_norm = ones_param((dh,), ("head_dim",), device=device)
            self.k_norm = ones_param((dh,), ("head_dim",), device=device)

    def forward(self, x, **kw):
        return apply_gqa(self, x, self.cfg, **kw)


def apply_gqa(params: GQA, x, cfg: ModelConfig, *, window: int, positions,
              cache=None, cache_len=None, mode: str = "train",
              causal: bool = True):
    """x: (B, L, D). cache: {'k','v'} (B, S_max, Hkv, Dh) or None.
    Returns (out, new_cache).

    The new cache holds k/v in x's dtype, as the reference's
    (``cache.astype(k.dtype)``): when the cache already has that dtype it
    is written in place and returned, else a converted copy is.
    """
    b, l, d = x.shape
    dh, hq, hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    q = dense(x, params.wq).reshape(b, l, hq, dh)
    k = dense(x, params.wk).reshape(b, l, hkv, dh)
    v = dense(x, params.wv).reshape(b, l, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm - 1.0, cfg.norm_eps)
        k = rms_norm(k, params.k_norm - 1.0, cfg.norm_eps)
    sections = cfg.mrope_sections
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)

    if mode == "train":
        out = attention_core(q, k, v, causal=causal, window=window,
                             softcap=cfg.attn_logit_softcap)
        new_cache = None
    elif mode == "prefill":
        kc = cache["k"].to(k.dtype)
        vc = cache["v"].to(v.dtype)
        kc.narrow(1, 0, l).copy_(k)
        vc.narrow(1, 0, l).copy_(v)
        out = attention_core(q, k, v, causal=causal, window=window,
                             softcap=cfg.attn_logit_softcap)
        new_cache = {"k": kc, "v": vc}
    elif mode == "decode":
        idx = torch.as_tensor(cache_len, device=x.device).reshape(-1)
        idx = idx.expand(b)
        rows = torch.arange(b, device=x.device)
        kc = cache["k"].to(k.dtype)
        vc = cache["v"].to(v.dtype)
        kc[rows, idx] = k[:, 0]
        vc[rows, idx] = v[:, 0]
        # direct masked attention over the cache (q position = idx)
        keep = _decode_keep(idx, kc.shape[1], window)
        qg = (q * scalar_in(dh ** -0.5, q.dtype)).reshape(
            b, 1, hkv, hq // hkv, dh)
        s = _scores(qg, kc, cfg.attn_logit_softcap)
        s = s.masked_fill(~keep[:, None, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = _weighted_values(p, vc, "bhgqk,bkhd->bqhgd")
        out = out.reshape(b, 1, hq, dh).to(x.dtype)
        new_cache = {"k": kc, "v": vc}
    else:
        raise ValueError(mode)

    out = dense(out.reshape(b, l, hq * dh), params.wo)
    return out, new_cache


def _decode_keep(idx, s_max: int, window: int):
    """(B, S) mask of the cache positions a decode step at ``idx`` reads:
    those up to and including ``idx``, the last ``window`` of them."""
    pk = torch.arange(s_max, device=idx.device)
    keep = pk[None] < (idx + 1)[:, None]
    if window:
        keep &= pk[None] >= torch.clamp(idx + 1 - window, min=0)[:, None]
    return keep


# ---------------------------------------------------------------------------
# Cross-attention (Whisper's decoder)
# ---------------------------------------------------------------------------

class CrossAttention(nn.Module):
    """The reference's ``init_cross_attention``: ``wq``, ``wk``, ``wv``,
    ``wo``."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        d, dh, hq, hkv = (cfg.d_model, cfg.head_dim_, cfg.num_heads,
                          cfg.num_kv_heads)
        kw = dict(device=device, generator=generator)
        self.wq = make_param((d, hq * dh), ("embed", "heads"), **kw)
        self.wk = make_param((d, hkv * dh), ("embed", "kv"), **kw)
        self.wv = make_param((d, hkv * dh), ("embed", "kv"), **kw)
        self.wo = make_param((hq * dh, d), ("heads", "embed"), **kw)


def apply_cross_attention(params: CrossAttention, x, enc_kv,
                          cfg: ModelConfig):
    """x (B, L, D) attends to ``enc_kv`` = {'k', 'v'} (B, S, Hkv, Dh),
    not causally."""
    b, l, _ = x.shape
    dh, hq = cfg.head_dim_, cfg.num_heads
    q = dense(x, params.wq).reshape(b, l, hq, dh)
    out = attention_core(q, enc_kv["k"], enc_kv["v"], causal=False)
    return dense(out.reshape(b, l, hq * dh), params.wo)


def encode_cross_kv(params: CrossAttention, enc_out, cfg: ModelConfig):
    b, s, _ = enc_out.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim_
    return {"k": dense(enc_out, params.wk).reshape(b, s, hkv, dh),
            "v": dense(enc_out, params.wv).reshape(b, s, hkv, dh)}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The parameters of one MLA layer (the reference's ``init_mla``);
    ``forward`` is :func:`apply_mla`."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.num_heads
        qk_d = cfg.qk_nope_dim + cfg.qk_rope_dim
        kw = dict(device=device, generator=generator)
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        self.wq_a = make_param((d, r_q), ("embed", "lora"), **kw)
        self.q_norm = ones_param((r_q,), ("lora",), device=device)
        self.wq_b = make_param((r_q, h * qk_d), ("lora", "heads"), **kw)
        self.wkv_a = make_param((d, r_kv + cfg.qk_rope_dim),
                                ("embed", "lora"), **kw)
        self.kv_norm = ones_param((r_kv,), ("lora",), device=device)
        self.wk_b = make_param((r_kv, h * cfg.qk_nope_dim),
                               ("lora", "heads"), **kw)
        self.wv_b = make_param((r_kv, h * cfg.v_head_dim),
                               ("lora", "heads"), **kw)
        self.wo = make_param((h * cfg.v_head_dim, d), ("heads", "embed"),
                             **kw)

    def forward(self, x, **kw):
        return apply_mla(self, x, self.cfg, **kw)


def _mla_qkv(params: MLA, x, cfg: ModelConfig, positions):
    """Shared projections. Returns q_nope, q_rope, kv_lat, k_rope."""
    b, l, _ = x.shape
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat = rms_norm(dense(x, params.wq_a), params.q_norm - 1.0,
                     cfg.norm_eps)
    q = dense(q_lat, params.wq_b).reshape(b, l, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = dense(x, params.wkv_a)
    kv_lat = rms_norm(kv_a[..., :r], params.kv_norm - 1.0, cfg.norm_eps)
    k_rope = kv_a[..., r:].reshape(b, l, 1, dr)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, kv_lat, k_rope


def _f32_einsum(spec: str, *operands):
    """``einsum(..., preferred_element_type=f32)`` of operands already in
    the compute dtype."""
    return torch.einsum(spec, *(t.float() for t in operands))


def apply_mla(params: MLA, x, cfg: ModelConfig, *, positions, cache=None,
              cache_len=None, mode: str = "train", window: int = 0):
    """MLA attention. cache: {'kv_lat' (B,S,r), 'k_rope' (B,S,dr)}.
    ``window`` applies to decode only, as in the reference."""
    b, l, _ = x.shape
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, kv_lat, k_rope = _mla_qkv(params, x, cfg, positions)

    if mode in ("train", "prefill"):
        # rebuild the full K/V and reuse the shared core, which scales by
        # q.shape[-1] ** -0.5 == (dn + dr) ** -0.5
        k_nope = dense(kv_lat, params.wk_b).reshape(b, l, h, dn)
        v = dense(kv_lat, params.wv_b).reshape(b, l, h, dv)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(b, l, h, dr)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = attention_core(q, k, v, causal=True)
        new_cache = None
        if mode == "prefill":
            kc = cache["kv_lat"].to(kv_lat.dtype)
            rc = cache["k_rope"].to(k_rope.dtype)
            kc.narrow(1, 0, l).copy_(kv_lat)
            rc.narrow(1, 0, l).copy_(k_rope)
            new_cache = {"kv_lat": kc, "k_rope": rc}
    elif mode == "decode":
        # absorbed form over the latent cache
        idx = torch.as_tensor(cache_len, device=x.device).reshape(-1)
        idx = idx.expand(b)
        rows = torch.arange(b, device=x.device)
        kc = cache["kv_lat"].to(kv_lat.dtype)
        rc = cache["k_rope"].to(k_rope.dtype)
        kc[rows, idx] = kv_lat[:, 0]
        rc[rows, idx] = k_rope[:, 0]
        new_cache = {"kv_lat": kc, "k_rope": rc}
        wk_b = params.wk_b.reshape(r, h, dn).to(q_nope.dtype)
        q_lat = _f32_einsum("bqhd,rhd->bqhr", q_nope, wk_b).to(x.dtype)
        s = (_f32_einsum("bqhr,bkr->bhqk", q_lat, kc)
             + _f32_einsum("bqhd,bkd->bhqk", q_rope, rc)) * (dn + dr) ** -0.5
        keep = _decode_keep(idx, kc.shape[1], window)
        s = s.masked_fill(~keep[:, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx_lat = _f32_einsum("bhqk,bkr->bqhr", p.to(kc.dtype), kc)
        wv_b = params.wv_b.reshape(r, h, dv).to(x.dtype)
        out = _f32_einsum("bqhr,rhd->bqhd", ctx_lat.to(x.dtype),
                          wv_b).to(x.dtype)
    else:
        raise ValueError(mode)

    out = dense(out.reshape(b, l, h * dv), params.wo)
    return out, new_cache
