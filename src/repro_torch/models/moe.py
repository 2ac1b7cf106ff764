"""Mixture-of-Experts with Ocean estimation-guided capacity sizing.

The port of ``repro.models.moe``. The token->expert routing matrix R is a
sparse boolean matrix; dispatch (``R @ X``) and combine (``R^T @ Y``) are
SpGEMM-shaped. Two realisations, both the reference's arithmetic:

* ``einsum`` — one-hot dispatch/combine tensors (T, E, C) and matmuls;
* ``scatter`` — ESC-style: tokens placed into (E*C, D) buffers at their
  rank within the expert, gathered back after the expert MLPs.

**Ocean integration**: per-expert buffer *capacity* is an output-size
prediction problem. ``calibrate_capacity`` is the paper's analysis step
applied to it: a ~3 % token sample and a conservative (mean + sigma)
estimate with the paper's expansion factor, against the exact histogram
(the symbolic pass). It is host numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import dense, make_param


class MLP(nn.Module):
    """A gated MLP's parameters (the reference's ``init_mlp``);
    ``forward`` is :func:`apply_mlp`."""

    def __init__(self, d_model: int, d_ff: int, *, device, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.wi = make_param((d_model, d_ff), ("embed", "mlp"), **kw)
        self.wg = make_param((d_model, d_ff), ("embed", "mlp"), **kw)
        self.wo = make_param((d_ff, d_model), ("mlp", "embed"), **kw)

    def forward(self, x):
        return apply_mlp(self, x)


def apply_mlp(params: MLP, x):
    h = F.silu(dense(x, params.wg)) * dense(x, params.wi)
    return dense(h, params.wo)


class MoE(nn.Module):
    """A MoE layer's parameters (the reference's ``init_moe``): router,
    stacked expert weights and the optional shared expert; ``forward`` is
    :func:`apply_moe`."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.moe_num_experts, cfg.d_model
        ff = cfg.moe_d_ff or cfg.d_ff
        kw = dict(device=device, generator=generator)
        self.router = make_param((d, e), ("embed", "experts"), **kw)
        self.wi = make_param((e, d, ff), ("experts", "embed", "mlp"), **kw)
        self.wg = make_param((e, d, ff), ("experts", "embed", "mlp"), **kw)
        self.wo = make_param((e, ff, d), ("experts", "mlp", "embed"), **kw)
        if cfg.moe_shared_expert:
            self.shared = MLP(d, cfg.d_ff, **kw)

    def forward(self, x, **kw):
        return apply_moe(self, x, self.cfg, **kw)


# default dispatch realization, as the reference's
DISPATCH_MODE = "einsum"


def set_dispatch_mode(mode: str):
    global DISPATCH_MODE
    if mode not in ("einsum", "scatter", "auto"):
        raise ValueError(f"unknown MoE dispatch mode {mode!r}")
    DISPATCH_MODE = mode


# number of dispatch groups: routing and capacity per group of tokens
MOE_GROUPS = 1


def set_moe_groups(g: int):
    global MOE_GROUPS
    MOE_GROUPS = max(int(g), 1)


def apply_moe(params: MoE, x, cfg: ModelConfig, capacity_factor: float = 0.0,
              dispatch: str = "", groups: int = 0):
    """x: (B, S, D) -> (B, S, D), aux dict with load stats.

    Static per-expert capacity C = max(ceil(tokens * top_k / E * cf), 4);
    tokens routed beyond an expert's capacity are dropped (in (token,
    choice) order). ``auto`` takes scatter from 1024 tokens a group on.
    With ``groups`` > 1 (and tokens divisible into groups of two or more)
    each group is routed on its own; ``aux['capacity']`` is then one entry
    a group.
    """
    dispatch = dispatch or DISPATCH_MODE
    groups = groups or MOE_GROUPS
    b, s, d = x.shape
    cf = capacity_factor or cfg.moe_capacity_factor
    all_tokens = b * s
    if dispatch == "auto":
        dispatch = "scatter" if (all_tokens // max(groups, 1)) >= 1024 \
            else "einsum"
    if groups > 1 and all_tokens % groups == 0 and all_tokens >= 2 * groups:
        xg = x.reshape(groups, all_tokens // groups, d)
        outs, auxes = zip(*(_moe_tokens(params, xi, cfg, cf, dispatch)
                            for xi in xg))
        aux = {"overflow_frac": torch.stack(
                   [a["overflow_frac"] for a in auxes]).mean(),
               "aux_loss": torch.stack([a["aux_loss"] for a in auxes]).mean(),
               "capacity": torch.stack([a["capacity"] for a in auxes])}
        return torch.stack(outs).reshape(b, s, d), aux
    out, aux = _moe_tokens(params, x.reshape(all_tokens, d), cfg, cf,
                           dispatch)
    return out.reshape(b, s, d), aux


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, descending, the lower index first
    among ties. ``torch.topk`` promises no order among ties (on the CPU it
    can return a higher index first), and the order of a token's choices
    decides which of them are dropped."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_tokens(params: MoE, xf, cfg: ModelConfig, cf: float, dispatch: str):
    """Route one group of tokens: xf (T, D) -> (T, D)."""
    tokens, d = xf.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    dt = xf.dtype
    capacity = max(int(np.ceil(tokens * k / e * cf)), 4)
    logits = dense(xf, params.router).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                      # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert's buffer
    onehot = F.one_hot(gate_idx, e)                            # (T, k, E)
    flat = onehot.reshape(tokens * k, e)
    pos_in_expert = (torch.cumsum(flat, dim=0) - flat).reshape(tokens, k, e)
    pos = (pos_in_expert * onehot).sum(dim=-1)                 # (T, k)
    keep = pos < capacity
    overflow_frac = 1.0 - keep.float().mean()

    if dispatch == "scatter":
        # flat slot within the (E*C, D) buffer; every dropped choice writes
        # the sentinel row E*C, which is thrown away, so the duplicate
        # writes there are harmless; kept slots are unique
        slot = torch.where(keep, gate_idx * capacity + pos, e * capacity)
        expert_in = xf.new_zeros((e * capacity + 1, d))
        tok_ids = torch.arange(tokens, device=xf.device).repeat_interleave(k)
        expert_in[slot.reshape(-1)] = xf[tok_ids]
        expert_in = expert_in[:-1].reshape(e, capacity, d)
    else:
        pos_oh = F.one_hot(torch.where(keep, pos, capacity),
                           capacity + 1)[..., :capacity].to(dt)  # (T, k, C)
        disp = torch.einsum("tke,tkc->tec", onehot.to(dt), pos_oh)
        expert_in = torch.einsum("td,tec->ecd", xf.float(),
                                 disp.float()).to(dt)

    # expert MLPs, batched over the expert axis
    wi, wg, wo = (w.to(dt) for w in (params.wi, params.wg, params.wo))
    a = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wi)
    expert_out = torch.bmm(a, wo)                              # (E, C, D)

    if dispatch == "scatter":
        flat_out = expert_out.reshape(e * capacity, d)
        slot_cl = torch.clamp(slot, max=e * capacity - 1)
        gathered = flat_out[slot_cl] * keep[..., None].to(dt)
        out = torch.sum(gathered.reshape(tokens, k, d)
                        * gate_vals[..., None].to(dt), dim=1)
    else:
        # the reference's "tke,tkc,tk->tec": a token's k choices are
        # distinct experts, so each (t, e, c) takes at most one gate and
        # the gates can ride on the one-hot; this keeps torch from making
        # a (T, k, E, C) intermediate
        combine = torch.einsum("tke,tkc->tec",
                               onehot.to(dt) * gate_vals.to(dt)[..., None],
                               pos_oh)
        out = torch.einsum("ecd,tec->td", expert_out.float(),
                           combine.float()).to(dt)

    if hasattr(params, "shared"):
        out = out + apply_mlp(params.shared, xf)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = onehot.float().sum(dim=1).mean(dim=0)
    aux_loss = e * torch.sum(me * ce)
    aux = {"overflow_frac": overflow_frac, "aux_loss": aux_loss,
           "capacity": torch.tensor(capacity)}
    return out, aux


# ---------------------------------------------------------------------------
# Ocean estimation-guided capacity calibration (host-side "analysis step")
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CapacityReport:
    method: str
    capacity_factor: float
    est_max_load: float          # estimated max tokens routed to one expert
    exact_max_load: Optional[float]
    sample_fraction: float


def calibrate_capacity(router_logits: np.ndarray, top_k: int, *,
                       method: str = "sampled", sample_ratio: float = 0.03,
                       sample_min: int = 600, sigma: float = 2.0,
                       expansion: float = 1.1, seed: int = 0,
                       validate: bool = True) -> CapacityReport:
    """Pick a capacity factor from (a sample of) router logits.

    method='exact': full histogram over all tokens — the symbolic-pass
    analogue: exact but costs a full pass over every token's top-k.
    method='sampled': Ocean's analysis-step analogue — only ~3% of tokens
    are routed and histogrammed; a conservative (mean + sigma*std) estimate
    plus the paper's expansion factor absorbs sampling error.
    ``validate``: also compute the exact max load (costs a full pass; for
    reporting only).
    """
    logits = np.asarray(router_logits, np.float32)
    tokens, e = logits.shape
    uniform = tokens * top_k / e

    def max_load_of(idx):
        counts = np.bincount(idx.reshape(-1), minlength=e)
        return counts.max()

    def full_topk():
        return np.argpartition(-logits, top_k - 1, axis=-1)[:, :top_k]

    if method == "exact":
        ml = max_load_of(full_topk())
        cf = float(ml / uniform) * expansion
        return CapacityReport("exact", cf, float(ml), float(ml), 1.0)

    n = max(min(sample_min, tokens), int(tokens * sample_ratio))
    rng = np.random.default_rng(seed)
    rows = rng.choice(tokens, size=min(n, tokens), replace=False)
    sample_idx = np.argpartition(-logits[rows], top_k - 1,
                                 axis=-1)[:, :top_k]
    counts = np.bincount(sample_idx.reshape(-1),
                         minlength=e).astype(np.float64)
    scale = tokens / len(rows)
    est = counts * scale
    # per-expert sampling std: binomial-ish sqrt(c * scale) * scale^0.5
    std = np.sqrt(np.maximum(counts, 1.0)) * scale
    est_max = float((est + sigma * std).max())
    cf = est_max / uniform * expansion
    exact = float(max_load_of(full_topk())) if validate else None
    return CapacityReport("sampled", float(cf), est_max, exact,
                          len(rows) / tokens)
