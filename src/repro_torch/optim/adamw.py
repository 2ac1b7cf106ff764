"""AdamW with global-norm clipping and optional gradient compression.

The port of ``repro.optim.adamw``. Parameters are an ``nn.Module`` (the
port's :class:`~repro_torch.models.transformer.Decoder`) or a dict of
tensors; gradients and the two moments are dicts keyed by the
parameters' names. :func:`adamw_update` is the reference's arithmetic
step by step, one parameter at a time (so its temporaries are one
parameter's size), and writes the new values into the parameters in
place. The moments are updated in place too, as a train step that holds
one state wants (a second copy of both would cost twice the parameters'
bytes). ``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: they
add epsilon at another point and order the arithmetic otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # gradient compression ahead of a gradient all-reduce: 'none' | 'bf16'
    grad_compression: str = "none"


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32: updates taken so far
    mu: Dict[str, torch.Tensor]     # f32, one a parameter, by name
    nu: Dict[str, torch.Tensor]


def named_params(params) -> Dict[str, torch.Tensor]:
    """Name -> tensor of an ``nn.Module``'s parameters or of a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    named = named_params(params)
    device = next(iter(named.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named.items()},
        nu={n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named.items()})


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: g * scale for n, g in grads.items()}, gn


def compress_grads(grads: Dict[str, torch.Tensor], method: str):
    """Lossy gradient representation ahead of a gradient all-reduce: bf16
    halves the payload."""
    if method == "bf16":
        return {n: g.to(torch.bfloat16).float() for n, g in grads.items()}
    return grads


@torch.no_grad()
def adamw_update(params, grads: Dict[str, torch.Tensor], state: AdamWState,
                 cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step: returns ``(params, new_state, grad_norm)``. The
    parameters and ``state``'s moments are updated in place; the new state
    holds those moment tensors and a new step. The grads are clipped as
    :func:`clip_by_global_norm` clips them, one parameter at a time. With
    ``grad_clip`` 0 the grad norm is 0 and nothing clips."""
    named = named_params(params)
    device = state.step.device
    if cfg.grad_clip:
        gn = global_norm(grads)
        scale = _clip_scale(gn, cfg.grad_clip)
    else:
        gn, scale = torch.zeros((), device=device), None
    step = state.step + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=device)
    for n, p in named.items():
        g = grads[n].float()
        if scale is not None:
            g = g * scale
        m = state.mu[n].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = state.nu[n].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), gn
