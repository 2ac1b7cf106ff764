"""Learning-rate schedules (the port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int, total: int, min_ratio: float = 0.1):
    """The lr scale at ``step`` (an int tensor, the optimizer's step before
    its increment), f32: a linear warmup from ``1 / warmup``, then a cosine
    from 1 down to ``min_ratio`` at ``total``, held there after it."""
    step = torch.as_tensor(step).float()
    warm = (step + 1.0) / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup, warm, cos)
