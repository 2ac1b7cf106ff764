"""Fault-tolerant training loop.

The port of ``repro.train.loop``:

* checkpoint/restart — resumes the parameters, the optimizer state and
  the data cursor from the latest atomic checkpoint;
* async checkpointing — IO overlaps compute;
* straggler/hang mitigation — a per-step wall-clock watchdog: from the
  sixth step on, a step slower than ``watchdog_factor`` x the trailing
  median is logged and counted;
* deterministic data — the pipeline is a pure function of (seed, step),
  so a restart never replays or skips a batch.

Batches go to the parameters' device. Each step is timed between device
synchronisations (the reference blocks on the loss), so a step's time is
its device work, not its launches.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0
    watchdog_window: int = 20


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(train_step: Callable, params, opt_state, data_cfg: DataConfig,
               loop_cfg: TrainLoopConfig, *, host_id: int = 0,
               num_hosts: int = 1,
               log_fn: Callable = print) -> Dict[str, Any]:
    """Runs ``train_step`` for ``total_steps`` with restart support.

    Returns {'params', 'opt_state', 'metrics_history', 'resumed_from',
    'straggler_steps', 'step_times_s'} (the last: every step's seconds).
    """
    gen = SyntheticLM(data_cfg)
    device = next(iter(params.parameters())).device
    mgr = None
    start_step = 0
    if loop_cfg.checkpoint_dir:
        mgr = CheckpointManager(loop_cfg.checkpoint_dir,
                                keep=loop_cfg.keep_checkpoints)
        last = mgr.latest_step()
        if last is not None:
            (params, opt_state), _ = mgr.restore((params, opt_state))
            start_step = last
            log_fn(f"[train] resumed from checkpoint step {last}")

    history: List[Dict[str, float]] = []
    durations: List[float] = []
    stragglers = 0

    for step in range(start_step, loop_cfg.total_steps):
        tokens = torch.as_tensor(gen.batch(step, host_id, num_hosts),
                                 device=device)
        batch = {"tokens": tokens}
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        _sync(device)
        dt = time.perf_counter() - t0

        if len(durations) >= 5:
            med = statistics.median(durations[-loop_cfg.watchdog_window:])
            if dt > loop_cfg.watchdog_factor * med:
                stragglers += 1
                log_fn(f"[watchdog] step {step} took {dt:.3f}s "
                       f"(median {med:.3f}s) — straggler flagged")
        durations.append(dt)

        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            h = {k: float(v) for k, v in metrics.items()}
            h["step"] = step
            h["step_time_s"] = dt
            history.append(h)
            log_fn(f"[train] step {step} loss {h['loss']:.4f} "
                   f"({dt*1000:.0f} ms)")

        if mgr and (step + 1) % loop_cfg.checkpoint_every == 0:
            mgr.save_async(step + 1, (params, opt_state))

    if mgr:
        mgr.save_async(loop_cfg.total_steps, (params, opt_state))
        mgr.wait()
    return {"params": params, "opt_state": opt_state,
            "metrics_history": history, "resumed_from": start_step,
            "straggler_steps": stragglers, "step_times_s": durations}
