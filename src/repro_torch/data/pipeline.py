"""Deterministic, resumable synthetic token pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only): batches are
bit-equal to the reference's for every ``(seed, step, host_id,
num_hosts)``. Every host generates only its slice of the global batch,
and the stream is a pure function of (seed, step), so a restart resumes
exactly from the step counter alone. A background prefetch thread keeps
batches ready ahead of the train step; ``close()`` stops it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-chain order-1 synthetic language (learnable structure so train
    # loss visibly decreases)
    num_states: int = 64
    prefetch: int = 2


class SyntheticLM:
    """Order-1 Markov synthetic language over the token vocabulary."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        s = cfg.num_states
        self._proj = rng.integers(0, cfg.vocab_size, size=s).astype(np.int32)
        trans = rng.random((s, 8)) ** 2
        self._next = rng.integers(0, s, size=(s, 8)).astype(np.int32)
        self._tp = (trans / trans.sum(-1, keepdims=True)).astype(np.float32)

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1
              ) -> np.ndarray:
        """(local_batch, seq_len + 1) int32 — pure function of (step, host)."""
        cfg = self.cfg
        local = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 64 + host_id)
        s = rng.integers(0, cfg.num_states, size=local)
        out = np.empty((local, cfg.seq_len + 1), np.int32)
        for t in range(cfg.seq_len + 1):
            out[:, t] = self._proj[s]
            choice = (rng.random(local)[:, None] >
                      np.cumsum(self._tp[s], axis=1)).sum(1)
            s = self._next[s, np.clip(choice, 0, 7)]
        return out


class Prefetcher:
    """Iterator over batches ``start_step, start_step + 1, ...`` made by a
    daemon thread up to ``cfg.prefetch`` ahead. ``close()`` stops the
    thread and waits for it to end."""

    def __init__(self, gen: SyntheticLM, start_step: int, host_id: int,
                 num_hosts: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=gen.cfg.prefetch)
        self._stop = threading.Event()

        def producer():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(gen.batch(step, host_id, num_hosts),
                                timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self.thread = threading.Thread(target=producer, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        return self._q.get()

    def close(self, timeout: float = 5.0):
        self._stop.set()
        self.thread.join(timeout)


def make_pipeline(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
                  num_hosts: int = 1) -> Iterator[np.ndarray]:
    """Prefetching iterator over batches, resumable at ``start_step``."""
    return Prefetcher(SyntheticLM(cfg), start_step, host_id, num_hosts)
