"""Measured load-factor tuner for the hash-accumulator rung.

PyTorch port of ``repro.core.tuning``. For a table-size rung the tuner times
:func:`repro_torch.kernels.ops.hash_bin_op` — the op the executor calls, so
the CUDA kernel on a GPU and the plain version on the CPU — on a small
synthetic workload for each candidate primary-table load factor, and caches
the winner in a :class:`TuningCache` keyed by (rung, device type, kernel
path). The reference's DMA-chunk and row-tile knobs mean nothing to the
CUDA design, so only the load factor is swept. A failed kernel build or
launch propagates: it is never turned into the default tuning.

Measurement is single-flight: the first thread to miss a key measures it,
and every other thread asking for that key meanwhile waits for that one
measurement and takes its result (or its error). So a process holds one
load factor a key, and two plans built at once never take different ones.
It does not give clean timing: two different keys may be measured at once,
and ``_measure`` times on the host clock around a device synchronisation,
so another thread's kernels on the shared stream fall into its time and
can change which candidate wins.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .binning import HASH_LOAD_FACTOR, HASH_MIN_TABLE, hash_spill_of
from .formats import pow2_at_least, resolve_device

# Below 0.5 a table wastes shared memory; above ~0.85 linear probing
# degrades.
LOAD_FACTOR_CANDIDATES = (0.5, HASH_LOAD_FACTOR)

# The rung the planner consults for the load factor it hands to binning.
REFERENCE_RUNG = 256


@dataclasses.dataclass(frozen=True)
class HashTuning:
    """One rung's measured choice (``f_chunk``/``tile_rows`` are carried
    for the plan's fields and unused by the CUDA kernel)."""
    load_factor: float = HASH_LOAD_FACTOR
    f_chunk: int = 128
    tile_rows: int = 8


DEFAULT_TUNING = HashTuning()


class _Flight:
    """One measurement in progress: its waiters block on ``done``."""

    def __init__(self):
        self.done = threading.Event()
        self.result: Optional[HashTuning] = None
        self.error: Optional[BaseException] = None


class TuningCache:
    """Thread-safe LRU of :class:`HashTuning` entries, with the
    measurements in progress (one a key)."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: "OrderedDict[str, HashTuning]" = OrderedDict()
        self._inflight: Dict[str, _Flight] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: str) -> Optional[HashTuning]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return hit

    def get_or_measure(self, key: str,
                       measure: Callable[[], HashTuning]) -> HashTuning:
        """The entry for ``key``, calling ``measure`` on a miss. Threads
        that miss ``key`` while a measurement of it runs wait for that one
        and take its result, or raise its error; an error caches nothing."""
        hit = self.lookup(key)
        if hit is not None:
            return hit
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                return hit
            flight = self._inflight.get(key)
            leader = flight is None
            if leader:
                flight = self._inflight[key] = _Flight()
        if not leader:
            flight.done.wait()
            if flight.error is not None:
                raise flight.error
            return flight.result
        try:
            flight.result = measure()
            self.insert(key, flight.result)
            return flight.result
        except BaseException as exc:
            flight.error = exc
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            flight.done.set()

    def insert(self, key: str, tuning: HashTuning) -> None:
        with self._lock:
            self._entries[key] = tuning
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._entries)}


DEFAULT_TUNING_CACHE = TuningCache()


def _kernel_path(device: torch.device) -> str:
    return "cuda-kernel" if device.type == "cuda" else "plain"


def tuning_key(rung: int, device="cuda") -> str:
    """Digest of everything the measurement depends on: the rung, the
    torch device type and which kernel path runs there."""
    dev = torch.device(device)
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(("hash-rung", int(rung), dev.type,
                   _kernel_path(dev))).encode())
    return h.hexdigest()


def _synthetic_workload(rung: int, device) -> Tuple:
    """A tiny bin whose rows hold ~0.6*rung distinct columns (the
    reference's workload, on ``device``)."""
    rng = np.random.default_rng(rung)
    r, nb = 4, 4
    nnz_row = max(int(rung * 0.6), 8)
    blen = max(nnz_row // nb, 1)
    b_cols = rng.integers(0, max(2 * rung, 64), size=nb * blen,
                          ).astype(np.int32)
    b_vals = np.ones(nb * blen, np.float32)
    a_rows = np.tile(np.arange(nb, dtype=np.int32), (r, 1))
    a_vals = np.ones((r, nb), np.float32)
    a_starts = np.tile((np.arange(nb, dtype=np.int32) * blen), (r, 1))
    a_lens = np.full((r, nb), blen, np.int32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (a_rows, a_vals, a_starts, a_lens, b_cols, b_vals))


def _measure(rung: int, device) -> HashTuning:
    """Time every load-factor candidate through ``kops.hash_bin_op``."""
    from ..kernels import ops as kops
    dev = torch.device(device)
    nnz_row = max(int(rung * 0.6), 8)
    work = _synthetic_workload(rung, dev)
    best, best_t = DEFAULT_TUNING, float("inf")
    for lf in LOAD_FACTOR_CANDIDATES:
        table = pow2_at_least(int(np.ceil(nnz_row / lf)),
                              floor=HASH_MIN_TABLE)

        def run():
            out = kops.hash_bin_op(*work, table=table,
                                   spill=hash_spill_of(table))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        run()  # warmup (and, on a GPU, the kernel build)
        t0 = time.perf_counter()
        run()
        run()
        dt = time.perf_counter() - t0
        if dt < best_t:
            best_t, best = dt, HashTuning(load_factor=lf)
    return best


def hash_tuning_for(rung: int, cache: Optional[TuningCache] = None,
                    device="cuda") -> HashTuning:
    """Measured load factor for a rung on ``device`` (the GPU unless the
    caller asks for the CPU; raises without one), cached and measured
    once however many threads ask at once. Measurement errors propagate,
    to the thread that measured and to every thread that waited on it."""
    cache = DEFAULT_TUNING_CACHE if cache is None else cache
    device = resolve_device(device)
    return cache.get_or_measure(tuning_key(rung, device),
                                lambda: _measure(int(rung), device))
