"""The hash-accumulator rung's fixed configuration.

PyTorch port of ``repro.core.tuning``, without its timing. The planner
sizes every hash rung from :data:`DEFAULT_TUNING` (the load factor
``binning.HASH_LOAD_FACTOR``), so a plan depends only on its operands and
is the same in every process. The reference's DMA-chunk and row-tile knobs
are carried on the plan and mean nothing to the CUDA kernel.

The rest of this module, a :class:`TuningCache` keyed by rung and device
and :func:`hash_tuning_for`, which reads it and never measures, exists
only for the benchmark harness, which pins every rung at
:data:`DEFAULT_TUNING` in :data:`DEFAULT_TUNING_CACHE`, and for its
tests. The planner does not read the cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Optional

import torch

from .binning import HASH_LOAD_FACTOR

# The rung the reference consults for the load factor it hands to binning.
REFERENCE_RUNG = 256


@dataclasses.dataclass(frozen=True)
class HashTuning:
    """One rung's configuration (``f_chunk``/``tile_rows`` are carried for
    the plan's fields and unused by the CUDA kernel)."""
    load_factor: float = HASH_LOAD_FACTOR
    f_chunk: int = 128
    tile_rows: int = 8


DEFAULT_TUNING = HashTuning()


class TuningCache:
    """LRU of :class:`HashTuning` entries by :func:`tuning_key`. It takes
    no lock: the planner never reads it, and the harness pins it from one
    thread before the first multiply."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._entries: "OrderedDict[str, HashTuning]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: str) -> Optional[HashTuning]:
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return hit

    def insert(self, key: str, tuning: HashTuning) -> None:
        self._entries[key] = tuning
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._entries)}


DEFAULT_TUNING_CACHE = TuningCache()


def tuning_key(rung: int, device="cuda") -> str:
    """Digest of the rung, the torch device type and which kernel path
    runs there."""
    dev = torch.device(device)
    path = "cuda-kernel" if dev.type == "cuda" else "plain"
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(("hash-rung", int(rung), dev.type, path)).encode())
    return h.hexdigest()


def hash_tuning_for(rung: int, cache: Optional[TuningCache] = None,
                    device="cuda") -> HashTuning:
    """The cache's entry for a rung on ``device``, else
    :data:`DEFAULT_TUNING`; never measures."""
    cache = DEFAULT_TUNING_CACHE if cache is None else cache
    return cache.lookup(tuning_key(rung, device)) or DEFAULT_TUNING
