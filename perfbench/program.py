"""The one place the benchmark touches the program under test.

The program is the PyTorch and CUDA port, ``repro_torch``, imported from
the checkout's ``src``. The benchmark takes from it the multiply
(``repro_torch.core.workflow.ocean_spgemm``), its CSR container, its plan
cache (to empty it once the window has closed), its kernel build, its
span tracer and its hash tuning cache; nothing else.

The port sizes its hash tables by a load factor that it times on the card
(``core/tuning.py``), and which candidate wins a 2-launch timing changes
from process to process: the same seed then plans other bins, does other
work and peaks at other memory (4.2 against 5.8 GiB on the FEM cell). So
set-up fixes every rung at the port's own default load factor before the
first multiply, and every run does the same work from its seed. The
cells' numbers are those of the port with its tuner so pinned, not of a
default call, which times the candidates; each cell's ``why`` says so.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


class Port:
    """The port's entry points, imported from ``<checkout>/src``."""

    def __init__(self):
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        from repro_torch.core import formats, planner, workflow
        from repro_torch.obs import trace
        self._formats = formats
        self._planner = planner
        self._workflow = workflow
        self.trace = trace

    def build_kernels(self, device: torch.device) -> None:
        """Load the CUDA kernels, building them on a checkout's first run
        (into ``src/repro_torch/kernels/_build/``, inside the checkout)."""
        if device.type == "cuda":
            from repro_torch.kernels import _build
            _build.library()

    def pin_hash_tuning(self, device: torch.device) -> bool:
        """Every hash rung at the port's default load factor, as if the
        tuner had measured it (see the module's docstring). Pins nothing,
        and returns False, where the port has no timed tuner's cache: a
        tuner that decides from counts needs no pin."""
        from repro_torch.core import binning, tuning
        try:
            cache, load = tuning.DEFAULT_TUNING_CACHE, tuning.DEFAULT_TUNING
            key, table = tuning.tuning_key, binning.HASH_MIN_TABLE
            largest = binning.HASH_MAX_TABLE
        except AttributeError:
            return False
        while table <= largest:
            cache.insert(key(table, device), load)
            table *= 2
        return True

    def csr(self, indptr, indices, values, shape):
        """The port's CSR over int32 offsets and indices."""
        return self._formats.CSR(indptr, indices, values, tuple(shape),
                                 int(indices.shape[0]))

    def multiply(self, a, b, plan_cache: bool):
        """C = A·B through the port's entry; returns (C, OceanReport)."""
        return self._workflow.ocean_spgemm(a, b, cache=plan_cache)

    def forget_plans(self) -> None:
        """Empty the process-wide plan cache."""
        self._planner.DEFAULT_PLAN_CACHE.clear()
