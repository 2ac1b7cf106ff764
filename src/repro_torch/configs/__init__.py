"""Architecture registry: ``--arch <id>`` resolves through here.

The port's copy of ``repro.configs``: the same ten architectures, shapes
only, built on :class:`repro_torch.models.config.ModelConfig`.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .shapes import SHAPES, ShapeSpec  # noqa: F401

_MODULES = {
    "minicpm3-4b": "minicpm3_4b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma3-1b": "gemma3_1b",
    "granite-3-8b": "granite_3_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-base": "whisper_base",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    """Returns the config module for an architecture id."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str, smoke: bool = False):
    mod = get_arch(arch_id)
    return mod.SMOKE if smoke else mod.CONFIG


def shape_skips(arch_id: str) -> Dict[str, str]:
    return dict(getattr(get_arch(arch_id), "SHAPE_SKIPS", {}))


def eligible_cells():
    """All (arch, shape) cells with skip reasons resolved."""
    cells = []
    for arch in ARCH_IDS:
        skips = shape_skips(arch)
        for shape in SHAPES:
            cells.append((arch, shape, skips.get(shape)))
    return cells
