"""Weight carrier: the reference's parameter, optimizer-state and cache
trees -> the port's.

The reference (``repro.models``) stacks the layers of each position of
the repeating layer period over the period's repeats: scanned layer ``i``
is ``blocks[i % period]`` at index ``i // period``, and the ``tail``
layers follow at ``n_scan * period + t``. The port keeps one module a
layer in layer order. The encoder-decoder's tree is unrolled already
(lists ``encoder``, ``decoder``, ``cross``, ``cross_ln``; caches
``{'self': [...], 'cross': [...]}``), so list item ``i`` is the port's
``name.i``. Trees are nested dicts/lists of numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, init_model(key, cfg)[0])``), so
this module needs no JAX.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.optim import AdamWState
from . import transformer as tf
from .config import ModelConfig
from .layers import param_axes, set_param_axes


def reference_layers(cfg: ModelConfig, tree) -> List[dict]:
    """The per-layer subtrees of a reference params or cache tree, in layer
    order (``tree['blocks']`` stacked by period position, then
    ``tree['tail']``)."""
    plan = tf.StackPlan.from_config(cfg)

    def take(sub, n):
        if isinstance(sub, dict):
            return {key: take(v, n) for key, v in sub.items()}
        return np.asarray(sub)[n]

    layers = [take(tree["blocks"][i % plan.period], i // plan.period)
              for i in range(plan.n_scan * plan.period)]
    return layers + list(tree["tail"])


def _flatten(sub, prefix: str, out: Dict[str, np.ndarray]):
    items = sub.items() if isinstance(sub, dict) else enumerate(sub)
    for key, v in items:
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(v, (dict, list, tuple)):
            _flatten(v, name, out)
        else:
            out[name] = np.asarray(v)
    return out


def reference_named(cfg: ModelConfig, tree) -> Dict[str, np.ndarray]:
    """A reference params-shaped tree (the params, their gradients, an
    AdamW moment) by the port's parameter names."""
    if cfg.is_encoder_decoder:
        return _flatten(tree, "", {})
    flat = _flatten({k: v for k, v in tree.items()
                     if k not in ("blocks", "tail")}, "", {})
    for i, layer in enumerate(reference_layers(cfg, tree)):
        _flatten(layer, f"layers.{i}", flat)
    return flat


def from_reference(cfg: ModelConfig, tree, device="cuda"):
    """The port's model (a ``Decoder`` or an ``EncDec``) holding the
    reference's parameters ``tree``."""
    model = tf.model_class(cfg)(cfg, device="meta")
    axes = param_axes(model)
    model.load_state_dict({n: torch.tensor(a, device=device)
                           for n, a in reference_named(cfg, tree).items()},
                          assign=True)
    return set_param_axes(model, axes)


def opt_state_from_reference(cfg: ModelConfig, state,
                             device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves) as the port's: the
    step an int32 tensor, ``mu`` and ``nu`` by parameter name."""
    def moments(tree):
        return {n: torch.tensor(a, dtype=torch.float32, device=device)
                for n, a in reference_named(cfg, tree).items()}
    return AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=device),
                      mu=moments(state.mu), nu=moments(state.nu))


def caches_from_reference(cfg: ModelConfig, caches, device="cuda"):
    """The reference's decoder cache tree as the port's per-layer list;
    an encoder-decoder's ``{'self', 'cross'}`` lists as the port's."""
    def layers(tree):
        return [{n: torch.tensor(np.asarray(c), device=device)
                 for n, c in layer.items()} for layer in tree]
    if cfg.is_encoder_decoder:
        return {k: layers(caches[k]) for k in ("self", "cross")}
    return layers(reference_layers(cfg, caches))
