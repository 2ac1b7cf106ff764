"""Fault-tolerant checkpointing (no external deps).

The port of ``repro.checkpoint.store``, with its directory layout
(``step_XXXXXXXX/`` holding ``shard_host0.npz`` and ``meta.json``):

* **Atomicity** — a checkpoint is written to ``step_XXXXXXXX.tmp/`` and
  renamed only after the arrays and the fsynced manifest are written; a
  crash mid-write never corrupts the latest checkpoint, and a leftover
  ``.tmp`` directory is ignored and replaced.
* **Leaves by name** — a tree is flattened in a fixed order (an
  ``nn.Module``'s state dict in its own order, a dict's items, a
  NamedTuple's fields, a list's items) into named tensors or arrays;
  ``meta.json`` records the names and shapes, and a restore into a tree
  with other names or shapes raises. A restore copies each array into
  its leaf in place, so it lands on the leaf's own device.
* **Async** — ``save_async`` copies the leaves to host memory
  synchronously and writes the files on a background thread, so the
  train loop overlaps checkpoint IO with compute; an error surfaces on
  the next ``wait()``.
* **Retention** — keep-last-N garbage collection.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

SEP = "/"   # between the levels of a leaf's name


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of ``tree`` in a fixed order; the leaves are
    tensors and numpy arrays."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        items = tree.state_dict(keep_vars=True).items()
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{prefix or 'the root'}")
    out = []
    for key, sub in items:
        out += flatten(sub, f"{prefix}{SEP}{key}" if prefix else str(key))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # numpy has no bf16
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _snapshot(leaf):
    """A host copy of ``leaf`` that later writes to it do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    keep: int = 3) -> str:
    """Write a checkpoint atomically. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(leaf)
              for i, (_, leaf) in enumerate(leaves)}
    np.savez(os.path.join(tmp, "shard_host0.npz"), **arrays)
    meta = {"step": step, "num_leaves": len(leaves),
            "names": [name for name, _ in leaves],
            "shapes": [list(a.shape) for a in arrays.values()]}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _steps(directory: str) -> List[str]:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _gc(directory: str, keep: int):
    for d in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    ckpts = _steps(directory)
    if not ckpts:
        return None
    return int(ckpts[-1].split("_")[1])


@torch.no_grad()
def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None):
    """Copy a checkpoint (the latest unless ``step``) into the leaves of
    ``tree_like`` in place; returns ``(tree_like, step)``. Raises when the
    checkpoint's leaf names or shapes differ from the tree's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves = flatten(tree_like)
    names = [name for name, _ in leaves]
    shapes = [list(leaf.shape) for _, leaf in leaves]
    if meta["names"] != names or meta["shapes"] != shapes:
        missing = sorted(set(meta["names"]) - set(names))
        extra = sorted(set(names) - set(meta["names"]))
        raise ValueError(
            f"checkpoint {path} has {meta['num_leaves']} leaves, the tree "
            f"{len(leaves)}: only in the checkpoint {missing[:5]}, only in "
            f"the tree {extra[:5]}, or their shapes differ")
    with np.load(os.path.join(path, "shard_host0.npz")) as data:
        for i, (_, leaf) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.from_numpy(arr))
            else:
                np.copyto(leaf, arr)
    return tree_like, step


class CheckpointManager:
    """Async checkpointing with retention, for the train loop."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any):
        self.wait()
        # snapshot to host memory synchronously; IO on the worker thread
        host = {name: _snapshot(leaf) for name, leaf in flatten(tree)}

        def work():
            try:
                save_checkpoint(self.directory, step, host, keep=self.keep)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def latest_step(self):
        return latest_step(self.directory)

    def restore(self, tree_like):
        return restore_checkpoint(self.directory, tree_like)
