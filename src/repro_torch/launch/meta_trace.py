"""Counting what a step does without running it: a dispatch mode over
``meta`` tensors.

The dry-run (``launch/dryrun.py``) runs each step with every tensor on
PyTorch's ``meta`` device, which allocates nothing. :class:`MetaTrace`
sits under autograd and sees every aten op of such a trace. It

* counts the **bytes** each op moves: the bytes of its tensor inputs
  (read) and outputs (written), each tensor counted by the elements it
  addresses (a broadcast dimension once). View and metadata ops (outputs
  that alias an input, or no tensor output) count nothing;
* tracks the **live bytes**: each storage an op creates is added when it
  appears and taken away when it dies (a ``weakref.finalize`` on the
  storage), and the peak is kept. Tensors made before the mode was entered
  (the step's arguments) are not counted;
* reuses output metadata: on ``meta`` an op's outputs depend only on its
  inputs' shapes, strides and dtypes and its other arguments, so a repeat
  of an op (a chunk loop's body) gets fresh ``meta`` tensors of the
  remembered layout instead of running the op's meta function again,
  which for elementwise ops is Python and costs about half a millisecond.
  Only ops that neither mutate nor alias an input are reused, and only when
  the remembered layout fills its storage exactly.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_MISS = object()


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: its element count over the
    dimensions whose stride is not 0, times the element size."""
    stride = t.stride()
    if 0 not in stride:
        return t.numel() * t.element_size()
    n = 1
    for size, st in zip(t.shape, stride):
        if st != 0:
            n *= size
    return n * t.element_size()


def _key(x, tensors: List[torch.Tensor]):
    """Hashable description of an argument; collects its tensors."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (x.dtype, x.shape, x.stride(), x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_key(e, tensors) for e in x)
    if isinstance(x, dict):
        return tuple((k, _key(v, tensors)) for k, v in sorted(x.items()))
    return x


def _layout(out):
    """The remembered form of an op's outputs, or None when they cannot be
    remade from metadata (a non-tensor output, an offset or a storage
    larger than the layout)."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "meta" or out.storage_offset() != 0:
            return None
        meta = (tuple(out.shape), out.stride(), out.dtype)
        probe = torch.empty_strided(meta[0], meta[1], dtype=meta[2],
                                    device="meta")
        if probe.untyped_storage().nbytes() != \
                out.untyped_storage().nbytes():
            return None
        return meta
    if isinstance(out, (list, tuple)):
        parts = [_layout(o) for o in out]
        if any(p is None for p in parts):
            return None
        return (type(out), parts)
    return None


def _remake(layout):
    if isinstance(layout[0], tuple):
        shape, stride, dtype = layout
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    kind, parts = layout
    return kind(_remake(p) for p in parts)


def _flat_tensors(out, acc: List[torch.Tensor]) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        acc.append(out)
    elif isinstance(out, (list, tuple)):
        for o in out:
            _flat_tensors(o, acc)
    return acc


def _same_layout(ts: List[torch.Tensor], layouts) -> bool:
    return all((tuple(t.shape), t.stride()) == lay
               for t, lay in zip(ts, layouts))


class MetaTrace(TorchDispatchMode):
    """``bytes`` moved, ``live`` and ``peak`` bytes of the storages made
    inside the mode, ``ops`` dispatched (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._memo: Dict[tuple, object] = {}
        self._tracked: Dict[int, weakref.ref] = {}

    def _track(self, st, inputs: set) -> None:
        key = st._cdata
        if key in inputs or key in self._tracked:
            return
        nbytes = st.nbytes()
        self.live += nbytes

        def free(_, key=key, nbytes=nbytes):
            del self._tracked[key]
            self.live -= nbytes
        self._tracked[key] = weakref.ref(st, free)

    def _run(self, func, args, kwargs, ins: List[torch.Tensor], key):
        """The op's outputs, remade from the memo where it can be."""
        mutable = func._schema.is_mutable
        try:
            memo = self._memo.get(key, _MISS)
        except TypeError:           # an unhashable argument
            return func(*args, **kwargs)
        if memo is not _MISS and memo is not None:
            if mutable:             # the outputs are these inputs
                kind, idx = memo
                outs = [ins[i] for i in idx]
                return outs[0] if kind is None else kind(outs)
            return _remake(memo)
        if any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)
        if not mutable:
            out = func(*args, **kwargs)
            self._memo[key] = _layout(out)
            return out
        before = [(tuple(t.shape), t.stride()) for t in ins]
        out = func(*args, **kwargs)
        outs = _flat_tensors(out, [])
        idx = [next((i for i, t in enumerate(ins) if t is o), None)
               for o in outs]
        ok = outs and None not in idx and _same_layout(ins, before) and (
            isinstance(out, torch.Tensor) or type(out) in (list, tuple))
        self._memo[key] = ((None if isinstance(out, torch.Tensor)
                            else type(out)), idx) if ok else None
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        schema = func._schema
        if not schema.is_mutable and any(
                r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)        # a view
        ins: List[torch.Tensor] = []
        key = (func, _key(args, ins), _key(kwargs, ins))
        out = self._run(func, args, kwargs, ins, key)
        outs = _flat_tensors(out, [])
        if not outs:
            return out
        in_storages = {t.untyped_storage()._cdata for t in ins}
        out_storages = [o.untyped_storage() for o in outs]
        if not schema.is_mutable and all(
                st._cdata in in_storages for st in out_storages):
            return out          # a view in all but its schema
        self.bytes += sum(tensor_bytes(t) for t in ins) + \
            sum(tensor_bytes(o) for o in outs)
        for st in out_storages:
            self._track(st, in_storages)
        if self.live > self.peak:
            self.peak = self.live
        return out
