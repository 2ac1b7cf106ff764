"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

The port of ``repro.launch.sharding``: the same rules over a mesh's
name -> size map, read from a :class:`~repro_torch.launch.mesh.
LogicalMesh` or a ``torch.distributed`` ``DeviceMesh``. Parallelism
policies over the production mesh (pod, data, model):

* ``tp``    — Megatron tensor parallel: weight output/expert/vocab axes over
              'model'; batch over ('pod','data'); weights replicated over
              'data' (fits small models).
* ``fsdp``  — tp + weights' 'embed' axis sharded over ('pod','data')
              (ZeRO-3: params, grads, and optimizer state all sharded over
              the data dimension).
* ``cp``    — context parallelism for long-context decode: KV-cache/state
              sequence dim over 'data' (batch too small to shard), weights
              as tp/fsdp.

Every mapping is divisibility-checked against the actual dim; on mismatch
the axis falls back to replication. A spec is a :class:`Spec`, one entry a
tensor dimension. Eager PyTorch has no partitioner to act on a sharding
constraint, so :meth:`ShardingPolicy.shard_fn` returns its input and the
models take no such hook; :meth:`ShardingPolicy.activation_spec` says
which spec the reference's ``shard_fn`` would constrain a tensor to.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .mesh import LogicalMesh

# logical axis -> candidate mesh axes, per policy
_RULES = {
    "tp": {
        "vocab": ("model",),
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "state": None,
        "embed": None,
        "lora": None,
    },
    "fsdp": {
        "vocab": ("model",),
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "embed": ("pod", "data"),      # ZeRO-3 over the data dimension(s)
        "state": None,
        "lora": None,
    },
}


class Spec(tuple):
    """A partition spec: for each tensor dimension ``None`` (replicated),
    a mesh axis name, or a tuple of names (``jax.sharding.PartitionSpec``'s
    form)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``LogicalMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, LogicalMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axes_size(shape: Dict[str, int], entry) -> int:
    """The number of shards a spec entry makes over ``shape``."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return int(np.prod([shape[n] for n in names]))


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh: Dict[str, int]) -> Tuple[int, ...]:
    """One device's block of a ``shape`` tensor under ``spec``: each
    dimension divided by the product of the mesh axes it maps to."""
    out = []
    for i, dim in enumerate(shape):
        k = axes_size(mesh, spec[i]) if i < len(spec) else 1
        if dim % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {spec[i]} ({k})")
        out.append(dim // k)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: object                    # a LogicalMesh or a DeviceMesh
    policy: str = "fsdp"            # 'tp' | 'fsdp'
    context_parallel: bool = False  # long_500k: KV seq over 'data'
    # the reference's two optimization knobs, kept as flags: re-constrain
    # the unembed weights to ('model', None) before the logits matmul, and
    # place attention q/k/v heads over 'model' when divisible, else
    # sequence-parallel q. They change only :meth:`activation_spec`.
    opt_unembed_gather: bool = False
    opt_attn_sharding: bool = False

    # ------------------------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        shape = self.shape
        return tuple(a for a in ("pod", "data") if a in shape)

    def _axis_size(self, names) -> int:
        shape = self.shape
        return int(np.prod([shape[n] for n in names]))

    def _map_axis(self, logical: Optional[str], dim: int, used: set):
        if logical is None:
            return None
        rule = _RULES[self.policy].get(logical)
        if rule is None:
            return None
        shape = self.shape
        names = tuple(n for n in rule if n in shape and n not in used)
        if not names:
            return None
        if dim % self._axis_size(names) != 0:
            # try a shrinking suffix before giving up
            while names and dim % self._axis_size(names) != 0:
                names = names[1:]
            if not names:
                return None
        for n in names:
            used.add(n)
        return names if len(names) > 1 else names[0]

    def param_spec(self, shape, logical) -> Spec:
        used: set = set()
        # map the most-parallel axes first (model before data)
        order = sorted(range(len(shape)),
                       key=lambda i: 0 if logical[i] in
                       ("vocab", "heads", "kv", "mlp", "experts") else 1)
        resolved = [None] * len(shape)
        for i in order:
            resolved[i] = self._map_axis(logical[i], shape[i], used)
        return Spec(*resolved)

    def param_shardings(self, params, specs: Dict[str, Tuple[str, ...]]
                        ) -> Dict[str, Spec]:
        """``{name: Spec}`` of a model's parameters (an ``nn.Module`` or
        ``{name: tensor or shape}``) from their logical ``specs``."""
        named = (dict(params.named_parameters())
                 if hasattr(params, "named_parameters") else params)
        return {n: self.param_spec(tuple(getattr(t, "shape", t)), specs[n])
                for n, t in named.items()}

    # ------------------------------------------------------------------
    def batch_spec(self, batch_size: int) -> Spec:
        shape = self.shape
        axes = [a for a in self.data_axes
                if batch_size % self._axis_size((a,)) == 0]
        # greedy: use as many data axes as divide the batch
        use = []
        prod = 1
        for a in axes:
            if batch_size % (prod * shape[a]) == 0:
                use.append(a)
                prod *= shape[a]
        return Spec(tuple(use) if len(use) > 1 else
                    (use[0] if use else None))

    def data_sharding(self, batch_size: int, ndim: int) -> Spec:
        spec = [None] * ndim
        spec[0] = self.batch_spec(batch_size)[0]
        return Spec(*spec)

    def cache_spec(self, shape, batch_size: int) -> Spec:
        """One per-layer cache's spec, by rank and shape:

        (B, S, H, D): batch->data; heads->model when divisible, else the
                      sequence dim shards over 'model' (flash-decoding
                      parallelism).
        (B, x, y):    latent KV (MLA) or Mamba states: batch->data, the
                      larger of x/y -> model.
        context_parallel (long_500k): sequence additionally over 'data'
        (batch=1 cannot use it).

        The reference detects and skips the leading layers axis of its
        stacked caches; the port's caches are one a layer and have none.
        """
        shape = tuple(shape)
        mesh = self.shape
        model_size = mesh.get("model", 1)
        data_size = mesh.get("data", 1)
        nd = len(shape)
        spec = [None] * nd
        if shape[0] == batch_size and not self.context_parallel:
            spec[0] = self.batch_spec(batch_size)[0]
        if nd == 4:  # (B, S, H, D)
            spos, hpos = 1, 2
            seq_axes = []
            if self.context_parallel and shape[spos] % data_size == 0:
                seq_axes.append("data")
            if shape[hpos] % model_size == 0:
                spec[hpos] = "model"
            elif shape[spos] % (data_size if seq_axes else 1) == 0 and \
                    shape[spos] % ((data_size if seq_axes else 1)
                                   * model_size) == 0:
                seq_axes.append("model")
            if seq_axes:
                spec[spos] = tuple(seq_axes) if len(seq_axes) > 1 \
                    else seq_axes[0]
        elif nd == 3:
            mid, last = shape[1], shape[2]
            # prefer sharding the larger dimension over 'model'
            cands = sorted([(mid, 1), (last, 2)], reverse=True)
            for dim, pos in cands:
                if dim % model_size == 0 and dim >= model_size:
                    spec[pos] = "model"
                    break
            if self.context_parallel and spec[1] is None and \
                    mid % data_size == 0 and mid > 4096:
                spec[1] = "data"
        return Spec(*spec)

    def cache_sharding(self, caches, batch_size: int):
        """The caches' structure (a decoder's list of per-layer dicts, or
        an encoder-decoder's ``{'self', 'cross'}`` lists) with a
        :class:`Spec` in place of each tensor (or shape)."""
        if isinstance(caches, dict):
            return {k: self.cache_sharding(v, batch_size)
                    for k, v in caches.items()}
        if isinstance(caches, (list, tuple)):
            return [self.cache_sharding(v, batch_size) for v in caches]
        return self.cache_spec(getattr(caches, "shape", caches), batch_size)

    # ------------------------------------------------------------------
    def activation_spec(self, name: str, shape) -> Optional[Spec]:
        """The spec the reference's ``shard_fn(name, x)`` constrains an
        activation of ``shape`` to (``src/repro/launch/sharding.py:
        186-240``); None where it leaves ``x`` unconstrained."""
        shape = tuple(shape)
        nd = len(shape)
        model = self.shape.get("model", 1)
        if name in ("activations", "residual"):
            spec = [None] * nd
            if not self.context_parallel and nd >= 2:
                spec[0] = self.batch_spec(shape[0])[0]
            return Spec(*spec)
        if name == "logits":
            spec = [None] * nd
            if not self.context_parallel:
                spec[0] = self.batch_spec(shape[0])[0]
            if shape[-1] % model == 0:
                spec[-1] = "model"
            return Spec(*spec)
        if name in ("attn_q", "attn_kv") and self.opt_attn_sharding:
            if nd != 4:     # the reference's unpacking raises; x unchanged
                return None
            b_, l_, h_, _ = shape   # (B, L, H, Dh)
            spec = [None] * 4
            if not self.context_parallel:
                spec[0] = self.batch_spec(b_)[0]
            if h_ % model == 0:
                spec[2] = "model"
            elif name == "attn_q" and l_ % model == 0 and l_ >= model:
                spec[1] = "model"   # sequence-parallel q; KV gathered
            return Spec(*spec)
        if name == "moe_group":
            # (G, T_loc, D): pin the group axis to the data dimension(s)
            axes = self.data_axes
            if shape[0] == self._axis_size(axes):
                spec = [None] * nd
                spec[0] = axes if len(axes) > 1 else axes[0]
                return Spec(*spec)
            return None
        if name == "unembed_weights" and self.opt_unembed_gather:
            # weights are (vocab, d) or (d, vocab); keep the vocab axis
            # model-sharded and gather the contraction axis
            vpos = 0 if shape[0] >= shape[1] else 1
            spec = [None, None]
            if shape[vpos] % model == 0:
                spec[vpos] = "model"
            return Spec(*spec)
        return None

    def shard_fn(self, name: str, x):
        """The reference's constraint hook: ``x`` itself, since eager
        PyTorch has no partitioner to act on one."""
        return x

    def replicated(self, ndim: int = 0) -> Spec:
        return Spec()
