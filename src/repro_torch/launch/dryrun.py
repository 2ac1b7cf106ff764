"""Multi-pod dry-run: prove every (arch x shape x mesh) cell traces at full
width and depth, say whether it fits one card, and price its roofline.

The port of ``repro.launch.dryrun``: the same cell grid (ten archs x four
shapes, less the configs' documented skips, on the 16 x 16 and
2 x 16 x 16 production meshes), CLI flags, record keys (``fits_16g`` is
``fits_80g``), ``TRAIN_MICROBATCH`` table and policies (``fsdp`` for
train, ``tp`` for serving, ``+cp`` on ``long_500k``). PyTorch has no
ahead-of-time SPMD compiler, so each cell is measured thus:

* **Trace on meta.** Each step runs with every tensor on the ``meta``
  device at the cell's per-device shapes (``launch/meta_trace.py``): the
  global batch divided by the data axes ``batch_spec`` uses (``+cp``:
  the cache sequence divided by ``data`` instead). That proves the shapes
  of the whole program agree at full scale and allocates nothing; it never
  touches a card. The steps are the port's own: ``lm.make_train_step``
  with AdamW, ``make_prefill_step``, ``make_decode_step``, the
  encoder-decoder's train and decode steps and ``transformer.
  apply_encdec(mode="prefill")``.
* **FLOPs and bytes** come from cost artifacts traced in cost mode (one
  attention chunk the size of the sequence, one Mamba scan chunk its
  length): ``body`` (one layer period: forward and backward under the
  cell's remat, or prefill, or decode) x ``n_scan``, plus ``tail`` (the
  layers after the last whole period, which the reference leaves out),
  plus ``outer`` (embedding, final norm, unembed, and for train the
  cross entropy and their gradients), all divided by the ``model`` axis,
  plus ``opt`` (``adamw_update`` on one device's shards of the
  parameters). The encoder-decoder's gradient pass or serving step is
  traced whole. FLOPs are ``FlopCounterMode``'s (matmul-class ops); bytes
  each aten op's inputs and outputs, unfused.
* **Memory per device** is argument + output + temp bytes. Argument and
  output bytes are exact arithmetic over the specs: params, AdamW state
  and batch (train: params, AdamW state and 4 metrics out); or params,
  caches, tokens and lengths (serving: logits and caches out). Temp is
  the peak of the storages live during the full-depth step on meta at the
  per-device batch, beyond its arguments (its activations and gradients
  unsharded, an upper bound); with microbatches one microbatch's train
  step plus one device's shards of the f32 gradient accumulators.
* **Collectives** follow one term a rule from the specs (bytes a device
  a step): under train, a leaf sharded over data axes (``n`` the product
  of those it maps to) all-gathers its compute-dtype bytes x (n-1)/n in
  forward and again in backward, and reduce-scatters its f32 gradient x
  (n-1)/n; a leaf replicated over the data axes all-reduces its f32
  gradient x 2(n-1)/n, ``n`` their product. A weight whose
  ``model``-mapped dimension is the one its product contracts (the
  output projections, the embedding's gather) all-reduces its output
  activation, tokens x d_out x 2 B x 2(m-1)/m, once in forward and again
  in backward under train. A MoE layer with its experts over ``model``
  makes two all-to-alls, dispatch and combine, of tokens x top_k x d x 2 B
  each, twice under train.

Roofline terms use one H100 SXM5 80GB at 700 W: 989.4 TFLOP/s dense
bf16, 3.35 TB/s HBM, and 50 GB/s a GPU across nodes (one 400 Gb/s
ConnectX-7 NIC a GPU in an 8-GPU DGX H100 node). What the reference's
XLA-based numbers hold and these do not is listed in ``PERF.md``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --jobs 8 --out dryrun.json
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.meta_trace import MetaTrace
from repro_torch.launch.sharding import (ShardingPolicy, Spec, axes_size,
                                         shard_shape)
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, scalar_in
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import AdamWState, adamw_update

# One H100 SXM5 80GB at its 700 W limit (NVIDIA's data sheet): dense
# bf16, HBM3, and one 400 Gb/s ConnectX-7 NIC a GPU in a DGX H100 node.
# NVLink's 450 GB/s a direction joins the 8 GPUs of one node only; every
# axis of both production meshes is 16 wide, so every collective crosses
# nodes and NVLink's rate is not used here.
HW = {"flops_bf16": 989.4e12, "hbm_bw": 3.35e12, "link_bw": 50e9}
HBM_PER_CHIP = 80e9

# per-arch train-cell gradient-accumulation microbatch (global rows)
TRAIN_MICROBATCH = {
    "qwen2-vl-72b": 32,
    "jamba-v0.1-52b": 32,
    "llama4-scout-17b-a16e": 32,
    "falcon-mamba-7b": 32,
}
DEFAULT_TRAIN_MICROBATCH = 64

# the 2-D projections ``x @ w`` (d_in, d_out), and as 3-D expert weights
# (experts, d_in, d_out); the embedding's gather contracts its vocab dim
_PROJECTIONS = {"wq", "wk", "wv", "wo", "wi", "wg", "router", "in_proj",
                "x_proj", "dt_proj", "out_proj", "wq_a", "wq_b", "wkv_a",
                "wk_b", "wv_b", "lm_head"}


class _cost_mode:
    """Context manager: trace with one attention chunk and one scan chunk
    the length of the sequence, for the cost artifacts."""

    def __enter__(self):
        attn_mod.set_unchunked_for_cost(True)
        mamba_mod.set_unchunked_for_cost(True)

    def __exit__(self, *a):
        attn_mod.set_unchunked_for_cost(False)
        mamba_mod.set_unchunked_for_cost(False)


def _artifact(fn, *, cost_mode: bool) -> Dict[str, Any]:
    """Run ``fn`` on meta tensors under :class:`MetaTrace` (and, in cost
    mode, ``FlopCounterMode``): its FLOPs, bytes, peak live bytes, ops."""
    t0 = time.perf_counter()
    trace = MetaTrace()
    if cost_mode:
        counter = FlopCounterMode(display=False)
        with _cost_mode(), trace, counter:
            fn()
        flops = float(counter.get_total_flops())
    else:
        with trace:
            fn()
        flops = None
    return {"trace_s": round(time.perf_counter() - t0, 2), "flops": flops,
            "bytes": float(trace.bytes), "peak_bytes": trace.peak,
            "ops": trace.ops}


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _positions(cfg: ModelConfig, b: int, l: int):
    pos = torch.arange(l, device="meta").expand(b, l)
    if cfg.mrope_sections:
        pos = pos[None].expand((3,) + pos.shape)
    return pos


def _nbytes(shape, dtype: torch.dtype, spec: Spec, mesh) -> int:
    """One device's bytes of a ``shape`` tensor of ``dtype`` under
    ``spec``."""
    return int(np.prod(shard_shape(shape, spec, mesh), dtype=np.int64)) \
        * torch.empty((), dtype=dtype).element_size()


def _tree_bytes(tensors, specs, mesh) -> int:
    """Per-device bytes of a (nested dict / list) tree of meta tensors
    under the same-shaped tree of specs."""
    if isinstance(tensors, dict):
        return sum(_tree_bytes(tensors[k], specs[k], mesh) for k in tensors)
    if isinstance(tensors, (list, tuple)):
        return sum(_tree_bytes(t, s, mesh) for t, s in zip(tensors, specs))
    return _nbytes(tensors.shape, tensors.dtype, specs, mesh)


def _flat_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _add(total: Dict, op: str, count: float, nbytes: float):
    rec = total.setdefault(op, {"count": 0, "bytes": 0.0})
    rec["count"] += count
    rec["bytes"] += nbytes


def _combine(total: Dict, rec: Dict, mult: float):
    total["flops"] += rec["flops"] * mult
    total["bytes"] += rec["bytes"] * mult


def _contracted_dim(name: str, ndim: int) -> Optional[int]:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _PROJECTIONS:
        return 1 if ndim == 3 else 0
    if leaf == "embed":
        return 0
    return None


def collectives(cfg: ModelConfig, model, pspecs: Dict[str, Spec],
                policy: ShardingPolicy, kind: str, tokens: int,
                enc_tokens: int = 0) -> Dict[str, Dict[str, float]]:
    """Collective bytes a device a step, one term a rule (module
    docstring). ``tokens`` are one device's decoder tokens (or the
    decoder-only model's), ``enc_tokens`` its encoder frames."""
    mesh = policy.shape
    data_axes = policy.data_axes
    m = mesh.get("model", 1)
    n_all = int(np.prod([mesh[a] for a in data_axes]))
    cd_bytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
    train = kind == "train"
    passes = 2 if train else 1
    out: Dict[str, Dict[str, float]] = {}
    for name, p in model.named_parameters():
        spec = pspecs[name]
        mapped = [a for e in spec for a in _flat_axes(e)]
        n = int(np.prod([mesh[a] for a in mapped if a in data_axes]))
        others = int(np.prod([mesh[a] for a in mapped
                              if a not in data_axes]))
        group = p.numel() // others     # one data group's share
        if train and n > 1:
            _add(out, "all-gather", 2, 2 * group * cd_bytes * (n - 1) / n)
            _add(out, "reduce-scatter", 1, group * 4 * (n - 1) / n)
        elif train and n_all > 1:
            _add(out, "all-reduce", 1,
                 group * 4 * 2 * (n_all - 1) / n_all)
        dim = _contracted_dim(name, p.ndim)
        if dim is None or m == 1 or "model" not in _flat_axes(spec[dim]):
            continue
        toks = enc_tokens if name.startswith("encoder.") or (
            name.startswith("cross.") and name.rsplit(".", 1)[-1]
            in ("wk", "wv")) else tokens
        if p.ndim == 3:
            toks *= cfg.moe_top_k
        _add(out, "all-reduce", passes,
             passes * toks * p.shape[-1] * 2 * 2 * (m - 1) / m)
    if cfg.moe_num_experts and m > 1:
        for i, kind_i in enumerate(tf.layer_kinds(cfg)):
            if kind_i.ff != "moe" or "model" not in _flat_axes(
                    pspecs[f"layers.{i}.ff.wi"][0]):
                continue
            a2a = tokens * cfg.moe_top_k * cfg.d_model * 2
            _add(out, "all-to-all", 2 * passes, 2 * passes * a2a)
    return out


# ---------------------------------------------------------------------------
# Cost artifacts
# ---------------------------------------------------------------------------

def _layers_fn(cfg, layers, b: int, l: int, mode: str, remat: str,
               cache_len: int = 0):
    """A function running ``layers`` (consecutive ``tf.Layer``s) on a meta
    batch: forward and backward for train (loss: the sum of the output),
    or prefill / decode over per-layer caches of ``cache_len``."""
    cd = cfg.compute_dtype

    def train():
        x = _meta((b, l, cfg.d_model), cd).requires_grad_(True)
        pos = _positions(cfg, b, l)

        def run(layer, h):
            return tf.apply_layer(layer, h, cfg, layer.kind, positions=pos,
                                  mode="train")[0]
        h = x
        for layer in layers:
            h = tf._remat(run, remat, layer, h)
        params = [p for layer in layers for p in layer.parameters()]
        torch.autograd.grad(h.float().sum(), params + [x])

    @torch.no_grad()
    def serve():
        x = _meta((b, l, cfg.d_model), cd)
        if mode == "decode":
            lens = _meta((b,), torch.int32)
            pos = lens.reshape(-1, 1).expand(b, 1)
            if cfg.mrope_sections:
                pos = pos[None].expand((3,) + pos.shape)
        else:
            lens, pos = None, _positions(cfg, b, l)
        for layer in layers:
            cache = tf.init_layer_cache(cfg, layer.kind, b, cache_len, cd,
                                        "meta")
            x = tf.apply_layer(layer, x, cfg, layer.kind, positions=pos,
                               cache=cache, cache_len=lens, mode=mode)[0]

    return train if mode == "train" else serve


def _outer_fn(cfg, model, b: int, l: int, mode: str):
    """Embedding, final norm and unembed; for train the chunked cross
    entropy over the whole length and the gradients of those weights."""
    cd = cfg.compute_dtype

    def hidden(tokens):
        x = model.embed[tokens].to(cd) * scalar_in(cfg.d_model ** 0.5, cd)
        return rms_norm(x, model.final_norm - 1.0, cfg.norm_eps)

    def train():
        tokens = _meta((b, l), torch.int64)
        loss = lm.chunked_cross_entropy(model, hidden(tokens), tokens, cfg,
                                        chunk=l)
        weights = [model.embed, model.final_norm]
        if not cfg.tie_embeddings:
            weights.append(model.lm_head)
        torch.autograd.grad(loss, weights)

    @torch.no_grad()
    def serve():
        h = hidden(_meta((b, l), torch.int64))
        tf.unembed(model, h[:, -1], cfg)

    return train if mode == "train" else serve


def _decoder_costs(cfg, model, b: int, length: int, mode: str, remat: str,
                   cache_len: int, m: int, arts: Dict, total: Dict) -> None:
    """A decoder's cost artifacts into ``arts``, their sum a device into
    ``total``: one layer period x ``n_scan``, the tail layers once and the
    outer ops once, each divided over ``m`` (the ``model`` axis)."""
    plan = tf.StackPlan.from_config(cfg)
    suffix = "grad" if mode == "train" else mode
    for name, layers, mult in (
            ("body", model.layers[:plan.period], plan.n_scan),
            ("tail", model.layers[plan.n_scan * plan.period:], 1)):
        if len(layers):
            art = arts[f"{name}_{suffix}"] = _artifact(
                _layers_fn(cfg, list(layers), b, length, mode, remat,
                           cache_len), cost_mode=True)
            _combine(total, art, mult / m)
    art = arts["outer_grad" if mode == "train" else "outer"] = _artifact(
        _outer_fn(cfg, model, b, length, mode), cost_mode=True)
    _combine(total, art, 1.0 / m)


def _opt_fn(model, pspecs, mesh):
    """``adamw_update`` on one device's shard of every parameter."""
    def run():
        named = {n: _meta(shard_shape(p.shape, pspecs[n], mesh))
                 for n, p in model.named_parameters()}
        grads = {n: _meta(t.shape) for n, t in named.items()}
        state = AdamWState(step=_meta((), torch.int32),
                           mu={n: _meta(t.shape) for n, t in named.items()},
                           nu={n: _meta(t.shape) for n, t in named.items()})
        adamw_update(named, grads, state, AdamWConfig(), 1.0)
    return run


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _geometry(policy: ShardingPolicy, shape: ShapeSpec):
    """(per-device batch, per-device cache length, batch shards)."""
    b_, l_ = shape.global_batch, shape.seq_len
    if policy.context_parallel:
        return b_, l_ // policy.shape.get("data", 1), 1
    shards = axes_size(policy.shape, policy.batch_spec(b_)[0])
    return b_ // shards, l_, shards


def build_cell(cfg: ModelConfig, shape: ShapeSpec, policy: ShardingPolicy,
               remat: str = "dots", microbatch: int = 0) -> Dict[str, Any]:
    """Trace one cell: artifacts, totals (FLOPs, bytes, collectives a
    device), the memory terms and ``per_device_bytes``. The MoE's dispatch
    groups (``moe.MOE_GROUPS``, global) are split over the batch shards
    for the per-device traces, as the reference's partitioner splits its
    group axis over the data axes."""
    groups = moe_mod.MOE_GROUPS
    moe_mod.set_moe_groups(max(1, groups // _geometry(policy, shape)[2]))
    try:
        return _build_cell(cfg, shape, policy, remat, microbatch)
    finally:
        moe_mod.set_moe_groups(groups)


def _build_cell(cfg, shape, policy, remat, microbatch):
    b_, l_ = shape.global_batch, shape.seq_len
    mesh = policy.shape
    m = mesh.get("model", 1)
    cd = cfg.compute_dtype
    b_dev, s_dev, shards = _geometry(policy, shape)
    model, specs = lm.abstract_params(cfg)
    train = shape.kind == "train"
    if not train:
        model = lm.cast_weights(model, cd)
    pspecs = policy.param_shardings(model, specs)
    params_bytes = sum(_nbytes(p.shape, p.dtype, pspecs[n], mesh)
                       for n, p in model.named_parameters())
    arts: Dict[str, Any] = {}
    total = {"flops": 0.0, "bytes": 0.0}
    dec_len = min(448, max(l_ // 8, 64))

    if train:
        arg_bytes = 3 * params_bytes + 4          # params, mu, nu, step
        out_bytes = arg_bytes + (2 if cfg.is_encoder_decoder else 4) * 4
        opt_state = adamw_init(model)
        step_cfg = AdamWConfig()
        if cfg.is_encoder_decoder:
            batch_global = {"audio_embeds": _meta((b_, l_, cfg.d_model), cd),
                            "tokens": _meta((b_, dec_len + 1), torch.int32)}
            batch_specs = {"audio_embeds": policy.data_sharding(b_, 3),
                           "tokens": policy.data_sharding(b_, 2)}
            batch = {"audio_embeds": _meta((b_dev, l_, cfg.d_model), cd),
                     "tokens": _meta((b_dev, dec_len + 1), torch.int32)}
            step = lm.make_encdec_train_step(cfg, step_cfg)
            micro, accum = 0, 0
            arts["full"] = _artifact(
                lambda: step(model, opt_state, batch), cost_mode=False)
            cost = _artifact(lambda: lm.encdec_grads_of(model, batch, cfg),
                             cost_mode=True)
            arts["cost_full"] = cost
            _combine(total, cost, 1.0 / m)
            tokens, enc_tokens = b_dev * dec_len, b_dev * l_
        else:
            batch_global = {"tokens": _meta((b_, l_ + 1), torch.int32)}
            batch_specs = {"tokens": policy.data_sharding(b_, 2)}
            micro = max(1, microbatch // shards) if microbatch else 0
            n_micro = b_dev // micro if micro and micro < b_dev else 1
            rows = micro if n_micro > 1 else b_dev
            step = lm.make_train_step(cfg, step_cfg, remat=remat)
            batch = {"tokens": _meta((rows, l_ + 1), torch.int32)}
            arts["full"] = _artifact(
                lambda: step(model, opt_state, batch), cost_mode=False)
            accum = params_bytes if n_micro > 1 else 0   # f32 shards
            _decoder_costs(cfg, model, b_dev, l_, "train", remat, 0, m,
                           arts, total)
            tokens, enc_tokens = b_dev * l_, 0
        arg_bytes += _tree_bytes(batch_global, batch_specs, mesh)
        arts["opt"] = _artifact(_opt_fn(model, pspecs, mesh), cost_mode=True)
        _combine(total, arts["opt"], 1.0)
        temp = arts["full"]["peak_bytes"] + accum
    else:
        decode = shape.kind == "decode"
        if cfg.is_encoder_decoder:
            caches_global = lm.init_caches(cfg, b_, dec_len, dtype=cd,
                                           device="meta", src_len=l_)
            caches = lm.init_caches(cfg, b_dev, dec_len, dtype=cd,
                                    device="meta", src_len=s_dev)
            if decode:
                step = lm.make_encdec_decode_step(cfg)
                args = (model, caches, _meta((b_dev, 1), torch.int32),
                        _meta((b_dev,), torch.int32))
                in_global = [_meta((b_, 1), torch.int32),
                             _meta((b_,), torch.int32)]
                tokens, enc_tokens = b_dev, 0
            else:
                @torch.no_grad()
                def step(params, caches, audio, tokens):
                    logits, caches, _ = tf.apply_encdec(
                        params, audio, tokens, cfg, mode="prefill",
                        caches=caches)
                    return logits[:, -1], caches
                args = (model, caches, _meta((b_dev, s_dev, cfg.d_model), cd),
                        _meta((b_dev, dec_len), torch.int32))
                in_global = [_meta((b_, l_, cfg.d_model), cd),
                             _meta((b_, dec_len), torch.int32)]
                tokens, enc_tokens = b_dev * dec_len, b_dev * l_
            arts["full"] = _artifact(lambda: step(*args), cost_mode=False)
            arts["cost_full"] = _artifact(lambda: step(*args),
                                          cost_mode=True)
            _combine(total, arts["cost_full"], 1.0 / m)
        else:
            caches_global = lm.init_caches(cfg, b_, l_, dtype=cd,
                                           device="meta")
            caches = lm.init_caches(cfg, b_dev, s_dev, dtype=cd,
                                    device="meta")
            if decode:
                step = lm.make_decode_step(cfg)
                args = (model, caches, _meta((b_dev, 1), torch.int32),
                        _meta((b_dev,), torch.int32))
                in_global = [_meta((b_, 1), torch.int32),
                             _meta((b_,), torch.int32)]
                length, tokens = 1, b_dev
            else:
                step = lm.make_prefill_step(cfg)
                args = (model, caches, _meta((b_dev, l_), torch.int32))
                in_global = [_meta((b_, l_), torch.int32)]
                length, tokens = l_, b_dev * l_
            enc_tokens = 0
            arts["full"] = _artifact(lambda: step(*args), cost_mode=False)
            _decoder_costs(cfg, model, b_dev, length, shape.kind, remat,
                           s_dev, m, arts, total)
        cache_bytes = _tree_bytes(caches_global,
                                  policy.cache_sharding(caches_global, b_),
                                  mesh)
        arg_bytes = params_bytes + cache_bytes + sum(
            _nbytes(t.shape, t.dtype, policy.data_sharding(b_, t.ndim), mesh)
            for t in in_global)
        logits = policy.activation_spec("logits", (b_, cfg.vocab_size))
        out_bytes = cache_bytes + _nbytes((b_, cfg.vocab_size),
                                          torch.float32, logits, mesh)
        temp = arts["full"]["peak_bytes"]
        micro = None
    total["collectives"] = collectives(cfg, model, pspecs, policy,
                                       shape.kind, tokens, enc_tokens)
    mem = {"argument_bytes": int(arg_bytes), "output_bytes": int(out_bytes),
           "temp_bytes": int(temp)}
    arts["full"]["mem"] = mem
    return {"artifacts": arts, "totals": total,
            "per_device": {"batch": b_dev, "seq": s_dev,
                           "microbatch": micro},
            "per_device_bytes": sum(mem.values())}


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

def roofline(cell: Dict[str, Any], cfg: ModelConfig, shape: ShapeSpec,
             chips: int) -> Dict[str, Any]:
    """Three roofline terms in seconds: one device's FLOPs, bytes and
    collective bytes against one card's peaks."""
    t = cell["totals"]
    coll_bytes = sum(s["bytes"] for s in t["collectives"].values())
    compute_s = t["flops"] / HW["flops_bf16"]
    memory_s = t["bytes"] / HW["hbm_bw"]
    collective_s = coll_bytes / HW["link_bw"]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        model_flops = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        model_flops = 2.0 * n_active * tokens
    hlo_flops_global = t["flops"] * chips
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": max(
            (("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)), key=lambda kv: kv[1])[0],
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_ratio": model_flops / hlo_flops_global
        if hlo_flops_global else None,
        "coll_bytes_per_device": coll_bytes,
    }


def evaluate(rec: Dict[str, Any], cfg: ModelConfig, shape: ShapeSpec,
             policy: ShardingPolicy, *, remat: str = "dots",
             microbatch: int = 0, want_roofline: bool = True
             ) -> Dict[str, Any]:
    """Fill ``rec`` with one cell's results (``status`` ok or error, with
    the traceback)."""
    t0 = time.time()
    try:
        cell = build_cell(cfg, shape, policy, remat=remat,
                          microbatch=microbatch)
        rec.update(cell)
        rec["status"] = "ok"
        rec["fits_80g"] = bool(rec["per_device_bytes"] < HBM_PER_CHIP)
        if want_roofline:
            rec["roofline"] = roofline(cell, cfg, shape, rec["chips"])
    except Exception as e:  # noqa: BLE001 - a cell's failure is its record
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             policy_name: Optional[str] = None, remat: str = "dots",
             want_roofline: bool = True, microbatch: int = 0,
             opt_unembed: bool = False, opt_attn: bool = False
             ) -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    cfg = configs.get_config(arch)
    skips = configs.shape_skips(arch)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
    }
    if shape_name in skips:
        rec["status"] = "skipped"
        rec["reason"] = skips[shape_name]
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    cp = shape_name == "long_500k"
    pol_name = policy_name or ("fsdp" if shape.kind == "train" else "tp")
    policy = ShardingPolicy(mesh, pol_name, context_parallel=cp,
                            opt_unembed_gather=opt_unembed,
                            opt_attn_sharding=opt_attn)
    rec["policy"] = pol_name + ("+cp" if cp else "") + \
        ("+ueg" if opt_unembed else "") + ("+attn" if opt_attn else "")
    rec["remat"] = remat if shape.kind == "train" else None
    if shape.kind == "train":
        if microbatch < 0:
            microbatch = TRAIN_MICROBATCH.get(arch, DEFAULT_TRAIN_MICROBATCH)
        rec["microbatch"] = microbatch
    return evaluate(rec, cfg, shape, policy, remat=remat,
                    microbatch=microbatch, want_roofline=want_roofline)


def _cell_job(job) -> Dict[str, Any]:
    """One grid cell in a worker process: the MoE settings, then the cell."""
    arch, shape, multi, kw, dispatch, groups = job
    moe_mod.set_dispatch_mode(dispatch)
    moe_mod.set_moe_groups(groups)
    rec = run_cell(arch, shape, multi, **kw)
    rec["moe_dispatch"] = dispatch
    rec["moe_groups"] = groups
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run of the "
                                 "port's steps, traced on meta")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--policy", default=None)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--opt-unembed", action="store_true")
    ap.add_argument("--opt-attn", action="store_true")
    ap.add_argument("--microbatch", type=int, default=-1,
                    help="-1: per-arch default")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "scatter", "auto"])
    ap.add_argument("--moe-groups", type=int, default=1,
                    help="0 = auto (data-axis size)")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    kw = dict(policy_name=args.policy, remat=args.remat,
              microbatch=args.microbatch, opt_unembed=args.opt_unembed,
              opt_attn=args.opt_attn)
    jobs = []
    for multi in meshes:
        mesh_name = "2x16x16" if multi else "16x16"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done:
                    continue
                g = args.moe_groups or (32 if multi else 16)
                jobs.append((arch, shape, multi, kw, args.moe_dispatch, g))

    def record(job, rec):
        print(f"=== {job[0]} x {job[1]} x {rec['mesh']} -> "
              f"{rec['status']}" + (f" ({rec.get('error')})"
                                    if rec["status"] == "error" else
                                    f" wall={rec.get('wall_s')}s"),
              flush=True)
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)

    if args.jobs <= 1:
        for job in jobs:
            record(job, _cell_job(job))
    else:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=args.jobs, mp_context=ctx) as pool:
            # records in grid order; each is written as soon as it and the
            # ones before it are done
            for job, rec in zip(jobs, pool.map(_cell_job, jobs)):
                record(job, rec)
    print(f"wrote {args.out}: {len(results)} cells")
    return results


if __name__ == "__main__":
    main()
