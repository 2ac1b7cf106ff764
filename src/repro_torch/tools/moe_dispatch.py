"""Ocean's estimation idea applied to MoE dispatch.

Per-expert buffer capacity is an output-size-estimation problem: the exact
answer needs a full histogram over all tokens (the paper's 'symbolic
pass'); Ocean's analysis-step analogue samples ~3% of tokens and derives a
conservative capacity. This demo (the port of ``examples/moe_dispatch.py``)
compares plan quality and cost on the OLMoE-style router (64 experts,
top-8), runs a MoE layer under both capacities and both dispatches, and
multiplies the expert co-routing product ``C = D^T @ D`` twice through
``SpGEMMService``, the second time a plan-cache hit.

    PYTHONPATH=src python -m repro_torch.tools.moe_dispatch [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import formats
from repro_torch.models import lm, moe
from repro_torch.serving import SpGEMMService


def router_logits(tokens: int, e: int, seed: int = 0) -> np.ndarray:
    """A skewed router: three hot experts, as in trained routers."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((tokens, e)).astype(np.float32)
    logits[:, :3] += 1.2
    return logits


def plan_capacity(logits: np.ndarray, k: int) -> dict:
    """Exact and sampled capacity plans, with the time each took."""
    t0 = time.perf_counter()
    exact = moe.calibrate_capacity(logits, k, method="exact")
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe.calibrate_capacity(logits, k, method="sampled", validate=False)
    t_sampled = time.perf_counter() - t0
    sampled = moe.calibrate_capacity(logits, k, method="sampled")
    return {"exact": exact, "sampled": sampled, "exact_s": t_exact,
            "sampled_s": t_sampled}


def run_dispatch(layer, cfg, x, sampled_cf: float) -> dict:
    """The layer under a static and the sampled capacity (capacity and
    token-drop fraction), and scatter against einsum dispatch."""
    drops = {}
    for label, cf in [("static 1.0", 1.0), ("sampled", sampled_cf)]:
        _, aux = moe.apply_moe(layer, x, cfg, capacity_factor=cf)
        drops[label] = {"capacity": int(aux["capacity"]),
                        "overflow_frac": float(aux["overflow_frac"])}
    o1, _ = moe.apply_moe(layer, x, cfg, dispatch="einsum")
    o2, _ = moe.apply_moe(layer, x, cfg, dispatch="scatter")
    return {"drops": drops,
            "scatter_vs_einsum": float((o1 - o2).abs().max())}


def co_routing(logits: np.ndarray, k: int, device):
    """C = D^T @ D over the top-k assignment D (tokens x experts,
    gate-weighted), served twice: once with the gates, once with drifted
    gates on the same pattern (a plan-cache hit). Returns ``(c1, rep1,
    c2, rep2, service, d, dt)``, D and D^T those of the first call."""
    tokens, e = logits.shape
    topk = np.argsort(-logits, axis=-1)[:, :k]           # (T, k) pattern
    gates = np.take_along_axis(logits, topk, axis=-1)
    gates = np.exp(gates) / np.exp(gates).sum(-1, keepdims=True)

    tok_ids = np.repeat(np.arange(tokens), k)
    exp_ids = topk.reshape(-1)
    t_order = np.argsort(exp_ids, kind="stable")  # row-major for D^T

    def dispatch_csr(gate_vals):
        v = gate_vals.reshape(-1).astype(np.float32)
        d = formats._to_csr(tok_ids, exp_ids, v, tokens, e, device)
        dt = formats._to_csr(exp_ids[t_order], tok_ids[t_order], v[t_order],
                             e, tokens, device)
        return d, dt

    service = SpGEMMService()
    d, dt = dispatch_csr(gates)
    c1, rep1 = service.multiply(dt, d)
    # gate values drift (e.g. a router update), assignment pattern fixed
    d2, dt2 = dispatch_csr(gates * 0.9 + 0.1 / k)
    c2, rep2 = service.multiply(dt2, d2)
    return c1, rep1, c2, rep2, service, d, dt


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the layer and the SpGEMM service "
                    "(default cuda)")
    ap.add_argument("--tokens", type=int, default=32_768)
    args = ap.parse_args()
    dev = formats.resolve_device(args.device)

    e, k = 64, 8
    logits = router_logits(args.tokens, e)
    plans = plan_capacity(logits, k)
    exact, sampled = plans["exact"], plans["sampled"]
    print(f"capacity planning ({e} experts, top-{k}, {args.tokens} tokens):")
    print(f"  exact   : cf={exact.capacity_factor:.3f} "
          f"({plans['exact_s'] * 1e3:.1f} ms, full histogram)")
    cheaper = plans["exact_s"] / max(plans["sampled_s"], 1e-9)
    print(f"  sampled : cf={sampled.capacity_factor:.3f} "
          f"({plans['sampled_s'] * 1e3:.1f} ms, {sampled.sample_fraction:.1%}"
          f" of tokens, x{cheaper:.0f} cheaper)")

    # run the actual MoE layer under both capacities and compare drops
    cfg = configs.get_config("olmoe-1b-7b", smoke=True)
    layer = lm.init_model(cfg, seed=0, device=dev).layers[0].ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((8, 128, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        res = run_dispatch(layer, cfg, x, sampled.capacity_factor)
    for label, r in res["drops"].items():
        print(f"  {label:12s}: capacity={r['capacity']} "
              f"token-drop={r['overflow_frac']:.4f}")
    print("  scatter vs einsum dispatch max diff: "
          f"{res['scatter_vs_einsum']:.2e} (same result, "
          "O(T*D) vs O(T*E*C) data movement)")

    # planner reuse on the dispatch pattern: the co-routing statistics
    # are recomputed whenever gate values update, but the top-k pattern is
    # unchanged, so the second SpGEMM hits the plan cache
    _, rep1, _, rep2, service, _, _ = co_routing(logits, k, dev)
    print(f"  co-routing C=D^T@D ({e}x{e}): workflow={rep1.workflow} "
          f"bins={rep1.bins} plan_cache_hit={rep2.plan_cache_hit} "
          f"setup {rep1.setup_seconds * 1e3:.1f} ms -> "
          f"{rep2.setup_seconds * 1e3:.1f} ms "
          f"(hit rate {service.stats.hit_rate:.0%})")


if __name__ == "__main__":
    main()
