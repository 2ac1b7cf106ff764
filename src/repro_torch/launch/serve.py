"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Spins up the batched continuous-batching engine on a (smoke) model and
runs a demo request workload, on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving import Request, ServeConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the model (default cuda; 'cpu' runs "
                    "the same steps on the CPU)")
    args = ap.parse_args()

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder_decoder:
        raise SystemExit("decoder-only serving CLI; whisper decode is "
                         "exercised via the dry-run + tests")
    params = lm.init_model(cfg, seed=args.seed, device=args.device)
    engine = ServingEngine(cfg, params, ServeConfig(
        batch_slots=args.slots,
        max_len=args.prompt_len + args.max_new + 8,
        cache_dtype="float32"))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    engine.run(reqs)
    for r in reqs:
        print(f"req {r.uid}: {len(r.output)} tokens -> {r.output[:8]}...")


if __name__ == "__main__":
    main()
