"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Runs the training loop on one device: the GPU unless ``--device cpu``
(the default ``cuda`` raises without one). Parameters are f32, drawn
from a generator seeded with ``--seed``; the compute dtype is the
config's. ``main(argv)`` returns the loop's result, so a script can call
it in process.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data import DataConfig
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainLoopConfig, train_loop


def schedule_for(steps: int) -> dict:
    """The CLI's cosine schedule for a run of ``steps``: warmup over a
    tenth of the run (at most 50 steps), decay to the end."""
    return {"warmup": min(50, steps // 10 + 1), "total": steps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the model (default cuda; 'cpu' runs "
                    "the same steps on the CPU)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder_decoder:
        raise SystemExit("use examples/train_lm.py-style scripts for "
                         "enc-dec training; this CLI trains decoder LMs")
    params = lm.init_model(cfg, seed=args.seed, device=args.device)
    opt_state = adamw_init(params)
    step = lm.make_train_step(
        cfg, AdamWConfig(lr=args.lr), remat=args.remat,
        microbatch=args.microbatch,
        schedule_kwargs=schedule_for(args.steps))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               checkpoint_dir=args.checkpoint_dir,
                               checkpoint_every=args.checkpoint_every,
                               log_every=args.log_every)
    out = train_loop(step, params, opt_state, data_cfg, loop_cfg)
    hist = out["metrics_history"]
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f}); stragglers: "
          f"{out['straggler_steps']}")
    return out


if __name__ == "__main__":
    main()
