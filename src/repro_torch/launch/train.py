"""Training launcher of the port, on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 [--batch 8 --seq 256] [--full] [--device cpu] \\
      [--ckpt results/train_ckpt --ckpt-every 50]

Runs the reduced config unless ``--full`` gives the published widths;
every family with a token input trains (dense, MoE, SSM, hybrid), and a
frontend arch (the encoder's frames, the VLM's prefix) is refused with the
reference's message.  Parameters are random from seed 0 and tokens come
from ``token_batch``.  The reference launcher's device mesh,
``param_specs`` shardings and ``jax.distributed`` start-up are dropped: the
port trains on one card (sharding is ROADMAP Queue A item 9).  CUDA unless
``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ARCH_IDS, get_config, reduced_config
from ..data.synthetic import token_batch
from ..device import resolve_device
from ..models.model import init_params
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.runtime import RunnerConfig, TrainRunner
from ..train.trainer import make_train_step, pick_n_micro


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint period in steps (0 = no checkpoints)")
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--step-deadline", type=float, default=0.0,
                    help="straggler watchdog seconds (0 = off)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if cfg.frontend:
        raise SystemExit("frontend archs: use examples/ drivers with "
                         "precomputed embeddings")
    dev = resolve_device(args.device)
    n_micro = pick_n_micro(cfg, args.batch, 1)
    params = init_params(cfg, seed=0, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          state_dtype=cfg.opt_state_dtype)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, n_micro)

    def data_fn(i):
        toks, labels = token_batch(i, args.batch, args.seq, cfg.vocab)
        return {"tokens": torch.from_numpy(toks).to(dev),
                "labels": torch.from_numpy(labels).to(dev)}

    runner = TrainRunner(step, data_fn, RunnerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt, step_deadline_s=args.step_deadline,
        log_every=10))
    runner.run(params, opt)
    print("[train] done")
    return runner


if __name__ == "__main__":
    main()
