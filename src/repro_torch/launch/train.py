"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 [--batch 8 --seq 256] [--full] [--device cpu] \\
      [--ckpt results/train_ckpt --ckpt-every 50]

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch llama3.2-1b --tp 2 ...

Runs the reduced config unless ``--full`` gives the published widths;
every family with a token input trains (dense, MoE, SSM, hybrid), and a
frontend arch (the encoder's frames, the VLM's prefix) is refused with the
reference's message.  Parameters are random from seed 0 and tokens come
from ``token_batch``.  CUDA unless ``--device cpu``.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) each process starts
the process group — NCCL on the card (each rank on ``LOCAL_RANK``'s
device), gloo only when the CPU is asked for — builds the mesh (``data`` =
world / ``--tp``, ``model`` = ``--tp``), places the parameters, the AdamW
moments (ZeRO) and every batch by the sharding rules, and hands the
placements to the runner for its checkpoints, which every rank writes its
share of.  Without ``torchrun`` it trains in one process.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..configs import ARCH_IDS, get_config, reduced_config
from ..data.synthetic import token_batch
from ..device import resolve_device
from ..models.model import init_params
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.runtime import RunnerConfig, TrainRunner
from ..train.trainer import make_train_step, pick_n_micro


def _start(device: torch.device, tp: int):
    """The process group and the ("data", "model") mesh of a ``torchrun``
    job; a failure to start is fatal (there is no fallback backend)."""
    import torch.distributed as dist

    from .mesh import make_mesh

    world = int(os.environ["WORLD_SIZE"])
    if world % tp:
        raise SystemExit(f"--tp {tp} does not divide the world of {world}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device, make_mesh((world // tp, tp), ("data", "model"),
                             device.type)


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
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks of the 'model' axis under torchrun")
    ap.add_argument("--step-deadline", type=float, default=0.0,
                    help="straggler watchdog seconds (0 = off)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if cfg.frontend:
        raise SystemExit("frontend archs: use the port's example drivers "
                         "(examples/*_torch.py) with precomputed embeddings")
    dev = resolve_device(args.device)
    mesh = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev, mesh = _start(dev, args.tp)
    dp = 1
    if mesh is not None:
        from .mesh import data_axes, mesh_size
        dp = mesh_size(mesh, data_axes(mesh))
    n_micro = pick_n_micro(cfg, args.batch, dp)
    params = init_params(cfg, seed=0, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          state_dtype=cfg.opt_state_dtype)
    opt = adamw_init(params, opt_cfg)
    placements = None
    if mesh is not None:
        from .sharding import (opt_specs, shard_batch, shard_opt_state,
                               shard_params, specs_placements)
        plain = params
        params, pspecs, _ = shard_params(plain, cfg, mesh)
        opt = shard_opt_state(opt, plain, cfg, mesh)
        placements = {"params": specs_placements(pspecs, mesh),
                      "opt": specs_placements(opt_specs(plain, cfg, mesh),
                                              mesh)}
        del plain
    step = make_train_step(cfg, opt_cfg, n_micro)

    def data_fn(i):
        toks, labels = token_batch(i, args.batch, args.seq, cfg.vocab)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        return batch if mesh is None else shard_batch(batch, cfg, mesh)

    runner = TrainRunner(step, data_fn, RunnerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt, step_deadline_s=args.step_deadline,
        log_every=10), placements=placements)
    runner.run(params, opt)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    print("[train] done")
    return runner


if __name__ == "__main__":
    main()
