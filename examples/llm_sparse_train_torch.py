"""Train a ~100M-parameter LM with the fault-tolerant runtime on the
PyTorch/CUDA port (a reduced llama3-family config), with the LogicSparse
datapath: frozen-mask sparsity on the MLP weights after warmup.

This is the end-to-end driver: data pipeline -> micro-batched train step
(the flash-attention kernel forward on the card) -> AdamW -> checkpoint /
restart (kill it mid-run and restart: it resumes from the last committed
step).

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/llm_sparse_train_torch.py [--steps 300]
    PYTHONPATH=src python examples/llm_sparse_train_torch.py --device cpu \\
        --layers 2 --d-model 64 --d-ff 128 --vocab 256 --batch 4 --seq 32

The size arguments default to the ~100M config; ``--ckpt-every`` sets the
checkpoint period.  ``REPRO_TORCH_DISPATCH`` (``auto`` | ``kernel`` |
``twin``) picks the flash kernel or its plain version.
"""
import argparse
import dataclasses
import shutil
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import layer_magnitude_prune
from repro_torch.data.synthetic import token_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.runtime import RunnerConfig, TrainRunner
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import tree_leaves, tree_map

MLP = ("wg", "wu", "wd")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="results/llm_ckpt_torch")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints (default resumes)")
    ap.add_argument("--prune-at", type=int, default=150)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--d-ff", type=int, default=1536)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.fresh:
        shutil.rmtree(args.ckpt, ignore_errors=True)

    # ~100M params: llama3.2-1b family, shrunk
    cfg = dataclasses.replace(
        get_config("llama3.2-1b"), n_layers=args.layers, d_model=args.d_model,
        n_heads=8, n_kv_heads=4, d_ff=args.d_ff, vocab=args.vocab,
        head_dim=args.d_model // 8, param_dtype="float32", remat=False)
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    opt = adamw_init(params, opt_cfg)
    B, T = args.batch, args.seq
    train_step = make_train_step(cfg, opt_cfg, n_micro=2)

    def data_fn(step):
        toks, labels = token_batch(step, B, T, cfg.vocab, seed=0)
        return {"tokens": torch.from_numpy(toks).to(dev),
                "labels": torch.from_numpy(labels).to(dev)}

    run_cfg = RunnerConfig(total_steps=min(args.prune_at, args.steps),
                           ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt,
                           log_every=25)
    runner = TrainRunner(train_step, data_fn, run_cfg)
    params, opt = runner.run(params, opt)
    dense_losses = [m["loss"] for m in runner.metrics_log] or [float("nan")]
    out = {"params": params, "dense_losses": dense_losses}

    if args.steps > args.prune_at:
        # LogicSparse: magnitude-prune the MLP weights, freeze the masks,
        # re-sparse fine-tune (the paper's workflow at LM scale)
        print("[example] pruning MLP weights to 50% + re-sparse fine-tune")
        mlp = params["blocks"]["mlp"]
        masks = {}
        for key in MLP:
            w = mlp[key]["w"].cpu().numpy()
            masks[key] = torch.from_numpy(np.stack(
                [layer_magnitude_prune(w[i], 0.5)
                 for i in range(w.shape[0])])).to(dev)
            mlp[key]["w"] = mlp[key]["w"] * masks[key]
        full_masks = tree_map(lambda p: None, params)
        for key in MLP:
            full_masks["blocks"]["mlp"][key]["w"] = masks[key]
        sparse_step = make_train_step(cfg, opt_cfg, n_micro=2,
                                      masks=full_masks)
        run_cfg2 = RunnerConfig(total_steps=args.steps,
                                ckpt_every=args.ckpt_every,
                                ckpt_dir=args.ckpt, log_every=25)
        runner2 = TrainRunner(sparse_step, data_fn, run_cfg2)
        params, opt = runner2.run(params, opt, start_step=args.prune_at)
        sparse_losses = [m["loss"] for m in runner2.metrics_log] \
            or [float("nan")]
        w = params["blocks"]["mlp"]["wg"]["w"]
        max_pruned = float(w[~masks["wg"]].abs().max())
        print(f"[example] mask preserved: max |pruned weight| = "
              f"{max_pruned:.2e}")
        print(f"[example] loss before prune {dense_losses[-1]:.3f} -> "
              f"after re-sparse fine-tune {sparse_losses[-1]:.3f}")
        out.update(params=params, masks=masks, max_pruned=max_pruned,
                   sparse_losses=sparse_losses)
    print("done.")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
