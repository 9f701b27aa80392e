"""End-to-end paper pipeline on the PyTorch/CUDA port: train LeNet-5 →
reference pruning → DSE → hardware-aware pruning + int4 re-sparse
fine-tuning → engine-free compacted deployment on the fused kernels — the
full Fig. 1 workflow at Table I's operating point.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/lenet_pipeline_torch.py
    PYTHONPATH=src python examples/lenet_pipeline_torch.py --device cpu

The strategy rows' latency, throughput and resource are cost-model
estimates from the H100 SXM datasheet (``H100_SXM``), not measurements;
accuracy is measured on the synthetic test digits.  The last line times
the masked-dense, FC-only compacted and whole fused forwards at batch 256
on the wall clock, beside the card's name and power limit (printed only).
``REPRO_TORCH_DISPATCH`` (``auto`` | ``kernel`` | ``twin``) picks kernels
or their plain versions for the compiled layers.
"""
import argparse
import subprocess
import sys
import time

import torch

from repro_torch.core import H100_SXM
from repro_torch.device import resolve_device
from repro_torch.models.lenet import lenet_forward
from repro_torch.train import lenet_pipeline

BATCH = 256
ITERS = 20


def card_line(dev) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(dev)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def wall_ms(fn, dev, iters=ITERS) -> float:
    """Wall-clock ms a call of ``fn`` after a warm-up, the device drained
    before and after."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--steps", type=int, default=80,
                    help="dense training steps")
    ap.add_argument("--finetune-steps", type=int,
                    default=lenet_pipeline.FINETUNE_STEPS,
                    help="masked int4 QAT re-sparse fine-tuning steps")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # the f32 layers run in IEEE f32 (cuDNN's default conv math is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    fig1 = lenet_pipeline.run(hw=H100_SXM, device=dev, steps=args.steps,
                              finetune_steps=args.finetune_steps)
    rows = fig1.rows
    print(f"\nestimates under {H100_SXM.name} (datasheet figures, not "
          "measured); accuracy measured")
    print(f"{'strategy':18s} {'acc':>7s} {'lat(us)':>9s} {'fps':>12s} "
          f"{'resource':>10s} {'compr':>7s}")
    for r in rows:
        print(f"{r['strategy']:18s} {r['accuracy']:7.4f} "
              f"{r['latency_us']:9.3f} {r['throughput_fps']:12.0f} "
              f"{r['resource_bytes']:10.3g} {r['compression']:6.1f}x")
    base = next(r for r in rows if r["strategy"] == "unfold")
    prop = next(r for r in rows if r["strategy"] == "proposed")
    print(f"\nproposed vs fully-unrolled dense (estimates): "
          f"{prop['throughput_fps'] / base['throughput_fps']:.2f}x "
          f"throughput at {prop['resource_bytes'] / base['resource_bytes']:.2%}"
          " resource")
    bench = rows[-1]["bench"]
    print(f"compression: stored bits {bench['stored_bits_compression']:.2f}x "
          f"(paper {bench['paper_target_compression']}x); whole-model bytes "
          f"{bench['whole_model_compression']:.2f}x "
          f"({bench['whole_model_storage_bytes']} of "
          f"{bench['dense_storage_bytes']} B); int8 containers "
          f"{bench['whole_model_int8_container_compression']:.2f}x; FC-only "
          f"{bench['fc_only_compression']:.2f}x")
    print(f"accuracy: dense {bench['accuracy_dense']:.4f}, pruned and masked "
          f"{bench['accuracy_pruned_masked']:.4f}, whole compressed "
          f"{bench['accuracy_whole_compressed']:.4f}")

    x = torch.from_numpy(fig1.task.batch(0, BATCH)[0]).to(dev)
    with torch.no_grad():
        t_dense = wall_ms(lambda: lenet_forward(fig1.params, x), dev)
        t_fc = wall_ms(lambda: lenet_forward(
            fig1.pruned_params, x, compressed=fig1.cm_fc.layers,
            fusion=True), dev)
        t_whole = wall_ms(lambda: lenet_forward(
            fig1.pruned_params, x, compressed=fig1.cm_whole.layers,
            fusion=True), dev)
    print(f"\nwall-clock batch-{BATCH} forward on {card_line(dev)}: masked "
          f"dense {t_dense:.3f} ms, FC-only compacted {t_fc:.3f} ms, whole "
          f"fused {t_whole:.3f} ms")
    return fig1


if __name__ == "__main__":
    main(sys.argv[1:])
