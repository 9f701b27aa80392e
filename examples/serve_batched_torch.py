"""Serve a small LM on the PyTorch/CUDA port with continuous batching:
requests of different prompt lengths and budgets share steps through slot
reuse (16-token prefill chunks, then one decode step for every live slot).

Run on the card (the default; each step a CUDA graph per phase and bucket)
or on the CPU (eager steps):

    PYTHONPATH=src python examples/serve_batched_torch.py
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

``REPRO_TORCH_DISPATCH`` (``auto`` | ``kernel`` | ``twin``) picks kernels
or their plain versions for compiled leaves; this example serves the raw
float weights.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("llama3.2-1b"), n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=4096, head_dim=64,
        param_dtype="float32", remat=False)
    params = init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(params, cfg, batch_slots=3, max_len=128, device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, 4096, size=n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 12), (9, 8), (3, 20), (7, 6),
                                        (4, 10)])]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run()
    dt = time.perf_counter() - t0
    st = engine.stats()
    steps = st["prefill_steps"] + st["decode_steps"]
    total_new = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests / {total_new} tokens in {steps} "
          f"batched steps ({st['prefill_steps']} prefill chunks, "
          f"{st['decode_steps']} decode steps; {dt:.2f}s, "
          f"{total_new / dt:.1f} tok/s on {dev}, graphs captured: "
          f"{st['graphs']})")
    for r in reqs:
        print(f"  req{r.uid}: prompt[{len(r.prompt)}] -> {r.out}")
    assert all(len(r.out) == r.max_new_tokens for r in reqs)
    # batching actually shared steps:
    assert steps < sum(len(r.prompt) + r.max_new_tokens for r in reqs)
    return reqs


if __name__ == "__main__":
    main(sys.argv[1:])
