"""Serving launcher of the port: the continuous-batching engine over the
decode step, on one card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 6 --slots 3 [--max-new 12] [--full] [--device cpu]

Serves the reduced config unless ``--full`` gives the published widths,
from raw parameters (random from seed 0) over the float KV cache, as the
reference launcher does: the prompts are the reference's, drawn from
``np.random.default_rng(0)``.  An arch with no decode step (the encoder)
is refused with the reference's message.  CUDA unless ``--device cpu``;
on CUDA each step runs as a captured graph.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import ARCH_IDS, get_config, reduced_config
from ..device import resolve_device
from ..models.model import init_params
from ..serve.engine import Request, ServeEngine

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if not cfg.supports_decode or cfg.frontend == "frame":
        raise SystemExit(f"{args.arch} has no decode step (encoder-only)")
    dev = resolve_device(args.device)
    params = init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(params, cfg, batch_slots=args.slots,
                         max_len=args.max_len, device=dev)
    rng = np.random.default_rng(0)      # the reference launcher's prompts
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab,
                                        size=int(rng.integers(3, 10))
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in reqs)
    st = engine.stats()
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens, "
          f"{st['prefill_steps'] + st['decode_steps']} batched steps, "
          f"{n_tok / dt:.1f} tok/s")
    for r in reqs[:3]:
        print(f"  req{r.uid}: {r.prompt[:4].tolist()}... -> {r.out[:6]}...")
    return engine, reqs


if __name__ == "__main__":
    main()
