#!/usr/bin/env python3
"""Is olmoe-1b-7b's drip the same in two processes?  Each of two fresh
processes builds the same full-width olmoe-1b-7b at 2 and at 8 of its 16
layers from seed 0, compiles it as ``chip_smoke.family_model`` does (the
MoE serving path's compile) and drips one prompt's first 20 tokens
through ``decode_step`` on the int4x2 cache, on the kernel path
(``dispatch="auto"``) and on the plain path (``"twin"``).  The parent then
compares the two processes' logits bit for bit, path by path, and prints
each process's kernel-vs-plain gap (the largest difference over the
largest plain logit, the measure of ``chip_smoke.moe_twin_check``).

Prints one JSON line per depth and the card line.  Needs one CUDA card;
imports nothing of JAX.

Usage:  python3 scripts/moe_drip_repeat.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

ARCH = "olmoe-1b-7b"
DEPTHS = (2, 8)
TOKENS = 20
PATHS = {"kernel": "auto", "plain": "twin"}


def drip(out: str) -> None:
    """One process: every depth's logits of both paths, saved to ``out``."""
    import chip_smoke as cs
    from repro_torch.models.model import decode_step, init_cache

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    for layers in DEPTHS:
        cm, cfg, _ = cs.family_model(ARCH, dev, layers)
        prompt = cs.serve_prompts(cfg)[0][:TOKENS]
        for name, mode in PATHS.items():
            cache = init_cache(cfg, 1, 512, kv_cache="int4x2", device=dev)
            rows = []
            for t in prompt:
                tok = torch.tensor([[int(t)]], device=dev)
                y = decode_step(cm.params, cfg, cache, tok,
                                patterns=cm.patterns, dispatch=mode,
                                t_bound=32, bt=64)[0][0, 0]
                rows.append(y.float().cpu())
            got[f"{layers}/{name}"] = torch.stack(rows)
        del cm
        torch.cuda.empty_cache()
    torch.save(got, out)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("moe_drip_repeat: no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    runs = []
    with tempfile.TemporaryDirectory() as d:
        for i in range(2):
            out = str(Path(d) / f"run{i}.pt")
            subprocess.run([sys.executable, __file__, "--drip", out],
                           cwd=ROOT, check=True)
            runs.append(torch.load(out))
    for layers in DEPTHS:
        row = {"arch": ARCH, "layers": layers, "tokens": TOKENS}
        for name in PATHS:
            a, b = (r[f"{layers}/{name}"] for r in runs)
            row[f"{name}_bitwise_across_processes"] = bool(torch.equal(a, b))
            row[f"{name}_max_abs_diff_across_processes"] = float(
                (a - b).abs().max())
        row["kernel_vs_plain_gap_per_process"] = [
            gap(r[f"{layers}/kernel"], r[f"{layers}/plain"]) for r in runs]
        print(json.dumps(row), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--drip":
        drip(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
