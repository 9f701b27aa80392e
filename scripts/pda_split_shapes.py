#!/usr/bin/env python3
"""packed_decode_attention's split route at the serving paths' reads: each
held against its plain version and timed beside its bound, SDPA on the
dequantised bf16 cache and the single kernel (the first design), through
``chip_smoke.zoo_attention_row``; reads with more than one row group, or
groups of more than 16 rows, are also timed with groups of at most 16 and
32 rows.  First runs ``chip_smoke.sweep_attention`` (every split build and
the single kernel's cases against the plain version, bitwise checks), and
prints the split kernel's registers and spills from the build log.

Prints one JSON line per read and the card line.  Needs one CUDA card;
imports nothing of JAX.

Usage:  python3 scripts/pda_split_shapes.py
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

DECODE_LENS = np.random.default_rng(1).integers(64, 320, size=(8, 1))
CHUNK_LENS = 200 + np.arange(1, 17)[None]
# (config, B, C, lengths): the decode reads of 8 slots and the 16-row
# prefill chunks the serving paths of chip_smoke.py time
READS = [("zamba2-2.7b", 8, 1, DECODE_LENS),
         ("phi-3-vision-4.2b", 8, 1, DECODE_LENS),
         ("phi-3-vision-4.2b", 1, 16, CHUNK_LENS),
         ("starcoder2-7b", 1, 16, CHUNK_LENS),
         ("llama3.2-1b", 8, 1, DECODE_LENS),
         ("llama3.2-1b", 1, 16, CHUNK_LENS),
         ("qwen1.5-4b", 8, 1, DECODE_LENS),
         ("starcoder2-7b", 8, 1, DECODE_LENS)]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    out = build.build_all()
    log = (out / "build.log").read_text()
    for m in re.finditer(r"Compiling entry function '(\w*pda_split\w*)'.*?"
                         r"Used (\d+) registers", log, re.S):
        print(f"ptxas {m.group(1)}: {m.group(2)} registers", flush=True)
    print(f"spill lines: {sorted(set(re.findall(r'\d+ bytes spill stores', log)))}",
          flush=True)
    dev = torch.device("cuda")
    cases = cs.sweep_attention(np.random.default_rng(0), dev)
    print(f"sweep_attention: {cases} cases passed", flush=True)
    for arch, B, C, lens in READS:
        row = cs.zoo_attention_row(get_config(arch), dev, B, C, lens)
        print(json.dumps(row), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
