#!/usr/bin/env python3
"""The tensor-core flash kernel's occupancy on the card: its
``__launch_bounds__`` as built (two CTAs an SM at Dh 64, 80 and 96, one
at Dh 128) against one CTA an SM at every head dim.

Builds ``src/repro_torch/csrc/flash_attention_tc.cu`` twice with nvcc into
``build/flash_tc_occupancy/``, the second with the minimum-blocks operand
of ``__launch_bounds__`` set to 1, and prints each build's registers and
spills (``-Xptxas -v``).  Holds both builds against the plain version at
Dh 64, 80, 96 and 128 (causal and not, GQA, ragged and unequal lengths,
q strided), then prints one JSON line per main-path shape with the device
ms of both builds, of the CUDA-core kernel and of SDPA, and the card line.
Needs one CUDA card; imports nothing of JAX.

Usage:  python3 scripts/flash_tc_occupancy.py
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

BOUNDS = "DH == 128 ? 1 : 2"     # the source's minimum CTAs an SM
# (B, T, H, Hkv, Dh, causal): hubert-xlarge's forward, zamba2-2.7b's
# training and forward, phi-3-vision-4.2b's forward, llama3.2-1b's and
# olmoe-1b-7b's training
SHAPES = {"hubert-xlarge": (4, 1024, 16, 16, 80, False),
          "zamba2-2.7b train": (1, 2048, 32, 32, 80, True),
          "zamba2-2.7b forward": (1, 512, 32, 32, 80, True),
          "phi-3-vision-4.2b": (1, 1088, 32, 32, 96, True),
          "llama3.2-1b train": (2, 2048, 32, 8, 64, True),
          "olmoe-1b-7b train": (1, 2048, 16, 16, 128, True)}


def build_variant(name: str, text: str, out: Path):
    src = out / f"{name}.cu"
    src.write_text(text)
    lib = out / f"lib{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def load(lib: Path):
    fn = ctypes.CDLL(str(lib)).flash_attention_tc_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, L, L, L,
                   ctypes.c_float, I, P]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, q, k, v, causal):
    B, Tq, H, Dh = q.shape
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
             Tq, k.shape[1], H, k.shape[2], Dh, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(Dh),
             int(causal), torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_tc")
    return out


def check(fn, dev) -> int:
    cases = 0
    for Dh in fk.TC_DH:
        for causal in (True, False):
            for G in (1, 4):
                for Tq, Tk in ((257, 257), (2048, 1000), (100, 2048)):
                    B, Hkv = 1 + 2 * (cases % 2), 2
                    q = torch.randn((B, Tq, 2 * Hkv * G, Dh), device=dev).to(
                        torch.bfloat16)[:, :, Hkv * G:]
                    k, v = (torch.randn((B, Tk, Hkv, Dh), device=dev).to(
                        torch.bfloat16) for _ in range(2))
                    y = launch(fn, q, k, v, causal)
                    ref = fk.flash_attention_plain(q, k, v, causal=causal)
                    err = float((y.float() - ref.float()).abs().max())
                    cs.require(err <= cs.flash_tol(torch.bfloat16, ref),
                               f"Dh={Dh} causal={causal} G={G} Tq={Tq} "
                               f"Tk={Tk}: max abs err {err}")
                    cases += 1
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tc_occupancy: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    text = (build.CSRC / "flash_attention_tc.cu").read_text()
    cs.require(text.count(BOUNDS) == 1, f"no {BOUNDS!r} in the source")
    out = ROOT / "build" / "flash_tc_occupancy"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {"as_built": build_variant("as_built", text, out),
            "one_cta": build_variant("one_cta", text.replace(BOUNDS, "1"),
                                     out)}
    fns = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        print(name, json.dumps([line.strip() for line in log.splitlines()
                                if "registers" in line or "spill" in line]))
        fns[name] = load(lib)
    for name, fn in fns.items():
        print(f"{name}: {check(fn, dev)} cases within one bf16 step of the "
              f"plain version", flush=True)
    for label, (B, T, H, Hkv, Dh, causal) in SHAPES.items():
        ins = [[torch.randn(s, device=dev).to(torch.bfloat16)
                for s in ((B, T, H, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh))]
               for _ in range(4)]
        heads = [[t.permute(0, 2, 1, 3) for t in qkv] for qkv in ins]
        row = {"shape": label, "B": B, "T": T, "H": H, "Hkv": Hkv, "Dh": Dh,
               "causal": causal}
        for name, fn in fns.items():
            row[f"{name}_ms"] = cs.device_ms(
                lambda i, fn=fn: lambda: launch(fn, *ins[i], causal), 4)
        row["cuda_core_ms"] = cs.device_ms(lambda i: lambda: fk._launch(
            *ins[i], causal, "cuda_core"), 4)
        row["sdpa_ms"] = cs.device_ms(
            lambda i: lambda: F.scaled_dot_product_attention(
                *heads[i], is_causal=causal, enable_gqa=True), 4)
        print(json.dumps(row), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
