"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>.so`` (a plain C
interface, no PyTorch headers, so a build takes seconds).  The first call
that needs a library builds every source at once, one ``nvcc`` process per
source started together, into ``build/repro_torch/<digest>/`` at the root of
the checkout, where ``<digest>`` hashes the sources and flags: editing a
kernel rebuilds, an unchanged tree reuses the earlier build.  Nothing here
runs at import time; the CPU-only tests import every module and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("block_sparse_matmul", "quant_matmul", "packed_decode_attention",
           "block_sparse_conv", "quant_conv", "fc_stack", "flash_attention",
           "flash_attention_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH) — the CUDA kernels are built from csrc/ at first use")
    return found


def build_all() -> Path:
    """Compile every source that has no library yet, all in parallel.

    Returns the build directory.  Raises with the compiler's output when a
    source does not compile.  ``build.log`` in the directory keeps each
    compiler's output (``-Xptxas -v``: registers, shared memory, spills).
    """
    out = build_dir()
    missing = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not missing:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    for name in missing:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    with open(out / "build.log", "a") as log:
        for name, tmp, cmd, proc in procs:
            text, _ = proc.communicate()
            log.write(f"$ {' '.join(cmd)}\n{text}\n")
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
                continue
            tmp.replace(out / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building the kernels on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise when a launch function returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
