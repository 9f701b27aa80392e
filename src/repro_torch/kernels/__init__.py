"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""
from __future__ import annotations

import importlib
from typing import Dict

# Every wrapper's launch counters: module (under this package) -> counter
# names.  Each wrapper adds one to its counters where it launches a kernel.
LAUNCH_COUNTERS = {
    "sparse_matmul.kernel": ("launches", "launches_thin", "launches_tc",
                             "launches_tiled", "conv_launches",
                             "conv_launches_reg", "conv_launches_band"),
    "quant_matmul.kernel": ("launches", "launches_thin", "launches_tc",
                            "launches_tiled", "conv_launches",
                            "conv_launches_reg", "conv_launches_band"),
    "flash_attention.decode_packed": ("launches", "launches_split",
                                      "launches_single"),
    "flash_attention.kernel": ("launches", "launches_tc", "launches_cc"),
    "fc_stack": ("launches", "launches_staged", "launches_stream"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> Dict[str, int]:
    """The launch counters of every wrapper, keyed ``"module:counter"``."""
    return {f"{m}:{c}": getattr(_module(m), c)
            for m, names in LAUNCH_COUNTERS.items() for c in names}


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts`) to the counters."""
    for key, n in delta.items():
        if n:
            m, c = key.split(":")
            mod = _module(m)
            setattr(mod, c, getattr(mod, c) + n)
