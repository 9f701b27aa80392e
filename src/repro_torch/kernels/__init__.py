"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""
from __future__ import annotations

import importlib
from typing import Dict, Optional

# Every wrapper's launch counters: module (under this package) -> counter
# names.  Each wrapper adds one to its counters where it launches a kernel;
# the matmuls' ``tuned_hits`` / ``tuned_misses`` count their launches given
# a tuned plan (on it / on the shape rule's instead).
LAUNCH_COUNTERS = {
    "sparse_matmul.kernel": ("launches", "launches_thin", "launches_tc",
                             "launches_tiled", "conv_launches",
                             "conv_launches_reg", "conv_launches_band",
                             "tuned_hits", "tuned_misses"),
    "quant_matmul.kernel": ("launches", "launches_thin", "launches_tc",
                            "launches_tiled", "conv_launches",
                            "conv_launches_reg", "conv_launches_band",
                            "tuned_hits", "tuned_misses"),
    "flash_attention.decode_packed": ("launches", "launches_split",
                                      "launches_single"),
    "flash_attention.kernel": ("launches", "launches_tc", "launches_cc"),
    "fc_stack": ("launches", "launches_staged", "launches_stream"),
}


# kernel -> (module, its pure plan check: ``(route, plan, *shape)`` -> why
# the route and plan cannot take the call, or None)
PLAN_ERRORS = {
    "quant_matmul": ("quant_matmul.kernel", "qmm_plan_error"),
    "block_sparse_matmul": ("sparse_matmul.kernel", "bsm_plan_error"),
    "packed_decode_attention": ("flash_attention.decode_packed",
                                "pda_plan_error"),
}


def refuse_dtensor(name: str, *operands) -> None:
    """Raise TypeError for a DTensor operand: a kernel takes one rank's
    local shards, which the dispatch's DTensor legs
    (:mod:`repro_torch.core.sharded`) hand it through ``local_map``."""
    from torch.distributed.tensor import DTensor

    for t in operands:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{name}: a DTensor reached the kernel wrapper — placed "
                "tensors run through the dispatch (linear_dispatch, "
                "attn_packed_dispatch, attn_full_dispatch), which calls the "
                "kernel on each rank's local shards")


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


def check_plan(kernel: str, route: str, plan, shape, *,
               name: Optional[str] = None) -> None:
    """Raise ValueError, naming ``name`` (the leaf), when ``kernel``'s
    ``route`` with ``plan`` cannot take a call of ``shape`` (the arguments
    of its route rule, as :data:`PLAN_ERRORS`' function takes them after
    route and plan).  Pure: host integers only, so testable on the CPU."""
    mod, fn = PLAN_ERRORS[kernel]
    err = getattr(_module(mod), fn)(route, plan, *shape)
    if err is not None:
        raise ValueError(f"{name or kernel}: {kernel} cannot take route "
                         f"{route!r} with plan {plan!r} here: {err}")
