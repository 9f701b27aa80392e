"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry points' device: CUDA unless the caller names one.

    With no device given and no CUDA device present this raises: the port
    never falls back to the CPU on its own — pass ``device="cpu"`` for that.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available — pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
