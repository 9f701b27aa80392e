"""Shared helpers for the built-in payload-family modules."""
from __future__ import annotations

import math

import numpy as np
import torch


def he_init(generator: torch.Generator, shape, dtype, fan_in) -> torch.Tensor:
    """He-style random init (normal / sqrt(fan_in)), drawn on the
    generator's device."""
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w / math.sqrt(fan_in)).to(dtype)


def to_numpy_f32(w) -> np.ndarray:
    """A weight (tensor on any device, or array) as a host f32 array."""
    if isinstance(w, torch.Tensor):
        return w.detach().to(torch.float32).cpu().numpy()
    return np.asarray(w, np.float32)
