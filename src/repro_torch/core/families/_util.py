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


def int8_codes(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform int8 codes in [-127, 127], drawn on the generator's device
    (the synthetic init of the integer families)."""
    return torch.randint(-127, 128, tuple(shape), generator=generator,
                         dtype=torch.int16,
                         device=generator.device).to(torch.int8)


def fan_in_scales(generator: torch.Generator, shape, fan_in) -> torch.Tensor:
    """f32 scales of ``1 / (127 sqrt(fan_in))``: int8 codes of unit
    variance-ish columns, as the reference's synthetic init sets them."""
    return torch.full(tuple(shape), 1.0 / (127 * np.sqrt(fan_in)),
                      dtype=torch.float32, device=generator.device)


def to_numpy_f32(w) -> np.ndarray:
    """A weight (tensor on any device, or array) as a host f32 array."""
    if isinstance(w, torch.Tensor):
        return w.detach().to(torch.float32).cpu().numpy()
    return np.asarray(w, np.float32)
