"""Carry weights across from numpy into the port.

The input is a nested dict of numpy arrays: a raw parameter tree, or a
compiled model's ``params`` plus its pattern table given as
``(K, N) -> (block, bitmap)``.  bfloat16 arrays (numpy dtype name
``bfloat16``) keep their bits exactly.  This module sees numpy only.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .core.sparsity import BlockSparsePattern, pattern_from_bitmap
from .device import resolve_device

__all__ = ["params_from_numpy", "patterns_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array as a tensor on ``device`` (CUDA unless ``device="cpu"``),
    bit for bit."""
    dev = resolve_device(device)
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree: Any, device=None) -> Any:
    """A nested dict of numpy arrays as the same dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def patterns_from_numpy(
        table: Dict[Tuple[int, int], Tuple[Tuple[int, int], np.ndarray]]
) -> Dict[Tuple[int, int], BlockSparsePattern]:
    """``(K, N) -> (block, bitmap)`` as the port's pattern table."""
    return {tuple(kn): pattern_from_bitmap(tuple(kn), tuple(block),
                                           np.asarray(bitmap, bool))
            for kn, (block, bitmap) in table.items()}
