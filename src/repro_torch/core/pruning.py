"""Pruning strategies: global magnitude reference + hardware-aware block
pruning, and the frozen-mask helpers of re-sparse fine-tuning.

The mask functions are host-side numpy on weights (patterns are compile-time
constants), copied from ``repro.core.pruning`` so the same weights give the
same masks byte for byte:

* ``global_magnitude_prune`` — one threshold across all prunable tensors
  (the paper's Fig. 1 reference);
* ``block_aware_prune`` — the hardware-aware two-level strategy: zeros
  concentrated into whole (bm, bn) blocks the static schedule drops, with
  unstructured freedom inside surviving blocks.

Mask *application* (``apply_masks``, ``masked_update``) runs on tensors;
the optimizer re-applies frozen masks after each update
(:func:`repro_torch.train.optimizer.adamw_update`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..tree import tree_map

__all__ = [
    "global_magnitude_prune",
    "layer_magnitude_prune",
    "block_aware_prune",
    "apply_masks",
    "masked_update",
    "sparsity_of",
]

PyTree = Any


def _threshold_for_sparsity(flat_abs: np.ndarray, sparsity: float) -> float:
    if sparsity <= 0.0:
        return -1.0
    if sparsity >= 1.0:
        return float("inf")
    k = int(np.floor(sparsity * flat_abs.size))
    if k == 0:
        return -1.0
    return float(np.partition(flat_abs, k - 1)[k - 1])


def global_magnitude_prune(
    weights: Dict[str, np.ndarray],
    sparsity: float,
    *,
    prunable: Optional[Callable[[str], bool]] = None,
) -> Dict[str, np.ndarray]:
    """One global magnitude threshold across all prunable tensors.

    Returns {name: bool mask} with True = keep.  Non-prunable tensors get
    all-True masks.
    """
    prunable = prunable or (lambda name: True)
    names = [n for n in weights if prunable(n)]
    if not names:
        return {n: np.ones_like(np.asarray(w), dtype=bool) for n, w in weights.items()}
    flat = np.concatenate([np.abs(np.asarray(weights[n]).ravel()) for n in names])
    thr = _threshold_for_sparsity(flat, sparsity)
    masks = {}
    for n, w in weights.items():
        w = np.asarray(w)
        masks[n] = (np.abs(w) > thr) if prunable(n) else np.ones_like(w, dtype=bool)
    return masks


def layer_magnitude_prune(weight: np.ndarray, sparsity: float) -> np.ndarray:
    """Per-tensor magnitude mask (True = keep)."""
    w = np.abs(np.asarray(weight))
    thr = _threshold_for_sparsity(w.ravel(), sparsity)
    return w > thr


def block_aware_prune(
    weight: np.ndarray,
    block: Tuple[int, int],
    *,
    block_density: float,
    in_block_density: float = 1.0,
) -> np.ndarray:
    """Hardware-aware two-level pruning.

    1. Score each (bm, bn) block by its L1 mass; keep the top
       ``block_density`` fraction — the rest become *entirely* zero so the
       static schedule drops them.
    2. Inside kept blocks, keep the top ``in_block_density`` fraction of
       elements by magnitude (unstructured; free at runtime, adds
       compression).

    Returns an element-level bool mask whose derived block bitmap has
    exactly ``ceil(block_density * n_blocks)`` present blocks.
    """
    w = np.asarray(weight)
    K, N = w.shape
    bm, bn = block
    if K % bm or N % bn:
        raise ValueError(f"weight {w.shape} not divisible by block {block}")
    gb = w.reshape(K // bm, bm, N // bn, bn)
    score = np.abs(gb).sum(axis=(1, 3))  # (K//bm, N//bn)
    n_total = score.size
    n_keep = max(1, int(np.ceil(block_density * n_total)))
    flat = score.ravel()
    keep_idx = np.argpartition(flat, n_total - n_keep)[n_total - n_keep:]
    block_mask = np.zeros(n_total, dtype=bool)
    block_mask[keep_idx] = True
    block_mask = block_mask.reshape(score.shape)

    if in_block_density >= 1.0:
        em = np.broadcast_to(block_mask[:, None, :, None], gb.shape)
        return em.reshape(K, N).copy()
    rows, cols = np.nonzero(block_mask)
    k_in = max(1, int(np.ceil(in_block_density * bm * bn)))
    m4 = np.zeros(gb.shape, dtype=bool)
    for r, c in zip(rows, cols):
        blk = np.abs(gb[r, :, c, :])
        thr = np.partition(blk.ravel(), blk.size - k_in)[blk.size - k_in]
        # >= thr can keep slightly more than k_in on ties; acceptable —
        # density targets are lower bounds for "keep".
        m4[r, :, c, :] = blk >= thr
    return m4.reshape(K, N)


def sparsity_of(mask) -> float:
    m = np.asarray(mask)
    return 1.0 - float(m.sum()) / m.size


# ------------------------------------------------------------- tensor side


def _tree_mul(tree: PyTree, masks: PyTree) -> PyTree:
    return tree_map(lambda t, m: t if m is None
                    else t * m.to(device=t.device, dtype=t.dtype), tree, masks)


def apply_masks(params: PyTree, masks: PyTree) -> PyTree:
    """Elementwise re-masking of a nested dict of tensors; a missing or None
    mask leaves its leaf as it is."""
    return _tree_mul(params, masks)


def masked_update(updates: PyTree, masks: PyTree) -> PyTree:
    """Zero the gradient/update where the mask is zero (frozen pattern)."""
    return _tree_mul(updates, masks)
