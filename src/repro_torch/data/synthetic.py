"""Deterministic synthetic data, numpy only: digits and token batches.

Digits are an MNIST-like 10-class task.

Each class is a fixed random 28×28 prototype, smoothed by a 3×3 box filter;
samples are prototypes plus Gaussian noise.  The port keeps its own copy of
``repro.data.synthetic``'s digit task: the prototypes are byte-equal for the
same seed.  ``DigitTask.batch`` seeds from ``hash((split, step, shard))``,
and Python salts the hash of a ``str`` per process, so a batch is only
reproducible inside one process: to compare two implementations, draw the
batch once and hand the same array to both.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DigitTask", "synthetic_digits", "token_batch"]


class DigitTask:
    """Fixed prototypes; train/test batches by split-disjoint seeding."""

    def __init__(self, seed: int = 0, noise: float = 0.35):
        rng = np.random.default_rng(seed)
        base = rng.normal(size=(10, 28, 28, 1)).astype(np.float32)
        # smooth the prototypes a little so pruned nets generalise
        k = np.ones((3, 3)) / 9.0
        sm = base.copy()
        for c in range(10):
            img = base[c, :, :, 0]
            pad = np.pad(img, 1, mode="edge")
            sm[c, :, :, 0] = sum(
                pad[i:i + 28, j:j + 28] * k[i, j]
                for i in range(3) for j in range(3))
        self.protos = sm
        self.noise = noise

    def batch(self, step: int, batch_size: int, *, split: str = "train",
              shard: int = 0, n_shards: int = 1):
        """(images (B, 28, 28, 1) f32, labels (B,) int32)."""
        seed = (hash((split, step, shard)) % (2**31)) ^ 0x5EED
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, 10, size=batch_size)
        x = self.protos[labels] + rng.normal(
            scale=self.noise, size=(batch_size, 28, 28, 1)).astype(np.float32)
        return x.astype(np.float32), labels.astype(np.int32)


def synthetic_digits(seed=0, noise=0.35) -> DigitTask:
    return DigitTask(seed, noise)


def token_batch(step: int, batch: int, seq: int, vocab: int, *,
                seed: int = 0, shard: int = 0, n_shards: int = 1):
    """(tokens, labels) with Zipf marginals + deterministic bigram structure
    (a copy of ``repro.data.synthetic.token_batch``: byte-equal output)."""
    rng = np.random.default_rng((seed * 1_000_003 + step) * 65_537 + shard)
    # zipf draw clipped to vocab
    z = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = (z % (vocab - 1)) + 1
    # bigram structure: with p=0.5, next token = f(prev) for a fixed affine f
    follow = rng.random((batch, seq + 1)) < 0.5
    affine = (toks * 31 + 7) % (vocab - 1) + 1
    toks[:, 1:] = np.where(follow[:, 1:], affine[:, :-1], toks[:, 1:])
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return tokens, labels
