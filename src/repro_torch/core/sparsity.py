"""Static two-level sparse weight format — the "engine-free" core.

A block bitmap over (bk, bn) weight tiles fixes, at compile time, which
tiles exist: absent tiles never reach the schedule, so they cost no
operations, no bytes and no memory.  Inside a present tile the element mask
is unstructured and is computed densely.  Both levels are compile-time
constants (host numpy), never data that a kernel reads to decide work.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .quant import PackedTensor, pack_codes

__all__ = [
    "BlockSparsePattern",
    "CompressedLinear",
    "compress",
    "compression_ratio",
    "decompress",
    "pattern_from_bitmap",
    "pattern_from_mask",
    "shared_pattern",
]


@dataclasses.dataclass(frozen=True, eq=False)
class BlockSparsePattern:
    """Static description of a two-level sparse (K, N) weight matrix.

    ``bitmap`` (K//bk, N//bn) bool marks present blocks; ``block_rows`` /
    ``block_cols`` (int16, int32 above 2**15 blocks) list their coordinates
    in row-major order — the static schedule.  ``nnz`` counts the surviving
    elements.  Compared and hashed by identity, so a pattern can key the
    per-device schedule cache of the sparse kernel.
    """

    shape: Tuple[int, int]
    block: Tuple[int, int]
    bitmap: np.ndarray
    block_rows: np.ndarray
    block_cols: np.ndarray
    nnz: int

    @property
    def n_blocks_total(self) -> int:
        return int(self.bitmap.size)

    @property
    def n_blocks_present(self) -> int:
        return int(self.block_rows.size)

    @property
    def block_density(self) -> float:
        return self.n_blocks_present / max(1, self.n_blocks_total)

    @property
    def element_density(self) -> float:
        return self.nnz / max(1, self.shape[0] * self.shape[1])

    @property
    def meta_bytes(self) -> int:
        """Static schedule metadata: packed bitmap + block coordinates."""
        return int(np.ceil(self.n_blocks_total / 8)) \
            + self.block_rows.nbytes + self.block_cols.nbytes


def pattern_from_bitmap(shape: Tuple[int, int], block: Tuple[int, int],
                        bitmap: np.ndarray, *,
                        nnz: Optional[int] = None) -> BlockSparsePattern:
    """Build the static pattern from a block-level bitmap (``nnz`` defaults
    to full present blocks)."""
    bitmap = np.asarray(bitmap, dtype=bool)
    rows, cols = np.nonzero(bitmap)
    cdt = np.int16 if max(bitmap.shape, default=0) < 2 ** 15 else np.int32
    return BlockSparsePattern(
        shape=tuple(int(s) for s in shape),
        block=tuple(int(b) for b in block),
        bitmap=bitmap,
        block_rows=rows.astype(cdt),
        block_cols=cols.astype(cdt),
        nnz=int(bitmap.sum()) * block[0] * block[1] if nnz is None else nnz,
    )


def pattern_from_mask(mask: np.ndarray, block: Tuple[int, int]) -> BlockSparsePattern:
    """Derive the static pattern from an element-level boolean mask."""
    mask = np.asarray(mask, dtype=bool)
    K, N = mask.shape
    bm, bn = block
    if K % bm or N % bn:
        raise ValueError(f"mask shape {mask.shape} not divisible by block {block}")
    bitmap = mask.reshape(K // bm, bm, N // bn, bn).any(axis=(1, 3))
    return pattern_from_bitmap((K, N), (bm, bn), bitmap, nnz=int(mask.sum()))


@dataclasses.dataclass
class CompressedLinear:
    """Compile-time-compacted sparse (optionally quantised) weight.

    ``blocks`` holds only the present tiles, ``(n_present, bk, bn)`` in the
    order of ``pattern.block_rows/cols``; with ``scales`` (N,) the blocks
    are int8 codes, or a :class:`PackedTensor` of them (uint8, packed along
    bk).  ``block_values()`` unpacks when needed.
    """

    pattern: BlockSparsePattern
    blocks: Union[torch.Tensor, PackedTensor]
    scales: Optional[torch.Tensor] = None
    bits: int = 16

    @property
    def packed(self) -> bool:
        return isinstance(self.blocks, PackedTensor)

    def block_values(self) -> torch.Tensor:
        return self.blocks.unpack() if self.packed else self.blocks

    @property
    def storage_bytes(self) -> int:
        if self.packed:
            b = self.blocks.container_bytes
        else:
            b = self.blocks.numel() * self.blocks.element_size()
        if self.scales is not None:
            b += self.scales.numel() * self.scales.element_size()
        return int(b) + self.pattern.meta_bytes


def compress(
    weight,
    mask,
    block: Tuple[int, int],
    *,
    pattern: Optional[BlockSparsePattern] = None,
    quant_scales=None,
    quant_bits: int = 8,
    dtype=torch.bfloat16,
    pack: bool = False,
) -> CompressedLinear:
    """Pack a masked dense weight into the static block-compacted format.

    ``quant_scales`` (N,) switches storage to int codes (dequantised at
    matmul time).  ``pattern`` forces an externally fixed schedule (the
    mask's own bitmap must be a subset; untouched blocks pack as zeros).
    ``pack=True`` (<=4-bit codes) bit-packs the codes into a uint8
    container, preferring the bk axis.  Host numpy arithmetic, so the codes
    match ``repro.core.sparsity.compress`` bit for bit; CPU tensors out.
    """
    weight = np.asarray(weight)
    mask = np.asarray(mask, dtype=bool)
    assert weight.shape == mask.shape
    if pattern is None:
        pattern = pattern_from_mask(mask, block)
    else:
        assert pattern.shape == weight.shape and pattern.block == tuple(block)
        own = pattern_from_mask(mask, block)
        assert (own.bitmap <= pattern.bitmap).all(), (
            "mask has nonzeros outside the forced pattern")
        pattern = dataclasses.replace(pattern, nnz=own.nnz)
    K, N = pattern.shape
    bm, bn = block
    w = (weight * mask).reshape(K // bm, bm, N // bn, bn).transpose(0, 2, 1, 3)
    packed = w[pattern.block_rows, pattern.block_cols]  # (n_present, bm, bn)
    if quant_scales is not None:
        scales = np.array(quant_scales, dtype=np.float32)
        assert scales.shape == (N,)
        qm = 2 ** (quant_bits - 1) - 1
        col_scale = scales.reshape(N // bn, 1, bn)[pattern.block_cols]
        q = np.clip(np.rint(packed / np.maximum(col_scale, 1e-12)), -qm, qm)
        codes = q.astype(np.int8)
        if pack:
            if quant_bits > 4:
                raise ValueError(
                    f"pack=True needs <=4-bit codes, got quant_bits="
                    f"{quant_bits} — int8 containers already hold 8-bit "
                    "codes exactly")
            per_byte = 4 if (quant_bits <= 2 and codes.shape[1] % 4 == 0) \
                else 2
            if codes.shape[1] % per_byte == 0:
                ax = 1
            elif codes.shape[2] % per_byte == 0:
                ax = 2
            else:
                ax = 1
            blocks = PackedTensor(
                data=pack_codes(torch.from_numpy(codes), axis=ax,
                                bits=8 // per_byte),
                shape=codes.shape, axis=ax, bits=quant_bits,
                per_byte=per_byte)
        else:
            blocks = torch.from_numpy(codes)
        return CompressedLinear(pattern=pattern, blocks=blocks,
                                scales=torch.from_numpy(scales),
                                bits=quant_bits)
    if pack:
        raise ValueError(
            "pack=True needs quantised (<=4-bit) blocks — float blocks "
            "have no sub-byte container")
    return CompressedLinear(
        pattern=pattern,
        blocks=torch.from_numpy(np.ascontiguousarray(packed, np.float32)).to(dtype),
        bits=16)


def decompress(cl: CompressedLinear) -> torch.Tensor:
    """Reconstruct the dense (K, N) weight (oracle / testing path)."""
    K, N = cl.pattern.shape
    bm, bn = cl.pattern.block
    blocks = cl.block_values()
    rows = torch.as_tensor(cl.pattern.block_rows.astype(np.int64),
                           device=blocks.device)
    cols = torch.as_tensor(cl.pattern.block_cols.astype(np.int64),
                           device=blocks.device)
    if cl.scales is not None:
        col_scale = cl.scales.reshape(N // bn, bn)[cols]          # (P, bn)
        blocks = blocks.to(torch.float32) * col_scale[:, None, :]
    grid = torch.zeros((K // bm, N // bn, bm, bn), dtype=blocks.dtype,
                       device=blocks.device)
    grid[rows, cols] = blocks
    return grid.permute(0, 2, 1, 3).reshape(K, N)


def shared_pattern(K: int, N: int, block: Tuple[int, int],
                   density: float) -> BlockSparsePattern:
    """Deterministic diagonal-striped block bitmap at ~``density``,
    identical for every layer of a class (cached; ``block`` must be a
    ``(bm, bn)`` tuple)."""
    if not isinstance(block, tuple):
        raise TypeError(
            f"shared_pattern caches on its arguments; block must be a "
            f"(bm, bn) tuple, got {type(block).__name__}")
    return _shared_pattern_cached(int(K), int(N), block, float(density))


@functools.lru_cache(maxsize=None)
def _shared_pattern_cached(K: int, N: int, block: Tuple[int, int],
                           density: float) -> BlockSparsePattern:
    bm, bn = block
    nR, nC = K // bm, N // bn
    stride = max(1, round(1.0 / max(density, 1e-6)))
    i, j = np.meshgrid(np.arange(nR), np.arange(nC), indexing="ij")
    return pattern_from_bitmap((K, N), block, (i + j) % stride == 0)


def compression_ratio(
    shape: Tuple[int, int],
    nnz: int,
    *,
    bits: int = 8,
    dense_bits: int = 32,
    index_bits_per_nnz: float = 0.0,
    block_meta_bits: int = 0,
) -> float:
    """Paper's compression metric: dense fp32 bits / compressed bits.

    For the engine-free format the per-nnz index cost is ~0 (the pattern is
    compiled into the program, mirroring the paper's "weights become
    wires"); ``block_meta_bits`` accounts the bitmap honestly.
    """
    dense = shape[0] * shape[1] * dense_bits
    comp = nnz * (bits + index_bits_per_nnz) + block_meta_bits
    return dense / max(comp, 1)
