"""Folding configuration — the accelerator analogue of FINN's PE/SIMD
folding, as ``repro.core.folding`` defines it (plain data, no torch).

On the FPGA, a layer's *folding factor* decides how many multiply lanes are
instantiated (more lanes = lower latency = more LUTs).  On an accelerator
the same knob appears twice:

* single chip — kernel tile shapes / how much of the chip's matrix units a
  layer's kernel occupies per cycle (modelled as ``parallelism`` lanes);
* multi chip — the shard factor over the ``model`` mesh axis.

``unroll`` levels mirror the paper:
  'folded'  — time-multiplexed (baseline, p small)
  'factor'  — factor-unfolding: more parallel lanes, still dense
  'sparse'  — sparse-unfolding: fully unrolled *and* statically pruned;
              zero blocks are eliminated from the schedule, so both the
              compute-resource and weight-residency cost scale with density.
"""
from __future__ import annotations

import dataclasses

__all__ = ["FoldingConfig", "UNROLL_LEVELS"]

UNROLL_LEVELS = ("folded", "factor", "sparse")


@dataclasses.dataclass
class FoldingConfig:
    parallelism: int = 1          # compute lanes (power of two)
    unroll: str = "folded"        # one of UNROLL_LEVELS
    block_density: float = 1.0    # fraction of (bm,bn) blocks kept
    element_density: float = 1.0  # nnz fraction inside kept blocks incl. block loss
    quant_bits: int = 8           # weight storage bits
    block: tuple = (128, 128)     # kernel tile
    shard_model: int = 1          # mesh 'model' axis shard factor

    def replace(self, **kw) -> "FoldingConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.unroll in UNROLL_LEVELS
        assert self.parallelism >= 1 and (self.parallelism & (self.parallelism - 1)) == 0
        assert 0.0 < self.block_density <= 1.0
        assert 0.0 < self.element_density <= 1.0
        assert self.quant_bits in (4, 8, 16)
