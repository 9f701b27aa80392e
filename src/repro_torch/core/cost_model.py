"""Roofline cost model — the accelerator analogue of the paper's ONNX-graph
latency/resource estimator, as ``repro.core.cost_model`` defines it.  Plain
Python float arithmetic, so every estimate equals the reference's.

Every layer of a model is summarised as a :class:`LayerSpec` (the layer IR).
Given a :class:`FoldingConfig` per layer, the model predicts

* ``latency``  — max(compute, memory, collective) roofline terms;
* ``resource`` — the "LUT" analogue: compute-lane claim + weight residency.

Dataflow semantics (matching the paper's Table I definitions):
* pipeline **throughput** = 1 / max-layer-latency (initiation interval);
* pipeline **latency**    = sum of layer latencies (fill time).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .folding import FoldingConfig

__all__ = [
    "HWSpec",
    "H100_SXM",
    "TPU_V5E",
    "LayerSpec",
    "decode_linear_spec",
    "layer_latency",
    "layer_resource",
    "network_estimate",
    "NetworkEstimate",
    "tile_roofline",
    "tile_vmem_bytes",
]


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops_bf16: float
    peak_flops_int8: float
    hbm_bw: float           # bytes/s
    ici_bw: float           # bytes/s per link
    hbm_bytes: int
    vmem_bytes: int
    lanes: int              # modelled compute lanes per chip (MXU columns)

    def peak_flops(self, bits: int) -> float:
        return self.peak_flops_int8 if bits <= 8 else self.peak_flops_bf16


TPU_V5E = HWSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    peak_flops_int8=394e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 2**30,
    vmem_bytes=128 * 2**20,
    lanes=2048,  # folding granularity: latency scales ~1/parallelism up to this
)

# NVIDIA's published H100 SXM5 80 GB figures at 700 W.  Every field is a
# datasheet figure, not a measurement.  Only ``CompileRules(hw=H100_SXM)``
# selects it: the compile pass defaults to TPU_V5E, the reference's picks.
H100_SXM = HWSpec(
    name="h100_sxm",
    # dense BF16 tensor-core peak (1979 TFLOP/s is with 2:4 sparsity)
    peak_flops_bf16=989e12,
    # dense INT8 tensor-core peak (3958 TOP/s is with 2:4 sparsity)
    peak_flops_int8=1979e12,
    # HBM3
    hbm_bw=3.35e12,
    # NVLink 4: 900 GB/s over 18 links
    ici_bw=50e9,
    # "80 GB", counted in GiB as TPU_V5E's 16 GB is
    hbm_bytes=80 * 2**30,
    # no one-to-one counterpart of a TPU's VMEM scratchpad.  Taken: the
    # most shared memory one thread block can claim (227 KiB), because
    # what this field gates is one kernel step's tile working set
    # (tile_vmem_bytes), and a CTA's tile lives in its SM's shared memory
    vmem_bytes=227 * 2**10,
    # no MXU columns on Hopper.  Taken: the tensor cores, 132 SMs x 4, the
    # units a layer's kernel occupies a share of (not a power of two, so
    # folding stops at 512 and sparse-unfold claims all 528)
    lanes=528,
)


@dataclasses.dataclass
class LayerSpec:
    """One node of the layer IR (shapes fixed by the arch × input shape)."""

    name: str
    kind: str                 # 'conv' | 'linear' | 'attention' | 'moe' | ...
    flops: float              # dense MACs*2 per network invocation
    weight_elems: int         # dense parameter count
    act_bytes: float          # activation HBM traffic per invocation (in+out)
    coll_bytes: float = 0.0   # collective bytes per invocation (sharded runs)
    prunable: bool = True
    max_block_density: float = 1.0   # from reference pruning (accuracy-safe)
    max_element_density: float = 1.0


def decode_linear_spec(K: int, N: int, batch_tokens: int = 1) -> LayerSpec:
    """Decode-shaped LayerSpec for an anonymous (K, N) linear — the shared
    default of ``compile_sparse.choose_policy`` and
    ``autotune.tuned_policy``, kept here so the heuristic pick and the
    autotune re-ranking always cost the same layer identically.  Conv
    leaves pass their own spec instead (MACs scale by output H·W)."""
    return LayerSpec(
        name="_", kind="linear",
        flops=2.0 * K * N * batch_tokens,
        weight_elems=K * N,
        act_bytes=4.0 * batch_tokens * (K + N),
    )


# Double-buffered 128x128 bf16 tile: the VMEM cost of one streaming lane.
LANE_UNIT_BYTES = 2 * 128 * 128 * 2

# Per-invocation overheads of the Pallas kernels, used by the autotuner to
# *rank* tile candidates before measuring (seed order, never a final score):
# one launch cost plus a per-grid-step cost (index-map evaluation, DMA issue).
KERNEL_LAUNCH_S = 2e-6
GRID_STEP_S = 5e-8


def tile_vmem_bytes(bm: int, bk: int, bn: int, *, x_bytes: int = 4,
                    w_bytes: int = 4) -> int:
    """VMEM claim of one (bm, bk) x (bk, bn) kernel step: double-buffered
    input/weight/output tiles plus the f32 accumulator.  The autotuner uses
    this as a feasibility gate — candidates that cannot fit on chip are
    never timed."""
    return (2 * (bm * bk * x_bytes + bk * bn * w_bytes + bm * bn * 4)
            + bm * bn * 4)


def tile_roofline(
    *,
    M: int,
    K: int,
    N: int,
    bm: int,
    bk: int,
    bn: int,
    n_blocks: Optional[int] = None,
    weight_bits: int = 32,
    hw: HWSpec = TPU_V5E,
    launch: bool = True,
) -> float:
    """Roofline latency of ONE kernel invocation under explicit tiles.

    The per-layer analogue of :func:`layer_latency` at kernel granularity —
    the autotuner seeds its measurement order with this prediction (the
    paper's Fig. 1 estimates-before-measurement loop, mapped onto tiles).

    ``n_blocks`` is the number of (bk, bn) weight tiles actually visited:
    the static schedule length for the block-sparse kernel (present blocks
    only — eliminated blocks cost nothing), or the full ``(K//bk)*(N//bn)``
    for the dense/quant kernel.  ``M`` is padded up to ``bm``, so the model
    charges thin decode batches for the rows the MXU pass wastes — this is
    exactly the term that makes small row tiles win at decode shapes.
    """
    if n_blocks is None:
        n_blocks = -(-K // bk) * (-(-N // bn))
    m_tiles = max(1, -(-M // bm))
    m_pad = m_tiles * bm
    grid = m_tiles * n_blocks
    flops = 2.0 * m_pad * n_blocks * bk * bn
    w_bytes = n_blocks * bk * bn * weight_bits / 8.0
    act_bytes = 4.0 * m_pad * (K + N)
    compute = flops / hw.peak_flops(weight_bits)
    memory = (w_bytes + act_bytes) / hw.hbm_bw
    t = grid * GRID_STEP_S + max(compute, memory)
    return t + (KERNEL_LAUNCH_S if launch else 0.0)


def layer_latency(spec: LayerSpec, cfg: FoldingConfig, hw: HWSpec) -> Dict[str, float]:
    """Three roofline terms + their max, for one layer under one folding.

    * folded/factor — dense weights *stream* from HBM every invocation; the
      layer occupies ``parallelism/lanes`` of the chip's compute.
    * sparse (sparse-unfolded) — the TPU analogue of the paper's fully
      unrolled pruned layer: compressed weights are *pinned in VMEM*
      (zero HBM weight traffic) and eliminated blocks cost zero FLOPs.
    """
    if cfg.unroll == "sparse":
        compute = spec.flops * cfg.block_density / hw.peak_flops(cfg.quant_bits)
        memory = spec.act_bytes / hw.hbm_bw
    else:
        p = min(cfg.parallelism, hw.lanes)
        compute = spec.flops / (hw.peak_flops(cfg.quant_bits) * p / hw.lanes)
        wbytes = spec.weight_elems * cfg.quant_bits / 8.0
        memory = (wbytes + spec.act_bytes) / hw.hbm_bw
    coll = spec.coll_bytes / hw.ici_bw if spec.coll_bytes else 0.0
    total = max(compute, memory, coll)
    return {"compute": compute, "memory": memory, "collective": coll, "total": total}


def layer_resource(spec: LayerSpec, cfg: FoldingConfig, hw: HWSpec) -> float:
    """The LUT analogue: VMEM bytes claimed (the scarce on-chip fabric).

    * folded/factor — ``parallelism`` double-buffered streaming tiles;
    * sparse-unfolded — pinned compressed weights (nnz × quant bits) plus
      one activation tile.  This is exactly why the paper's fully-unrolled
      *sparse* layer costs ~5% of the fully-unrolled dense one: resource
      scales with surviving nnz, not with the dense shape.
    """
    if cfg.unroll == "sparse":
        nnz_bytes = spec.weight_elems * cfg.element_density * cfg.quant_bits / 8.0
        return nnz_bytes + LANE_UNIT_BYTES
    return min(cfg.parallelism, hw.lanes) * LANE_UNIT_BYTES


@dataclasses.dataclass
class NetworkEstimate:
    per_layer: List[Dict[str, float]]
    latency: float        # pipeline fill = sum of layer latencies
    ii: float             # initiation interval = bottleneck latency
    throughput: float     # 1 / ii
    resource: float       # sum of layer resources
    bottleneck: str       # name of the II-dominating layer


def network_estimate(
    specs: Sequence[LayerSpec],
    cfgs: Sequence[FoldingConfig],
    hw: HWSpec = TPU_V5E,
) -> NetworkEstimate:
    rows, total_res = [], 0.0
    ii, lat, bott = 0.0, 0.0, ""
    for spec, cfg in zip(specs, cfgs):
        terms = layer_latency(spec, cfg, hw)
        res = layer_resource(spec, cfg, hw)
        rows.append({"name": spec.name, **terms, "resource": res})
        lat += terms["total"]
        total_res += res
        if terms["total"] > ii:
            ii, bott = terms["total"], spec.name
    return NetworkEstimate(
        per_layer=rows,
        latency=lat,
        ii=ii,
        throughput=1.0 / ii if ii > 0 else float("inf"),
        resource=total_res,
        bottleneck=bott,
    )
