"""LogicSparse core of the port: engine-free static sparsity, the payload
families and their dispatch, and the hardware-aware cost model and DSE.

Exports the reference's ``repro.core`` names.  They load on first
access, so importing a kernel module that imports ``core.quant`` never
imports the dispatch that imports the kernels back.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "sparsity": ("BlockSparsePattern", "CompressedLinear", "compress",
                 "decompress", "compression_ratio", "pattern_from_mask"),
    "pruning": ("global_magnitude_prune", "layer_magnitude_prune",
                "block_aware_prune", "apply_masks", "masked_update",
                "sparsity_of"),
    "quant": ("PACKED_CONTAINER", "PackedTensor", "QuantizedTensor",
              "quantize", "dequantize", "fake_quant", "pack_int4",
              "pack_quantized", "qmax", "unpack_int4"),
    "folding": ("FoldingConfig", "UNROLL_LEVELS"),
    "cost_model": ("HWSpec", "TPU_V5E", "H100_SXM", "LayerSpec",
                   "layer_latency", "layer_resource", "network_estimate",
                   "NetworkEstimate"),
    "dse": ("DSEResult", "apply_realised_densities",
            "balanced_folding_baseline", "run_dse"),
    "lm_ir": ("lm_layer_specs",),
    "dispatch": ("DISPATCH_ENV", "ConvPayload", "DispatchConfig",
                 "conv_dispatch", "conv_im2col", "linear_dispatch",
                 "payload_dispatch"),
    "autotune": ("AUTOTUNE_CACHE_ENV", "TuneOptions", "TunedConfig",
                 "TunedTable", "autotune_attn", "autotune_leaf",
                 "autotune_lenet", "autotune_model", "bucket_m",
                 "default_cache_path", "dse_retune", "load_table",
                 "schedule_hash", "tune_key", "tuned_policy"),
    "compile_sparse": ("CompileRules", "CompressedModel", "LayerReport",
                       "choose_policy", "compile_lenet", "compile_model",
                       "conv_weight_matrix", "conv_weight_unmatrix",
                       "decompress_model", "realised_densities"),
}
_ALIASES = {"resolve_dispatch": ("dispatch", "resolve")}
_WHERE = {name: (mod, name) for mod, names in _EXPORTS.items()
          for name in names}
_WHERE.update(_ALIASES)

__all__ = sorted(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod, attr = _WHERE[name]
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
    globals()[name] = value
    return value
