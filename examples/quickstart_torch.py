"""Quickstart on the PyTorch/CUDA port: the LogicSparse core, layer-level
and whole-model.

Prune a weight matrix with the hardware-aware two-level pruner, compress it
into the engine-free static block format (int8), run the CUDA kernel
against its plain version, let the DSE balance a small network — then lower
a *whole model* onto the compressed datapath with ``compile_model`` and
decode with it.

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Kernel dispatch: every compiled linear executes through
``repro_torch.core.dispatch``, which picks per layer between the CUDA
kernels (quant_matmul / block_sparse_matmul, fused dequant + bias /
activation epilogue) and their plain PyTorch versions.  The
``REPRO_TORCH_DISPATCH`` environment variable sets the choice globally:

  REPRO_TORCH_DISPATCH=auto    (default) the kernel for CUDA tensors, the
                               plain version for CPU ones
  REPRO_TORCH_DISPATCH=kernel  the kernel; a CPU tensor raises
  REPRO_TORCH_DISPATCH=twin    the plain version on any device

The same knob is the ``dispatch=`` argument of ``forward`` /
``decode_step`` / ``ServeEngine`` / ``lenet_forward``.  The autotuner's
table lives at ``REPRO_TORCH_AUTOTUNE_CACHE`` (default
``results/autotune_torch.json``); this example tunes into a temporary file
of its own (``path=``), so it neither reads nor writes that table.  Each section asserts its error against the plain or dense
oracle: within ``TOL`` of the oracle's largest value.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core import (
    CompileRules, DispatchConfig, LayerSpec, TuneOptions,
    autotune_model, block_aware_prune, compile_lenet, compile_model, compress,
    compression_ratio, conv_dispatch, conv_weight_matrix, decompress_model,
    payload_registry, quantize, run_dse, sparsity_of,
)
from repro_torch.core.compile_sparse import compile_conv
from repro_torch.device import resolve_device
from repro_torch.kernels.sparse_matmul.ops import sparse_linear
from repro_torch.models.config import ArchConfig
from repro_torch.models.lenet import LAYERS, init_lenet, lenet_forward
from repro_torch.models.model import decode_step, init_cache, init_params

# f32 everywhere: the kernels against their oracles, share of max|oracle|
TOL = 1e-4


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def check(what: str, got, want) -> float:
    err = rel_err(got, want)
    print(f"{what} max err: {err:.2e} of the largest value")
    assert err <= TOL, f"{what}: {err:.2e} > {TOL}"
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # IEEE f32 oracles (cuDNN's default conv math is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    # 1. hardware-aware two-level pruning: whole 128x128 blocks leave the
    #    static schedule; elements inside survivors stay unstructured.
    rng = np.random.default_rng(0)
    w = rng.normal(size=(512, 512)).astype(np.float32)
    mask = block_aware_prune(w, (128, 128), block_density=0.375,
                             in_block_density=0.4)
    print(f"element sparsity: {sparsity_of(mask):.2%}")

    # 2. compress: int8 storage + compile-time block compaction (host
    #    numpy, as the compile pass packs), then onto the device
    q = quantize(torch.from_numpy(w), 8, axis=1)
    cl = compress(w, mask, (128, 128), quant_scales=q.scales.numpy(),
                  quant_bits=8)
    cl = dataclasses.replace(cl, blocks=cl.blocks.to(dev),
                             scales=cl.scales.to(dev))
    print(f"blocks kept: {cl.pattern.n_blocks_present}/"
          f"{cl.pattern.n_blocks_total}  compression vs fp32: "
          f"{compression_ratio(cl.pattern.shape, cl.pattern.nnz, bits=8):.1f}x")

    # 3. execute: the block-sparse kernel (its plain version for a CPU
    #    tensor) against the plain version
    x = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32)).to(dev)
    y_kernel = sparse_linear(x, cl, use_kernel=True)
    y_plain = sparse_linear(x, cl, use_kernel=False)
    out["kernel_vs_plain"] = check("kernel-vs-plain", y_kernel, y_plain)

    # 4. DSE: balance a 3-layer pipeline under a resource budget (Fig. 1)
    specs = [
        LayerSpec("embed", "linear", flops=2e8, weight_elems=4_000_000,
                  act_bytes=1e5, max_block_density=0.4,
                  max_element_density=0.1),
        LayerSpec("mlp", "linear", flops=8e8, weight_elems=8_000_000,
                  act_bytes=2e5, max_block_density=0.5,
                  max_element_density=0.15),
        LayerSpec("head", "linear", flops=1e8, weight_elems=2_000_000,
                  act_bytes=5e4, max_block_density=0.5,
                  max_element_density=0.2),
    ]
    res = run_dse(specs, resource_budget=32e6)
    print(f"DSE (TPU_V5E estimates): II {res.baseline.ii:.2e}s -> "
          f"{res.estimate.ii:.2e}s ({res.baseline.ii / res.estimate.ii:.1f}x), "
          f"sparse-unfolded: {res.sparse_layers}")

    # 5. whole-model pass: compile a transformer onto the compressed
    #    datapath.  Every eligible linear becomes dense / int8-quant /
    #    block-sparse (the cost model's choice); the result decodes directly
    #    through decode_step or ServeEngine(cm, cfg), and
    #    decompress_model() is the dense oracle.
    cfg = ArchConfig(name="qs", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=211,
                     param_dtype="float32", remat=False)
    params = init_params(cfg, seed=0, device=dev)
    cm = compile_model(params, cfg, rules=CompileRules(
        block=(32, 32), min_weight_elems=1024, block_density=0.5),
        device=dev)
    print("compiled policies:", {r.name: r.policy for r in cm.report})
    print(f"model storage: {cm.dense_bytes} -> {cm.storage_bytes} bytes "
          f"({cm.compression:.1f}x)")
    toks = torch.tensor([[3]], dtype=torch.int32, device=dev)

    def decode(p, **kw):
        return decode_step(p, cfg, init_cache(cfg, 1, 16, device=dev), toks,
                           **kw)[0]

    lc = decode(cm.params, patterns=cm.patterns)
    ld = decode(decompress_model(cm))
    out["compressed_vs_oracle"] = check("compressed-vs-oracle decode", lc, ld)

    # 6. kernel dispatch: the same compiled model through the plain
    #    versions (dispatch="twin") — one kernel launch per compiled linear
    #    on the card against the plain version's gathers
    lt = decode(cm.params, patterns=cm.patterns, dispatch="twin")
    out["kernel_vs_twin"] = check("kernel-vs-twin dispatch decode", lc, lt)

    # 7. autotune: the compile pass defers the per-layer policy and
    #    bit-width to the cost model (policy="autotune"); the tuner times
    #    the legal plans of each compiled leaf (the rule's plan first) and
    #    caches them on disk keyed by (shape, dtype, backend, schedule).  A
    #    second run is a pure cache lookup, and the tuned table rides
    #    DispatchConfig into the step: the same numerics, tuned plans.
    cm_at = compile_model(params, cfg, rules=CompileRules(
        block=(32, 32), min_weight_elems=1024, block_density=0.5,
        policies={k: "autotune" for k in ("wq", "wk", "wv", "wo",
                                          "wg", "wu", "wd")}), device=dev)
    print("autotuned policies:", {r.name: r.policy for r in cm_at.report})
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune_torch.json")
        table = autotune_model(cm_at, M=1, options=TuneOptions(iters=3),
                               path=cache)
        retuned = autotune_model(cm_at, M=1, options=TuneOptions(iters=3),
                                 path=cache)
    print(f"autotune: {len(table)} leaves tuned, cache reuse re-timed "
          f"{retuned.n_timings()} candidates")
    assert retuned.n_timings() == 0
    lt = decode(cm_at.params, patterns=cm_at.patterns,
                dispatch=DispatchConfig(mode="auto", tuned=table))
    l0 = decode(cm_at.params, patterns=cm_at.patterns)
    out["tuned_vs_default"] = check("tuned-vs-default decode", lt, l0)

    # 8. convolutions through the SAME datapath: compile a FULL LeNet-5.
    #    compile_lenet lowers conv1/conv2 onto their im2col matrices
    #    (conv_weight_matrix, patch-feature order) through the same
    #    compress/quantize pipeline as the FCs, wraps them as ConvPayloads,
    #    and lenet_forward runs them through conv_dispatch — patches
    #    gathered in the fused conv kernel, bias + relu in its epilogue.
    #    The report covers every layer, so cm.compression is the
    #    whole-model ratio (conv+fc).
    lp = init_lenet(seed=2, device=dev)
    lblocks = {"conv1": (5, 2), "conv2": (10, 4),
               "fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2)}
    lmasks = {}
    for name, kind, _ in LAYERS:
        w2 = lp[name + "_w"].cpu().numpy()
        if kind == "conv":
            w2 = conv_weight_matrix(w2)  # (kh,kw,cin,cout) -> (K,N)
        lmasks[name] = block_aware_prune(w2, lblocks[name], block_density=0.5,
                                         in_block_density=0.8)
    cml = compile_lenet(lp, lmasks, blocks=lblocks,
                        rules=CompileRules(block=(8, 4), min_weight_elems=0),
                        device=dev)
    print("lenet per-layer policies:", {r.name: r.policy for r in cml.report})
    print(f"whole-model (conv+fc) compression: {cml.compression:.1f}x "
          f"({cml.dense_bytes} -> {cml.storage_bytes} bytes)")
    img = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 28, 28, 1)).astype(np.float32)).to(dev)
    with torch.no_grad():
        yc = lenet_forward(lp, img, compressed=cml.layers)
        yd = lenet_forward(decompress_model(cml), img)
    out["lenet_vs_oracle"] = check("conv+fc compressed-vs-oracle", yc, yd)

    # 9. beyond stride-1 VALID: compile_conv carries the full static
    #    geometry (strides, SAME padding, dilation) into the ConvPayload,
    #    so resnet-style convs run through the same kernels; and every
    #    compressed-leaf format — the per-channel-scale int8 family too —
    #    is a registered module (repro_torch.core.payload_registry), so
    #    policies are registry names.
    w4 = np.random.default_rng(6).normal(size=(3, 3, 8, 16)).astype(
        np.float32)
    xs = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 14, 14, 8)).astype(np.float32)).to(dev)
    for pol in ("sparse", "perchannel"):
        cpay, _, rep = compile_conv(
            w4, strides=(2, 2), padding="SAME", policy=pol, name=pol,
            rules=CompileRules(block=(8, 4), min_weight_elems=1),
            in_hw=(14, 14), device=dev)
        ys = conv_dispatch(cpay, xs)
        print(f"stride-2 SAME conv [{pol:>10}]: out {tuple(ys.shape)}, "
              f"{rep.compressed_bytes}/{rep.dense_bytes} bytes")
        assert tuple(ys.shape) == (2, 7, 7, 16)
        out[f"conv_{pol}_vs_twin"] = check(
            f"stride-2 SAME conv [{pol}] vs twin", ys,
            conv_dispatch(cpay, xs, dispatch="twin"))
    print("registered payload families:",
          [f.name for f in payload_registry.all_families()])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
