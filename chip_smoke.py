#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile every CUDA kernel from ``src/repro_torch/csrc``;
3. kernels — hold each kernel against its plain PyTorch version over every
   container, row count and activation, on every route of
   ``block_sparse_matmul`` and ``quant_matmul`` (thin-M, M <= 16;
   tensor-core, bf16 x past 16 rows, bitwise equal across two calls; and
   tiled; f32 and bf16 blocks on the thin-M and tensor-core routes too,
   and quant codes of N % 16 == 8 columns, copied by cp.async), of ``packed_decode_attention`` (split across the cache and its query
   rows in groups of 8, C in {1, 16}, G in {1, 4, 9}, Dh in {64, 80, 96,
   128}; and the single kernel for shapes outside the split build: dead,
   ragged and full slots, bitwise equal across extents and calls) and of the flash
   kernel (tensor cores for bf16 Dh 64/80/96/128, CUDA cores for the rest:
   causal or not, GQA, ragged and unequal Tq / Tk, bf16 and f32, a
   sequence-sharded rank's query offset on both routes, and its op's
   gradient, at an offset too) and of the fused convs (register-tiled at LeNet's shapes,
   strided and unpooled, f32 and bf16 x; band for the 3 x 3 pool, and for
   every register-tiled case again) and of the FC stack (staged, f32 and
   bf16 x, at the edge of shared memory; stream for every staged case
   again and past that edge), requiring each call
   to take the route its shape rule names;
   then time kernel, plain version and a one-call PyTorch yardstick at the
   shapes the main paths give it, beside the least time the card could take
   (``bound_ms``) and the first version of each redesigned kernel; the
   tensor-core routes' f32 sums against the plain version (f32 blocks
   among them); and the widened routes (ragged quant column tiles,
   hubert-xlarge's 504-column head, flash at Dh 80 / 96, actsparse's f32
   blocks at M = 8 and 512) beside their first designs, bounds and
   one-call library times;
4. serve   — compile llama3.2-1b at full width (random weights from a seed)
   to int4x2 quant/block-sparse leaves; serve 16 requests through
   ``ServeEngine`` with the int4x2 KV cache, each step a CUDA graph per
   phase and bucket (after warm-up requests that reach every bucket),
   require every kernel to have launched and every packed attention read
   (decode rows and 16-row prefill chunks) on the split route; replay one
   captured decode step and one captured prefill chunk from a saved cache
   state against the same steps run eagerly (logits and cache bit for bit,
   the same launches); serve the same requests eagerly (identical tokens),
   with the int4 cache (identical tokens) and with the "unpack" read (the
   same tokens, or a tie at the first difference); hold a prefill chunk
   plus 4 decode steps against the plain versions (``dispatch="twin"``)
   for each container, each decode step's 64 ``quant_matmul`` and 48
   ``block_sparse_matmul`` calls on their thin-M routes and 16 attention
   reads on the split route; profile a decode step and a prefill chunk,
   captured and eager (wall, device busy, idle share); count the
   programmatic edges of a captured decode step; then run the compiled
   model's full-sequence forward (B = 1, T = 512) through
   ``block_sparse_matmul`` and ``quant_matmul`` (all 112 linears on their
   tensor-core routes) and the flash kernel (tensor-core route), held
   against the twin path, with its wall time, device busy time and idle
   share;
4a. sharding — on NCCL at world size 1 (a file store in a temporary
   directory; no fallback), the (1, 1) ``("data", "model")`` mesh: the
   train phase's llama3.2-1b step (4 x 2048, 2 micro-batches, frozen MLP
   masks) for 2 steps through ``TrainRunner``, unplaced and then with
   parameters, ZeRO moments, masks and batch placed by the sharding rules
   (losses within 2^-8 and grad norms within 2%, 64 tensor-core flash
   launches a placed step); the serve phase's compile through a 16-row
   prefill chunk of 8 slots and 4 decode steps with the int4x2 cache,
   unplaced and placed by ``cache_specs`` (logits bit for bit); both
   steps timed (DTensor's host cost); then, in one process, each rank's
   local kernel call at model axes 2 and 4 — every compiled leaf class of
   a layer at M = 8 and 128 (``wq``/``wk``/``wv`` column-parallel, ``wo``
   row-parallel, the MLP's blocks replicated where their pattern does not
   partition, a crafted partitioning ``wg`` on local schedules), the tied
   head vocab-sharded, the packed reads (C = 1, 16) and the training
   flash call with its op's backward on local heads, and the placed
   ``seq_shard`` leg (``attn_full_dispatch`` on CUDA DTensors, q cut along
   T) at each rank of a fake (1, n) group, each rank's rows at their query
   offset (bf16 on the tensor cores, and an f32 call on the CUDA cores) —
   combined as the collective would and held within one bf16 step of the
   unsharded call (dk, dv summed over n ranks: n steps), each kernel call
   on the route its shape rule names; each rank's sequence-sharded flash
   call at model 4, and the whole call, timed on 4 input copies beside
   its bound, plain version and SDPA with the offset rows' mask;
4a'. seq cache — the sequence-sharded KV cache: llama3.2-1b's packed
   reads (int4x2 and int4, 8 slots over 512 rows, decode and the 16-row
   chunk) cut into the ranges of model axes 2 and 4, each range's split
   call (``return_lse``: its combine pass writes each row's log-sum-exp)
   combined across ranges and held within one bf16 step of the whole split
   read and of the plain version (lse within 1e-5), with rows whose range
   holds no live key; each range call, the combine and the whole read
   timed; then the dry-run of llama3.2-1b's ``decode_32k`` and
   ``train_4k`` cells and olmoe-1b-7b's ``decode_32k`` on the (16, 16)
   mesh (``python -m repro_torch.launch.dryrun``, started after the build
   in processes of their own that see no card), each required ``ok``, its
   per-rank bytes and counts printed;
4a''. moe sharding — the MoE layer's placed leg on a new NCCL (1, 1)
   mesh: olmoe-1b-7b at 2 of 16 layers (bf16, f32 AdamW moments, frozen
   expert masks) for 2 steps of 2 x 1024 tokens in 2 micro-batches
   through ``TrainRunner``, unplaced and placed from the same state
   (losses and grad norms within 2^-8 / 2%, pruned weights exactly zero,
   the same launches); qwen2-moe-a2.7b at 2 of 24 layers compiled as the
   MoE serving path compiles it, 8 slots dripped 4 steps on the int4x2
   cache, unplaced and placed (logits bit for bit, the same launches by
   route, both steps' eager host ms); then, in one process, the leg's
   local function of each rank of (data, model) (2, 2) and (1, 4) on
   olmoe-1b-7b's full-width layer (8 drip tokens; the 2 x 1024 train
   batch): the ranks' parts summed within one bf16 step of the unsharded
   layer, every rank's keep mask the unsharded one, each rank's capacity
   rows and ``Fe`` columns printed;
4a'''. ssm sharding — the SSM and hybrid families' placed legs on a new
   NCCL (1, 1) mesh: xlstm-1.3b at 8 of 48 layers (one super-block) and
   zamba2-2.7b at 6 of 54 (one super-block), full width, bf16, f32 AdamW
   moments, remat, 2 steps of 2 x 512 / 2 x 1024 tokens in 2
   micro-batches through ``TrainRunner``, unplaced and placed from the
   same state (losses and grad norms bit for bit, the same launches by
   route); zamba2-2.7b compiled as the hybrid serving path compiles it and
   xlstm-1.3b with int8 mLSTM leaves, 8 slots dripped 4 steps (int4x2
   cache), unplaced and placed (logits bit for bit, the same launches);
   then, in one process, the legs' local functions rank by rank at model
   axes 4 and 16 on one full-width Mamba2 and one mLSTM layer (chunkwise
   at T 512, and one recurrent step on a filled state): each rank's part
   combined as the collectives would, within 1e-5 of the largest value of
   the unsharded layer, the updated states too; xlstm-1.3b's and
   zamba2-2.7b's ``decode_32k`` dry-run cells;
4b. autotune — on the serve phase's compile: ``autotune_model`` at M = 8
   and 512 into a new table under ``chiprun_out/``, every candidate plan
   held against its plain version before it is timed (CUDA events, leaves
   rotated over copies past the L2); a second run times nothing;
   ``autotune_attn`` at the engine's shape; ``ServeEngine(cm,
   autotune=table)`` serves the 16 requests captured with every matmul
   launch on its tuned plan (no misses, the routes its entries name), the
   untuned engine's tokens or a tie at the first difference, a captured
   decode step and prefill chunk bit for bit their eager steps; the tuned
   decode step profiled beside the untuned one;
5. lenet   — compile LeNet-5 at its published widths (random weights from a
   seed) with the Table-I whole-model rules, run the fused forward on 256
   synthetic digits, require ``block_sparse_conv`` x2 and
   ``fc_stack_matmul`` x1 per forward (``quant_conv`` x2 with the convs
   under "quant"), every conv on the register-tiled route and the FC stack
   on the staged route, hold the logits
   against ``dispatch="twin"``, and time images/s beside the masked-dense
   forward;
5b. fig1   — the paper's Fig. 1 workflow (``repro_torch.train.
   lenet_pipeline.run`` with the strategy rows at ``H100_SXM``, cost-model
   estimates): LeNet-5 trained 80 steps, pruned (global magnitude for the
   DSE's caps, then two-level block-aware masks), fine-tuned 200 masked
   int4 QAT steps, compiled whole and FC-only; ``cm_whole`` deployed
   through ``lenet_forward(fusion=True)`` on the 1024 test digits with the
   counts set to 0 just before it: its launches by route as the compile's
   report implies (register-tiled convs, the staged FC stack), the logits
   within ``LENET_TOL`` of the twin, top-1 equal within one image, the
   stored-bits ratio ``FIG1_STORED_BITS`` (unless a pruning tie kept more),
   whole-model bytes at least 11x and above FC-only, both loss curves
   falling; then ``examples/llm_sparse_train_torch.py`` at its ~100M
   config, 30 steps pruned at 20 and a second run to 40 resumed from the
   last checkpoint (every flash launch f32 on the CUDA-core route, the
   pruned weights exactly 0, the masks kept, losses falling); then
   ``examples/quickstart_torch.py`` and ``examples/serve_batched_torch.py``
   with their own asserts;
6. families — the newer payload families on the ported kernels:
   perchannel (8 and 4 bits), bfp8, int2 (quant at 2 bits), sparse at 2
   bits (int2x4 blocks) and actsparse (tau 0.05, under a ReLU: the fused
   ("trelu", tau) epilogue) at llama3.2-1b's full-width leaf shapes,
   through ``payload_dispatch`` against ``dispatch="twin"`` at bf16 M = 8
   and 512 and f32 M = 8 and 64, each call on the route its rule names,
   timed at M = 8 and 512 beside the int4x2 leaf of its kernel; then
   llama3.2-1b at full width compiled three times — no policies (the cost
   model's pick under TPU_V5E), a family map at 8 bits, and 2 bits — each
   held against the twin path (a prefill chunk and 4 decode steps) and
   serving 4 requests captured and eager with identical tokens, every
   matmul launch on the route its rule names (the H100_SXM picks printed
   as an estimate; the family map's actsparse leaves never tiled, its
   captured decode step profiled with block_sparse_matmul's share); then LeNet-5 with no policies and with 2-bit quant
   convs, the fused forward against the twin with its launches, and
   ``run_dse`` / ``balanced_folding_baseline`` at the Table-I budget on
   both HWSpecs (estimates);
7. zoo     — qwen1.5-4b and starcoder2-7b at full width, cut to 6 and 4
   layers in depth (``ZOO_LAYERS``; bf16, random weights from a seed),
   each compiled with the serve phase's rules (no
   ``wg`` for starcoder2's GELU MLP; the untied head takes the cost
   model's pick), with its host and device memory peaks; the twin check
   (a prefill chunk and 4 decode steps; the float cache within
   ``TWIN_TOL``, the int4x2 cache within ``ZOO_TWIN_TOL``); the serve
   phase's 16 requests captured, every matmul and packed attention read on the
   route its shape rule names (every packed read split: starcoder2's
   16-row prefill chunks, 144 query rows a kv head, in 18 row groups; no
   single-kernel launch), and eagerly with the same
   tokens; captured decode and prefill profiles; their leaves (``wq``,
   ``wk``, the MLP, the head) and attention reads at M = 8 held against
   the plain versions and timed; then the acceptance matrix on the
   kernels (``build_matrix``, ``dispatch="kernel"``): every oracle floor,
   the 8 expected_fail cells failing, bfp8@2 passing, all 64 cells run
   (the 4 autotune cells among them), each cell's decode time;
7b. encoder_vlm_moe — four configs at full width (bf16, random weights
   from seed 0), each compiled with ``zoo_rules`` (the head left to the
   cost model), each path's counts set to 0 just before it and read just
   after: hubert-xlarge's compiled forward on 4 x 1024 frame embeddings
   (non-causal; every matmul on its rule's route, all tensor-core routes,
   the 504-column head's codes copied by cp.async, 48 flash calls on the
   tensor-core route at Dh 80), held against the twin within
   ``TWIN_TOL["float"]``; phi-3-vision-4.2b (cut to 16 of 32 layers,
   ``VLM_LAYERS``): its twin check, its 16 requests
   served captured (every launch on its rule's route, the Dh 96 reads
   split) with the capture check, its captured step profiles
   and the compiled forward over 576 prefix embeddings and 512 tokens;
   olmoe-1b-7b and qwen2-moe-a2.7b (cut to 8 of 16 and 4 of 24 layers)
   through the
   token drip: a twin check that also counts the router choices that
   differ (``MOE_TWIN_TOL``), 16 and 4 requests served captured per bucket
   with every launch on its rule's route and the bitwise capture check,
   and the captured drip step's profile; the flash kernel at Dh 80 and
   96 (tensor cores, and the CUDA-core first design) and the split
   packed reads at Dh 96 (and the single kernel, the first design) timed
   beside their bounds, plain versions and
   SDPA, and the MLP leaves and the heads at their forwards' rows (phi-3-
   vision-4.2b's and hubert-xlarge's on the tensor cores beside the tiled
   first design) beside theirs and ``x @ W``;
7c. ssm_hybrid — xlstm-1.3b (raw parameters, its mLSTM projections int8
   leaves: ``linear_mode="int8"``) and zamba2-2.7b (compiled with
   ``zoo_rules``: the shared attention and the head) at full width and
   depth (bf16, random weights from seed 0), each path's counts set to 0
   just before it and read just after: a drip twin check (a 16-token
   prompt dripped, 4 greedy steps; ``SSM_TWIN_TOL``, with the plain bf16
   path's distance from f32 beside it), the 16 requests through the
   captured token drip (xlstm-1.3b one graph, 168 thin-M ``quant_matmul``
   launches a step; zamba2-2.7b a graph a bucket, 36 thin-M
   ``quant_matmul``, 27 + the head's thin-M ``block_sparse_matmul`` and 9
   split packed reads a step, Dh 80) with the bitwise capture check, the 4
   shortest served eagerly with the same tokens, the captured drip step's
   profile, the resident
   state bytes of a slot and the memory peaks; the full-sequence forward
   at B = 1, T = 512 on its kernels against the twin (xlstm-1.3b's last
   16 positions also against its drip, in bf16 and f32); the int8 mLSTM
   leaves, zamba2-2.7b's shared leaves, its packed read (Dh 80) and flash
   call timed beside their bounds, plain versions and library calls;
8. train   — llama3.2-1b at full width (random weights from a seed),
   ``block_aware_prune`` masks on every MLP weight, one step under
   ``dispatch="kernel"`` held against ``"twin"``, then 6 AdamW steps
   through ``TrainRunner`` (global batch 4 x 2048, 2 micro-batches,
   remat): the loss must fall, pruned weights stay exactly zero and the
   flash kernel runs 64 times per step, all on its tensor-core route; step
   ms, tokens/s, peak memory and
   the device idle share of one step (torch.profiler);
8b. train_families — the MoE, SSM and hybrid families trained at full
   width (bf16, f32 AdamW moments, remat; ``TRAIN_FAMILY_PATHS``):
   olmoe-1b-7b (cut to 4 of 16 layers: 8 do not fit beside a functional
   AdamW) and zamba2-2.7b (9 super-blocks) at 4 x 2048 tokens in 4
   micro-batches, xlstm-1.3b (cut to 16 of 48 layers) at 4 x 512 in 2,
   frozen
   ``block_aware_prune`` masks on each 2-D slice of the routed experts,
   the Mamba2 ``wout`` and shared MLP, the mLSTM projections; the twin
   check where a kernel runs (one step under ``dispatch="kernel"`` and one
   under ``"twin"``, ``TRAIN_TWIN_TOL``), then 4 steps through
   ``TrainRunner`` with the counts set to 0 just before and read just
   after: finite, falling losses, pruned weights exactly zero, the flash
   launches exactly 2 a super-block's attention and micro-batch on the
   tensor-core route (olmoe, Dh 128; zamba2, Dh 80), none for xlstm-1.3b
   and no other kernel; step ms, tokens/s, peak
   memory, a one-step profile; the flash forward and its backward's
   recompute at both training shapes (B 1, T 2048) timed.

Prints the kernels line, the card line and, last, the result line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch  # noqa: E402,F401  (fails outside a checkout)
from repro_torch.tree import tree_items, tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor core / fp32
SERVE_RULES = dict(block=(128, 128), block_density=0.25,
                   in_block_density=0.5, min_weight_elems=0, quant_bits=4,
                   policies={"wq": "quant", "wk": "quant", "wv": "quant",
                             "wo": "quant", "wg": "sparse", "wu": "sparse",
                             "wd": "sparse"})
# benchmarks/table1_lenet.py:85-87 and :105-106, with the densities of a
# two-level prune (no masks and no cost model needed)
LENET_BLOCKS = {"fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2), "conv1": (5, 2),
                "conv2": (10, 4)}
LENET_RULES = dict(block=(8, 4), min_weight_elems=0, quant_bits=4,
                   block_density=0.5, in_block_density=0.25)
LENET_BATCH = 256
# LeNet kernel path vs twin: f32 throughout, only the order of summation
# differs, relative to the largest logit
LENET_TOL = 1e-4
# kernel vs plain version on one call, f32: relative to max|ref|
F32_TOL = 1e-5
# kernel path vs plain versions through all 16 bf16 layers, relative to the
# largest logit.  The kernels round like the plain versions but sum in
# another order, so single bf16 steps differ and grow through the layers.
# With the int4 / int4x2 caches (the same codes, one or two a byte) a
# one-step difference in a K/V value can also flip its int4 code, moving that
# element by amax/7, so that bound is looser.
TWIN_TOL = {"float": 2e-2, "int4": 1e-1, "int4x2": 1e-1}


class SmokeError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(make_call, n: int, reps: int = 5) -> float:
    """Mean device time of one call.  ``make_call(i)`` returns the call on
    the i-th of ``n`` copies of its inputs; the n calls are captured in one
    CUDA graph, so replays leave no host time between launches, and copies
    that together exceed the 50 MB L2 make each call read its inputs from
    device memory, as a serving step does."""
    calls = [make_call(i) for i in range(n)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(int(t.numel() * t.element_size()) for t in ts)


# ------------------------------------------------------------- kernel sweep


ACTS = [None, "relu", "silu", "gelu", ("trelu", 0.1)]


def tol_for(dtype, ref) -> float:
    """bf16 outputs may differ by one rounding step of the output (2^-8
    relative); f32 outputs by the f32 sum-order error over K terms."""
    scale = float(ref.abs().max()) + 1e-6
    return (2 ** -7 if dtype == torch.bfloat16 else 1e-4) * scale


# Relative width about trelu's tau, of the largest |pre-activation|, inside
# which the tensor-core routes may put an output on the other side: their
# f32 sums run in another order than the plain version's (wgmma chains,
# the scale at emit), which moves a pre-activation by a few f32 steps of
# the sum, far less than this.
TC_FLIP_BAND = 1e-5


def act_err(y, ref, act, pre=None):
    """Largest |y - ref|.  trelu(tau) is discontinuous at tau: given the plain
    version's f32 pre-activation ``pre`` (tensor-core routes only), an
    output whose pre-activation lies within TC_FLIP_BAND * max|pre| of tau
    may instead be 0 or the pre-activation itself."""
    d = (y.float() - ref.float()).abs()
    if isinstance(act, tuple) and pre is not None:
        near = (pre - act[1]).abs() <= TC_FLIP_BAND * float(pre.abs().max())
        either = torch.minimum(y.float().abs(), (y.float() - pre).abs())
        d = torch.where(near, either, d)
    return float(d.max())


def sparse_case(rng, dev, container, bk, nR, empty=False, nC=3, bn=128):
    """A random (nR x nC)-block pattern of (bk, bn) blocks with an absent
    column block, in one container; returns the kernel's and the plain
    version's arguments."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.sparse_matmul import kernel as K_

    bitmap = rng.random((nR, nC)) < 0.6
    bitmap[:, 1] = False            # an absent output column block
    bitmap[0, 0] = True
    if empty:
        bitmap[:] = False
    rows, cols = np.nonzero(bitmap)
    P = rows.size
    scales, packed = None, False
    if container in ("f32", "bf16"):
        vals = (torch.randn((P, bk, bn), device=dev) / 8).to(
            torch.float32 if container == "f32" else torch.bfloat16)
        blocks = vals
    else:
        qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
        vals = torch.randint(-qm, qm + 1, (P, bk, bn), device=dev).to(torch.int8)
        scales = torch.rand((nC * bn,), device=dev) / (qm * 16)
        blocks = vals
        if container != "int8":
            packed = container
            blocks = pack_codes(vals, axis=1,
                                bits=4 if container == "int4x2" else 2)
    sched = K_.make_schedule(rows, cols, nR, nC, dev)
    return blocks, vals, scales, packed, sched, rows, cols, nC


def sweep_sparse(rng, dev):
    """block_sparse_matmul against its plain version on every route: the
    first design's cases (every container, M in {1, 8, 16, 128}, empty
    patterns, many blocks per column, blocks taller than a staging round),
    the thin-M cases (M in {1, 3, 8, 16}, the three byte containers, K up
    to 8192 with up to 64 blocks per column, an absent column block, bias
    or not, over the activations; the untied heads' 384 and 1187 column
    blocks) and the tensor-core cases (bf16 x, M in
    {17, 40, 128, 512}, the three byte containers, K up to 8192, N in {512,
    2048, 8192}, an absent column block, empty patterns, 64-row and
    256-column blocks, bias or not, over the activations; each bitwise
    equal on a second call), and f32 and bf16 blocks (actsparse, the
    float sparse path) on both: thin-M at M in {1, 8, 16} (f32 and bf16
    x) and the tensor cores at bf16 M in {17, 128, 512}, an absent column
    block, empty patterns and columns cut into ranges; each call must take
    the route the rule names."""
    from repro_torch.kernels.sparse_matmul import kernel as K_
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref

    routes = {"thin_m": "launches_thin", "tensor_core": "launches_tc",
              "tiled": "launches_tiled"}
    # (container, M, bk, nR, empty, activation index, nC, bn, x dtype)
    cases = []
    for ci, container in enumerate(("f32", "bf16", "int8", "int4x2", "int2x4")):
        for mi, M in enumerate((1, 8, 16, 128)):
            for empty in (False, True):
                cases.append((container, M, 128, 4, empty, ci + mi, 3, 128,
                              None))
    # more blocks per column than one staging round holds, and blocks taller
    # than a round, at the row tiles whose rounds are smallest
    for M in (8, 16):
        for container in ("int8", "int4x2"):
            cases += [(container, M, 128, 12, False, M, 3, 128, None),
                      (container, M, 1024, 2, False, M + 1, 3, 128, None)]
    # thin-M: K = 8192 (64 row blocks), K = 1536, K = 256
    for mi, M in enumerate((1, 3, 8, 16)):
        for ci, container in enumerate(("int8", "int4x2", "int2x4")):
            for ki, nR in enumerate((64, 12, 2)):
                cases.append((container, M, 128, nR, False, mi + ci + ki, 3,
                              128, None))
    # thin-M at the untied heads' shapes, with a bias: qwen1.5-4b (K = 2560,
    # N = 151936 = 1187 column blocks) and starcoder2-7b (4608, 49152)
    cases += [("int4x2", 8, 128, 20, False, 0, 1187, 128, torch.bfloat16),
              ("int4x2", 16, 128, 36, False, 0, 384, 128, torch.bfloat16)]
    # tensor cores: (K, N) = (8192, 512), (2048, 2048), (2048, 8192) and a
    # 2-block K, then 64-row blocks, 256-column blocks and empty patterns
    bf16 = torch.bfloat16
    for mi, M in enumerate((17, 40, 128, 512)):
        for ci, container in enumerate(("int8", "int4x2", "int2x4")):
            for ki, (nR, nC) in enumerate(((64, 4), (16, 16), (16, 64),
                                           (2, 4))):
                cases.append((container, M, 128, nR, False, mi + ci + ki, nC,
                              128, bf16))
            cases += [(container, M, 64, 24, False, mi + ci, 8, 128, bf16),
                      (container, M, 128, 8, False, mi + ci + 1, 4, 256,
                       bf16),
                      (container, M, 128, 4, True, mi + ci + 2, 4, 128,
                       bf16)]
    # f32 and bf16 blocks: thin-M rows (K = 8192 cut into ranges, K = 1536,
    # an empty pattern), then the tensor cores (K = 8192 in ranges, a wide
    # N, 64-row and 256-column blocks, an empty pattern)
    for ci, container in enumerate(("f32", "bf16")):
        for mi, M in enumerate((1, 8, 16)):
            for xi, xdt in enumerate((torch.float32, bf16)):
                a = ci + mi + xi
                cases += [(container, M, 128, 64, False, a, 3, 128, xdt),
                          (container, M, 128, 12, False, a + 1, 3, 128, xdt),
                          (container, M, 128, 4, True, a + 2, 3, 128, xdt)]
        for mi, M in enumerate((17, 128, 512)):
            a = ci + mi
            cases += [(container, M, 128, 64, False, a, 4, 128, bf16),
                      (container, M, 128, 16, False, a + 1, 16, 128, bf16),
                      (container, M, 64, 24, False, a + 2, 8, 128, bf16),
                      (container, M, 128, 8, False, a + 3, 4, 256, bf16),
                      (container, M, 128, 4, True, a + 4, 4, 128, bf16)]
    for container, M, bk, nR, empty, ai, nC, bn, xdt in cases:
        act = ACTS[ai % len(ACTS)]
        if xdt is None:
            xdt = torch.float32 if container == "f32" or ai % 2 \
                else torch.bfloat16
        blocks, vals, scales, packed, sched, rows, cols, nC = sparse_case(
            rng, dev, container, bk, nR, empty, nC, bn)
        x = torch.randn((M, nR * bk), device=dev).to(xdt)
        bias = torch.randn((nC * bn,), device=dev) if (ai + M) % 3 else None
        ratio = K_.packed_ratio(packed)
        route, _ = K_.bsm_route(
            M, bk, bn, ratio, nC, sched.max_blocks_per_col, xdt == bf16,
            blocks.data_ptr(), blocks.element_size(), x.data_ptr())
        # every container here is 1-byte codes or f32 / bf16 blocks
        want = "thin_m" if M <= 16 \
            and bk * K_.rows_per_cta(M) <= K_.THIN_XCAP else \
            "tensor_core" if M > 16 and xdt == bf16 \
            and bk % 64 == 0 and bn % 128 == 0 else "tiled"
        require(route == want, f"bsm_route sent {container} M={M} bk={bk} "
                               f"bn={bn} {xdt} to the {route} route, not "
                               f"{want}")

        def call():
            return K_.block_sparse_matmul(x, blocks, sched, scales=scales,
                                          bias=bias, activation=act,
                                          packed=packed)

        y = took_route(K_, routes, route, call)
        ref, pre = (block_sparse_matmul_ref(
            x, vals, rows, cols, n_row_blocks=nR, n_col_blocks=nC,
            scales=scales, bias=bias, activation=a, out_dtype=dt)
            for a, dt in ((act, xdt), (None, torch.float32)))
        torch.cuda.synchronize()
        tol = tol_for(xdt, ref.float())
        err = act_err(y, ref, act, pre if route == "tensor_core" else None)
        label = (f"block_sparse_matmul {route} {container} M={M} bk={bk} "
                 f"bn={bn} nR={nR} nC={nC} empty={empty} act={act} "
                 f"bias={bias is not None}")
        require(err <= tol, f"{label}: max abs err {err}")
        if route == "tensor_core":
            require(torch.equal(y, call()), f"{label}: a second call gave "
                                            f"other bits")
    return len(cases)


def took_route(mod, routes, want, fn):
    """Run ``fn`` and require that it added one launch to the counter
    ``routes[want]`` of ``mod`` and none to the other routes' counters."""
    before = {r: getattr(mod, a) for r, a in routes.items()}
    out = fn()
    moved = {r: getattr(mod, a) - before[r] for r, a in routes.items()}
    require(moved == {r: int(r == want) for r in routes},
            f"expected one launch on the {want} route, counters moved {moved}")
    return out


def sweep_quant(rng, dev):
    """quant_matmul against its plain version on every route: the first
    design's shapes (M in {1, 8, 16, 128}, an odd N that keeps M = 8 on the
    tiled kernel), the thin-M cases (M in {1, 3, 8, 16}, K in {2048, 8192},
    N in {96, 512, 2048}; and qwen1.5-4b's and starcoder2-7b's leaf
    shapes) and the tensor-core cases (bf16 x, M in {17, 40, 128, 512}, K
    in {2048, 8192}, N in {512, 2048, 8192}; ragged last column tiles at N
    in {48, 320, 32064} (phi-3-vision-4.2b's head at its forward's 1088
    rows), one of them cut along K; each bitwise equal on a second call),
    and N % 16 == 8, whose codes no TMA map takes (cp.async: hubert-xlarge's
    504-column head at its forward's 4096 rows, N in {40, 328, 504}, one
    of them cut along K), every container, with and without bias, over the
    activations; each call must take the route ``qmm_route`` names."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    routes = {"thin_m": "launches_thin", "tensor_core": "launches_tc",
              "tiled": "launches_tiled"}
    bf16 = torch.bfloat16
    # (K, N, M, x dtype: None alternates f32 and bf16)
    shapes = [(512, 320, M, None) for M in (1, 8, 16, 128)] + [
        (2560, 96, 8, None), (2560, 96, 16, None), (512, 90, 8, None)]
    shapes += [(K, N, M, None) for M in (1, 3, 8, 16) for K in (2048, 8192)
               for N in (96, 512, 2048)]
    # the leaf shapes of qwen1.5-4b and starcoder2-7b on thin-M
    shapes += [(2560, 2560, 8, None), (6912, 2560, 16, None),
               (4608, 512, 8, None), (18432, 4608, 8, None)]
    shapes += [(K, N, M, bf16) for M in (17, 40, 128, 512)
               for K, N in ((2048, 512), (2048, 2048), (8192, 2048),
                            (2048, 8192))]
    # ragged last column tiles, all but the head's cut along K
    ragged = [(512, 320, 128, bf16), (8192, 320, 64, bf16),
              (1024, 48, 24, bf16), (3072, 32064, 1088, bf16),
              (1280, 504, 4096, bf16)]
    # N % 16 == 8: the codes by cp.async (the head above among them)
    pitch8 = [(2048, 328, 512, bf16), (1024, 40, 24, bf16),
              (8192, 504, 64, bf16)]
    shapes += ragged + pitch8
    split_ragged = split_pitch8 = 0
    cases = 0
    for ci, container in enumerate(("int8", "int4x2", "int2x4")):
        for mi, (K, N, M, xdt) in enumerate(shapes):
            act = ACTS[(ci + mi) % len(ACTS)]
            if xdt is None:
                xdt = bf16 if mi % 2 else torch.float32
            qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
            codes = torch.randint(-qm, qm + 1, (K, N), device=dev).to(torch.int8)
            scales = torch.rand((N,), device=dev) / (qm * 16)
            w, packed, ratio = codes, False, 1
            if container != "int8":
                packed = container
                ratio = 2 if container == "int4x2" else 4
                w = pack_codes(codes, axis=0, bits=8 // ratio)
            x = torch.randn((M, K), device=dev).to(xdt)
            bias = torch.randn((N,), device=dev) if (mi + ci) % 2 == 0 \
                else None
            route, plan = qk.qmm_route(M, K, N, ratio, xdt == bf16,
                                       w.data_ptr(), x.data_ptr())
            want = "thin_m" if M <= 16 and N % 4 == 0 else \
                "tensor_core" if M > 16 and xdt == bf16 and K % 64 == 0 \
                and N % 8 == 0 else "tiled"
            if route == "tensor_core" and N % 128:
                split_ragged += plan.k_splits > 1
                split_pitch8 += plan.k_splits > 1 and N % 16 == 8
            require(route == want, f"qmm_route sent {container} M={M} K={K} "
                                   f"N={N} {xdt} to the {route} route, not "
                                   f"{want}")

            def call():
                return qk.quant_matmul(x, w, scales, bias, activation=act,
                                       packed=packed)

            y = took_route(qk, routes, route, call)
            ref, pre = (quant_matmul_ref(x, codes, scales, bias=bias,
                                         activation=a, out_dtype=dt)
                        for a, dt in ((act, xdt), (None, torch.float32)))
            torch.cuda.synchronize()
            tol = tol_for(xdt, ref.float())
            err = act_err(y, ref, act,
                          pre if route == "tensor_core" else None)
            label = (f"quant_matmul {route} {container} M={M} K={K} N={N} "
                     f"act={act} bias={bias is not None}")
            require(err <= tol, f"{label}: max abs err {err}")
            if route == "tensor_core":
                require(torch.equal(y, call()),
                        f"{label}: a second call gave other bits")
            cases += 1
    require(split_ragged > 0 and split_pitch8 > 0,
            "no ragged (or N % 16 == 8) tensor-core case was cut along K")
    return cases


# Shapes the widened routes take besides the main paths' (those are timed
# in their phases' rows): the quant sweep's ragged column tiles (M, K, N;
# int4x2), hubert-xlarge's 504-column head at its forward's rows (codes by
# cp.async), small flash calls at Dh 80 / 96 (B, T, H, Hkv, Dh, causal) and
# the actsparse leaves of FAMILY_SHAPES (f32 blocks, the fused trelu) at
# decode and forward rows (leaf, M; bf16 x).
RAGGED_QMM = ((128, 512, 320), (64, 8192, 320), (24, 1024, 48),
              (40, 2048, 4112), (4096, 1280, 504))
SMALL_FLASH = ((1, 257, 8, 2, 80, False), (3, 100, 8, 2, 96, True),
               (1, 2048, 8, 2, 96, False))
ACTSPARSE_PAIRS = (("mlp/wg", 8), ("mlp/wd", 8), ("mlp/wg", 512),
                   ("mlp/wd", 512))


def route_pairs(dev):
    """The new routes beside the first designs they replace at
    ``RAGGED_QMM``, ``SMALL_FLASH`` and ``ACTSPARSE_PAIRS``: device ms of
    each (inputs outside L2 for the matmuls), the rule's route first, with
    the bound, the plain version's time and the one-call library time
    (``x @ W``, W dense bf16; SDPA)."""
    import torch.nn.functional as F

    from repro_torch.core import payload_registry
    from repro_torch.core.compile_sparse import CompileRules, compile_conv
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.kernels.sparse_matmul import kernel as sk
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref
    rows = []
    for M, K, N in RAGGED_QMM:
        codes = torch.randint(-7, 8, (K, N), device=dev).to(torch.int8)
        w = pack_codes(codes, axis=0, bits=4)
        x = torch.randn((M, K), device=dev).to(torch.bfloat16)
        s = torch.rand((N,), device=dev) / 100
        route, plan = qk.qmm_route(M, K, N, 2, True, w.data_ptr(),
                                   x.data_ptr())
        ws = copies(w, n_copies(nbytes(w)))
        dense = (codes.float() * s).to(torch.bfloat16)
        ds = copies(dense, n_copies(nbytes(dense), 16))
        b, by = bound(nbytes(x, w, s) + 2 * M * N, 2.0 * M * K * N, "bf16")
        row = {"kernel": "quant_matmul", "shape": f"M={M} K={K} N={N} "
               f"int4x2", "route": route, "plan": list(plan),
               "bound_ms": b, "bound_by": by,
               "plain_ms": device_ms(lambda i: lambda: quant_matmul_ref(
                   x, codes, s, out_dtype=torch.bfloat16), 2),
               "library_ms": device_ms(lambda i: lambda: x @ ds[i], len(ds))}
        for r, p_ in ((route, plan), ("tiled", None)):
            row[f"{r}_ms"] = device_ms(
                lambda i, r=r, p_=p_: lambda: qk._launch(
                    x, ws[i], s, None, None, 2, r, p_), len(ws))
        rows.append(row)
        del codes, dense, ds
    for B, T, H, Hkv, Dh, causal in SMALL_FLASH:
        ins = [[torch.randn(s_, device=dev).to(torch.bfloat16)
                for s_ in ((B, T, H, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh))]
               for _ in range(4)]
        route = fk.flash_route(*ins[0])
        pairs = T * (T + 1) / 2 if causal else T * T
        b, by = bound(nbytes(*ins[0]) + nbytes(ins[0][0]),
                      4.0 * B * H * Dh * pairs, "bf16")
        heads = [[t.permute(0, 2, 1, 3) for t in qkv] for qkv in ins]
        row = {"kernel": "flash_attention", "shape": f"B={B} T={T} H={H} "
               f"Hkv={Hkv} Dh={Dh} {'causal' if causal else 'non-causal'}",
               "route": route, "bound_ms": b, "bound_by": by,
               "plain_ms": device_ms(lambda i: lambda: fk.flash_attention_plain(
                   *ins[i], causal=causal), 2),
               "library_ms": device_ms(
                   lambda i: lambda: F.scaled_dot_product_attention(
                       *heads[i], is_causal=causal, enable_gqa=True), 4)}
        for r in (route, "cuda_core"):
            row[f"{r}_ms"] = device_ms(lambda i, r=r: lambda: fk._launch(
                *ins[i], causal, r), 4)
        rows.append(row)
    rng = np.random.default_rng(27)
    act = ("trelu", FAMILY_TAU)
    for leaf in dict(ACTSPARSE_PAIRS):
        K, N = FAMILY_SHAPES[leaf]
        w = (rng.standard_normal((K, N), dtype=np.float32) / math.sqrt(K))
        p = compile_conv(w.reshape(1, 1, K, N), policy="actsparse",
                         rules=CompileRules(**FAMILY_RULES, quant_bits=8),
                         name=leaf, device=dev)[0].payload
        blocks, pat = p.cl.blocks, p.cl.pattern
        sched = schedule_for(pat, dev)
        dense = payload_registry.family_of_payload(p).payload_dense(p).to(
            torch.bfloat16)
        for leaf_m, M in ACTSPARSE_PAIRS:
            if leaf_m != leaf:
                continue
            x = torch.randn((M, K), device=dev).to(torch.bfloat16)
            ops = family_operands(p, x)
            route, plan = family_route(ops, M, x)
            # trelu: on the tensor cores either side within the band
            pre = block_sparse_matmul_ref(
                x, blocks, pat.block_rows, pat.block_cols,
                n_row_blocks=pat.bitmap.shape[0],
                n_col_blocks=pat.bitmap.shape[1], out_dtype=torch.float32)
            t = time_family(ops, dense, M, act,
                            pre if route == "tensor_core" else None)
            require(t["max_abs_err"] <= t["tol"],
                    f"route_pairs actsparse {leaf} M={M} {route}: max abs "
                    f"err {t['max_abs_err']}")
            bs = copies(blocks, n_copies(nbytes(blocks)))
            row = {"kernel": "block_sparse_matmul", "shape": f"actsparse "
                   f"{leaf} M={M} K={K} N={N} f32 blocks "
                   f"{pat.n_blocks_present}/{pat.n_blocks_total} of "
                   f"{pat.block}", "route": route,
                   "plan": None if plan is None else list(plan),
                   f"{route}_ms": t["ms"], **{k: t[k] for k in (
                       "bound_ms", "bound_by", "library_ms", "plain_ms",
                       "max_abs_err", "tol")},
                   "tiled_ms": device_ms(lambda i: lambda: sk._launch(
                       x, bs[i], sched, None, None, act, 1, "tiled"),
                       len(bs))}
            if route == "tensor_core":  # the rule's alternative m tile
                alt = sk.bsm_tc_plan(M, *pat.block, pat.bitmap.shape[1],
                                     sched.max_blocks_per_col,
                                     m_tile=192 - plan.m_tile)
                row["other_m_tile"] = {"plan": list(alt), "ms": device_ms(
                    lambda i: lambda: sk._launch(
                        x, bs[i], sched, None, None, act, 1, "tensor_core",
                        alt), len(bs))}
            rows.append(row)
        del p, blocks, dense
        torch.cuda.empty_cache()
    return rows


def tc_sum_error(dev):
    """The tensor-core routes' f32 sums against the plain version's f32
    pre-activation, as a share of its largest magnitude: both kernels, the
    three containers, K = 8192 and M = 512, read from the f32 partials of a
    plan cut in two (K splits; ranges of each column's blocks), added as the
    reduce pass adds them; then block_sparse_matmul's f32 blocks (each
    weight three bf16 terms) and bf16 blocks the same way.  Must stay
    within half of TC_FLIP_BAND."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.kernels.sparse_matmul import kernel as K_
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref

    M, K, N = 512, 8192, 2048
    worst = {}
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(16)
        rng = np.random.default_rng(16)
        for container, qm, ratio in (("int8", 127, 1), ("int4x2", 7, 2),
                                     ("int2x4", 1, 4)):
            x = torch.randn((M, K), device=dev).to(torch.bfloat16)
            codes = torch.randint(-qm, qm + 1, (K, N), device=dev).to(
                torch.int8)
            s = torch.rand((N,), device=dev) / (qm * 16)
            w = codes if ratio == 1 else pack_codes(codes, axis=0,
                                                    bits=8 // ratio)
            ws = torch.zeros((2, M, N), device=dev)
            qk._launch(x, w, s, None, None, ratio, "tensor_core",
                       qk.QmmTcPlan(64, 128, 2, K // 128), ws=ws)
            pre = quant_matmul_ref(x, codes, s)
            got = (ws[0] + ws[1]) * s
            worst[f"quant_matmul {container}"] = float(
                (got - pre).abs().max()) / float(pre.abs().max())

            blocks, vals, scales, packed, sched, rows, cols, nC = \
                sparse_case(rng, dev, container, 128, K // 128, nC=16)
            per = -(-sched.max_blocks_per_col // 2)
            ranges = -(-sched.max_blocks_per_col // per)
            ws = torch.zeros((ranges, M, nC * 128), device=dev)
            K_._launch(x, blocks, sched, scales, None, None, ratio,
                       "tensor_core", K_.BsmTcPlan(64, 128, per, ranges),
                       ws=ws)
            pre = block_sparse_matmul_ref(
                x, vals, rows, cols, n_row_blocks=K // 128, n_col_blocks=nC,
                scales=scales)
            got = ws[0]
            for r in range(1, ranges):
                got = got + ws[r]
            worst[f"block_sparse_matmul {container}"] = float(
                (got - pre).abs().max()) / float(pre.abs().max())
        for container in ("f32", "bf16"):
            x = torch.randn((M, K), device=dev).to(torch.bfloat16)
            blocks, vals, _, _, sched, rows, cols, nC = sparse_case(
                rng, dev, container, 128, K // 128, nC=16)
            per = -(-sched.max_blocks_per_col // 2)
            ranges = -(-sched.max_blocks_per_col // per)
            ws = torch.zeros((ranges, M, nC * 128), device=dev)
            K_._launch(x, blocks, sched, None, None, None, 1, "tensor_core",
                       K_.BsmTcPlan(64, 128, per, ranges), ws=ws)
            pre = block_sparse_matmul_ref(x, vals, rows, cols,
                                          n_row_blocks=K // 128,
                                          n_col_blocks=nC)
            got = ws[0]
            for r in range(1, ranges):
                got = got + ws[r]
            worst[f"block_sparse_matmul {container}"] = float(
                (got - pre).abs().max()) / float(pre.abs().max())
    torch.cuda.synchronize()
    for what, err in worst.items():
        require(err <= TC_FLIP_BAND / 2,
                f"{what}: tensor-core f32 sums {err} of max|pre| from the "
                f"plain version")
    return worst


def random_cache(B, T, Hkv, Dh, dev):
    """int4x2 codes and scales of a random cache, then the same codes as
    int8 (the int4 container)."""
    from repro_torch.core.quant import pack_int4
    codes_k = torch.randint(-7, 8, (B, T, Hkv, Dh), device=dev).to(torch.int8)
    codes_v = torch.randint(-7, 8, (B, T, Hkv, Dh), device=dev).to(torch.int8)
    k_s = torch.rand((B, T, Hkv), device=dev) / 7
    v_s = torch.rand((B, T, Hkv), device=dev) / 7
    return (pack_int4(codes_k, axis=-1), pack_int4(codes_v, axis=-1), k_s, v_s,
            codes_k, codes_v)


def at_offset(t, off):
    """A dense copy of the 1-byte tensor ``t`` whose data starts ``off``
    bytes past an allocation's (aligned) start."""
    if not off:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def sweep_attention(rng, dev):
    """packed_decode_attention against its plain version on both routes:
    C in {1, 16}, G in {1, 4}, Dh in {64, 80, 96, 128}, bt 64 (and 16, 32,
    128: several tiles per split, or several splits a tile), slots whose
    rows are all dead (length 0), start at length 1, end mid-tile and reach
    the extent; C·G = 128 and starcoder2-7b's 144 (G 9, Dh 128) in row
    groups on the split kernel; f32 and bf16 q.  The single kernel keeps a
    case for each reason a shape stays there: a Dh (48) or a bt (Dh 128 at
    128, Dh 80 at 32) with no split build, and codes that lack the build's
    alignment (Dh 64 at 8 bytes, Dh 80 int4x2 at 4; Dh 80's 40-byte int4x2
    rows at 8 bytes take the split kernel's 8-byte copies).  Each call must
    take the route ``pda_plan`` names -- split for every built (Dh, bt)
    whose codes have ``split_code_align`` -- give the same bits on a second
    call, and the same bits at the full extent and at a bounded one
    (lengths <= 128).  Every case runs again over the same codes as int8
    (the int4 container, ``packed=False``, at the offset given): the same
    route, and the same bits as the int4x2 call.  Tolerance: ``flash_tol``
    (one bf16 step, or 1e-5 of the largest value in f32; the split route
    reorders the online softmax's rescaling)."""
    from repro_torch.kernels.flash_attention import decode_packed as dp

    routes = {"split": "launches_split", "single": "launches_single"}
    B, T, Hkv = 4, 200, 2
    # (C, G, Dh, bt, byte offset of the int4x2 codes, of the int8 codes)
    shapes = [(C, G, Dh, 64, 0, 0) for C in (1, 16) for G in (1, 4)
              for Dh in (64, 80, 96, 128)]
    shapes += [(1, 4, 64, 16, 0, 0), (16, 4, 128, 16, 0, 0),
               (4, 2, 64, 32, 0, 0), (16, 8, 64, 64, 0, 0),
               (1, 4, 80, 128, 0, 0), (16, 1, 96, 32, 0, 0),
               (16, 4, 96, 128, 0, 0)]
    # starcoder2-7b's GQA (G = 9, Dh 128): a decode read and a 16-row
    # prefill chunk (144 query rows a kv head: three groups of 48)
    shapes += [(1, 9, 128, 64, 0, 0), (16, 9, 128, 64, 0, 0)]
    # the single kernel: no split build, then codes the build cannot copy
    shapes += [(16, 4, 48, 64, 0, 0), (1, 4, 128, 128, 0, 0),
               (16, 1, 80, 32, 0, 0), (1, 4, 64, 64, 8, 8),
               (16, 1, 80, 64, 4, 4)]
    # Dh 80 int4x2 codes 8-byte aligned: split by 8-byte copies (the int8
    # codes, 80-byte rows, aligned to 16)
    shapes += [(16, 4, 80, 64, 8, 0)]
    cases = 0
    for C, G, Dh, bt, off4, off8 in shapes:
        H = Hkv * G
        k_p, v_p, k_s, v_s, k_q, v_q = random_cache(B, T, Hkv, Dh, dev)
        k_p, v_p = at_offset(k_p, off4), at_offset(v_p, off4)
        k_q, v_q = at_offset(k_q, off8), at_offset(v_q, off8)
        base = np.array([0, 0, 69, T - C])
        lens = base[:, None] + np.arange(1, C + 1)[None, :]
        lens[0] = 0                       # a slot with every tile dead
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        plan = dp.pda_plan(B, C, H, Hkv, Dh, T, bt, k_p.data_ptr()
                           | v_p.data_ptr() | int(k_p.stride(0)))
        route = "single" if plan is None else "split"
        want = "split" if (Dh, bt) in dp.SPLIT_SHAPES \
            and off4 % dp.split_code_align(Dh) == 0 else "single"
        require(route == want, f"pda_plan sent C={C} G={G} Dh={Dh} bt={bt} "
                               f"codes at +{off4} to the {route} route, not "
                               f"{want}")
        require(plan is None or plan.n_groups
                == -(-C * G // dp.SPLIT_MAX_QROWS),
                f"pda_plan cut C·G = {C * G} rows into {plan}")
        plan8 = dp.pda_plan(B, C, H, Hkv, Dh, T, bt, k_q.data_ptr()
                            | v_q.data_ptr() | int(k_q.stride(0)),
                            packed=False)
        require(plan8 == plan, f"pda_plan gave int8 codes {plan8}, int4x2 "
                               f"codes {plan}, at C={C} G={G} Dh={Dh} bt={bt}")
        for qdt in (torch.float32, torch.bfloat16):
            q = torch.randn((B, C, H, Dh), device=dev).to(qdt)

            def call(ln, tb=T):
                ext = [a[:, :tb] for a in (k_p, v_p, k_s, v_s)]
                return took_route(dp, routes, route,
                                  lambda: dp.packed_decode_attention(
                                      q, *ext, ln, bt=bt))

            tag = f"packed_decode_attention {route} C={C} G={G} Dh={Dh} " \
                  f"bt={bt} +{off4} {qdt}"
            y = call(lengths)
            ref = dp.tiled_packed_attention(q, k_p, v_p, k_s, v_s, lengths,
                                            bt=bt)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            require(err <= flash_tol(qdt, ref),
                    f"{tag}: max abs err {err}")
            require(torch.equal(y, call(lengths)),
                    f"{tag}: two calls gave different bits")
            ln = torch.clamp(lengths, max=128)
            yb = call(ln, 128)
            require(torch.equal(call(ln), yb),
                    f"{tag}: the full and the bounded extent gave different "
                    f"bits")
            ref = dp.tiled_packed_attention(
                q, *(a[:, :128] for a in (k_p, v_p, k_s, v_s)), ln, bt=bt)
            torch.cuda.synchronize()
            err = float((yb.float() - ref.float()).abs().max())
            require(err <= flash_tol(qdt, ref),
                    f"{tag} extent 128: max abs err {err}")
            y8 = took_route(dp, routes, route,
                            lambda: dp.packed_decode_attention(
                                q, k_q, v_q, k_s, v_s, lengths, bt=bt,
                                packed=False))
            ref8 = dp.tiled_packed_attention(q, k_q, v_q, k_s, v_s, lengths,
                                             bt=bt, packed=False)
            torch.cuda.synchronize()
            err = float((y8.float() - ref8.float()).abs().max())
            require(err <= flash_tol(qdt, ref8),
                    f"{tag} int8 codes: max abs err {err}")
            require(torch.equal(y8, y),
                    f"{tag}: int8 and int4x2 codes gave different bits")
            cases += 2
    return cases


def sweep_flash(rng, dev, report):
    """The flash kernels against their plain version.  The CUDA-core cases:
    causal and not, G in {1, 4}, Dh in {16, 64, 128} (and 40, 256), ragged
    T, Tq != Tk, B in {1, 3}, bf16 and f32, q read through a strided view,
    and bf16 Dh 64 with rows that are not 16-byte multiples; f32 Dh 80 and
    96, and bf16 Dh 96 with such rows.  The tensor-core cases: bf16, Dh 64,
    80, 96 and 128, causal and not, G in {1, 2, 4}, Tq / Tk ragged and
    unequal up to 2048, B in {1, 3}, q strided.  The query offsets of a
    sequence-sharded rank (``OFFSET_FLASH``): causal and not, G in {1, 4},
    f32 Dh 64 and 80 (CUDA cores), bf16 Dh 64, 80, 96 and 128 (tensor
    cores), against ``flash_attention_plain(q_offset=...)``.  Each
    call must take the route ``flash_route`` names.  Then the op's gradient
    against autograd through ``chunked_attention``, at offset 0 and, on
    each route, at an offset.  The host seconds of the offset cases go to
    ``report["flash_q_offset_sweep_s"]``."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.layers import chunked_attention

    routes = {"tensor_core": "launches_tc", "cuda_core": "launches_cc"}
    shapes = [(causal, G, Dh, Tq, Tq, 0) for causal in (True, False)
              for G in (1, 4) for Dh in (16, 64, 128) for Tq in (100, 257)]
    shapes += [(False, 4, 64, 100, 257, 0), (False, 1, 16, 257, 33, 0),
               (True, 4, 64, 257, 100, 0), (True, 2, 40, 130, 130, 0),
               (True, 1, 256, 70, 70, 0), (True, 2, 64, 100, 100, 1),
               (False, 1, 64, 257, 100, 1), (True, 2, 80, 130, 130, 0),
               (False, 4, 96, 257, 100, 0), (True, 1, 96, 100, 100, 1)]
    both = (torch.float32, torch.bfloat16)
    runs = [(s_, both, 0) for s_ in shapes] + [
        ((causal, G, Dh, Tq, Tk, 0), (torch.bfloat16,), 0)
        for causal in (True, False) for Dh in fk.TC_DH for G in (1, 2, 4)
        for Tq, Tk in ((100, 100), (257, 257), (2048, 1000), (257, 2048))]
    first_offset = len(runs)
    runs += [((causal, G, Dh, Tq, off + Tq + extra, 0), (dt,), off)
             for causal in (True, False) for G in (1, 4)
             for dt, Dh in OFFSET_FLASH_DH for off, Tq, extra in OFFSET_FLASH]
    cases, offset_s = 0, 0.0
    for i, (shape, dts, off) in enumerate(runs):
        t0 = time.perf_counter()
        causal, G, Dh, Tq, Tk, pad = shape
        B, Hkv = (1, 3)[i % 2], 2
        for dt in dts:
            # pad > 0: rows of Dh + 1 elements, not whole 16-byte copies
            base = torch.randn((B, Tq, 2 * Hkv * G, Dh + pad),
                               device=dev).to(dt)
            q = base[:, :, Hkv * G:, :Dh]       # strided over heads
            k = torch.randn((B, Tk, Hkv, Dh), device=dev).to(dt)
            v = torch.randn((B, Tk, Hkv, Dh), device=dev).to(dt)
            route = fk.flash_route(q, k, v)
            want = "tensor_core" if dt == torch.bfloat16 \
                and Dh in (64, 80, 96, 128) and not pad else "cuda_core"
            require(route == want, f"flash_route sent {shape} {dt} to the "
                                   f"{route} route, not {want}")
            y = took_route(fk, routes, route, lambda: fk.flash_attention_fwd(
                q, k, v, causal=causal, q_offset=off))
            ref = fk.flash_attention_plain(q, k, v, causal=causal,
                                           q_offset=off)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            require(err <= flash_tol(dt, ref),
                    f"flash_attention {route} causal={causal} G={G} Dh={Dh} "
                    f"Tq={Tq} Tk={Tk} q_offset={off} B={B} {dt}: max abs "
                    f"err {err}")
            cases += 1
        if i >= first_offset:
            offset_s += time.perf_counter() - t0
    # the op's gradient: its backward is autograd through chunked_attention
    # (at the rows' offset); (dtype, Dh, Tq, Tk, q_offset, route)
    for dt, Dh, Tq, Tk, off, want in (
            (torch.bfloat16, 64, 300, 300, 0, "tensor_core"),
            (torch.bfloat16, 64, 300, 400, 100, "tensor_core"),
            (torch.float32, 80, 100, 1164, 1000, "cuda_core")):
        t0 = time.perf_counter()
        q = torch.randn((2, Tq, 8, Dh), device=dev).to(dt)
        k, v = (torch.randn((2, Tk, 2, Dh), device=dev).to(dt)
                for _ in range(2))
        g = torch.randn((2, Tq, 8, Dh), device=dev).to(dt)
        grads = []
        for fn in (lambda a, b, c: took_route(
                       fk, routes, want,
                       lambda: flash_attention(a, b, c, True, off)),
                   lambda a, b, c: chunked_attention(a, b, c, causal=True,
                                                     q_offset=off)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fn(*leaves).backward(g)
            grads.append([t.grad.float() for t in leaves])
        for name, a, b in zip("qkv", *grads):
            err = float((a - b).abs().max())
            require(err <= flash_tol(dt, b),
                    f"flash_attention gradient d{name} ({want}, q_offset "
                    f"{off}): max abs err {err}")
        cases += 1
        if off:
            offset_s += time.perf_counter() - t0
    report["flash_q_offset_sweep_s"] = offset_s
    return cases


# A sequence-sharded rank's flash calls (``core/sharded.py`` ``attn_full``):
# (q_offset, Tq, keys past q_offset + Tq), offsets neither multiples of 64
# nor of the 128-row q tile among them, on each route's head dims
OFFSET_FLASH = ((0, 24, 40), (64, 100, 0), (100, 257, 37), (1000, 512, 0),
                (1000, 24, 117))
OFFSET_FLASH_DH = ((torch.float32, 64), (torch.float32, 80),
                   (torch.bfloat16, 64), (torch.bfloat16, 80),
                   (torch.bfloat16, 96), (torch.bfloat16, 128))


def flash_tol(dtype, ref) -> float:
    """bf16: one output rounding step (2^-7 of the largest value); f32: the
    sum-order error of an f32 online softmax (``F32_TOL`` of the largest)."""
    scale = float(ref.float().abs().max()) + 1e-6
    return (2 ** -7 if dtype == torch.bfloat16 else F32_TOL) * scale


# Conv sweep geometries: (name, (H, W, cin), (kh, kw), strides, dilation,
# block, N).  The first two are LeNet's conv1 and conv2; the others add
# strides, dilation and a bk that divides by 4 (int2x4).
CONV_GEOMS = [
    ("conv1", (28, 28, 1), (5, 5), (1, 1), (1, 1), (5, 2), 6),
    ("conv2", (12, 12, 6), (5, 5), (1, 1), (1, 1), (10, 4), 16),
    ("strided", (11, 11, 4), (3, 3), (2, 2), (1, 1), (12, 4), 8),
    ("dilated", (13, 13, 4), (3, 3), (1, 1), (2, 2), (12, 4), 8),
]
POOLS = [("avg", 2), None, ("max", 2)]


def conv_pool(pool, Ho, Wo):
    """The sweep's pool where its window tiles the output, else a 3x3 max
    pool where that tiles, else none."""
    for p in (pool, ("max", 3)):
        if p is not None and Ho % p[1] == 0 and Wo % p[1] == 0:
            return p
    return None


def f32_check(name, y, ref):
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    scale = float(ref.abs().max())
    require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    require(err <= F32_TOL * scale + 1e-30,
            f"{name}: max abs err {err} > {F32_TOL} x max|ref| {scale}")
    return err


def conv_check(name, y, ref):
    """f32 outputs within ``F32_TOL`` of max|ref|; bf16 outputs (bf16 x,
    f32 inside, one rounding at the store) within one bf16 step."""
    if y.dtype != torch.bfloat16:
        return f32_check(name, y, ref)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    require(err <= tol_for(y.dtype, ref.float()),
            f"{name}: max abs err {err} > one bf16 step of max|ref|")
    return err


CONV_ROUTES = {"reg_tile": "conv_launches_reg", "band": "conv_launches_band"}
# the sweeps' (batch, x dtype) cases: f32 at three batches, then bf16
CONV_BATCHES = [(1, torch.float32), (7, torch.float32),
                (256, torch.float32), (7, torch.bfloat16)]


def conv_sweep_call(mod, route, fn, band):
    """Run a conv wrapper call ``fn`` and require it to take ``route`` (one
    launch on that route's counter, none on the other's); then launch the
    band route through ``band`` (the wrapper's ``_conv_launch`` with
    route "band", uncounted).  Returns both outputs, the band one None when
    the rule already chose band."""
    y = took_route(mod, CONV_ROUTES, route, fn)
    return y, (band() if route == "reg_tile" else None)


def sweep_sparse_conv(rng, dev):
    """block_sparse_conv against its plain version over CONV_GEOMS (LeNet's
    conv1 and conv2, strides, dilation), every container, B in {1, 7, 256}
    in f32 and B = 7 in bf16: each call must take the route ``conv_route``
    names, and each call on the register-tiled route is repeated on the
    band route (the first design), so both stay held at LeNet's shapes."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.sparse_matmul import kernel as K_
    from repro_torch.kernels.sparse_matmul.kernel import valid_out_hw
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_conv_ref

    cases = {"reg_tile": 0, "band": 0}
    for gi, (gname, (H, W, C), khw, st, dl, (bk, bn), N) in \
            enumerate(CONV_GEOMS):
        K = C * khw[0] * khw[1]
        nR, nC = K // bk, N // bn
        Ho, Wo = valid_out_hw(H, W, khw, st, dl)
        containers = [c for c in ("f32", "int8", "int4x2", "int2x4")
                      if c in ("f32", "int8") or bk % (2 if c == "int4x2"
                                                       else 4) == 0]
        for ci, container in enumerate(containers):
            for bi, (B, xdt) in enumerate(CONV_BATCHES):
                empty = gi == 1 and ci == 1 and bi == 0
                bitmap = rng.random((nR, nC)) < 0.5
                bitmap[:, nC // 2] = False      # an absent column block
                bitmap[0, 0] = True
                if empty:
                    bitmap[:] = False
                rows, cols = np.nonzero(bitmap)
                P = rows.size
                scales, packed = None, False
                if container == "f32":
                    vals = torch.randn((P, bk, bn), device=dev) / 4
                    blocks = vals
                else:
                    qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
                    vals = torch.randint(-qm, qm + 1, (P, bk, bn),
                                         device=dev).to(torch.int8)
                    scales = torch.rand((N,), device=dev) / (qm * 4)
                    blocks = vals
                    if container != "int8":
                        packed = container
                        blocks = pack_codes(vals, axis=1, bits=4 if
                                            container == "int4x2" else 2)
                sched = K_.make_schedule(rows, cols, nR, nC, dev)
                x = torch.randn((B, H, W, C), device=dev).to(xdt)
                bias = torch.randn((N,), device=dev) if (ci + bi) % 2 \
                    else None
                act = "relu" if bi % 2 == 0 else None
                pool = conv_pool(POOLS[(ci + bi) % 3], Ho, Wo)
                kw = dict(kernel_hw=khw, strides=st, dilation=dl,
                          activation=act, pool=pool)
                ref = block_sparse_conv_ref(
                    x, vals, rows, cols, n_row_blocks=nR, n_col_blocks=nC,
                    scales=scales, bias=bias, out_dtype=xdt, **kw)
                label = (f"block_sparse_conv {gname} {container} B={B} "
                         f"{xdt} pool={pool} empty={empty}")
                if empty:   # nothing to launch: act(b) everywhere
                    y = K_.block_sparse_conv(x, blocks, sched, scales=scales,
                                             bias=bias, packed=packed, **kw)
                    conv_check(label, y, ref)
                    continue
                route, _ = K_.conv_route(
                    B, H, W, C, khw, st, dl, pool, N, xdt, block=(bk, bn),
                    max_blocks_per_col=sched.max_blocks_per_col)
                y, yb = conv_sweep_call(
                    K_, route,
                    lambda: K_.block_sparse_conv(
                        x, blocks, sched, scales=scales, bias=bias,
                        packed=packed, **kw),
                    lambda: K_._conv_launch(
                        x, blocks, sched, khw, scales, bias, act, st, dl,
                        pool, K_.packed_ratio(packed), "band"))
                conv_check(f"{label} {route}", y, ref)
                cases[route] += 1
                if yb is not None:
                    conv_check(f"{label} band", yb, ref)
                    cases["band"] += 1
    return cases


def sweep_quant_conv(rng, dev):
    """quant_conv against its plain version over CONV_GEOMS, every
    container, the batches of CONV_BATCHES; routes as in
    :func:`sweep_sparse_conv`."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.ref import quant_conv_ref
    from repro_torch.kernels.sparse_matmul.kernel import (conv_route,
                                                          packed_ratio,
                                                          valid_out_hw)

    cases = {"reg_tile": 0, "band": 0}
    for gname, (H, W, C), khw, st, dl, _, N in CONV_GEOMS:
        K = C * khw[0] * khw[1]
        Ho, Wo = valid_out_hw(H, W, khw, st, dl)
        containers = [c for c in ("int8", "int4x2", "int2x4")
                      if c == "int8" or K % (2 if c == "int4x2" else 4) == 0]
        for ci, container in enumerate(containers):
            for bi, (B, xdt) in enumerate(CONV_BATCHES):
                qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
                codes = torch.randint(-qm, qm + 1, (K, N),
                                      device=dev).to(torch.int8)
                scales = torch.rand((N,), device=dev) / (qm * 4)
                w, packed = codes, False
                if container != "int8":
                    packed = container
                    w = pack_codes(codes, axis=0,
                                   bits=4 if container == "int4x2" else 2)
                x = torch.randn((B, H, W, C), device=dev).to(xdt)
                bias = torch.randn((N,), device=dev) if (ci + bi) % 2 \
                    else None
                act = "relu" if bi % 2 == 0 else None
                pool = conv_pool(POOLS[(ci + bi) % 3], Ho, Wo)
                kw = dict(kernel_hw=khw, strides=st, dilation=dl,
                          activation=act, pool=pool)
                route, _ = conv_route(B, H, W, C, khw, st, dl, pool, N, xdt)
                y, yb = conv_sweep_call(
                    qk, route,
                    lambda: qk.quant_conv(x, w, scales, bias, packed=packed,
                                          **kw),
                    lambda: qk._conv_launch(
                        x, w, scales, bias, khw, act, st, dl, pool,
                        packed_ratio(packed), "band"))
                ref = quant_conv_ref(x, codes, scales, bias, out_dtype=xdt,
                                     **kw)
                label = f"quant_conv {gname} {container} B={B} {xdt} " \
                        f"pool={pool}"
                conv_check(f"{label} {route}", y, ref)
                cases[route] += 1
                if yb is not None:
                    conv_check(f"{label} band", yb, ref)
                    cases["band"] += 1
    return cases


FCS_ROUTES = {"staged": "launches_staged", "stream": "launches_stream"}
# the fc-stack sweep's stacks: LeNet's, three activations with K and N off
# multiples of 4, one wide layer, a 6-column last layer (a part group), a
# stack whose staged plan needs every byte of a CTA's 227 KB of shared
# memory, and one too wide for it (stream)
FCS_STACKS = [((256, 120, 84, 10), ["relu", "relu", None]),
              ((300, 64, 33, 7), ["silu", ("trelu", 0.1), "gelu"]),
              ((40, 500), [None]),
              ((64, 36, 6), ["gelu", None]),
              ((116, 432), ["relu"]),
              ((384, 384), ["relu"])]
# (batch, x dtype): 7 and 250 rows are not multiples of a row tile
FCS_BATCHES = [(1, torch.float32), (7, torch.float32), (64, torch.float32),
               (250, torch.float32), (256, torch.float32),
               (7, torch.bfloat16), (256, torch.bfloat16)]


def sweep_fc_stack(rng, dev):
    """fc_stack_matmul against its plain version over FCS_STACKS and
    FCS_BATCHES: each call must take the route ``fcs_route`` names, and
    each call on the staged route is repeated on the stream route (the
    first design), uncounted."""
    from repro_torch.kernels import fc_stack as fk

    cases = {"staged": 0, "stream": 0}
    for si, (dims, acts) in enumerate(FCS_STACKS):
        ws = [torch.randn((k, n), device=dev) / math.sqrt(k)
              for k, n in zip(dims, dims[1:])]
        for bi, (B, xdt) in enumerate(FCS_BATCHES):
            bs = [torch.randn((n,), device=dev) if (si + bi + i) % 2 else None
                  for i, n in enumerate(dims[1:])]
            x = torch.randn((B, dims[0]), device=dev).to(xdt)
            route, _ = fk.fcs_route(B, dims, xdt)
            y = took_route(fk, FCS_ROUTES, route,
                           lambda: fk.fc_stack_matmul(x, ws, bs, acts))
            ref = fk.fc_stack_matmul_ref(x, ws, bs, acts)
            label = f"fc_stack_matmul dims={dims} B={B} {xdt}"
            conv_check(f"{label} {route}", y, ref)
            cases[route] += 1
            if route == "staged":
                conv_check(f"{label} stream",
                           fk._launch(x, ws, bs, acts, "stream"), ref)
                cases["stream"] += 1
    return cases


# --------------------------------------------------- main-path measurements


def measure_kernels(cm, cfg, dev, counts):
    """Time each kernel, its plain version and a one-call PyTorch yardstick
    at the serving path's decode shapes, on the compiled model's own
    layer-0 leaves, and hold the kernel against the plain version there."""
    import torch.nn.functional as F

    from repro_torch.core.quant import unpack_codes
    from repro_torch.core.sparsity import CompressedLinear, decompress
    from repro_torch.kernels.flash_attention import decode_packed as dp
    from repro_torch.kernels.flash_attention.decode_packed import (
        packed_decode_attention, tiled_packed_attention)
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.kernels.sparse_matmul import kernel as sk
    from repro_torch.kernels.sparse_matmul.kernel import block_sparse_matmul
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref

    M, D, F_ = 8, cfg.d_model, cfg.d_ff
    out = []
    x = torch.randn((M, D), device=dev).to(torch.bfloat16)

    def timing(name, y, ref, nbytes_, ops, shape, run_k, run_p, run_lib,
               sizes):
        err = float((y.float() - ref.float()).abs().max())
        tol = tol_for(y.dtype, ref.float())
        require(err <= tol, f"{name} at {shape}: max abs err {err}")
        b, f = bound(nbytes_, ops, "bf16")
        return {"max_abs_err": err, "tol": tol,
                "ms": device_ms(run_k, sizes[0]),
                "plain_ms": device_ms(run_p, sizes[1]),
                "bound_ms": b, "bound_by": f,
                "library_ms": device_ms(run_lib, sizes[2]), "shape": shape}

    def entry(name, source, replaces, *args):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                **timing(name, *args)}

    # block-sparse: mlp/wg of layer 0, int4x2 blocks (thin-M route); then
    # mlp/wd (K = 8192, N = 2048) and the compiled forward's M = 512 (tiled)
    def bsm_case(leaf_name, xs, n_copies):
        leaf = cm.params["blocks"]["mlp"][leaf_name]
        Kl = int(xs.shape[1])
        pat = cm.patterns[(Kl, leaf["w_s"].shape[-1])]
        wp, ws = leaf["w_blkp"][0].contiguous(), leaf["w_s"][0].contiguous()
        sched = schedule_for(pat, dev)
        bk, bn = pat.block
        nR, nC = pat.bitmap.shape
        Ms = int(xs.shape[0])
        vals = unpack_codes(wp, bk, axis=1, bits=4)
        rows = torch.as_tensor(pat.block_rows, device=dev)
        cols = torch.as_tensor(pat.block_cols, device=dev)
        dense = decompress(CompressedLinear(pattern=pat, blocks=vals,
                                            scales=ws)).to(torch.bfloat16)
        wps, valss, denses = (copies(t, n) for t, n in zip(
            (wp, vals, dense), n_copies))
        route, plan = sk.bsm_route(
            Ms, bk, bn, 2, nC, sched.max_blocks_per_col,
            xs.dtype == torch.bfloat16, wp.data_ptr(), 1, xs.data_ptr())
        detail = ""
        if route == "thin_m":
            detail = (f" ({plan.blocks_per_range} blocks per range, "
                      f"{nC * plan.ranges_per_col} CTAs)")
        elif route == "tensor_core":
            ctas = -(-Ms // plan.m_tile) * nC * plan.ranges_per_col
            detail = (f" ({plan.m_tile}-row tiles, {plan.blocks_per_range} "
                      f"blocks per range, {ctas} CTAs)")
        y = block_sparse_matmul(xs, wp, sched, scales=ws, packed="int4x2")
        ref = block_sparse_matmul_ref(xs, vals, rows, cols, n_row_blocks=nR,
                                      n_col_blocks=nC, scales=ws,
                                      out_dtype=xs.dtype)
        t = timing(
            "block_sparse_matmul", y, ref,
            nbytes(xs, wp, ws, y, sched.col_ptr, sched.rows, sched.pidx),
            2.0 * Ms * pat.n_blocks_present * bk * bn,
            f"{leaf_name}: M={Ms} K={Kl} N={nC * bn} int4x2 blocks "
            f"{pat.n_blocks_present}/{pat.n_blocks_total} of {pat.block}, "
            f"{route} route{detail}",
            lambda i: lambda: block_sparse_matmul(xs, wps[i], sched,
                                                  scales=ws, packed="int4x2"),
            lambda i: lambda: block_sparse_matmul_ref(
                xs, valss[i], rows, cols, n_row_blocks=nR, n_col_blocks=nC,
                scales=ws, out_dtype=xs.dtype),
            lambda i: lambda: xs @ denses[i], n_copies)
        if route != "tiled":
            # the first design (tiled kernel) at the same shape, this run
            t["first_version_ms"] = device_ms(lambda i: lambda: sk._launch(
                xs, wps[i], sched, ws, None, None, 2, "tiled"), n_copies[0])
        if route == "tensor_core":
            # the plan with the other m tile, the rule's alternative
            alt = sk.bsm_tc_plan(Ms, bk, bn, nC, sched.max_blocks_per_col,
                                 m_tile=192 - plan.m_tile)
            t["other_m_tile"] = {"plan": list(alt), "ms": device_ms(
                lambda i: lambda: sk._launch(xs, wps[i], sched, ws, None,
                                             None, 2, "tensor_core", alt),
                n_copies[0])}
        return t

    def bf16_rows(m, k):
        return torch.randn((m, k), device=dev).to(torch.bfloat16)

    wg_t = bsm_case("wg", x, (16, 8, 2))
    # then the compiled forward's M = 512 (tensor-core route) and M = 128
    wg_t["also"] = [bsm_case("wd", bf16_rows(M, F_), (32, 8, 2)),
                    bsm_case("wg", bf16_rows(512, D), (4, 2, 2)),
                    bsm_case("wd", bf16_rows(512, F_), (4, 2, 2)),
                    bsm_case("wg", bf16_rows(128, D), (8, 2, 4))]
    out.append({"name": "block_sparse_matmul", "route": "cuda",
                "source": "src/repro_torch/csrc/block_sparse_matmul.cu",
                "replaces": "src/repro/kernels/sparse_matmul/kernel.py:313",
                "launches": counts["block_sparse_matmul"],
                "launches_by_route": {k: counts[k]
                                      for k in (BSM_THIN, BSM_TC, BSM_TILED)},
                **wg_t})

    # quant: attn/wq of layer 0, int4x2 along K (thin-M route); then attn/wk
    # (N = 512) and the compiled forward's M = 512 (tiled route)
    def quant_case(leaf_name, xq, n_copies):
        leaf = cm.params["blocks"]["attn"][leaf_name]
        wq, sq = leaf["w_qp"][0].contiguous(), leaf["w_s"][0].contiguous()
        Mq, N = int(xq.shape[0]), int(wq.shape[1])
        codes = unpack_codes(wq, D, axis=0, bits=4)
        dense = (codes.float() * sq[None, :]).to(torch.bfloat16)
        wqs, codess, denses = (copies(t, n) for t, n in zip(
            (wq, codes, dense), n_copies))
        route, plan = qk.qmm_route(Mq, D, N, 2, xq.dtype == torch.bfloat16,
                                   wq.data_ptr(), xq.data_ptr())
        y = quant_matmul(xq, wq, sq, packed="int4x2")
        ref = quant_matmul_ref(xq, codes, sq, out_dtype=xq.dtype)
        t = timing(
            "quant_matmul", y, ref, nbytes(xq, wq, sq, y), 2.0 * Mq * D * N,
            f"{leaf_name}: M={Mq} K={D} N={N} int4x2, {route} route"
            + (f" ({plan.k_splits} K splits)" if route == "thin_m" else
               f" ({plan.m_tile}-row tiles, {plan.k_splits} K splits)"
               if plan else ""),
            lambda i: lambda: quant_matmul(xq, wqs[i], sq, packed="int4x2"),
            lambda i: lambda: quant_matmul_ref(xq, codess[i], sq,
                                               out_dtype=xq.dtype),
            lambda i: lambda: xq @ denses[i], n_copies)
        if route != "tiled":
            # the first design (tiled kernel) at the same shape, this run
            t["first_version_ms"] = device_ms(lambda i: lambda: qk._launch(
                xq, wqs[i], sq, None, None, 2, "tiled"), n_copies[0])
        if route == "tensor_core":
            # the plan with the other m tile, the rule's alternative
            alt = qk.qmm_tc_plan(Mq, D, N, m_tile=192 - plan.m_tile)
            t["other_m_tile"] = {"plan": list(alt), "ms": device_ms(
                lambda i: lambda: qk._launch(xq, wqs[i], sq, None, None, 2,
                                             "tensor_core", alt),
                n_copies[0])}
        return t

    wq_t = quant_case("wq", x, (32, 16, 8))
    # then the compiled forward's M = 512 (tensor-core route) and M = 128
    wq_t["also"] = [quant_case("wk", x, (32, 16, 8)),
                    quant_case("wq", bf16_rows(512, D), (4, 2, 4)),
                    quant_case("wk", bf16_rows(512, D), (8, 4, 8)),
                    quant_case("wq", bf16_rows(128, D), (8, 4, 8))]
    out.append({"name": "quant_matmul", "route": "cuda",
                "source": "src/repro_torch/csrc/quant_matmul.cu",
                "replaces": "src/repro/kernels/quant_matmul/kernel.py:125",
                "launches": counts["quant_matmul"],
                "launches_by_route": {k: counts[k]
                                      for k in (QMM_THIN, QMM_TC, QMM_TILED)},
                **wq_t})

    # attention: a decode read over 8 slots of a 512-row cache, then the
    # decode profile's shape (200 live rows of each slot, a 256-row extent
    # of the 512-row cache)
    B, H, Hkv, Dh, T, bt = M, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 512, 64
    G = H // Hkv
    q = torch.randn((B, 1, H, Dh), device=dev).to(torch.bfloat16)
    caches = [random_cache(B, T, Hkv, Dh, dev) for _ in range(32)]
    qh = q.permute(0, 2, 1, 3)

    def attention_case(lens_np, tb):
        lengths = torch.as_tensor(lens_np[:, None], dtype=torch.int32,
                                  device=dev)
        ext = [[a[:, :tb] for a in c[:4]] for c in caches]

        def sdpa_inputs(c):
            kd = (c[4][:, :tb].float() * c[2][:, :tb, :, None]).to(
                torch.bfloat16)
            vd = (c[5][:, :tb].float() * c[3][:, :tb, :, None]).to(
                torch.bfloat16)
            return (kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1),
                    vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1))

        kvd = [sdpa_inputs(c) for c in caches[:4]]
        mask = (torch.arange(tb, device=dev)[None, :] < lengths)[:, None,
                                                                   None, :]
        plan = dp.pda_plan(B, 1, H, Hkv, Dh, tb, bt, ext[0][0].data_ptr()
                           | ext[0][1].data_ptr() | int(ext[0][0].stride(0)))
        route = "single" if plan is None else "split"
        y = packed_decode_attention(q, *ext[0], lengths, bt=bt)
        ref = tiled_packed_attention(q, *ext[0], lengths, bt=bt)
        live = int(lens_np.sum())
        t = timing(
            "packed_decode_attention", y, ref,
            nbytes(q, y, lengths) + live * Hkv * (Dh + 8),
            4.0 * H * Dh * live,
            f"B={B} C=1 H={H} Hkv={Hkv} Dh={Dh} extent {tb} of a {T}-row "
            f"cache, bt={bt}, live rows {live}, {route} route"
            + ("" if plan is None else f" ({plan.n_splits * Hkv * B} CTAs)"),
            lambda i: lambda: packed_decode_attention(q, *ext[i], lengths,
                                                      bt=bt),
            lambda i: lambda: tiled_packed_attention(q, *ext[i], lengths,
                                                     bt=bt),
            lambda i: lambda: F.scaled_dot_product_attention(
                qh, *kvd[i], attn_mask=mask), (32, 32, 4))
        if plan is not None:
            # the first design (single kernel) at the same shape, this run
            t["first_version_ms"] = device_ms(lambda i: lambda: dp._launch(
                q, *ext[i], lengths, bt, None), 32)
        # the int4 container: the same codes as int8, on the same route
        ext8 = [[c[4][:, :tb], c[5][:, :tb], c[2][:, :tb], c[3][:, :tb]]
                for c in caches]
        y8 = packed_decode_attention(q, *ext8[0], lengths, bt=bt,
                                     packed=False)
        torch.cuda.synchronize()
        require(torch.equal(y8, y), "packed_decode_attention: int8 and "
                                    "int4x2 codes gave different bits")
        b8, f8 = bound(nbytes(q, y, lengths) + live * Hkv * (2 * Dh + 8),
                       4.0 * H * Dh * live, "bf16")
        t["int4_codes"] = {
            "ms": device_ms(lambda i: lambda: packed_decode_attention(
                q, *ext8[i], lengths, bt=bt, packed=False), 32),
            "plain_ms": device_ms(lambda i: lambda: tiled_packed_attention(
                q, *ext8[i], lengths, bt=bt, packed=False), 8),
            "bound_ms": b8, "bound_by": f8,
            # SDPA reads the same dequantised bf16 cache for either
            # container: timed again here beside the int8-code read
            "library_ms": device_ms(
                lambda i: lambda: F.scaled_dot_product_attention(
                    qh, *kvd[i], attn_mask=mask), 4)}
        return t

    attn_t = attention_case(
        np.random.default_rng(1).integers(64, 320, size=B), T)
    attn_t["also"] = [attention_case(np.full(B, 200), 256)]
    out.append({"name": "packed_decode_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/packed_decode_attention.cu",
                "replaces":
                    "src/repro/kernels/flash_attention/decode_packed.py:128",
                "launches": counts["packed_decode_attention"],
                "launches_by_route": {PDA_SPLIT: counts[PDA_SPLIT],
                                      PDA_SINGLE: counts[PDA_SINGLE]},
                **attn_t})
    return out


def copies(t, n):
    """``n`` copies of a tensor (the first is ``t`` itself)."""
    return [t] + [t.clone() for _ in range(n - 1)]


# ---------------------------------------------------------------- serving


SERVE_KERNELS = ("block_sparse_matmul", "quant_matmul",
                 "packed_decode_attention")
QMM_THIN, QMM_TC, QMM_TILED = ("quant_matmul/thin_m",
                               "quant_matmul/tensor_core",
                               "quant_matmul/tiled")
BSM_THIN, BSM_TC, BSM_TILED = ("block_sparse_matmul/thin_m",
                               "block_sparse_matmul/tensor_core",
                               "block_sparse_matmul/tiled")
PDA_SPLIT, PDA_SINGLE = ("packed_decode_attention/split",
                         "packed_decode_attention/single")
FLASH_TC, FLASH_CC = "flash_attention/tensor_core", "flash_attention/cuda_core"
BSC_REG, BSC_BAND = "block_sparse_conv/reg_tile", "block_sparse_conv/band"
QCONV_REG, QCONV_BAND = "quant_conv/reg_tile", "quant_conv/band"
FCS_STAGED, FCS_STREAM = "fc_stack_matmul/staged", "fc_stack_matmul/stream"
# matmul launches given a tuned plan: on it / on the shape rule's instead
TUNED_HITS = ("quant_matmul/tuned_hits", "block_sparse_matmul/tuned_hits")
TUNED_MISSES = ("quant_matmul/tuned_misses",
                "block_sparse_matmul/tuned_misses")


def counters():
    """kernel name -> (wrapper module, name of its launch counter)."""
    from repro_torch.kernels import fc_stack
    from repro_torch.kernels.flash_attention import decode_packed
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul import kernel as sk
    return {"block_sparse_matmul": (sk, "launches"),
            "quant_matmul": (qk, "launches"),
            "packed_decode_attention": (decode_packed, "launches"),
            "block_sparse_conv": (sk, "conv_launches"),
            "quant_conv": (qk, "conv_launches"),
            "fc_stack_matmul": (fc_stack, "launches"),
            "flash_attention": (fk, "launches"),
            # the launches of each route, beside the totals above
            QMM_THIN: (qk, "launches_thin"),
            QMM_TC: (qk, "launches_tc"),
            QMM_TILED: (qk, "launches_tiled"),
            BSM_THIN: (sk, "launches_thin"),
            BSM_TC: (sk, "launches_tc"),
            BSM_TILED: (sk, "launches_tiled"),
            PDA_SPLIT: (decode_packed, "launches_split"),
            PDA_SINGLE: (decode_packed, "launches_single"),
            FLASH_TC: (fk, "launches_tc"),
            FLASH_CC: (fk, "launches_cc"),
            BSC_REG: (sk, "conv_launches_reg"),
            BSC_BAND: (sk, "conv_launches_band"),
            QCONV_REG: (qk, "conv_launches_reg"),
            QCONV_BAND: (qk, "conv_launches_band"),
            FCS_STAGED: (fc_stack, "launches_staged"),
            FCS_STREAM: (fc_stack, "launches_stream"),
            TUNED_HITS[0]: (qk, "tuned_hits"),
            TUNED_HITS[1]: (sk, "tuned_hits"),
            TUNED_MISSES[0]: (qk, "tuned_misses"),
            TUNED_MISSES[1]: (sk, "tuned_misses")}


def reset_counts():
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in counters().items()}


def pct(v, p):
    return float(np.percentile(np.asarray(v, float), p)) if len(v) else None


def serve(dev, report):
    """Compile llama3.2-1b, then serve the same 16 requests through
    ``ServeEngine`` captured (one CUDA graph per phase and bucket), eagerly,
    and captured again with the int4 cache and with the "unpack" read."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_sparse import CompileRules, compile_model
    from repro_torch.models.model import init_params

    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cm = compile_model(params, cfg, rules=CompileRules(**SERVE_RULES),
                       device=dev)
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    report["serve_setup_s"] = {"init_params": t1 - t0, "compile_model": t2 - t1}

    prompts = serve_prompts(cfg)
    runs = {}
    # the measured configuration first, counted: int4x2, fused, captured
    eng, runs["captured"], counts = serve_run(cm, cfg, dev, prompts,
                                              count=True)
    for name in SERVE_KERNELS + (QMM_THIN, BSM_THIN, PDA_SPLIT):
        require(counts[name] > 0, f"serving ran without launching {name}")
    require(counts[PDA_SINGLE] == 0,
            f"serving sent {counts[PDA_SINGLE]} packed_decode_attention "
            f"launches to the single kernel: every decode row and 16-row "
            f"prefill chunk takes the split route")
    require(runs["captured"]["graphs"] > 0,
            f"the captured engine captured no step: {runs['captured']}")
    report["capture_check"] = capture_check(eng, cfg)
    del eng
    _, runs["eager"], _ = serve_run(cm, cfg, dev, prompts, capture=False)
    require(runs["eager"]["tokens"] == runs["captured"]["tokens"],
            "captured and eager serving gave different tokens")
    _, runs["int4"], _ = serve_run(cm, cfg, dev, prompts, kv_cache="int4")
    require(runs["int4"]["tokens"] == runs["captured"]["tokens"],
            "int4 and int4x2 caches served different tokens")
    _, runs["unpack"], _ = serve_run(cm, cfg, dev, prompts,
                                     packed_read="unpack")
    runs["unpack"]["divergences"] = read_divergences(
        cm, cfg, dev, prompts, runs["captured"]["tokens"],
        runs["unpack"]["tokens"])
    tokens = runs["captured"].pop("tokens")
    for r in runs.values():
        r.pop("tokens", None)
    require(all(len(t) == 32 for t in tokens),
            "not every request got its 32 tokens")
    require(all(0 <= t < cfg.vocab for out in tokens for t in out),
            "a generated token is outside the vocabulary")
    report["serve"] = {
        "requests": 16, "prompt_tokens": int(sum(len(p) for p in prompts)),
        "new_tokens_per_request": 32, **runs["captured"],
        "container_storage_bytes": cm.container_storage_bytes,
        "byte_compression": cm.byte_compression, "launches": counts,
        "eager": runs["eager"], "int4": runs["int4"],
        "unpack": runs["unpack"]}

    report["twin_check"] = {
        kv: twin_check(cm, cfg, dev, prompts[0][:16], kv) for kv in TWIN_TOL}
    report["step_profile"] = {
        f"{phase}_{mode}": profile_step(cm, cfg, dev, phase, mode == "captured")
        for phase in ("decode", "prefill") for mode in ("captured", "eager")}
    report["pdl_edges"] = pdl_edges(cm, cfg, dev)
    report["compiled_forward"] = compiled_forward(cm, cfg, dev)
    return cm, cfg, counts, tokens


# ---------------------------------------------------------------- sharding

# the placed (DTensor) steps at world 1 against the unplaced ones
SHARD_TRAIN_STEPS = 2
SHARD_DECODE_STEPS = 4
# model axes of the shard-local kernel calls, simulated in one process
SHARD_MODEL_AXES = (2, 4)
# the rows of the shard-local linear calls: a decode step's 8 slots and a
# 16-row prefill chunk of them
SHARD_ROWS = (8, 128)


def start_nccl(dev, store_dir):
    """NCCL at world size 1 from a file store, and the (1, 1) mesh.  A
    failure is fatal: there is no gloo fallback on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1)
    require(dist.get_backend() == "nccl",
            f"the process group started {dist.get_backend()}, not nccl")
    return make_mesh((1, 1), ("data", "model"), dev.type)


def sharding_train(cfg, dev, mesh):
    """(a) chip_smoke's llama3.2-1b train step (4 x 2048, 2 micro-batches,
    frozen MLP masks) through ``TrainRunner``, unplaced then placed by the
    sharding rules on the (1, 1) mesh, from the same state; the placed
    run's counts are set to 0 just before it and read just after."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.runtime import RunnerConfig, TrainRunner
    from repro_torch.train.trainer import make_train_step

    params = init_params(cfg, seed=0, device=dev)
    masks = {"blocks": {"mlp": {}}}
    for name in ("wg", "wu", "wd"):
        w = params["blocks"]["mlp"][name]["w"]
        mt = prune_slices(w)
        w.mul_(mt.to(w.dtype))
        masks["blocks"]["mlp"][name] = {"w": mt}
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    opt = adamw_init(params, opt_cfg)
    toks, labels = token_batch(0, TRAIN["batch"], TRAIN["seq"], cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    rc = RunnerConfig(total_steps=SHARD_TRAIN_STEPS, ckpt_every=0,
                      log_every=1)
    out = {}
    runner = TrainRunner(make_train_step(cfg, opt_cfg, TRAIN["n_micro"],
                                         masks), lambda i: batch, rc)
    runner.run(params, opt)
    out["unplaced"] = runner.metrics_log
    del runner

    placed, _, _ = sh.shard_params(params, cfg, mesh)
    popt = sh.shard_opt_state(opt, params, cfg, mesh)
    pmasks = sh.shard_masks(masks, placed)
    pbatch = sh.shard_batch(batch, cfg, mesh)
    runner = TrainRunner(make_train_step(cfg, opt_cfg, TRAIN["n_micro"],
                                         pmasks), lambda i: pbatch, rc)
    torch.cuda.synchronize()
    reset_counts()
    new_params, _ = runner.run(placed, popt)
    torch.cuda.synchronize()
    counts = read_counts()
    out["placed"] = runner.metrics_log
    for name, m in masks["blocks"]["mlp"].items():
        w = new_params["blocks"]["mlp"][name]["w"].to_local()
        require(bool((w[~m["w"]] == 0).all()),
                f"sharding: pruned {name} weights are not exactly zero")
    for a, b in zip(out["unplaced"], out["placed"]):
        for k, tol in TRAIN_TWIN_TOL.items():
            rel = abs(a[k] - b[k]) / abs(a[k])
            require(math.isfinite(b[k]) and rel <= tol,
                    f"sharding: placed train step {k} {b[k]} vs unplaced "
                    f"{a[k]}: rel err {rel} > {tol}")
    want = cfg.n_layers * 2 * TRAIN["n_micro"]
    require(counts[FLASH_TC] == want * SHARD_TRAIN_STEPS
            and counts[FLASH_CC] == 0,
            f"sharding: {counts[FLASH_TC]} tensor-core and {counts[FLASH_CC]}"
            f" CUDA-core flash launches in {SHARD_TRAIN_STEPS} placed steps, "
            f"expected {want} a step on the tensor cores")
    return {
        "losses": {k: [m["loss"] for m in v] for k, v in out.items()},
        "grad_norms": {k: [m["grad_norm"] for m in v]
                       for k, v in out.items()},
        "step_ms": {k: [m["step_s"] * 1e3 for m in v]
                    for k, v in out.items()},
        "flash_tc_launches_per_step": counts[FLASH_TC] / SHARD_TRAIN_STEPS,
        "tol": TRAIN_TWIN_TOL}


def sharding_decode(cm, cfg, dev, mesh):
    """(b) a 16-row prefill chunk of 8 slots, then decode steps, with the
    int4x2 cache: unplaced, and placed (parameters by the compiled rules,
    the cache by ``cache_specs``); the logits must be equal bit for bit.
    Then both steps timed eagerly (wall, synchronised)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm

    prompts = serve_prompts(cfg)
    chunk = torch.from_numpy(np.stack([p[:16] for p in prompts[:8]])).to(dev)
    placed, specs, _ = sh.shard_params(cm.params, cfg, mesh, cm.patterns)

    def run(p, place):
        cache = tm.init_cache(cfg, 8, 256, "int4x2", device=dev)
        if place:
            cache = sh.shard_cache(cache, cfg, mesh, "int4x2")
        put = (lambda t: sh.shard_batch({"tokens": t}, cfg, mesh)["tokens"]) \
            if place else (lambda t: t)
        logits, cache = tm.prefill_step(p, cfg, cache, put(chunk),
                                        patterns=cm.patterns)
        out = [logits]
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        for _ in range(SHARD_DECODE_STEPS):
            tok = nxt.full_tensor() if place else nxt
            logits, cache = tm.decode_step(p, cfg, cache, put(tok),
                                           patterns=cm.patterns)
            out.append(logits)
            nxt = logits.argmax(-1).to(torch.int32)
        step = lambda: tm.decode_step(p, cfg, cache, put(tok),   # noqa: E731
                                      patterns=cm.patterns)
        return [o.full_tensor() if place else o for o in out], step

    ref, step_u = run(cm.params, False)
    got, step_p = run(placed, True)
    for i, (a, b) in enumerate(zip(ref, got)):
        require(torch.equal(a, b),
                f"sharding: placed step {i} logits differ from the unplaced "
                f"step's by {float((a.float() - b.float()).abs().max())}")
    ms = {}
    for name, fn in (("unplaced", step_u), ("placed", step_p),
                     ("placed_again", step_p), ("unplaced_again", step_u)):
        ms[name] = host_ms(fn, iters=10)
    return {"steps": len(ref), "bitwise": True, "decode_step_ms": ms}


def local_linear_calls(fam, leaf, specs, x, pattern, n):
    """Each of ``n`` model ranks' local call of one compiled linear (a
    layer's leaves ``leaf``, their sharding specs ``specs``) on the card,
    combined as the collective would (columns concatenated; row- and
    pattern-parallel partial sums added in rank order in f32); returns
    (combined, mode, [route of each call])."""
    from repro_torch.core import sharded
    from repro_torch.core.dispatch import linear_dispatch
    from repro_torch.launch import sharding as sh
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul import kernel as sk

    m1 = ((n,), ("model",))
    key = fam.key_leaf
    pl = {k: sh.placements(specs[k], m1)[0] for k in leaf}
    mode = sharded.linear_mode(fam, pl[key], leaf[key].ndim, n)
    lay = sharded.linear_layout(fam, {k: t.ndim for k, t in leaf.items()},
                                mode, x.ndim)
    outs, routes = [], []
    for r in range(n):
        loc = {k: sharded.local_shard(t, [lay[k]], (n,), (r,)).contiguous()
               for k, t in leaf.items()}
        xl = sharded.local_shard(x, [lay["x"]], (n,), (r,)).contiguous()
        pat = sharded.local_pattern(pattern, n, r) if mode == "pattern" \
            else pattern
        ops = ("sparse", xl, loc[key], loc.get("w_s"), "int4x2", pat) \
            if fam.name == "sparse_packed" else \
            ("quant", xl, loc[key], loc.get("w_s"), "int4x2")
        route, _ = family_route(ops, int(xl.shape[0]), xl)
        mod = sk if ops[0] == "sparse" else qk
        outs.append(took_route(
            mod, {"thin_m": "launches_thin", "tensor_core": "launches_tc",
                  "tiled": "launches_tiled"}, route,
            lambda: linear_dispatch(loc, xl, pattern=pat)))
        routes.append(route)
    if mode == "column":
        y = torch.cat(outs, dim=-1)
    elif mode == "replicated":
        require(all(torch.equal(o, outs[0]) for o in outs),
                f"{fam.name}: replicated ranks' outputs differ")
        y = outs[0]
    else:
        y = sum(o.float() for o in outs).to(outs[0].dtype)
    return y, mode, routes


def crafted_mlp_leaf(cfg, dev, rng):
    """An int4x2 block-sparse ``wg`` leaf at llama's full width whose
    pattern (alternate 128 x 128 blocks of each block-row, half the blocks)
    partitions by block-rows 2 and 4 ways: the pattern-parallel rule's local
    schedules on the card."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.core.sparsity import pattern_from_bitmap

    K, N, b = cfg.d_model, cfg.d_ff, 128
    bitmap = np.add.outer(np.arange(K // b), np.arange(N // b)) % 2 == 0
    pat = pattern_from_bitmap((K, N), (b, b), bitmap)
    P = pat.n_blocks_present
    codes = torch.randint(-7, 8, (P, b, b), device=dev).to(torch.int8)
    leaf = {"w_blkp": pack_codes(codes, axis=1, bits=4),
            "w_s": torch.rand((N,), device=dev) / 112}
    return leaf, pat


def sharding_kernels(cm, cfg, dev):
    """(c) the shard-local kernel calls at model axes 2 and 4, simulated in
    one process: every compiled leaf class of layer 0 (``wq``/``wk``/``wv``
    column-parallel, ``wo`` row-parallel, the MLP's blocks local where the
    pattern partitions and replicated where it does not, and a crafted
    partitioning ``wg`` besides) at a decode step's and a prefill chunk's
    rows, the tied head vocab-sharded, and the packed attention reads
    (decode and 16-row chunk) and the training flash forward and its op's
    backward on each rank's local heads and, through the placed leg, on
    each rank's rows of a sequence-sharded q (``sharding_flash_seq``);
    each combined output within one bf16 step of max|ref| of the
    unsharded call, each kernel call on the route its shape rule names;
    each rank's sequence-sharded flash call at model 4 timed
    (``seq_flash_rows``)."""
    from repro_torch.core import payload_registry
    from repro_torch.core.dispatch import linear_dispatch
    from repro_torch.kernels.flash_attention import decode_packed as dp
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import sharding as sh

    rng = np.random.default_rng(0)
    out = {}
    shape_of = {r.name: r.shape for r in cm.report}
    crafted, crafted_pat = crafted_mlp_leaf(cfg, dev, rng)
    for n in SHARD_MODEL_AXES:
        mesh = ((1, n), ("data", "model"))
        specs = sh.sanitize_specs(sh.param_specs(cm.params, cfg, mesh,
                                                 patterns=cm.patterns),
                                  cm.params, mesh)
        row = {"sparse_leaves_sharded": sum(
            1 for path, s in tree_items(specs)
            if path[-1] == "w_blkp" and "model" in s),
            "sparse_leaves": sum(1 for path, _ in tree_items(specs)
                                 if path[-1] == "w_blkp"),
            "leaves": {}}
        cases = [(path, leaf,
                  {k: s[1:] for k, s in tree_get(
                      specs, path.split("/")).items()},
                  cm.patterns.get(shape_of[path]))
                 for path, leaf in compiled_leaves(cm) if path != "head"]
        cases.append(("crafted/wg", crafted,
                      {"w_blkp": ("model", None, None), "w_s": (None,)},
                      crafted_pat))
        for path, leaf, lspecs, pat in cases:
            fam = payload_registry.family_for_leaves(leaf)
            K = int(shape_of.get(path, crafted_pat.shape)[0])
            for M in SHARD_ROWS:
                x = (torch.randn((M, K), device=dev) / 8).to(torch.bfloat16)
                ref = linear_dispatch(leaf, x, pattern=pat)
                y, mode, routes = local_linear_calls(fam, leaf, lspecs, x,
                                                     pat, n)
                err = float((y.float() - ref.float()).abs().max())
                tol = tol_for(torch.bfloat16, ref.float())
                require(err <= tol,
                        f"sharding: {path} at model {n}, M {M} ({mode}): "
                        f"{err} > one bf16 step {tol}")
                row["leaves"][f"{path}@{M}"] = {"mode": mode,
                                                "routes": routes, "err": err}
        # the tied head, vocab-sharded: h @ W_r.T per rank, concatenated
        w = cm.params["embed"]["w"]
        h = (torch.randn((8, cfg.d_model), device=dev) / 8).to(w.dtype)
        ref = h @ w.T
        y = torch.cat([h @ t.T for t in w.chunk(n, dim=0)], dim=-1)
        require(float((y.float() - ref.float()).abs().max())
                <= tol_for(torch.bfloat16, ref.float()),
                f"sharding: head at model {n}")
        row["head"] = {"mode": "column (vocab)", "route": "torch.matmul",
                       "err": float((y.float() - ref.float()).abs().max())}
        row["attention"] = sharding_attention(cfg, dev, n, dp)
        row["flash"] = sharding_flash(cfg, dev, n, fk, flash_attention)
        row["flash_seq"] = sharding_flash_seq(cfg, dev, n, fk)
        out[f"model_{n}"] = row
    out["flash_seq_rows_model_4"] = seq_flash_rows(
        cfg, dev, out["model_4"]["flash_seq"]["bfloat16"]["extents"], fk)
    return out


def sharding_attention(cfg, dev, n, dp):
    """The packed reads of a decode step (C = 1) and a 16-row prefill chunk
    of 8 slots over a 512-row int4x2 cache, each rank on its H / n q heads
    and Hkv / n kv heads, concatenated against the all-heads read."""
    H, Hkv, Dh, B, T, bt = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 8,
                            512, 64)
    k_p, v_p, k_s, v_s, _, _ = random_cache(B, T, Hkv, Dh, dev)
    res = {}
    for C in (1, 16):
        q = (torch.randn((B, C, H, Dh), device=dev) / 4).to(torch.bfloat16)
        lens = torch.randint(1, T - C, (B, 1), device=dev, dtype=torch.int32) \
            + torch.arange(1, C + 1, device=dev, dtype=torch.int32)[None]
        ref = dp.packed_decode_attention(q, k_p, v_p, k_s, v_s, lens, bt=bt)
        outs, routes = [], []
        h, g = H // n, Hkv // n
        for r in range(n):
            args = [t[:, :, r * g:(r + 1) * g].contiguous()
                    for t in (k_p, v_p, k_s, v_s)]
            ql = q[:, :, r * h:(r + 1) * h].contiguous()
            plan = dp.pda_plan(B, C, h, g, Dh, T, bt)
            route = "split" if plan is not None else "single"
            outs.append(took_route(
                dp, {"split": "launches_split", "single": "launches_single"},
                route, lambda: dp.packed_decode_attention(ql, *args, lens,
                                                          bt=bt)))
            routes.append(route)
        y = torch.cat(outs, dim=2)
        err = float((y.float() - ref.float()).abs().max())
        require(err <= tol_for(torch.bfloat16, ref.float()),
                f"sharding: packed read C={C} at model {n}: {err}")
        res[f"C{C}"] = {"routes": routes, "err": err}
    return res


def sharding_flash(cfg, dev, n, fk, flash_attention):
    """The training flash call (one micro-batch: 2 x 2048, causal) on each
    rank's H / n q heads and Hkv / n kv heads, forward and the op's
    backward, concatenated against the all-heads call."""
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T = TRAIN["batch"] // TRAIN["n_micro"], TRAIN["seq"]
    q, k, v = ((torch.randn((B, T, h_, Dh), device=dev) / 2).to(torch.bfloat16)
               for h_ in (H, Hkv, Hkv))
    g = (torch.randn((B, T, H, Dh), device=dev) / 2).to(torch.bfloat16)

    def fwd_bwd(q_, k_, v_, g_):
        q_, k_, v_ = (t.detach().requires_grad_() for t in (q_, k_, v_))
        o = flash_attention(q_, k_, v_, True)
        dq, dk, dv = torch.autograd.grad(o, (q_, k_, v_), g_)
        return o.detach(), dq, dk, dv

    ref = fwd_bwd(q, k, v, g)
    parts, routes = [], []
    h, kv = H // n, Hkv // n
    for r in range(n):
        sl = lambda t, w: t[:, :, r * w:(r + 1) * w].contiguous()  # noqa
        args = (sl(q, h), sl(k, kv), sl(v, kv), sl(g, h))
        route = fk.flash_route(*args[:3])
        parts.append(took_route(fk, {"tensor_core": "launches_tc",
                                     "cuda_core": "launches_cc"}, route,
                                lambda: fwd_bwd(*args)))
        routes.append(route)
    errs = {}
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        y = torch.cat([p[i] for p in parts], dim=2)
        errs[name] = float((y.float() - ref[i].float()).abs().max())
        require(errs[name] <= tol_for(torch.bfloat16, ref[i].float()),
                f"sharding: flash {name} at model {n}: {errs[name]}")
    return {"routes": routes, "err": errs}


def sharding_flash_seq(cfg, dev, n, fk):
    """The training flash call sequence-sharded (``seq_shard``: q cut along
    T over ``model``, k and v replicated) at model n, through the placed
    leg a step runs: ``attn_full_dispatch`` on CUDA DTensors at each rank r
    of a fake (1, n) group (its collectives move nothing, so each rank's
    local work is what that rank computes) — q placed ``Shard(1)``, the
    rank's rows where DTensor cuts T (``sharded.local_extent``), one
    launch on the route ``flash_route`` names, forward and the op's
    backward.  Each rank's out against the whole call's rows, dq, dk and dv
    summed in f32 over the ranks (dq: disjoint rows; dk, dv: the leg's
    ``Partial``) against the whole call: out and dq within one bf16 step
    of max|ref|, dk and dv within n.  llama3.2-1b's call (one micro-batch,
    2 x 2048, bf16, causal: the tensor-core route) and an f32 call (1 x
    512: the CUDA-core route, f32 tolerances)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core import sharded
    from repro_torch.core.dispatch import attn_full_dispatch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh

    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    routes = {"tensor_core": "launches_tc", "cuda_core": "launches_cc"}
    out = {}
    for dt, B, T, want in (
            (torch.bfloat16, TRAIN["batch"] // TRAIN["n_micro"],
             TRAIN["seq"], "tensor_core"),
            (torch.float32, 1, 512, "cuda_core")):
        t0 = time.perf_counter()
        q, k, v, g = ((torch.randn((B, T, h_, Dh), device=dev) / 2).to(dt)
                      for h_ in (H, Hkv, Hkv, H))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*leaves, True)
        ref = [o.detach()] + list(torch.autograd.grad(o, leaves, g))
        outs, sums, extents, shapes = [], None, [], []
        for r in range(n):
            with fake_group(n, rank=r):
                mesh = make_mesh((1, n), ("data", "model"), dev.type)
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                qd = sharded.place(leaves[0], mesh, [Replicate(), Shard(1)])
                kd, vd = (sharded.place(t, mesh, [Replicate()] * 2)
                          for t in leaves[1:])
                off, rows = sharded.local_extent(qd, 1)
                od = took_route(fk, routes, want, lambda: attn_full_dispatch(
                    qd, kd, vd, causal=True))
                ol = od.to_local()
                grads = torch.autograd.grad(ol, leaves,
                                            g[:, off:off + rows])
            d = ol.detach().float() - ref[0][:, off:off + rows].float()
            outs.append(float(d.abs().max()))
            part = [t.float() for t in grads]
            sums = part if sums is None else [a + b
                                              for a, b in zip(sums, part)]
            extents.append([off, rows])
            shapes.append(list(od.shape))
        starts = [sum(e[1] for e in extents[:i]) for i in range(n)]
        require([e[0] for e in extents] == starts
                and sum(e[1] for e in extents) == T,
                f"sharding: seq-sharded ranks at model {n} cut {T} rows as "
                f"{extents}")
        require(all(s_ == list(q.shape) for s_ in shapes),
                f"sharding: seq-sharded flash outputs at model {n} have "
                f"global shapes {shapes}, not {list(q.shape)}")
        errs = {"out": max(outs)}
        for i, name in enumerate(("dq", "dk", "dv")):
            errs[name] = float((sums[i] - ref[i + 1].float()).abs().max())
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            tol = tol_for(dt, ref[i].float()) * (1 if i < 2 else n)
            require(errs[name] <= tol,
                    f"sharding: seq-sharded flash {name} at model {n} "
                    f"({dt}): {errs[name]} > {tol}")
        out[str(dt).split(".")[-1]] = {
            "route": want, "launches": n, "err": errs, "extents": extents,
            "seconds": time.perf_counter() - t0}
    return out


def seq_flash_rows(cfg, dev, extents, fk):
    """Each rank's flash call of the sequence-sharded training call
    (llama3.2-1b, 2 x 2048, bf16, causal) at the ranks' ``extents`` ((first
    row, rows) each, as ``sharding_flash_seq`` read them off DTensor),
    and the whole call: kernel, plain version and SDPA (an explicit boolean
    mask of the offset rows: ``is_causal`` aligns at 0) device ms, each on
    4 copies of its inputs as ``flash_row`` times them, beside the bound
    from the rank's causal pairs (rows at q_offset + i see q_offset + i + 1
    keys) and the bytes it needs (k and v to q_offset + Tq)."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T = TRAIN["batch"] // TRAIN["n_micro"], TRAIN["seq"]
    ins = [[torch.randn((B, T, h_, Dh), device=dev).to(torch.bfloat16)
            for h_ in (H, Hkv, Hkv)] for _ in range(4)]
    heads = [[t.permute(0, 2, 1, 3) for t in qkv] for qkv in ins]
    rows = []
    for r, (off, Tq) in enumerate(extents):
        q_r = [qkv[0][:, off:off + Tq].contiguous() for qkv in ins]
        qh = [t.permute(0, 2, 1, 3) for t in q_r]
        k, v = ins[0][1:]
        y = fk.flash_attention_fwd(q_r[0], k, v, causal=True, q_offset=off)
        ref = fk.flash_attention_plain(q_r[0], k, v, causal=True,
                                       q_offset=off)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        require(err <= flash_tol(torch.bfloat16, ref),
                f"sharding: rank {r}'s flash call ({off}, {Tq}): {err}")
        kend = min(T, off + Tq)
        pairs = Tq * off + Tq * (Tq + 1) / 2
        b_ms, b_by = bound(nbytes(q_r[0], k[:, :kend], v[:, :kend], y),
                           4.0 * B * H * Dh * pairs, "bf16")
        qpos = off + torch.arange(Tq, device=dev)
        mask = torch.arange(T, device=dev)[None, :] <= qpos[:, None]
        rows.append({
            "rank": r, "q_offset": off, "rows": Tq, "max_abs_err": err,
            "pairs_share": pairs / (T * (T + 1) / 2),
            "ms": device_ms(lambda i: lambda: fk.flash_attention_fwd(
                q_r[i], *ins[i][1:], causal=True, q_offset=off), 4),
            "plain_ms": device_ms(lambda i: lambda: fk.flash_attention_plain(
                q_r[i], *ins[i][1:], causal=True, q_offset=off), 2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": device_ms(
                lambda i: lambda: F.scaled_dot_product_attention(
                    qh[i], *heads[i][1:], attn_mask=mask, enable_gqa=True),
                4)})
    whole_ms = device_ms(lambda i: lambda: fk.flash_attention_fwd(
        *ins[i], causal=True), 4)
    return {"ranks": rows, "whole_ms": whole_ms,
            "ranks_sum_ms": sum(r_["ms"] for r_ in rows),
            "seconds": time.perf_counter() - t0}


def sharding(cm, cfg, dev, report):
    """The sharding phase: (a) the placed train step and (b) the placed
    compiled decode step on NCCL at world 1, (c) the shard-local kernel
    calls at model axes 2 and 4, (d) DTensor's host cost in the step
    times."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        mesh = start_nccl(dev, store)
        try:
            res = {"train": sharding_train(cfg, dev, mesh),
                   "decode": sharding_decode(cm, cfg, dev, mesh)}
        finally:
            dist.destroy_process_group()
    res["kernels"] = sharding_kernels(cm, cfg, dev)
    res["seconds"] = time.perf_counter() - t0
    report["sharding"] = res
    return res


# ------------------------------------------- the sequence-sharded cache

# llama3.2-1b's packed reads at 8 slots over a 512-row cache, a decode row
# (C = 1) and the 16-row chunk, cut into the ranges of model axes 2 and 4
SEQ_T = 512
SEQ_CHUNKS = (1, 16)
SEQ_TIME_CALLS = 8
PDA_ROUTES = {"split": "launches_split", "single": "launches_single"}
# the dry-run's cells on (16, 16), each in a process of its own
DRYRUN_CELLS = (("llama3.2-1b", "decode_32k"), ("llama3.2-1b", "train_4k"),
                ("olmoe-1b-7b", "decode_32k"), ("xlstm-1.3b", "decode_32k"),
                ("zamba2-2.7b", "decode_32k"))
DRYRUN_TIMEOUT_S = 600


def start_dryrun(out_dir):
    """Start the dry-run of :data:`DRYRUN_CELLS` on the (16, 16) mesh:
    ``python -m repro_torch.launch.dryrun``, one process a cell, with no card visible (the fake process group is process-global
    and must not meet NCCL; it runs on meta tensors), at a lower CPU
    priority than the card's phases, beside which it runs from the start;
    :func:`seq_cache` joins it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        log = open(out_dir / f"dryrun_{arch}_{shape}.log", "w")
        procs[f"{arch}/{shape}"] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out",
             str(out_dir / "dryrun_torch"), "--force"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(10)), log)
    return {"procs": procs, "t0": time.perf_counter(), "out": out_dir}


def stop_dryrun(dry):
    for proc, log in dry["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def join_dryrun(dry):
    """Each cell's record; a cell that did not end ``ok`` fails."""
    out = {}
    for cell, (proc, log) in dry["procs"].items():
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - dry["t0"])
        rc = proc.wait(timeout=max(left, 1))
        log.close()
        arch, shape = cell.split("/")
        path = dry["out"] / "dryrun_torch" / f"{arch}__{shape}__pod1.json"
        require(rc == 0 and path.exists(),
                f"dry-run {cell}: exit {rc}, see {log.name}")
        rec = json.loads(path.read_text())
        require(rec["status"] == "ok",
                f"dry-run {cell}: {rec['status']} {rec.get('error')}")
        out[cell] = {k: rec.get(k) for k in (
            "n_chips", "bytes_per_device", "n_micro", "flops_per_device",
            "traffic_bytes_per_device", "collective_bytes_per_device",
            "collectives", "collective_counts", "model_flops_ratio",
            "t_place_s", "t_step_s")}
    out["seconds"] = time.perf_counter() - dry["t0"]
    out["torch"] = torch.__version__
    return out


def seq_combine_parts(parts):
    """The ranges' partial reads, stacked, combined by
    ``repro_torch.core.sharded.seq_combine`` (the ranks' combine, with a
    reduction over the stack in place of the all-reduces)."""
    from repro_torch.core.sharded import seq_combine

    o = torch.stack([p[0].float() for p in parts])
    lse = torch.stack([p[1] for p in parts])
    return seq_combine(o, lse, lambda t, op: t.amax(dim=0) if op == "max"
                       else t.sum(dim=0))


def seq_read_case(dev, cfg, dp, kc, vc, k_s, v_s, codes, C, packed, n,
                  bt=64):
    """One read of the 8 slots, whole and cut into ``n`` ranges of the
    cache: each range's split-kernel call with its local extents and
    ``return_lse``, combined; held against the whole split read and the
    plain version, with the times of each range's call, of the combine and
    of the whole read (beside its bound, its plain version's time and
    SDPA's on the dequantised bf16 cache, ``codes`` the int8 codes)."""
    import torch.nn.functional as F

    H, Dh, B, T = cfg.n_heads, cfg.head_dim, kc.shape[0], kc.shape[1]
    Hkv = cfg.n_kv_heads
    q = (torch.randn((B, C, H, Dh), device=dev) / 4).to(torch.bfloat16)
    # every extent in the first 3/4 of the cache: at 4 ranges the last
    # holds no live key, at 2 the second holds none of the shorter rows'
    lens = torch.randint(1, T * 3 // 4 - C, (B, 1), device=dev,
                         dtype=torch.int32) \
        + torch.arange(1, C + 1, device=dev, dtype=torch.int32)[None]
    kw = dict(bt=bt, packed=packed)
    whole, whole_lse = took_route(
        dp, PDA_ROUTES, "split", lambda: dp.packed_decode_attention(
            q, kc, vc, k_s, v_s, lens, return_lse=True, **kw))
    plain, plain_lse = dp.tiled_packed_attention(q, kc, vc, k_s, v_s, lens,
                                                 return_lse=True, **kw)
    t = T // n
    calls, dead = [], 0
    for r in range(n):
        args = [x[:, r * t:(r + 1) * t].contiguous()
                for x in (kc, vc, k_s, v_s)]
        ext = torch.clamp(lens - r * t, 0, t)
        dead += int((ext == 0).sum())
        calls.append(lambda a=args, e=ext: dp.packed_decode_attention(
            q.float(), *a, e, return_lse=True, **kw))
    parts = [took_route(dp, PDA_ROUTES, "split", c) for c in calls]
    o, lse = seq_combine_parts(parts)
    require(bool(torch.isfinite(o).all()),
            f"seq cache: a non-finite combined read at model {n}")
    y = o.to(torch.bfloat16)
    err = {"vs_split": float((y.float() - whole.float()).abs().max()),
           "vs_plain": float((y.float() - plain.float()).abs().max()),
           "lse_vs_split": float((lse - whole_lse).abs().max()),
           "lse_vs_plain": float((lse - plain_lse).abs().max())}
    for key, ref in (("vs_split", whole), ("vs_plain", plain)):
        require(err[key] <= tol_for(torch.bfloat16, ref.float()),
                f"seq cache: C={C} packed={packed} model {n} {key}: "
                f"{err[key]}")
    for key, ref in (("lse_vs_split", whole_lse), ("lse_vs_plain", plain_lse)):
        require(err[key] <= 1e-5 * (float(ref.abs().max()) + 1),
                f"seq cache: C={C} packed={packed} model {n} {key}: "
                f"{err[key]}")
    n_t = SEQ_TIME_CALLS
    kd, vd = ((c.float() * sc[..., None]).to(torch.bfloat16).permute(
        0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
        for c, sc in zip(codes, (k_s, v_s)))
    mask = torch.arange(T, device=dev)[None, None, None, :] \
        < lens[:, None, :, None]
    qh = q.permute(0, 2, 1, 3)
    # each live cache row read once a slot; 4·Dh operations a (query row,
    # head, live key)
    live = int(lens.amax(dim=1).sum())
    code_bytes = Dh if packed else 2 * Dh
    b_ms, b_by = bound(nbytes(q, whole, lens) + live * Hkv * (code_bytes + 8),
                       4.0 * H * Dh * int(lens.sum()), "bf16")
    times = {
        "range_ms": [device_ms(lambda i, c=c: c, n_t) for c in calls],
        "combine_ms": device_ms(lambda i: lambda: seq_combine_parts(parts),
                                n_t),
        "whole_ms": device_ms(lambda i: lambda: dp.packed_decode_attention(
            q, kc, vc, k_s, v_s, lens, **kw), n_t),
        "whole_bound_ms": b_ms, "whole_bound_by": b_by,
        "whole_plain_ms": device_ms(lambda i: lambda: dp.tiled_packed_attention(
            q, kc, vc, k_s, v_s, lens, **kw), 2),
        "whole_library_ms": device_ms(
            lambda i: lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=mask), n_t)}
    return {"err": err, "rows_with_no_live_key_in_a_range": dead, **times}


def seq_cache(dev, report, dry):
    """The sequence-sharded cache on the card: (a) llama3.2-1b's packed
    reads (int4x2 and int4, decode and the 16-row chunk) cut into the
    ranges of model axes 2 and 4, each range's split call and the combine
    against the whole split read and the plain version; (b) the dry-run's
    cells (:data:`DRYRUN_CELLS`), started at the beginning, joined
    here."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import decode_packed as dp

    t0 = time.perf_counter()
    cfg = get_config("llama3.2-1b")
    k_p, v_p, k_s, v_s, k_q, v_q = random_cache(8, SEQ_T, cfg.n_kv_heads,
                                                cfg.head_dim, dev)
    reads = {}
    for packed, (kc, vc) in ((True, (k_p, v_p)), (False, (k_q, v_q))):
        for C in SEQ_CHUNKS:
            for n in SHARD_MODEL_AXES:
                key = f"{'int4x2' if packed else 'int4'}/C{C}/model_{n}"
                reads[key] = seq_read_case(dev, cfg, dp, kc, vc, k_s, v_s,
                                           (k_q, v_q), C, packed, n)
    res = {"reads": reads, "reads_timed": "device ms a call, CUDA graph of "
           f"{SEQ_TIME_CALLS} calls on the same operands (L2-warm)",
           "dryrun": join_dryrun(dry)}
    res["seconds"] = time.perf_counter() - t0
    report["seq_cache"] = res
    return res


# ------------------------------------------------------------ MoE sharding

# the MoE leg's placed steps at world 1: olmoe-1b-7b's train step at 2 of
# its 16 layers (2 steps of 2 x 1024 tokens in 2 micro-batches, frozen
# expert masks) and qwen2-moe-a2.7b's drip at 2 of 24 (8 slots, 4 steps,
# int4x2); its local function rank by rank at (data, model) (2, 2) and
# (1, 4), on the 8-slot drip's tokens and on the train step's batch
MOE_SHARD_TRAIN = dict(arch="olmoe-1b-7b", layers=2, batch=2, seq=1024,
                       n_micro=2, steps=2)
MOE_SHARD_DRIP = dict(arch="qwen2-moe-a2.7b", layers=2, slots=8, steps=4)
MOE_SHARD_MESHES = ((2, 2), (1, 4))
MOE_SHARD_ROWS = ((8, 1), (2, 1024))


def moe_sharding_train(dev, mesh):
    """(a) olmoe-1b-7b's train step through ``TrainRunner``, unplaced and
    then placed from the same state, each run's counts set to 0 just
    before it and read just after: losses and gradient norms within
    ``TRAIN_TWIN_TOL`` (and whether bit for bit), pruned expert weights
    exactly zero, the same launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.runtime import RunnerConfig, TrainRunner
    from repro_torch.train.trainer import make_train_step

    spec = MOE_SHARD_TRAIN
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["layers"])
    params = init_params(cfg, seed=0, device=dev)
    moe = params["blocks"]["moe"]
    masks = {"blocks": {"moe": {}}}
    for name in ("eg", "eu", "ed"):
        w = moe[name]["w"]
        mt = prune_slices(w)
        w.mul_(mt.to(w.dtype))
        masks["blocks"]["moe"][name] = {"w": mt}
    opt_cfg = AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype)
    opt = adamw_init(params, opt_cfg)
    toks, labels = token_batch(0, spec["batch"], spec["seq"], cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    rc = RunnerConfig(total_steps=spec["steps"], ckpt_every=0, log_every=1)
    placed, _, _ = sh.shard_params(params, cfg, mesh)
    runs = {"unplaced": (params, opt, masks, batch),
            "placed": (placed, sh.shard_opt_state(opt, params, cfg, mesh),
                       sh.shard_masks(masks, placed),
                       sh.shard_batch(batch, cfg, mesh))}
    logs, counts = {}, {}
    for name, (p, o, m, b) in runs.items():
        runner = TrainRunner(make_train_step(cfg, opt_cfg, spec["n_micro"],
                                             m), lambda i, b=b: b, rc)
        torch.cuda.synchronize()
        reset_counts()
        new_params, _ = runner.run(p, o)
        torch.cuda.synchronize()
        counts[name] = read_counts()
        logs[name] = runner.metrics_log
        for k, mk in masks["blocks"]["moe"].items():
            w = new_params["blocks"]["moe"][k]["w"]
            w = w.to_local() if hasattr(w, "to_local") else w
            require(not bool(((w != 0) & ~mk["w"]).any()),
                    f"moe sharding: {name} pruned {k} weights are not "
                    "exactly zero")
        del runner, new_params
    bitwise = True
    for a, b in zip(logs["unplaced"], logs["placed"]):
        for k, tol in TRAIN_TWIN_TOL.items():
            rel = abs(a[k] - b[k]) / abs(a[k])
            bitwise &= a[k] == b[k]
            require(math.isfinite(b[k]) and rel <= tol,
                    f"moe sharding: placed train step {k} {b[k]} vs "
                    f"unplaced {a[k]}: rel err {rel} > {tol}")
    want = cfg.n_layers * 2 * spec["n_micro"] * spec["steps"]
    require(counts["placed"] == counts["unplaced"]
            and counts["placed"][FLASH_TC] == want
            and counts["placed"][FLASH_CC] == 0,
            f"moe sharding: train launches placed {counts['placed']} vs "
            f"unplaced {counts['unplaced']}, expected {want} on the tensor "
            "cores")
    return {"layers": cfg.n_layers, **{k: spec[k] for k in (
        "batch", "seq", "n_micro", "steps")},
        "losses": {k: [m["loss"] for m in v] for k, v in logs.items()},
        "grad_norms": {k: [m["grad_norm"] for m in v]
                       for k, v in logs.items()},
        "step_ms": {k: [m["step_s"] * 1e3 for m in v]
                    for k, v in logs.items()},
        "bitwise": bool(bitwise), "tol": TRAIN_TWIN_TOL,
        "launches": {k: v for k, v in counts["placed"].items() if v}}


def moe_sharding_drip(dev, mesh):
    """(b) qwen2-moe-a2.7b compiled as ``moe_path`` compiles it, its drip
    (each slot a prompt token a step) with the int4x2 cache, unplaced and
    placed, each run's counts set to 0 just before it and read just
    after: the logits equal bit for bit at every step, the same launches
    by route; both steps' eager host ms in turns."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm

    spec = MOE_SHARD_DRIP
    cm, cfg, info = family_model(spec["arch"], dev, spec["layers"])
    B = spec["slots"]
    toks = torch.from_numpy(np.stack([p[:spec["steps"]] for p in
                                      serve_prompts(cfg)[:B]])).to(dev)
    placed, _, _ = sh.shard_params(cm.params, cfg, mesh, cm.patterns)

    def run(p, place):
        cache = tm.init_cache(cfg, B, 256, "int4x2", device=dev)
        if place:
            cache = sh.shard_cache(cache, cfg, mesh, "int4x2")
        put = (lambda t: sh.shard_batch({"tokens": t}, cfg, mesh)["tokens"]) \
            if place else (lambda t: t)
        out = []
        for i in range(spec["steps"]):
            logits, cache = tm.decode_step(p, cfg, cache,
                                           put(toks[:, i:i + 1]),
                                           patterns=cm.patterns)
            out.append(logits.full_tensor() if place else logits)
        step = lambda: tm.decode_step(p, cfg, cache,   # noqa: E731
                                      put(toks[:, -1:]), patterns=cm.patterns)
        return out, step

    logits, steps, counts = {}, {}, {}
    for name, p in (("unplaced", cm.params), ("placed", placed)):
        torch.cuda.synchronize()
        reset_counts()
        logits[name], steps[name] = run(p, name == "placed")
        torch.cuda.synchronize()
        counts[name] = read_counts()
    for i, (a, b) in enumerate(zip(logits["unplaced"], logits["placed"])):
        require(bool(torch.isfinite(a).all()) and torch.equal(a, b),
                f"moe sharding: placed drip step {i} logits differ from the "
                f"unplaced step's by {float((a.float() - b.float()).abs().max())}")
    require(counts["placed"] == counts["unplaced"]
            and counts["placed"]["quant_matmul"] > 0
            and counts["placed"]["packed_decode_attention"] > 0,
            f"moe sharding: drip launches placed {counts['placed']} vs "
            f"unplaced {counts['unplaced']}")
    ms = {}
    for name, key in (("unplaced", "unplaced"), ("placed", "placed"),
                      ("placed_again", "placed"),
                      ("unplaced_again", "unplaced")):
        ms[name] = host_ms(steps[key], iters=10)
    del cm, placed
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "slots": B, "steps": spec["steps"],
            "bitwise": True, "compile_s": info["compile_s"],
            "policies": info["policies"], "decode_step_ms": ms,
            "launches": {k: v for k, v in counts["placed"].items() if v}}


def moe_sharding_local(dev):
    """(c) the leg's local function (``blocks.moe_slice``) of each rank of
    (data, model) (2, 2) and (1, 4), in one process, on olmoe-1b-7b's
    full-width layer: rank (i, j) routes all the tokens and runs capacity
    rows ``sharded.moe_rows(C, d, i)`` of every expert on ``Fe`` columns
    ``j·Fe/m ..``; the ranks' f32 parts summed in rank order, cast to bf16,
    within one bf16 step of the unsharded ``moe_apply``, every rank's
    keep mask the unsharded routing's."""
    from repro_torch.configs import get_config
    from repro_torch.core import sharded
    from repro_torch.models import blocks
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config(MOE_SHARD_TRAIN["arch"]),
                              n_layers=1)
    p = tree_map(lambda t: t[0], init_params(cfg, seed=0, device=dev)[
        "blocks"]["moe"])
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_expert
    w = (p["router"]["w"], p["eg"]["w"], p["eu"]["w"], p["ed"]["w"])
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for B, T in MOE_SHARD_ROWS:
        x = torch.randn((B, T, D), generator=gen, device=dev).to(
            torch.bfloat16)
        xt = x.reshape(B * T, D)
        ref = blocks.moe_apply(p, cfg, x).reshape(B * T, D)
        keep = blocks.moe_route(p, cfg, xt)[3]
        C = blocks.moe_capacity(cfg, B * T)
        for d, m in MOE_SHARD_MESHES:
            f = Fe // m
            total = torch.zeros((B * T, D), dtype=torch.float32, device=dev)
            ranks = []
            for i in range(d):
                lo, rows = sharded.moe_rows(C, d, i)
                for j in range(m):
                    cols = slice(j * f, (j + 1) * f)
                    y, k = blocks.moe_slice(
                        cfg, xt, w[0], w[1][..., cols], w[2][..., cols],
                        w[3][:, cols], lo, rows)
                    require(torch.equal(k, keep),
                            f"moe sharding: rank ({i}, {j}) of ({d}, {m}) "
                            "kept other entries than the unsharded routing")
                    total += y
                    ranks.append({"rank": [i, j], "capacity_rows": [
                        lo, min(C, lo + rows)], "product_rows": E * rows,
                        "fe_columns": f})
            got = total.to(torch.bfloat16)
            err = float((got.float() - ref.float()).abs().max())
            tol = tol_for(torch.bfloat16, ref.float())
            require(err <= tol,
                    f"moe sharding: ({d}, {m}) ranks' sum on {B} x {T} "
                    f"tokens: {err} > one bf16 step {tol}")
            out[f"{B}x{T}@{d}x{m}"] = {
                "C": C, "err": err, "tol": tol, "keep_equal": True,
                "dropped": int((~keep).sum()),
                "bitwise": bool(torch.equal(got, ref)), "ranks": ranks}
    return out


def moe_sharding(dev, report, dryrun):
    """The MoE sharding phase: (a) the placed train step and (b) the placed
    drip on NCCL at world 1, (c) the leg's local function rank by rank,
    (d) olmoe-1b-7b's ``decode_32k`` dry-run cell (run beside the earlier
    phases, joined in ``seq_cache``)."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        mesh = start_nccl(dev, store)
        try:
            res = {"train": moe_sharding_train(dev, mesh),
                   "drip": moe_sharding_drip(dev, mesh)}
        finally:
            dist.destroy_process_group()
    res["local"] = moe_sharding_local(dev)
    res["dryrun"] = dryrun["olmoe-1b-7b/decode_32k"]
    res["seconds"] = time.perf_counter() - t0
    report["moe_sharding"] = res
    return res


# ------------------------------------------------------------ ssm sharding

# the SSM and hybrid legs' phase: (arch, layers, batch, seq) trained for 2
# steps in 2 micro-batches — one super-block of each at full width (the
# sLSTM's host-bound step loop holds xlstm-1.3b to T 512) — and their drips
# at one super-block, 8 slots, 4 steps
SSM_SHARD_TRAIN = (("xlstm-1.3b", 8, 2, 512), ("zamba2-2.7b", 6, 2, 1024))
SSM_SHARD_MICRO = 2
SSM_SHARD_STEPS = 2
SSM_SHARD_DRIP = dict(slots=8, steps=4)
SSM_SHARD_MODEL_AXES = (4, 16)
# the local functions' inputs: 2 rows of 512 positions (two chunks), and
# one recurrent step of 8 slots on a filled state
SSM_SHARD_ROWS = ((2, 512), (8, 1))
SSM_SHARD_TOL = 1e-5


def ssm_sharding_train(dev, mesh):
    """(a) each family's train step through ``TrainRunner``, unplaced and
    then placed from the same state, each run's counts set to 0 just
    before it and read just after: losses and gradient norms bit for bit,
    the same launches by route (zamba2-2.7b's flash forward and remat
    recompute on the tensor cores; xlstm-1.3b launches none)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.models.model import init_params, n_superblocks
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.runtime import RunnerConfig, TrainRunner
    from repro_torch.train.trainer import make_train_step

    out = {}
    for arch, layers, B, T in SSM_SHARD_TRAIN:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        params = init_params(cfg, seed=0, device=dev)
        opt_cfg = AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype)
        opt = adamw_init(params, opt_cfg)
        toks, labels = token_batch(0, B, T, cfg.vocab)
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        rc = RunnerConfig(total_steps=SSM_SHARD_STEPS, ckpt_every=0,
                          log_every=1)
        placed, _, _ = sh.shard_params(params, cfg, mesh)
        runs = {"unplaced": (params, opt, batch),
                "placed": (placed, sh.shard_opt_state(opt, params, cfg, mesh),
                           sh.shard_batch(batch, cfg, mesh))}
        logs, counts = {}, {}
        for name, (p, o, b) in runs.items():
            runner = TrainRunner(make_train_step(cfg, opt_cfg,
                                                 SSM_SHARD_MICRO),
                                 lambda i, b=b: b, rc)
            torch.cuda.synchronize()
            reset_counts()
            runner.run(p, o)
            torch.cuda.synchronize()
            counts[name] = read_counts()
            logs[name] = runner.metrics_log
            del runner
        for a, b in zip(logs["unplaced"], logs["placed"]):
            for k in ("loss", "grad_norm"):
                require(math.isfinite(b[k]) and a[k] == b[k],
                        f"ssm sharding: {arch} placed train step {k} {b[k]} "
                        f"vs unplaced {a[k]}: not bit for bit")
        n_attn = n_superblocks(cfg) if cfg.family == "hybrid" else 0
        want = n_attn * 2 * SSM_SHARD_MICRO * SSM_SHARD_STEPS
        require(counts["placed"] == counts["unplaced"]
                and counts["placed"][FLASH_TC] == want
                and counts["placed"]["flash_attention"] == want,
                f"ssm sharding: {arch} train launches placed "
                f"{counts['placed']} vs unplaced {counts['unplaced']}, "
                f"expected {want} on the tensor cores")
        out[arch] = {
            "layers": layers, "batch": B, "seq": T,
            "n_micro": SSM_SHARD_MICRO, "steps": SSM_SHARD_STEPS,
            "losses": {k: [m["loss"] for m in v] for k, v in logs.items()},
            "grad_norms": {k: [m["grad_norm"] for m in v]
                           for k, v in logs.items()},
            "step_ms": {k: [m["step_s"] * 1e3 for m in v]
                        for k, v in logs.items()},
            "bitwise": True,
            "launches": {k: v for k, v in counts["placed"].items() if v}}
        del params, opt, placed, runs
        torch.cuda.empty_cache()
    return out


def ssm_sharding_drip(dev, mesh):
    """(b) zamba2-2.7b at one super-block compiled as ``family_model``
    compiles it, and xlstm-1.3b at one with int8 mLSTM leaves: 8 slots
    dripped 4 steps on the int4x2 cache, unplaced and placed, each run's
    counts set to 0 just before it and read just after: the logits equal
    bit for bit at every step, the same launches by route; both steps'
    eager host ms in turns."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_sparse import CompressedModel
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm

    spec = SSM_SHARD_DRIP
    out = {}
    for arch, layers in (("zamba2-2.7b", 6), ("xlstm-1.3b", 8)):
        if arch == "zamba2-2.7b":
            cm, cfg, info = family_model(arch, dev, layers)
        else:
            cfg = dataclasses.replace(get_config(arch), linear_mode="int8",
                                      n_layers=layers)
            cm = CompressedModel(params=tm.init_params(cfg, seed=0,
                                                       device=dev),
                                 patterns={}, report=[])
            info = {"policies": {"blocks/mlstm": "int8 (synthetic)"}}
        B = spec["slots"]
        toks = torch.from_numpy(np.stack([p[:spec["steps"]] for p in
                                          serve_prompts(cfg)[:B]])).to(dev)
        placed, _, _ = sh.shard_params(cm.params, cfg, mesh, cm.patterns)

        def run(p, place):
            cache = tm.init_cache(cfg, B, 256, "int4x2", device=dev)
            if place:
                cache = sh.shard_cache(cache, cfg, mesh, "int4x2")
            put = (lambda t: sh.shard_batch({"tokens": t}, cfg,
                                            mesh)["tokens"]) \
                if place else (lambda t: t)
            logits = []
            for i in range(spec["steps"]):
                lg, cache = tm.decode_step(p, cfg, cache,
                                           put(toks[:, i:i + 1]),
                                           patterns=cm.patterns)
                logits.append(lg.full_tensor() if place else lg)
            step = lambda: tm.decode_step(p, cfg, cache,  # noqa: E731
                                          put(toks[:, -1:]),
                                          patterns=cm.patterns)
            return logits, step

        logits, steps, counts = {}, {}, {}
        with torch.no_grad():
            for name, p in (("unplaced", cm.params), ("placed", placed)):
                torch.cuda.synchronize()
                reset_counts()
                logits[name], steps[name] = run(p, name == "placed")
                torch.cuda.synchronize()
                counts[name] = read_counts()
            for i, (a, b) in enumerate(zip(logits["unplaced"],
                                           logits["placed"])):
                require(bool(torch.isfinite(a).all()) and torch.equal(a, b),
                        f"ssm sharding: {arch} placed drip step {i} logits "
                        f"differ from the unplaced step's by "
                        f"{float((a.float() - b.float()).abs().max())}")
            require(counts["placed"] == counts["unplaced"]
                    and counts["placed"]["quant_matmul"] > 0,
                    f"ssm sharding: {arch} drip launches placed "
                    f"{counts['placed']} vs unplaced {counts['unplaced']}")
            ms = {}
            for name, key in (("unplaced", "unplaced"), ("placed", "placed"),
                              ("placed_again", "placed"),
                              ("unplaced_again", "unplaced")):
                ms[name] = host_ms(steps[key], iters=5)
        out[arch] = {"layers": cfg.n_layers, "slots": B,
                     "steps": spec["steps"], "bitwise": True,
                     "policies": info["policies"], "decode_step_ms": ms,
                     "launches": {k: v for k, v in counts["placed"].items()
                                  if v}}
        del cm, placed, steps
        torch.cuda.empty_cache()
    return out


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def ssm_local_mamba(dev, gen):
    """(c) zamba2-2.7b's Mamba2 layer at full width: each rank's part of
    the leg at model axes 4 and 16 (``ssm.mamba_layout``, the conv state
    cut as the rules cut it), through the leg's own local function
    (``ssm.mamba_part``), handed the columns its all-to-alls deliver
    (``take.cols`` of ``win``'s output and of the conv state); the parts'
    outputs concatenated in rank order against the unsharded block; for
    the recurrent step also each rank's S heads and the conv-state shard
    that it writes back."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("zamba2-2.7b")
    p = ssm.mamba2_init(gen, cfg)
    N, P = cfg.ssm_state, ssm.MAMBA_HEADDIM
    H = cfg.d_inner // P
    dxbc = cfg.d_inner + 2 * N
    leaves = (p["conv"], p["dt_bias"], p["a_log"], p["d_skip"])
    out = {}
    for B, T in SSM_SHARD_ROWS:
        x = (torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
             ).to(torch.bfloat16)
        zxd = ssm.linear_apply(p["win"], x)
        cs = S = None
        decode = T == 1
        if decode:
            cs = torch.randn((B, 3, dxbc), generator=gen, device=dev)
            S = torch.randn((B, H, P, N), generator=gen, device=dev) * 0.1
        S_ref = None if S is None else S.clone()
        ref, new_state = ssm._mamba_mix(zxd, *leaves, N, P, conv_state=cs,
                                        S=S_ref)
        for n in SSM_SHARD_MODEL_AXES:
            parts, s_err, ranks = [], 0.0, []
            for r in range(n):
                lay = ssm.mamba_layout(H, P, N, n, r, True, decode, dev)
                h0, Hl, Pl = lay["h0"], lay["Hl"], lay["Pl"]
                require(Pl == P, f"ssm sharding: model {n} cuts a head")
                hs = slice(h0, h0 + Hl)
                s0, s1 = lay["state"]
                S_r = conv_r = cs_r = None
                if decode:
                    S_r = S[:, hs].clone()
                    conv_r = cs[..., s0:s1].clone()
                    cs_r = cs.index_select(-1, lay["conv_take"].cols)
                y = ssm.mamba_part(
                    zxd.index_select(-1, lay["take"].cols), *leaves, lay, N,
                    P, conv_state=cs_r, conv_out=conv_r, S=S_r, S_own=True)
                parts.append(y)
                if decode:
                    s_err = max(s_err, rel_err(S_r, S_ref[:, hs]))
                    require(torch.equal(conv_r, new_state[..., s0:s1]),
                            f"ssm sharding: Mamba2 rank {r} of {n}'s conv "
                            "state is not the unsharded one's")
                ranks.append({"rank": r, "channels": [lay["c0"], lay["c1"]],
                              "heads": [h0, h0 + Hl], "head_width": Pl,
                              "columns_taken": int(len(lay["take"].cols))})
            err = rel_err(torch.cat(parts, -1), ref)
            require(err <= SSM_SHARD_TOL and s_err <= SSM_SHARD_TOL,
                    f"ssm sharding: Mamba2 parts at model {n} on {B} x {T}: "
                    f"{err} / state {s_err} > {SSM_SHARD_TOL} of the "
                    "largest value")
            out[f"{B}x{T}@{n}"] = {"rel_err": err, "state_rel_err": s_err,
                                   "ranks": ranks[:2] + ranks[-1:]}
    return out


def ssm_local_mlstm(dev, gen):
    """(c) xlstm-1.3b's mLSTM layer at full width: each rank's key slice
    (``ssm.mlstm_layout``) through ``ssm.mlstm_state_part``, the parts
    summed in rank order in f32 (the all-reduces and the reduce-scatter),
    then each rank's columns through ``ssm.mlstm_out_part``, at model axes
    4 and 16; the columns concatenated against the unsharded block
    (``ssm._mlstm_mix``); for the recurrent step also each rank's key rows
    of S and n."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config("xlstm-1.3b")
    p = ssm.mlstm_init(gen, cfg)
    H, di = cfg.n_heads, cfg.d_inner
    P = di // H
    out = {}
    for B, T in SSM_SHARD_ROWS:
        x = (torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
             ).to(torch.bfloat16)
        q, k, v, gif, og = (ssm.linear_apply(p[n], x) for n in
                            ("wq", "wk", "wv", "wif", "wog"))
        S = n_ = None
        if T == 1:
            S = torch.randn((B, H, P, P), generator=gen, device=dev) * 0.01
            n_ = torch.randn((B, H, P), generator=gen, device=dev)
        S_ref = None if S is None else S.clone()
        n_ref = None if n_ is None else n_.clone()
        ref = ssm._mlstm_mix(q, k, v, gif, og, H, S_ref, n_ref)
        for n in SSM_SHARD_MODEL_AXES:
            sums, s_err = None, 0.0
            for r in range(n):
                lay = ssm.mlstm_layout(H, P, n, r, dev)
                want, p0, p1 = lay["take"].cols, lay["p0"], lay["p1"]
                st = None if S is None else (S[:, :, p0:p1].clone(),
                                             n_[:, :, p0:p1].clone())
                part = ssm.mlstm_state_part(q[..., want], k[..., want], v,
                                            gif, H, P, *(st or ()))
                sums = list(part) if sums is None else [
                    None if a is None else a + b for a, b in zip(sums, part)]
                if st is not None:
                    s_err = max(s_err, rel_err(st[0], S_ref[:, :, p0:p1]),
                                rel_err(st[1], n_ref[:, :, p0:p1]))
            scores, inter, innr = sums
            cols = []
            for r in range(n):
                lay = ssm.mlstm_layout(H, P, n, r, dev)
                c0, c1 = lay["c0"], lay["c1"]
                cols.append(ssm.mlstm_out_part(
                    scores, inter[..., c0:c1], innr, v[..., c0:c1], gif,
                    og[..., c0:c1], lay["h0"], P))
            err = rel_err(torch.cat(cols, -1), ref)
            require(err <= SSM_SHARD_TOL and s_err <= SSM_SHARD_TOL,
                    f"ssm sharding: mLSTM parts at model {n} on {B} x {T}: "
                    f"{err} / state {s_err} > {SSM_SHARD_TOL} of the "
                    "largest value")
            out[f"{B}x{T}@{n}"] = {"rel_err": err, "state_rel_err": s_err,
                                   "key_rows": P // n, "columns": di // n}
    return out


def ssm_sharding(dev, report, dryrun):
    """The SSM sharding phase: (a) the placed train steps and (b) the
    placed drips on NCCL at world 1, (c) the legs' local functions rank by
    rank, (d) xlstm-1.3b's and zamba2-2.7b's ``decode_32k`` dry-run cells
    (run beside the earlier phases, joined in ``seq_cache``)."""
    import tempfile

    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        mesh = start_nccl(dev, store)
        try:
            res = {"train": ssm_sharding_train(dev, mesh),
                   "drip": ssm_sharding_drip(dev, mesh)}
        finally:
            dist.destroy_process_group()
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        res["local"] = {"mamba2": ssm_local_mamba(dev, gen),
                        "mlstm": ssm_local_mlstm(dev, gen)}
    torch.cuda.empty_cache()
    res["dryrun"] = {k: dryrun[f"{k}/decode_32k"]
                     for k in ("xlstm-1.3b", "zamba2-2.7b")}
    res["seconds"] = time.perf_counter() - t0
    report["ssm_sharding"] = res
    return res


# ---------------------------------------------------------------- autotune

TUNE_MS = (8, 512)   # the engine's 8 decode rows; a 512-row prefill
SERVE_PAIR_KEYS = ("tokens_per_s", "decode_step_ms_p50",
                   "prefill_step_ms_p50", "ttft_ms_p50")


def tuned_rows(table):
    """Per tuned key of the last tuning run: the rule's plan and median
    time (the first candidate timed), the winner's, its roofline seed and
    every candidate timed (each held against its plain version first)."""
    out = {}
    for log in table.log:
        if log.get("cached"):
            continue
        cands = log["candidates"]   # the attention read's rule: bt 64
        rule = next((c for c in cands if c.get("bt") == 64), cands[0])
        won = table.get(log["key"])
        out[log["key"]] = {
            "rule": [rule["route"], rule.get("plan", rule.get("bt")),
                     rule["median_us"], rule["spread_us"]],
            "tuned": [won.route, won.plan if won.bt is None else won.bt,
                      won.measured_us],
            "predicted_us": won.predicted_us,
            "candidates": log["candidates"]}
    return out


def autotune(cm, cfg, dev, report, tokens):
    """The autotune phase on the serve phase's compile: tune every leaf at
    M = 8 and 512 (a new table under ``chiprun_out/``: no stale cache),
    each candidate held against its plain version before it is timed; a
    second run times nothing; tune the attention read's kv tile at the
    engine's shape; serve the 16 requests on the tuned and the untuned
    engine in turns, captured (every tuned matmul launch on its entry's
    plan: no misses; the tokens the untuned engine's, or tied at the
    first difference; a captured decode step and prefill chunk bit for bit
    their eager steps); profile the tuned decode step beside the untuned
    one, in turns."""
    from repro_torch.core import autotune as ta
    from repro_torch.core.dispatch import DispatchConfig

    path = ROOT / "chiprun_out" / "autotune_torch.json"
    path.unlink(missing_ok=True)
    out = report["autotune"] = {}
    t0 = time.perf_counter()
    table = ta.autotune_model(cm, M=TUNE_MS, x_dtype=torch.bfloat16,
                              path=str(path))
    out["tune_s"] = time.perf_counter() - t0
    out["keys"] = tuned_rows(table)
    out["n_timings"] = table.n_timings()
    require(out["n_timings"] > 0 and out["keys"],
            f"autotune timed nothing: {table.log}")
    require(all(e.use_kernel for e in table.entries.values()),
            "a tuned entry on the card names the plain version")
    t0 = time.perf_counter()
    again = ta.autotune_model(cm, M=TUNE_MS, x_dtype=torch.bfloat16,
                              path=str(path))
    out["retune_s"] = time.perf_counter() - t0
    require(again.n_timings() == 0 and again.entries == table.entries,
            f"the second tuning run timed {again.n_timings()} candidates")
    t0 = time.perf_counter()
    attn = ta.autotune_attn(B=8, T=512, H=cfg.n_heads, Hkv=cfg.n_kv_heads,
                            Dh=cfg.head_dim, x_dtype=torch.bfloat16,
                            table=again, device=dev)
    out["attn_s"] = time.perf_counter() - t0
    out["attn"] = tuned_rows(again)
    require(attn.use_kernel and attn.bt in ta.ATTN_BTS, f"attn entry {attn}")
    out["attn_rule_row"] = kv_tile_row(cfg, dev)

    prompts = serve_prompts(cfg)
    # untuned and tuned engines in turns (untuned, tuned, tuned, untuned):
    # the serving numbers compared within this call; the first tuned run
    # is counted and checked
    pairs = {}
    for name in ("untuned", "tuned", "tuned_2", "untuned_2"):
        kw = {"autotune": again} if name.startswith("tuned") else {}
        e, r, c = serve_run(cm, cfg, dev, prompts, count=name == "tuned",
                            **kw)
        pairs[name] = {k: r[k] for k in SERVE_PAIR_KEYS}
        if name == "tuned":
            eng, run, counts = e, r, c
        else:
            require(r["tokens"] == (run["tokens"] if kw else tokens),
                    f"the {name} engine served other tokens than its twin")
            del e
    out["serve_pairs"] = pairs
    require(eng._bt == attn.bt and eng.dispatch.m_bucket == 8,
            f"the tuned engine pinned bt {eng._bt}, m_bucket "
            f"{eng.dispatch.m_bucket}")
    hits = sum(counts[k] for k in TUNED_HITS)
    misses = sum(counts[k] for k in TUNED_MISSES)
    matmuls = counts["quant_matmul"] + counts["block_sparse_matmul"]
    require(hits > 0 and misses == 0 and hits == matmuls,
            f"tuned engine: {hits} tuned hits, {misses} misses, {matmuls} "
            f"matmul launches")
    named = {"quant": set(), "sparse": set()}
    for key, e in again.entries.items():
        kind = key.split(":")[0]
        if kind in named and key.split(":")[1] == "M8":
            named[kind].add(e.route)
    off = {c: counts[c] for (kind, route), c in ROUTE_COUNTER.items()
           if route not in named[kind] and counts[c]}
    require(not off, f"tuned engine: launches off the routes its entries "
                     f"name ({named}): {off}")
    require(counts[PDA_SINGLE if attn.route == "split" else PDA_SPLIT] == 0,
            f"tuned engine: attention reads off the {attn.route} route")
    got = run.pop("tokens")
    tuned_disp = DispatchConfig(tuned=again, m_bucket=8)
    run["divergences"] = read_divergences(
        cm, cfg, dev, prompts, tokens, got,
        reads={"untuned": dict(bt=64),
               "tuned": dict(bt=attn.bt, dispatch=tuned_disp)},
        what="tuned engine")
    run["launches"] = {k: v for k, v in counts.items() if v}
    out["serve"] = run
    out["capture_check"] = capture_check(eng, cfg)
    del eng
    out["decode_profile"] = {}
    for name in ("untuned", "tuned", "tuned_2", "untuned_2"):
        kw = {"autotune": again} if name.startswith("tuned") else {}
        out["decode_profile"][name] = profile_step(cm, cfg, dev, "decode",
                                                   True, steps=20, **kw)
    return out


def kv_tile_row(cfg, dev, B=8, T=512, bt=64):
    """The kv tile's tuning shape on the rule's tile (``autotune_attn``:
    B slots of one query row over every extent 32, 64, ... T, full), the
    kernel's, plain version's, SDPA's and the bound's times each summed over
    the extents, as the tuner sums its candidates'."""
    extents = [32 * 2 ** i for i in range(int(math.log2(T // 32)) + 1)]
    rows = [zoo_attention_row(cfg, dev, B, 1, np.full((B, 1), e), T=e,
                              bt=bt) for e in extents]
    out = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out.update(extents=extents, routes=sorted({r["route"] for r in rows}),
               max_abs_err=max(r["max_abs_err"] for r in rows),
               bound_by=sorted({r["bound_by"] for r in rows}))
    return out


def serve_prompts(cfg):
    """The serve phase's 16 requests: 64–256 prompt tokens, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
            for n in rng.integers(64, 257, size=16)]


# warm-up requests that reach every bucket the measured requests use:
# prefill chunks up to 512 rows, decode rows from 61 to 260
WARM = ((300, 2), (60, 200))


def serve_engine(cm, cfg, dev, **kw):
    from repro_torch.serve.engine import ServeEngine
    kw = {"kv_cache": "int4x2", **kw}
    return ServeEngine(cm, cfg, batch_slots=8, max_len=512, prefill_chunk=16,
                       device=dev, **kw)


def serve_run(cm, cfg, dev, prompts, count=False, warm=WARM, **kw):
    """Serve ``prompts`` (32 new tokens each) on a new engine, after warm-up
    requests ``warm`` ((prompt tokens, new tokens) pairs; by default ones
    that reach every bucket); the counts are set to 0 just before the
    measured requests and read just after.  Returns the engine, its
    numbers and tokens, and the counts (None unless ``count``)."""
    from repro_torch.serve.engine import Request

    eng = serve_engine(cm, cfg, dev, **kw)
    rng = np.random.default_rng(1)
    for i, (n, new) in enumerate(warm):
        eng.submit(Request(uid=-1 - i, prompt=rng.integers(
            0, cfg.vocab, n).astype(np.int32), max_new_tokens=new))
    eng.run()
    torch.cuda.synchronize()
    st0, tok0 = eng.stats(), eng.tokens_processed()
    if count:
        reset_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    done = sorted(eng.run(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts() if count else None
    st = eng.stats()
    dec = st["decode_ms"][len(st0["decode_ms"]):]
    pre = st["prefill_ms"][len(st0["prefill_ms"]):]
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in done]
    return eng, {
        "capture": eng.capture, "kv_cache": eng.kv_cache,
        "packed_read": eng.packed_read, "wall_s": wall,
        "tokens_per_s": (eng.tokens_processed() - tok0) / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "decode_step_ms_p50": pct(dec, 50),
        "prefill_step_ms_p50": pct(pre, 50),
        "decode_steps": len(dec), "prefill_steps": len(pre),
        "graphs": st["graphs"], "capture_s": st["capture_s"],
        "graph_pool_bytes": st["graph_pool_bytes"],
        "captures_after_warmup": st["graphs"] - st0["graphs"],
        "cache_bytes": eng.cache_bytes(),
        "tokens": [r.out for r in done]}, counts


def cache_length(cache):
    """The attention cache's ``length`` leaf (the hybrid's under
    ``"attn"``), or None for a cache with no attention."""
    if "length" in cache:
        return cache["length"]
    return cache["attn"]["length"] if "attn" in cache else None


def capture_check(eng, cfg):
    """One captured step of each phase the engine captured (a decode step
    and a prefill chunk; a drip step), at its largest bucket, replayed from
    a saved cache state, against the same step run eagerly from that state:
    logits and cache bit for bit, and the same launches."""
    out = {}
    cases = {}
    for ph, tb in eng._graphs:
        cases[ph] = max(tb, cases.get(ph, 0))
    rng = np.random.default_rng(3)
    eng._fill("tok", rng.integers(0, cfg.vocab, (eng.slots, 1)))
    eng._fill("act", np.ones(eng.slots, np.int32))
    eng._fill("ptok", rng.integers(0, cfg.vocab, (1, eng.prefill_chunk)))
    eng._fill("nv", eng.prefill_chunk)
    eng._fill("slot", 3)
    length = cache_length(eng.cache)
    if length is not None:
        length.fill_(cases.get("decode", max(cases.values())) // 2)
    saved = tree_map(torch.clone, eng.cache)
    restore = lambda: tree_map(lambda v, s: v.copy_(s), eng.cache, saved)
    for phase, tb in cases.items():
        fn = eng.phase_fn(phase)
        torch.cuda.synchronize()
        reset_counts()
        eager = fn(tb).clone()
        torch.cuda.synchronize()
        eager_counts = read_counts()
        eager_cache = tree_map(torch.clone, eng.cache)
        restore()
        reset_counts()
        replay = eng._step_logits(phase, tb).clone()
        torch.cuda.synchronize()
        replay_counts = read_counts()
        same_cache = all(torch.equal(v, e) for v, e in zip(
            tree_leaves(eng.cache), tree_leaves(eager_cache)))
        diff = float((replay.float() - eager.float()).abs().max())
        require(torch.equal(replay, eager) and same_cache,
                f"captured {phase} step (bucket {tb}) differs from the eager "
                f"step: logits max abs diff {diff}, cache equal {same_cache}")
        require(replay_counts == eager_counts,
                f"captured {phase} step launched {replay_counts}, the eager "
                f"step {eager_counts}")
        restore()
        out[phase] = {"bucket": tb, "bitwise_equal": True,
                      "launches": {k: n for k, n in replay_counts.items()
                                   if n}}
    return out


READS = {"fused": dict(bt=64, packed_read="fused"),
         "unpack": dict(bt=64, packed_read="unpack")}


def read_divergences(cm, cfg, dev, prompts, ref_tokens, tokens,
                     reads=READS, what="unpack read"):
    """Requests whose tokens differ from the reference run's (by default
    the "unpack" read against the fused one): at the first differing
    token, each of ``reads`` (name -> step keywords, the reference run's
    first) is replayed teacher-forced on one slot (the reference tokens
    before it) and must score the two candidates within
    ``TWIN_TOL["int4x2"]`` of the largest logit — a tie.  Returns one entry
    per differing request."""
    from repro_torch.models.model import decode_step, init_cache, prefill_step

    tol = TWIN_TOL["int4x2"]
    out = []
    for uid, (a, b) in enumerate(zip(ref_tokens, tokens)):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        prompt = prompts[uid]
        last = {}
        for read, kw in reads.items():
            cache = init_cache(cfg, 1, 512, kv_cache="int4x2", device=dev)
            for pos in range(0, len(prompt), 16):
                chunk = np.zeros((1, 16), np.int32)
                n = min(16, len(prompt) - pos)
                chunk[0, :n] = prompt[pos:pos + n]
                logits = prefill_step(
                    cm.params, cfg, cache, torch.as_tensor(chunk, device=dev),
                    patterns=cm.patterns, n_valid=torch.tensor(
                        [n], dtype=torch.int32, device=dev),
                    **kw)[0][0, n - 1]
            for tok in a[:i]:
                logits = decode_step(
                    cm.params, cfg, cache, torch.tensor([[tok]], device=dev),
                    patterns=cm.patterns, **kw)[0][0, 0]
            last[read] = logits.float()
        top = float(next(iter(last.values())).abs().max())
        gaps = [abs(float(v[a[i]] - v[b[i]])) / top for v in last.values()]
        entry = {"uid": uid, "step": i, "tokens": [a[i], b[i]],
                 "gaps": gaps}
        require(max(gaps) <= tol, f"{what}: request {uid} step {i} "
                                  f"is not a tie: {entry}")
        out.append(entry)
    return out


def profile_step(cm, cfg, dev, phase: str, capture: bool, steps: int = 5,
                 share=(), **kw):
    """Where a serving step's time goes: the engine's step at 8 slots of
    200 cached rows (int4x2 cache, bucket 256; a prefill chunk of 16 rows
    into slot 0; the SSM family's one bucket, its states as they run), each
    ending as the engine's does with its logits' argmax
    on the host: wall-clock per step beside the device time of the kernels
    it launches, from torch.profiler (CUPTI); captured or eager.  ``kw``
    goes to the engine (``autotune=table``); ``share``: name parts whose
    kernels' share of the device busy time is reported as well."""
    from torch.profiler import ProfilerActivity, profile

    eng = serve_engine(cm, cfg, dev, capture=capture, **kw)
    eng._fill("tok", np.zeros((8, 1), np.int32))
    eng._fill("act", np.ones(8, np.int32))
    eng._fill("ptok", np.arange(16, dtype=np.int32)[None])
    eng._fill("nv", 16)
    eng._fill("slot", 0)
    length = cache_length(eng.cache)
    tb = 0 if length is None else 256

    def step():
        logits = eng._step_logits(phase, tb)
        last = logits[0] if phase == "prefill" else logits[:, 0]
        torch.argmax(last, dim=-1).cpu()
        if length is not None:
            length.fill_(200)

    if length is not None:
        length.fill_(200)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    dev_us = {}  # device kernels only: CPU-side ops would count them twice
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[e.key] = e.self_device_time_total / steps
    busy_ms = sum(dev_us.values()) / 1e3
    out = {"captured": eng.capture, "graphs": eng.stats()["graphs"],
           "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms if dev_us else None,
           "device_idle_share": 1 - busy_ms / wall_ms if dev_us else None,
           "top_device_us_per_step": top_device_us(dev_us)}
    for part in share:
        us = sum(v for k, v in dev_us.items() if part in k)
        out[f"{part}_device_us_per_step"] = us
        out[f"{part}_share"] = us / 1e3 / busy_ms if dev_us else None
    return out


def pdl_edges(cm, cfg, dev):
    """Whether capture keeps the programmatic dependent launches (the
    thin-M reduce passes, the split attention's combine pass) as
    programmatic graph edges: one decode step captured with its graph kept,
    its edges counted by type through libcuda's cuGraphGetEdges_v2.
    None where this torch or CUDA version cannot show the graph."""
    import ctypes

    eng = serve_engine(cm, cfg, dev)
    eng.cache["length"].fill_(200)
    eng._fill("act", np.ones(8, np.int32))
    s = eng._stream              # the engine's capture stream
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        eng._decode_fn(256)      # libraries and handles, before capture
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError as e:
        return {"edges": None, "why": f"torch {torch.__version__}: {e}"}
    before = read_counts()
    with torch.cuda.graph(graph, stream=s):
        eng._decode_fn(256)
    after = read_counts()
    pdl_launches = sum(after[k] - before[k]
                       for k in (QMM_THIN, BSM_THIN, PDA_SPLIT))
    reset_counts()
    try:
        fn = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    except (OSError, AttributeError) as e:
        return {"edges": None, "why": str(e)}
    fn.restype = ctypes.c_int
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = fn(raw, None, None, None, ctypes.byref(n))
    require(err == 0, f"cuGraphGetEdges_v2: error {err}")
    nodes = (ctypes.c_void_p * n.value)()
    nodes_to = (ctypes.c_void_p * n.value)()
    data = (ctypes.c_uint8 * (8 * n.value))()
    err = fn(raw, nodes, nodes_to, data, ctypes.byref(n))
    require(err == 0, f"cuGraphGetEdges_v2: error {err}")
    by_type = {}
    for i in range(n.value):   # CUgraphEdgeData: from_port, to_port, type
        kind = {0: "default", 1: "programmatic"}.get(data[8 * i + 2],
                                                      str(data[8 * i + 2]))
        key = f"{kind}/from_port{data[8 * i]}"
        by_type[key] = by_type.get(key, 0) + 1
    return {"edges": n.value, "by_type": by_type,
            "pdl_launch_pairs": pdl_launches}


def compiled_forward(cm, cfg, dev):
    """The full-sequence forward of the compiled model (B = 1, T = 512):
    its linears reach block_sparse_matmul and quant_matmul at M = 512 on
    their tensor-core routes, its attention the flash kernel; logits held
    against ``dispatch="twin"`` within the serving path's float tolerance;
    then its wall time, device busy time and idle share."""
    from repro_torch.models.model import forward

    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 512)), dtype=torch.int32, device=dev)
    with torch.no_grad():
        forward(cm.params, cfg, {"tokens": toks}, patterns=cm.patterns)
        torch.cuda.synchronize()
        reset_counts()
        y = forward(cm.params, cfg, {"tokens": toks}, patterns=cm.patterns)
        torch.cuda.synchronize()
        counts = read_counts()
        yt = forward(cm.params, cfg, {"tokens": toks}, patterns=cm.patterns,
                     dispatch="twin")
    want = {"block_sparse_matmul": 3 * cfg.n_layers,
            "quant_matmul": 4 * cfg.n_layers, "flash_attention": cfg.n_layers,
            QMM_TC: 4 * cfg.n_layers, QMM_THIN: 0, QMM_TILED: 0,
            BSM_TC: 3 * cfg.n_layers, BSM_THIN: 0, BSM_TILED: 0,
            FLASH_TC: cfg.n_layers, FLASH_CC: 0}
    require(all(counts[k] == n for k, n in want.items()),
            f"compiled forward launched {counts}, expected {want}")
    y, yt = y.float(), yt.float()
    require(tuple(y.shape) == (1, 512, cfg.vocab) and
            bool(torch.isfinite(y).all()), "compiled forward: bad logits")
    top = float(yt.abs().max())
    rel = float((y - yt).abs().max()) / top
    tol = TWIN_TOL["float"]
    require(rel <= tol, f"compiled forward: kernel vs twin logits max rel "
                        f"err {rel} > {tol}")

    def fwd():
        with torch.no_grad():
            forward(cm.params, cfg, {"tokens": toks}, patterns=cm.patterns)

    prof = profile_forward(fwd)
    top_us = top_device_us(prof.pop("device_us_per_forward"))
    return {"launches": {k: counts[k] for k in want}, "max_rel_err": rel,
            "tol": tol, "largest_logit": top, **prof,
            "top_device_us_per_forward": top_us}


def twin_check(cm, cfg, dev, prompt, kv_cache, want=None, tol=None):
    """Kernel path vs plain versions on the card: one prefill chunk and 4
    greedy decode steps, teacher-forced with the kernel path's tokens.

    Logits must agree within ``tol`` (default ``TWIN_TOL[kv_cache]``,
    relative to the largest logit) and the greedy tokens must be equal,
    unless both paths score the two candidates within that tolerance of
    each other.  ``want`` is the launches by route a decode step must make
    (default: the serve phase's compile, every matmul on its thin-M route).
    """
    from repro_torch.models.model import decode_step, init_cache, prefill_step

    tol = TWIN_TOL[kv_cache] if tol is None else tol
    toks = torch.as_tensor(prompt[None], device=dev)
    caches = {m: init_cache(cfg, 1, 512, kv_cache=kv_cache, device=dev)
              for m in ("auto", "twin")}
    logits = {mode: prefill_step(cm.params, cfg, cache, toks,
                                 patterns=cm.patterns, dispatch=mode,
                                 t_bound=32, bt=64)[0]
              for mode, cache in caches.items()}
    steps, per_step = [], None
    for i in range(5):
        a, t = logits["auto"][0, -1].float(), logits["twin"][0, -1].float()
        require(bool(torch.isfinite(a).all() and torch.isfinite(t).all()),
                "non-finite logits")
        tk, tt = int(torch.argmax(a)), int(torch.argmax(t))
        top = float(t.abs().max())
        steps.append({
            "token": tk, "plain_token": tt,
            "rel_err": float((a - t).abs().max()) / top,
            "tie": tk != tt and all(
                abs(float(v[tk] - v[tt])) <= tol * top for v in (a, t)),
        })
        if i == 4:
            break
        nxt = torch.tensor([[tk]], device=dev)
        if i == 0:
            reset_counts()
        for mode, cache in caches.items():
            logits[mode] = decode_step(cm.params, cfg, cache, nxt,
                                       patterns=cm.patterns, dispatch=mode,
                                       t_bound=64, bt=64)[0]
        if i == 0:
            per_step = read_counts()
            L = cfg.n_layers
            want = dict(want or {QMM_THIN: 4 * L, QMM_TC: 0, QMM_TILED: 0,
                                 BSM_THIN: 3 * L, BSM_TC: 0, BSM_TILED: 0})
            if kv_cache != "float":
                want.update({PDA_SPLIT: 0, PDA_SINGLE: 0})
                want[pda_route(cfg, 1, 1, 64)] = L
            got = {k: per_step[k] for k in want}
            require(got == want, f"{kv_cache} cache: a decode step launched "
                                 f"{got} by route, expected {want}")
    max_rel = max(s_["rel_err"] for s_ in steps)
    require(max_rel <= tol, f"{kv_cache} cache: kernel vs plain logits max "
                            f"rel err {max_rel} > {tol}")
    for i, s_ in enumerate(steps):
        require(s_["token"] == s_["plain_token"] or s_["tie"],
                f"{kv_cache} cache: greedy token differs between kernel and "
                f"plain path at step {i}: {s_}")
    return {"steps": steps, "max_rel_err": max_rel, "tol": tol,
            "launches_per_decode_step": per_step}


# ------------------------------------------------------------------ LeNet


LENET_NAMES = ("conv1", "conv2", "fc1", "fc2", "fc3")
# policies of each configuration, and the launches one fused forward needs:
# both convs on the register-tiled route, none on the band route; the FC
# stack on the staged route, none on the stream route
LENET_CONFIGS = {
    "table1": ({n: "sparse" for n in LENET_NAMES},
               {"block_sparse_conv": 2, BSC_REG: 2, "fc_stack_matmul": 1,
                FCS_STAGED: 1}),
    "quant_conv": ({**{n: "sparse" for n in LENET_NAMES}, "conv1": "quant",
                    "conv2": "quant"},
                   {"quant_conv": 2, QCONV_REG: 2, "fc_stack_matmul": 1,
                    FCS_STAGED: 1}),
}


def host_ms(fn, iters: int = 20) -> float:
    """Wall-clock per call of ``fn`` (eager: host and device), after a
    synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def top_device_us(dev_us, n: int = 8):
    """The ``n`` largest device items, by name cut to 80 characters; names
    that share the cut add up (a dict keyed by the cut name would keep the
    last value under the first one's place)."""
    cut = {}
    for k, v in dev_us.items():
        cut[k[:80]] = cut.get(k[:80], 0.0) + v
    return dict(sorted(cut.items(), key=lambda kv: -kv[1])[:n])


def profile_forward(fwd, steps: int = 5, unit: str = "forward",
                    wall_ms=None):
    """Device busy time and idle share of one call of ``fwd`` (a forward,
    or a train step with ``unit="step"``), from torch.profiler's device
    activity alone (the host's op events would only slow its processing:
    xlstm-1.3b's forward has ~100k).  ``wall_ms``: the call's wall time
    measured by the caller, warm (then ``fwd`` runs only under the
    profiler)."""
    from torch.profiler import ProfilerActivity, profile

    if wall_ms is None:
        fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fwd()
        torch.cuda.synchronize()
    # the raw device events, summed by name: building key_averages' event
    # tree took over a minute for a train step of ~10^5 launches
    dev_us = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev_us[e.name()] = dev_us.get(e.name(), 0.0) \
                + e.duration_ns() / 1e3 / steps
    busy_ms = sum(dev_us.values()) / 1e3
    return {f"wall_ms_per_{unit}": wall_ms,
            f"device_busy_ms_per_{unit}": busy_ms if dev_us else None,
            "device_idle_share": 1 - busy_ms / wall_ms if dev_us else None,
            f"device_us_per_{unit}": dict(sorted(dev_us.items(),
                                                 key=lambda kv: -kv[1]))}


def lenet(dev, report):
    """Compile LeNet-5 under each configuration, run the fused forward on
    256 synthetic digits with the counts set to 0 just before it, and hold
    it against the twin path and the masked-dense forward."""
    from repro_torch.core.compile_sparse import (CompileRules, compile_lenet,
                                                 decompress_model)
    from repro_torch.data.synthetic import synthetic_digits
    from repro_torch.models.lenet import init_lenet, lenet_forward

    params = init_lenet(seed=0, device=dev)
    images, _ = synthetic_digits(0, noise=1.1).batch(0, LENET_BATCH)
    x = torch.from_numpy(images).to(dev)
    out, cms = {}, {}
    for cname, (policies, expect) in LENET_CONFIGS.items():
        t0 = time.perf_counter()
        cm = compile_lenet(params, rules=CompileRules(**LENET_RULES,
                                                      policies=policies),
                           blocks=LENET_BLOCKS, device=dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0

        def fused():
            return lenet_forward(params, x, compressed=cm.layers, fusion=True)

        fused()                       # first call: schedules, densify once
        torch.cuda.synchronize()
        reset_counts()
        y = fused()
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: expect.get(k, 0) for k in counts}
        require(counts == want, f"lenet {cname}: one fused forward launched "
                                f"{counts}, expected {want}")
        yt = lenet_forward(params, x, compressed=cm.layers, fusion=True,
                           dispatch="twin")
        dparams = decompress_model(cm)

        def dense():
            return lenet_forward(dparams, x)

        yd = dense()
        torch.cuda.synchronize()
        require(tuple(y.shape) == (LENET_BATCH, 10) and
                bool(torch.isfinite(y).all()), f"lenet {cname}: bad logits")
        top = float(yt.abs().max())
        err = float((y - yt).abs().max())
        err_dense = float((yd - yt).abs().max())
        ak, at = y.argmax(1), yt.argmax(1)
        diff = (ak != at).nonzero().flatten().tolist()
        ties = all(abs(float(v[i, ak[i]] - v[i, at[i]])) <= LENET_TOL * top
                   for i in diff for v in (y, yt))
        require(err <= LENET_TOL * top,
                f"lenet {cname}: kernel vs twin logits max abs err {err} > "
                f"{LENET_TOL} x {top}")
        require(err_dense <= LENET_TOL * top,
                f"lenet {cname}: masked-dense vs twin logits max abs err "
                f"{err_dense} > {LENET_TOL} x {top}")
        require(ties, f"lenet {cname}: argmax differs beyond a tie at rows "
                      f"{diff}")
        fused_ms = [host_ms(fused), host_ms(dense), host_ms(dense),
                    host_ms(fused)]
        f_ms = (fused_ms[0] + fused_ms[3]) / 2
        d_ms = (fused_ms[1] + fused_ms[2]) / 2
        out[cname] = {
            "launches_per_forward": counts, "compile_s": compile_s,
            "max_abs_err_vs_twin": err, "max_abs_err_dense_vs_twin":
                err_dense, "largest_logit": top, "tol": LENET_TOL * top,
                "argmax_differs_at": diff,
            "fused_ms": [fused_ms[0], fused_ms[3]],
            "masked_dense_ms": [fused_ms[1], fused_ms[2]],
            "fused_images_per_s": LENET_BATCH / f_ms * 1e3,
            "masked_dense_images_per_s": LENET_BATCH / d_ms * 1e3,
            "fused_over_dense": d_ms / f_ms,
            "container_storage_bytes": cm.container_storage_bytes,
            "byte_compression": cm.byte_compression,
            "profile": profile_forward(fused),
            "profile_masked_dense": profile_forward(dense),
        }
        cms[cname] = (cm, counts)
    report["lenet"] = out
    return params, x, cms


def sparse_conv_operands(cp):
    """The operands the sparse family hands block_sparse_conv for a
    compiled conv (core/families/sparse.py ``_conv_fused``)."""
    pl = cp.payload
    pat = pl.pattern
    if pl.packed and pl.blocks.axis % 3 == 1 \
            and pat.block[0] % pl.blocks.per_byte == 0:
        return pl.blocks.data, pl.blocks.container
    return pl.block_values(), False


def quant_conv_operands(cp):
    """The operands the quant family hands quant_conv (``_conv_fused``)."""
    pl = cp.payload
    from repro_torch.core.quant import PackedTensor
    if isinstance(pl, PackedTensor):
        if pl.axis == 0 and cp.K % pl.per_byte == 0:
            return pl.data, pl.container, pl.unpack()
        return pl.unpack(), False, pl.unpack()
    return pl.values, False, pl.values


def conv2d_call(cp, xin):
    """The one-call library yardstick of a fused conv: ``F.conv2d`` on the
    densified weight, the conv alone (no bias, relu or pool)."""
    import torch.nn.functional as F

    from repro_torch.core.compile_sparse import conv_weight_unmatrix
    from repro_torch.core.dispatch import _payload_dense_f32
    w4 = conv_weight_unmatrix(_payload_dense_f32(cp.payload, xin.device),
                              cp.kernel).permute(3, 2, 0, 1).contiguous()
    xn = xin.permute(0, 3, 1, 2).contiguous()
    return lambda: F.conv2d(xn, w4)


def measure_lenet_kernels(params, x, cms, dev):
    """Time each LeNet kernel at B=256 on the compiled model's own leaves,
    summed over its launches in one forward, beside its bound, its plain
    version and a library yardstick; inputs are warm in L2, as in the
    forward (each layer reads what the one before just wrote)."""
    import torch.nn.functional as F

    from repro_torch.core.dispatch import _payload_dense_f32, conv_dispatch
    from repro_torch.kernels import fc_stack as fk
    from repro_torch.kernels.fc_stack import (fc_stack_matmul,
                                              fc_stack_matmul_ref, fcs_route)
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.quant_matmul.kernel import quant_conv
    from repro_torch.kernels.quant_matmul.ref import quant_conv_ref
    from repro_torch.kernels.sparse_matmul import kernel as sk
    from repro_torch.kernels.sparse_matmul.kernel import (
        block_sparse_conv, conv_route, packed_ratio)
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_conv_ref

    N_CALLS = 16
    pool = ("avg", 2)
    entries, details = [], {}

    def conv_inputs(cm):
        """(name, conv payload, input) of conv1 and conv2 in the forward."""
        h1 = conv_dispatch(cm.layers["conv1"], x, bias=params["conv1_b"],
                           activation="relu", pool=pool)
        return [("conv1", cm.layers["conv1"], x),
                ("conv2", cm.layers["conv2"], h1)]

    def library(cp, xin):
        call = conv2d_call(cp, xin)
        return lambda i: call

    def add(name, source, replaces, counts, rows, shape, library_note,
            routes=()):
        """One kernels-line entry: times summed over the kernel's launches
        in one forward; the bound of their total bytes and operations."""
        tot = {k: sum(r[k] for r in rows) for k in
               ("ms", "plain_ms", "library_ms", "bytes", "ops",
                "first_version_ms")
               if all(r.get(k) is not None for r in rows)}
        bms, by = bound(tot["bytes"], tot["ops"], "f32")
        for r in rows:
            r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], "f32")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": bms, "bound_by": by,
            "library_ms": tot.get("library_ms"), "shape": shape,
            "library": library_note, "l2": "warm"})
        if "first_version_ms" in tot:
            entries[-1]["first_version_ms"] = tot["first_version_ms"]
            entries[-1]["launches_by_route"] = {k: counts[k] for k in routes}
        details[name] = rows

    def plan_note(route, plan):
        return route if plan is None else (
            f"{route}: {plan.ct} columns x 4 positions a thread, "
            f"{plan.img} images x {plan.ks} K parts a CTA, "
            f"{plan.grid[0] * plan.grid[1]} CTAs of {plan.threads}")

    # block_sparse_conv: the Table-I configuration's conv1 and conv2
    cm, counts = cms["table1"]
    rows = []
    for lname, cp, xin in conv_inputs(cm):
        pl = cp.payload
        pat = pl.pattern
        nR, nC = pat.bitmap.shape
        bk, bn = pat.block
        blocks, packed = sparse_conv_operands(cp)
        vals = pl.block_values()
        sched = schedule_for(pat, dev)
        rws = torch.as_tensor(pat.block_rows, device=dev)
        cls = torch.as_tensor(pat.block_cols, device=dev)
        b = params[lname + "_b"]
        kw = dict(kernel_hw=cp.kernel[:2], activation="relu", pool=pool)
        B, H, W, C = (int(d) for d in xin.shape)
        route, plan = conv_route(B, H, W, C, cp.kernel[:2], (1, 1), (1, 1),
                                 pool, cp.N, xin.dtype, block=(bk, bn),
                                 max_blocks_per_col=sched.max_blocks_per_col)
        y = block_sparse_conv(xin, blocks, sched, scales=pl.scales, bias=b,
                              packed=packed, **kw)
        ref = block_sparse_conv_ref(xin, vals, rws, cls, n_row_blocks=nR,
                                    n_col_blocks=nC, scales=pl.scales,
                                    bias=b, **kw)
        err = f32_check(f"block_sparse_conv {lname} at B={LENET_BATCH}", y,
                        ref)
        Ho, Wo = H - cp.kernel[0] + 1, W - cp.kernel[1] + 1
        P = pat.n_blocks_present
        rows.append({
            "bytes": nbytes(xin, blocks, pl.scales, b, y, sched.col_ptr,
                            sched.rows, sched.pidx),
            "ops": 2.0 * B * Ho * Wo * P * bk * bn,
            "layer": lname, "max_abs_err": err,
            "ms": device_ms(lambda i: lambda: block_sparse_conv(
                xin, blocks, sched, scales=pl.scales, bias=b, packed=packed,
                **kw), N_CALLS),
            "plain_ms": device_ms(lambda i: lambda: block_sparse_conv_ref(
                xin, vals, rws, cls, n_row_blocks=nR, n_col_blocks=nC,
                scales=pl.scales, bias=b, **kw), N_CALLS),
            # the first design (band route) at the same shape, this run
            "first_version_ms": device_ms(
                lambda i: lambda: sk._conv_launch(
                    xin, blocks, sched, cp.kernel[:2], pl.scales, b, "relu",
                    (1, 1), (1, 1), pool, packed_ratio(packed), "band"),
                N_CALLS),
            "library_ms": device_ms(library(cp, xin), N_CALLS),
            "shape": f"x {tuple(xin.shape)} K={cp.K} N={cp.N} blocks {P}/"
                     f"{pat.n_blocks_total} of {pat.block} "
                     f"{packed or str(blocks.dtype).split('.')[-1]}, "
                     f"{plan_note(route, plan)}"})
    add("block_sparse_conv", "src/repro_torch/csrc/block_sparse_conv.cu",
        "src/repro/kernels/sparse_matmul/kernel.py:537", counts, rows,
        "; ".join(r["shape"] for r in rows),
        "F.conv2d on the densified weight, conv alone (no bias, relu, pool)",
        (BSC_REG, BSC_BAND))

    # quant_conv: the quant-conv configuration's conv1 and conv2
    cm, counts = cms["quant_conv"]
    rows = []
    for lname, cp, xin in conv_inputs(cm):
        w_q, packed, codes = quant_conv_operands(cp)
        sc = cp.payload.scales.reshape(-1)
        b = params[lname + "_b"]
        kw = dict(kernel_hw=cp.kernel[:2], activation="relu", pool=pool)
        B, H, W, C = (int(d) for d in xin.shape)
        route, plan = conv_route(B, H, W, C, cp.kernel[:2], (1, 1), (1, 1),
                                 pool, cp.N, xin.dtype)
        y = quant_conv(xin, w_q, sc, b, packed=packed, **kw)
        ref = quant_conv_ref(xin, codes, sc, b, **kw)
        err = f32_check(f"quant_conv {lname} at B={LENET_BATCH}", y, ref)
        Ho, Wo = H - cp.kernel[0] + 1, W - cp.kernel[1] + 1
        rows.append({
            "bytes": nbytes(xin, w_q, sc, b, y),
            "ops": 2.0 * B * Ho * Wo * cp.K * cp.N,
            "layer": lname, "max_abs_err": err,
            "ms": device_ms(lambda i: lambda: quant_conv(
                xin, w_q, sc, b, packed=packed, **kw), N_CALLS),
            "plain_ms": device_ms(lambda i: lambda: quant_conv_ref(
                xin, codes, sc, b, **kw), N_CALLS),
            # the first design (band route) at the same shape, this run
            "first_version_ms": device_ms(lambda i: lambda: qk._conv_launch(
                xin, w_q, sc, b, cp.kernel[:2], "relu", (1, 1), (1, 1), pool,
                packed_ratio(packed), "band"), N_CALLS),
            "library_ms": device_ms(library(cp, xin), N_CALLS),
            "shape": f"x {tuple(xin.shape)} K={cp.K} N={cp.N} "
                     f"{packed or 'int8'}, {plan_note(route, plan)}"})
    add("quant_conv", "src/repro_torch/csrc/quant_conv.cu",
        "src/repro/kernels/quant_matmul/kernel.py:242", counts, rows,
        "; ".join(r["shape"] for r in rows),
        "F.conv2d on the densified weight, conv alone (no bias, relu, pool)",
        (QCONV_REG, QCONV_BAND))

    # fc_stack_matmul: the Table-I configuration's fc1 -> fc2 -> fc3
    cm, counts = cms["table1"]
    h = x
    for lname in ("conv1", "conv2"):
        h = conv_dispatch(cm.layers[lname], h, bias=params[lname + "_b"],
                          activation="relu", pool=pool)
    h = h.reshape(h.shape[0], -1).contiguous()
    names = ("fc1", "fc2", "fc3")
    ws = [_payload_dense_f32(cm.layers[n], dev) for n in names]
    bs = [params[n + "_b"] for n in names]
    acts = ["relu", "relu", None]
    route, plan = fcs_route(h.shape[0], [h.shape[1]] +
                            [w.shape[1] for w in ws], h.dtype)
    y = fc_stack_matmul(h, ws, bs, acts)
    ref = fc_stack_matmul_ref(h, ws, bs, acts)
    err = f32_check(f"fc_stack_matmul at B={LENET_BATCH}", y, ref)
    wts = [w.t() for w in ws]

    def chain():
        """fc1 -> fc2 -> fc3 as three F.linear calls with torch.relu (f32,
        allow_tf32 False): a chain of three calls, not one."""
        a = torch.relu(F.linear(h, wts[0], bs[0]))
        return F.linear(torch.relu(F.linear(a, wts[1], bs[1])), wts[2],
                        bs[2])

    rows = [{"layer": "fc1+fc2+fc3", "max_abs_err": err,
             "bytes": nbytes(h, *ws, *bs, y),
             "ops": 2.0 * h.shape[0] * sum(w.numel() for w in ws),
             "ms": device_ms(lambda i: lambda: fc_stack_matmul(
                 h, ws, bs, acts), N_CALLS),
             "plain_ms": device_ms(lambda i: lambda: fc_stack_matmul_ref(
                 h, ws, bs, acts), N_CALLS),
             # the first design (stream route) at the same shape, this run
             "first_version_ms": device_ms(lambda i: lambda: fk._launch(
                 h, ws, bs, acts, "stream"), N_CALLS),
             "library_ms": None,
             "chain_ms": device_ms(lambda i: chain, N_CALLS),
             "shape": f"x {tuple(h.shape)} W 256x120, 120x84, 84x10 f32, "
                      + (route if plan is None else
                         f"{route}: {plan.tm} rows a CTA, {plan.grid} CTAs "
                         f"of {plan.threads}, {plan.smem} B of shared "
                         f"memory, K parts "
                         f"{plan.ks}")}]
    add("fc_stack_matmul", "src/repro_torch/csrc/fc_stack.cu",
        "src/repro/kernels/fc_stack.py:60", counts, rows, rows[0]["shape"],
        "none: no one PyTorch call chains three linears with their "
        "epilogues", (FCS_STAGED, FCS_STREAM))
    entries[-1]["plan"] = None if plan is None else vars(plan)
    entries[-1]["chain_ms"] = rows[0]["chain_ms"]
    entries[-1]["chain"] = ("three F.linear calls with torch.relu, f32, "
                            "allow_tf32 False: a chain of three calls, not "
                            "one")
    return entries, details


# ------------------------------------------------- the paper's workflow


# The Fig. 1 workflow at Table I's operating point (repro_torch.train.
# lenet_pipeline): 80 dense steps, 200 masked int4 QAT fine-tuning steps
FIG1_STEPS = (80, 200)
# stored bits at the operating point's mask counts over dense f32 bits; it
# depends on the counts alone, which block_aware_prune fixes (ceil of each
# density) but for a tie at its in-block ">= thr", which keeps one more.
# tests/test_torch_lenet_pipeline.py pins the same value on the CPU.
FIG1_STORED_BITS = 52.04474067088003
# the LLM example at a cut: its ~100M config, 30 steps (pruned at 20), then
# a second run to 40 that resumes from the last committed step
FIG1_LLM = dict(prune_at=20, ckpt_every=10, steps=(30, 40))


def example(name):
    """``examples/<name>_torch.py`` of this checkout, as a module."""
    import importlib.util

    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fig1_want(cm):
    """The launches one fused forward of a compiled LeNet takes by its
    report: a sparse conv on block_sparse_conv, a quant conv on quant_conv,
    each on its register-tiled route; the FC stack in one staged
    fc_stack_matmul launch.  No band or stream route: no LeNet shape needs
    one."""
    want = {}
    pol = {r.name: r.policy for r in cm.report}
    for conv in ("conv1", "conv2"):
        kernel, route = {"sparse": ("block_sparse_conv", BSC_REG),
                         "quant": ("quant_conv", QCONV_REG)}[pol[conv]]
        want[kernel] = want.get(kernel, 0) + 1
        want[route] = want.get(route, 0) + 1
    require(cm.fusion.get("fc_stack") == ("fc1", "fc2", "fc3"),
            f"fig1: the FC stack is not fused: {cm.fusion}")
    want.update({"fc_stack_matmul": 1, FCS_STAGED: 1})
    return want


def fig1_counts(masks):
    """Each layer's kept weights against what the densities fix: kept
    blocks x the in-block keep (a tie adds to it)."""
    from repro_torch.train import lenet_pipeline as lp

    out = {}
    for name, m in masks.items():
        conv = name.startswith("conv")
        m2 = m.transpose(2, 0, 1, 3).reshape(-1, m.shape[-1]) if conv else m
        bk, bn = (lp.CONV_BLOCK if conv else lp.BLOCK)[name]
        n_blocks = (m2.shape[0] // bk) * (m2.shape[1] // bn)
        bd = lp.CONV_BLOCK_DENSITY if conv else 0.5
        ibd = 1.0 if conv else lp.FC_IN_BLOCK_DENSITY
        fixed = max(1, math.ceil(bd * n_blocks)) \
            * max(1, math.ceil(ibd * bk * bn))
        out[name] = {"kept": int(m.sum()), "fixed": fixed}
    return out


def fig1_lenet(dev):
    """(a): the workflow trained, pruned and QAT-fine-tuned on the card,
    then ``cm_whole`` deployed through the fused kernels on the 1024 test
    digits, against the twin path."""
    from repro_torch.core import H100_SXM
    from repro_torch.models.lenet import lenet_forward
    from repro_torch.train import lenet_pipeline as lp

    t0 = time.perf_counter()
    reset_counts()
    run = lp.run(hw=H100_SXM, device=dev, steps=FIG1_STEPS[0],
                 finetune_steps=FIG1_STEPS[1])
    torch.cuda.synchronize()
    run_counts = read_counts()
    run_s = time.perf_counter() - t0
    bench = run.rows[-1]["bench"]
    want = fig1_want(run.cm_whole)
    # the run's one compressed forward: accuracy() of cm_whole
    require(run_counts == {k: want.get(k, 0) for k in run_counts},
            f"fig1: the workflow launched {run_counts}, expected {want}")
    losses = {k: v.cpu().tolist() for k, v in run.losses.items()}
    for k, v in losses.items():
        require(all(math.isfinite(l) for l in v)
                and np.mean(v[-10:]) < np.mean(v[:10]),
                f"fig1: the {k} losses do not fall: {v[:10]} ... {v[-10:]}")

    x, y = run.task.batch(*lp.TEST_BATCH, split="test")
    xs = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        reset_counts()
        yk = lenet_forward(run.pruned_params, xs,
                           compressed=run.cm_whole.layers, fusion=True)
        torch.cuda.synchronize()
        counts = read_counts()
        yt = lenet_forward(run.pruned_params, xs,
                           compressed=run.cm_whole.layers, fusion=True,
                           dispatch="twin")
    require(counts == {k: want.get(k, 0) for k in counts},
            f"fig1: the deployed forward launched {counts}, expected {want}")
    require(tuple(yk.shape) == (len(y), 10) and bool(torch.isfinite(yk).all()),
            "fig1: bad logits")
    top = float(yt.abs().max())
    err = float((yk - yt).abs().max())
    require(err <= LENET_TOL * top,
            f"fig1: fused vs twin logits max abs err {err} > {LENET_TOL} x "
            f"{top}")
    labels = torch.from_numpy(y).long()
    right_k = int((yk.argmax(-1).cpu() == labels).sum())
    right_t = int((yt.argmax(-1).cpu() == labels).sum())
    require(abs(right_k - right_t) <= 1,
            f"fig1: top-1 {right_k} fused vs {right_t} twin of {len(y)}")

    kept = fig1_counts(run.masks)
    ratio = bench["stored_bits_compression"]
    if all(c["kept"] == c["fixed"] for c in kept.values()):
        require(ratio == FIG1_STORED_BITS,
                f"fig1: stored bits {ratio}x, pinned {FIG1_STORED_BITS}x")
    else:
        print(f"fig1: a tie in block_aware_prune kept more: {kept}",
              flush=True)
        require(all(c["kept"] >= c["fixed"] for c in kept.values())
                and ratio < FIG1_STORED_BITS,
                f"fig1: kept weights {kept}, stored bits {ratio}x")
    whole, fc = run.cm_whole.byte_compression, run.cm_fc.byte_compression
    require(whole >= lp.BYTE_COMPRESSION_FLOOR and whole > fc,
            f"fig1: whole-model bytes {whole}x, FC-only {fc}x")
    return {
        "seconds_run": run_s, "steps": FIG1_STEPS,
        "accuracy": {k: bench[f"accuracy_{k}"] for k in
                     ("dense", "pruned_masked", "whole_compressed")},
        "deployed_top1": {"fused": right_k, "twin": right_t,
                          "images": len(y)},
        "max_abs_err_vs_twin": err, "largest_logit": top,
        "tol": LENET_TOL * top, "launches_run": run_counts,
        "launches_deployed": counts,
        "policies": {r.name: r.policy for r in run.cm_whole.report},
        "stored_bits_compression": ratio, "kept": kept,
        "whole_model_compression": whole, "fc_only_compression": fc,
        "int8_container_compression": run.cm_whole.compression,
        "whole_model_storage_bytes": run.cm_whole.container_storage_bytes,
        "dense_storage_bytes": run.cm_whole.dense_bytes,
        "losses_dense": losses["dense"], "losses_finetune": losses["finetune"],
        "rows_h100_sxm_estimates": [
            {k: v for k, v in r.items() if k != "bench"} for r in run.rows],
    }


def fig1_llm(dev):
    """(b): the LLM example at a cut, stopped and resumed from its last
    committed step; every flash launch on the CUDA-core route (f32)."""
    import tempfile

    mod = example("llm_sparse_train")
    c = FIG1_LLM
    with tempfile.TemporaryDirectory() as ck:
        argv = ["--prune-at", str(c["prune_at"]), "--ckpt-every",
                str(c["ckpt_every"]), "--ckpt", ck]
        reset_counts()
        t0 = time.perf_counter()
        first = mod.main(argv + ["--steps", str(c["steps"][0])])
        second = mod.main(argv + ["--steps", str(c["steps"][1])])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    layers = len(second["params"]["blocks"]["mlp"]["wg"]["w"])
    flash = 2 * layers * c["steps"][1]          # 2 micro-batches a step
    want = {"flash_attention": flash, FLASH_CC: flash}
    require(counts == {k: want.get(k, 0) for k in counts},
            f"fig1 llm: launched {counts}, expected {want}")
    resumed = c["steps"][1] - c["steps"][0]
    require(len(second["sparse_losses"]) == resumed,
            f"fig1 llm: the second run trained "
            f"{len(second['sparse_losses'])} steps, not {resumed}")
    require(second["max_pruned"] == 0.0 and first["max_pruned"] == 0.0,
            f"fig1 llm: a pruned weight is {second['max_pruned']}")
    for key, m in first["masks"].items():
        require(torch.equal(second["masks"][key], m),
                f"fig1 llm: {key}'s mask changed across the resume")
    losses = first["dense_losses"] + first["sparse_losses"] \
        + second["sparse_losses"]
    require(all(math.isfinite(v) for v in losses)
            and np.mean(losses[-5:]) < np.mean(losses[:5]),
            f"fig1 llm: the losses do not fall: {losses}")
    return {"seconds": seconds, "launches": counts, "layers": layers,
            "losses": losses, "max_pruned": second["max_pruned"]}


def fig1(dev, report):
    """The paper's Fig. 1 workflow and the port's example entry points on
    the card: (a) ``fig1_lenet``, (b) ``fig1_llm``, (c) ``quickstart_torch``
    and ``serve_batched_torch``'s ``main`` with their own asserts."""
    t0 = time.perf_counter()
    out = {"lenet": fig1_lenet(dev), "llm": fig1_llm(dev)}
    reset_counts()
    qs = example("quickstart").main([])
    counts = read_counts()
    require(counts["block_sparse_matmul"] > 0 and counts["quant_matmul"] > 0
            and counts["block_sparse_conv"] > 0,
            f"fig1 quickstart: its compiled leaves launched {counts}")
    out["quickstart"] = {"errors": qs,
                         "launches": {k: v for k, v in counts.items() if v}}
    reqs = example("serve_batched").main([])
    out["serve_batched"] = {"tokens": sum(len(r.out) for r in reqs)}
    out["seconds"] = time.perf_counter() - t0
    report["fig1"] = out
    return out


# ---------------------------------------------------------------- training


# The training slice: global batch 4 x 2048 tokens in 2 micro-batches,
# 6 AdamW steps on one batch (a falling loss checks the gradients), frozen
# masks on every MLP weight as the serve compile prunes them.
TRAIN = dict(batch=4, seq=2048, n_micro=2, steps=6)
TRAIN_PRUNE = dict(block=(128, 128), block_density=0.25, in_block_density=0.5)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=8)
# One train step under dispatch="kernel" vs "twin" from the same state.  Only
# the attention forward differs (flash kernel vs chunked_attention): both
# compute in f32 and round to bf16, so single outputs differ by a bf16 step,
# which the 16 bf16 layers carry on.  The loss is a mean over 8192 tokens:
# within one bf16 step (2^-8) relative.  The gradient norm comes from the
# same backward code at those slightly different activations: within the
# 2% relative that the serving path allows its float-cache logits.
TRAIN_TWIN_TOL = {"loss": 2 ** -8, "grad_norm": 2e-2}


def event_ms(fn, reps: int = 5) -> float:
    """Mean device time per call from CUDA events around ``reps`` calls,
    after one warm-up call (for work a CUDA graph should not capture)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def train(dev, report):
    """Train llama3.2-1b at full width for a few steps through
    ``make_train_step`` and ``TrainRunner``, with frozen block-sparse masks
    on every ``wg``/``wu``/``wd``; the counts are set to 0 just before the
    run.  Holds one step against ``dispatch="twin"`` first."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.runtime import RunnerConfig, TrainRunner
    from repro_torch.train.trainer import make_train_step

    cfg = get_config("llama3.2-1b")
    require(cfg.remat, "the training slice runs with remat")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    masks = {"blocks": {"mlp": {}}}
    for name in ("wg", "wu", "wd"):
        w = params["blocks"]["mlp"][name]["w"]
        mt = prune_slices(w)
        w.mul_(mt.to(w.dtype))          # pruned before training, in place
        masks["blocks"]["mlp"][name] = {"w": mt}
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    opt = adamw_init(params, opt_cfg)
    toks, labels = token_batch(0, TRAIN["batch"], TRAIN["seq"], cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # kernel vs twin: one step each from the same state
    twin = {}
    for mode in ("kernel", "twin"):
        step = make_train_step(cfg, opt_cfg, TRAIN["n_micro"], masks,
                               dispatch=mode)
        met = step(params, opt, batch)[2]       # the new state is dropped
        twin[mode] = {k: float(met[k]) for k in ("loss", "grad_norm")}
        del met
    for k, tol in TRAIN_TWIN_TOL.items():
        a, b = twin["kernel"][k], twin["twin"][k]
        rel = abs(a - b) / abs(b)
        twin[f"{k}_rel_err"] = rel
        require(math.isfinite(a) and rel <= tol,
                f"train step kernel vs twin {k}: {a} vs {b}, rel err {rel} > "
                f"{tol}")

    step = make_train_step(cfg, opt_cfg, TRAIN["n_micro"], masks)
    runner = TrainRunner(step, lambda i: batch, RunnerConfig(
        total_steps=TRAIN["steps"], ckpt_every=0, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    box = {"params": params, "opt": opt}
    del params, opt          # the runner holds the only references
    reset_counts()
    params, opt = runner.run(box.pop("params"), box.pop("opt"))
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    log = runner.metrics_log
    losses = [m["loss"] for m in log]
    require(len(log) == TRAIN["steps"] and all(map(math.isfinite, losses)),
            f"train: {len(log)} steps, losses {losses}")
    require(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    for name, m in masks["blocks"]["mlp"].items():
        w = params["blocks"]["mlp"][name]["w"]
        require(bool((w[~m["w"]] == 0).all()),
                f"train: pruned {name} weights are not exactly zero")
    want = cfg.n_layers * 2 * TRAIN["n_micro"] * TRAIN["steps"]
    require(counts["flash_attention"] == want,
            f"train: {counts['flash_attention']} flash launches, expected "
            f"{want} (forward + remat recompute per layer and micro-batch)")
    require(counts[FLASH_TC] == want and counts[FLASH_CC] == 0,
            f"train: {counts[FLASH_TC]} flash launches on the tensor-core "
            f"route and {counts[FLASH_CC]} on the CUDA cores, expected {want} "
            f"and 0")
    step_ms = [m["step_s"] * 1e3 for m in log]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    report["train"] = {
        **TRAIN, "setup_s": setup_s, "losses": losses,
        "grad_norms": [m["grad_norm"] for m in log], "step_ms": step_ms,
        "step_ms_p50": pct(step_ms, 50),
        "tokens_per_s": tokens / pct(step_ms, 50) * 1e3,
        "peak_memory_bytes": peak, "launches": counts,
        "flash_launches_per_step": counts["flash_attention"] / len(log),
        "twin_check": twin, "twin_tol": TRAIN_TWIN_TOL,
        "profile": profile_forward(lambda: step(params, opt, batch), steps=1,
                                   unit="step"),
    }
    return counts


def measure_flash(dev, counts):
    """Row 7: the flash kernel at the training shape (one micro-batch of one
    layer) beside its bound, its plain version and SDPA; and the backward
    that recomputes ``chunked_attention`` there."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, flash_attention_plain)
    from repro_torch.models.layers import chunked_attention

    B, T, H, Hkv, Dh = TRAIN["batch"] // TRAIN["n_micro"], TRAIN["seq"], 32, \
        8, 64
    ins = [[torch.randn(s_, device=dev).to(torch.bfloat16)
            for s_ in ((B, T, H, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh))]
           for _ in range(4)]
    q, k, v = ins[0]
    route = fk.flash_route(q, k, v)
    require(route == "tensor_core", f"flash_route sends the training shape "
                                    f"to the {route} route")
    y = flash_attention_fwd(q, k, v, causal=True)
    ref = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    tol = flash_tol(torch.bfloat16, ref)
    require(err <= tol, f"flash_attention at the training shape: max abs err "
                        f"{err} > {tol}")
    heads = [[t.permute(0, 2, 1, 3) for t in qkv] for qkv in ins]
    ops = 4.0 * B * H * Dh * T * (T + 1) / 2    # causal pairs k <= q
    b_ms, b_by = bound(nbytes(q, k, v, y), ops, "bf16")
    g = torch.randn_like(q)

    def backward():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(chunked_attention(*leaves, causal=True), leaves,
                            g)

    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": counts["flash_attention"], "max_abs_err": err,
        "tol": tol,
        "ms": device_ms(lambda i: lambda: flash_attention_fwd(
            *ins[i], causal=True), 4),
        "plain_ms": device_ms(lambda i: lambda: flash_attention_plain(
            *ins[i], causal=True), 2),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": device_ms(lambda i: lambda: F.scaled_dot_product_attention(
            *heads[i], is_causal=True, enable_gqa=True), 4),
        # the first design (CUDA-core kernel) at the same shape, in this run
        "first_version_ms": device_ms(lambda i: lambda: fk._launch(
            *ins[i], True, "cuda_core"), 4),
        "launches_by_route": {FLASH_TC: counts[FLASH_TC],
                              FLASH_CC: counts[FLASH_CC]},
        "backward_recompute_ms": event_ms(backward),
        "shape": f"B={B} T={T} H={H} Hkv={Hkv} Dh={Dh} bf16 causal, "
                 f"{route} route",
        "library": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True), (B, H, T, Dh) views"}


# ------------------------------------------------------ train_families


# The MoE, SSM and hybrid families trained at full width: bf16 weights,
# each config's own AdamW moment dtype (f32), remat on, ``TRAIN_OPT``, 4
# steps through ``TrainRunner`` on ``token_batch`` seed 0, frozen
# ``block_aware_prune(**TRAIN_PRUNE)`` masks (one per 2-D slice) on the
# named stacked leaves, pruned in place before training.  Each path: (arch,
# layers kept or None for all, batch, seq, n_micro, masked leaves).
#
# olmoe-1b-7b is cut to 4 of its 16 layers.  AdamW is functional (the
# runner retries a failed step from the old state), so its update holds
# the old and the new parameters and moments beside the f32 gradient sums,
# 24 B a parameter and the masks: at 4 layers (1.88 G parameters) the peak
# is 51.5 GB on an H100 80GB, which at 8 layers (3.56 G) reckons ~97 GB,
# past the card's 80 GiB.
# xlstm-1.3b runs T 512 (its sLSTM runs a step at a time) at 16 of its 48
# layers (2 of 6 super-blocks): whole, its host-bound steps took 115-133 s
# of a script that ran 852-1038 s, past half its limit.  zamba2-2.7b's
# ``win`` (10,448 columns, not a multiple of 128) is not masked.
TRAIN_FAMILY_PATHS = (
    ("olmoe-1b-7b", 4, 4, 2048, 4,
     tuple(("blocks", "moe", n, "w") for n in ("eg", "eu", "ed"))),
    ("zamba2-2.7b", None, 4, 2048, 4,
     (("blocks", "mamba", "wout", "w"),)
     + tuple(("shared_attn", "mlp", n, "w") for n in ("wg", "wu", "wd"))),
    ("xlstm-1.3b", 16, 4, 512, 2,
     tuple(("blocks", "mlstm", n, "w") for n in ("wq", "wk", "wv", "wo"))),
)
TRAIN_FAMILY_STEPS = 4
# host threads computing the masks (numpy releases the GIL in its loops)
PRUNE_THREADS = 8


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def prune_slices(w):
    """``block_aware_prune(**TRAIN_PRUNE)`` of every 2-D slice of ``w``
    (..., K, N): a bool mask of ``w``'s shape on its device."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.pruning import block_aware_prune

    flat = w.reshape(-1, *w.shape[-2:])
    out = torch.empty(flat.shape, dtype=torch.bool, device=w.device)
    with ThreadPoolExecutor(PRUNE_THREADS) as ex:
        for lo in range(0, flat.shape[0], 64):
            host = flat[lo:lo + 64].float().cpu().numpy()
            masks = ex.map(lambda a: block_aware_prune(a, **TRAIN_PRUNE),
                           list(host))
            out[lo:lo + 64] = torch.from_numpy(np.stack(list(masks))).to(
                w.device)
    return out.reshape(w.shape)


def train_family_path(spec, dev):
    """One family's training at full width: the twin check (one step under
    ``dispatch="kernel"`` and one under ``"twin"`` from the same state, where
    the path has a kernel), then ``TRAIN_FAMILY_STEPS`` steps through
    ``TrainRunner`` with the counts set to 0 just before and read just
    after: finite, falling losses, pruned weights exactly zero, the flash
    launches on the route its head dim names; step ms, tokens/s, peak
    memory and a one-step profile."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models.model import init_params, n_superblocks
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.runtime import RunnerConfig, TrainRunner
    from repro_torch.train.trainer import make_train_step

    arch, layers, B, T, n_micro, masked = spec
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    require(cfg.remat, f"{arch}: the training slice runs with remat")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    masks, n_masked = {}, 0
    for path in masked:
        w = tree_get(params, path)
        m = prune_slices(w)
        w.mul_(m.to(w.dtype))           # pruned before training, in place
        d = masks
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = m
        n_masked += m.numel()
    opt_cfg = AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype)
    opt = adamw_init(params, opt_cfg)
    toks, labels = token_batch(0, B, T, cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    out = {"layers": cfg.n_layers, "batch": B, "seq": T, "n_micro": n_micro,
           "steps": TRAIN_FAMILY_STEPS, "params": n_params,
           "masked": ["/".join(p) for p in masked],
           "masked_elements": n_masked,
           "setup_s": time.perf_counter() - t0}

    # one flash launch a super-block's attention in the forward and one in
    # its remat recompute, per micro-batch
    n_attn = n_superblocks(cfg) if cfg.family in ("moe", "hybrid") else 0
    route = FLASH_TC if n_attn else None    # Dh 128 and 80: tensor cores
    if n_attn:      # kernel vs twin: one step each from the same state
        t = time.perf_counter()
        twin = {}
        for mode in ("kernel", "twin"):
            step = make_train_step(cfg, opt_cfg, n_micro, masks,
                                   dispatch=mode)
            met = step(params, opt, batch)[2]   # the new state is dropped
            twin[mode] = {k: float(met[k]) for k in ("loss", "grad_norm")}
            del met
        for k, tol in TRAIN_TWIN_TOL.items():
            a, b = twin["kernel"][k], twin["twin"][k]
            rel = abs(a - b) / abs(b)
            twin[f"{k}_rel_err"] = rel
            require(math.isfinite(a) and rel <= tol,
                    f"{arch} train step kernel vs twin {k}: {a} vs {b}, rel "
                    f"err {rel} > {tol}")
        out["twin_check"] = twin
        out["twin_s"] = time.perf_counter() - t

    step = make_train_step(cfg, opt_cfg, n_micro, masks)
    runner = TrainRunner(step, lambda i: batch, RunnerConfig(
        total_steps=TRAIN_FAMILY_STEPS, ckpt_every=0, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out["resident_bytes"] = torch.cuda.memory_allocated(dev)
    box = {"params": params, "opt": opt}
    del params, opt          # the runner holds the only references
    reset_counts()
    params, opt = runner.run(box.pop("params"), box.pop("opt"))
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    log = runner.metrics_log
    losses = [m["loss"] for m in log]
    require(len(log) == TRAIN_FAMILY_STEPS
            and all(map(math.isfinite, losses)),
            f"{arch} train: {len(log)} steps, losses {losses}")
    require(losses[-1] < losses[0],
            f"{arch} train: the loss did not fall: {losses}")
    for path in masked:
        w, m = tree_get(params, path), tree_get(masks, path)
        require(not bool(((w != 0) & ~m).any()),
                f"{arch} train: pruned {'/'.join(path)} weights are not "
                f"exactly zero")
    want = n_attn * 2 * n_micro * TRAIN_FAMILY_STEPS
    got = {k: counts[k] for k in ("flash_attention", FLASH_TC, FLASH_CC)}
    require(got == {"flash_attention": want,
                    FLASH_TC: want if route == FLASH_TC else 0,
                    FLASH_CC: want if route == FLASH_CC else 0},
            f"{arch} train: flash launches {got}, expected {want} on "
            f"{route} (forward + remat recompute per super-block and "
            f"micro-batch)")
    require(sum(v for k, v in counts.items() if "/" not in k) == want,
            f"{arch} train: kernels off the path launched: {counts}")
    step_ms = [m["step_s"] * 1e3 for m in log]
    p50 = pct(step_ms, 50)
    t = time.perf_counter()
    prof = profile_forward(lambda: step(params, opt, batch), steps=1,
                           unit="step", wall_ms=p50)
    top = top_device_us(prof.pop("device_us_per_step"))
    out.update({
        "losses": losses, "grad_norms": [m["grad_norm"] for m in log],
        "step_ms": step_ms, "step_ms_p50": p50,
        "tokens_per_s": B * T / p50 * 1e3, "peak_memory_bytes": peak,
        "launches": got, "flash_route": route,
        "flash_launches_per_step": counts["flash_attention"] / len(log),
        "twin_tol": TRAIN_TWIN_TOL, **prof,
        "top_device_us_per_step": top,
        "profile_s": time.perf_counter() - t})
    return out, cfg, counts


def train_flash_row(dev, cfg, launches):
    """The flash kernel at one layer of ``cfg``'s training forward (one
    micro-batch: B 1, T 2048) beside its bound, plain version and SDPA
    (``flash_row``), and the backward that recomputes
    ``chunked_attention`` there."""
    from repro_torch.models.layers import chunked_attention

    B, T = 1, 2048
    row = flash_row(dev, cfg, B, T, True)
    q, k, v = (torch.randn(s_, device=dev).to(torch.bfloat16)
               for s_ in ((B, T, cfg.n_heads, cfg.head_dim),
                          (B, T, cfg.n_kv_heads, cfg.head_dim),
                          (B, T, cfg.n_kv_heads, cfg.head_dim)))
    g = torch.randn_like(q)

    def backward():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(chunked_attention(*leaves, causal=True), leaves,
                            g)

    row.update(launches=launches, backward_recompute_ms=event_ms(backward))
    return row


def train_families(dev, report):
    """The MoE, SSM and hybrid families' training (``TRAIN_FAMILY_PATHS``),
    each path's counts set to 0 just before it and read just after; the
    flash rows at olmoe-1b-7b's and zamba2-2.7b's training shapes go to
    ``report["train_families_rows"]``."""
    out, rows = {}, {"flash_attention": []}
    report["train_families"] = out
    report["train_families_rows"] = rows
    t0 = time.perf_counter()
    for spec in TRAIN_FAMILY_PATHS:
        t = time.perf_counter()
        out[spec[0]], cfg, counts = train_family_path(spec, dev)
        torch.cuda.empty_cache()
        if counts["flash_attention"]:
            rows["flash_attention"].append(train_flash_row(
                dev, cfg, counts["flash_attention"]))
        out[spec[0]]["seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0


# ----------------------------------------------------------- families


# llama3.2-1b's full-width leaf shapes (K, N)
FAMILY_SHAPES = {"attn/wq": (2048, 2048), "attn/wk": (2048, 512),
                 "mlp/wg": (2048, 8192), "mlp/wd": (8192, 2048)}
# label -> (policy, bits): the families this slice adds, and sparse at 2
# bits (int2x4 blocks); "quant4" / "sparse4" are the int4x2 leaves they
# are timed beside
FAMILY_LEAVES = {"perchannel8": ("perchannel", 8),
                 "perchannel4": ("perchannel", 4), "bfp8": ("bfp8", 8),
                 "int2": ("quant", 2), "sparse2": ("sparse", 2),
                 "actsparse": ("actsparse", 8)}
FAMILY_TAU = 0.05
FAMILY_RULES = dict(block=(128, 128), block_density=0.25,
                    in_block_density=0.5, min_weight_elems=0,
                    act_threshold=FAMILY_TAU)
# (M, x dtype): thin-M rows, tensor-core rows, and f32 rows on either side
# of the thin-M limit; each call must take the route its rule names
FAMILY_CALLS = ((8, torch.bfloat16), (512, torch.bfloat16),
                (8, torch.float32), (64, torch.float32))
FAMILY_TIMED = ((8, torch.bfloat16), (512, torch.bfloat16))
# llama3.2-1b at full width, three compiles: the cost model's pick
# (no policies, TPU_V5E), a family map at 8 bits, and 2 bits
FAMILY_MODELS = {
    "auto_int4": dict(quant_bits=4),
    "family_map": dict(quant_bits=8, act_threshold=FAMILY_TAU, policies={
        "wq": "perchannel", "wo": "perchannel", "wk": "bfp8", "wv": "bfp8",
        "wg": "actsparse", "wu": "actsparse", "wd": "actsparse"}),
    "int2": dict(quant_bits=2, policies={
        "wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
        "wg": "sparse", "wu": "sparse", "wd": "sparse"}),
}
FAMILY_MODEL_RULES = dict(block=(128, 128), block_density=0.25,
                          in_block_density=0.5, min_weight_elems=0)
# the Table-I whole-model rules (benchmarks/table1_lenet.py:105-106), no
# policies: the cost model picks; then the convs as quant at 2 bits
LENET_WHOLE_MODEL = dict(block=(8, 4), min_weight_elems=0, quant_bits=4)
LENET_FAMILY_CONFIGS = {
    "auto": (LENET_WHOLE_MODEL, None,
             {"block_sparse_conv": 2, BSC_REG: 2, "fc_stack_matmul": 1,
              FCS_STAGED: 1}),
    "int2_conv": (dict(LENET_WHOLE_MODEL, quant_bits=2),
                  {**{n: "sparse" for n in LENET_NAMES}, "conv1": "quant",
                   "conv2": "quant"},
                  {"quant_conv": 2, QCONV_REG: 2, "fc_stack_matmul": 1,
                   FCS_STAGED: 1}),
}
DSE_BUDGET = 8e6   # benchmarks/table1_lenet.py:83
QMM_ROUTES = {"thin_m": "launches_thin", "tensor_core": "launches_tc",
              "tiled": "launches_tiled"}


def n_copies(nbytes_, cap=64):
    """Copies of an operand that together exceed the 50 MB L2 well."""
    return int(min(cap, max(2, math.ceil(128e6 / max(nbytes_, 1)))))


def family_operands(payload, x):
    """What the family's dispatch hands its kernel for ``payload`` and the
    activation ``x``: ("quant", x', codes, scales, packed) or ("sparse", x,
    blocks, scales, packed, pattern)."""
    from repro_torch.core.dispatch import perchannel_fold, unit_scales
    from repro_torch.core.families.actsparse import ActSparsePayload
    from repro_torch.core.families.bfp8 import BFP8Tensor
    from repro_torch.core.families.perchannel import PerChannelQuant
    from repro_torch.core.quant import PackedTensor, QuantizedTensor
    if isinstance(payload, PerChannelQuant):
        N = payload.values.shape[1]
        return ("quant", perchannel_fold(x, payload.scales, x.dtype),
                payload.values, unit_scales(N, x.device), False)
    if isinstance(payload, BFP8Tensor):
        return ("quant", x, payload.mantissas,
                torch.exp2(payload.exponents.float()), False)
    if isinstance(payload, PackedTensor):
        return "quant", x, payload.data, payload.scales, payload.container
    if isinstance(payload, QuantizedTensor):
        return "quant", x, payload.values, payload.scales, False
    cl = payload.cl if isinstance(payload, ActSparsePayload) else payload
    if cl.packed:
        return ("sparse", x, cl.blocks.data, cl.scales, cl.blocks.container,
                cl.pattern)
    return "sparse", x, cl.blocks, cl.scales, False, cl.pattern


def family_route(ops, M, x):
    """The route the shape rule names for these operands."""
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul import kernel as sk
    from repro_torch.kernels.sparse_matmul.kernel import packed_ratio
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    bf16 = x.dtype == torch.bfloat16
    if ops[0] == "quant":
        _, xq, w, _, packed = ops
        K, N = int(xq.shape[1]), int(w.shape[1])
        return qk.qmm_route(M, K, N, packed_ratio(packed), bf16,
                            w.data_ptr(), xq.data_ptr())
    _, xs, blocks, _, packed, pat = ops
    sched = schedule_for(pat, x.device)
    bk, bn = pat.block
    return sk.bsm_route(M, bk, bn, packed_ratio(packed), pat.bitmap.shape[1],
                        sched.max_blocks_per_col, bf16, blocks.data_ptr(),
                        blocks.element_size(), xs.data_ptr())


def family_kernel_call(ops, w, act=None):
    """The kernel wrapper call on the operands, with the weight ``w`` (one
    of its copies)."""
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul
    from repro_torch.kernels.sparse_matmul.kernel import block_sparse_matmul
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    if ops[0] == "quant":
        _, xq, _, s, packed = ops
        return lambda: quant_matmul(xq, w, s, activation=act, packed=packed)
    _, xs, _, s, packed, pat = ops
    sched = schedule_for(pat, xs.device)
    return lambda: block_sparse_matmul(xs, w, sched, scales=s,
                                       activation=act, packed=packed)


def family_plain_call(ops, dense_codes, act=None):
    """The plain version on the operands' unpacked codes."""
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref
    if ops[0] == "quant":
        _, xq, _, s, _ = ops
        return lambda: quant_matmul_ref(xq, dense_codes, s, activation=act,
                                        out_dtype=xq.dtype)
    _, xs, _, s, _, pat = ops
    nR, nC = pat.bitmap.shape
    # the coordinates on the card: a capture cannot copy from the host
    rows, cols = (torch.as_tensor(a, device=xs.device)
                  for a in (pat.block_rows, pat.block_cols))
    return lambda: block_sparse_matmul_ref(
        xs, dense_codes, rows, cols, n_row_blocks=nR, n_col_blocks=nC,
        scales=s, activation=act, out_dtype=xs.dtype)


def unpacked(ops):
    from repro_torch.core.quant import unpack_codes
    from repro_torch.kernels.sparse_matmul.kernel import packed_ratio
    w, packed = ops[2], ops[4]
    ratio = packed_ratio(packed)
    if ratio == 1:
        return w
    if ops[0] == "quant":
        return unpack_codes(w, int(ops[1].shape[1]), axis=0, bits=8 // ratio)
    return unpack_codes(w, ops[5].block[0], axis=1, bits=8 // ratio)


def time_family(ops, dense_bf16, M, act, pre=None):
    """Kernel, plain and one-call library times of one leaf's operands at M
    rows (bf16), its inputs outside L2, beside its bound; the kernel's
    largest gap from the plain version by ``act_err`` (``pre``: the plain
    version's f32 pre-activation, where a trelu may flip)."""
    w = ops[2]
    y = family_kernel_call(ops, w, act)()
    ref = family_plain_call(ops, unpacked(ops), act)()
    x = ops[1]
    n = n_copies(nbytes(w))
    ws = copies(w, n)
    codes = unpacked(ops)
    n_plain = min(8, n_copies(nbytes(codes)))
    cs = copies(codes, n_plain)
    ds = copies(dense_bf16, n_copies(nbytes(dense_bf16), 16))
    K = int(x.shape[1])
    if ops[0] == "quant":
        N = int(w.shape[1])
        moved = nbytes(x, w, ops[3]) + M * N * x.element_size()
        ops_n = 2.0 * M * K * N
    else:
        pat = ops[5]
        N = pat.shape[1]
        moved = nbytes(x, w) + M * N * x.element_size() + (
            0 if ops[3] is None else nbytes(ops[3])) + 12 * pat.n_blocks_present
        ops_n = 2.0 * M * pat.n_blocks_present * pat.block[0] * pat.block[1]
    b, by = bound(moved, ops_n, "bf16")
    return {"max_abs_err": act_err(y, ref, act, pre),
            "tol": tol_for(y.dtype, ref.float()),
            "ms": device_ms(lambda i: family_kernel_call(ops, ws[i], act), n),
            "plain_ms": device_ms(
                lambda i: family_plain_call(ops, cs[i], act), n_plain),
            "library_ms": device_ms(lambda i: lambda: x @ ds[i], len(ds)),
            "bound_ms": b, "bound_by": by}


def families_leaves(dev):
    """Step 1: each new family at llama3.2-1b's full-width leaf shapes
    through ``payload_dispatch`` against ``dispatch="twin"`` on every row
    count of FAMILY_CALLS, each call on the route its rule names, then
    timed beside the int4x2 leaf of its kernel at the same shape."""
    from repro_torch.core import payload_registry
    from repro_torch.core.compile_sparse import CompileRules, compile_conv
    from repro_torch.core.dispatch import payload_dispatch
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul import kernel as sk

    rows = {"quant_matmul": [], "block_sparse_matmul": []}
    checked = 0
    rng = np.random.default_rng(20)
    for leaf, (K, N) in FAMILY_SHAPES.items():
        w = (rng.standard_normal((K, N), dtype=np.float32) / math.sqrt(K))
        leaves = dict(FAMILY_LEAVES, quant4=("quant", 4), sparse4=("sparse", 4))
        payloads = {}
        for label, (policy, bits) in leaves.items():
            rules = CompileRules(**FAMILY_RULES, quant_bits=bits)
            payloads[label] = compile_conv(
                w.reshape(1, 1, K, N), policy=policy, rules=rules,
                name=f"{leaf} {label}", device=dev)[0].payload
        int4 = {}
        for label in list(FAMILY_LEAVES) + ["quant4", "sparse4"]:
            p = payloads[label]
            fam = payload_registry.family_of_payload(p).name
            act = "relu" if label == "actsparse" else None
            dense_bf16 = payload_registry.family_of_payload(p).payload_dense(
                p).to(torch.bfloat16)
            for M, dt in FAMILY_CALLS:
                x = torch.randn((M, K), device=dev).to(dt)
                ops = family_operands(p, x)
                kernel = "quant_matmul" if ops[0] == "quant" \
                    else "block_sparse_matmul"
                mod = qk if ops[0] == "quant" else sk
                route, plan = family_route(ops, M, x)
                y = took_route(mod, QMM_ROUTES, route, lambda: payload_dispatch(
                    p, x, activation=act, leaf=f"{leaf} {label}"))
                ref = payload_dispatch(p, x, activation=act, dispatch="twin")
                pre = None
                if act is not None:  # trelu: either side within the band
                    pre = payload_dispatch(p, x, dispatch="twin",
                                           compute_dtype=torch.float32)
                torch.cuda.synchronize()
                err = act_err(y, ref, ("trelu", FAMILY_TAU) if act else None,
                              pre)
                tol = tol_for(dt, ref.float())
                require(bool(torch.isfinite(y).all()) and err <= tol,
                        f"families: {leaf} {label} ({fam}) M={M} {dt}: "
                        f"kernel vs twin max abs err {err} > {tol}")
                checked += 1
                if (M, dt) not in FAMILY_TIMED:
                    continue
                t = time_family(ops, dense_bf16, M,
                                ("trelu", FAMILY_TAU) if act else None,
                                pre if route == "tensor_core" else None)
                row = {"family": fam, "leaf": leaf, "label": label,
                       "shape": f"M={M} K={K} N={N}", "route": route,
                       "container": ops[4] or str(ops[2].dtype).split(
                           ".")[-1],
                       "twin_err": err, "tol": tol, **t}
                if label in ("quant4", "sparse4"):
                    int4[(kernel, M)] = t["ms"]
                    continue
                rows[kernel].append(row)
            del dense_bf16
        for kernel, rs in rows.items():
            for r in rs:
                if r["leaf"] == leaf and "int4x2_ms" not in r:
                    r["int4x2_ms"] = int4[(kernel, int(
                        r["shape"].split()[0][2:]))]
        del payloads
        torch.cuda.empty_cache()
    return rows, checked


def compiled_leaves(cm):
    """(path, leaf) of each compiled linear: layer 0's slice of every block
    linear, the hybrid's unstacked shared attention block, and the untied
    head where the model has one."""
    from repro_torch.core.compile_sparse import _iter_linears
    for path, parent, key in _iter_linears(cm.params["blocks"], "blocks"):
        yield path, {k: v[0] for k, v in parent[key].items()}
    if isinstance(cm.params.get("shared_attn"), dict):
        for path, parent, key in _iter_linears(cm.params["shared_attn"],
                                               "shared_attn"):
            yield path, parent[key]
    if isinstance(cm.params.get("head"), dict):
        yield "head", cm.params["head"]


def leaf_ops(cm, path, leaf, x):
    """What the leaf's family hands its kernel for the activation ``x`` (as
    ``family_operands``; the scales leaf is ``w_s``, None where the family
    keeps others), or None for a dense leaf."""
    from repro_torch.core import payload_registry
    fam = payload_registry.family_for_leaves(leaf)
    if fam.name == "dense":
        return None
    shape_of = {r.name: r.shape for r in cm.report}
    if fam.name in ("sparse", "sparse_packed", "actsparse"):
        pat = cm.patterns[shape_of[path]]
        blocks = leaf[fam.key_leaf]
        packed = "int2x4" if fam.name == "sparse_packed" and \
            blocks.shape[1] * 4 == pat.block[0] else (
                "int4x2" if fam.name == "sparse_packed" else False)
        return "sparse", x, blocks, leaf.get("w_s"), packed, pat
    packed = {"int2": "int2x4", "quant_packed": "int4x2"}.get(fam.name, False)
    return "quant", x, leaf[fam.key_leaf], leaf.get("w_s"), packed


ROUTE_COUNTER = {("quant", "thin_m"): QMM_THIN,
                 ("quant", "tensor_core"): QMM_TC,
                 ("quant", "tiled"): QMM_TILED,
                 ("sparse", "thin_m"): BSM_THIN,
                 ("sparse", "tensor_core"): BSM_TC,
                 ("sparse", "tiled"): BSM_TILED}


def decode_want(cm, cfg, dev, M=1):
    """The launches per route one step of M rows (a decode step of M slots,
    or a prefill chunk of M rows) needs, from each layer-0 leaf's and the
    head's operands through its kernel's shape rule.  A block leaf runs
    once a layer, the hybrid's shared block once a super-block, the head
    once."""
    from repro_torch.models.model import n_superblocks
    want = dict.fromkeys(ROUTE_COUNTER.values(), 0)
    shape_of = {r.name: r.shape for r in cm.report}
    for path, leaf in compiled_leaves(cm):
        x = torch.zeros((M, shape_of[path][0]), device=dev,
                        dtype=torch.bfloat16)
        ops = leaf_ops(cm, path, leaf, x)
        if ops is None:
            continue
        route, _ = family_route(ops, M, x)
        want[ROUTE_COUNTER[(ops[0], route)]] += 1 if path == "head" else (
            n_superblocks(cfg) if path.startswith("shared_attn/")
            else cfg.n_layers)
    return want


def family_serve(cm, cfg, dev, prompts):
    """The same requests through a captured and an eager engine: tokens,
    and the launches by route of the captured run."""
    from repro_torch.serve.engine import Request
    out = {}
    for capture in (True, False):
        eng = serve_engine(cm, cfg, dev, capture=capture)
        reset_counts()
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        done = sorted(eng.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        out["captured" if capture else "eager"] = {
            "tokens": [r.out for r in done], "counts": read_counts(),
            "graphs": eng.stats()["graphs"]}
        del eng
    return out


def families_models(dev):
    """Step 2: llama3.2-1b at full width under FAMILY_MODELS: per-leaf
    policies and bytes, the H100_SXM picks (an estimate), the twin check
    and the same 4 requests served captured and eager."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_sparse import (CompileRules, _fit_block,
                                                 choose_policy, compile_model)
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.models.model import init_params

    cfg = get_config("llama3.2-1b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in (24, 40, 56, 64)]
    out = {}
    for name, over in FAMILY_MODELS.items():
        params = init_params(cfg, seed=0, device=dev)
        rules = CompileRules(**FAMILY_MODEL_RULES, **over)
        t0 = time.perf_counter()
        cm = compile_model(params, cfg, rules=rules, device=dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        del params
        h100 = dataclasses.replace(rules, hw=H100_SXM, policies=None)
        bd = rules.block_density
        ed = rules.block_density * rules.in_block_density
        picks = {r.name: r.policy for r in cm.report}
        estimate = {r.name: choose_policy(
            *r.shape, rules=h100, block_density=bd, element_density=ed,
            sparse_eligible=_fit_block(*r.shape, rules.block) is not None)
            for r in cm.report}
        print(f"families {name}: policies {json.dumps(picks)}, "
              f"container_storage_bytes {cm.container_storage_bytes}; "
              f"H100_SXM cost-model picks (an estimate, not run): "
              f"{json.dumps(estimate)}", flush=True)
        want = decode_want(cm, cfg, dev)
        tw = twin_check(cm, cfg, dev, prompts[0][:16], "int4x2", want=want)
        served = family_serve(cm, cfg, dev, prompts)
        cap, eag = served["captured"], served["eager"]
        require(cap["tokens"] == eag["tokens"],
                f"families {name}: captured and eager serving gave "
                f"different tokens")
        require(all(len(t) == 8 and all(0 <= v < cfg.vocab for v in t)
                    for t in cap["tokens"]),
                f"families {name}: a request got a bad answer")
        counts = cap["counts"]
        if name == "family_map":  # actsparse's wg / wu / wd: never tiled
            require(want[BSM_TILED] == 0 and counts[BSM_TILED] == 0,
                    f"families {name}: tiled block_sparse_matmul launches "
                    f"{want[BSM_TILED]} due, {counts[BSM_TILED]} served")
        for kernel, routes in (("quant_matmul", (QMM_THIN, QMM_TC,
                                                 QMM_TILED)),
                               ("block_sparse_matmul", (BSM_THIN, BSM_TC,
                                                        BSM_TILED))):
            named = [r for r in routes if want[r]]
            require(counts[kernel] == sum(counts[r] for r in named) and
                    (counts[kernel] > 0) == bool(named),
                    f"families {name}: served {kernel} launches "
                    f"{ {r: counts[r] for r in routes} }, every one due on "
                    f"{named}")
        out[name] = {
            "compile_s": compile_s, "policies": picks,
            "h100_sxm_estimate": estimate,
            "container_storage_bytes": cm.container_storage_bytes,
            "byte_compression": cm.byte_compression,
            "decode_launches_by_route": want,
            "twin_check": {k: tw[k] for k in ("max_rel_err", "tol")},
            "served_launches": {k: v for k, v in counts.items() if v},
            "graphs": cap["graphs"]}
        if name == "family_map":
            # the captured decode step, and the share of its device time in
            # block_sparse_matmul's kernels: the actsparse leaves alone
            out[name]["decode_profile"] = profile_step(
                cm, cfg, dev, "decode", True, share=("bsm",))
        del cm
        torch.cuda.empty_cache()
    return out


def families_lenet(dev):
    """Step 3: LeNet-5 at its published widths with no policies (the cost
    model's pick) and with the convs as quant at 2 bits; the fused forward
    on 256 digits against the twin, with its launches; each compile's
    convs timed on its own operands (inputs warm in L2); run_dse and
    balanced_folding_baseline at the Table-I budget (estimates)."""
    from repro_torch.core.compile_sparse import (CompileRules, compile_lenet,
                                                 realised_densities)
    from repro_torch.core.cost_model import H100_SXM, TPU_V5E, network_estimate
    from repro_torch.core.dse import (apply_realised_densities,
                                      balanced_folding_baseline, run_dse)
    from repro_torch.data.synthetic import synthetic_digits
    from repro_torch.kernels.quant_matmul.kernel import quant_conv
    from repro_torch.kernels.quant_matmul.ref import quant_conv_ref
    from repro_torch.kernels.sparse_matmul.kernel import block_sparse_conv
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_conv_ref
    from repro_torch.models.lenet import (init_lenet, lenet_forward,
                                          lenet_layer_specs)

    params = init_lenet(seed=0, device=dev)
    images, _ = synthetic_digits(0, noise=1.1).batch(0, LENET_BATCH)
    x = torch.from_numpy(images).to(dev)
    out, conv_rows, sparse_conv_rows = {}, [], []
    for cname, (rules_kw, policies, expect) in LENET_FAMILY_CONFIGS.items():
        cm = compile_lenet(params, rules=CompileRules(**rules_kw,
                                                      policies=policies),
                           blocks=LENET_BLOCKS, device=dev)
        picks = {r.name: r.policy for r in cm.report}
        if policies is None:
            require(set(picks.values()) == {"sparse"},
                    f"lenet {cname}: the cost model picked {picks}, the "
                    "reference picks sparse for all five layers")
        lenet_forward(params, x, compressed=cm.layers, fusion=True)
        torch.cuda.synchronize()
        reset_counts()
        y = lenet_forward(params, x, compressed=cm.layers, fusion=True)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: expect.get(k, 0) for k in counts}
        require(counts == want, f"lenet {cname}: one fused forward launched "
                                f"{counts}, expected {want}")
        yt = lenet_forward(params, x, compressed=cm.layers, fusion=True,
                           dispatch="twin")
        top = float(yt.abs().max())
        err = float((y - yt).abs().max())
        require(tuple(y.shape) == (LENET_BATCH, 10)
                and bool(torch.isfinite(y).all()), f"lenet {cname}: bad logits")
        require(err <= LENET_TOL * top, f"lenet {cname}: kernel vs twin "
                                        f"logits max abs err {err} > "
                                        f"{LENET_TOL} x {top}")
        specs = apply_realised_densities(lenet_layer_specs(),
                                         realised_densities(cm))
        dse = {}
        for hw in (TPU_V5E, H100_SXM):
            res = run_dse(specs, hw=hw, resource_budget=DSE_BUDGET)
            base = network_estimate(
                specs, balanced_folding_baseline(specs, hw, DSE_BUDGET), hw)
            dse[hw.name] = {
                "sparse_layers": res.sparse_layers, "moves": len(res.trace) - 1,
                "ii_s": res.estimate.ii, "latency_s": res.estimate.latency,
                "resource": res.estimate.resource,
                "baseline_ii_s": base.ii, "baseline_resource": base.resource,
                "folding": [(c.unroll, c.parallelism) for c in res.configs]}
        out[cname] = {"policies": picks, "launches_per_forward": counts,
                      "max_abs_err_vs_twin": err, "tol": LENET_TOL * top,
                      "container_storage_bytes": cm.container_storage_bytes,
                      "dse_estimate": dse}
        if cname == "auto":  # the cost model's picks on block_sparse_conv
            h = x
            for name in ("conv1", "conv2"):
                cp = cm.layers[name]
                pl, pat = cp.payload, cp.payload.pattern
                nR, nC = pat.bitmap.shape
                blocks, packed = sparse_conv_operands(cp)
                vals = pl.block_values()
                sched = schedule_for(pat, dev)
                rws, cls = (torch.as_tensor(a, device=dev)
                            for a in (pat.block_rows, pat.block_cols))
                b = params[name + "_b"]
                kw = dict(kernel_hw=cp.kernel[:2], activation="relu",
                          pool=("avg", 2))
                yk = block_sparse_conv(h, blocks, sched, scales=pl.scales,
                                       bias=b, packed=packed, **kw)
                yr = block_sparse_conv_ref(h, vals, rws, cls, n_row_blocks=nR,
                                           n_col_blocks=nC, scales=pl.scales,
                                           bias=b, **kw)
                err = f32_check(f"block_sparse_conv auto {name}", yk, yr)
                B_, H_, W_, C_ = h.shape
                Ho, Wo = H_ - cp.kernel[0] + 1, W_ - cp.kernel[1] + 1
                bk, bn = pat.block
                b_ms, b_by = bound(
                    nbytes(h, blocks, pl.scales, b, yk, sched.col_ptr,
                           sched.rows, sched.pidx),
                    2.0 * B_ * Ho * Wo * pat.n_blocks_present * bk * bn, "f32")
                sparse_conv_rows.append({
                    "family": "sparse (cost-model pick)", "leaf": name,
                    "container": packed or str(blocks.dtype).split(".")[-1],
                    "blocks": f"{pat.n_blocks_present}/{pat.n_blocks_total} "
                              f"of {pat.block}",
                    "shape": f"B={B_} {H_}x{W_}x{C_} K={cp.K} N={cp.N}",
                    "max_abs_err": err,
                    "ms": device_ms(lambda i: lambda: block_sparse_conv(
                        h, blocks, sched, scales=pl.scales, bias=b,
                        packed=packed, **kw), 16),
                    "plain_ms": device_ms(
                        lambda i: lambda: block_sparse_conv_ref(
                            h, vals, rws, cls, n_row_blocks=nR,
                            n_col_blocks=nC, scales=pl.scales, bias=b, **kw),
                        4),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": device_ms(lambda i: conv2d_call(cp, h), 16)})
                h = yk
        if cname == "int2_conv":
            h = x
            for name in ("conv1", "conv2"):
                cp = cm.layers[name]
                w_q, packed, codes = quant_conv_operands(cp)
                s = cp.payload.scales.reshape(cp.N)
                b = params[name + "_b"]
                kw = dict(kernel_hw=cp.kernel[:2], activation="relu",
                          pool=("avg", 2))
                yk = quant_conv(h, w_q, s, b, packed=packed, **kw)
                yr = quant_conv_ref(h, codes, s, b, out_dtype=h.dtype, **kw)
                torch.cuda.synchronize()
                B_, H_, W_, C_ = h.shape
                Ho, Wo = H_ - cp.kernel[0] + 1, W_ - cp.kernel[1] + 1
                b_ms, b_by = bound(nbytes(h, w_q, s, b, yk),
                                   2.0 * B_ * Ho * Wo * cp.K * cp.N, "f32")
                conv_rows.append({
                    "family": "int2", "leaf": name,
                    "container": "int2x4 along "
                    + ("K" if cp.payload.axis == 0 else "N"),
                    "kernel_codes": packed or "int8 (unpacked once)",
                    "shape": f"B={B_} {H_}x{W_}x{C_} K={cp.K} N={cp.N}",
                    "max_abs_err": float((yk - yr).abs().max()),
                    "ms": device_ms(lambda i: lambda: quant_conv(
                        h, w_q, s, b, packed=packed, **kw), 16),
                    "plain_ms": device_ms(lambda i: lambda: quant_conv_ref(
                        h, codes, s, b, out_dtype=h.dtype, **kw), 4),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": device_ms(lambda i: conv2d_call(cp, h), 16)})
                f32_check(f"quant_conv int2 {name}", yk, yr)
                h = yk
        del cm
    return out, conv_rows, sparse_conv_rows


def families(dev, report, kernels):
    """The families phase: steps 1-3; the kernels line's quant_matmul,
    block_sparse_matmul, block_sparse_conv and quant_conv entries gain a
    ``families`` list."""
    t0 = time.perf_counter()
    rows, checked = families_leaves(dev)
    t1 = time.perf_counter()
    models = families_models(dev)
    t2 = time.perf_counter()
    lenet_out, rows["quant_conv"], rows["block_sparse_conv"] = \
        families_lenet(dev)
    t3 = time.perf_counter()
    for k in kernels:
        if k["name"] in rows:
            k["families"] = rows[k["name"]]
    report["families"] = {"leaf_calls_checked": checked, "models": models,
                          "lenet": lenet_out, "rows": rows,
                          "seconds": {"leaves": t1 - t0, "models": t2 - t1,
                                      "lenet": t3 - t2}}


# -------------------------------------------------------------------- zoo


ZOO_ARCHS = ("qwen1.5-4b", "starcoder2-7b")
# the leaves timed at M = 8 beside their bound, plain and library times
ZOO_LEAVES = {"qwen1.5-4b": ("blocks/attn/wq", "blocks/mlp/wg",
                             "blocks/mlp/wd", "head"),
              "starcoder2-7b": ("blocks/attn/wq", "blocks/attn/wk",
                                "blocks/mlp/wu", "blocks/mlp/wd", "head")}
ZOO_M = 8
# the zoo configs' depth on the card: a quarter of their layers (40 and
# 32), at full width, so the script stays well inside its time limit
# cut in depth to keep the script within its time limit: 6 of qwen1.5-4b's
# 40 layers and 4 of starcoder2-7b's 32
ZOO_LAYERS = {"qwen1.5-4b": 6, "starcoder2-7b": 4}
# The zoo configs' int4x2 twin bound.  qwen1.5-4b keeps TWIN_TOL.  For
# starcoder2-7b the gap is int4 K/V code flips compounding through its 32
# layers (measured at its full depth): a one-step bf16 difference flips a code, which moves that value
# by amax/7.  ``twin_layers`` records it on the card: the share of a
# layer's K/V codes that differ between the kernel and plain paths grows
# with depth, while with the float cache the two agree within TWIN_TOL;
# and the plain bf16 path is itself 0.12-0.14 from the plain f32 path on
# the same cache (NVIDIA H100 80GB HBM3, 700 W).  So the kernel path is
# held to that distance, 0.15, not to TWIN_TOL.
ZOO_TWIN_TOL = {"qwen1.5-4b": TWIN_TOL["int4x2"], "starcoder2-7b": 0.15}
# the acceptance matrix's compressed forwards reach these kernels
MATRIX_KERNELS = ("block_sparse_matmul", "quant_matmul", "block_sparse_conv",
                  "quant_conv", "fc_stack_matmul", "flash_attention")


def zoo_rules(cfg):
    """SERVE_RULES for ``cfg``: a policy key that names no leaf raises in
    ``compile_model``, so the keys ``cfg`` has no leaf for are dropped (a
    GELU MLP has no ``wg``; an MoE without a shared expert has no MLP
    leaf, its routed experts and router are never compiled)."""
    from repro_torch.core.compile_sparse import CompileRules
    mlp = cfg.family != "moe" or cfg.n_shared_experts
    pols = {k: v for k, v in SERVE_RULES["policies"].items()
            if (k != "wg" or cfg.act == "swiglu")
            and (mlp or k not in ("wg", "wu", "wd"))}
    return CompileRules(**{**SERVE_RULES, "policies": pols})


class RssPeak:
    """The process's resident set in bytes before a block and its peak
    while the block runs, sampled from /proc/self/statm every 20 ms."""

    def __enter__(self):
        import os
        import threading
        self._page = os.sysconf("SC_PAGE_SIZE")
        self.before = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def family_model(arch, dev, layers=None):
    """A config at full width (``layers`` cuts its depth) from seed 0,
    compiled with ``zoo_rules`` (the head left to the cost model), with
    the compile's host and device peaks (the zoo and encoder/VLM/MoE
    phases)."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_sparse import compile_model
    from repro_torch.models.model import init_params

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with RssPeak() as rss:
        cm = compile_model(params, cfg, rules=zoo_rules(cfg), device=dev)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    out = {"n_layers": cfg.n_layers, "init_params_s": t1 - t0,
           "compile_s": t2 - t1, "host_rss_before_compile": rss.before,
           "host_rss_peak_compile": rss.peak,
           "device_peak_init_compile": torch.cuda.max_memory_allocated(),
           "param_bytes": int(sum(r.dense_bytes for r in cm.report)),
           "container_storage_bytes": cm.container_storage_bytes,
           "byte_compression": cm.byte_compression,
           "policies": {r.name: r.policy for r in cm.report}}
    print(f"{arch}: {cfg.n_layers} layers compiled in {out['compile_s']:.1f}"
          f" s, policies {json.dumps(out['policies'])}", flush=True)
    return cm, cfg, out


def head_route(cm, dev, M):
    """The kernel and route of the untied head's call on M rows (None for
    a dense head)."""
    shape_of = {r.name: r.shape for r in cm.report}
    x = torch.zeros((M, shape_of["head"][0]), device=dev, dtype=torch.bfloat16)
    ops = leaf_ops(cm, "head", cm.params["head"], x)
    return None if ops is None else ROUTE_COUNTER[(ops[0], family_route(
        ops, M, x)[0])]


def twin_layers(cm, cfg, dev, prompt):
    """Where the int4x2 twin gap enters: one prefill chunk and 4 decode
    steps (teacher-forced with the kernel path's tokens) through the
    kernel path, the plain path and the plain path in f32 (its bf16
    leaves cast up); the logits' gaps (relative to the largest logit) and,
    per layer, the share of the chunk's K/V codes that differ and the
    largest relative gap of its K scales.  A record: ``twin_check`` holds
    the bound."""
    from repro_torch.core.quant import unpack_int4
    from repro_torch.models.model import decode_step, init_cache, prefill_step
    from repro_torch.tree import tree_map
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    paths = {"kernel": (cm.params, cfg, "auto"),
             "plain": (cm.params, cfg, "twin"),
             "plain_f32": (tree_map(lambda t: t.float() if t.dtype
                                    == torch.bfloat16 else t, cm.params),
                           f32, "twin")}
    toks = torch.as_tensor(prompt[None], device=dev)
    caches = {k: init_cache(c, 1, 512, kv_cache="int4x2", device=dev)
              for k, (_, c, _) in paths.items()}
    logits = {k: [prefill_step(p, c, caches[k], toks, patterns=cm.patterns,
                               dispatch=m, t_bound=32, bt=64)[0][0, -1]
                  .float()] for k, (p, c, m) in paths.items()}
    C = len(prompt)
    codes = {k: [unpack_int4(caches[k][leaf][:, 0, :C], cfg.head_dim,
                             axis=-1) for leaf in ("k_p", "v_p")]
             for k in paths}
    scales = {k: caches[k]["k_s"][:, 0, :C].float() for k in paths}
    for _ in range(4):
        tok = torch.argmax(logits["kernel"][-1]).view(1, 1)
        for k, (p, c, m) in paths.items():
            logits[k].append(decode_step(p, c, caches[k], tok,
                                         patterns=cm.patterns, dispatch=m,
                                         t_bound=64, bt=64)[0][0, -1].float())
    out = {}
    for a, b in (("kernel", "plain"), ("kernel", "plain_f32"),
                 ("plain", "plain_f32")):
        out[f"{a}_vs_{b}"] = {
            "logits": [float((x - y).abs().max() / y.abs().max())
                       for x, y in zip(logits[a], logits[b])],
            "code_flip_share": [float(sum((ca[i] != cb[i]).float().mean()
                                          for ca, cb in zip(codes[a],
                                                            codes[b])) / 2)
                                for i in range(cfg.n_layers)],
            "k_scale_gap": [float((scales[a][i] - scales[b][i]).abs().max()
                                  / scales[b][i].abs().max())
                            for i in range(cfg.n_layers)]}
    return out


def pda_route(cfg, B, C, bt):
    """The route ``pda_plan`` names for a serving read of C rows of B
    slots: the split kernel, for every config and read the serving paths
    run (the single kernel is for shapes outside the split build), so
    every count checked against it holds ``launches_single`` to 0."""
    from repro_torch.kernels.flash_attention import decode_packed as dp
    plan = dp.pda_plan(B, C, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 512,
                       bt)
    require(plan is not None,
            f"{cfg.name}: pda_plan sends a serving read of C={C} rows of "
            f"B={B} slots (Dh {cfg.head_dim}, bt {bt}) to the single kernel")
    return PDA_SPLIT


def serve_want(cm, cfg, dev, decode_steps, prefill_steps):
    """The launches by route of a serving window: decode steps of 8 slots
    and 16-row prefill chunks, each call on the route its rule names."""
    from repro_torch.core.dispatch import ATTN_BT_DEFAULT
    from repro_torch.models.model import n_superblocks
    want = {PDA_SPLIT: 0, PDA_SINGLE: 0}
    for M, steps, C in ((8, decode_steps, 1), (16, prefill_steps, 16)):
        for k, n in decode_want(cm, cfg, dev, M).items():
            want[k] = want.get(k, 0) + n * steps
        B = 8 if C == 1 else 1
        want[pda_route(cfg, B, C, ATTN_BT_DEFAULT)] += \
            n_superblocks(cfg) * steps
    return want


def zoo_leaf_rows(cm, cfg, dev, leaves_m=None):
    """Leaves of the compiled model at M rows (bf16): ``leaves_m`` ((path,
    M) pairs; default ZOO_LEAVES at M = 8), each on the route its rule
    names, held against its plain version and timed beside its bound and
    the one-call library yardstick (``x @ W``, W dense bf16)."""
    from repro_torch.core.compile_sparse import _decompress_leaf
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul import kernel as sk
    shape_of = {r.name: r.shape for r in cm.report}
    policy_of = {r.name: r.policy for r in cm.report}
    leaves = dict(compiled_leaves(cm))
    rows = {"quant_matmul": [], "block_sparse_matmul": []}
    if leaves_m is None:
        leaves_m = [(path, ZOO_M) for path in ZOO_LEAVES[cfg.name]]
    for path, M in leaves_m:
        K, N = shape_of[path]
        x = torch.randn((M, K), device=dev).to(torch.bfloat16)
        ops = leaf_ops(cm, path, leaves[path], x)
        require(ops is not None, f"zoo {cfg.name}: {path} compiled dense")
        kernel = "quant_matmul" if ops[0] == "quant" \
            else "block_sparse_matmul"
        route, plan = family_route(ops, M, x)
        took_route(qk if ops[0] == "quant" else sk, QMM_ROUTES, route,
                   family_kernel_call(ops, ops[2]))
        dense = _decompress_leaf(leaves[path], cm.patterns.get((K, N)),
                                 torch.bfloat16, shape=(K, N))["w"]
        t = time_family(ops, dense, M, None)
        del dense
        if path == "head" and ops[0] == "quant" and route != "tiled":
            t["first_version_ms"] = first_quant_ms(ops)
        label = f"zoo {cfg.name} {path} M={M} K={K} N={N} {route}"
        require(t["max_abs_err"] <= t["tol"],
                f"{label}: kernel vs plain max abs err {t['max_abs_err']}")
        detail = {"policy": policy_of[path], "container": ops[4] or str(
            ops[2].dtype).split(".")[-1]}
        if ops[0] == "sparse":
            pat = ops[5]
            detail["blocks"] = (f"{pat.n_blocks_present}/"
                                f"{pat.n_blocks_total} of {pat.block}")
        if route == "thin_m":
            detail["plan"] = list(plan)
        rows[kernel].append({"config": cfg.name, "leaf": path,
                             "shape": f"M={M} K={K} N={N}",
                             "route": route, **detail, **t})
        torch.cuda.empty_cache()
    return rows


def first_quant_ms(ops):
    """The first design of quant_matmul (the tiled kernel) on a leaf's
    operands, its codes outside L2 as ``time_family`` reads them."""
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul.kernel import packed_ratio
    _, xq, w, s, packed = ops
    ws = copies(w, n_copies(nbytes(w)))
    return device_ms(lambda i: lambda: qk._launch(
        xq, ws[i], s, None, None, packed_ratio(packed), "tiled"), len(ws))


def zoo_attention_row(cfg, dev, B, C, lens, T=512, bt=64):
    """packed_decode_attention over B slots of a T-row int4x2 cache, C query
    rows a slot (``lens`` (B, C): live rows of each), on the route
    ``pda_plan`` names, held against its plain version and timed beside its
    bound, SDPA on the dequantised bf16 cache and the first design (the
    single kernel, ``first_version_ms``).  Where other caps on a row group
    (4, 8, 16, 32, 64 rows) cut the C·G rows otherwise than the rule, the
    split read is timed again with each (``group_cap_ms``), held to the
    rule's bits."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import decode_packed as dp
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    q = torch.randn((B, C, H, Dh), device=dev).to(torch.bfloat16)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    caches = [random_cache(B, T, Hkv, Dh, dev)[:4] for _ in range(16)]
    k_p, v_p = caches[0][:2]
    plan = dp.pda_plan(B, C, H, Hkv, Dh, T, bt, k_p.data_ptr()
                       | v_p.data_ptr() | int(k_p.stride(0)))
    route = "single" if plan is None else "split"
    routes = {"split": "launches_split", "single": "launches_single"}
    y = took_route(dp, routes, route, lambda: dp.packed_decode_attention(
        q, *caches[0], lengths, bt=bt))
    ref = dp.tiled_packed_attention(q, *caches[0], lengths, bt=bt)
    torch.cuda.synchronize()
    err, tol = float((y.float() - ref.float()).abs().max()), \
        flash_tol(torch.bfloat16, ref)
    label = f"zoo {cfg.name} attention B={B} C={C} G={G} Dh={Dh} {route}"
    require(err <= tol, f"{label}: max abs err {err}")

    def dequantised(c):
        k_p, v_p, k_s, v_s = c
        kd, vd = ((unpack(a).float() * s[..., None]).to(torch.bfloat16)
                  .permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
                  for a, s in ((k_p, k_s), (v_p, v_s)))
        return kd, vd

    def unpack(a):
        from repro_torch.core.quant import unpack_int4
        return unpack_int4(a, Dh, axis=-1)

    kvd = [dequantised(c) for c in caches[:4]]
    qh = q.permute(0, 2, 1, 3)
    mask = (torch.arange(T, device=dev)[None, None, :]
            < lengths[:, :, None])[:, None]
    live = np.asarray(lens)
    b, by = bound(nbytes(q, y, lengths)
                  + int(live.max(axis=1).sum()) * Hkv * (Dh + 8),
                  4.0 * H * Dh * float(live.sum()), "bf16")
    row = {"config": cfg.name, "shape": f"B={B} C={C} H={H} Hkv={Hkv} "
           f"Dh={Dh} extent {T}, bt={bt}, live rows {int(live.sum())}",
           "route": route, "max_abs_err": err, "tol": tol,
           "ms": device_ms(lambda i: lambda: dp.packed_decode_attention(
               q, *caches[i], lengths, bt=bt), 16),
           "plain_ms": device_ms(lambda i: lambda: dp.tiled_packed_attention(
               q, *caches[i], lengths, bt=bt), 4),
           "bound_ms": b, "bound_by": by,
           "library_ms": device_ms(
               lambda i: lambda: F.scaled_dot_product_attention(
                   qh, *kvd[i], attn_mask=mask), 4)}
    row["first_version_ms"] = device_ms(lambda i: lambda: dp._launch(
        q, *caches[i], lengths, bt, None), 16)
    if plan is not None:
        row["plan"] = list(plan)
        row["group_cap_ms"] = {}
        for cap in (4, 8, 16, 32, 64):
            alt = plan._replace(**dict(zip(
                ("n_groups", "group_rows"), dp.split_row_groups(C * G, cap))))
            if alt == plan:
                continue
            require(torch.equal(dp._launch(q, *caches[0], lengths, bt, alt),
                                y), f"{label}: row groups {alt} changed bits")
            row["group_cap_ms"][cap] = device_ms(
                lambda i: lambda: dp._launch(q, *caches[i], lengths, bt, alt),
                16)
    return row


def zoo_model(arch, dev):
    """One config at full width, cut to ``ZOO_LAYERS`` in depth: compile
    with the serving rules (host and device peaks), the twin check, the serve phase's 16 requests captured
    (every launch on the route its rule names) and eagerly (the same
    tokens), the captured steps' profiles, and the leaf and attention
    rows."""
    cm, cfg, out = family_model(arch, dev, ZOO_LAYERS[arch])
    out["head_route"] = {M: head_route(cm, dev, M) for M in (1, 8, 16)}
    out["launches_per_step"] = {
        "decode": decode_want(cm, cfg, dev, 8),
        "prefill": decode_want(cm, cfg, dev, 16)}
    print(f"zoo {arch}: the head, picked by the cost model: "
          f"{out['policies'].get('head')} on the routes "
          f"{json.dumps(out['head_route'])} (rows M)", flush=True)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(64, 257, size=16)]
    out["twin_check"] = {}
    for kv, tol in (("float", TWIN_TOL["float"]),
                    ("int4x2", ZOO_TWIN_TOL[arch])):
        tw = twin_check(cm, cfg, dev, prompts[0][:16], kv,
                        want=decode_want(cm, cfg, dev), tol=tol)
        out["twin_check"][kv] = {k: tw[k] for k in ("max_rel_err", "tol",
                                                     "steps")}
    out["twin_layers"] = twin_layers(cm, cfg, dev, prompts[0][:16])
    print(f"zoo {arch}: twin check {json.dumps(out['twin_check'])}; "
          f"by layer {json.dumps(out['twin_layers'])}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    eng, cap, counts = serve_run(cm, cfg, dev, prompts, count=True)
    del eng
    want = serve_want(cm, cfg, dev, cap["decode_steps"], cap["prefill_steps"])
    got = {k: counts[k] for k in want}
    require(got == want, f"zoo {arch}: served launches by route {got}, "
                         f"the shape rules name {want}")
    _, eager, _ = serve_run(cm, cfg, dev, prompts, capture=False)
    require(eager.pop("tokens") == cap["tokens"],
            f"zoo {arch}: captured and eager serving gave different tokens")
    tokens = cap.pop("tokens")
    require(all(len(t) == 32 and all(0 <= v < cfg.vocab for v in t)
                for t in tokens), f"zoo {arch}: a request got a bad answer")
    out["device_peak_serve"] = torch.cuda.max_memory_allocated()
    out["serve"] = {**cap, "launches": {k: v for k, v in counts.items() if v},
                    "eager": eager}
    out["step_profile"] = {f"{ph}_captured": profile_step(cm, cfg, dev, ph,
                                                          True)
                           for ph in ("decode", "prefill")}
    print(f"zoo {arch}: serve {json.dumps(out['serve'])}", flush=True)
    print(f"zoo {arch}: step profile {json.dumps(out['step_profile'])}",
          flush=True)

    rows = zoo_leaf_rows(cm, cfg, dev)
    del cm
    torch.cuda.empty_cache()
    lens = np.random.default_rng(1).integers(64, 320, size=(8, 1))
    rows["packed_decode_attention"] = [zoo_attention_row(cfg, dev, 8, 1, lens)]
    if arch == "starcoder2-7b":
        rows["packed_decode_attention"].append(zoo_attention_row(
            cfg, dev, 1, 16, 200 + np.arange(1, 17)[None]))
    return out, rows


def zoo_matrix(dev):
    """The acceptance matrix on the card: ``build_matrix`` with every
    compressed forward under ``dispatch="kernel"``, on the port's own
    seeded weights (drawn on the host, as on the CPU).  Requires
    ``floor_fails`` to find nothing: every oracle floor, the 8
    expected_fail cells really failing their dense floor, bfp8@2 passing
    on every config and all 64 cells run, the autotune cells among them;
    returns the payload and the launches it made."""
    from repro_torch.core import acceptance as acc

    reset_counts()
    t0 = time.perf_counter()
    m = acc.build_matrix(time_cells=True, log=lambda s: None, device=dev,
                         dispatch="kernel")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    for name in MATRIX_KERNELS:
        require(counts[name] > 0, f"zoo matrix: no {name} launch")
    xf = sorted(k for k, r in m["cells"].items() if r["expected_fail"])
    require(len(xf) == 8, f"zoo matrix: expected_fail cells {xf}")
    require(len(m["cells"]) == 64 and not m["not_run"],
            f"zoo matrix: {len(m['cells'])} cells run, not run "
            f"{m['not_run']}")
    fails = acc.floor_fails(m)
    require(not fails, f"zoo matrix on the card: {fails}")
    # the dense floors of the other weight-preserving cells, as data: they
    # were set on the reference's weights
    dense_floors = {k: r["dense_top1"] >= acc.DENSE_TOP1_FLOOR[r["bits"]]
                    for k, r in m["cells"].items()
                    if r["policy"] in acc.WEIGHT_PRESERVING
                    and not r["expected_fail"]}
    return {"seconds": seconds, "cells": m["cells"], "not_run": m["not_run"],
            "dense_floor_held": dense_floors,
            "launches": {k: v for k, v in counts.items() if v}}


def zoo(dev, report, kernels):
    """The zoo phase: qwen1.5-4b and starcoder2-7b at full width, then the
    acceptance matrix; the kernels line's quant_matmul,
    block_sparse_matmul and packed_decode_attention entries gain a ``zoo``
    list."""
    out, rows = {}, {}
    t0 = time.perf_counter()
    for arch in ZOO_ARCHS:
        t = time.perf_counter()
        out[arch], r = zoo_model(arch, dev)
        out[arch]["seconds"] = time.perf_counter() - t
        for k, v in r.items():
            rows.setdefault(k, []).extend(v)
        torch.cuda.empty_cache()
    out["matrix"] = zoo_matrix(dev)
    out["seconds"] = time.perf_counter() - t0
    for k in kernels:
        if k["name"] in rows:
            k["zoo"] = rows[k["name"]]
    report["zoo"] = out
    report["zoo_rows"] = rows


# -------------------------------------------- encoder, VLM and MoE families


ENCODER_ARCH, VLM_ARCH = "hubert-xlarge", "phi-3-vision-4.2b"
ENCODER_BATCH = (4, 1024)     # 4 clips of 1024 frames (~20 s of audio each)
VLM_PREFIX, VLM_TOKENS = 576, 512
# phi-3-vision-4.2b is cut to 16 of its 32 layers, and olmoe-1b-7b to 8 of
# 16, since the SSM and hybrid phase joined the script: it ran 632.5-760.9
# s with them whole, past half its limit
VLM_LAYERS = 16
# MoE configs served by the token drip: (arch, layers kept, requests).
# qwen2-moe-a2.7b is cut to 4 of its 24 layers to stay in time, olmoe-1b-7b
# to 8 of 16 (above).
MOE_PATHS = (("olmoe-1b-7b", 8, 16), ("qwen2-moe-a2.7b", 4, 4))
# The MoE configs' int4x2 twin bound.  The gap is starcoder2-7b's K/V code
# flips plus the router's: a bf16 step that moves a gate across its
# neighbour changes the token's top-k, a discontinuous change that then
# compounds through the layers.  ``moe_twin_check`` records it on the card
# (NVIDIA H100 80GB HBM3, 700 W): with the float cache the kernel and plain
# paths differ by 0.017-0.046 of the largest logit (olmoe-1b-7b) with 2.0%
# of the router choices flipped; with the int4x2 cache by 0.099-0.125 with
# 7.5% flipped, rising with depth; qwen2-moe-a2.7b (4 layers) 0.030-0.113;
# and the plain bf16 path is itself 0.16-0.19 (olmoe-1b-7b) and 0.15-0.29
# (qwen2-moe-a2.7b) from the plain f32 path, with 9-12% of its router
# choices flipped.  So the kernel path is held to 0.15, starcoder2-7b's
# bound, and to no more than the plain bf16 path's distance from f32.
MOE_TWIN_TOL = {"olmoe-1b-7b": 0.15, "qwen2-moe-a2.7b": 0.15}


def forward_check(cm, cfg, dev, batch, want, tol=TWIN_TOL["float"],
                  steps=3):
    """The compiled full-sequence forward on ``batch``: the launches by
    route ``want`` names, finite logits held against ``dispatch="twin"``
    within ``tol`` (the serving path's float tolerance); then its wall
    time, device busy time and idle share over ``steps`` forwards."""
    from repro_torch.models.model import forward

    with torch.no_grad():
        forward(cm.params, cfg, batch, patterns=cm.patterns)
        torch.cuda.synchronize()
        reset_counts()
        y = forward(cm.params, cfg, batch, patterns=cm.patterns)
        torch.cuda.synchronize()
        counts = read_counts()
        yt = forward(cm.params, cfg, batch, patterns=cm.patterns,
                     dispatch="twin")
    got = {k: counts[k] for k in want}
    require(got == want, f"{cfg.name} forward launched {got} by route, "
                         f"expected {want}")
    y, yt = y.float(), yt.float()
    require(bool(torch.isfinite(y).all()), f"{cfg.name} forward: non-finite")
    top = float(yt.abs().max())
    rel = float((y - yt).abs().max()) / top
    require(rel <= tol, f"{cfg.name} forward: kernel vs twin logits max rel "
                        f"err {rel} > {tol}")
    shape = tuple(y.shape)
    del y, yt

    def fwd():
        with torch.no_grad():
            forward(cm.params, cfg, batch, patterns=cm.patterns)

    prof = profile_forward(fwd, steps=steps)
    top_us = top_device_us(prof.pop("device_us_per_forward"))
    return {"logits_shape": list(shape), "launches": got, "max_rel_err": rel,
            "tol": tol, "largest_logit": top, **prof,
            "top_device_us_per_forward": top_us}


def flash_row(dev, cfg, B, T, causal):
    """The flash kernel at one layer of a forward of ``cfg`` (B x T, its
    heads and head dim) on the route ``flash_route`` names, held against
    its plain version and timed beside its bound and SDPA; on the tensor
    cores also the first design (the CUDA-core kernel) at the same shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ins = [[torch.randn(s_, device=dev).to(torch.bfloat16)
            for s_ in ((B, T, H, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh))]
           for _ in range(4)]
    q, k, v = ins[0]
    route = fk.flash_route(q, k, v)
    routes = {"tensor_core": "launches_tc", "cuda_core": "launches_cc"}
    y = took_route(fk, routes, route, lambda: fk.flash_attention_fwd(
        q, k, v, causal=causal))
    ref = fk.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = float((y.float() - ref.float()).abs().max())
    tol = flash_tol(torch.bfloat16, ref)
    require(err <= tol, f"flash {cfg.name} Dh={Dh}: max abs err {err}")
    pairs = T * (T + 1) / 2 if causal else T * T
    b, by = bound(nbytes(q, k, v, y), 4.0 * B * H * Dh * pairs, "bf16")
    heads = [[t.permute(0, 2, 1, 3) for t in qkv] for qkv in ins]
    row = {"config": cfg.name, "shape": f"B={B} T={T} H={H} Hkv={Hkv} "
           f"Dh={Dh} bf16 {'causal' if causal else 'non-causal'}",
           "route": route, "max_abs_err": err, "tol": tol,
           "ms": device_ms(lambda i: lambda: fk.flash_attention_fwd(
               *ins[i], causal=causal), 4),
           "plain_ms": device_ms(lambda i: lambda: fk.flash_attention_plain(
               *ins[i], causal=causal), 2),
           "bound_ms": b, "bound_by": by,
           "library_ms": device_ms(
               lambda i: lambda: F.scaled_dot_product_attention(
                   *heads[i], is_causal=causal, enable_gqa=True), 4)}
    if route == "tensor_core":
        row["first_version_ms"] = device_ms(lambda i: lambda: fk._launch(
            *ins[i], causal, "cuda_core"), 4)
    return row


def encoder_path(dev):
    """hubert-xlarge at full width: the compiled forward on 4 x 1024 frame
    embeddings, non-causal; every linear on its rule's route, all of them
    tensor-core routes (the 504-column head too: its codes by cp.async),
    the attention on the flash kernel's tensor-core route (Dh 80)."""
    cm, cfg, out = family_model(ENCODER_ARCH, dev)
    B, T = ENCODER_BATCH
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((B, T, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    want = decode_want(cm, cfg, dev, B * T)
    require(want[QMM_TILED] == 0 and want[BSM_TILED] == 0,
            f"{cfg.name}: the rules send forward linears to the tiled "
            f"routes: {want}")
    want.update({FLASH_TC: cfg.n_layers, FLASH_CC: 0})
    out["forward"] = forward_check(cm, cfg, dev, {"frame_embeds": frames},
                                   want)
    out["forward"]["frames"] = [B, T]
    print(f"{cfg.name}: forward {json.dumps(out['forward'])}", flush=True)
    del frames
    # the forward's MLP leaf and its head (the 128-block does not tile
    # 504 columns: the cost model's quant; 504 one-byte codes make no
    # 16-byte row pitch, so the tensor-core route copies them by cp.async)
    # at the forward's rows, the head beside the tiled first design
    rows = zoo_leaf_rows(cm, cfg, dev, [("blocks/mlp/wu", B * T),
                                        ("head", B * T)])
    head = rows["quant_matmul"][-1]
    require(head["leaf"] == "head" and head["route"] == "tensor_core",
            f"{cfg.name}: the head at M={B * T} took the {head['route']} "
            f"route")
    del cm
    torch.cuda.empty_cache()
    rows["flash_attention"] = [flash_row(dev, cfg, B, T, False)]
    return out, rows


def vlm_path(dev):
    """phi-3-vision-4.2b at full width: the twin check, the 16 requests
    served captured with every launch on its rule's route (the Dh 96 reads
    split) and the capture check, the captured step
    profiles, then the compiled forward over 576 prefix embeddings and 512
    tokens."""
    cm, cfg, out = family_model(VLM_ARCH, dev, VLM_LAYERS)
    prompts = serve_prompts(cfg)
    tw = twin_check(cm, cfg, dev, prompts[0][:16], "int4x2",
                    want=decode_want(cm, cfg, dev))
    out["twin_check"] = {k: tw[k] for k in ("max_rel_err", "tol", "steps")}
    torch.cuda.reset_peak_memory_stats()
    eng, cap, counts = serve_run(cm, cfg, dev, prompts, count=True)
    out["capture_check"] = capture_check(eng, cfg)
    del eng
    want = serve_want(cm, cfg, dev, cap["decode_steps"], cap["prefill_steps"])
    got = {k: counts[k] for k in want}
    require(got == want, f"{cfg.name}: served launches by route {got}, the "
                         f"shape rules name {want}")
    tokens = cap.pop("tokens")
    require(all(len(t) == 32 and all(0 <= v < cfg.vocab for v in t)
                for t in tokens), f"{cfg.name}: a request got a bad answer")
    out["device_peak_serve"] = torch.cuda.max_memory_allocated()
    out["serve"] = {**cap, "launches": {k: v for k, v in counts.items() if v}}
    out["step_profile"] = {f"{ph}_captured": profile_step(cm, cfg, dev, ph,
                                                          True)
                           for ph in ("decode", "prefill")}
    print(f"{cfg.name}: twin check {json.dumps(out['twin_check'])}; capture "
          f"check {json.dumps(out['capture_check'])}", flush=True)
    print(f"{cfg.name}: serve {json.dumps(out['serve'])}", flush=True)
    print(f"{cfg.name}: step profile {json.dumps(out['step_profile'])}",
          flush=True)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (1, VLM_TOKENS)), dtype=torch.int32, device=dev),
        "prefix_embeds": torch.as_tensor(rng.standard_normal(
            (1, VLM_PREFIX, cfg.d_model)), dtype=torch.bfloat16,
            device=dev)}
    T = VLM_PREFIX + VLM_TOKENS
    want = decode_want(cm, cfg, dev, T)
    want.update({FLASH_TC: cfg.n_layers, FLASH_CC: 0})
    out["forward"] = forward_check(cm, cfg, dev, batch, want)
    out["forward"]["prefix_tokens"] = [VLM_PREFIX, VLM_TOKENS]
    print(f"{cfg.name}: forward {json.dumps(out['forward'])}", flush=True)
    # the MLP leaf at the decode step's rows and the forward's, and the
    # head at the forward's (32,064 columns: the tensor-core quant route,
    # its last column tile ragged)
    rows = zoo_leaf_rows(cm, cfg, dev, [("blocks/mlp/wg", 8),
                                        ("blocks/mlp/wg", T), ("head", T)])
    head = rows["quant_matmul"][-1]
    require(head["leaf"] == "head" and head["route"] == "tensor_core",
            f"{cfg.name}: the head at M={T} took the {head['route']} route")
    del cm
    torch.cuda.empty_cache()
    lens = np.random.default_rng(1).integers(64, 320, size=(8, 1))
    rows["packed_decode_attention"] = [
        zoo_attention_row(cfg, dev, 8, 1, lens),
        zoo_attention_row(cfg, dev, 1, 16, 200 + np.arange(1, 17)[None])]
    rows["flash_attention"] = [flash_row(dev, cfg, 1, T, True)]
    return out, rows


def moe_twin_check(cm, cfg, dev, prompt, tol=None):
    """The MoE kernel path against its plain versions on the card: the
    prompt dripped a token at a time, then 4 greedy decode steps, all
    teacher-forced with the kernel path's tokens, through five paths: the
    kernel and plain paths on the int4x2 cache and on the float cache,
    and the plain path in f32 (its bf16 leaves cast up) on the int4x2
    cache.  The int4x2 kernel path's logits must lie within ``tol``
    (default ``MOE_TWIN_TOL``) of the plain path's, relative to the
    largest, at the prompt's last token and each step, and no farther than
    the plain path lies from the plain f32 path; its greedy tokens equal
    or tied, and a decode step's launches on the routes their rules
    name.  Recorded beside it: each pair's logit gaps and the share of
    router choices (token, expert) that differ, per layer."""
    from repro_torch.models import blocks
    from repro_torch.models.model import decode_step, init_cache
    from repro_torch.tree import tree_map

    tol = MOE_TWIN_TOL[cfg.name] if tol is None else tol
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                   cm.params)
    paths = {"kernel": (cm.params, cfg, "auto", "int4x2"),
             "plain": (cm.params, cfg, "twin", "int4x2"),
             "kernel_float": (cm.params, cfg, "auto", "float"),
             "plain_float": (cm.params, cfg, "twin", "float"),
             "plain_f32": (p32, f32, "twin", "int4x2")}
    ids = {k: [] for k in paths}
    logits = {k: [] for k in paths}
    route = blocks.moe_route
    cur = [None]

    def spy(p, cfg_, xt, dispatch=None):
        r = route(p, cfg_, xt, dispatch)
        ids[cur[0]].append(r[0])
        return r

    caches = {k: init_cache(c, 1, 512, kv_cache=kv, device=dev)
              for k, (_, c, _, kv) in paths.items()}
    per_step = None
    blocks.moe_route = spy
    try:
        feed = [int(t) for t in prompt]
        for i in range(len(prompt) + 4):
            tok = torch.tensor([[feed[i]]], device=dev)
            for k, (p, c, mode, _) in paths.items():
                cur[0] = k
                first = k == "kernel" and i == len(prompt)
                if first:
                    reset_counts()
                y = decode_step(p, c, caches[k], tok, patterns=cm.patterns,
                                dispatch=mode, t_bound=32, bt=64)[0][0, 0]
                if first:
                    per_step = read_counts()
                if i >= len(prompt) - 1:
                    logits[k].append(y.float())
            if i >= len(prompt) - 1:
                feed.append(int(torch.argmax(logits["kernel"][-1])))
    finally:
        blocks.moe_route = route
    del p32
    L = cfg.n_layers
    pairs = {}
    for a, b in (("kernel", "plain"), ("kernel_float", "plain_float"),
                 ("kernel", "plain_f32"), ("plain", "plain_f32")):
        flips = [0] * L
        for n, (x, y) in enumerate(zip(ids[a], ids[b])):
            flips[n % L] += sum(len(set(u.tolist()) - set(v.tolist()))
                                for u, v in zip(x, y))
        calls = len(ids[a]) // L
        pairs[f"{a}_vs_{b}"] = {
            "logits": [float((x - y).abs().max() / y.abs().max())
                       for x, y in zip(logits[a], logits[b])],
            "router_flip_share": sum(flips) / (calls * L * cfg.top_k),
            "router_flip_share_by_layer": [f / (calls * cfg.top_k)
                                           for f in flips]}
    steps = []
    for a, t in zip(logits["kernel"], logits["plain"]):
        require(bool(torch.isfinite(a).all() and torch.isfinite(t).all()),
                f"{cfg.name}: non-finite logits")
        tk, tt = int(torch.argmax(a)), int(torch.argmax(t))
        top = float(t.abs().max())
        steps.append({
            "token": tk, "plain_token": tt,
            "rel_err": float((a - t).abs().max()) / top,
            "tie": tk != tt and all(
                abs(float(v[tk] - v[tt])) <= tol * top for v in (a, t))})
    max_rel = max(s_["rel_err"] for s_ in steps)
    out = {"steps": steps, "max_rel_err": max_rel, "tol": tol,
           "launches_per_decode_step": {k: v for k, v in per_step.items()
                                        if v}, "pairs": pairs}
    print(f"{cfg.name}: twin check {json.dumps(out)}", flush=True)
    want = decode_want(cm, cfg, dev)
    want.update({PDA_SPLIT: 0, PDA_SINGLE: 0})
    want[pda_route(cfg, 1, 1, 64)] = L
    got = {k: per_step[k] for k in want}
    require(got == want, f"{cfg.name}: a decode step launched {got} by "
                         f"route, expected {want}")
    require(max_rel <= tol, f"{cfg.name}: kernel vs plain logits max rel err "
                            f"{max_rel} > {tol}")
    bf16_gap = max(pairs["plain_vs_plain_f32"]["logits"])
    require(max_rel <= bf16_gap,
            f"{cfg.name}: kernel vs plain logits max rel err {max_rel} "
            f"exceeds the plain bf16 path's distance from f32, {bf16_gap}")
    for i, s_ in enumerate(steps):
        require(s_["token"] == s_["plain_token"] or s_["tie"],
                f"{cfg.name}: greedy token differs between kernel and plain "
                f"path at step {i}: {s_}")
    return out


def moe_path(arch, layers, n_requests, dev):
    """An MoE config at full width (``layers`` cuts its depth): the twin
    check with its router flips, then ``n_requests`` of the serve phase's
    requests through the token drip, captured per bucket, every launch on
    the route its rule names, and the capture check; the captured drip
    step's profile."""
    cm, cfg, out = family_model(arch, dev, layers)
    prompts = serve_prompts(cfg)[:n_requests]
    out["twin_check"] = moe_twin_check(cm, cfg, dev, prompts[0][:16])
    torch.cuda.reset_peak_memory_stats()
    eng, cap, counts = serve_run(cm, cfg, dev, prompts, count=True)
    require(cap["prefill_steps"] == 0 and cap["graphs"] > 0,
            f"{cfg.name}: the drip ran {cap['prefill_steps']} prefill steps, "
            f"{cap['graphs']} graphs")
    out["capture_check"] = capture_check(eng, cfg)
    require(set(out["capture_check"]) == {"drip"},
            f"{cfg.name}: captured phases {sorted(out['capture_check'])}")
    del eng
    want = serve_want(cm, cfg, dev, cap["decode_steps"], 0)
    got = {k: counts[k] for k in want}
    require(got == want, f"{cfg.name}: served launches by route {got}, the "
                         f"shape rules name {want}")
    tokens = cap.pop("tokens")
    require(all(len(t) == 32 and all(0 <= v < cfg.vocab for v in t)
                for t in tokens), f"{cfg.name}: a request got a bad answer")
    out["device_peak_serve"] = torch.cuda.max_memory_allocated()
    out["serve"] = {**cap, "requests": n_requests,
                    "launches": {k: v for k, v in counts.items() if v}}
    out["step_profile"] = {"drip_captured": profile_step(cm, cfg, dev, "drip",
                                                         True)}
    print(f"{cfg.name}: capture check {json.dumps(out['capture_check'])}; "
          f"serve {json.dumps(out['serve'])}", flush=True)
    print(f"{cfg.name}: step profile {json.dumps(out['step_profile'])}",
          flush=True)
    del cm
    torch.cuda.empty_cache()
    return out


def encoder_vlm_moe(dev, report):
    """The encoder, VLM and MoE phase, each path's launch counts set to 0
    just before it and read just after; its flash_attention and
    packed_decode_attention rows at the new head dims go to
    ``report["encoder_vlm_moe_rows"]`` (the kernels line's entries gain
    them as an ``encoder_vlm_moe`` list)."""
    out, rows = {}, {}
    report["encoder_vlm_moe"] = out
    report["encoder_vlm_moe_rows"] = rows
    t0 = time.perf_counter()
    for name, fn in ((ENCODER_ARCH, encoder_path), (VLM_ARCH, vlm_path)):
        t = time.perf_counter()
        out[name], r = fn(dev)
        out[name]["seconds"] = time.perf_counter() - t
        for k, v in r.items():
            rows.setdefault(k, []).extend(v)
    for arch, layers, n in MOE_PATHS:
        t = time.perf_counter()
        out[arch] = moe_path(arch, layers, n, dev)
        out[arch]["seconds"] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t0


# ------------------------------------------------ SSM and hybrid families


SSM_ARCH, HYBRID_ARCH = "xlstm-1.3b", "zamba2-2.7b"
SSM_FORWARD_T = 512          # two chunks of the chunkwise forms
# The drip twin check's bound, of the largest logit.  zamba2-2.7b's shared
# attention reads the int4x2 cache: TWIN_TOL's.  xlstm-1.3b reads no KV
# cache, but its 48 layers each round their output and gates to bf16
# around f32 states, and the mLSTM's normaliser divides by a sum of them:
# on the card (NVIDIA H100 80GB HBM3, 700 W) the kernel path lay
# 0.020-0.025 of the largest logit from the plain path, and the plain bf16
# path itself 0.017-0.024 from the plain f32 path.  So the kernel path is
# held to 0.05 and, past TWIN_TOL, to no more than 1.25x the plain bf16
# path's distance from f32 (``drip_twin_check``).
SSM_TWIN_TOL = {SSM_ARCH: 0.05, HYBRID_ARCH: TWIN_TOL["int4x2"]}
BF16_GAP_SLACK = 1.25
# xlstm-1.3b's chunkwise forward against its drip with every leaf in f32:
# the same arithmetic in another order (on the card: under 1e-5 of the
# largest logit at every position of 512, NVIDIA H100 80GB HBM3, 700 W)
SSM_F32_TOL = 1e-4
# warm-up requests of the captured drip: the hybrid's reach every bucket;
# the SSM family has one, captured at its first step
SSM_WARM = {"ssm": ((2, 2),), "hybrid": WARM}
# the requests served eagerly against the captured run: the shortest 4 (an
# eager step is host-bound, 50-100 ms)
SSM_EAGER_REQUESTS = 4
# the mLSTM projections the int8 leaves run: (leaf, rows) pairs timed
SSM_LEAVES = (("wq", 8), ("wo", 8), ("wq", SSM_FORWARD_T),
              ("wo", SSM_FORWARD_T))
HYBRID_LEAVES = (("shared_attn/attn/wq", 8), ("shared_attn/mlp/wg", 8),
                 ("shared_attn/mlp/wd", 8),
                 ("shared_attn/attn/wq", SSM_FORWARD_T),
                 ("shared_attn/mlp/wg", SSM_FORWARD_T))


def mlstm_leaf_ops(params, name, x):
    """Layer 0's int8 mLSTM leaf ``name`` as the quant family hands it to
    its kernel for the activation ``x``."""
    leaf = {k: v[0, 0] for k, v in params["blocks"]["mlstm"][name].items()}
    return "quant", x, leaf["w_q"], leaf["w_s"], False


def ssm_want(params, cfg, dev, M):
    """The launches by route of one step of M rows of the SSM family: the
    four int8 projections of each mLSTM layer on their rule's route."""
    want = dict.fromkeys(ROUTE_COUNTER.values(), 0)
    n_m = cfg.n_layers - cfg.n_layers // cfg.slstm_every
    for name in ("wq", "wk", "wv", "wo"):
        K = params["blocks"]["mlstm"][name]["w_q"].shape[-2]
        x = torch.zeros((M, K), device=dev, dtype=torch.bfloat16)
        ops = mlstm_leaf_ops(params, name, x)
        want[ROUTE_COUNTER[("quant", family_route(ops, M, x)[0])]] += n_m
    return want


def drip_want(cm, cfg, dev, M):
    """One step of M rows of either family: its matmuls by route, and the
    hybrid's packed reads (one a super-block) on ``pda_plan``'s route."""
    from repro_torch.models.model import n_superblocks
    want = {PDA_SPLIT: 0, PDA_SINGLE: 0, FLASH_TC: 0, FLASH_CC: 0}
    if cfg.family == "ssm":
        want.update(ssm_want(cm.params, cfg, dev, M))
    else:
        want.update(decode_want(cm, cfg, dev, M))
        want[pda_route(cfg, M, 1, 64)] += n_superblocks(cfg)
    return want


def drip_twin_check(cm, cfg, dev, prompt, tol):
    """The token drip's kernel path against its plain versions on the card:
    the prompt dripped a token at a time through ``decode_step`` at B = 1,
    then 4 greedy steps, teacher-forced with the kernel path's tokens,
    through the kernel ("auto") and plain ("twin") paths and the plain
    path in f32 (bf16 leaves cast up), the hybrid on the int4x2 cache.  The
    kernel path's logits must lie within ``tol`` of the plain path's,
    relative to the largest, at the prompt's last token and each step,
    greedy tokens equal or tied, and a step's launches on the routes their
    rules name; the plain path's distance from f32 is recorded beside
    it."""
    from repro_torch.models.model import decode_step, init_cache

    f32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                   cm.params)
    paths = {"kernel": (cm.params, cfg, "auto"),
             "plain": (cm.params, cfg, "twin"),
             "plain_f32": (p32, f32, "twin")}
    caches = {k: init_cache(c, 1, 512, kv_cache="int4x2", device=dev)
              for k, (_, c, _) in paths.items()}
    logits = {k: [] for k in paths}
    feed = [int(t) for t in prompt]
    per_step = None
    with torch.no_grad():
        for i in range(len(prompt) + 4):
            tok = torch.tensor([[feed[i]]], dtype=torch.int32, device=dev)
            for k, (p, c, mode) in paths.items():
                first = k == "kernel" and i == len(prompt)
                if first:
                    torch.cuda.synchronize()
                    reset_counts()
                y = decode_step(p, c, caches[k], tok, patterns=cm.patterns,
                                dispatch=mode, t_bound=32, bt=64)[0][0, 0]
                if first:
                    torch.cuda.synchronize()
                    per_step = read_counts()
                if i >= len(prompt) - 1:
                    logits[k].append(y.float())
            if i >= len(prompt) - 1:
                feed.append(int(torch.argmax(logits["kernel"][-1])))
    del p32, caches
    torch.cuda.empty_cache()
    gaps = {f"{a}_vs_{b}": [float((x - y).abs().max() / y.abs().max())
                            for x, y in zip(logits[a], logits[b])]
            for a, b in (("kernel", "plain"), ("plain", "plain_f32"),
                         ("kernel", "plain_f32"))}
    steps = []
    for a, t in zip(logits["kernel"], logits["plain"]):
        require(bool(torch.isfinite(a).all() and torch.isfinite(t).all()),
                f"{cfg.name}: non-finite logits")
        tk, tt = int(torch.argmax(a)), int(torch.argmax(t))
        top = float(t.abs().max())
        steps.append({
            "token": tk, "plain_token": tt,
            "rel_err": float((a - t).abs().max()) / top,
            "tie": tk != tt and all(
                abs(float(v[tk] - v[tt])) <= tol * top for v in (a, t))})
    max_rel = max(s_["rel_err"] for s_ in steps)
    want = drip_want(cm, cfg, dev, 1)
    got = {k: per_step[k] for k in want}
    out = {"steps": steps, "max_rel_err": max_rel, "tol": tol,
           "launches_per_decode_step": {k: v for k, v in per_step.items()
                                        if v}, "gaps": gaps}
    print(f"{cfg.name}: twin check {json.dumps(out)}", flush=True)
    require(got == want, f"{cfg.name}: a decode step launched {got} by "
                         f"route, expected {want}")
    require(max_rel <= tol, f"{cfg.name}: kernel vs plain logits max rel err "
                            f"{max_rel} > {tol}")
    if tol > TWIN_TOL["int4x2" if cfg.family == "hybrid" else "float"]:
        kernel_f32 = max(gaps["kernel_vs_plain_f32"])
        bf16_f32 = max(gaps["plain_vs_plain_f32"])
        require(kernel_f32 <= BF16_GAP_SLACK * bf16_f32,
                f"{cfg.name}: the kernel path lies {kernel_f32} from plain "
                f"f32, past {BF16_GAP_SLACK}x the plain bf16 path's "
                f"{bf16_f32}")
    for i, s_ in enumerate(steps):
        require(s_["token"] == s_["plain_token"] or s_["tie"],
                f"{cfg.name}: greedy token differs between kernel and plain "
                f"path at step {i}: {s_}")
    return out


def drip_logits(params, cfg, dev, tokens, last):
    """Logits of the last ``last`` positions of ``tokens`` dripped one at a
    time through a one-slot engine (captured steps).  Each step waits for
    the card, as the engine's own steps do by reading their logits: the
    next step's token goes through the same pinned staging buffer."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, batch_slots=1, max_len=len(tokens),
                      device=dev)
    out = []
    for i, t in enumerate(tokens):
        eng._fill("tok", np.asarray([[t]], np.int32))
        tb = 0 if cfg.family == "ssm" else eng._bucket_t(i + 1)
        y = eng._step_logits("drip", tb)
        if i >= len(tokens) - last:
            out.append(y[0, 0].float().clone())
        torch.cuda.synchronize(dev)
    del eng
    return torch.stack(out)


def chunkwise_vs_drip(cm, cfg, dev, batch, seq, last=16):
    """xlstm-1.3b's chunkwise full-sequence forward against its recurrence
    (the same tokens dripped through a one-slot engine) at the last
    ``last`` positions, in bf16 (within ``SSM_TWIN_TOL``: the two round
    differently at every bf16 step) and with the bf16 leaves cast to f32
    (within ``SSM_F32_TOL``: the same arithmetic in another order)."""
    from repro_torch.models.model import forward

    out = {}
    p32 = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                   cm.params)
    f32 = dataclasses.replace(cfg, param_dtype="float32")
    for name, params, c, tol in (("bf16", cm.params, cfg, SSM_TWIN_TOL[
            cfg.name]), ("f32", p32, f32, SSM_F32_TOL)):
        with torch.no_grad():
            full = forward(params, c, batch)[0, -last:].float()
        rec = drip_logits(params, c, dev, seq, last)
        rel = float((full - rec).abs().max()) / float(rec.abs().max())
        out[name] = {"max_rel_err": rel, "tol": tol, "positions": last}
        require(rel <= tol, f"{cfg.name}: {name} chunkwise forward vs the "
                            f"drip's recurrence, last {last} positions: max "
                            f"rel err {rel} > {tol}")
        del full, rec
    del p32
    torch.cuda.empty_cache()
    return out


def mlstm_leaf_rows(params, dev):
    """SSM_LEAVES of xlstm-1.3b's int8 mLSTM (layer 0) at M rows (bf16),
    each on the route its rule names, held against its plain version and
    timed beside its bound and ``x @ W`` (W dense bf16)."""
    from repro_torch.kernels.quant_matmul import kernel as qk
    rows = []
    for name, M in SSM_LEAVES:
        K, N = params["blocks"]["mlstm"][name]["w_q"].shape[-2:]
        x = torch.randn((M, K), device=dev).to(torch.bfloat16)
        ops = mlstm_leaf_ops(params, name, x)
        route, plan = family_route(ops, M, x)
        took_route(qk, QMM_ROUTES, route, family_kernel_call(ops, ops[2]))
        dense = (ops[2].float() * ops[3]).to(torch.bfloat16)
        t = time_family(ops, dense, M, None)
        del dense
        label = f"{SSM_ARCH} mlstm/{name} M={M} K={K} N={N} {route}"
        require(t["max_abs_err"] <= t["tol"],
                f"{label}: kernel vs plain max abs err {t['max_abs_err']}")
        row = {"config": SSM_ARCH, "leaf": f"blocks/mlstm/{name}",
               "shape": f"M={M} K={K} N={N}", "route": route,
               "container": "int8", **t}
        if route == "thin_m":
            row["plan"] = list(plan)
        rows.append(row)
    return rows


def ssm_hybrid_model(arch, dev):
    """xlstm-1.3b (raw parameters, its mLSTM projections synthetic int8
    leaves: the reference does not compile the SSM family) or zamba2-2.7b
    (compiled with ``zoo_rules``: the shared attention and the head), at
    full width and depth from seed 0, with the host and device peaks."""
    from repro_torch.configs import get_config
    from repro_torch.core.compile_sparse import CompressedModel
    from repro_torch.models.model import init_params

    if arch == HYBRID_ARCH:
        return family_model(arch, dev)
    cfg = dataclasses.replace(get_config(arch), linear_mode="int8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
    out = {"n_layers": cfg.n_layers, "linear_mode": cfg.linear_mode,
           "init_params_s": time.perf_counter() - t0,
           "host_rss_peak_init": rss.peak,
           "device_peak_init": torch.cuda.max_memory_allocated(),
           "param_bytes": int(sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params)))}
    print(f"{arch}: {cfg.n_layers} layers initialised, "
          f"{out['param_bytes']} parameter bytes", flush=True)
    # the raw tree where the helpers take a compiled model: no pattern
    # table, no report row (the reference does not compile the SSM family;
    # its int8 leaves are synthetic)
    return CompressedModel(params=params, patterns={}, report=[]), cfg, out


def ssm_hybrid_path(arch, dev):
    """One config at full width: the drip twin check, the serve phase's 16
    requests through the token drip, captured (every launch on the route
    its rule names), the capture check, the shortest requests served
    eagerly with the same tokens, the captured drip step's profile, then the full-sequence forward at B = 1,
    T = 512 on its kernels held against the twin (xlstm-1.3b's last 16
    positions also against the drip's logits: chunkwise against
    recurrent)."""
    t0 = time.perf_counter()
    cm, cfg, out = ssm_hybrid_model(arch, dev)
    parts = out["seconds_by_part"] = {"setup": time.perf_counter() - t0}
    prompts = serve_prompts(cfg)
    t0 = time.perf_counter()
    out["twin_check"] = drip_twin_check(cm, cfg, dev, prompts[0][:16],
                                        SSM_TWIN_TOL[arch])
    parts["twin_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss:
        eng, cap, counts = serve_run(cm, cfg, dev, prompts, count=True,
                                     warm=SSM_WARM[cfg.family])
    want_graphs = 1 if cfg.family == "ssm" else cap["graphs"]
    require(cap["prefill_steps"] == 0 and cap["graphs"] == want_graphs > 0,
            f"{cfg.name}: the drip ran {cap['prefill_steps']} prefill steps, "
            f"{cap['graphs']} graphs")
    out["capture_check"] = capture_check(eng, cfg)
    require(set(out["capture_check"]) == {"drip"},
            f"{cfg.name}: captured phases {sorted(out['capture_check'])}")
    del eng
    torch.cuda.empty_cache()
    want = {k: n * cap["decode_steps"]
            for k, n in drip_want(cm, cfg, dev, 8).items()}
    got = {k: counts[k] for k in want}
    require(got == want, f"{cfg.name}: served launches by route {got}, the "
                         f"shape rules name {want}")
    out["device_peak_serve"] = torch.cuda.max_memory_allocated()
    out["host_rss_peak_serve"] = rss.peak
    out["state_bytes_per_slot"] = cap["cache_bytes"] / 8
    parts["serve_captured"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the shortest requests served eagerly (no warm-up: an eager engine
    # captures nothing): each request's tokens are its own, as the drip
    # computes every slot's row on its own
    few = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[
        :SSM_EAGER_REQUESTS]
    _, eager, _ = serve_run(cm, cfg, dev, [prompts[i] for i in few],
                            warm=(), capture=False)
    torch.cuda.empty_cache()
    parts["serve_eager"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    require(eager.pop("tokens") == [cap["tokens"][i] for i in few],
            f"{cfg.name}: captured and eager serving gave different tokens")
    tokens = cap.pop("tokens")
    require(all(len(t) == 32 and all(0 <= v < cfg.vocab for v in t)
                for t in tokens), f"{cfg.name}: a request got a bad answer")
    out["serve"] = {**cap, "launches": {k: v for k, v in counts.items() if v},
                    "eager": eager}
    out["step_profile"] = {"drip_captured": profile_step(cm, cfg, dev, "drip",
                                                         True)}
    torch.cuda.empty_cache()
    parts["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print(f"{cfg.name}: capture check {json.dumps(out['capture_check'])}; "
          f"serve {json.dumps(out['serve'])}", flush=True)
    print(f"{cfg.name}: step profile {json.dumps(out['step_profile'])}",
          flush=True)

    T = SSM_FORWARD_T
    seq = np.random.default_rng(2).integers(0, cfg.vocab, T).astype(np.int32)
    batch = {"tokens": torch.as_tensor(seq[None], device=dev)}
    want = drip_want(cm, cfg, dev, T)
    want.update({PDA_SPLIT: 0, PDA_SINGLE: 0})
    if cfg.family == "hybrid":
        from repro_torch.models.model import n_superblocks
        want[FLASH_TC] = n_superblocks(cfg)
    # the forward reads no KV cache: the float bound, or xlstm-1.3b's
    tol = SSM_TWIN_TOL[arch] if cfg.family == "ssm" else TWIN_TOL["float"]
    out["forward"] = forward_check(cm, cfg, dev, batch, want, tol=tol,
                                   steps=1)
    parts["forward_check"] = time.perf_counter() - t0
    if cfg.family == "ssm":
        out["forward"]["chunkwise_vs_drip"] = chunkwise_vs_drip(
            cm, cfg, dev, batch, seq)
    parts["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print(f"{cfg.name}: forward {json.dumps(out['forward'])}", flush=True)
    if cfg.family == "ssm":
        rows = {"quant_matmul": mlstm_leaf_rows(cm.params, dev)}
    else:
        rows = zoo_leaf_rows(cm, cfg, dev, HYBRID_LEAVES)
    del cm
    torch.cuda.empty_cache()
    if cfg.family == "hybrid":
        lens = np.random.default_rng(1).integers(64, 320, size=(8, 1))
        rows["packed_decode_attention"] = [
            zoo_attention_row(cfg, dev, 8, 1, lens)]
        rows["flash_attention"] = [flash_row(dev, cfg, 1, T, True)]
    parts["rows"] = time.perf_counter() - t0
    return out, rows


def ssm_hybrid(dev, report):
    """The SSM and hybrid phase: xlstm-1.3b and zamba2-2.7b, each path's
    launch counts set to 0 just before it and read just after; its rows go
    to ``report["ssm_hybrid_rows"]`` (the kernels line's entries gain them
    as an ``ssm_hybrid`` list)."""
    out, rows = {}, {}
    report["ssm_hybrid"] = out
    report["ssm_hybrid_rows"] = rows
    t0 = time.perf_counter()
    for arch in (SSM_ARCH, HYBRID_ARCH):
        t = time.perf_counter()
        out[arch], r = ssm_hybrid_path(arch, dev)
        out[arch]["seconds"] = time.perf_counter() - t
        for k, v in r.items():
            rows.setdefault(k, []).extend(v)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0



def main() -> int:
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"card: {report['card']}", flush=True)
    start = time.perf_counter()
    ends = report["phase_end_s"] = {}

    def lap(name):
        """The seconds from the start to the end of phase ``name``."""
        ends[name] = round(time.perf_counter() - start, 1)

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    lap("build")
    print(f"build: {report['build_s']:.1f} s", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dry = start_dryrun(out_dir)
    try:
        rng = np.random.default_rng(0)
        torch.manual_seed(0)
        report["sweep_cases"] = {
            "block_sparse_matmul": sweep_sparse(rng, dev),
            "quant_matmul": sweep_quant(rng, dev),
            "packed_decode_attention": sweep_attention(rng, dev),
            "block_sparse_conv": sweep_sparse_conv(rng, dev),
            "quant_conv": sweep_quant_conv(rng, dev),
            "fc_stack_matmul": sweep_fc_stack(rng, dev),
            "flash_attention": sweep_flash(rng, dev, report),
        }
        print(f"kernels vs plain versions: {report['sweep_cases']} cases pass",
              flush=True)
        report["tc_f32_sum_err"] = tc_sum_error(dev)
        print("tensor-core f32 sums vs plain, share of max|pre|: "
              + json.dumps(report["tc_f32_sum_err"]), flush=True)
        report["route_pairs"] = route_pairs(dev)
        lap("sweeps")
        print("new routes beside their first designs (device ms): "
              + json.dumps(report["route_pairs"]), flush=True)

        cm, cfg, counts, tokens = serve(dev, report)
        lap("serve")
        print(f"serve: {json.dumps(report['serve'])}", flush=True)
        print(f"twin check: {json.dumps(report['twin_check'])}", flush=True)
        print(f"capture check: {json.dumps(report['capture_check'])}",
              flush=True)
        print(f"step profile: {json.dumps(report['step_profile'])}",
              flush=True)
        print(f"programmatic edges: {json.dumps(report['pdl_edges'])}",
              flush=True)
        print(f"compiled forward: {json.dumps(report['compiled_forward'])}",
              flush=True)
        sh = sharding(cm, cfg, dev, report)
        lap("sharding")
        print(f"sharding ({sh['seconds']:.1f} s) on {report['card']}: "
              + json.dumps({k: sh[k] for k in ("train", "decode")}),
              flush=True)
        print("sharding shard-local kernels (model axes 2 and 4): "
              + json.dumps(sh["kernels"]), flush=True)
        sq = seq_cache(dev, report, dry)
        lap("seq_cache")
        print(f"seq cache reads, model axes 2 and 4 ({sq['seconds']:.1f} s) "
              f"on {report['card']}: " + json.dumps(sq["reads"]), flush=True)
        for arch, shape in DRYRUN_CELLS:
            print(f"dryrun {arch} {shape} on (16, 16), torch "
                  f"{torch.__version__}: "
                  + json.dumps(sq["dryrun"][f"{arch}/{shape}"]), flush=True)
        ms = moe_sharding(dev, report, sq["dryrun"])
        lap("moe_sharding")
        print(f"moe sharding ({ms['seconds']:.1f} s) on {report['card']}: "
              + json.dumps({k: ms[k] for k in ("train", "drip")}),
              flush=True)
        print("moe sharding shard-local partials, (data, model) (2, 2) and "
              "(1, 4): " + json.dumps(ms["local"]), flush=True)
        ss = ssm_sharding(dev, report, sq["dryrun"])
        lap("ssm_sharding")
        print(f"ssm sharding ({ss['seconds']:.1f} s) on {report['card']}: "
              + json.dumps({k: ss[k] for k in ("train", "drip")}),
              flush=True)
        print("ssm sharding local parts, model axes 4 and 16: "
              + json.dumps(ss["local"]), flush=True)
        tune = autotune(cm, cfg, dev, report, tokens)
        lap("autotune")
        print("autotune (rule plan / tuned plan, us; NVIDIA card above): "
              + json.dumps({k: {f: r[f] for f in ("rule", "tuned",
                                                  "predicted_us")}
                            for k, r in tune["keys"].items()}), flush=True)
        print("autotune candidates: " + json.dumps(
            {k: r["candidates"] for k, r in tune["keys"].items()}),
            flush=True)
        print("autotune attention: " + json.dumps(tune["attn"]), flush=True)
        print("autotune attention, the rule's tile summed over the extents: "
              + json.dumps(tune["attn_rule_row"]), flush=True)
        print("autotune serve: " + json.dumps(
            {k: v for k, v in tune.items()
             if k not in ("keys", "attn", "attn_rule_row", "decode_profile",
                          "serve_pairs")}),
            flush=True)
        print("autotune serving, untuned / tuned in turns: "
              + json.dumps(tune["serve_pairs"]), flush=True)
        print("autotune decode profile (captured): " + json.dumps(
            {k: {f: v[f] for f in ("wall_ms_per_step",
                                   "device_busy_ms_per_step",
                                   "device_idle_share")}
             for k, v in tune["decode_profile"].items()}), flush=True)

        kernels = measure_kernels(cm, cfg, dev, counts)
        lap("measure_kernels")
        del cm
        params, x, cms = lenet(dev, report)
        print("lenet: " + json.dumps({
            c: {k: v for k, v in r.items() if not k.startswith("profile")}
            for c, r in report["lenet"].items()}), flush=True)
        lenet_kernels, report["lenet_kernels"] = measure_lenet_kernels(
            params, x, cms, dev)
        kernels += lenet_kernels
        lap("lenet")
        del params, x, cms
        fig1(dev, report)
        lap("fig1")
        f1 = report["fig1"]
        print(f"fig1 ({f1['seconds']:.1f} s) on {report['card']}: " + json.dumps(
            {k: v for k, v in f1["lenet"].items()
             if k not in ("losses_dense", "losses_finetune",
                          "rows_h100_sxm_estimates")}), flush=True)
        print("fig1 losses (dense, then the masked int4 QAT fine-tune): "
              + json.dumps({k: f1["lenet"][k] for k in
                            ("losses_dense", "losses_finetune")}), flush=True)
        print("fig1 strategy rows (latency, throughput and resource are "
              "cost-model estimates from the H100 SXM datasheet, not "
              "measured): " + json.dumps(f1["lenet"]["rows_h100_sxm_estimates"]),
              flush=True)
        print("fig1 examples: " + json.dumps(
            {k: f1[k] for k in ("llm", "quickstart", "serve_batched")}),
            flush=True)
        families(dev, report, kernels)
        lap("families")
        fam = report["families"]
        print("families: " + json.dumps(
            {k: v for k, v in fam.items() if k not in ("rows", "lenet")}),
            flush=True)
        print("families lenet: " + json.dumps({
            c: {k: v for k, v in r.items() if k != "dse_estimate"}
            for c, r in fam["lenet"].items()}), flush=True)
        print("families DSE at the Table-I budget (cost-model estimates, "
              "not measured): " + json.dumps({
                  c: r["dse_estimate"] for c, r in fam["lenet"].items()}),
              flush=True)
        zoo(dev, report, kernels)
        lap("zoo")
        mat = report["zoo"]["matrix"]
        print(f"zoo matrix ({mat['seconds']:.1f} s, launches "
              f"{json.dumps(mat['launches'])}); not run: "
              f"{json.dumps(mat['not_run'])}", flush=True)
        print(f"zoo matrix decode_us on {report['card']}: " + json.dumps(
            {k: r["decode_us"] for k, r in mat["cells"].items()}), flush=True)
        print("zoo matrix container_bytes (the port's own weights): "
              + json.dumps({k: r["container_bytes"]
                            for k, r in mat["cells"].items()}), flush=True)
        print("zoo rows: " + json.dumps(report["zoo_rows"]), flush=True)
        encoder_vlm_moe(dev, report)
        lap("encoder_vlm_moe")
        evm = report["encoder_vlm_moe"]
        print(f"encoder/VLM/MoE ({evm['seconds']:.1f} s) launches by route: "
              + json.dumps({a: r.get("serve", r.get("forward", {})).get(
                  "launches") for a, r in evm.items() if isinstance(r, dict)}),
              flush=True)
        print("encoder/VLM/MoE rows: "
              + json.dumps(report["encoder_vlm_moe_rows"]), flush=True)
        ssm_hybrid(dev, report)
        lap("ssm_hybrid")
        sh = report["ssm_hybrid"]
        print(f"SSM/hybrid ({sh['seconds']:.1f} s) launches by route: "
              + json.dumps({a: r["serve"]["launches"] for a, r in sh.items()
                            if isinstance(r, dict)}), flush=True)
        print("SSM/hybrid memory: " + json.dumps({
            a: {k: v for k, v in r.items() if "peak" in k or "bytes" in k}
            for a, r in sh.items() if isinstance(r, dict)}), flush=True)
        print("SSM/hybrid rows: " + json.dumps(report["ssm_hybrid_rows"]),
              flush=True)
        train_counts = train(dev, report)
        lap("train")
        print("train: " + json.dumps({k: v for k, v in report["train"].items()
                                      if k != "profile"}), flush=True)
        prof = report["train"]["profile"]
        print("train profile: " + json.dumps({
            **{k: v for k, v in prof.items() if k != "device_us_per_step"},
            "top_device_us_per_step": top_device_us(
                prof["device_us_per_step"])}), flush=True)
        train_families(dev, report)
        lap("train_families")
        tf = report["train_families"]
        for arch, r in tf.items():
            if not isinstance(r, dict):
                continue
            print(f"train_families {arch} on {report['card']}: " + json.dumps(
                {k: r[k] for k in (
                    "layers", "batch", "seq", "n_micro", "step_ms_p50",
                    "tokens_per_s", "peak_memory_bytes", "device_idle_share",
                    "wall_ms_per_step", "device_busy_ms_per_step", "losses",
                    "launches", "twin_check", "setup_s", "seconds")
                 if k in r}), flush=True)
            print(f"train_families {arch} profile, top device items (us a "
                  f"step): " + json.dumps(r["top_device_us_per_step"]),
                  flush=True)
        print(f"train_families ({tf['seconds']:.1f} s) flash rows: "
              + json.dumps(report["train_families_rows"]), flush=True)
        kernels.append(measure_flash(dev, train_counts))
        lap("measure_flash")
        print("phase ends (s after the start; the dry-run cells ended "
              f"{sq['dryrun']['seconds']:.1f} s after theirs): "
              + json.dumps(ends), flush=True)
        for k in kernels:
            for phase in ("encoder_vlm_moe", "ssm_hybrid", "train_families"):
                if k["name"] in report[f"{phase}_rows"]:
                    k[phase] = report[f"{phase}_rows"][k["name"]]
            pairs = [r for r in report["route_pairs"]
                     if r["kernel"] == k["name"]]
            if pairs:
                k["route_pairs"] = pairs
        report["kernels"] = kernels
    finally:
        stop_dryrun(dry)
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
