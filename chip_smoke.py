#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile every CUDA kernel from ``src/repro_torch/csrc``;
3. kernels — hold each kernel against its plain PyTorch version over every
   container, row count and activation, then time kernel, plain version
   and a one-call PyTorch yardstick at the shapes the serving path gives
   it, beside the least time the card could take (``bound_ms``);
4. serve   — compile llama3.2-1b at full width (random weights from a seed)
   to int4x2 quant/block-sparse leaves, serve 16 requests through
   ``ServeEngine`` with the int4x2 KV cache, require every kernel to have
   launched, and hold a prefill chunk plus 4 decode steps against the
   plain versions (``dispatch="twin"``).

Prints the kernels line, the card line and, last, the result line
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch  # noqa: E402,F401  (fails outside a checkout)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor core / fp32
SERVE_RULES = dict(block=(128, 128), block_density=0.25,
                   in_block_density=0.5, min_weight_elems=0, quant_bits=4,
                   policies={"wq": "quant", "wk": "quant", "wv": "quant",
                             "wo": "quant", "wg": "sparse", "wu": "sparse",
                             "wd": "sparse"})
# kernel path vs plain versions through all 16 bf16 layers, relative to the
# largest logit.  The kernels round like the plain versions but sum in
# another order, so single bf16 steps differ and grow through the layers.
# With the int4x2 cache a one-step difference in a K/V value can also flip
# its int4 code, moving that element by amax/7, so that bound is looser.
TWIN_TOL = {"float": 2e-2, "int4x2": 1e-1}


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


def sparse_case(rng, dev, container, bk, nR, empty=False):
    """A random (nR x 3)-block pattern of (bk, 128) blocks with an absent
    column block, in one container; returns the kernel's and the plain
    version's arguments."""
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.sparse_matmul import kernel as K_

    bn, nC = 128, 3
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
    from repro_torch.kernels.sparse_matmul.kernel import block_sparse_matmul
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref

    cases = []
    for ci, container in enumerate(("f32", "bf16", "int8", "int4x2", "int2x4")):
        for mi, M in enumerate((1, 8, 16, 128)):
            for empty in (False, True):
                cases.append((container, M, 128, 4, empty, ci + mi))
    # more blocks per column than one staging round holds, and blocks taller
    # than a round, at the row tiles whose rounds are smallest
    for M in (8, 16):
        for container in ("int8", "int4x2"):
            cases += [(container, M, 128, 12, False, M),
                      (container, M, 1024, 2, False, M + 1)]
    for container, M, bk, nR, empty, ai in cases:
        act = ACTS[ai % len(ACTS)]
        xdt = torch.float32 if container == "f32" or ai % 2 else torch.bfloat16
        blocks, vals, scales, packed, sched, rows, cols, nC = sparse_case(
            rng, dev, container, bk, nR, empty)
        x = torch.randn((M, nR * bk), device=dev).to(xdt)
        bias = torch.randn((nC * 128,), device=dev)
        y = block_sparse_matmul(x, blocks, sched, scales=scales, bias=bias,
                                activation=act, packed=packed)
        ref = block_sparse_matmul_ref(
            x, vals, rows, cols, n_row_blocks=nR, n_col_blocks=nC,
            scales=scales, bias=bias, activation=act, out_dtype=xdt)
        torch.cuda.synchronize()
        err = float((y.float() - ref.float()).abs().max())
        require(err <= tol_for(xdt, ref.float()),
                f"block_sparse_matmul {container} M={M} bk={bk} nR={nR} "
                f"empty={empty} act={act}: max abs err {err}")
    return len(cases)


def sweep_quant(rng, dev):
    from repro_torch.core.quant import pack_codes
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    cases = 0
    shapes = [(512, 320, M) for M in (1, 8, 16, 128)] + [(2560, 96, 8),
                                                          (2560, 96, 16)]
    for ci, container in enumerate(("int8", "int4x2", "int2x4")):
        for mi, (K, N, M) in enumerate(shapes):
            act = ACTS[(ci + mi) % len(ACTS)]
            xdt = torch.bfloat16 if mi % 2 else torch.float32
            qm = {"int8": 127, "int4x2": 7, "int2x4": 1}[container]
            codes = torch.randint(-qm, qm + 1, (K, N), device=dev).to(torch.int8)
            scales = torch.rand((N,), device=dev) / (qm * 16)
            w, packed = codes, False
            if container != "int8":
                packed = container
                w = pack_codes(codes, axis=0, bits=4 if container == "int4x2"
                               else 2)
            x = torch.randn((M, K), device=dev).to(xdt)
            bias = torch.randn((N,), device=dev) if mi % 2 == 0 else None
            y = quant_matmul(x, w, scales, bias, activation=act, packed=packed)
            ref = quant_matmul_ref(x, codes, scales, bias=bias,
                                   activation=act, out_dtype=xdt)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            require(err <= tol_for(xdt, ref.float()),
                    f"quant_matmul {container} M={M} K={K} act={act}: max abs "
                    f"err {err}")
            cases += 1
    return cases


def random_cache(B, T, Hkv, Dh, dev):
    from repro_torch.core.quant import pack_int4
    codes_k = torch.randint(-7, 8, (B, T, Hkv, Dh), device=dev).to(torch.int8)
    codes_v = torch.randint(-7, 8, (B, T, Hkv, Dh), device=dev).to(torch.int8)
    k_s = torch.rand((B, T, Hkv), device=dev) / 7
    v_s = torch.rand((B, T, Hkv), device=dev) / 7
    return (pack_int4(codes_k, axis=-1), pack_int4(codes_v, axis=-1), k_s, v_s,
            codes_k, codes_v)


def sweep_attention(rng, dev):
    from repro_torch.kernels.flash_attention.decode_packed import (
        packed_decode_attention, tiled_packed_attention)

    cases = 0
    B, H, Hkv, Dh, T, bt = 3, 8, 2, 64, 200, 64
    k_p, v_p, k_s, v_s, _, _ = random_cache(B, T, Hkv, Dh, dev)
    for C in (1, 16):
        for qdt in (torch.float32, torch.bfloat16):
            base = np.array([0, 69, T - C])       # dead tiles, ragged tiles
            lens = base[:, None] + np.minimum(np.arange(C) + 1, C)[None, :]
            lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn((B, C, H, Dh), device=dev).to(qdt)
            for tb in (T, 128):                   # full and bounded extent
                ext = [a[:, :tb] for a in (k_p, v_p, k_s, v_s)]
                ln = torch.clamp(lengths, max=tb)
                y = packed_decode_attention(q, *ext, ln, bt=bt)
                ref = tiled_packed_attention(q, *ext, ln, bt=bt)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                require(err <= tol_for(qdt, ref.float()),
                        f"packed_decode_attention C={C} {qdt} extent={tb}: "
                        f"max abs err {err}")
                cases += 1
    return cases


# --------------------------------------------------- main-path measurements


def measure_kernels(cm, cfg, dev, counts):
    """Time each kernel, its plain version and a one-call PyTorch yardstick
    at the serving path's decode shapes, on the compiled model's own
    layer-0 leaves, and hold the kernel against the plain version there."""
    import torch.nn.functional as F

    from repro_torch.core.quant import unpack_codes
    from repro_torch.core.sparsity import CompressedLinear, decompress
    from repro_torch.kernels.flash_attention.decode_packed import (
        packed_decode_attention, tiled_packed_attention)
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
    from repro_torch.kernels.sparse_matmul.kernel import block_sparse_matmul
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    from repro_torch.kernels.sparse_matmul.ref import block_sparse_matmul_ref

    M, D, F_ = 8, cfg.d_model, cfg.d_ff
    out = []
    x = torch.randn((M, D), device=dev).to(torch.bfloat16)

    def entry(name, source, replaces, y, ref, nbytes_, ops, shape, run_k,
              run_p, run_lib, sizes):
        err = float((y.float() - ref.float()).abs().max())
        tol = tol_for(y.dtype, ref.float())
        require(err <= tol, f"{name} at the serving shape: max abs err {err}")
        b, f = bound(nbytes_, ops, "bf16")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": err, "tol": tol,
                "ms": device_ms(run_k, sizes[0]),
                "plain_ms": device_ms(run_p, sizes[1]),
                "bound_ms": b, "bound_by": f,
                "library_ms": device_ms(run_lib, sizes[2]), "shape": shape}

    # block-sparse: mlp/wg of layer 0, int4x2 blocks
    leaf = cm.params["blocks"]["mlp"]["wg"]
    pat = cm.patterns[(D, F_)]
    wp, ws = leaf["w_blkp"][0].contiguous(), leaf["w_s"][0].contiguous()
    sched = schedule_for(pat, dev)
    bk, bn = pat.block
    nR, nC = pat.bitmap.shape
    vals = unpack_codes(wp, bk, axis=1, bits=4)
    rows = torch.as_tensor(pat.block_rows, device=dev)
    cols = torch.as_tensor(pat.block_cols, device=dev)
    dense = decompress(CompressedLinear(pattern=pat, blocks=vals, scales=ws)
                       ).to(torch.bfloat16)
    wps, valss, denses = (copies(t, n) for t, n in ((wp, 16), (vals, 8),
                                                     (dense, 2)))
    y = block_sparse_matmul(x, wp, sched, scales=ws, packed="int4x2")
    ref = block_sparse_matmul_ref(x, vals, rows, cols, n_row_blocks=nR,
                                  n_col_blocks=nC, scales=ws, out_dtype=x.dtype)
    out.append(entry(
        "block_sparse_matmul", "src/repro_torch/csrc/block_sparse_matmul.cu",
        "src/repro/kernels/sparse_matmul/kernel.py:313", y, ref,
        nbytes(x, wp, ws, y, sched.col_ptr, sched.rows, sched.pidx),
        2.0 * M * pat.n_blocks_present * bk * bn,
        f"M={M} K={D} N={F_} int4x2 blocks {pat.n_blocks_present}/"
        f"{pat.n_blocks_total} of {pat.block}",
        lambda i: lambda: block_sparse_matmul(x, wps[i], sched, scales=ws,
                                              packed="int4x2"),
        lambda i: lambda: block_sparse_matmul_ref(
            x, valss[i], rows, cols, n_row_blocks=nR, n_col_blocks=nC,
            scales=ws, out_dtype=x.dtype),
        lambda i: lambda: x @ denses[i], (16, 8, 2)))

    # quant: attn/wq of layer 0, int4x2 along K
    leaf = cm.params["blocks"]["attn"]["wq"]
    wq, sq = leaf["w_qp"][0].contiguous(), leaf["w_s"][0].contiguous()
    N = int(wq.shape[1])
    codes = unpack_codes(wq, D, axis=0, bits=4)
    dense = (codes.float() * sq[None, :]).to(torch.bfloat16)
    wqs, codess, denses = (copies(t, n) for t, n in ((wq, 32), (codes, 16),
                                                     (dense, 8)))
    y = quant_matmul(x, wq, sq, packed="int4x2")
    ref = quant_matmul_ref(x, codes, sq, out_dtype=x.dtype)
    out.append(entry(
        "quant_matmul", "src/repro_torch/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul/kernel.py:125", y, ref,
        nbytes(x, wq, sq, y), 2.0 * M * D * N, f"M={M} K={D} N={N} int4x2",
        lambda i: lambda: quant_matmul(x, wqs[i], sq, packed="int4x2"),
        lambda i: lambda: quant_matmul_ref(x, codess[i], sq,
                                           out_dtype=x.dtype),
        lambda i: lambda: x @ denses[i], (32, 16, 8)))

    # attention: a decode read over 8 slots of a 512-row cache
    B, H, Hkv, Dh, T, bt = M, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 512, 64
    G = H // Hkv
    lens_np = np.random.default_rng(1).integers(64, 320, size=B)
    lengths = torch.as_tensor(lens_np[:, None], dtype=torch.int32, device=dev)
    q = torch.randn((B, 1, H, Dh), device=dev).to(torch.bfloat16)
    caches = [random_cache(B, T, Hkv, Dh, dev) for _ in range(32)]

    def sdpa_inputs(c):
        kd = (c[4].float() * c[2][..., None]).to(torch.bfloat16)
        vd = (c[5].float() * c[3][..., None]).to(torch.bfloat16)
        return (kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1),
                vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1))

    kvd = [sdpa_inputs(c) for c in caches[:4]]
    mask = (torch.arange(T, device=dev)[None, :] < lengths)[:, None, None, :]
    qh = q.permute(0, 2, 1, 3)
    y = packed_decode_attention(q, *caches[0][:4], lengths, bt=bt)
    ref = tiled_packed_attention(q, *caches[0][:4], lengths, bt=bt)
    live = int(lens_np.sum())
    out.append(entry(
        "packed_decode_attention",
        "src/repro_torch/csrc/packed_decode_attention.cu",
        "src/repro/kernels/flash_attention/decode_packed.py:128", y, ref,
        nbytes(q, y, lengths) + live * Hkv * (Dh + 8), 4.0 * H * Dh * live,
        f"B={B} C=1 H={H} Hkv={Hkv} Dh={Dh} T={T} bt={bt} live rows {live}",
        lambda i: lambda: packed_decode_attention(q, *caches[i][:4], lengths,
                                                  bt=bt),
        lambda i: lambda: tiled_packed_attention(q, *caches[i][:4], lengths,
                                                 bt=bt),
        lambda i: lambda: F.scaled_dot_product_attention(
            qh, *kvd[i], attn_mask=mask), (32, 32, 4)))
    return out


def copies(t, n):
    """``n`` copies of a tensor (the first is ``t`` itself)."""
    return [t] + [t.clone() for _ in range(n - 1)]


# ---------------------------------------------------------------- serving


def counters():
    from repro_torch.kernels.flash_attention import decode_packed
    from repro_torch.kernels.quant_matmul import kernel as qk
    from repro_torch.kernels.sparse_matmul import kernel as sk
    return {"block_sparse_matmul": sk, "quant_matmul": qk,
            "packed_decode_attention": decode_packed}


def reset_counts():
    for mod in counters().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in counters().items()}


def pct(v, p):
    return float(np.percentile(np.asarray(v, float), p)) if len(v) else None


def serve(dev, report):
    from repro_torch.configs import get_config
    from repro_torch.core.compile_sparse import CompileRules, compile_model
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Request, ServeEngine

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

    def engine():
        return ServeEngine(cm, cfg, batch_slots=8, max_len=512,
                           prefill_chunk=16, kv_cache="int4x2", device=dev)

    rng = np.random.default_rng(0)
    warm = engine()
    warm.submit(Request(uid=-1, prompt=rng.integers(0, cfg.vocab, 24)
                        .astype(np.int32), max_new_tokens=2))
    warm.run()

    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(64, 257, size=16)]
    eng = engine()
    reset_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for name, n in counts.items():
        require(n > 0, f"serving ran without launching {name}")
    require(len(done) == 16 and all(len(r.out) == 32 for r in done),
            "not every request got its 32 tokens")
    require(all(0 <= t < cfg.vocab for r in done for t in r.out),
            "a generated token is outside the vocabulary")
    st = eng.stats()
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in done]
    report["serve"] = {
        "requests": 16, "prompt_tokens": int(sum(len(p) for p in prompts)),
        "new_tokens_per_request": 32, "wall_s": wall,
        "tokens_per_s": eng.tokens_processed() / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "decode_step_ms_p50": pct(st["decode_ms"], 50),
        "prefill_step_ms_p50": pct(st["prefill_ms"], 50),
        "decode_steps": st["decode_steps"], "prefill_steps": st["prefill_steps"],
        "cache_bytes": eng.cache_bytes(),
        "container_storage_bytes": cm.container_storage_bytes,
        "byte_compression": cm.byte_compression, "launches": counts,
    }

    report["twin_check"] = {
        kv: twin_check(cm, cfg, dev, prompts[0][:16], kv) for kv in TWIN_TOL}
    report["decode_profile"] = profile_decode(cm, cfg, dev)
    return cm, cfg, counts


def profile_decode(cm, cfg, dev, steps: int = 5):
    """Where a decode step's time goes: host wall-clock per step (8 slots at
    200 cached rows, int4x2 cache) beside the device time of the kernels it
    launches, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import decode_step, init_cache

    cache = init_cache(cfg, 8, 512, kv_cache="int4x2", device=dev)
    cache["length"].fill_(200)
    tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)

    def step():
        decode_step(cm.params, cfg, cache, tok, patterns=cm.patterns,
                    t_bound=256, bt=64)
        cache["length"].fill_(200)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
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
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms if dev_us else None,
            "device_idle_share": 1 - busy_ms / wall_ms if dev_us else None,
            "top_device_us_per_step": dict(top)}


def twin_check(cm, cfg, dev, prompt, kv_cache):
    """Kernel path vs plain versions on the card: one prefill chunk and 4
    greedy decode steps, teacher-forced with the kernel path's tokens.

    Logits must agree within ``TWIN_TOL[kv_cache]`` (relative to the
    largest logit) and the greedy tokens must be equal, unless both paths
    score the two candidates within that tolerance of each other.
    """
    from repro_torch.models.model import decode_step, init_cache, prefill_step

    tol = TWIN_TOL[kv_cache]
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
    max_rel = max(s_["rel_err"] for s_ in steps)
    require(max_rel <= tol, f"{kv_cache} cache: kernel vs plain logits max "
                            f"rel err {max_rel} > {tol}")
    for i, s_ in enumerate(steps):
        require(s_["token"] == s_["plain_token"] or s_["tie"],
                f"{kv_cache} cache: greedy token differs between kernel and "
                f"plain path at step {i}: {s_}")
    return {"steps": steps, "max_rel_err": max_rel, "tol": tol,
            "launches_per_decode_step": per_step}


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

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s", flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    try:
        rng = np.random.default_rng(0)
        torch.manual_seed(0)
        report["sweep_cases"] = {
            "block_sparse_matmul": sweep_sparse(rng, dev),
            "quant_matmul": sweep_quant(rng, dev),
            "packed_decode_attention": sweep_attention(rng, dev),
        }
        print(f"kernels vs plain versions: {report['sweep_cases']} cases pass",
              flush=True)

        cm, cfg, counts = serve(dev, report)
        print(f"serve: {json.dumps(report['serve'])}", flush=True)
        print(f"twin check: {json.dumps(report['twin_check'])}", flush=True)
        print(f"decode profile: {json.dumps(report['decode_profile'])}",
              flush=True)

        kernels = measure_kernels(cm, cfg, dev, counts)
        report["kernels"] = kernels
    finally:
        (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
