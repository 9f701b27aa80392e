"""The gloo ranks' cases of the MoE family's placed path
(``tests/test_torch_moe_sharding*.py``), run by
``_sharding_workers.run_rank`` with ``kind`` "moe_train" or "moe_serve".

Reduced olmoe-1b-7b and qwen2-moe-a2.7b (f32; 8 experts, top-4, ``Fe`` 32,
qwen2-moe-a2.7b with one shared expert), each case against the same
computation in one process (the unplaced port, in the same rank), as
``rel``: the largest difference over the largest one-process magnitude.

* ``moe_train``: :func:`_sharding_workers._train_cases` — the loss, every
  gradient and every parameter and moment after one AdamW step (eps 1e-3),
  ``seq_shard`` off (``n_micro`` 1 and 2) and on — on the seed-0 tree with
  its norm gains cast to f32 (``f32``), and the gradients of the tree as
  it is (``bf16_gains``).  A bf16 gain's gradient is an f32 sum rounded
  once to bf16; the placed sum's order differs from one process's in the
  last f32 bits, and where the f32 value lies within that of a rounding
  boundary the bf16 result moves by one step.  So the gains are held to
  ``REL`` where their gradient is f32 and, as they are, to one bf16 step
  an element (``steps``); every f32 leaf to ``REL`` in both.  And one
  step with frozen expert masks (``masked``): parameters to ``REL``,
  pruned weights exactly zero.
* ``moe_serve``: ``make_prefill_step`` and ``make_serve_step`` as the
  dry-run calls them (``steps``); the drip (decode steps from an empty
  cache) of a compiled
  model — quant attention projections, and qwen2-moe-a2.7b's shared
  expert as sparse blocks under stripe masks that the pattern rule
  shards over ``model`` where they partition — with the float and int4x2
  caches; and the layer cases of :data:`LAYER_CASES`: one ``moe_apply`` on
  a placed input against one process, its keep masks, its drop count, its
  rank-0 expert products' FLOPs (``OpCosts``) beside the bound
  ``6·E·ceil(C/d)·D·(Fe/m)``, and the gathered output for the test
  process to hold against the reference's ``moe_apply``.
"""
import dataclasses
import math

import numpy as np
import torch

from _sharding_workers import _grads, _rel, _stripe, _train_cases

ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
KV = ("float", "int4x2")
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}
DRIP_STEPS = 5
# name -> (capacity_factor, B, T, x's T axis over ``model``): S = 32
# tokens, E = 8, K = 4; C = 8 (below every expert's share of the 128
# entries: drops certain), 17 (which 2 data ranks do not divide) and the
# config's own 20
LAYER_CASES = {"drop": (0.25, 4, 8, False), "ragged": (1.05, 4, 8, False),
               "config": (1.25, 4, 8, False), "seq": (1.25, 4, 8, True)}


def layer_config(arch: str, cf: float):
    from repro_torch.configs import reduced_config

    return dataclasses.replace(reduced_config(arch), capacity_factor=cf)


def layer_input(cfg, B: int, T: int) -> np.ndarray:
    """The layer cases' input: seeded normal rows, shifted along the
    router's first column so that the routing is skewed."""
    from repro_torch.models import model as tm

    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    w0 = tm.init_params(cfg, seed=0, device="cpu")["blocks"]["moe"][
        "router"]["w"][0, :, 0].numpy()
    return x + 2.0 * w0[None, None]


def layer_params(cfg):
    """Layer 0's MoE parameters of the seed-0 model (plain tensors)."""
    from repro_torch.models import model as tm

    p = tm.init_params(cfg, seed=0, device="cpu")["blocks"]["moe"]
    return tm._tree_index(p, 0)


def f32_gains(tree):
    """``tree`` with its bf16 leaves (the norm gains) cast to f32."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                    tree)


def bf16_steps(a, b) -> float:
    """The largest difference of ``b`` from the bf16 tensor ``a``, in bf16
    steps (units in the last place) of ``a``'s elements."""
    b = b.full_tensor() if hasattr(b, "full_tensor") else b
    a, b = a.detach().float(), b.detach().float()
    _, e = torch.frexp(a)
    ulp = torch.where(a == 0, torch.full_like(a, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(a), e - 8))
    return float(((a - b).abs() / ulp).max())


def _bf16_gain_case(mesh, cfg):
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm

    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    params = tm.init_params(cfg, seed=0, device="cpu")
    placed, _, _ = sh.shard_params(params, cfg, mesh)
    l1, g1 = _grads(tm, cfg, params, batch)
    l2, g2 = _grads(tm, cfg, placed, sh.shard_batch(batch, cfg, mesh))
    bf16 = [k for k in g1 if g1[k].dtype == torch.bfloat16]
    return {"loss": _rel(l1, l2),
            "grads": max(_rel(g1[k], g2[k]) for k in g1 if k not in bf16),
            "steps": max(bf16_steps(g1[k], g2[k]) for k in bf16),
            "n_bf16": len(bf16)}


def _masked_case(mesh, cfg):
    """One AdamW step of ``make_train_step`` with frozen expert masks
    (``eg`` / ``eu`` / ``ed``, half of each slice's elements, seeded),
    ``n_micro`` 2, on the f32-gain tree, placed (masks by
    ``shard_masks``) against one process: the parameters within ``REL``
    and every pruned weight exactly zero after the step."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_items

    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    params = f32_gains(tm.init_params(cfg, seed=0, device="cpu"))
    moe = params["blocks"]["moe"]
    masks = {"blocks": {"moe": {}}}
    for name in ("eg", "eu", "ed"):
        w = moe[name]["w"]
        m = torch.from_numpy(rng.random(tuple(w.shape)) < 0.5)
        w.mul_(m.to(w.dtype))
        masks["blocks"]["moe"][name] = {"w": m}
    oc = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1, total_steps=4)
    opt = adamw_init(params, oc)
    placed, _, _ = sh.shard_params(params, cfg, mesh)
    p1, _, _ = make_train_step(cfg, oc, 2, masks)(params, opt, batch)
    p2, _, _ = make_train_step(cfg, oc, 2, sh.shard_masks(masks, placed))(
        placed, sh.shard_opt_state(opt, params, cfg, mesh),
        sh.shard_batch(batch, cfg, mesh))
    zero = all(
        not bool(((p2["blocks"]["moe"][k]["w"].full_tensor() != 0)
                  & ~masks["blocks"]["moe"][k]["w"]).any())
        for k in ("eg", "eu", "ed"))
    return {"params": max(_rel(a, b) for (_, a), (_, b) in zip(
        tree_items(p1), tree_items(p2))), "pruned_zero": zero}


def _step_cases(mesh, cfg):
    """``make_prefill_step`` on a 4 × 8 batch and ``make_serve_step`` (two
    steps over a float cache), as the dry-run calls them, on the seed-0
    tree: placed against one process."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.train.trainer import make_prefill_step, make_serve_step

    params = tm.init_params(cfg, seed=0, device="cpu")
    placed, _, _ = sh.shard_params(params, cfg, mesh)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8))
                            .astype(np.int32))
    put = lambda t: sh.shard_batch({"tokens": t}, cfg, mesh)  # noqa: E731
    out = {"prefill": _rel(make_prefill_step(cfg)(params, {"tokens": toks}),
                           make_prefill_step(cfg)(placed, put(toks)))}
    serve = make_serve_step(cfg)
    one = tm.init_cache(cfg, 4, 16, device="cpu")
    cache = sh.shard_cache(tm.init_cache(cfg, 4, 16, device="cpu"), cfg,
                           mesh)
    errs = []
    for i in range(2):
        a, one = serve(params, one, toks[:, i:i + 1])
        b, cache = serve(placed, cache, put(toks[:, i:i + 1])["tokens"])
        errs.append(_rel(a, b))
    out["serve"] = max(errs)
    return out


def _drip_cases(mesh, cfg):
    from repro_torch.core import compile_sparse as tc
    from repro_torch.launch import mesh as lm, sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_items

    params = tm.init_params(cfg, seed=0, device="cpu")
    policies, masks = dict(SERVE), {}
    if cfg.n_shared_experts:
        D, Fs = cfg.d_model, cfg.d_expert * cfg.n_shared_experts
        masks = {"wg": _stripe(cfg.n_layers, D // 16, Fs // 16),
                 "wu": _stripe(cfg.n_layers, D // 16, Fs // 16),
                 "wd": _stripe(cfg.n_layers, Fs // 16, D // 16)}
    else:
        policies = {k: v for k, v in policies.items()
                    if k not in ("wg", "wu", "wd")}
    rules = tc.CompileRules(block=(16, 16), block_density=0.5,
                            in_block_density=0.5, min_weight_elems=0,
                            quant_bits=4, policies=policies)
    cm = tc.compile_model(params, cfg, rules=rules, masks=masks or None,
                          device="cpu")
    placed, specs, local = sh.shard_params(cm.params, cfg, mesh, cm.patterns)
    n_model = lm.mesh_size(mesh, "model")
    out = {"pattern_sharded": sum(
        1 for path, s in tree_items(specs)
        if "shared" in path and path[-1] == "w_blkp" and "model" in s
        and n_model > 1),
        "shared_compiled": sum(1 for path, _ in tree_items(cm.params)
                               if "shared" in path and path[-1] == "w_blkp")}
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, DRIP_STEPS))
                            .astype(np.int32))

    def run(p, cache, place):
        logits = []
        for i in range(DRIP_STEPS):
            t = toks[:, i:i + 1]
            if place:
                t = sh.shard_batch({"tokens": t}, cfg, mesh)["tokens"]
            lg, cache = tm.decode_step(p, cfg, cache, t,
                                       patterns=cm.patterns)
            logits.append(lg)
        return logits, cache

    for kv in KV:
        ref, rc = run(cm.params, tm.init_cache(cfg, 4, 16, kv, device="cpu"),
                      False)
        cache = sh.shard_cache(tm.init_cache(cfg, 4, 16, kv, device="cpu"),
                               cfg, mesh, kv)
        got, gc = run(placed, cache, True)
        out[f"{kv}/logits"] = max(_rel(a, b) for a, b in zip(ref, got))
        out[f"{kv}/cache"] = max(_rel(a, b) for (_, a), (_, b) in zip(
            tree_items(rc), tree_items(gc)))
    return out


def _layer_case(mesh, arch, cf, B, T, seq):
    from repro_torch.core import sharded
    from repro_torch.launch import mesh as lm, sharding as sh
    from repro_torch.launch.op_costs import OpCosts
    from repro_torch.models import blocks as tb, model as tm

    cfg = layer_config(arch, cf)
    p1 = layer_params(cfg)
    placed, _, _ = sh.shard_params(tm.init_params(cfg, seed=0, device="cpu"),
                                   cfg, mesh)
    p2 = tm._tree_index(placed["blocks"]["moe"], 0)
    x = torch.from_numpy(layer_input(cfg, B, T))
    dp = lm.data_axes(mesh)
    spec = (dp if len(dp) > 1 else dp[0], "model" if seq else None, None)
    px = sharded.place(x, mesh, sh.placements(spec, mesh))
    keeps = []
    route = tb.moe_route

    def spy(p, cfg_, xt, dispatch=None):
        r = route(p, cfg_, xt, dispatch)
        keeps.append(r[3])
        return r

    tb.moe_route = spy
    try:
        y1 = tb.moe_apply(p1, cfg, x)
        with OpCosts() as costs:
            y2 = tb.moe_apply(p2, cfg, px)
    finally:
        tb.moe_route = route
    S, E, D, Fe = B * T, cfg.n_experts, cfg.d_model, cfg.d_expert
    C = tb.moe_capacity(cfg, S)
    m = lm.mesh_size(mesh, "model")
    d = lm.mesh_size(mesh, dp)
    return {"rel": _rel(y1, y2), "C": C, "d": d, "m": m,
            "keep_equal": all(bool(torch.equal(k, keeps[0]))
                              for k in keeps[1:]),
            "routings": len(keeps),
            "drops": int((~keeps[0]).sum()),
            "bmm_flops": costs.flops_by_op.get("bmm", 0),
            "bmm_bound": 6 * E * math.ceil(C / d) * D * (Fe // m),
            "bmm_one_process": 6 * E * C * D * Fe,
            "placements": [str(p) for p in y2.placements],
            "y": y2.full_tensor().numpy()}


def moe_cases(mesh, kind: str):
    """Every case of ``kind`` ("moe_train" / "moe_serve") for both
    configs on ``mesh``."""
    from repro_torch.configs import reduced_config

    out = {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        if kind == "moe_train":
            out[arch] = {"f32": _train_cases(mesh, cfg, f32_gains),
                         "bf16_gains": _bf16_gain_case(mesh, cfg),
                         "masked": _masked_case(mesh, cfg)}
            continue
        res = {"drip": _drip_cases(mesh, cfg), "steps": _step_cases(mesh, cfg)}
        for name, (cf, B, T, seq) in LAYER_CASES.items():
            res[name] = _layer_case(mesh, arch, cf, B, T, seq)
        out[arch] = res
    return out
