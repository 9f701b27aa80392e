"""The gloo ranks of ``tests/test_torch_sharding_apply.py``: each spawned
process starts one rank of a ``(data, model)`` mesh on the CPU, runs every
case of that mesh against the same computation in one process (the
unplaced port, in the same rank), and puts its numbers on a queue.

Reduced llama3.2-1b (f32 parameters, bf16 norm gains), 4 sequences of 16
tokens.  Every case reports the largest difference relative to the largest
magnitude of the one-process value (``rel``), over every leaf or output.

* ``train``: the loss, every gradient and every parameter after one AdamW
  step, ``seq_shard`` off and on, ``n_micro`` 1 and 2.  The parameter check
  runs AdamW with ``eps = 1e-3``: at the default 1e-8 its first step is
  ``lr · sign(g)`` for a gradient within rounding of zero, which turns a
  1e-7 difference of the all-reduce order into a whole ``2 · lr``.
  ``_FSDP_MIN_ELEMS`` is lowered to 1024 elements so that FSDP and ZeRO
  place the reduced leaves over the data axis as they would the full ones.
* ``decode``: a compiled model (quant ``wq``/``wk``/``wv``/``wo`` at 4
  bits; sparse MLP blocks under crafted stripe masks, so the pattern-aware
  rule shards their block axis over ``model`` and each rank runs its local
  schedule) through a 4-row prefill chunk and three decode steps, with the
  float and int4x2 caches; at a ``model`` axis that does not divide the 2
  kv heads the cache is sequence-sharded.
* ``ckpt``: each rank a host (two or four), the placed parameters and
  moments saved and restored to placements.
* ``refuse``: a DTensor handed to a kernel wrapper raises.
* ``uneven`` (``tests/test_torch_seq_shard_uneven.py``): the ``seq_shard``
  train case alone at a T the ``model`` axis does not divide
  (:data:`UNEVEN_T`): DTensor cuts T as ``torch.chunk`` does, so the
  ranks' query rows start at multiples of ``ceil(T / n)``.

The MoE family (``tests/test_torch_moe_sharding*.py``, ``kind =
"moe_train"`` / ``"moe_serve"``): ``tests/_moe_workers.py``.  The SSM and
hybrid families (``tests/test_torch_{hybrid,xlstm}_sharding*.py``):
``tests/_ssm_workers.py``.

The sequence-sharded cache (``tests/test_torch_seq_cache.py``, ``kind =
"seq"``): :data:`SEQ_CASES` names, for each mesh, the (kv heads, batch) of
reduced llama3.2-1b (f32) whose cache ``cache_specs`` cuts along T; each
runs one decode step, a 16-row prefill chunk (straddling ranks) and three
more decode steps on a 32-row cache, placed and in one process, for every
container and read of :data:`SEQ_READS`.
"""
import dataclasses
import os
import tempfile
import traceback

import numpy as np
import torch

KV = ("float", "int4x2")
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}


def _rel(a, b) -> float:
    a = a.detach().float()
    b = b.full_tensor() if hasattr(b, "full_tensor") else b
    b = b.detach().float()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


def _grads(tm, cfg, params, batch):
    from repro_torch.tree import tree_items

    items = list(tree_items(params))
    leaves = [t.detach().requires_grad_() for _, t in items]
    tree = {}
    for (path, _), t in zip(items, leaves):
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    loss = tm.loss_fn(tree, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss, {p: g for (p, _), g in zip(items, grads)}


def _train_cases(mesh, cfg0, prepare=None, eps=1e-3, T=16,
                 seqs=(False, True)):
    """The train cases on ``mesh``; ``prepare`` (a function of the
    parameter tree) changes the seed-0 tree first; ``eps`` is AdamW's;
    4 sequences of ``T`` tokens; ``seqs`` the ``seq_shard`` settings."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step
    from repro_torch.tree import tree_items

    out = {}
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg0.vocab, (4, T))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    oc = AdamWConfig(lr=1e-2, eps=eps, warmup_steps=1, total_steps=4)
    for seq in seqs:
        cfg = dataclasses.replace(cfg0, seq_shard=seq)
        params = tm.init_params(cfg, seed=0, device="cpu")
        if prepare is not None:
            params = prepare(params)
        placed, _, _ = sh.shard_params(params, cfg, mesh)
        pbatch = sh.shard_batch(batch, cfg, mesh)
        l1, g1 = _grads(tm, cfg, params, batch)
        l2, g2 = _grads(tm, cfg, placed, pbatch)
        out[f"seq{int(seq)}/loss"] = _rel(l1, l2)
        out[f"seq{int(seq)}/grads"] = max(_rel(g1[k], g2[k]) for k in g1)
        opt = adamw_init(params, oc)
        popt = sh.shard_opt_state(opt, params, cfg, mesh)
        for n_micro in (1, 2) if not seq else (1,):
            step = make_train_step(cfg, oc, n_micro)
            p1, o1, m1 = step(params, opt, batch)
            p2, o2, m2 = step(placed, popt, pbatch)
            key = f"seq{int(seq)}/micro{n_micro}"
            out[f"{key}/params"] = max(
                _rel(a, b) for (_, a), (_, b) in zip(tree_items(p1),
                                                      tree_items(p2)))
            out[f"{key}/moments"] = max(
                _rel(a, b) for (_, a), (_, b) in zip(tree_items(o1["m"]),
                                                      tree_items(o2["m"])))
            out[f"{key}/metrics"] = max(_rel(m1[k], m2[k])
                                        for k in ("loss", "grad_norm"))
    return out


def _stripe(L, nR, nC, b=16):
    bm = np.add.outer(np.arange(nR), np.arange(nC)) % 2 == 0
    m = np.kron(bm, np.ones((b, b), bool))
    return np.broadcast_to(m, (L,) + m.shape).copy()


def _decode_cases(mesh, cfg):
    from repro_torch.core import compile_sparse as tc
    from repro_torch.launch import mesh as lm, sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_items

    params = tm.init_params(cfg, seed=0, device="cpu")
    D, F = cfg.d_model, cfg.d_ff
    masks = {"wg": _stripe(cfg.n_layers, D // 16, F // 16),
             "wu": _stripe(cfg.n_layers, D // 16, F // 16),
             "wd": _stripe(cfg.n_layers, F // 16, D // 16)}
    rules = tc.CompileRules(block=(16, 16), block_density=0.5,
                            in_block_density=0.5, min_weight_elems=0,
                            quant_bits=4, policies=SERVE)
    cm = tc.compile_model(params, cfg, rules=rules, masks=masks, device="cpu")
    placed, specs, local = sh.shard_params(cm.params, cfg, mesh, cm.patterns)
    n_model = lm.mesh_size(mesh, "model")
    out = {"pattern_sharded": sum(
        1 for path, s in tree_items(specs)
        if path[-1] == "w_blkp" and "model" in s and n_model > 1),
        "local_patterns": len(local)}
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8))
                            .astype(np.int32))

    def run(p, cache, place):
        logits = []
        for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7)):
            t = toks[:, lo:hi]
            if place:
                t = sh.shard_batch({"tokens": t}, cfg, mesh)["tokens"]
            fn = tm.prefill_step if hi - lo > 1 else tm.decode_step
            lg, cache = fn(p, cfg, cache, t, patterns=cm.patterns)
            logits.append(lg)
        return logits, cache

    for kv in KV:
        ref, rc = run(cm.params, tm.init_cache(cfg, 4, 32, kv, device="cpu"),
                      False)
        cache = sh.shard_cache(tm.init_cache(cfg, 4, 32, kv, device="cpu"),
                               cfg, mesh, kv)
        got, gc = run(placed, cache, True)
        out[f"{kv}/logits"] = max(_rel(a, b) for a, b in zip(ref, got))
        out[f"{kv}/cache"] = max(_rel(a, b) for (_, a), (_, b) in zip(
            tree_items(rc), tree_items(gc)))
    return out


def _ckpt_case(mesh, cfg, ckdir, rank, world):
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.tree import tree_items

    params = tm.init_params(cfg, seed=3, device="cpu")
    opt = adamw_init(params, AdamWConfig())
    placed, pspecs, _ = sh.shard_params(params, cfg, mesh)
    state = {"params": placed,
             "opt": sh.shard_opt_state(opt, params, cfg, mesh)}
    ck = Checkpointer(ckdir, host_id=rank, n_hosts=world)
    ck.save(7, state, extra={"note": "n hosts"})
    template = {"params": tm.init_params(cfg, seed=4, device="cpu"),
                "opt": adamw_init(params, AdamWConfig())}
    pl = {"params": sh.specs_placements(pspecs, mesh),
          "opt": sh.specs_placements(sh.opt_specs(params, cfg, mesh), mesh)}
    got, manifest = ck.restore(template, placements=pl)
    want = {"params": params, "opt": opt}
    same = all(bool(torch.equal(a.float(), b.full_tensor().float()))
               for (_, a), (_, b) in zip(tree_items(want), tree_items(got)))
    placed_ok = all(list(b.placements) == list(c.placements)
                    for (_, b), (_, c) in zip(tree_items(got["params"]),
                                              tree_items(placed)))
    files = sorted(p for p in os.listdir(os.path.join(ckdir, "step_000000007"))
                   if p.startswith("host_"))
    return {"equal": same, "placements": placed_ok,
            "n_hosts": manifest["n_hosts"], "files": files,
            "note": manifest["note"]}


def _refuse_case(mesh):
    from torch.distributed.tensor import Replicate

    from repro_torch.core import sharded
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul

    x = sharded.place(torch.ones(2, 8), mesh, [Replicate()] * mesh.ndim)
    try:
        quant_matmul(x, torch.zeros(8, 4, dtype=torch.int8), torch.ones(4))
    except TypeError as e:
        return str(e)
    return None


# mesh -> the tokens a sequence of the ``uneven`` train case: rows the
# ``model`` axis does not divide (at model 4, 18 rows are chunks of 5, 5, 5
# and 3; at model 2, 17 rows are 9 and 8)
UNEVEN_T = {(1, 4): 18, (2, 2): 17}


# mesh -> the (n_kv_heads, batch) cases whose cache is cut along T there:
# over model (kv heads it does not divide), over the data axes (a batch of
# one), or over both
SEQ_CASES = {(1, 2): [(1, 2)], (2, 1): [(2, 1)], (1, 4): [(2, 2), (2, 1)],
             (2, 2): [(2, 1), (1, 1), (1, 2)]}
# (container, read) of the sequence-sharded cases
SEQ_READS = [("float", "fused"), ("int4", "fused"), ("int4x2", "fused"),
             ("int4x2", "unpack")]
SEQ_T = 32
SEQ_CHUNKS = ((0, 1), (1, 17), (17, 18), (18, 19), (19, 20))


def seq_config(hkv: int):
    from repro_torch.configs import reduced_config

    return dataclasses.replace(reduced_config("llama3.2-1b"), n_kv_heads=hkv)


def seq_tokens(cfg, B: int):
    rng = np.random.default_rng(5)
    return rng.integers(0, cfg.vocab, (B, SEQ_CHUNKS[-1][1])).astype(np.int32)


def _seq_cases(mesh):
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_items

    out = {}
    shape = tuple(int(s) for s in mesh.shape)
    for hkv, B in SEQ_CASES[shape]:
        cfg = seq_config(hkv)
        params = tm.init_params(cfg, seed=0, device="cpu")
        placed, _, _ = sh.shard_params(params, cfg, mesh)
        toks = torch.from_numpy(seq_tokens(cfg, B))
        for kv, read in SEQ_READS:
            key = f"h{hkv}b{B}/{kv}/{read}"
            one = tm.init_cache(cfg, B, SEQ_T, kv, device="cpu")
            cache = sh.shard_cache(tm.init_cache(cfg, B, SEQ_T, kv,
                                                 device="cpu"), cfg, mesh, kv)
            leaf = cache["k" if kv == "float" else "k_s"]
            out[f"{key}/t_dims"] = [
                mesh.mesh_dim_names[i] for i, p in enumerate(leaf.placements)
                if getattr(p, "dim", None) == 2]
            ref, got = [], []
            for lo, hi in SEQ_CHUNKS:
                fn = tm.prefill_step if hi - lo > 1 else tm.decode_step
                t = toks[:, lo:hi]
                lg, one = fn(params, cfg, one, t, packed_read=read)
                ref.append(lg)
                tp = sh.shard_batch({"tokens": t}, cfg, mesh)["tokens"]
                lg, cache = fn(placed, cfg, cache, tp, packed_read=read)
                got.append(lg.full_tensor())
            out[f"{key}/logits"] = [g.numpy() for g in got]
            out[f"{key}/rel"] = max(_rel(a, b) for a, b in zip(ref, got))
            out[f"{key}/finite"] = all(bool(torch.isfinite(g).all())
                                       for g in got)
            # the placed cache, gathered, against the one-process cache:
            # each rank wrote its own rows and no other
            out[f"{key}/cache"] = max(_rel(a, b) for (_, a), (_, b) in zip(
                tree_items(one), tree_items(cache)))
    return out


def run_rank(rank, world, shape, init, ckdir, q, kind="apply"):
    """One rank: every case of the ``shape`` mesh (``kind`` "apply": the
    train, decode, refusal and checkpoint cases; "uneven": the
    ``seq_shard`` train case at :data:`UNEVEN_T`; "seq": the
    sequence-sharded cache's; "moe_train" / "moe_serve": the MoE family's,
    ``tests/_moe_workers.py``; "hybrid_train" / "hybrid_serve" /
    "xlstm_train" / "xlstm_serve": the SSM and hybrid families',
    ``tests/_ssm_workers.py``); puts ``(rank, results)`` or ``(rank,
    traceback)`` on ``q``."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        from repro_torch.configs import reduced_config
        from repro_torch.launch import mesh as lm, sharding as sh

        sh._FSDP_MIN_ELEMS = 1024
        mesh = lm.make_mesh(shape, ("data", "model"), "cpu")
        if kind == "seq":
            q.put((rank, _seq_cases(mesh)))
            return
        if kind.startswith("moe"):
            from _moe_workers import moe_cases
            q.put((rank, moe_cases(mesh, kind)))
            return
        if kind.startswith(("hybrid", "xlstm")):
            from _ssm_workers import ssm_cases
            q.put((rank, ssm_cases(mesh, kind)))
            return
        cfg = reduced_config("llama3.2-1b")
        if kind == "uneven":
            q.put((rank, _train_cases(mesh, cfg, T=UNEVEN_T[shape],
                                      seqs=(True,))))
            return
        res = {"train": _train_cases(mesh, cfg),
               "decode": _decode_cases(mesh, cfg),
               "refuse": _refuse_case(mesh)}
        res["ckpt"] = _ckpt_case(mesh, cfg, ckdir, rank, world)
        q.put((rank, res))
    except Exception:  # reported to the test, which fails with it
        q.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(shape, timeout: float = 150.0, kind: str = "apply"):
    """Run :func:`run_rank` (its ``kind`` of cases) on every rank of a
    ``shape`` mesh; returns the rank-0 results.  Each rank joins within
    ``timeout`` seconds or is killed, and the call fails rather than
    hangs."""
    import torch.multiprocessing as mp

    world = int(np.prod(shape))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=run_rank, args=(
            r, world, shape, f"file://{d}/store", os.path.join(d, "ck"), q,
            kind))
            for r in range(world)]
        for p in procs:
            p.start()
        try:
            got = dict(q.get(timeout=timeout) for _ in procs)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: v for r, v in got.items() if isinstance(v, str)}
    assert not errors, "\n".join(f"rank {r}:\n{v}" for r, v in errors.items())
    assert all(not p.is_alive() for p in procs)
    return got[0]
