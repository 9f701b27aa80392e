"""The gloo ranks' cases of the SSM and hybrid families' placed paths
(``tests/test_torch_{hybrid,xlstm}_sharding*.py``), run by
``_sharding_workers.run_rank`` with ``kind`` "hybrid_train",
"hybrid_serve", "xlstm_train" or "xlstm_serve".

Each family at two sizes (:func:`configs`): its stock ``reduced_config``
(f32) and a ``cut`` one, made here, with which a ``model`` axis of 4
meets what 16 meets at full width:

* zamba2-2.7b ``cut``: ``d_inner`` 256, ``ssm_state`` 16 — ``win``'s 548
  columns split 137 a rank across the z / xBC / dt boundary, ``conv``'s
  288 channels 72 a rank, S and ``wout`` one of the 4 heads a rank (the
  stock config's 2 heads do not split 4 ways: S stays replicated and a
  rank's channels are half a head);
* xlstm-1.3b ``cut``: ``n_heads`` 2, ``d_inner`` 256, ``slstm_every`` 2 —
  ``wq`` cut at half a head, ``wif``'s 4 columns across its i / f halves,
  S at 32 of the 128 key rows.

Every case against the same computation in one process (the unplaced
port, in the same rank), as ``rel``: the largest difference over the
largest one-process magnitude.

* ``*_train``: :func:`_sharding_workers._train_cases` — loss, every
  gradient, every parameter and moment after one AdamW step, ``n_micro``
  1 and 2, ``seq_shard`` off and on — with the norm gains in f32
  (``f32``), and the gradients with the gains in bf16 as the model makes
  them (``bf16_gains``: f32 leaves to ``REL``, each gain within one bf16
  step an element; ``_moe_workers._bf16_gain_case``).  AdamW runs with
  ``eps`` :data:`ADAM_EPS`: its first step moves an element by ``lr ·
  g / (|g| + eps)``, which multiplies a gradient's difference by about
  ``max|g| / (4·eps)`` where ``|g|`` is near ``eps``.  The sLSTM bias
  (zero at init) and the embedding have gradients up to ~0.02 whose
  last-bit differences from the batch split (present at (2, 1) too,
  where every rank runs the unplaced block on its rows) reach 3e-6 of
  the leaf, so at the dense family's 1e-3 the step would show them ~6×
  larger; at 1e-2 it shows them as they are.
* ``*_serve``: ``make_prefill_step`` and two ``make_serve_step`` calls
  (``steps``, ``_moe_workers._step_cases``); the drip — :data:`DRIP_STEPS`
  decode steps from an empty cache — of zamba2-2.7b compiled (quant
  attention projections, sparse MLP blocks) with the float and int4x2
  caches, and of xlstm-1.3b with dense and int8 mLSTM leaves (``drip``):
  logits and every cache leaf, the cache tree keeping its tensors; and
  the stock config's raw drip's logits for the test process to hold
  against the reference's ``decode_step``.  xlstm-1.3b also at ``odd``
  (:data:`ODD`: ``d_inner`` 120, heads of 30), whose key features a
  ``model`` axis of 4 does not divide: the rules replicate the mLSTM
  state there, and each rank updates its rows of it (7 or 8), exchanged
  after each step.
"""
import dataclasses

import numpy as np
import torch

from _moe_workers import _bf16_gain_case, _step_cases, f32_gains
from _sharding_workers import _rel, _train_cases

DRIP_STEPS = 4
ADAM_EPS = 1e-2
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}
FAMILY = {"hybrid": "zamba2-2.7b", "xlstm": "xlstm-1.3b"}
CUT = {"zamba2-2.7b": dict(d_inner=256, ssm_state=16),
       "xlstm-1.3b": dict(n_heads=2, d_inner=256, slstm_every=2)}
SIZES = ("stock", "cut")
ODD = {"xlstm-1.3b": dict(d_inner=120)}


def configs(arch: str):
    """``{"stock": reduced_config(arch), "cut": ...}`` (see the module
    docstring)."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    return {"stock": cfg, "cut": dataclasses.replace(cfg, **CUT[arch])}


def delivered(plans, N: int) -> list:
    """The global columns each rank receives when every rank ``s`` sends
    its even shard's columns ``plans[s].send`` of an N-wide last dim, cut
    by ``send_counts``, in one all-to-all (``sharded._take_cols``), in
    the order the rank gets them; each pair's send and receive counts
    must agree."""
    n = len(plans)
    w = N // n
    out = []
    for r in range(n):
        pieces = []
        for s, ps in enumerate(plans):
            assert ps.send_counts[r] == plans[r].recv_counts[s], (s, r)
            off = sum(ps.send_counts[:r])
            pieces.append(ps.send.numpy()[off:off + ps.send_counts[r]]
                          + s * w)
        out.append(np.concatenate(pieces))
    return out


def drip_tokens(cfg) -> np.ndarray:
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab, (4, DRIP_STEPS)).astype(np.int32)


def _drip(mesh, cfg, kv: str, compiled: bool):
    from repro_torch.core import compile_sparse as tc
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_items

    params = tm.init_params(cfg, seed=0, device="cpu")
    patterns = None
    if compiled:
        rules = tc.CompileRules(block=(16, 16), block_density=0.5,
                                in_block_density=0.5, min_weight_elems=0,
                                quant_bits=4, policies=SERVE)
        cm = tc.compile_model(params, cfg, rules=rules, device="cpu")
        params, patterns = cm.params, cm.patterns
    placed, _, _ = sh.shard_params(params, cfg, mesh, patterns)
    toks = torch.from_numpy(drip_tokens(cfg))

    def run(p, cache, place):
        logits = []
        for i in range(DRIP_STEPS):
            t = toks[:, i:i + 1]
            if place:
                t = sh.shard_batch({"tokens": t}, cfg, mesh)["tokens"]
            lg, cache = tm.decode_step(p, cfg, cache, t, patterns=patterns)
            logits.append(lg)
        return logits, cache

    with torch.no_grad():
        ref, rc = run(params, tm.init_cache(cfg, 4, 16, kv, device="cpu"),
                      False)
        cache = sh.shard_cache(tm.init_cache(cfg, 4, 16, kv, device="cpu"),
                               cfg, mesh, kv)
        before = dict(tree_items(cache))
        got, gc = run(placed, cache, True)
    return {"logits": max(_rel(a, b) for a, b in zip(ref, got)),
            "cache": max(_rel(a, b) for (_, a), (_, b) in zip(
                tree_items(rc), tree_items(gc))),
            "same_tensors": gc is cache and all(
                t is before[k] for k, t in tree_items(gc)),
            "placed": all(hasattr(t, "placements") for _, t in
                          tree_items(gc)),
            "got": [g.full_tensor().numpy() for g in got]}


def ssm_cases(mesh, kind: str):
    """Every case of ``kind`` (see the module docstring) on ``mesh``."""
    family, what = kind.split("_")
    arch = FAMILY[family]
    out = {}
    for size, cfg in configs(arch).items():
        if what == "train":
            out[size] = {"f32": _train_cases(mesh, cfg, f32_gains,
                                             eps=ADAM_EPS),
                         "bf16_gains": _bf16_gain_case(mesh, cfg)}
            continue
        res = {"steps": _step_cases(mesh, cfg)}
        if arch == "zamba2-2.7b":
            for kv in ("float", "int4x2"):
                res[f"compiled/{kv}"] = _drip(mesh, cfg, kv, True)
            res["raw/float"] = _drip(mesh, cfg, "float", False)
        else:
            for mode in ("dense", "int8"):
                res[f"{mode}/float"] = _drip(
                    mesh, dataclasses.replace(cfg, linear_mode=mode),
                    "float", False)
        out[size] = res
    if what == "serve" and arch in ODD:
        cfg = dataclasses.replace(configs(arch)["stock"], **ODD[arch])
        out["odd"] = {"dense/float": _drip(mesh, cfg, "float", False)}
    return out
