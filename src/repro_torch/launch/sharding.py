"""Sharding rules — the reference's parameter, optimizer, batch and cache
specs — and their placement as DTensors.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dim split over those axes in that
order): the reference's ``PartitionSpec``.  The rules are the reference's
(``repro.launch.sharding``), name-based over the tree paths: tensor
parallelism (TP) for every projection class, FSDP extension over the data
axes for weights past :data:`_FSDP_MIN_ELEMS` elements, ZeRO-sharded AdamW
moments, and shape-dependent KV-cache layouts (heads over ``model`` when it
divides the kv heads, else the sequence).  Compressed leaves follow their
payload family's ``shard_tails`` / ``legacy_tp`` (the registry), so a new
leaf format shards without editing this table.

:func:`placements` maps a spec to one DTensor ``Shard(dim)`` /
``Replicate()`` per mesh dim; :func:`shard_params` and its siblings place a
tree.  The rules themselves are pure: they run on a stub mesh (see
:mod:`repro_torch.launch.mesh`) without any device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from ..core import payload_registry
from ..core.sharded import (local_pattern, model_coord, place,
                            schedule_shardable)
from ..models.config import ArchConfig
from ..tree import tree_map
from .mesh import axis_names, data_axes, mesh_size

__all__ = ["batch_specs", "cache_specs", "opt_specs", "opt_state_specs",
           "param_specs", "place_tree",
           "placements", "sanitize_specs", "schedule_shardable",
           "shard_batch", "shard_cache", "shard_masks", "shard_opt_state",
           "shard_params", "specs_placements"]

PyTree = Any
Spec = Tuple

# (path fragment, spec of the *trailing* dims of the unstacked param);
# first match wins, stacked layer dims pad with None on the left.  The
# compressed leaves' rows come from their payload families
# (:func:`_family_tp_rules`), ahead of these.
_TP_RULES = [
    ("embed", ("model", None)),          # vocab-sharded embedding
    ("head", (None, "model")),           # vocab-sharded unembedding
    ("frontend_proj", (None, None)),
    ("router", (None, None)),
    ("slstm", (None,)),                  # sLSTM fully replicated
    ("eg", (None, None, "model")),       # MoE experts: TP over the FFN dim
    ("eu", (None, None, "model")),
    ("ed", (None, "model", None)),
    ("wq", (None, "model")),             # column-parallel in
    ("wk", (None, "model")),
    ("wv", (None, "model")),
    ("wg", (None, "model")),
    ("wu", (None, "model")),
    ("win", (None, "model")),
    ("wif", (None, "model")),
    ("wog", (None, "model")),
    ("wx", (None, "model")),
    ("wo", ("model", None)),             # row-parallel out
    ("wd", ("model", None)),
    ("wout", ("model", None)),
    ("conv", (None, "model")),           # mamba conv kernel: channel-sharded
]

_FSDP_MIN_ELEMS = 1 << 20


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in getattr(leaf, "shape", ()))


def _size(leaf) -> int:
    return math.prod(_shape(leaf))


def _pattern_tail(leaf_shape, patterns, n_shards: int,
                  packed: bool = False) -> Spec:
    """Trailing spec of a ``w_blk`` / ``w_blkp`` leaf (..., P, bk, bn) under
    the pattern side-table: row-parallel over ``model`` only when the
    matching pattern's schedule partitions evenly; replicated otherwise.

    The leaf is matched to its pattern structurally — the (bk, bn) block
    and the packed length P — since the table is keyed by the logical
    (K, N), which the compacted leaf no longer carries.  Several matching
    patterns must all agree on shardability, else the leaf stays
    replicated.  ``packed`` marks a bit-packed container whose bk axis holds
    nibble pairs (bk / 2 rows): the logical bk is recovered for the match.
    """
    P, bk, bn = leaf_shape[-3:]
    if packed:
        bk *= 2
    cands = [p for p in patterns.values()
             if tuple(p.block) == (bk, bn) and p.n_blocks_present == P]
    if cands and all(schedule_shardable(p, n_shards) for p in cands):
        return ("model", None, None)
    return (None, None, None)


def _family_tp_rules():
    """The pattern-free fallback rows of the payload families: each family
    with a ``legacy_tp`` tail shards its key leaf by name, ahead of the
    path rules, so a compressed leaf never falls through to its
    projection's dense rule."""
    return [(fam.key_leaf, tuple(fam.legacy_tp))
            for fam in payload_registry.all_families()
            if fam.legacy_tp is not None]


def _tp_spec(pstr: str, ndim: int) -> Spec:
    parts = pstr.split("/")
    for frag, tail in _family_tp_rules() + _TP_RULES:
        if frag in parts:
            if len(tail) > ndim:
                tail = tail[-ndim:]     # the reference's slice, ndim 0 too
            return (None,) * (ndim - len(tail)) + tuple(tail)
    return (None,) * ndim


def _fsdp_extend(spec: Spec, shape: Tuple[int, ...], dp: Tuple[str, ...],
                 dp_size: int) -> Spec:
    """Shard the largest still-replicated dim over the data axes (FSDP /
    ZeRO), only where it divides; the biggest dim first."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and shape[i] % dp_size == 0 and shape[i] >= dp_size:
            return spec[:i] + (dp if len(dp) > 1 else dp[0],) + spec[i + 1:]
    return spec


def param_specs(params: PyTree, cfg: ArchConfig, mesh, *, fsdp: bool = True,
                zero: bool = False, patterns=None) -> PyTree:
    """The spec tree of ``params`` (``zero=True`` for the optimizer moments:
    always FSDP-extended, as ZeRO-1).

    ``patterns`` is the compile pass's side-table ((K, N) ->
    BlockSparsePattern).  A leaf its family marks ``"pattern"`` (the sparse
    ``w_blk`` / ``w_blkp`` / ``w_ablk`` containers) gets a pattern-aware
    spec when ``patterns`` is given (:func:`_pattern_tail`); one marked
    ``"replicate"`` stays replicated; everything else follows the path
    rules, which include each family's ``legacy_tp`` row
    (:func:`sanitize_specs` remains the net)."""
    dp = data_axes(mesh)
    dp_size = mesh_size(mesh, dp)
    mdl_size = mesh_size(mesh, "model")

    def one(path, leaf):
        shape = _shape(leaf)
        mode, packed = payload_registry.shard_info(path[-1])
        if mode == "pattern" and patterns is not None:
            tail = _pattern_tail(shape, patterns, mdl_size, packed=packed)
            spec = (None,) * (len(shape) - len(tail)) + tail
        elif mode == "replicate":
            spec = (None,) * len(shape)
        else:
            spec = _tp_spec("/".join(path), len(shape))
        if (fsdp or zero) and _size(leaf) >= _FSDP_MIN_ELEMS and dp_size > 1:
            spec = _fsdp_extend(spec, shape, dp, dp_size)
        return spec

    return _map_with_path(one, params)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return None if tree is None else fn(path, tree)


def opt_state_specs(opt_state: PyTree, pspecs: PyTree) -> PyTree:
    """AdamW's state: the moments take the (ZeRO-extended) parameter specs,
    the step counter is replicated."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def batch_specs(cfg: ArchConfig, mesh) -> PyTree:
    """Batch rows over the data axes."""
    dp = data_axes(mesh)
    b = dp if len(dp) > 1 else dp[0]
    specs = {"tokens": (b, None), "labels": (b, None)}
    if cfg.frontend == "patch":
        specs["prefix_embeds"] = (b, None, None)
    if cfg.frontend == "frame":
        specs = {"frame_embeds": (b, None, None), "labels": (b, None)}
    return specs


def cache_specs(cfg: ArchConfig, mesh, *, batch: int = 0,
                kv_cache: str = "float") -> PyTree:
    """KV / state cache specs for decode.

    Attention caches (L, B, T, Hkv, Dh): batch over the data axes when
    ``batch`` divides (0: assume it does), otherwise the *sequence* dim
    carries them (long-context B = 1 serving); heads over ``model`` when it
    divides ``n_kv_heads``, else T takes ``model`` too (a sequence-sharded
    KV cache, whose read needs a partial-softmax combine).

    ``kv_cache`` names the container (:data:`repro_torch.models.blocks.
    KV_CACHE_MODES`).  The quantised ones hold, beside ``length``: codes of
    k's shape (``k_q`` / ``v_q``, int8) or k's shape with Dh halved
    (``k_p`` / ``v_p``, int4x2), each with the spec of its ``k`` / ``v``;
    and per-row scales (L, B, T, Hkv) (``k_s`` / ``v_s``), with k's spec
    less its head-dim entry — so codes and scales always shard on the same
    head / sequence axis as the float cache would.  The SSM and hybrid
    families' recurrent states follow the reference."""
    dp = data_axes(mesh)
    b = dp if len(dp) > 1 else dp[0]
    mdl = mesh_size(mesh, "model")
    dp_size = mesh_size(mesh, dp)
    b_ok = batch == 0 or batch % dp_size == 0
    bdim = b if b_ok else None

    def attn_spec():
        if cfg.n_kv_heads % mdl == 0:
            kv = (None, bdim, None if b_ok else b, "model", None)
        else:
            tdim = "model" if b_ok else (b + ("model",) if isinstance(b, tuple)
                                         else (b, "model"))
            kv = (None, bdim, tdim, None, None)  # sequence-sharded KV
        length = (None, bdim)
        if kv_cache in (None, "float"):
            return {"k": kv, "v": kv, "length": length}
        codes = ("k_q", "v_q") if kv_cache == "int4" else ("k_p", "v_p")
        return {codes[0]: kv, codes[1]: kv, "k_s": kv[:-1], "v_s": kv[:-1],
                "length": length}

    if cfg.family in ("dense", "vlm", "moe"):
        return attn_spec()
    if cfg.family == "ssm":
        P_head = cfg.d_inner // cfg.n_heads
        m = "model" if P_head % mdl == 0 else None
        return {
            "slstm": {"h": (None, bdim, None), "c": (None, bdim, None),
                      "n": (None, bdim, None)},
            "mlstm": {"S": (None, None, bdim, None, m, None),
                      "n": (None, None, bdim, None, m)},
        }
    if cfg.family == "hybrid":
        H = cfg.d_inner // 64  # the Mamba2 head dim
        m = "model" if H % mdl == 0 else None
        return {
            "attn": attn_spec(),
            "mamba": {"S": (None, None, bdim, m, None, None),
                      "conv": (None, None, bdim, None, "model")},
        }
    raise ValueError(cfg.family)


def sanitize_specs(spec_tree: PyTree, shape_tree: PyTree, mesh) -> PyTree:
    """The final net: drop every axis that does not evenly divide its dim
    (e.g. a 504-entry vocab over a 16-way ``model`` axis)."""
    def ax_size(ax):
        return 1 if ax is None else mesh_size(mesh, ax)

    def one(spec, leaf):
        shape = _shape(leaf)
        axes = tuple(spec)
        if len(axes) < len(shape):
            axes = (None,) * (len(shape) - len(axes)) + axes
        fixed = []
        for dim, ax in zip(shape, axes[:len(shape)]):
            n = ax_size(ax)
            fixed.append(ax if n == 1 or dim % n == 0 else None)
        return tuple(fixed)

    return _map_specs(one, spec_tree, shape_tree)


def _map_specs(fn, specs, *rest):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return None if specs is None else fn(specs, *rest)


# -------------------------------------------------------------- placement


def placements(spec: Spec, mesh) -> list:
    """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim d
    names that mesh axis (a dim split over ``("pod", "data")`` takes
    ``Shard(d)`` on both, in mesh order, as the reference's tuple reads),
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        axes = () if ax is None else (tuple(ax) if isinstance(ax, (tuple, list))
                                      else (ax,))
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {d} splits over {axes}, not in the mesh's "
                f"axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names mesh axis {names[i]} "
                                 "twice")
            out[i] = Shard(d)
    return out


def specs_placements(spec_tree: PyTree, mesh) -> PyTree:
    """A spec tree as a tree of ``(mesh, placements)`` pairs (what
    :meth:`repro_torch.train.checkpoint.Checkpointer.restore` takes)."""
    return _map_specs(lambda s: (mesh, placements(s, mesh)), spec_tree)


def place_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """``tree`` (the same full tree on every rank) as DTensors placed by the
    spec tree ``specs``."""
    return _map_specs(lambda s, t: place(t, mesh, placements(s, mesh)),
                      specs, tree)


def shard_params(params: PyTree, cfg: ArchConfig, mesh, patterns=None):
    """``params`` (the same full tree on every rank) as DTensors placed by
    ``sanitize_specs(param_specs(...))``; returns (placed params, specs,
    local patterns).  The local side-table holds, for each (K, N) whose
    pattern-sharded leaf shards over ``model``, this rank's pattern
    (:func:`repro_torch.core.sharded.local_pattern`: block-rows
    ``r·nR/n ..``, its blocks chunk ``r`` of the leaf)."""
    specs = sanitize_specs(
        param_specs(params, cfg, mesh, patterns=patterns), params, mesh)
    n, r = model_coord(mesh)
    local: Dict[Tuple[int, int], Any] = {}

    def note(path, leaf):
        mode, packed = payload_registry.shard_info(path[-1])
        spec = specs
        for k in path:
            spec = spec[k]
        if mode != "pattern" or n == 1 or "model" not in spec:
            return
        P, bk, bn = _shape(leaf)[-3:]
        bk *= 2 if packed else 1
        for kn, pat in patterns.items():
            if tuple(pat.block) == (bk, bn) and pat.n_blocks_present == P:
                local[kn] = local_pattern(pat, n, r)

    if patterns:
        _map_with_path(note, params)
    return place_tree(params, specs, mesh), specs, local


def opt_specs(params: PyTree, cfg: ArchConfig, mesh, patterns=None) -> PyTree:
    """AdamW's state specs: ``opt_state_specs`` over the ZeRO-extended,
    sanitised parameter specs."""
    zspecs = sanitize_specs(
        param_specs(params, cfg, mesh, zero=True, patterns=patterns),
        params, mesh)
    return opt_state_specs(None, zspecs)


def shard_opt_state(opt_state: PyTree, params: PyTree, cfg: ArchConfig, mesh,
                    patterns=None) -> PyTree:
    """AdamW's moments placed by :func:`opt_specs` (ZeRO: the parameter
    specs, FSDP-extended) and its step replicated."""
    return place_tree(opt_state, opt_specs(params, cfg, mesh, patterns),
                      mesh)


def shard_batch(batch: Dict, cfg: ArchConfig, mesh) -> Dict:
    """The batch's rows over the data axes (``batch_specs``)."""
    specs = sanitize_specs(
        {k: v for k, v in batch_specs(cfg, mesh).items() if k in batch},
        batch, mesh)
    return place_tree(batch, specs, mesh)


def shard_cache(cache: PyTree, cfg: ArchConfig, mesh,
                kv_cache: str = "float") -> PyTree:
    """A decode cache placed by ``cache_specs``.  A sequence-sharded KV
    placement (a ``model`` axis that does not divide ``n_kv_heads``, or a
    batch the data axes do not divide) is written and read on each rank's
    range of T, the ranks' partial reads combined
    (:func:`repro_torch.models.blocks._cache_attend`)."""
    attn = cache.get("attn", cache)
    B = int((attn["length"] if "length" in attn
             else cache["slstm"]["h"]).shape[1])
    specs = sanitize_specs(cache_specs(cfg, mesh, batch=B, kv_cache=kv_cache),
                           cache, mesh)
    return place_tree(cache, specs, mesh)


def shard_masks(masks: PyTree, params: PyTree) -> PyTree:
    """Frozen sparsity masks placed like their (placed) weights."""
    return tree_map(lambda m, p: None if m is None else
                    place(m, p.device_mesh, p.placements), masks, params)
