"""Model zoo: init, the full-sequence forward and loss (training, prefill
and scoring), and the cached decode/prefill steps of every family — dense,
encoder, VLM, MoE, SSM and hybrid.

Parameters are plain dicts of tensors whose per-layer leaves are stacked
along a leading layer axis ``(L, ...)``, as in the JAX reference; the steps
loop over the layers in Python.  Caches are updated in place.

The heterogeneous stacks are homogeneous *super-blocks*, with the
reference's layout (so its parameter tree carries over unchanged):

  xlstm  (ssm):    48 = 6 x [1 sLSTM + 7 mLSTM]               (slstm_every 8)
  zamba2 (hybrid): 54 = 9 x [shared attention (tied) + 6 Mamba2]  (attn_every 6)

A super-block's inner stacks (``m_ln``, ``mlstm``, ``mamba``) and their
state caches carry a second stacked axis, ``(L, n_inner, ...)``; the
hybrid's ``shared_attn`` block is unstacked and applied by every
super-block, each with its own KV cache.  The recurrent families serve
through per-token ``decode_step`` (no ``active`` mask, no chunked
prefill): their state advances on every step.

The encoder (``frontend="frame"``) and the VLM (``frontend="patch"``) ride
the dense block behind a stub frontend, one ``frontend_proj`` projection of
precomputed frame or prefix embeddings; an encoder has no decode cache.
MoE swaps the MLP for :func:`repro_torch.models.blocks.moe_apply`; its
router's static capacity depends on the token count, so it serves through
per-token ``decode_step`` (no ``active`` mask, no chunked prefill).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import sharded
from ..device import resolve_device
from ..tree import tree_map
from .blocks import (
    _dtype,
    attn_apply,
    attn_cache_init,
    attn_init,
    mlp_apply,
    mlp_init,
    moe_apply,
    moe_init,
    norm_apply,
    norm_init,
)
from .config import ArchConfig
from .layers import Params, linear_apply
from .shard_hints import seq_shard_hint
from .ssm import (
    mamba2_apply,
    mamba2_cache_init,
    mamba2_init,
    mlstm_apply,
    mlstm_cache_init,
    mlstm_init,
    slstm_apply,
    slstm_cache_init,
    slstm_init,
)

__all__ = ["cache_batch_axes", "decode_step", "embed_inputs", "forward",
           "init_cache", "init_params", "loss_fn", "n_superblocks",
           "prefill_step"]

FAMILIES = ("dense", "encoder", "vlm", "moe", "ssm", "hybrid")
# the families with a decode cache (an encoder has none)
DECODE_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
# the families whose recurrent state advances on every step
RECURRENT_FAMILIES = ("ssm", "hybrid")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"unknown family {cfg.family!r}; the port runs "
            f"{', '.join(FAMILIES)}")


def _check_decode(cfg: ArchConfig) -> None:
    _check_family(cfg)
    if cfg.family not in DECODE_FAMILIES:
        raise ValueError(f"{cfg.family} has no decode cache")


def n_superblocks(cfg: ArchConfig) -> int:
    """The stacked axis of ``blocks``: super-blocks for the SSM and hybrid
    families, layers for the others."""
    if cfg.family == "ssm":
        assert cfg.n_layers % cfg.slstm_every == 0
        return cfg.n_layers // cfg.slstm_every
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_every == 0
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _blocks_init(gen: torch.Generator, cfg: ArchConfig, dev) -> Params:
    L = n_superblocks(cfg)
    if cfg.family == "ssm":       # xLSTM super-block
        inner = (L, cfg.slstm_every - 1)
        return {"s_ln": norm_init(cfg, L, dev),
                "slstm": slstm_init(gen, cfg, (L,)),
                "m_ln": norm_init(cfg, inner, dev),
                "mlstm": mlstm_init(gen, cfg, inner)}
    if cfg.family == "hybrid":    # Zamba2 super-block (shared attn outside)
        inner = (L, cfg.attn_every)
        return {"m_ln": norm_init(cfg, inner, dev),
                "mamba": mamba2_init(gen, cfg, inner)}
    blocks = {"ln1": norm_init(cfg, L, dev), "attn": attn_init(gen, cfg, L),
              "ln2": norm_init(cfg, L, dev)}
    if cfg.family == "moe":
        blocks["moe"] = moe_init(gen, cfg, L)
    else:
        blocks["mlp"] = mlp_init(gen, cfg, L)
    return blocks


class _MetaGenerator(torch.Generator):
    """A CPU generator that names ``meta`` as its device: the inits draw
    on ``generator.device``, and meta has no generator of its own (a
    draw on meta takes any generator and consumes nothing)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None) -> Params:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (CUDA unless ``device="cpu"``); linears in
    ``cfg.linear_mode``.  ``device="meta"`` gives the tree's shapes and
    dtypes with nothing allocated (:mod:`repro_torch.launch.specs`)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = (_MetaGenerator(device="cpu") if dev.type == "meta"
           else torch.Generator(device=dev)).manual_seed(int(seed))
    dt = _dtype(cfg)
    params: Params = {
        "embed": {"w": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                    device=dev) * 0.02).to(dt)},
        "blocks": _blocks_init(gen, cfg, dev),
        "final_norm": norm_init(cfg, 0, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": (torch.randn((cfg.d_model, cfg.vocab),
                                            generator=gen, device=dev)
                                * 0.02).to(dt)}
    if cfg.family == "hybrid" and cfg.attn_every:
        params["shared_attn"] = {
            "ln": norm_init(cfg, 0, dev), "attn": attn_init(gen, cfg, 0),
            "ln2": norm_init(cfg, 0, dev), "mlp": mlp_init(gen, cfg, 0)}
    if cfg.frontend:  # stub modality frontend: a single projection
        params["frontend_proj"] = {"w": (torch.randn(
            (cfg.d_model, cfg.d_model), generator=gen, device=dev)
            * 0.02).to(dt)}
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               kv_cache: str = "float", *, device=None) -> Dict:
    """Stacked decode cache (leading axis = layer, or super-block).

    The attention KV container ``kv_cache``: ``"float"`` stores
    activations, ``"int4"`` int8 codes + per-row scales, ``"int4x2"`` the
    same codes packed two per byte + the scales.  The SSM family's cache is
    ``{"slstm": {h, c, n}, "mlstm": {S, n}}``, the hybrid's ``{"attn":
    <the KV container>, "mamba": {S, conv}}``: recurrent states in f32, O(1)
    a slot, not per token.  An encoder has none."""
    _check_decode(cfg)
    dev = resolve_device(device)
    L = n_superblocks(cfg)
    if cfg.family == "ssm":
        return {"slstm": slstm_cache_init(cfg, batch, (L,), dev),
                "mlstm": mlstm_cache_init(cfg, batch,
                                          (L, cfg.slstm_every - 1), dev)}
    attn = attn_cache_init(cfg, batch, max_len, kv_cache=kv_cache, layers=L,
                           device=dev)
    if cfg.family == "hybrid":
        return {"attn": attn,
                "mamba": mamba2_cache_init(cfg, batch, (L, cfg.attn_every),
                                           dev)}
    return attn


def cache_batch_axes(cfg: ArchConfig, kv_cache: str = "float") -> Dict:
    """Per-leaf batch (serving slot) axis of :func:`init_cache`'s leaves, in
    its structure: attention and sLSTM leaves stack as (L, B, ...), axis 1;
    the inner-stacked mLSTM and Mamba2 leaves as (L, n_inner, B, ...), axis
    2.  The engine splices slots through this spec, never by guessing the
    axis from a size (a stacked axis may equal the slot count)."""
    _check_decode(cfg)
    meta = init_cache(cfg, 1, 1, kv_cache=kv_cache, device="meta")
    if cfg.family == "ssm":
        return {"slstm": tree_map(lambda _: 1, meta["slstm"]),
                "mlstm": tree_map(lambda _: 2, meta["mlstm"])}
    if cfg.family == "hybrid":
        return {"attn": tree_map(lambda _: 1, meta["attn"]),
                "mamba": tree_map(lambda _: 2, meta["mamba"])}
    return tree_map(lambda _: 1, meta)


def _tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (views).  A placed leaf whose layer
    axis is sharded (a stacked vector under a row-parallel rule: the
    reference's spec of ``wo``'s scales) is gathered along it first."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    if sharded.is_dtensor(tree):
        tree = sharded.unshard_dim(tree, 0)
    return tree[i]


def _embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding rows ``w[tokens]``; a placed (vocab-sharded) table
    looks up each rank's vocab range (:func:`repro_torch.core.sharded.
    embed`)."""
    if sharded.is_dtensor(w):
        return sharded.embed(w, tokens)
    return w[tokens.to(torch.int64)]


def _positions(h: torch.Tensor, start=None) -> torch.Tensor:
    """(B, T) positions of h's rows: ``start[:, None] + arange(T)`` (``start``
    (B,) or None for 0), placed like h's leading dims when h is a
    DTensor."""
    def make(h_, s_):
        B, T = h_.shape[:2]
        pos = torch.arange(T, device=h_.device)[None].expand(B, T)
        return pos if s_ is None else s_[:, None] + pos.to(s_.dtype)

    if sharded.is_dtensor(h):
        return sharded.local_apply(make, list(h.placements), h, start)
    return make(h, start)


def _ffn(p, cfg, h, patterns, dispatch):
    """The block's second half: the MoE layer or the MLP, on ln2(h)."""
    x = norm_apply(cfg, p["ln2"], h)
    if cfg.family == "moe":
        return moe_apply(p["moe"], cfg, x, patterns, dispatch)
    return mlp_apply(p["mlp"], cfg, x, patterns=patterns, dispatch=dispatch)


def _dense_block(p, cfg, h, positions, cache, patterns, dispatch, n_valid,
                 t_bound, bt, packed_read):
    a, _ = attn_apply(p["attn"], cfg, norm_apply(cfg, p["ln1"], h), positions,
                      cache, patterns, dispatch, n_valid=n_valid,
                      t_bound=t_bound, bt=bt, packed_read=packed_read)
    h = h + a
    return h + _ffn(p, cfg, h, patterns, dispatch)


def _head(params: Params, cfg: ArchConfig, h: torch.Tensor, patterns,
          dispatch) -> torch.Tensor:
    h = norm_apply(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        w = params["embed"]["w"]
        if sharded.is_dtensor(w):
            return sharded.tied_head(h, w)
        return h @ w.T.to(h.dtype)
    return linear_apply(params["head"], h, pattern=(patterns or {}).get(
        (cfg.d_model, cfg.vocab)), dispatch=dispatch, leaf="head")


def embed_inputs(params: Params, cfg: ArchConfig, batch: Dict, *,
                 dispatch=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token / stub-frontend embedding: returns (h, positions).

    ``frontend="frame"`` (audio encoder): ``batch["frame_embeds"]`` (B, T,
    D) through ``frontend_proj``.  Otherwise ``batch["tokens"]`` (B, T) are
    looked up; with ``frontend="patch"`` (VLM), ``batch["prefix_embeds"]``
    (B, P, D) go through ``frontend_proj`` and are prepended.  Positions
    count from 0 over the whole sequence."""
    _check_family(cfg)
    if cfg.frontend == "frame":
        h = batch["frame_embeds"].to(_dtype(cfg))
        h = linear_apply(params["frontend_proj"], h, dispatch=dispatch,
                         leaf="frontend_proj")
    else:
        h = _embed(params["embed"]["w"], batch["tokens"])
        if cfg.frontend == "patch" and "prefix_embeds" in batch:
            pre = batch["prefix_embeds"].to(h.dtype)
            pre = linear_apply(params["frontend_proj"], pre,
                               dispatch=dispatch, leaf="frontend_proj")
            h = torch.cat([pre, h], dim=1)
    return h, _positions(h)


def _full_block(p, cfg, h, positions, patterns, dispatch):
    a, _ = attn_apply(p["attn"], cfg, norm_apply(cfg, p["ln1"], h), positions,
                      None, patterns, dispatch)
    h = h + a
    return h + _ffn(p, cfg, h, patterns, dispatch)


def _ssm_superblock(p, cfg, h, cache, dispatch):
    """xLSTM super-block: 1 sLSTM + (slstm_every - 1) mLSTM, pre-norm
    residual; ``cache`` (the super-block's state views, updated in place)
    or None for the full sequence."""
    y, _ = slstm_apply(p["slstm"], cfg, norm_apply(cfg, p["s_ln"], h),
                       cache["slstm"] if cache else None, dispatch)
    h = h + y.to(h.dtype)
    for j in range(cfg.slstm_every - 1):
        y, _ = mlstm_apply(_tree_index(p["mlstm"], j), cfg,
                           norm_apply(cfg, _tree_index(p["m_ln"], j), h),
                           _tree_index(cache["mlstm"], j) if cache else None,
                           dispatch)
        h = h + y.to(h.dtype)
    return h


def _hybrid_superblock(p, shared, cfg, h, positions, cache, patterns,
                       dispatch, t_bound=None, bt=None, packed_read="fused"):
    """Zamba2 super-block: the tied shared attention + MLP (compiled leaves
    read ``patterns``), then attn_every Mamba2 blocks; ``cache`` as in
    :func:`_ssm_superblock`, its ``attn`` part the super-block's KV
    cache."""
    a, _ = attn_apply(shared["attn"], cfg, norm_apply(cfg, shared["ln"], h),
                      positions, cache["attn"] if cache else None, patterns,
                      dispatch, t_bound=t_bound, bt=bt,
                      packed_read=packed_read)
    h = h + a
    h = h + mlp_apply(shared["mlp"], cfg, norm_apply(cfg, shared["ln2"], h),
                      patterns=patterns, dispatch=dispatch)
    for j in range(cfg.attn_every):
        y, _ = mamba2_apply(_tree_index(p["mamba"], j), cfg,
                            norm_apply(cfg, _tree_index(p["m_ln"], j), h),
                            _tree_index(cache["mamba"], j) if cache else None,
                            dispatch)
        h = h + y.to(h.dtype)
    return h


def _block(p_layer, params, cfg, h, positions, cache, patterns, dispatch,
           n_valid=None, t_bound=None, bt=None, packed_read="fused"):
    """One layer (super-block) of any family; ``cache`` None for the full
    sequence."""
    if cfg.family == "ssm":
        return _ssm_superblock(p_layer, cfg, h, cache, dispatch)
    if cfg.family == "hybrid":
        return _hybrid_superblock(p_layer, params["shared_attn"], cfg, h,
                                  positions, cache, patterns, dispatch,
                                  t_bound, bt, packed_read)
    if cache is None:
        return _full_block(p_layer, cfg, h, positions, patterns, dispatch)
    return _dense_block(p_layer, cfg, h, positions, cache, patterns,
                        dispatch, n_valid, t_bound, bt, packed_read)


def forward(params: Params, cfg: ArchConfig, batch: Dict, *, patterns=None,
            dispatch=None) -> torch.Tensor:
    """Full-sequence forward (train / prefill): logits (B, T, V).

    Attention runs through the flash op on the card (its backward
    recomputes ``chunked_attention``); the SSM blocks run their chunkwise
    forms (the sLSTM a loop over T).  With ``cfg.remat`` and autograd on,
    each layer runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, as ``jax.checkpoint`` does
    in the reference.  ``patterns`` / ``dispatch`` as in
    :func:`decode_step`, for compiled parameter trees.

    Placed (DTensor) parameters and batch (:mod:`repro_torch.launch.
    sharding`) run the same forward on each rank's shards; with
    ``cfg.seq_shard`` every layer's input and output are sequence-sharded
    over ``model`` (:func:`repro_torch.models.shard_hints.seq_shard_hint`).
    """
    h, positions = embed_inputs(params, cfg, batch, dispatch=dispatch)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n_superblocks(cfg)):
        p_layer = _tree_index(params["blocks"], i)
        h = seq_shard_hint(h, cfg.seq_shard)
        if remat:
            h = checkpoint(_block, p_layer, params, cfg, h, positions, None,
                           patterns, dispatch, use_reentrant=False)
        else:
            h = _block(p_layer, params, cfg, h, positions, None, patterns,
                       dispatch)
        h = seq_shard_hint(h, cfg.seq_shard)
    return _head(params, cfg, h, patterns, dispatch)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict, *,
            dispatch=None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["labels"] >= 0``, from f32
    logits by logsumexp (no (B, T, V) log-prob tensor).  A VLM's prefix
    positions carry no label: their logits are dropped."""
    logits = forward(params, cfg, batch, dispatch=dispatch).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    if cfg.frontend == "patch" and "prefix_embeds" in batch:
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
    if sharded.is_dtensor(logits):
        return sharded.cross_entropy(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return -((picked - lse) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _run(params, cfg, cache, tokens, positions, patterns, dispatch, n_valid,
         t_bound, bt, packed_read):
    h = _embed(params["embed"]["w"], tokens)
    for i in range(n_superblocks(cfg)):
        h = _block(_tree_index(params["blocks"], i), params, cfg, h,
                   positions, _tree_index(cache, i), patterns, dispatch,
                   n_valid, t_bound, bt, packed_read)
    return _head(params, cfg, h, patterns, dispatch), cache


def decode_step(params: Params, cfg: ArchConfig, cache: Dict,
                tokens: torch.Tensor, *, patterns=None, dispatch=None,
                active: Optional[torch.Tensor] = None,
                t_bound: Optional[int] = None,
                bt: Optional[int] = None,
                packed_read: str = "fused") -> Tuple[torch.Tensor, Any]:
    """One token per sequence: tokens (B, 1) -> logits (B, 1, V).

    The cache is updated IN PLACE and returned.  ``active`` is an optional
    (B,) 0/1 mask: an inactive slot writes a garbage row past its
    (unadvanced) length.  ``t_bound`` bounds the cache-read extent, ``bt``
    pins the packed read's kv tile rows and ``packed_read`` picks the
    quantised caches' read ("fused" or "unpack", see
    :func:`repro_torch.models.blocks.attn_apply`); ``patterns`` is the
    compile pass's side-table and ``dispatch`` the kernel mode.

    MoE refuses ``active``: a masked slot's garbage row still competes for
    expert capacity and could displace a live token's routing.  The SSM and
    hybrid families refuse it too: their recurrent state advances on every
    step.  Their positions are implicit in the state (ssm) or the shared
    attention's cache lengths (hybrid).
    """
    _check_decode(cfg)
    if active is not None and cfg.family in RECURRENT_FAMILIES:
        raise ValueError(
            f"decode_step active= mask is attention-only — the {cfg.family} "
            "family's recurrent state advances on every step and cannot "
            "mask a slot out")
    if active is not None and cfg.family == "moe":
        raise ValueError(
            "decode_step active= mask is unsupported for moe — a masked "
            "garbage row still competes for expert capacity and can "
            "displace live tokens' routing")
    if cfg.family == "ssm":
        positions = None
    else:
        length = cache["attn"]["length"] if cfg.family == "hybrid" \
            else cache["length"]
        positions = _positions(tokens, length[0])
    nv = None if active is None else active.to(torch.int32)
    return _run(params, cfg, cache, tokens, positions, patterns, dispatch, nv,
                t_bound, bt, packed_read)


def prefill_step(params: Params, cfg: ArchConfig, cache: Dict,
                 tokens: torch.Tensor, *, patterns=None, dispatch=None,
                 n_valid: Optional[torch.Tensor] = None,
                 t_bound: Optional[int] = None,
                 bt: Optional[int] = None,
                 packed_read: str = "fused") -> Tuple[torch.Tensor, Any]:
    """One prompt chunk per sequence: tokens (B, C) -> logits (B, C, V).

    Each layer quantise-packs the chunk's K/V and writes it at the slot's
    length, IN PLACE; row ``c`` attends to ``length + c + 1`` positions.
    ``n_valid`` (B,) counts the real rows of a ragged final chunk; the
    final real row's logits give the first generated token.  Other
    arguments as :func:`decode_step`.

    Only the attention-only families (dense, VLM) chunk: a MoE chunk would
    change the router's static capacity (a function of the token count).
    """
    _check_decode(cfg)
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(
            f"prefill_step supports the attention-only families "
            f"('dense', 'vlm'), not {cfg.family!r} — serve other families "
            "through per-token decode_step")
    positions = _positions(tokens, cache["length"][0])
    nv = None if n_valid is None else n_valid.to(torch.int32)
    return _run(params, cfg, cache, tokens, positions, patterns, dispatch, nv,
                t_bound, bt, packed_read)
