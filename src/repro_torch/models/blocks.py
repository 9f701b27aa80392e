"""Transformer blocks: GQA attention over a float, int4 or bit-packed
int4x2 KV cache, the MLP, the MoE layer — every linear through the
compressed-linear dispatch — and the conv-bearing patch-embedding hook.

Linears are initialised by :func:`lin_init` in the config's
``linear_mode`` (any family's init mode; the sparse modes share one
pattern per (K, N) shape, :func:`_pattern`)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import payload_registry, sharded
from ..core.dispatch import (
    ConvPayload,
    attn_full_dispatch,
    attn_packed_dispatch,
    conv_dispatch,
)
from ..core.families._util import he_init
from ..core.quant import pack_int4, unpack_int4
from ..core.sparsity import shared_pattern
from .config import ArchConfig
from .layers import (
    Params,
    apply_rope,
    attention_lse,
    decode_attention,
    layernorm,
    linear_apply,
    linear_init,
    prefill_attention,
    rmsnorm,
)
from .shard_hints import hint

# KV-cache containers of the port (attn_cache_init kv_cache=):
#   "float"  — (B, T, Hkv, Dh) activations at cfg.param_dtype
#   "int4"   — int4 codes, one per int8 byte + per-(slot, pos, head) f32
#              scales
#   "int4x2" — the same codes packed two per byte along Dh + the scales
KV_CACHE_MODES = ("float", "int4", "int4x2")
PACKED_READS = ("fused", "unpack")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def norm_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if cfg.norm == "rms" else layernorm(p, x)


def _pattern(cfg: ArchConfig, K: int, N: int):
    """The config's shared static pattern of a (K, N) linear under a sparse
    ``linear_mode``: the group count s for ``gsparse*`` (None when the
    groups would not be whole multiples of 8), a diagonal-striped
    :class:`BlockSparsePattern` for ``sparse*`` (None when the block does
    not tile the shape: the leaf falls back to dense), else None."""
    mode = cfg.linear_mode
    if mode.startswith("gsparse"):
        s = max(1, round(1.0 / max(cfg.sparse_density, 1e-6)))
        if K % s or N % s or (K // s) % 8 or (N // s) % 8:
            return None
        return s
    if not mode.startswith("sparse"):
        return None
    bk = min(cfg.sparse_block[0], K)
    bn = min(cfg.sparse_block[1], N)
    if K % bk or N % bn:
        return None
    return shared_pattern(K, N, (bk, bn), cfg.sparse_density)


def lin_init(gen: torch.Generator, cfg: ArchConfig, K: int, N: int, *,
             bias: bool = False, lead: Tuple[int, ...] = ()) -> Params:
    """One linear in ``cfg.linear_mode``, stacked over ``lead``; a sparse
    mode whose pattern does not fit the shape inits dense."""
    mode = cfg.linear_mode
    sparse = mode.startswith("sparse") or mode.startswith("gsparse")
    pat = _pattern(cfg, K, N) if sparse else None
    if sparse and pat is None:
        mode = "dense"
    return linear_init(gen, K, N, dtype=_dtype(cfg), mode=mode, bias=bias,
                       pattern=pat, lead=lead)


def lin_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, K: int, N: int,
              patterns=None, dispatch=None, leaf: Optional[str] = None):
    """``patterns`` is the compile pass's side-table ((K, N) -> static
    BlockSparsePattern), looked up for the families that need it; without
    an entry, a pattern-bound leaf takes the config's shared pattern (the
    synthetic ``linear_mode`` leaves of :func:`lin_init`)."""
    pat = None
    if payload_registry.pattern_leaf(p):
        pat = (patterns or {}).get((K, N)) or _pattern(cfg, K, N)
    return linear_apply(p, x, pattern=pat, dispatch=dispatch, leaf=leaf)


# ------------------------------------------------------------------- init


def _lead(L) -> Tuple[int, ...]:
    """Leading stack axes: an int L (0 = unstacked) or a tuple."""
    if isinstance(L, tuple):
        return L
    return (L,) if L else ()


def norm_init(cfg: ArchConfig, L, device) -> Params:
    """Norm gains (and biases) in bf16 whatever ``param_dtype`` is, as the
    reference's ``rmsnorm_init`` / ``layernorm_init`` make them; ``L`` is
    the stack (an int, 0 = unstacked, or a tuple of axes)."""
    shape = _lead(L) + (cfg.d_model,)
    p = {"g": torch.ones(shape, dtype=torch.bfloat16, device=device)}
    if cfg.norm != "rms":
        p["b"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return p


def attn_init(gen: torch.Generator, cfg: ArchConfig, L: int) -> Params:
    """Attention projections stacked over ``L`` layers (0: unstacked, the
    hybrid's shared block), in ``cfg.linear_mode``."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = _lead(L)
    return {
        "wq": lin_init(gen, cfg, D, H * Dh, bias=cfg.qkv_bias, lead=lead),
        "wk": lin_init(gen, cfg, D, Hkv * Dh, bias=cfg.qkv_bias, lead=lead),
        "wv": lin_init(gen, cfg, D, Hkv * Dh, bias=cfg.qkv_bias, lead=lead),
        "wo": lin_init(gen, cfg, H * Dh, D, lead=lead),
    }


def mlp_init(gen: torch.Generator, cfg: ArchConfig, L: int,
             d_ff: Optional[int] = None) -> Params:
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    lead = _lead(L)
    if cfg.act == "swiglu":
        return {"wg": lin_init(gen, cfg, D, F_, lead=lead),
                "wu": lin_init(gen, cfg, D, F_, lead=lead),
                "wd": lin_init(gen, cfg, F_, D, lead=lead)}
    return {"wu": lin_init(gen, cfg, D, F_, lead=lead),
            "wd": lin_init(gen, cfg, F_, D, lead=lead)}


# ----------------------------------------------------------------- attention


def _kv_quant(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(slot, pos, head) int4 quantisation of KV rows
    (B, T, Hkv, Dh): one scale per row, so an appended row never rescales
    the history."""
    uf = u.to(torch.float32)
    amax = uf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / 7.0, 1e-12)            # (B, T, Hkv)
    codes = torch.clamp(torch.round(uf / scale[..., None]), -7, 7)
    return codes.to(torch.int8), scale


def _kv_insert(cache_kv: torch.Tensor, upd: torch.Tensor,
               idx: torch.Tensor, seq: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """Write ``upd`` (B, C, ...) into ``cache_kv`` (B, T, ...) at rows
    ``idx[b] .. idx[b] + C - 1``, in place.

    The start row is clamped to ``[0, T - C]``, as ``dynamic_update_slice``
    clamps it in the reference: an idle slot whose length is T writes its
    garbage row at T - 1 instead of failing.

    ``seq = (offset, T)``: ``cache_kv`` holds rows ``offset .. offset + t - 1``
    of a sequence-sharded cache of T rows, and only the chunk rows that fall
    in that range land here (a chunk may straddle ranks).  Shape-only, with
    no data-dependent count: each chunk row's position is clamped into the
    range, and the row there is written with the chunk row that owns it, or
    with its own value where none does — so rows that clamp to one
    position all write the same value.
    """
    B, T = cache_kv.shape[:2]
    C = upd.shape[1]
    slot = torch.arange(B, device=idx.device)[:, None].expand(B, C)
    rows = torch.arange(C, device=idx.device)[None, :]
    if seq is None:
        start = torch.clamp(idx.to(torch.int64), 0, T - C)
        cache_kv[slot, start[:, None] + rows] = upd.to(cache_kv.dtype)
        return cache_kv
    off, T_all = seq
    start = torch.clamp(idx.to(torch.int64), 0, T_all - C)[:, None]
    pos = torch.clamp(start + rows - off, 0, T - 1)
    src = pos + off - start                    # the chunk row owning pos
    own = ((src >= 0) & (src < C)).reshape(B, C, *(1,) * (upd.ndim - 2))
    new = upd.to(cache_kv.dtype)[slot, torch.clamp(src, 0, C - 1)]
    cache_kv[slot, pos] = torch.where(own, new, cache_kv[slot, pos])
    return cache_kv


def _extent(arr: torch.Tensor, t_bound: Optional[int]) -> torch.Tensor:
    """The cache leaf bounded to its first ``t_bound`` positions (a view)."""
    if t_bound is not None and t_bound < arr.shape[1]:
        return arr[:, :t_bound]
    return arr


def _cache_write(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                 n_valid: Optional[torch.Tensor],
                 t_bound: Optional[int],
                 seq: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Insert a step's K/V rows (B, T, Hkv, Dh) at each slot's ``length``,
    quantise-packing them for the int4 / int4x2 containers, and advance
    ``length`` by ``n_valid``, all IN PLACE; returns the per-row read
    extents ``lengths`` (B, T).  ``seq`` = (offset, whole T): the leaves
    are one rank's range of a sequence-sharded cache (:func:`_kv_insert`);
    ``length`` and the extents stay whole."""
    B, T = k.shape[:2]
    idx = cache["length"]
    nv = torch.full((B,), T, dtype=torch.int32, device=k.device) \
        if n_valid is None else n_valid.to(torch.int32)
    row = torch.arange(T, dtype=torch.int32, device=k.device)
    # row c attends to idx + c + 1 positions; garbage rows clamp to the
    # last valid extent (>= 1, so no all-masked softmax row).  A slot whose
    # length runs past the read extent (an idle slot of the token drip,
    # which advances every step) reads the whole extent, never past it.
    T_c = seq[1] if seq is not None else \
        (cache["k"] if "k" in cache else cache["k_s"]).shape[1]
    ext = T_c if t_bound is None else min(t_bound, T_c)
    lengths = idx[:, None] + torch.minimum(row + 1, nv[:, None])
    lengths = torch.clamp(lengths, 1, ext)
    if "k" in cache:
        _kv_insert(cache["k"], k, idx, seq)
        _kv_insert(cache["v"], v, idx, seq)
    else:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        _kv_insert(cache["k_s"], ks, idx, seq)
        _kv_insert(cache["v_s"], vs, idx, seq)
        if "k_p" in cache:   # int4x2: two codes per byte along Dh
            _kv_insert(cache["k_p"], pack_int4(kq, axis=-1), idx, seq)
            _kv_insert(cache["v_p"], pack_int4(vq, axis=-1), idx, seq)
        else:                # int4: int8 container, the same codes
            _kv_insert(cache["k_q"], kq, idx, seq)
            _kv_insert(cache["v_q"], vq, idx, seq)
    idx += nv
    return lengths


def _float_read(cfg: ArchConfig, q: torch.Tensor, cache: Dict,
                lengths: torch.Tensor, t_bound: Optional[int],
                return_lse: bool = False):
    """The plain float read: the float cache bounded to ``t_bound``, or a
    quantised container decoded whole to the compute dtype (the
    reference's "unpack" baseline).  ``return_lse``: the f32 output and each
    row's log-sum-exp (:func:`repro_torch.models.layers.attention_lse`; the
    partial read of one rank's range of a sequence-sharded cache)."""
    if "k" in cache:
        kx, vx = _extent(cache["k"], t_bound), _extent(cache["v"], t_bound)
    else:
        packed = "k_p" in cache
        k_st, v_st = (cache["k_p"], cache["v_p"]) if packed \
            else (cache["k_q"], cache["v_q"])
        Dh = q.shape[-1]
        k_codes = unpack_int4(k_st, Dh, axis=-1) if packed else k_st
        v_codes = unpack_int4(v_st, Dh, axis=-1) if packed else v_st
        dt = _dtype(cfg)
        kx = (k_codes.to(torch.float32) * cache["k_s"][..., None]).to(dt)
        vx = (v_codes.to(torch.float32) * cache["v_s"][..., None]).to(dt)
    if return_lse:
        return attention_lse(q, kx, vx, lengths)
    if q.shape[1] == 1:
        return decode_attention(q, kx, vx, lengths[:, 0])
    return prefill_attention(q, kx, vx, lengths)


def _cache_attend(cfg: ArchConfig, q, k, v, cache: Dict, n_valid, t_bound,
                  bt, packed_read, dispatch):
    """Write the step's K/V into ``cache`` and read it for q.  On DTensors
    (a cache placed by ``cache_specs``) the write and the float read run on
    each rank's slots and kv heads (``local_map``); the fused read goes
    through :func:`attn_packed_dispatch`'s own DTensor leg.

    A sequence-sharded cache (T cut over ``model``, or over the data axes
    at a batch they do not divide): each rank writes the rows of its range
    (:func:`_kv_insert`), reads its range with local extents and the ranks'
    partial reads are combined by their log-sum-exps
    (:func:`repro_torch.core.sharded.seq_read`)."""
    names = sorted(cache)
    kv_leaf = cache["k"] if "k" in cache else cache["k_s"]
    seq = sharded.seq_dims(kv_leaf)
    if sharded.is_dtensor(q):
        if n_valid is not None and not sharded.is_dtensor(n_valid):
            raise ValueError("a placed cache needs a placed n_valid / active "
                             "mask")
        leaves = [cache[n] for n in names]
        rows = None
        if seq:
            _, pl, off, _ = sharded.seq_layout(kv_leaf)
            k = k.redistribute(k.device_mesh, pl)
            v = v.redistribute(v.device_mesh, pl)
            rows = (off, int(kv_leaf.shape[1]))

        def write(k_, v_, nv_, *leaves_):
            return _cache_write(dict(zip(names, leaves_)), k_, v_, nv_,
                                t_bound, rows)

        lengths = sharded.local_apply(
            write, list(cache["length"].placements), k, v, n_valid, *leaves)
    else:
        lengths = _cache_write(cache, k, v, n_valid, t_bound)
    if seq and ("k" in cache or packed_read == "unpack"):
        rest = [n for n in names if n != "length"]
        return sharded.seq_read(
            q, lengths, [cache[n] for n in rest],
            lambda q_, ext, *leaves_: _float_read(
                cfg, q_, dict(zip(rest, leaves_)), ext, None,
                return_lse=True))
    if "k" in cache or packed_read == "unpack":
        if not sharded.is_dtensor(q):
            return _float_read(cfg, q, cache, lengths, t_bound)
        return sharded.local_apply(
            lambda q_, l_, *leaves_: _float_read(
                cfg, q_, dict(zip(names, leaves_)), l_, t_bound),
            list(q.placements), q, lengths, *[cache[n] for n in names])
    packed = "k_p" in cache
    k_st, v_st = (cache["k_p"], cache["v_p"]) if packed \
        else (cache["k_q"], cache["v_q"])
    # a sequence-sharded cache is read whole on each rank's range: its
    # extents, not t_bound, bound the read
    bound = None if seq else t_bound
    return attn_packed_dispatch(
        q, _extent(k_st, bound), _extent(v_st, bound),
        _extent(cache["k_s"], bound), _extent(cache["v_s"], bound),
        lengths, packed=packed, dispatch=dispatch, bt=bt, leaf="attn.kv")


def _heads(t: torch.Tensor, H: int, Dh: int) -> torch.Tensor:
    if sharded.is_dtensor(t):
        return sharded.split_heads(t, H, Dh)
    return t.reshape(*t.shape[:2], H, Dh)


def _flat_heads(t: torch.Tensor) -> torch.Tensor:
    if sharded.is_dtensor(t):
        return sharded.merge_heads(t)
    return t.reshape(*t.shape[:2], -1)


def attn_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,                 # (B, T, D)
    positions: torch.Tensor,         # (B, T)
    cache: Optional[Dict] = None,
    patterns=None,
    dispatch=None,
    *,
    n_valid: Optional[torch.Tensor] = None,  # (B,) valid rows of the T axis
    t_bound: Optional[int] = None,   # cache-read extent (axis 1)
    bt: Optional[int] = None,        # packed-read kv tile rows
    packed_read: str = "fused",      # quantised read: "fused" | "unpack"
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention over the full sequence (``cache=None``) or a cache.

    Without a cache (training and prefill forward) q, k and v of all T
    positions go through :func:`attn_full_dispatch` — the flash kernel
    forward on the card — and the returned cache is None.  With
    ``cfg.seq_shard`` on placed (DTensor) activations, q is sequence-sharded
    over ``model`` and k, v replicated there (context parallelism), as the
    reference hints them; on plain tensors the hints do nothing.

    With a cache, T == 1 is a decode row and T > 1 a prefill chunk.  Both
    insert their K/V at each slot's ``length`` and attend with a per-row
    causal extent.  The cache is updated IN PLACE (rows, scales and
    ``length``) and returned.  ``n_valid`` marks how many of the T rows are
    real; the rest write garbage rows past the new length, masked on every
    later read or overwritten by the next real write.

    The container is read off the cache's keys: ``k``/``v`` (float),
    ``k_q``/``v_q`` (int4, int8 codes) or ``k_p``/``v_p`` (int4x2).  The
    quantised containers hold the same codes and scales.  ``packed_read``
    picks their read: ``"fused"`` attends straight from codes x scales
    (:func:`attn_packed_dispatch`), ``"unpack"`` decodes the whole
    container to the compute dtype and runs the plain float read.
    """
    D = x.shape[-1]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(lin_apply(cfg, p["wq"], x, D, H * Dh, patterns, dispatch,
                         "attn/wq"), H, Dh)
    k = _heads(lin_apply(cfg, p["wk"], x, D, Hkv * Dh, patterns, dispatch,
                         "attn/wk"), Hkv, Dh)
    v = _heads(lin_apply(cfg, p["wv"], x, D, Hkv * Dh, patterns, dispatch,
                         "attn/wv"), Hkv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        if cfg.seq_shard:
            # context parallelism: q sharded over T on 'model'; kv (small
            # under GQA) replicated
            q = hint(q, (None, "model", None, None))
            k = hint(k, (None, None, None, None))
            v = hint(v, (None, None, None, None))
        o = attn_full_dispatch(q, k, v, causal=cfg.causal, dispatch=dispatch,
                               leaf="attn.full")
        return lin_apply(cfg, p["wo"], _flat_heads(o), H * Dh, D, patterns,
                         dispatch, "attn/wo"), None
    if packed_read not in PACKED_READS:
        raise ValueError(
            f"unknown packed_read {packed_read!r} — 'fused' (tiled "
            "nibble-decode read) or 'unpack' (full-container decode "
            "baseline)")
    o = _cache_attend(cfg, q, k, v, cache, n_valid, t_bound, bt, packed_read,
                      dispatch)
    return lin_apply(cfg, p["wo"], _flat_heads(o), H * Dh, D, patterns,
                     dispatch, "attn/wo"), cache


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int,
                    kv_cache: str = "float", *, layers: int = 0,
                    device=None) -> Dict:
    """Decode KV cache in one of :data:`KV_CACHE_MODES`; ``layers`` > 0
    adds a leading layer axis to every leaf."""
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    lead = (layers,) if layers else ()
    z = lambda *shape, dtype: torch.zeros(lead + shape, dtype=dtype,
                                          device=device)
    length = z(batch, dtype=torch.int32)
    if kv_cache in (None, "float"):
        return {"k": z(batch, max_len, Hkv, Dh, dtype=_dtype(cfg)),
                "v": z(batch, max_len, Hkv, Dh, dtype=_dtype(cfg)),
                "length": length}
    if kv_cache not in KV_CACHE_MODES:
        raise ValueError(
            f"unknown kv_cache container {kv_cache!r} — valid: "
            f"{KV_CACHE_MODES}")
    scales = {"k_s": z(batch, max_len, Hkv, dtype=torch.float32),
              "v_s": z(batch, max_len, Hkv, dtype=torch.float32)}
    if kv_cache == "int4":
        return {"k_q": z(batch, max_len, Hkv, Dh, dtype=torch.int8),
                "v_q": z(batch, max_len, Hkv, Dh, dtype=torch.int8),
                **scales, "length": length}
    return {  # int4x2: two codes per uint8 byte along Dh
        "k_p": z(batch, max_len, Hkv, (Dh + 1) // 2, dtype=torch.uint8),
        "v_p": z(batch, max_len, Hkv, (Dh + 1) // 2, dtype=torch.uint8),
        **scales, "length": length}


# ----------------------------------------------------------------------- mlp


def mlp_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, patterns=None,
              dispatch=None, *, d_ff: Optional[int] = None,
              name: str = "mlp") -> torch.Tensor:
    """``d_ff`` overrides the config's width (the MoE shared expert);
    ``name`` prefixes the leaf names the dispatch reports."""
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    if "wg" in p:
        g = F.silu(lin_apply(cfg, p["wg"], x, D, F_, patterns, dispatch,
                             f"{name}/wg").to(torch.float32))
        u = lin_apply(cfg, p["wu"], x, D, F_, patterns, dispatch,
                      f"{name}/wu").to(torch.float32)
        return lin_apply(cfg, p["wd"], (g * u).to(x.dtype), F_, D, patterns,
                         dispatch, f"{name}/wd")
    h = F.gelu(lin_apply(cfg, p["wu"], x, D, F_, patterns, dispatch,
                         f"{name}/wu").to(torch.float32), approximate="tanh")
    return lin_apply(cfg, p["wd"], h.to(x.dtype), F_, D, patterns, dispatch,
                     f"{name}/wd")


# ----------------------------------------------------------------------- moe


def moe_init(gen: torch.Generator, cfg: ArchConfig, L: int) -> Params:
    """The router (f32, He init), the routed experts' SwiGLU stacks (L, E,
    K, N) drawn normal / sqrt(K), and the shared expert (an MLP of width
    ``d_expert * n_shared_experts``) where the config has one."""
    D, Fe, E = cfg.d_model, cfg.d_expert, cfg.n_experts
    p: Params = {
        "router": {"w": he_init(gen, (L, D, E), torch.float32, D)},
        "eg": {"w": he_init(gen, (L, E, D, Fe), _dtype(cfg), D)},
        "eu": {"w": he_init(gen, (L, E, D, Fe), _dtype(cfg), D)},
        "ed": {"w": he_init(gen, (L, E, Fe, D), _dtype(cfg), Fe)},
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, L,
                               d_ff=cfg.d_expert * cfg.n_shared_experts)
    return p


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Static per-expert capacity for S tokens: ``ceil(S·K/E·cf)`` capped
    at S, and never below 8."""
    C = math.ceil(S * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, min(C, S))


def moe_route(p: Params, cfg: ArchConfig, xt: torch.Tensor, dispatch=None):
    """The routing of S tokens ``xt`` (S, D): an f32 router and softmax,
    the top-k experts with gates renormalised to sum 1, and each (token,
    choice) entry's slot in its expert's buffer of ``moe_capacity`` rows.

    Ties rank the lower expert first, as ``jax.lax.top_k`` does (a stable
    descending sort).  The entries sort by expert stably and rank within
    their expert's run (``searchsorted``, left side); an entry ranked at or
    past the capacity is dropped to slot ``E·C``.  Returns (ids (S, K),
    gates (S, K), order, keep, dest) with the last three over the sorted
    S·K entries."""
    S = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = linear_apply(p["router"], xt.to(torch.float32),
                          dispatch=dispatch, leaf="moe/router")
    gates = torch.softmax(logits, dim=-1)
    gate_s, ids_s = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, ids_k = gate_s[:, :K], ids_s[:, :K]
    gate_k = gate_k / torch.clamp_min(gate_k.sum(-1, keepdim=True), 1e-9)
    C = moe_capacity(cfg, S)
    flat_ids = ids_k.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_ids, torch.arange(E, device=xt.device, dtype=sorted_ids.dtype))
    rank = torch.arange(S * K, device=xt.device) - seg_start[sorted_ids]
    keep = rank < C
    dest = torch.where(keep, sorted_ids * C + rank,
                       torch.full_like(rank, E * C))
    return ids_k, gate_k, order, keep, dest


def _moe_routed(cfg: ArchConfig, xt: torch.Tensor, router_w, eg, eu, ed,
                dispatch=None) -> torch.Tensor:
    """The routed experts of S tokens ``xt`` (S, D), the reference's
    arithmetic: each kept entry's token row written to its own buffer row
    (the drop slot ``E·C`` takes the rest and is discarded); the experts as
    batched products, g and u in f32 and ``g·u`` cast to the activation
    dtype before ``ed``.  The K weighted outputs of a token are put back in
    (token, choice) order and summed over the choices — a fixed order, so
    the combine is deterministic on the card (a scatter-add would add them
    in whatever order its atomics land)."""
    S, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    _, gate_k, order, keep, dest = moe_route({"router": {"w": router_w}},
                                             cfg, xt, dispatch)
    C = moe_capacity(cfg, S)
    src_tok = order // K
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dest, xt[src_tok])
    eb = buf[:E * C].reshape(E, C, D)
    ebf = eb.to(torch.float32)
    g = F.silu(torch.bmm(ebf, eg.to(torch.float32)))
    u = torch.bmm(ebf, eu.to(torch.float32))
    yo = torch.bmm((g * u).to(xt.dtype), ed).reshape(E * C, D)
    gathered = torch.where(keep[:, None], yo[torch.clamp_max(dest, E * C - 1)],
                           torch.zeros((), dtype=yo.dtype, device=yo.device))
    w = gate_k.reshape(-1)[order]
    contrib = (gathered * w[:, None]).to(xt.dtype)
    y = torch.empty_like(contrib).index_copy_(0, order, contrib)
    return y.reshape(S, K, D).sum(dim=1)


def moe_slice(cfg: ArchConfig, xt: torch.Tensor, router_w, eg, eu, ed,
              lo: int, rows: int, dispatch=None):
    """One rank's part of the routed experts (the placed leg,
    :func:`repro_torch.core.sharded.moe`): the routing of all S tokens
    ``xt`` (S, D), as :func:`moe_route` gives it, and of every expert only
    the capacity rows ``[lo, lo + rows)`` (rows at or past ``C`` are zero
    rows whose outputs are never read back), run on the ``Fe`` columns of
    ``eg`` / ``eu`` / ``ed`` given (E, D, Fe') / (E, Fe', D).

    The slice's buffer is gathered, not scattered: row ``j`` of expert
    ``e`` holds the entry ranked ``lo + j`` in the expert's run of the
    stably sorted choices, so an entry is kept exactly when one process
    keeps it, on exactly one rank.  ``ed``'s product is kept in f32 (a
    ``Fe`` shard's part of it), weighted by the gates in f32 and put in
    (token, choice) order, then summed over the choices.  Returns ``(y,
    keep)``: y (S, D) f32, this slice's part of the routed output, and the
    routing's keep mask over the sorted S·K entries."""
    S, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    ids_k, gate_k, order, keep, _ = moe_route({"router": {"w": router_w}},
                                              cfg, xt, dispatch)
    C = moe_capacity(cfg, S)
    sorted_ids = ids_k.reshape(-1)[order]
    experts = torch.arange(E, device=xt.device, dtype=sorted_ids.dtype)
    start = torch.searchsorted(sorted_ids, experts)
    end = torch.searchsorted(sorted_ids, experts, right=True)
    pos = lo + torch.arange(rows, device=xt.device)
    at = start[:, None] + pos[None]                       # (E, rows)
    valid = ((pos[None] < C) & (at < end[:, None])).reshape(-1)
    entry = order[torch.where(valid, at.reshape(-1), torch.zeros_like(
        at.reshape(-1)))]                                 # token·K + choice
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    eb = torch.where(valid[:, None], xt[entry // K], zero)
    ebf = eb.reshape(E, rows, D).to(torch.float32)
    g = F.silu(torch.bmm(ebf, eg.to(torch.float32)))
    u = torch.bmm(ebf, eu.to(torch.float32))
    yo = torch.bmm((g * u).to(xt.dtype).to(torch.float32),
                   ed.to(torch.float32)).reshape(E * rows, D)
    # a zero row's output is 0: the padding adds nothing wherever it lands
    contrib = yo * gate_k.reshape(-1)[entry][:, None]
    y = torch.zeros((S * K + 1, D), dtype=torch.float32, device=xt.device)
    y.index_copy_(0, torch.where(valid, entry, torch.full_like(entry, S * K)),
                  contrib)
    return y[:S * K].reshape(S, K, D).sum(dim=1), keep


def moe_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, patterns=None,
              dispatch=None) -> torch.Tensor:
    """Sort-based top-k dispatch with static capacity (drop policy), as the
    reference's ``_moe_apply`` (:func:`_moe_routed`): every shape is
    static, so a step that routes captures into a CUDA graph.  The shared
    expert's MLP adds on top.

    A placed (DTensor) ``x`` runs the routed experts through
    :func:`repro_torch.core.sharded.moe` — every rank routes all the
    tokens and computes its own capacity rows (:func:`moe_slice`) on its
    ``Fe`` shard — and the shared expert through the linear legs: the
    one-process result."""
    B, T, D = x.shape
    w = (p["router"]["w"], p["eg"]["w"], p["eu"]["w"], p["ed"]["w"])
    if sharded.is_dtensor(x):
        y = sharded.moe(
            x, *w, capacity=lambda S: moe_capacity(cfg, S),
            whole=lambda xt, *w_: _moe_routed(cfg, xt, *w_, dispatch),
            part=lambda xt, *w_, lo, rows: moe_slice(
                cfg, xt, *w_, lo, rows, dispatch)[0])
    else:
        y = _moe_routed(cfg, x.reshape(B * T, D), *w,
                        dispatch).reshape(B, T, D)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], cfg, x, patterns, dispatch,
                          d_ff=cfg.d_expert * cfg.n_shared_experts,
                          name="moe/shared")
    return y


# --------------------------------------------------------- patch embedding


def patch_embed_apply(p, x: torch.Tensor, *, bias=None, dispatch=None,
                      activation=None, leaf=None) -> torch.Tensor:
    """Conv-bearing embedding hook (ViT/VLM patch embed, CNN stems).

    ``p`` is a compiled :class:`~repro_torch.core.dispatch.ConvPayload`
    (through :func:`conv_dispatch`: the fused conv kernels on the card) or
    a raw dense leaf ``{"w": (kh, kw, cin, cout)[, "b"]}`` (a plain
    ``F.conv2d``).  Both run the same conv: non-overlapping (kh, kw)-strided
    VALID patches, NHWC in and out; a payload compiled at another stride
    raises in ``conv_dispatch``.  ``bias`` applies on both branches (the
    raw leaf's own ``"b"`` when none is given).
    """
    if isinstance(p, ConvPayload):
        kh, kw = p.kernel[0], p.kernel[1]
        return conv_dispatch(p, x, strides=(kh, kw), padding="VALID",
                             bias=bias, activation=activation,
                             dispatch=dispatch, leaf=leaf)
    from ..kernels.sparse_matmul.kernel import apply_activation

    w = p["w"]
    kh, kw = int(w.shape[0]), int(w.shape[1])
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=(kh, kw)).permute(0, 2, 3, 1)
    b = bias if bias is not None else p.get("b")
    if b is not None:
        y = y + b
    return apply_activation(y, activation)
