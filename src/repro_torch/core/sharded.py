"""The DTensor legs of the dispatch: compiled linears, the MoE layer's
routed experts, the SSM blocks (Mamba2, mLSTM, sLSTM), attention reads,
the vocab-sharded embedding, head and loss on each rank's local shards.

A parameter placed by :mod:`repro_torch.launch.sharding` is a ``DTensor``
on a ``DeviceMesh`` whose axes carry the reference's names (``pod`` /
``data`` / ``model``).  Every function here runs the same kernel (on the
CPU its plain version) that the unsharded call runs, through
``torch.distributed.tensor.experimental.local_map`` on the local shards,
and says with its output placements what the collective has to do:

* **column-parallel** (a key leaf sharded on its last axis over ``model``):
  x replicated over ``model`` gives a ``Shard(-1)`` output;
* **row-parallel** (``wo`` / ``wd`` / ``wout``: the key leaf sharded on its
  K axis; and the block axis of a pattern-sharded ``w_blk`` / ``w_blkp``,
  whose rank-local schedule :func:`local_pattern` cuts): x's local K slice
  gives a ``Partial`` output, all-reduced; the bias and the activation are
  applied once, after the reduction, never in each rank's epilogue;
* **replicated** (no ``model`` sharding, or a ``model`` axis of one rank):
  the whole call on every rank, epilogue fused as in the unsharded call.

A KV cache whose T axis is cut over ranks (sequence-sharded) is read on
each rank's range, and the partial reads are combined by their
log-sum-exps (:func:`seq_read`, :func:`seq_combine`).

Data-parallel axes carry the batch; a weight sharded over them (FSDP) is
gathered first, and its gradient comes back as ``Partial`` over them (the
redistribution's backward reduce-scatters it).  Each local function
declares the placements of its inputs' gradients (``in_grad_placements``):
a replicated input whose local use sees only part of the output
(x of a column-parallel call, a gathered kv head) gets a ``Partial``
gradient.
"""
from __future__ import annotations

import weakref
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

__all__ = ["ColTake", "any_dtensor", "attn_full", "attn_packed",
           "col_take", "cross_entropy", "embed", "even_range", "is_dtensor",
           "linear", "linear_layout", "linear_mode", "local_apply",
           "local_pattern", "local_shard", "mamba2", "merge_heads", "mlstm",
           "model_coord", "moe", "moe_rows", "place", "regular_heads",
           "schedule_shardable", "seq_combine", "seq_dims", "seq_layout",
           "seq_read", "slstm", "split_heads", "tied_head", "unshard_dim",
           "upcast"]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def any_dtensor(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def _pl():
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Partial, Replicate, Shard


def _model_dim(mesh) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def model_coord(mesh) -> Tuple[int, int]:
    """(ranks along ``model``, this rank's coordinate there); (1, 0)
    without a ``model`` axis."""
    md = _model_dim(mesh)
    if md is None:
        return 1, 0
    return int(mesh.size(md)), int(mesh.get_local_rank(md))


def _set(placements, i: Optional[int], p) -> list:
    out = list(placements)
    if i is not None:
        out[i] = p
    return out


def _to(t, placements):
    placements = list(placements)
    if list(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def _norm_dim(p, ndim: int):
    _, _, Shard = _pl()
    if isinstance(p, Shard) and p.dim < 0:
        return Shard(p.dim + ndim)
    return p


# ------------------------------------------------------------- placement


def local_shard(t: torch.Tensor, placements, mesh_shape: Sequence[int],
                coords: Sequence[int]) -> torch.Tensor:
    """The even shard of the full tensor ``t`` that the rank at ``coords``
    holds under ``placements`` (a view): each ``Shard(d)`` mesh dim, in mesh
    order, cuts its tensor dim into ``mesh_shape[i]`` equal pieces."""
    _, _, Shard = _pl()
    for p, n, c in zip(placements, mesh_shape, coords):
        if isinstance(p, Shard) and n > 1:
            d = p.dim % t.ndim
            if t.shape[d] % n:
                raise ValueError(
                    f"dim {d} of {tuple(t.shape)} does not split {n} ways")
            step = t.shape[d] // n
            t = t.narrow(d, c * step, step)
    return t


def place(t: torch.Tensor, mesh, placements):
    """``t`` (the same full tensor on every rank, as one seed draws it) as a
    DTensor on ``mesh``: each rank keeps its own shard, cut as DTensor
    cuts (:func:`local_extent`), with no communication."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    loc = t[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    return DTensor.from_local(loc.contiguous(), mesh, list(placements),
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def local_apply(fn: Callable, out_placements, *args,
                in_grad_placements=None, out_shape=None):
    """``fn`` on the local shards of ``args`` (DTensors pass their local
    tensor, anything else passes as is), its outputs wrapped with
    ``out_placements`` — ``local_map`` with the mesh of the first DTensor
    argument.  ``in_grad_placements`` (one entry an argument, None: the
    argument's own placements) are the placements of the gradients that
    ``fn``'s backward gives the local inputs.  ``out_shape`` is the global
    shape of an output whose sharded dim the ranks need not split evenly:
    ``local_map`` takes it as the local size times the ranks, which is
    wrong where DTensor cut the input as ``torch.chunk`` does (a
    sequence-sharded T: ``ceil(T / n)`` rows a rank, the last ranks
    shorter)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    if in_grad_placements is not None:
        # a DTensor input given no gradient placements keeps its own
        in_grad_placements = tuple(
            list(a.placements) if g is None and is_dtensor(a) else g
            for a, g in zip(args, in_grad_placements))
    out = local_map(fn, out_placements=out_placements,
                    in_placements=None,
                    in_grad_placements=in_grad_placements,
                    device_mesh=mesh)(*args)
    if out_shape is None or out.shape == torch.Size(out_shape):
        return out
    shape = torch.Size(out_shape)
    return DTensor.from_local(
        out.to_local(), out.device_mesh, list(out.placements),
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def local_extent(t, dim: int) -> Tuple[int, int]:
    """``(first index, size)`` of this rank's shard of DTensor ``t`` along
    ``dim``, as DTensor cuts it: ``torch.chunk``'s ``ceil(size / n)`` a
    rank, the last ranks shorter or empty, the mesh dims nested in mesh
    order."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(offset[dim]), int(shape[dim])


def _grad_for_weight(w_placements, x_placements, md) -> list:
    """A weight's gradient placements: ``Partial`` on every non-``model``
    mesh dim where x is sharded (each rank saw part of the batch), else
    the weight's own."""
    Partial, _, Shard = _pl()
    return [p if i == md else (Partial() if isinstance(x_placements[i], Shard)
                               else p)
            for i, p in enumerate(w_placements)]


def _unshard_data(t):
    """Gather a DTensor over every mesh dim but ``model`` (FSDP)."""
    _, Replicate, _ = _pl()
    md = _model_dim(t.device_mesh)
    return _to(t, [p if i == md else Replicate()
                   for i, p in enumerate(t.placements)])


def unshard_dim(t, d: int):
    """Gather a DTensor over every mesh dim that shards its tensor dim
    ``d``."""
    _, Replicate, Shard = _pl()
    want = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim == d % t.ndim
            else p for p in t.placements]
    return _to(t, want)


class _Upcast(torch.autograd.Function):
    """``p.to(dtype)`` whose gradient is reduced to ``p``'s placements in
    ``dtype`` before it is cast back to ``p``'s dtype."""

    @staticmethod
    def forward(ctx, p, dtype):
        ctx.placements, ctx.dtype = list(p.placements), p.dtype
        return p.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return _to(g, ctx.placements).to(ctx.dtype), None


def upcast(p, dtype):
    """A placed parameter (a bf16 norm gain) cast to the compute dtype, its
    gradient summed over the ranks in that dtype (f32) and only then
    rounded to the parameter's: the one-process rounding, where casting
    each rank's partial sum first would round every part."""
    if p.dtype == dtype:
        return p
    return _Upcast.apply(p, dtype)


# ------------------------------------------------- pattern-sharded blocks

def schedule_shardable(pattern, n_shards: int) -> bool:
    """Can this shared static schedule be row-parallel partitioned n ways?

    The packed ``w_blk`` axis is ordered row-major (block-rows, then
    block-columns, from the bitmap), so splitting it into ``n_shards``
    equal contiguous chunks is a valid tensor-parallel partition exactly
    when every chunk covers a whole group of block-rows: each shard owns
    K / n input rows and its own sub-schedule, and the partial outputs are
    summed (the row-parallel contract of ``wo`` / ``wd``).  That holds iff
    the block-row count divides and each contiguous row group holds an
    equal share of the present blocks.  Anything else would split a block
    between shards or misalign the side-table against the shard-local
    packed index: those patterns stay replicated.
    """
    if n_shards <= 1:
        return True
    P = pattern.n_blocks_present
    nR = pattern.bitmap.shape[0]
    if P == 0 or P % n_shards or nR % n_shards:
        return False
    per_row = pattern.bitmap.sum(axis=1)
    groups = per_row.reshape(n_shards, nR // n_shards).sum(axis=1)
    return bool((groups == P // n_shards).all())


# pattern -> {(n, r): the rank-local pattern}; dropped with the pattern
_LOCAL: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def local_pattern(pattern, n: int, r: int):
    """Rank ``r`` of ``n``'s side-table for a pattern-sharded block leaf:
    the block-rows ``r·nR/n .. (r+1)·nR/n - 1`` of the bitmap over K / n
    input rows, whose packed blocks are chunk ``r`` of ``w_blk`` /
    ``w_blkp`` — what ``schedule_shardable`` guarantees.  Made once per
    (pattern, n, r)."""
    from .sparsity import pattern_from_bitmap

    if n == 1:
        return pattern
    per = _LOCAL.setdefault(pattern, {})
    got = per.get((n, r))
    if got is None:
        if not schedule_shardable(pattern, n):
            raise ValueError(
                f"pattern {pattern.shape} block {pattern.block} does not "
                f"partition {n} ways by block-rows: its leaf stays "
                "replicated (schedule_shardable)")
        nR = pattern.bitmap.shape[0]
        rows = pattern.bitmap[r * nR // n:(r + 1) * nR // n]
        K, N = pattern.shape
        got = per[(n, r)] = pattern_from_bitmap((K // n, N), pattern.block,
                                                rows)
    return got


# -------------------------------------------------------------- linears


def linear_mode(fam, placement, ndim: int, n: int) -> str:
    """"column" / "row" / "pattern" / "replicated": how a linear runs whose
    ``ndim``-D key leaf has ``placement`` on a ``model`` axis of ``n``
    ranks (one rank, or no ``model`` axis: pass ``n`` = 1)."""
    _, Replicate, Shard = _pl()
    p = _norm_dim(placement, ndim)
    if n == 1 or isinstance(p, Replicate):
        return "replicated"
    if isinstance(p, Shard):
        if p.dim == ndim - 1 and not fam.needs_pattern:
            return "column"
        if p.dim == 0 and ndim == 2 and not fam.needs_pattern:
            return "row"
        if p.dim == 0 and ndim == 3 and fam.needs_pattern:
            return "pattern"
    raise ValueError(
        f"{fam.name} leaf {fam.key_leaf} placed {placement} on a {ndim}-D "
        "leaf: no tensor-parallel rule runs it (column: last axis; row: K "
        "axis; pattern: the block axis)")


def linear_layout(fam, ndims: Dict[str, int], mode: str,
                  x_ndim: int) -> Dict[str, Any]:
    """The ``model``-axis placement of each operand of a linear run in
    ``mode`` (:func:`linear_mode`): ``"x"``, ``"out"`` and each leaf name of
    ``ndims`` (leaf name -> its ndim; ``"b"`` the bias).  Column-parallel:
    the key leaf's last axis and every vector (the (N,) scales and bias) are
    sharded, x replicated, the output sharded on its last axis.  Row- and
    pattern-parallel: the key leaf's first axis and x's last are sharded,
    the rest replicated, the output ``Partial``.  Replicated: all whole."""
    Partial, Replicate, Shard = _pl()
    if mode == "replicated":
        lay = {k: Replicate() for k in ndims}
        lay.update(x=Replicate(), out=Replicate())
        return lay
    if mode == "column":
        lay = {k: Shard(0) if nd == 1 else Replicate()
               for k, nd in ndims.items()}
        lay[fam.key_leaf] = Shard(ndims[fam.key_leaf] - 1)
        lay.update(x=Replicate(), out=Shard(x_ndim - 1))
        return lay
    lay = {k: Replicate() for k in ndims}
    lay[fam.key_leaf] = Shard(0)
    lay.update(x=Shard(x_ndim - 1), out=Partial())
    return lay


def linear(fam, p: Dict[str, Any], x, *, pattern, cfg, activation,
           compute_dtype, leaf: Optional[str], tag: str,
           validate: Callable):
    """One compiled linear on DTensors (see the module docstring); ``x``
    (..., K) sharded over the data axes along its leading dims."""
    from .dispatch import _epilogue

    Partial, Replicate, _ = _pl()
    if not is_dtensor(x):
        raise ValueError(
            f"{leaf or fam.name}: placed (DTensor) leaves need a DTensor "
            "input — place the batch with repro_torch.launch.sharding")
    w = p[fam.key_leaf]
    if not is_dtensor(w):
        raise ValueError(f"{leaf or fam.name}: a DTensor input needs placed "
                         "leaves")
    mesh = w.device_mesh
    md = _model_dim(mesh)
    n, r = model_coord(mesh)
    mode = linear_mode(fam, w.placements[md] if md is not None else None,
                       w.ndim, n)
    names = sorted(k for k in p if k != "b" and p[k] is not None)
    bias = p.get("b")
    lay = linear_layout(fam, {k: p[k].ndim for k in p if p[k] is not None},
                        mode, x.ndim)

    def placed(t, k):
        t = _unshard_data(t)
        return _to(t, _set(t.placements, md, lay[k]))

    leaves = {k: placed(p[k], k) if is_dtensor(p[k]) else p[k]
              for k in names}
    bias = placed(bias, "b") if is_dtensor(bias) else bias
    x = _to(x, _set(x.placements, md, lay["x"]))
    out_pl = _set(x.placements, md, lay["out"])
    x_grad = _set(x.placements, md, Partial()) if mode == "column" \
        else list(x.placements)
    pat = local_pattern(pattern, n, r) if mode == "pattern" else pattern
    fused = mode in ("column", "replicated")

    def run(x_l, b_l, *leaf_l):
        pl_ = dict(zip(names, leaf_l))
        validate(pl_, pat)
        return fam.apply(pl_, x_l, pattern=pat, cfg=cfg,
                         bias=b_l if fused else None,
                         activation=activation if fused else None,
                         compute_dtype=compute_dtype, leaf=leaf, tag=tag)

    args = [leaves[k] for k in names]
    b_arg = bias if fused else None
    grads = [x_grad, _grad_for_weight(b_arg.placements, x.placements, md)
             if is_dtensor(b_arg) else None]
    grads += [_grad_for_weight(a.placements, x.placements, md)
              if is_dtensor(a) else None for a in args]
    y = local_apply(run, out_pl, x, b_arg, *args,
                    in_grad_placements=tuple(grads))
    if fused:
        return y
    y = _to(y, _set(y.placements, md, Replicate()))    # the all-reduce
    if bias is None and activation is None:
        return y
    return _epilogue(y, bias, activation, y.dtype)


# ------------------------------------------------------ heads and rope


def split_heads(t, H: int, Dh: int):
    """(B, T, H·Dh) -> (B, T, H, Dh) on the local shard: a ``model`` shard
    of whole heads stays ``Shard(2)``; one that cuts a head is gathered
    first (GQA's kv at a ``model`` axis past its kv heads)."""
    _, Replicate, Shard = _pl()
    md = _model_dim(t.device_mesh)
    n, _ = model_coord(t.device_mesh)
    if md is not None and n > 1:
        p = _norm_dim(t.placements[md], t.ndim)
        if isinstance(p, Shard) and p.dim == 2 and H % n:
            t = _to(t, _set(t.placements, md, Replicate()))
    return local_apply(lambda a: a.reshape(*a.shape[:2], -1, Dh),
                       list(t.placements), t)


def merge_heads(t):
    """(B, T, H, Dh) -> (B, T, H·Dh) on the local shard."""
    return local_apply(lambda a: a.reshape(*a.shape[:2], -1),
                       list(t.placements), t,
                       out_shape=(*t.shape[:2], t.shape[2] * t.shape[3]))


def rope(x, positions, theta: float, fn: Callable):
    """``fn(x, positions, theta)`` (the plain RoPE) on the local shards;
    ``positions`` (B, T) placed like x's leading dims."""
    return local_apply(lambda a, p: fn(a, p, theta), list(x.placements), x,
                       positions)


# ------------------------------------------------------------------ MoE


def moe_rows(C: int, d: int, r: int) -> Tuple[int, int]:
    """``(lo, rows)``: the capacity rows ``[lo, lo + rows)`` of every
    expert that rank ``r`` of ``d`` computes, ``rows = ceil(C / d)`` (past
    ``C``: padding, never read back)."""
    rows = -(-C // d)
    return r * rows, rows


def _moe_layout(mesh, C: int, fe_cut: bool) -> Tuple[Tuple[int, ...], int,
                                                      int]:
    """How :func:`moe` splits an MoE layer's routed experts on this rank:
    ``(cut, lo, rows)``.  ``cut`` are the mesh dims of more than one rank
    (each one splits the work, so the output is ``Partial`` over them);
    the capacity is split (:func:`moe_rows`) over the ranks of the data
    axes — and of ``model`` too where the experts are not sharded along
    ``Fe`` there (``fe_cut`` False) — in mesh order."""
    md = _model_dim(mesh)
    cut = tuple(i for i in range(mesh.ndim) if int(mesh.size(i)) > 1)
    d, r = 1, 0
    for i in cut:
        if i == md and fe_cut:
            continue
        n = int(mesh.size(i))
        d, r = d * n, r * n + int(mesh.get_local_rank(i))
    return (cut,) + moe_rows(C, d, r)


def moe(x, router_w, eg, eu, ed, *, capacity: Callable, whole: Callable,
        part: Callable):
    """The routed experts of an MoE layer on DTensors: ``x`` (B, T, D)
    placed like the batch (and T over ``model`` under ``seq_shard``), the
    router (D, E), ``eg`` / ``eu`` (E, D, Fe) and ``ed`` (E, Fe, D) as the
    rules place them (``Fe`` over ``model``, D over the data axes).
    Returns the routed output placed like x, in x's dtype.

    Every rank gathers all S = B·T tokens and the router and routes them
    (``part`` runs the unplaced routing), so the capacity ``capacity(S)``
    is the global batch's and every rank sees the entries one process
    keeps.  Each rank then computes only its capacity rows of every expert
    (:func:`moe_rows`) on its ``Fe`` columns (the experts gathered over
    the data axes, FSDP): ``part(xt, router, eg, eu, ed, lo=, rows=)``
    gives its f32 part of the weighted, (token, choice)-ordered output,
    ``Partial`` over every cut mesh dim, reduced once (reduce-scatter over
    the dims that cut x, all-reduce over the rest) in f32 and only then
    cast.  No rank computes another's rows or columns.  With no cut dim
    (one rank) ``whole(xt, router, eg, eu, ed)`` — the unplaced arithmetic
    — runs on the local tensors as they are.

    Gradients: x's and the router's are ``Partial`` over the cut dims
    (each rank's gates and rows meet only its own entries), the experts'
    over the cut dims where they are replicated (the data axes: FSDP's
    reduce-scatter along D)."""
    Partial, Replicate, Shard = _pl()
    mesh = x.device_mesh
    md = _model_dim(mesh)
    B, T, D = x.shape
    S = B * T
    fe_cut = md is not None and isinstance(
        _norm_dim(eg.placements[md], eg.ndim), Shard)
    cut, lo, rows = _moe_layout(mesh, capacity(S), fe_cut)
    if not cut:
        return local_apply(
            lambda x_, *w: whole(x_.reshape(S, D), *w).reshape(B, T, D),
            list(x.placements), x, router_w, eg, eu, ed)
    rep = [Replicate()] * mesh.ndim
    part_pl = [Partial() if i in cut else Replicate()
               for i in range(mesh.ndim)]
    ws = [_unshard_data(t) if fe_cut else _to(t, rep) for t in (eg, eu, ed)]
    grads = [part_pl, part_pl] + [
        [Partial() if i in cut and isinstance(p, Replicate) else p
         for i, p in enumerate(t.placements)] for t in ws]

    def run(x_, r_, g_, u_, d_):
        return part(x_.reshape(S, D), r_, g_, u_, d_, lo=lo,
                    rows=rows).reshape(B, T, D)

    y = local_apply(run, part_pl, _to(x, rep), _to(router_w, rep), *ws,
                    in_grad_placements=tuple(grads))
    return _to(y, list(x.placements)).to(x.dtype)


# ------------------------------------------------------------ SSM blocks


def even_range(size: int, n: int, r: int) -> Tuple[int, int]:
    """``[lo, hi)``: rank ``r`` of ``n``'s part of ``size`` items, the
    even shard where ``n`` divides ``size`` (else the balanced one)."""
    return r * size // n, (r + 1) * size // n


def regular_heads(lo: int, hi: int, P: int) -> Tuple[int, int, int]:
    """``(h0, Hl, Pl)``: channels ``[lo, hi)`` of heads P wide as Hl heads
    of Pl channels from head ``h0`` — whole heads, or a part of one head
    (``Pl`` < P, starting at channel ``lo - h0·P`` of it).  A range that
    spans part of a head and more raises."""
    if lo % P == 0 and (hi - lo) % P == 0:
        return lo // P, (hi - lo) // P, P
    if lo // P == (hi - 1) // P:
        return lo // P, 1, hi - lo
    raise ValueError(f"channels [{lo}, {hi}) of heads {P} wide are neither "
                     "whole heads nor a part of one head")


def _part_grad(x_placements, md, cut: bool) -> list:
    """The gradient placements of a gathered (replicated) weight that a
    rank's part uses: ``Partial`` over ``model`` where the ranks there
    each use their own part (``cut``) and over every data dim that cuts
    the batch; else ``Replicate``."""
    Partial, Replicate, Shard = _pl()
    return [Partial() if (i == md and cut) or (
        i != md and isinstance(p, Shard)) else Replicate()
        for i, p in enumerate(x_placements)]


def _model_partial(t) -> list:
    """The gradient placements of an activation gathered over ``model``
    whose ranks there each use their own part: its own placements,
    ``Partial`` over ``model``."""
    Partial, _, _ = _pl()
    return _set(t.placements, _model_dim(t.device_mesh), Partial())


def _cut_last(t, md) -> bool:
    """Is the DTensor ``t`` sharded along its last dim over ``model``?"""
    _, _, Shard = _pl()
    p = _norm_dim(t.placements[md], t.ndim)
    return isinstance(p, Shard) and p.dim == t.ndim - 1


class ColTake(NamedTuple):
    """Rank ``r``'s columns of an N-wide last dim cut evenly over n ranks
    (:func:`col_take`), as index tensors on the device, made once:
    ``cols``, the sorted global columns it wants (taken locally where
    every rank holds all N); ``send``, the columns of its own shard that
    the ranks want, in rank order; the all-to-all's split sizes."""
    cols: torch.Tensor
    send: torch.Tensor
    send_counts: Tuple[int, ...]
    recv_counts: Tuple[int, ...]


def col_take(want: Sequence[np.ndarray], N: int, r: int, device) -> ColTake:
    """The :class:`ColTake` of rank ``r`` where each rank ``s`` of
    ``len(want)`` wants the sorted global columns ``want[s]`` of an N-wide
    last dim whose even shard ``[s·N/n, (s+1)·N/n)`` it holds."""
    n = len(want)
    w = N // n

    def inside(cols, s):
        return (cols >= s * w) & (cols < (s + 1) * w)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    sends = [want[s][inside(want[s], r)] - r * w for s in range(n)]
    return ColTake(idx(want[r]), idx(np.concatenate(sends)),
                   tuple(len(c) for c in sends),
                   tuple(int(inside(want[r], s).sum()) for s in range(n)))


def _take_cols(t: torch.Tensor, cut: bool, plan: ColTake, group):
    """This rank's columns ``plan.cols`` from the local ``t``: all N
    columns (``cut`` False), or the even shard, when each rank sends every
    other the columns it wants in one all-to-all (autograd: the backward
    sends the gradients back and adds them where a column went to several
    ranks)."""
    if not cut:
        return t.index_select(-1, plan.cols)
    import torch.distributed._functional_collectives as funcol

    buf = t.index_select(-1, plan.send).movedim(-1, 0).contiguous()
    got = funcol.all_to_all_single_autograd(
        buf, list(plan.recv_counts), list(plan.send_counts), group)
    return got.movedim(0, -1)


def _sync_part(state: torch.Tensor, dim: int, lo: int, hi: int, group):
    """A replicated state of which this rank updated ``[lo, hi)`` along
    ``dim`` (and each rank its own disjoint range): every rank's range
    summed into all, with nothing else added (exact)."""
    import torch.distributed._functional_collectives as funcol

    part = torch.zeros_like(state)
    part.narrow(dim, lo, hi - lo).copy_(state.narrow(dim, lo, hi - lo))
    state.copy_(funcol.all_reduce(part, "sum", group))


def _data_match(act, leaves, md) -> None:
    """A cache leaf must cut its batch over the data dims as the
    activations do: each rank's slots are its rows."""
    _, _, Shard = _pl()
    for t in leaves:
        for i, (a, c) in enumerate(zip(act.placements, t.placements)):
            if i != md and isinstance(a, Shard) != isinstance(c, Shard):
                raise ValueError(
                    f"a cache leaf placed {t.placements} against activations "
                    f"placed {act.placements}: the batch must shard alike")


def mamba2(zxd, conv, dt_bias, a_log, d_skip, *, cache: Optional[Dict],
           dtype, whole: Callable, layout: Callable, part: Callable):
    """A Mamba2 block between ``win`` and ``wout`` on DTensors: ``zxd`` (B,
    T, 2·di + 2N + H) is ``win``'s output (column-parallel over ``model``,
    or replicated where the rules drop the split), the batch over the data
    axes; ``conv`` (W, di + 2N), the per-head ``dt_bias`` / ``a_log`` /
    ``d_skip`` and, decoding, ``cache`` {"S": (B, H, P, N), "conv": (B, 3,
    di + 2N)} as ``cache_specs`` places them.  Returns y (B, T, di) in
    ``dtype``, ``Shard(-1)`` over ``model``: ``wout``'s row-parallel K
    slice.

    Every channel of x is its own scan given its head's dt and the shared
    B and C, so rank r of ``model``'s n computes channels ``[r·di/n,
    (r+1)·di/n)`` (whole heads — 5 of zamba2-2.7b's 80 at 16 — or part of
    one) and nothing else.  ``layout(n, r, conv_cut, decode, device)``
    (:func:`repro_torch.models.ssm.mamba_layout`) gives the rank's block:
    ``take``, the :class:`ColTake` of ``win``'s columns it needs — its z,
    its x, its heads' dt, all of B and C and, decoding, the raw xBC of its
    conv-state shard; ``conv_take``, that of the conv-state channels its
    conv reads; its channels ``c0`` / ``c1``.  One all-to-all of ``win``'s
    column shards hands them over (each rank repeats the conv and the
    ``C·Bᵀ`` products of B and C's 2N channels, which every head reads,
    and, where its channels are part of a head, that head's decay); then
    ``part(got, conv, dt_bias, a_log, d_skip, lay, conv_state=,
    conv_out=, S=, S_own=)`` (``ssm.mamba_part``) runs the unplaced
    block's arithmetic on the rank's block, updates its S in place — its
    heads' shard (``S_own``), or, where the rules replicate S (H does not
    split), its channels of the whole S, exchanged after — and writes back
    its own shard of the conv state (``conv_out``).  The conv kernel and
    the per-head vectors are gathered (their gradients ``Partial``).  With
    one rank along ``model`` the local tensors run ``whole(zxd, conv,
    dt_bias, a_log, d_skip, conv_state=, S=)`` — the unplaced
    arithmetic."""
    _, Replicate, Shard = _pl()
    mesh = zxd.device_mesh
    md = _model_dim(mesh)
    n, r = model_coord(mesh)
    rep = [Replicate()] * mesh.ndim
    small = [_to(t, rep) for t in (conv, dt_bias, a_log, d_skip)]
    c_leaves = [cache["conv"], cache["S"]] if cache is not None else []
    _data_match(zxd, c_leaves, md)
    w_grad = _part_grad(zxd.placements, md, n > 1)
    if n == 1:
        def run_whole(z_, k_, dt_, al_, ds_, *c_):
            y, new = whole(z_, k_, dt_, al_, ds_,
                           conv_state=c_[0] if c_ else None,
                           S=c_[1] if c_ else None)
            if c_:
                c_[0].copy_(new)
            return y.to(dtype)

        return local_apply(run_whole, _set(zxd.placements, md, Replicate()),
                           zxd, *small, *c_leaves,
                           in_grad_placements=(None,) + (w_grad,) * 4
                           + (None,) * len(c_leaves))
    group = mesh.get_group(md)
    cut = _cut_last(zxd, md)
    if not cut:
        zxd = _to(zxd, _set(zxd.placements, md, Replicate()))
    decode = cache is not None
    conv_cut = decode and _cut_last(cache["conv"], md)
    s_own = decode and isinstance(
        _norm_dim(cache["S"].placements[md], 4), Shard)

    def run_part(z_, k_, dt_, al_, ds_, *c_):
        lay = layout(n, r, conv_cut, decode, z_.device)
        got = _take_cols(z_, cut, lay["take"], group)
        conv_l, S_l = c_ if c_ else (None, None)
        cs = None if conv_l is None else _take_cols(
            conv_l, conv_cut, lay["conv_take"], group)
        y = part(got, k_, dt_, al_, ds_, lay, conv_state=cs, conv_out=conv_l,
                 S=S_l, S_own=s_own)
        if S_l is not None and not s_own:
            _sync_part(S_l.view(S_l.shape[0], -1, S_l.shape[-1]), 1,
                       lay["c0"], lay["c1"], group)
        return y.to(dtype)

    z_grad = list(zxd.placements) if cut else _model_partial(zxd)
    return local_apply(run_part, _set(zxd.placements, md, Shard(2)), zxd,
                       *small, *c_leaves,
                       in_grad_placements=(z_grad,) + (w_grad,) * 4
                       + (None,) * len(c_leaves))


def mlstm(q, k, v, gif, og, *, H: int, cache: Optional[Dict], dtype,
          whole: Callable, layout: Callable, state_part: Callable,
          out_part: Callable):
    """An mLSTM block between its projections on DTensors: ``q``, ``k``,
    ``v``, ``og`` (B, T, di) (column-parallel over ``model``: 256 columns
    a rank of xlstm-1.3b's 4 heads of 1024 at 16, a quarter of a head) and
    ``gif`` (B, T, 2H) as the linears give them, the batch over the data
    axes; decoding, ``cache`` {"S": (B, H, P, P), "n": (B, H, P)} as
    ``cache_specs`` places it (the key axis — dim 2 — over ``model``).
    Returns y (B, T, di) in ``dtype``, ``Shard(-1)`` over ``model``: the
    out gate applied, ``wo``'s row-parallel K slice.

    The heads do not split over 16 ranks, but the key features do, as the
    cache does: rank r of n owns key features ``[p0, p1) = [r·P/n,
    (r+1)·P/n)`` of every head.  ``layout(n, r, device)``
    (:func:`repro_torch.models.ssm.mlstm_layout`) gives them, ``take``,
    the :class:`ColTake` of those q / k columns, and the rank's output
    columns ``[c0, c1)`` from head ``h0`` (``cols_cut``; all of them where
    n does not divide di).  One all-to-all each moves q's and k's column
    shards to the key columns; v and the gates are gathered.
    ``state_part`` (:func:`repro_torch.models.ssm.mlstm_state_part`) then
    computes, on the rank's key slice, the partial scores ``q·kᵀ`` of
    every chunk and the partial inter-chunk terms ``qd @ S`` and ``qd ·
    n``, and runs the chunk state ``S`` — its own key rows — from its k
    and the whole v (decoding, the cache's shard updated in place).  The
    partial sums are reduced in f32: the scores and ``qd · n``
    all-reduced, ``qd @ S`` reduce-scattered to each rank's columns.
    ``out_part`` (``mlstm_out_part``) gives the rank's columns: the
    decayed scores against its columns of v (its shard), plus the inter
    terms, normalised and gated by its ``og`` shard.  No rank computes
    another's scores, state or output columns; each repeats only the
    gates' decay and, where its columns are part of a head (more ranks
    than heads), that head's intra-chunk normaliser.  Where the rules
    replicate S (P does not split), each rank updates its key rows of the
    whole state and the rows are exchanged after.  With one rank along
    ``model``, ``whole(q, k, v, gif, og, S=, n=)`` — the unplaced
    arithmetic — runs on the local tensors."""
    Partial, Replicate, Shard = _pl()
    mesh = q.device_mesh
    md = _model_dim(mesh)
    n_m, r = model_coord(mesh)
    di = int(q.shape[-1])
    P = di // H
    c_leaves = [cache["S"], cache["n"]] if cache is not None else []
    _data_match(q, c_leaves, md)
    act = list(q.placements)
    if n_m == 1:
        def run(q_, k_, v_, g_, o_, *c_):
            return whole(q_, k_, v_, g_, o_,
                         S=c_[0] if c_ else None,
                         n=c_[1] if c_ else None).to(dtype)

        return local_apply(run, _set(act, md, Replicate()), q, k, v, gif,
                           og, *c_leaves)
    group = mesh.get_group(md)
    lay = layout(n_m, r, q.device)
    rep_m = lambda t: _to(t, _set(t.placements, md, Replicate()))  # noqa
    cuts = [_cut_last(t, md) for t in (q, k)]
    q, k = (t if c else rep_m(t) for t, c in zip((q, k), cuts))
    v_all, g_all = rep_m(v), rep_m(gif)
    p0, p1 = lay["p0"], lay["p1"]
    s_cut = cache is not None and isinstance(
        _norm_dim(cache["S"].placements[md], 4), Shard)
    part_pl = _set(act, md, Partial())

    def state(q_, k_, v_, g_, *c_):
        qr = _take_cols(q_, cuts[0], lay["take"], group)
        kr = _take_cols(k_, cuts[1], lay["take"], group)
        if not c_:
            return state_part(qr, kr, v_, g_, H, P)
        S_l, n_l = c_
        S, n = (S_l, n_l) if s_cut else (S_l[:, :, p0:p1], n_l[:, :, p0:p1])
        _, inter, innr = state_part(qr, kr, v_, g_, H, P, S, n)
        if not s_cut:
            _sync_part(S_l, 2, p0, p1, group)
            _sync_part(n_l, 2, p0, p1, group)
        return inter, innr

    grads = tuple(list(t.placements) if c else _model_partial(t)
                  for t, c in zip((q, k), cuts)) + (
        _model_partial(v_all), _model_partial(g_all)) + (None,) * len(
            c_leaves)
    outs = local_apply(state, (part_pl,) * (2 if cache is not None else 3),
                       q, k, v_all, g_all, *c_leaves,
                       in_grad_placements=grads)
    scores = None if cache is not None else outs[0]
    inter, innr = outs[-2:]
    cols = Shard(2) if lay["cols_cut"] else Replicate()
    inter = _to(inter, _set(act, md, cols))
    innr = _to(innr, _set(act, md, Replicate()))
    v_c, og_c = (_to(t, _set(t.placements, md, cols)) for t in (v, og))
    # the whole operands of the columns' part: each rank reads its own
    # heads of them where the columns split
    whole_grad = _set(act, md, Partial() if isinstance(cols, Shard)
                      else Replicate())
    if scores is not None:
        scores = _to(scores, _set(act, md, Replicate()))

    def out(inter_, innr_, v_, g_, o_, *s_):
        return out_part(s_[0] if s_ else None, inter_, innr_, v_, g_, o_,
                        lay["h0"], P).to(dtype)

    c_pl = _set(act, md, cols)
    extra = [scores] if scores is not None else []
    return local_apply(out, c_pl, inter, innr, v_c, g_all, og_c, *extra,
                       in_grad_placements=(c_pl, whole_grad, c_pl,
                                           whole_grad, c_pl)
                       + (whole_grad,) * len(extra))


def slstm(xw, r, b, *, cache: Optional[Dict], dtype, run: Callable):
    """An sLSTM block after its input projection on DTensors: ``xw`` (B, T,
    4D) placed like the batch (the rules replicate the sLSTM over
    ``model``: ``wx`` runs replicated), the recurrent weights ``r`` and
    bias ``b`` as placed (FSDP over the data axes) and, decoding, ``cache``
    {"h", "c", "n"} (B, D) placed like the batch.  Returns the h states (B,
    T, D) in ``dtype``, placed like ``xw``.

    The recurrence is sequential in T and its state is small, so nothing
    splits over ``model``: every rank gathers ``r`` and ``b`` and runs the
    whole step loop, ``run(xw, r, b, cache)``
    (:func:`repro_torch.models.ssm._slstm_run`), on its local batch rows in
    one local function (no DTensor dispatch a step), the cache's local
    rows updated in place.  So x's gradient over ``model`` is
    ``Replicate``: every model rank computes the same whole gradient."""
    _, Replicate, _ = _pl()
    mesh = xw.device_mesh
    md = _model_dim(mesh)
    rep = [Replicate()] * mesh.ndim
    xw = _to(xw, _set(xw.placements, md, Replicate()))
    r, b = _to(r, rep), _to(b, rep)
    names = ("h", "c", "n")
    c_leaves = [cache[k] for k in names] if cache is not None else []
    _data_match(xw, c_leaves, md)
    w_grad = _part_grad(xw.placements, md, False)

    def fn(xw_, r_, b_, *c_):
        return run(xw_, r_, b_, dict(zip(names, c_)) if c_ else None).to(
            dtype)

    return local_apply(fn, list(xw.placements), xw, r, b, *c_leaves,
                       in_grad_placements=(list(xw.placements), w_grad,
                                           w_grad) + (None,) * len(c_leaves))


# ------------------------------------------------------------ attention


def _kv_for_heads(q, k, v):
    """k, v laid out for q's local heads: local kv heads when the ``model``
    axis shards both evenly (a q head block stays with its kv heads), else
    gathered over ``model``; returns (k, v, kv_local) where ``kv_local``
    False means each rank slices its q heads' kv heads."""
    _, Replicate, Shard = _pl()
    md = _model_dim(q.device_mesh)
    n, _ = model_coord(q.device_mesh)
    qp = _norm_dim(q.placements[md], 4) if md is not None else Replicate()
    Hkv = k.shape[2]
    want = list(q.placements)
    if isinstance(qp, Shard) and qp.dim == 2 and Hkv % n == 0:
        return _to(k, want), _to(v, want), True
    want = _set(want, md, Replicate())
    return _to(k, want), _to(v, want), False


def _q_heads_kv(H: int, Hkv: int, n: int, r: int) -> Tuple[int, int]:
    """The kv heads [lo, hi) that rank r's q heads read when kv is
    gathered (q heads h -> kv head h // G, G = H / Hkv)."""
    G = H // Hkv
    Hl = H // n
    if Hl % G and G % Hl:
        raise ValueError(
            f"{H} q heads over {Hkv} kv heads do not split {n} ways into "
            "whole kv groups")
    lo = r * Hl // G
    return lo, lo + max(1, Hl // G)


def attn_full(q, k, v, *, causal: bool, run: Callable):
    """Full-sequence attention on DTensors: ``run(q, k, v, q_offset)`` (the
    flash op on the card, ``chunked_attention`` on the CPU) over the rank's
    local heads, or — q sequence-sharded over ``model`` (``seq_shard``) —
    over its local query rows against the gathered k, v."""
    Partial, Replicate, Shard = _pl()
    mesh = q.device_mesh
    md = _model_dim(mesh)
    n, r = model_coord(mesh)
    H, Hkv = q.shape[2], k.shape[2]
    qp = _norm_dim(q.placements[md], 4) if md is not None else Replicate()
    for i, p in enumerate(q.placements):
        if i != md and isinstance(p, Shard) and p.dim != 0:
            raise ValueError(f"attention: q placed {q.placements}: only the "
                             "batch may shard over the data axes")
    if n > 1 and isinstance(qp, Shard) and qp.dim == 1:       # seq-sharded
        want = _set(q.placements, md, Replicate())
        k, v = _to(k, want), _to(v, want)
        off, _ = local_extent(q, 1)
        kv_grad = _set(k.placements, md, Partial())
        fn = lambda q_, k_, v_: run(q_, k_, v_, off)       # noqa: E731
    elif n > 1 and isinstance(qp, Shard) and qp.dim == 2:     # head-sharded
        k, v, kv_local = _kv_for_heads(q, k, v)
        if kv_local:
            kv_grad = list(k.placements)
            fn = lambda q_, k_, v_: run(q_, k_, v_, 0)     # noqa: E731
        else:
            lo, hi = _q_heads_kv(H, Hkv, n, r)
            kv_grad = _set(k.placements, md, Partial())
            fn = lambda q_, k_, v_: run(                    # noqa: E731
                q_, k_[:, :, lo:hi], v_[:, :, lo:hi], 0)
    else:
        if md is not None:
            q = _to(q, _set(q.placements, md, Replicate()))
        k, v = _to(k, list(q.placements)), _to(v, list(q.placements))
        kv_grad = list(k.placements)
        fn = lambda q_, k_, v_: run(q_, k_, v_, 0)         # noqa: E731
    return local_apply(fn, list(q.placements), q, k, v,
                       in_grad_placements=(list(q.placements), kv_grad,
                                           kv_grad), out_shape=q.shape)


# ------------------------------------------- a sequence-sharded KV cache


def seq_dims(leaf) -> Tuple[int, ...]:
    """The mesh dims that cut the T axis (dim 1) of a layer's cache leaf
    (B, T, ...): ``model`` where it does not divide the kv heads, the data
    axes too (or alone) at a batch they do not divide (``cache_specs``)."""
    if not is_dtensor(leaf):
        return ()
    _, _, Shard = _pl()
    return tuple(i for i, p in enumerate(leaf.placements)
                 if isinstance(p, Shard) and p.dim % leaf.ndim == 1)


def seq_layout(leaf):
    """``(dims, placements, offset, t_local)`` of a sequence-sharded cache
    leaf on this rank: the mesh dims that cut T, the placements of the
    rows that read or write it — the leaf's, less its T axis (q and the new
    k / v rows whole over those dims; batch and kv heads as the cache
    shards them) — and the first row and row count of this rank's range
    (:func:`local_extent`)."""
    _, Replicate, _ = _pl()
    dims = seq_dims(leaf)
    pl = [Replicate() if i in dims else p
          for i, p in enumerate(leaf.placements)]
    return (dims, pl) + local_extent(leaf, 1)


def seq_combine(o: torch.Tensor, lse: torch.Tensor, reduce: Callable
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole read from partial reads over ranges of the cache: ``o``
    (..., Dh) and ``lse`` (...) in f32, one part a range, and ``reduce(t,
    op)`` (op "max" or "sum") that reduces ``t`` over the parts — an
    all-reduce over the process groups that cut T (:func:`seq_read`), or a
    reduction over a stacked leading axis.  ``lse = logsumexp_r lse_r``
    and ``o = Σ_r exp(lse_r − lse) · o_r``, computed as ``M = max_r lse_r``
    (one reduction), then ``Σ_r w_r·o_r`` and ``Σ_r w_r`` with ``w_r =
    exp(lse_r − M)`` in one sum: ``o = Σ w_r·o_r / Σ w_r``, ``lse = M + log
    Σ w_r``.  A part with no live key of a row (``lse_r = -inf``, ``o_r =
    0``) adds 0."""
    m = reduce(lse, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)
    both = reduce(torch.cat([o * w[..., None], w[..., None]], dim=-1), "sum")
    den = both[..., -1]
    return (both[..., :-1] / torch.clamp_min(den, 1e-30)[..., None],
            m + torch.log(den))


def _group_reduce(groups) -> Callable:
    """``reduce(t, op)`` for :func:`seq_combine`: all-reduces over each of
    ``groups`` in turn."""
    import torch.distributed._functional_collectives as funcol

    def reduce(t, op):
        for g in groups:
            t = funcol.all_reduce(t, op, g)
        return t

    return reduce


def seq_read(q, lengths, leaves: Sequence, read: Callable):
    """An attention read over a sequence-sharded cache (``leaves``: the
    layer's cache leaves, each (B, T, ...) with T cut over :func:`seq_dims`):
    on each rank ``read(q, ext, *leaves)`` over the rank's range with its
    local extents ``ext`` = each row's extent less the range's start,
    clipped to ``[0, t_local]``, giving ``(o_r, lse_r)`` in f32; the ranks'
    parts combined by :func:`seq_combine`.  Returns the read in q's dtype,
    whole over the dims that cut T."""
    _, Replicate, Shard = _pl()
    mesh = leaves[0].device_mesh
    dims, pl, off, t_local = seq_layout(leaves[0])
    reduce = _group_reduce([mesh.get_group(i) for i in dims])
    q = _to(q, pl)
    lengths = _to(lengths, [p if isinstance(p, Shard) and p.dim == 0
                            else Replicate() for p in pl])

    def run(q_, l_, *leaves_):
        ext = torch.clamp(l_.to(torch.int32) - off, 0, t_local)
        o, lse = read(q_, ext, *leaves_)
        o, _ = seq_combine(o.to(torch.float32), lse, reduce)
        return o.to(q_.dtype)

    return local_apply(run, pl, q, lengths, *leaves)


def attn_packed(q, k_c, v_c, k_s, v_s, lengths, *, run: Callable):
    """The quantised cache read on DTensors: ``run`` (the packed attention
    kernel's dispatch) on the rank's slots and kv heads, where the cache
    shards its heads like q (``cache_specs`` at a ``model`` axis dividing
    the kv heads).  A sequence-sharded cache is read on each rank's range
    with ``run(..., return_lse=True)`` on f32 q (so the split kernel's
    output is its f32 result, not yet rounded) and the ranks' parts are
    combined (:func:`seq_read`)."""
    _, Replicate, Shard = _pl()
    if seq_dims(k_c):
        return seq_read(q, lengths, [k_c, v_c, k_s, v_s],
                        lambda q_, ext, *c: run(q_.to(torch.float32), *c,
                                                ext, return_lse=True))
    mesh = q.device_mesh
    md = _model_dim(mesh)
    n, _ = model_coord(mesh)
    if md is not None and n > 1 and isinstance(
            _norm_dim(k_c.placements[md], k_c.ndim), Shard):
        q = _to(q, _set(q.placements, md, Shard(2)))
    elif md is not None:
        q = _to(q, _set(q.placements, md, Replicate()))
    lengths = _to(lengths, _set(lengths.placements, md, Replicate())) \
        if md is not None else lengths
    return local_apply(run, list(q.placements), q, k_c, v_c, k_s, v_s,
                       lengths)


# ------------------------------------------ embedding, tied head and loss


def embed(w, tokens):
    """``w[tokens]`` with ``w`` (V, D) vocab-sharded over ``model`` (the
    ``"embed"`` rule): each rank looks up the tokens of its vocab range,
    zeros elsewhere, and the ``Partial`` rows are all-reduced."""
    Partial, Replicate, Shard = _pl()
    if not is_dtensor(tokens):
        raise ValueError("a placed embedding needs placed tokens")
    w = _unshard_data(w)
    mesh = w.device_mesh
    md = _model_dim(mesh)
    n, r = model_coord(mesh)
    tok_pl = list(tokens.placements)
    wp = _norm_dim(w.placements[md], 2) if md is not None else Replicate()
    if n > 1 and isinstance(wp, Shard) and wp.dim == 0:
        lo = r * (w.shape[0] // n)

        def run(w_l, t_l):
            t = t_l.to(torch.int64) - lo
            hit = (t >= 0) & (t < w_l.shape[0])
            rows = w_l[torch.where(hit, t, torch.zeros_like(t))]
            return torch.where(hit[..., None], rows,
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device))

        y = local_apply(run, _set(tok_pl, md, Partial()), w, tokens,
                        in_grad_placements=(
                            _grad_for_weight(w.placements, tok_pl, md), None))
        return _to(y, _set(tok_pl, md, Replicate()))
    w = _to(w, _set(w.placements, md, Replicate())) if md is not None else w
    return local_apply(lambda w_l, t_l: w_l[t_l.to(torch.int64)], tok_pl,
                       w, tokens, in_grad_placements=(
                           _grad_for_weight(w.placements, tok_pl, md), None))


def tied_head(h, w):
    """``h @ w.T`` for the tied embedding ``w`` (V, D): column-parallel over
    its vocab shard, the logits ``Shard(-1)`` over ``model``."""
    Partial, Replicate, Shard = _pl()
    w = _unshard_data(w)
    mesh = w.device_mesh
    md = _model_dim(mesh)
    n, _ = model_coord(mesh)
    h = _to(h, _set(h.placements, md, Replicate())) if md is not None else h
    wp = _norm_dim(w.placements[md], 2) if md is not None else Replicate()
    if n > 1 and isinstance(wp, Shard) and wp.dim == 0:
        out_pl = _set(h.placements, md, Shard(h.ndim - 1))
        h_grad = _set(h.placements, md, Partial())
    else:
        if md is not None:
            w = _to(w, _set(w.placements, md, Replicate()))
        out_pl, h_grad = list(h.placements), list(h.placements)
    return local_apply(lambda h_l, w_l: h_l @ w_l.T.to(h_l.dtype), out_pl,
                       h, w, in_grad_placements=(
                           h_grad, _grad_for_weight(w.placements,
                                                    h.placements, md)))


class _VocabParallelXent(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over a vocab shard:
    the max, the sum of exponentials and the picked logit all-reduced
    over ``group``; the gradient (softmax - one-hot) stays local."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        import torch.distributed as dist

        x = logits.to(torch.float32)
        m = x.amax(dim=-1)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        s = e.sum(dim=-1)
        t = labels.to(torch.int64).clamp_min(0) - lo
        hit = (t >= 0) & (t < x.shape[-1])
        picked = torch.where(hit, torch.gather(
            x, -1, torch.where(hit, t, torch.zeros_like(t))[..., None])[..., 0],
            torch.zeros((), dtype=x.dtype, device=x.device))
        if group is not None:
            dist.all_reduce(s, group=group)
            dist.all_reduce(picked, group=group)
        lse = torch.log(s) + m
        ctx.save_for_backward(x, lse, t, hit)
        ctx.in_dtype = logits.dtype
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, lse, t, hit = ctx.saved_tensors
        p = torch.exp(x - lse[..., None])
        onehot = torch.zeros_like(p).scatter_(
            -1, torch.where(hit, t, torch.zeros_like(t))[..., None],
            hit[..., None].to(p.dtype))
        return ((p - onehot) * g[..., None]).to(ctx.in_dtype), None, None, \
            None


def cross_entropy(logits, labels):
    """Mean next-token cross-entropy over ``labels >= 0`` from logits
    (B, T, V) vocab-sharded over ``model`` (the head's ``Shard(-1)``),
    without gathering the vocab: the loss ``repro_torch.models.model.
    loss_fn`` computes; ``labels`` placed like the batch."""
    _, Replicate, Shard = _pl()
    if not is_dtensor(labels):
        raise ValueError("placed logits need placed labels (shard_batch)")
    mesh = logits.device_mesh
    md = _model_dim(mesh)
    n, r = model_coord(mesh)
    lp = _norm_dim(logits.placements[md], 3) if md is not None else Replicate()
    if not (n > 1 and isinstance(lp, Shard) and lp.dim == 2):
        if md is not None:
            logits = _to(logits, _set(logits.placements, md, Replicate()))
        group, lo = None, 0
    else:
        group, lo = mesh.get_group(md), r * (logits.shape[-1] // n)
    # the per-token loss: the logits' batch placements, no vocab axis
    tok_pl = _set(logits.placements, md, Replicate())
    labels = _to(labels, tok_pl)
    per_tok = local_apply(
        lambda x_l, y_l: _VocabParallelXent.apply(x_l, y_l, lo, group),
        tok_pl, logits, labels, in_grad_placements=(
            list(logits.placements), None))
    mask = (labels >= 0).to(torch.float32)
    return (per_tok * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
