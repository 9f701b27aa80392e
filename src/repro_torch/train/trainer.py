"""Train / prefill step factories — the entry points the launcher runs.

``make_train_step``: microbatched gradient accumulation, AdamW, frozen
sparsity masks; with ``n_micro > 1`` the gradients accumulate in f32 and
are divided by ``n_micro``, with ``n_micro == 1`` they keep the parameter
dtype (bf16 at full width), as in ``repro.train.trainer``.  The reference's
``jax.jit`` / ``lax.scan`` become eager calls and a Python loop.

``make_prefill_step``: the full-sequence forward's last-position logits.
``make_serve_step``: one cached decode step (the dry-run's decode cells).

Both take placed parameters too (DTensors from
:func:`repro_torch.launch.sharding.shard_params`, a batch from
``shard_batch``): the forward runs on each rank's shards, each gradient is
redistributed to its parameter's placements (the data-parallel all-reduce,
or reduce-scatter under FSDP), and AdamW updates each rank's shards of
parameters and ZeRO-sharded moments.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.sharded import is_dtensor, place
from ..models.config import ArchConfig
from ..models.model import decode_step, forward, loss_fn
from .optimizer import AdamWConfig, adamw_update
from ..tree import tree_leaves, tree_map

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step",
           "pick_n_micro"]

PyTree = Any


def pick_n_micro(cfg: ArchConfig, global_batch: int, dp_size: int,
                 *, seqs_per_shard: int = 2) -> int:
    """Microbatching policy, activation-budget driven: target
    ``seqs_per_shard`` sequences per data shard per microbatch (remat keeps
    the per-layer working set at one microbatch)."""
    per_shard = max(1, global_batch // max(dp_size, 1))
    n = max(1, per_shard // seqs_per_shard)
    n = min(n, global_batch)
    while global_batch % n or (global_batch // n) % dp_size:
        n -= 1
    return max(n, 1)


def _split_trainable(params: PyTree):
    """Partition params into (trainable float leaves, frozen int leaves):
    float leaves become autograd leaves (detached views that require grad,
    so the caller's tensors are untouched); integer leaves (int8 / packed
    storage) are frozen — differentiating them is a type error."""
    trainable = tree_map(lambda x: x.detach().requires_grad_()
                         if x.is_floating_point() else None, params)
    frozen = tree_map(lambda x: None if x.is_floating_point() else x, params)
    return trainable, frozen


def _merge(trainable: PyTree, frozen: PyTree) -> PyTree:
    return tree_map(lambda a, b: a if a is not None else b, trainable, frozen)


def _like_param(g, p):
    """A gradient in its parameter's placements (plain tensors as they
    are)."""
    if is_dtensor(p) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _micro_batches(batch: Dict, n_micro: int):
    """``n_micro`` micro-batches of consecutive rows; a placed batch leaf is
    gathered (tokens are small) and each micro-batch placed as it was, so
    the split is the one-process split."""
    def split(v):
        full = v.full_tensor() if is_dtensor(v) else v
        parts = full.reshape(n_micro, full.shape[0] // n_micro,
                             *full.shape[1:])
        if is_dtensor(v):
            return [place(t, v.device_mesh, v.placements) for t in parts]
        return list(parts)

    cols = {k: split(v) for k, v in batch.items()}
    return [{k: cols[k][i] for k in cols} for i in range(n_micro)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, n_micro: int = 1,
                    masks: Optional[PyTree] = None, *, dispatch=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens`` and ``labels`` (B, T) with B a
    multiple of ``n_micro``; ``dispatch`` selects kernels or their plain
    versions (``repro_torch.core.dispatch``)."""

    def value_and_grad(trainable, frozen, batch):
        leaves = tree_leaves(trainable)
        loss = loss_fn(_merge(trainable, frozen), cfg, batch,
                       dispatch=dispatch)
        # a leaf the loss does not reach (an encoder's token embedding)
        # gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        by_id = {id(t): _like_param(g, t) for t, g in zip(leaves, grads)}
        loss = loss.detach()
        if is_dtensor(loss):
            loss = loss.full_tensor()
        return loss, tree_map(
            lambda t: None if t is None else by_id[id(t)], trainable)

    def train_step(params, opt_state, batch):
        trainable, frozen = _split_trainable(params)
        if n_micro == 1:
            loss, grads = value_and_grad(trainable, frozen, batch)
            losses = loss[None]
        else:
            grads = tree_map(lambda p: None if p is None else torch.zeros_like(
                p, dtype=torch.float32), trainable)
            losses = []
            for mb in _micro_batches(batch, n_micro):
                loss, g = value_and_grad(trainable, frozen, mb)
                # the accumulator is this step's own: add in place (a bf16
                # gradient widens element by element, with no f32 copy)
                tree_map(lambda a, b: None if a is None else a.add_(b),
                         grads, g)
                losses.append(loss)
                del g
            losses = torch.stack(losses)
            tree_map(lambda g: None if g is None else g.div_(n_micro), grads)
        # frozen (integer) leaves get scalar-zero placeholders so the
        # optimizer tree matches; adamw skips non-float params.
        grads = tree_map(lambda g, p: g if g is not None else torch.zeros(
            (), dtype=torch.float32, device=p.device), grads, params)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, opt_cfg, masks=masks)
        metrics["loss"] = torch.mean(losses)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (B, V)``: the next-token logits of
    the last position only, without autograd."""

    @torch.no_grad()
    def prefill_step(params, batch: Dict):
        return forward(params, cfg, batch)[:, -1]

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``serve_step(params, cache, tokens) -> (logits, cache)``: one decode
    step, tokens (B, 1), the cache updated in place
    (:func:`repro_torch.models.model.decode_step`), without autograd."""

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return decode_step(params, cfg, cache, tokens)

    return serve_step
