"""AdamW with optional bf16 moments and frozen-sparsity masks.

A port of ``repro.train.optimizer``.  ``masks`` (True = keep) implement
the paper's re-sparse fine-tuning: after each update the new parameters are
multiplied by their masks, so pruned weights stay exactly zero and the
pruned connectivity never regrows.  The math runs in f32 and casts back to
each parameter's dtype (bf16 master weights at full width); integer leaves
(int8 / packed storage) are frozen.  Functional: the inputs are left
untouched, new trees are returned.

A leaf of more than :data:`UPDATE_CHUNK` elements is updated a flat slice
at a time into its new tensors, its mask applied slice by slice: every
operation is elementwise, so the result is the same bit for bit, and the
f32 temporaries stay a slice's size instead of several copies of the leaf
(a stacked expert or Mamba2 leaf holds over a billion elements).

Placed (DTensor) leaves update on each rank's shards of the moments' (ZeRO)
placements: the gradient, parameter and mask are taken to them first (a
local slice of a replicated tensor), the same elementwise arithmetic runs
on the local shard, and the new parameter goes back to its own placements
(the ZeRO all-gather).  The gradient norm sums each leaf's global sum of
squares in leaf order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..core.sharded import is_dtensor
from ..tree import tree_leaves, tree_map

__all__ = ["UPDATE_CHUNK", "AdamWConfig", "adamw_init", "adamw_update",
           "global_norm", "schedule"]

PyTree = Any

# elements of a leaf updated at once (f32 temporaries of 256 MiB each)
UPDATE_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # moments dtype ("bfloat16" for 405B)
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, as an f32 tensor on ``step``'s
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: PyTree, cfg: AdamWConfig) -> PyTree:
    """Zero moments in ``cfg.state_dtype`` beside every leaf, and the step
    counter (int32, on the device of the first leaf)."""
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros_like(p, dtype=dt) if is_dtensor(p) \
        else torch.zeros(p.shape, dtype=dt, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sumsq(x) -> torch.Tensor:
    s = torch.sum(torch.square(x.to(torch.float32)))
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a plain tensor;
    a placed leaf contributes its global sum)."""
    return torch.sqrt(sum(_sumsq(x) for x in tree_leaves(tree)))


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def adamw_update(grads: PyTree, state: PyTree, params: PyTree,
                 cfg: AdamWConfig, masks: Optional[PyTree] = None):
    """Returns (new_params, new_state, metrics)."""
    step = _local(state["step"]) + 1
    lr = schedule(cfg, step)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-12), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd_slice(g, m, v, p, mk):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            step_ = step_ + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * step_).to(p.dtype)
        if mk is not None:  # frozen sparsity: pruned weights stay exactly 0
            new_p = new_p * mk.to(device=p.device, dtype=p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    def upd(g, m, v, p, mk):
        if not p.is_floating_point():
            return p, m, v  # frozen integer storage (int8 weights)
        if is_dtensor(p):
            return upd_placed(g, m, v, p, mk)
        if p.numel() <= UPDATE_CHUNK:
            return upd_slice(g, m, v, p, mk)
        out = tuple(torch.empty(p.shape, dtype=t.dtype, device=t.device)
                    for t in (p, m, v))
        ins = [t.reshape(-1) for t in (g, m, v, p)]
        ins.append(None if mk is None else mk.reshape(-1))
        flat_out = [t.view(-1) for t in out]
        for lo in range(0, p.numel(), UPDATE_CHUNK):
            sl = slice(lo, lo + UPDATE_CHUNK)
            for dst, src in zip(flat_out, upd_slice(
                    *(None if t is None else t[sl] for t in ins))):
                dst[sl] = src
        return out

    def upd_placed(g, m, v, p, mk):
        from torch.distributed.tensor import DTensor

        mesh, at = m.device_mesh, list(m.placements)
        to = lambda t: t if t is None or list(t.placements) == at \
            else t.redistribute(mesh, at)                      # noqa: E731
        new = upd(*(None if t is None else to(t).to_local()
                    for t in (g, m, v, p, mk)))
        wrap = lambda t, like: DTensor.from_local(             # noqa: E731
            t, mesh, at, run_check=False, shape=like.shape,
            stride=like.stride())
        new_p = wrap(new[0], p)
        if list(p.placements) != at:
            new_p = new_p.redistribute(p.device_mesh, p.placements)
        return new_p, wrap(new[1], m), wrap(new[2], v)

    flat = tree_map(upd, grads, state["m"], state["v"], params,
                    masks if masks is not None else {})
    pick = lambda i: tree_map(lambda t: t[i], flat)
    if is_dtensor(state["step"]):
        from torch.distributed.tensor import DTensor
        step = DTensor.from_local(step, state["step"].device_mesh,
                                  state["step"].placements, run_check=False)
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gn, "lr": lr}
