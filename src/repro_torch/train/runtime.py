"""Fault-tolerant training runtime: the loop around the train step.

A port of ``repro.train.runtime``:

* checkpoint/restart — resumes from the latest committed step; the data
  pipeline is regenerated from the step counter (preemption-safe);
* failure watchdog — each step runs under a deadline; a trip or a
  ``RuntimeError`` marks the step failed, and the runner retries it, then
  rolls back to the last committed checkpoint (after any save still in
  flight has committed);
* async checkpoints every ``ckpt_every`` steps and at the end.

The reference's ``jax.block_until_ready`` becomes ``torch.cuda.synchronize``
for a step whose results lie on the card.  Elastic re-mesh: on restore the
state is placed again by ``placements`` (``{"params": ..., "opt": ...}``
trees of ``(mesh, placements)``, the current mesh's; the checkpoint stores
no mesh), and under a started process group every rank is a checkpoint
host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import Checkpointer
from ..tree import tree_leaves

__all__ = ["RunnerConfig", "StepDeadlineExceeded", "TrainRunner"]

PyTree = Any


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 50              # <= 0: no checkpoints at all
    ckpt_dir: str = "results/train_ckpt"
    step_deadline_s: float = 0.0      # 0 = no watchdog
    max_retries: int = 2
    log_every: int = 10


class StepDeadlineExceeded(RuntimeError):
    pass


def _sync(tree: PyTree) -> None:
    """Wait for the device work behind a step's results."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class TrainRunner:
    """Drives (params, opt_state) through train_step with FT semantics."""

    def __init__(self, train_step: Callable, data_fn: Callable[[int], Dict],
                 cfg: RunnerConfig, *, placements: Optional[PyTree] = None):
        self.train_step = train_step
        self.data_fn = data_fn
        self.cfg = cfg
        self.placements = placements
        host, hosts = 0, 1
        if dist.is_available() and dist.is_initialized():
            host, hosts = dist.get_rank(), dist.get_world_size()
        self.ckpt = Checkpointer(cfg.ckpt_dir, host_id=host, n_hosts=hosts)
        self.metrics_log = []
        self.fault_injector: Optional[Callable[[int], None]] = None

    def _checkpointing(self) -> bool:
        return self.cfg.ckpt_every > 0

    # ------------------------------------------------------------------ run

    def run(self, params: PyTree, opt_state: PyTree, *, start_step: int = 0):
        """Train from ``params`` / ``opt_state`` (or the latest committed
        checkpoint past ``start_step``) to ``total_steps``; returns the
        final (params, opt_state).  Only the current state is held between
        steps: a caller that passes its own last references (``run(
        box.pop("params"), box.pop("opt"))``) lets the first state go after
        the first step, so a step's peak holds two states, not three."""
        state = {"params": params, "opt": opt_state}
        del params, opt_state
        step = start_step
        latest = self.ckpt.latest_step() if self._checkpointing() else None
        if latest is not None and latest > step:
            state, manifest = self.ckpt.restore(
                state, placements=self.placements)
            step = manifest["step"]
            print(f"[runner] restored step {step} from {self.cfg.ckpt_dir}")

        while step < self.cfg.total_steps:
            batch = self.data_fn(step)
            ok, state, metrics = self._guarded_step(step, state, batch)
            if not ok:
                # failure path: restore last good state and retry the step
                latest = self.ckpt.latest_step() \
                    if self._checkpointing() else None
                if latest is not None:
                    self.ckpt.wait()
                    state, manifest = self.ckpt.restore(
                        state, placements=self.placements)
                    step = manifest["step"]
                    print(f"[runner] failure: rolled back to step {step}")
                    continue
                raise RuntimeError(
                    "step failed with no checkpoint to roll back to")
            step += 1
            if metrics and step % self.cfg.log_every == 0:
                loss = float(metrics.get("loss", np.nan))
                print(f"[runner] step {step}: loss={loss:.4f}")
            if self._checkpointing() and (
                    step % self.cfg.ckpt_every == 0
                    or step == self.cfg.total_steps):
                self.ckpt.save_async(step, state,
                                     extra={"wallclock": time.time()})
        self.ckpt.wait()
        return state["params"], state["opt"]

    # ----------------------------------------------------------------- steps

    def _guarded_step(self, step: int, state, batch):
        deadline = self.cfg.step_deadline_s
        for attempt in range(self.cfg.max_retries + 1):
            try:
                if self.fault_injector is not None:
                    self.fault_injector(step)
                t0 = time.perf_counter()
                params, opt, metrics = self.train_step(
                    state["params"], state["opt"], batch)
                _sync(metrics)
                dt = time.perf_counter() - t0
                if deadline and dt > deadline:
                    raise StepDeadlineExceeded(
                        f"step {step} took {dt:.1f}s > {deadline:.1f}s "
                        f"(straggler watchdog)")
                self.metrics_log.append(
                    {**{k: float(v) for k, v in metrics.items()},
                     "step_s": dt})
                return True, {"params": params, "opt": opt}, metrics
            except (StepDeadlineExceeded, RuntimeError) as e:
                print(f"[runner] step {step} attempt {attempt} failed: {e}")
                if attempt == self.cfg.max_retries:
                    return False, state, None
        return False, state, None
