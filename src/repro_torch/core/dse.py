"""Automated DSE — faithful implementation of the paper's Fig. 1 workflow.

    trained model
      └─ 1. global magnitude pruning (reference)      -> per-layer density caps
      └─ 2. heuristic folding search + secondary relaxation -> balanced baseline
      └─ 3. iterative bottleneck elimination:
             · if sparse-unfolding a layer *lowers* its resource use,
               apply it directly;
             · else estimate per-layer latency/resource, pick the latency
               bottleneck, try {sparse-unfold, factor-unfold}, apply the
               feasible move with the best Δlatency/Δresource;
             · stop when no move satisfies the resource constraint.
      └─ 4. emit folding + sparse-layer configuration
             (layers chosen for sparse-unfolding get re-sparse fine-tuning;
              the rest stay dense).

The same engine drives both scales: LeNet-5 on one chip (paper repro) and
per-layer shard/tile selection for the LM archs.  Plain Python float
arithmetic, as ``repro.core.dse``: the same specs give the same folding and
trace.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cost_model import HWSpec, LayerSpec, NetworkEstimate, TPU_V5E, network_estimate
from .folding import FoldingConfig

__all__ = ["DSEResult", "run_dse", "balanced_folding_baseline",
           "apply_realised_densities"]


def apply_realised_densities(
    specs: Sequence[LayerSpec],
    realised: Dict[str, Tuple[float, float]],
) -> List[LayerSpec]:
    """Feed a compression pass's *realised* densities back into the layer IR.

    ``realised`` maps layer name -> (block_density, element_density) — the
    output of :func:`repro_torch.core.compile_sparse.realised_densities`, which
    covers conv leaves (im2col-packed) and linears alike.  Layers absent
    from ``realised`` keep their reference-pruning caps.  This closes the
    estimate→realise→re-estimate loop of the paper's Fig. 1: a second
    ``run_dse`` over the returned specs iterates against what the pass
    actually packed instead of what the pruner hoped for.
    """
    out: List[LayerSpec] = []
    for s in specs:
        de = realised.get(s.name)
        if de is None:
            out.append(s)
            continue
        bd, ed = de
        out.append(dataclasses.replace(
            s, max_block_density=float(bd), max_element_density=float(ed)))
    return out


@dataclasses.dataclass
class DSEResult:
    configs: List[FoldingConfig]
    estimate: NetworkEstimate
    baseline: NetworkEstimate           # balanced dense baseline (step 2)
    trace: List[Dict]                   # iteration log (for EXPERIMENTS.md)
    sparse_layers: List[str]            # names selected for re-sparse fine-tuning


def _fits(specs, cfgs, hw, budget) -> bool:
    return network_estimate(specs, cfgs, hw).resource <= budget


def balanced_folding_baseline(
    specs: Sequence[LayerSpec],
    hw: HWSpec,
    budget: float,
    *,
    max_parallelism: Optional[int] = None,
) -> List[FoldingConfig]:
    """Step 2: throughput-oriented heuristic folding search.

    Greedily double the parallelism of the current bottleneck while the
    resource budget holds ("heuristic folding search"); if the minimal
    configuration already violates the budget, *secondary relaxation*
    re-folds the least-critical layers (this mirrors FINN's folding DSE
    with our resource awareness added).
    """
    max_p = max_parallelism or hw.lanes
    cfgs = [FoldingConfig(parallelism=1) for _ in specs]
    # secondary relaxation guard: minimal config must fit; if not, budget is
    # weight-dominated and folding cannot help — report as-is.
    if not _fits(specs, cfgs, hw, budget):
        return cfgs
    while True:
        est = network_estimate(specs, cfgs, hw)
        order = sorted(
            range(len(specs)), key=lambda i: est.per_layer[i]["total"], reverse=True
        )
        moved = False
        for i in order:
            if cfgs[i].parallelism >= max_p:
                continue
            # folding only helps compute-bound layers
            if est.per_layer[i]["compute"] <= est.per_layer[i]["memory"]:
                continue
            trial = list(cfgs)
            trial[i] = cfgs[i].replace(parallelism=cfgs[i].parallelism * 2)
            if _fits(specs, trial, hw, budget):
                new = network_estimate(specs, trial, hw)
                if new.ii < est.ii - 1e-18 or i == order[0]:
                    # always allow the bottleneck to grow; others only if II drops
                    if new.ii <= est.ii + 1e-18:
                        cfgs = trial
                        moved = True
                        break
        if not moved:
            break
    return cfgs


def _sparse_unfold(spec: LayerSpec, cfg: FoldingConfig, hw: HWSpec) -> FoldingConfig:
    """Fully unroll + statically prune a layer (the paper's key move)."""
    return cfg.replace(
        parallelism=hw.lanes,
        unroll="sparse",
        block_density=spec.max_block_density,
        element_density=spec.max_element_density,
    )


def _factor_unfold(cfg: FoldingConfig, hw: HWSpec) -> Optional[FoldingConfig]:
    if cfg.parallelism >= hw.lanes:
        return None
    return cfg.replace(parallelism=cfg.parallelism * 2, unroll="factor")


def _relax(
    specs: Sequence[LayerSpec],
    cfgs: List[FoldingConfig],
    bottleneck: int,
    hw: HWSpec,
    budget: float,
) -> Optional[List[FoldingConfig]]:
    """Secondary relaxation: halve parallelism of slack layers until the
    configuration fits the budget, never letting a relaxed layer become the
    new bottleneck.  Returns None if the budget still cannot be met."""
    cfgs = list(cfgs)
    est = network_estimate(specs, cfgs, hw)
    target_ii = est.per_layer[bottleneck]["total"]
    for _ in range(64):
        if est.resource <= budget:
            return cfgs
        # most-slack first: layer whose latency would stay under target_ii
        best_i, best_slack = None, 0.0
        for i, (spec, cfg) in enumerate(zip(specs, cfgs)):
            if i == bottleneck or cfg.parallelism <= 1 or cfg.unroll == "sparse":
                continue
            trial = cfg.replace(parallelism=cfg.parallelism // 2)
            from .cost_model import layer_latency
            lat = layer_latency(spec, trial, hw)["total"]
            if lat <= target_ii and (target_ii - lat) > best_slack:
                best_i, best_slack = i, target_ii - lat
        if best_i is None:
            return None
        cfgs[best_i] = cfgs[best_i].replace(parallelism=cfgs[best_i].parallelism // 2)
        est = network_estimate(specs, cfgs, hw)
    return cfgs if est.resource <= budget else None


def run_dse(
    specs: Sequence[LayerSpec],
    *,
    hw: HWSpec = TPU_V5E,
    resource_budget: Optional[float] = None,
    max_iters: int = 256,
    retune: Optional[Callable[[LayerSpec, FoldingConfig, HWSpec],
                              Optional[FoldingConfig]]] = None,
) -> DSEResult:
    """Fig. 1 DSE.  ``retune`` (:func:`repro_torch.core.autotune.
    dse_retune`) lets step 3's bottleneck elimination propose a tuner
    move: given the bottleneck layer's spec and current folding config it
    may return a refined config (a re-ranked bit-width), competing against
    sparse-/factor-unfold on the same Δlatency/Δresource rule."""
    specs = list(specs)
    budget = resource_budget if resource_budget is not None else hw.hbm_bytes * 0.5
    trace: List[Dict] = []

    # -- step 2: balanced dense baseline -----------------------------------
    cfgs = balanced_folding_baseline(specs, hw, budget)
    baseline = network_estimate(specs, cfgs, hw)
    trace.append({"iter": 0, "move": "baseline", "ii": baseline.ii,
                  "resource": baseline.resource, "bottleneck": baseline.bottleneck})

    # -- step 3a: direct sparse-unfolding wherever it *reduces* resources --
    from .cost_model import layer_resource
    for i, spec in enumerate(specs):
        if not spec.prunable:
            continue
        cand = _sparse_unfold(spec, cfgs[i], hw)
        if layer_resource(spec, cand, hw) < layer_resource(spec, cfgs[i], hw):
            cfgs[i] = cand
            trace.append({"iter": 0, "move": f"direct-sparse-unfold:{spec.name}",
                          "ii": network_estimate(specs, cfgs, hw).ii,
                          "resource": network_estimate(specs, cfgs, hw).resource,
                          "bottleneck": network_estimate(specs, cfgs, hw).bottleneck})

    # -- step 3b: iterative bottleneck elimination --------------------------
    for it in range(1, max_iters + 1):
        est = network_estimate(specs, cfgs, hw)
        b = max(range(len(specs)), key=lambda i: est.per_layer[i]["total"])
        spec = specs[b]
        candidates: List[Tuple[str, List[FoldingConfig]]] = []
        if spec.prunable and cfgs[b].unroll != "sparse":
            t = list(cfgs); t[b] = _sparse_unfold(spec, cfgs[b], hw)
            candidates.append(("sparse-unfold", t))
        fu = _factor_unfold(cfgs[b], hw)
        if fu is not None:
            t = list(cfgs); t[b] = fu
            candidates.append(("factor-unfold", t))
        if retune is not None:
            rt = retune(spec, cfgs[b], hw)
            if rt is not None and rt != cfgs[b]:
                t = list(cfgs); t[b] = rt
                candidates.append(("retune", t))

        best = None
        for move, trial in candidates:
            new = network_estimate(specs, trial, hw)
            if new.resource > budget:
                # secondary relaxation: re-fold non-critical layers (halve
                # their parallelism) while their latency stays under the II
                # this move would achieve, to free budget for the move.
                trial = _relax(specs, trial, b, hw, budget)
                if trial is None:
                    continue
                new = network_estimate(specs, trial, hw)
                move += "+relax"
            d_lat = est.ii - new.ii
            if d_lat <= 0:
                continue
            d_res = max(new.resource - est.resource, 1.0)
            gain = d_lat / d_res
            if best is None or gain > best[0]:
                best = (gain, move, trial, new)
        if best is None:
            break
        _, move, cfgs, new = best
        trace.append({"iter": it, "move": f"{move}:{spec.name}", "ii": new.ii,
                      "resource": new.resource, "bottleneck": new.bottleneck})

    final = network_estimate(specs, cfgs, hw)
    sparse_layers = [s.name for s, c in zip(specs, cfgs) if c.unroll == "sparse"]
    return DSEResult(configs=cfgs, estimate=final, baseline=baseline,
                     trace=trace, sparse_layers=sparse_layers)
