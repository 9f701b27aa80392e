"""Model-zoo compression acceptance matrix (the port of
``repro.core.acceptance``).

Sweeps every zoo architecture (LeNet-5 plus the reduced-shape
llama3.2-1b / qwen1.5-4b / starcoder2-7b transformer configs) across the
registered compression policies and bit-widths, and scores each cell with
two differential accuracy proxies:

* **oracle** — compressed forward vs the forward of ``decompress_model``
  (the dequantised / scattered dense oracle): datapath fidelity, a
  near-exact floor for every family except ``actsparse``, whose
  threshold-ReLU is part of its format and which the plain-ReLU oracle
  does not apply;
* **dense** — compressed forward vs the forward of the original float
  parameters: compression loss.  Naive 2-bit codes collapse here (the
  ``expected_fail`` cells, which must really fail) while bfp8 at the same
  sweep coordinate holds.

Pruning policies discard weights by construction, so on random weights
their dense agreement is near chance: only the oracle floor gates them.

The grid, floors and committed-file checks are the reference's.  What the
port adds:

* the environments take a ``device`` (CUDA unless ``device="cpu"``), a
  ``dispatch`` mode for the compressed forwards (``build_matrix(...,
  dispatch="kernel")`` on the card holds every cell to the kernels), and
  an optional parameter tree per config (``params={config: tree}``).
  Without one they draw their own weights from ``init_params(cfg,
  seed=0)`` / ``init_lenet(seed=0)`` on the host and move them to the
  device: a ``torch.Generator`` draws other numbers on a CUDA device than
  on the CPU, and the reference's threefry weights are the same on every
  backend, so the port's cells are the same on the CPU and the card.
  Container bytes depend on the weights (same-shape bitmaps are unioned),
  and so does whether a 2-bit cell collapses (LeNet's do on most seeds,
  not all), so only the reference's weights reproduce the committed
  ``BENCH_zoo_matrix.json``;
* :func:`floor_fails` holds a payload to the checks that need no
  committed file (the card's check, on the port's own weights);
* the ``autotune@8`` cells (``tuned_policy``'s picks, deterministic) are
  held to the committed bytes like every other cell, where the reference
  exempts them;
* a cell the port cannot compile would stand in ``NOT_RUN`` (none does:
  all 64 run), never evaluated and never counted as passing;
  :func:`build_matrix` lists such cells under ``"not_run"`` beside
  ``"cells"``, and :func:`check_matrix`'s :class:`MatrixCheck` names them
  with the reason beside ``fails``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import reduced_config
from ..device import resolve_device
from ..tree import tree_map
from .compile_sparse import CompileRules, compile_lenet, compile_model, \
    conv_weight_matrix, conv_weight_unmatrix, decompress_model
from .families._util import to_numpy_f32
from .pruning import block_aware_prune

__all__ = ["ACT_THRESHOLD", "ACTSPARSE_ORACLE_MSE_CEIL",
           "ACTSPARSE_ORACLE_TOP1_FLOOR", "BATCH", "CellResult",
           "DENSE_TOP1_FLOOR", "EXPECTED_FAIL", "LENET_BATCH", "LENET_BLOCKS",
           "MatrixCheck", "NOT_RUN", "ORACLE_MSE_CEIL", "ORACLE_TOP1_FLOOR",
           "POLICY_GRID", "SEQ", "STEADY_ITERS", "STEADY_WARMUP",
           "TOP1_REGRESSION_TOL", "WEIGHT_PRESERVING", "ZOO_CONFIGS",
           "ZOO_TRANSFORMERS", "build_matrix", "cell_key", "cell_specs",
           "check_matrix", "floor_fails", "make_env"]

ZOO_TRANSFORMERS = ("llama3.2-1b", "qwen1.5-4b", "starcoder2-7b")
ZOO_CONFIGS = ("lenet",) + ZOO_TRANSFORMERS

# policy -> bit-widths swept.  bits=16 means float storage (no weight
# quantisation); bfp8 keeps its fixed 8-bit mantissa container at every
# sweep coordinate — that is the point of the bfp8-vs-int2 contrast.
POLICY_GRID: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("dense", (16,)),
    ("sparse", (16,)),   # float blocks; quantised blocks are quant_sparse
    ("quant", (8, 4, 2)),
    ("quant_sparse", (8, 4, 2)),
    ("perchannel", (8, 4, 2)),
    ("bfp8", (8, 4, 2)),
    ("actsparse", (16,)),
    ("autotune", (8,)),
)

# policies that keep every weight (dense-reference floors apply); the
# pruning policies are gated on the oracle axis only
WEIGHT_PRESERVING = ("dense", "quant", "perchannel", "bfp8")

# known-collapse cells: 2-bit codes with a single scale per output
# column cannot represent the weight distribution — committed honestly
# as expected_fail, with the bfp8@2 contrast cell passing beside them
EXPECTED_FAIL: Dict[Tuple[str, int], str] = {
    ("quant", 2): "naive 2-bit codes (codes in {-1,0,1} under one "
                  "scale per output column) collapse the logits",
    ("perchannel", 2): "per-channel activation folding does not rescue "
                       "2-bit codes — same collapse as naive quant",
}

# cells the port cannot compile yet, on every config, and why: none
NOT_RUN: Dict[Tuple[str, int], str] = {}

ORACLE_TOP1_FLOOR = 0.999
ORACLE_MSE_CEIL = 1e-6
# actsparse's threshold-ReLU is part of the format, not an error — the
# oracle runs plain ReLU, so its agreement floor is deliberately looser
ACTSPARSE_ORACLE_TOP1_FLOOR = 0.75
ACTSPARSE_ORACLE_MSE_CEIL = 1e-3
# dense-reference pass floors by bit-width (weight-preserving cells)
DENSE_TOP1_FLOOR = {16: 0.99, 8: 0.90, 4: 0.50, 2: 0.50}
# top-1 agreement is measured over 64 argmax comparisons per cell, so
# one flipped position moves it by 1/64; allow 8 flips of drift
TOP1_REGRESSION_TOL = 0.125

ACT_THRESHOLD = 0.02   # actsparse threshold-ReLU tau
BATCH, SEQ = 4, 16     # transformer eval batch (64 argmax positions)
LENET_BATCH = 64
STEADY_ITERS = 5
STEADY_WARMUP = 2

LENET_BLOCKS = {"conv1": (5, 2), "conv2": (10, 4),
                "fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2)}


def cell_specs() -> List[Tuple[str, str, int]]:
    """The full (config, policy, bits) grid, in committed order."""
    return [(cfg, pol, bits)
            for cfg in ZOO_CONFIGS
            for pol, widths in POLICY_GRID
            for bits in widths]


def cell_key(config: str, policy: str, bits: int) -> str:
    return f"{config}/{policy}@{bits}"


@dataclasses.dataclass
class CellResult:
    config: str
    policy: str
    bits: int
    oracle_top1: float
    oracle_mse: float
    dense_top1: float
    dense_mse: float
    stored_bits_ratio: float
    container_bytes: int
    policies_used: List[str]
    expected_fail: bool
    reason: Optional[str]
    decode_us: Optional[float] = None

    @property
    def key(self) -> str:
        return cell_key(self.config, self.policy, self.bits)

    def to_row(self) -> Dict[str, Any]:
        row = dataclasses.asdict(self)
        if row["decode_us"] is None:
            del row["decode_us"]
        if not row["expected_fail"]:
            del row["reason"]
        return row


@dataclasses.dataclass
class MatrixCheck:
    """What :func:`check_matrix` found: ``fails`` (empty = every run cell
    passes), ``not_run`` ({cell key: why}: never counted as passing) and
    the evaluated cells by key."""
    fails: List[str]
    not_run: Dict[str, str]
    results: Dict[str, CellResult]


# ------------------------------------------------------------------ helpers


def _top1(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((torch.argmax(a, -1) == torch.argmax(b, -1))
                 .to(torch.float32).mean())


def _mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _steady_us(f: Callable[[], Any], dev: torch.device,
               iters: int = STEADY_ITERS, warmup: int = STEADY_WARMUP) -> float:
    """Steady-state wall time per call in microseconds (min over
    ``iters`` after ``warmup`` calls), the device synchronised before and
    after each call."""
    for _ in range(warmup):
        f()
    _sync(dev)
    best = float("inf")
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        f()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _on(tree, dev: torch.device):
    """A parameter tree drawn on the host, moved to ``dev``."""
    return tree_map(lambda t: t.to(dev), tree)


def _rules_for(policy: str, bits: int, names) -> CompileRules:
    """CompileRules for one cell: the policy is forced onto every zoo
    leaf so the cell measures exactly one format."""
    real = {"quant_sparse": "sparse"}.get(policy, policy)
    return CompileRules(
        # (16, 16) tiles every reduced-shape leaf (64x64 attn, 64x32 GQA
        # wk, 64x128 mlp) into a real block grid — the default (128, 128)
        # clips to ONE block per leaf and block_density rounds up to
        # keeping it, which would make every sparse cell silently dense
        block=(16, 16),
        min_weight_elems=0,
        quant_bits=min(bits, 8),
        quantize_sparse=(policy == "quant_sparse"),
        act_threshold=ACT_THRESHOLD,
        policies={n: real for n in names},
    )


# ------------------------------------------------------------ environments


class _TransformerEnv:
    """Cached per-arch fixture: params, eval batch, dense reference."""

    def __init__(self, arch: str, device=None, params=None, dispatch=None):
        from ..models.model import forward, init_params

        self.arch = arch
        self.dev = resolve_device(device)
        self.dispatch = dispatch
        self.cfg = reduced_config(arch)
        self.params = params if params is not None else \
            _on(init_params(self.cfg, seed=0, device="cpu"), self.dev)
        toks = np.random.default_rng(0).integers(
            0, self.cfg.vocab, (BATCH, SEQ))
        self.batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                                device=self.dev)}
        with torch.no_grad():
            self.dense_logits = forward(self.params, self.cfg, self.batch)
        # leaf paths discovered from a probe compile: policy overrides
        # are keyed by path and unknown keys raise loudly
        probe = compile_model(self.params, self.cfg,
                              rules=CompileRules(min_weight_elems=0),
                              device=self.dev)
        self.names = [r.name for r in probe.report]

    def evaluate(self, policy: str, bits: int,
                 time_decode: bool = False) -> CellResult:
        from ..models.model import decode_step, forward, init_cache

        cfg = self.cfg
        cm = compile_model(self.params, cfg,
                           rules=_rules_for(policy, bits, self.names),
                           device=self.dev)
        with torch.no_grad():
            lc = forward(cm.params, cfg, self.batch, patterns=cm.patterns,
                         dispatch=self.dispatch)
            lo = forward(decompress_model(cm), cfg, self.batch)
            decode_us = None
            if time_decode:
                cache = init_cache(cfg, BATCH, SEQ, device=self.dev)
                tok = torch.zeros((BATCH, 1), dtype=torch.int32,
                                  device=self.dev)

                def step():   # each call from the empty cache
                    cache["length"].zero_()
                    return decode_step(cm.params, cfg, cache, tok,
                                       patterns=cm.patterns,
                                       dispatch=self.dispatch)[0]

                decode_us = _steady_us(step, self.dev)
        return self._result(policy, bits, cm, lc, lo, decode_us)

    def _result(self, policy, bits, cm, lc, lo, decode_us) -> CellResult:
        xf = EXPECTED_FAIL.get((policy, bits))
        return CellResult(
            config=self.arch, policy=policy, bits=bits,
            oracle_top1=_top1(lc, lo), oracle_mse=_mse(lc, lo),
            dense_top1=_top1(lc, self.dense_logits),
            dense_mse=_mse(lc, self.dense_logits),
            stored_bits_ratio=float(cm.byte_compression),
            container_bytes=int(cm.container_storage_bytes),
            policies_used=sorted({r.policy for r in cm.report}),
            expected_fail=xf is not None, reason=xf,
            decode_us=decode_us)


class _LenetEnv(_TransformerEnv):
    """LeNet cells: fused convs + FC stack, forward timing."""

    def __init__(self, device=None, params=None,  # noqa: D107 — no super
                 dispatch=None):
        from ..models.lenet import LAYERS, init_lenet, lenet_forward

        self.arch = "lenet"
        self.dev = resolve_device(device)
        self.dispatch = dispatch
        self.params = params if params is not None else \
            _on(init_lenet(seed=0, device="cpu"), self.dev)
        img = np.random.default_rng(0).normal(size=(LENET_BATCH, 28, 28, 1))
        self.x = torch.as_tensor(img, dtype=torch.float32, device=self.dev)
        with torch.no_grad():
            self.dense_logits = lenet_forward(self.params, self.x)
        self.names = [n for n, _, _ in LAYERS]
        self.masks = self._prune_masks()

    def _prune_masks(self):
        masks = {}
        for n in ("fc1", "fc2", "fc3"):
            masks[n] = block_aware_prune(
                to_numpy_f32(self.params[n + "_w"]), LENET_BLOCKS[n],
                block_density=0.5)
        for n in ("conv1", "conv2"):
            w4 = to_numpy_f32(self.params[n + "_w"])
            m2 = block_aware_prune(conv_weight_matrix(w4), LENET_BLOCKS[n],
                                   block_density=0.55)
            masks[n] = conv_weight_unmatrix(torch.from_numpy(m2),
                                            w4.shape).numpy()
        return masks

    def evaluate(self, policy: str, bits: int,
                 time_decode: bool = False) -> CellResult:
        from ..models.lenet import lenet_forward

        # weight-preserving cells compress the FULL weights (no mask):
        # their dense-reference score isolates the format's loss
        masks = None if policy in WEIGHT_PRESERVING else self.masks
        cm = compile_lenet(self.params, masks, blocks=LENET_BLOCKS,
                           rules=_rules_for(policy, bits, self.names),
                           device=self.dev)

        def fwd():
            return lenet_forward(self.params, self.x, compressed=cm.layers,
                                 fusion=cm.fusion, dispatch=self.dispatch)

        with torch.no_grad():
            lc = fwd()
            lo = lenet_forward(decompress_model(cm), self.x)
            decode_us = _steady_us(fwd, self.dev) if time_decode else None
        return self._result(policy, bits, cm, lc, lo, decode_us)


def make_env(config: str, device=None, params=None, dispatch=None):
    """The environment of one zoo config (``"lenet"`` or a transformer)."""
    if config == "lenet":
        return _LenetEnv(device, params, dispatch)
    return _TransformerEnv(config, device, params, dispatch)


def _run_cells(device, params, dispatch, evaluate):
    """Walk the grid in committed order, one environment per config;
    ``evaluate(env, config, policy, bits)`` for every cell that runs.
    Returns {key: why} of the cells not run."""
    not_run: Dict[str, str] = {}
    env = None
    for config, policy, bits in cell_specs():
        if (policy, bits) in NOT_RUN:
            not_run[cell_key(config, policy, bits)] = NOT_RUN[(policy, bits)]
            continue
        if env is None or env.arch != config:
            env = None   # free the last config's weights first
            env = make_env(config, device, (params or {}).get(config),
                           dispatch)
        evaluate(env, config, policy, bits)
    return not_run


# ----------------------------------------------------------------- build


def build_matrix(time_cells: bool = True,
                 log: Callable[[str], None] = print, *, device=None,
                 params: Optional[Dict[str, Any]] = None,
                 dispatch=None) -> Dict[str, Any]:
    """Evaluate the grid; returns the ``BENCH_zoo_matrix.json`` payload
    (schema 1) with the cells not run under ``"not_run"``."""
    cells: Dict[str, Any] = {}

    def evaluate(env, config, policy, bits):
        r = env.evaluate(policy, bits, time_decode=time_cells)
        cells[r.key] = r.to_row()
        log(f"  {r.key}: oracle_top1={r.oracle_top1:.3f} "
            f"dense_top1={r.dense_top1:.3f} ratio={r.stored_bits_ratio:.2f}"
            + (f" decode_us={r.decode_us:.0f}" if r.decode_us else "")
            + (" [expected_fail]" if r.expected_fail else ""))

    not_run = _run_cells(device, params, dispatch, evaluate)
    for key, why in not_run.items():
        log(f"  {key}: not run — {why}")
    return {
        "schema": 1,
        "grid": {"configs": list(ZOO_CONFIGS),
                 "policies": [p for p, _ in POLICY_GRID],
                 "bits": sorted({b for _, ws in POLICY_GRID for b in ws})},
        "floors": {
            "oracle_top1": ORACLE_TOP1_FLOOR,
            "oracle_mse": ORACLE_MSE_CEIL,
            "actsparse_oracle_top1": ACTSPARSE_ORACLE_TOP1_FLOOR,
            "actsparse_oracle_mse": ACTSPARSE_ORACLE_MSE_CEIL,
            "dense_top1_by_bits": {str(k): v
                                   for k, v in DENSE_TOP1_FLOOR.items()},
            "top1_regression_tol": TOP1_REGRESSION_TOL,
        },
        "cells": cells,
        "not_run": not_run,
    }


# ----------------------------------------------------------------- check


def floor_fails(payload: Dict[str, Any]) -> List[str]:
    """The checks of a :func:`build_matrix` payload that need no committed
    file: every cell's oracle floor, each expected_fail cell failing its
    dense floor, bfp8@2 holding its dense floor on every config, and the
    NOT_RUN cells, and only they, not run.  (The other cells' dense floors
    were set on the reference's weights.)"""
    cells, fails = payload["cells"], []
    for key, row in cells.items():
        act = row["policy"] == "actsparse"
        top1 = ACTSPARSE_ORACLE_TOP1_FLOOR if act else ORACLE_TOP1_FLOOR
        mse = ACTSPARSE_ORACLE_MSE_CEIL if act else ORACLE_MSE_CEIL
        if row["oracle_top1"] < top1 or row["oracle_mse"] > mse:
            fails.append(f"{key}: oracle top-1 {row['oracle_top1']}, mse "
                         f"{row['oracle_mse']}")
        floor = DENSE_TOP1_FLOOR.get(row["bits"])
        if row["expected_fail"] and row["dense_top1"] >= floor:
            fails.append(f"{key}: expected_fail but dense top-1 "
                         f"{row['dense_top1']} >= {floor}")
    for config in ZOO_CONFIGS:
        row = cells.get(cell_key(config, "bfp8", 2))
        if row is None or row["dense_top1"] < DENSE_TOP1_FLOOR[2]:
            fails.append(f"{config}/bfp8@2: {row}")
    want = sorted(cell_key(c, p, b) for c, p, b in cell_specs()
                  if (p, b) in NOT_RUN)
    if sorted(payload["not_run"]) != want or set(cells) & set(want):
        fails.append(f"cells not run: {sorted(payload['not_run'])}, "
                     f"want {want}")
    return fails


def _check_cell(r: CellResult, committed: Optional[Dict[str, Any]],
                fails: List[str]) -> None:
    key = r.key
    is_act = r.policy == "actsparse"
    top1_floor = ACTSPARSE_ORACLE_TOP1_FLOOR if is_act else ORACLE_TOP1_FLOOR
    mse_ceil = ACTSPARSE_ORACLE_MSE_CEIL if is_act else ORACLE_MSE_CEIL
    if r.oracle_top1 < top1_floor:
        fails.append(f"{key}: oracle_top1 {r.oracle_top1:.4f} < floor "
                     f"{top1_floor} — compacted datapath disagrees with "
                     "its own decompressed oracle")
    if r.oracle_mse > mse_ceil:
        fails.append(f"{key}: oracle_mse {r.oracle_mse:.3e} > ceil "
                     f"{mse_ceil:.0e}")
    if r.policy in WEIGHT_PRESERVING:
        floor = DENSE_TOP1_FLOOR[r.bits]
        if r.expected_fail:
            if r.dense_top1 >= floor:
                fails.append(
                    f"{key}: marked expected_fail but dense_top1 "
                    f"{r.dense_top1:.4f} >= floor {floor} — the collapse "
                    "is gone; promote the cell instead of keeping a "
                    "stale expected_fail marker")
        elif r.dense_top1 < floor:
            fails.append(f"{key}: dense_top1 {r.dense_top1:.4f} < floor "
                         f"{floor} at {r.bits} bits")
    # no-regression + byte-accounting vs the committed matrix
    if committed is None:
        fails.append(f"{key}: missing from committed BENCH_zoo_matrix.json"
                     " — regenerate the matrix")
        return
    ctop1 = float(committed["dense_top1"])
    if r.dense_top1 < ctop1 - TOP1_REGRESSION_TOL:
        fails.append(f"{key}: dense_top1 regressed {ctop1:.4f} -> "
                     f"{r.dense_top1:.4f} (tol {TOP1_REGRESSION_TOL})")
    if r.container_bytes != int(committed["container_bytes"]):
        fails.append(
            f"{key}: container_bytes {r.container_bytes} != committed "
            f"{committed['container_bytes']} — the byte accounting or "
            "the deterministic compile changed")
    cratio = float(committed["stored_bits_ratio"])
    if abs(r.stored_bits_ratio - cratio) > 1e-6 * max(1.0, cratio):
        fails.append(f"{key}: stored_bits_ratio {r.stored_bits_ratio}"
                     f" != committed {cratio}")


def check_matrix(committed: Dict[str, Any],
                 log: Callable[[str], None] = print, *, device=None,
                 params: Optional[Dict[str, Any]] = None) -> MatrixCheck:
    """Re-evaluate every cell that runs (no timing) against the committed
    matrix: the per-cell floors, ``expected_fail`` cells really failing,
    no dense-top-1 regression, and container bytes and stored-bits ratio
    equal to the committed ones (which hold only for the committed
    weights: hand them in as ``params``).  Structural guards first: the
    grid must be at least 4 configs x 5 policies x 3 bit-widths and the
    committed file must carry an expected_fail cell."""
    fails: List[str] = []
    ccells = committed.get("cells", {})
    specs = cell_specs()
    configs = {c for c, _, _ in specs}
    policies = {p for _, p, _ in specs}
    bits = {b for _, _, b in specs}
    if len(configs) < 4 or len(policies) < 5 or len(bits) < 3:
        fails.append(f"grid too small: {len(configs)} configs x "
                     f"{len(policies)} policies x {len(bits)} bit-widths "
                     "(need >= 4 x 5 x 3)")
    if not any(c.get("expected_fail") for c in ccells.values()):
        fails.append("committed matrix has no expected_fail cell — the "
                     "known 2-bit collapse must be recorded honestly")
    results: Dict[str, CellResult] = {}

    def evaluate(env, config, policy, b):
        r = env.evaluate(policy, b, time_decode=False)
        results[r.key] = r
        _check_cell(r, ccells.get(r.key), fails)
        log(f"  {r.key}: oracle_top1={r.oracle_top1:.3f} "
            f"dense_top1={r.dense_top1:.3f}"
            + (" [expected_fail]" if r.expected_fail else ""))

    not_run = _run_cells(device, params, None, evaluate)
    for key, why in not_run.items():
        log(f"  {key}: not run — {why}")
    return MatrixCheck(fails=fails, not_run=not_run, results=results)
