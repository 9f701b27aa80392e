"""Whole-model compression pass — one canonical compressed representation.

``compile_model`` takes a transformer parameter tree (plus optional
per-leaf keep-masks) and lowers every attention/MLP linear onto the
engine-free datapath under its per-leaf policy:

* ``dense``  — the weight kept as is;
* ``quant``  — per-output-channel int codes (``{"w_q", "w_s"}``, or the
  bit-packed ``{"w_qp", "w_s"}`` at 4 bits);
* ``sparse`` — block-compacted codes against one shared
  :class:`BlockSparsePattern` per (K, N) shape (``{"w_blk"[, "w_s"]}``, or
  ``{"w_blkp", "w_s"}`` bit-packed at <= 4 bits).

The shared bitmap scores blocks by their L1 mass summed over the layer
stack; inside surviving blocks every layer keeps its own unstructured
element mask.  The analysis runs in host numpy with the reference's exact
arithmetic, so policies, patterns, codes, scales and containers equal
``repro.core.compile_sparse``'s byte for byte.

``compile_lenet`` (the paper's Table-I LeNet-5) and ``compile_conv`` lower
per-name layers — convolutions included — onto payload objects: a conv's
``(kh, kw, cin, cout)`` weight becomes its ``(cin*kh*kw, cout)`` im2col
matrix (:func:`conv_weight_matrix`), compiled like a linear and wrapped in
a :class:`repro_torch.core.dispatch.ConvPayload` with its geometry.

A leaf without a ``policies`` entry takes :func:`choose_policy`'s pick: a
roofline over :mod:`repro_torch.core.cost_model` (decode-shaped by default;
a conv leaf's MACs scale by its output H·W).  ``CompileRules.hw`` defaults
to the reference's ``TPU_V5E``, so the same weights give the reference's
policies; ``H100_SXM`` is opt-in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_leaves
from . import payload_registry
from .cost_model import HWSpec, LayerSpec, TPU_V5E, decode_linear_spec, \
    layer_latency
from .dispatch import ConvPayload, conv_out_hw
from .families._util import to_numpy_f32
from .folding import FoldingConfig
from .sparsity import (
    BlockSparsePattern,
    pattern_from_bitmap,
    pattern_from_mask,
)

__all__ = [
    "CompileRules",
    "CompressedModel",
    "LayerReport",
    "choose_policy",
    "compile_conv",
    "compile_lenet",
    "compile_model",
    "compile_policies",
    "conv_weight_matrix",
    "conv_weight_unmatrix",
    "decompress_model",
    "realised_densities",
]

_LINEAR_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
_LINEAR_SUBTREES = ("attn", "mlp", "shared")

# accepted as an override value beside compile_policies(): the pick and
# the bit-width come from autotune.tuned_policy
AUTOTUNE_POLICY = "autotune"


def compile_policies() -> Tuple[str, ...]:
    """Valid per-layer policies: ``"dense"`` plus every registered policy
    compiler."""
    return ("dense",) + payload_registry.policy_names()


@dataclasses.dataclass(frozen=True)
class CompileRules:
    """Knobs of the compression pass (all compile-time)."""

    block: Tuple[int, int] = (128, 128)   # clipped per-shape to (K, N)
    quant_bits: int = 8
    block_density: float = 0.25           # target when deriving masks
    in_block_density: float = 1.0         # unstructured level inside blocks
    batch_tokens: int = 1                 # cost-model shape (decode default)
    hw: HWSpec = TPU_V5E                  # cost-model machine
    min_weight_elems: int = 4096          # below this: always dense
    quantize_sparse: bool = True          # sparse blocks stored as int codes
    dtype: Any = torch.float32            # float storage dtype (non-quant)
    policies: Optional[Dict[str, str]] = None  # per-leaf-name override
    # threshold captured into the "actsparse" family: a following ReLU is
    # sharpened to trelu(y, tau) so small positives become exact zeros
    act_threshold: float = 0.0


@dataclasses.dataclass
class LayerReport:
    name: str
    policy: str
    shape: Tuple[int, int]
    n_layers: int
    dense_bytes: int
    compressed_bytes: int        # int8-container accounting (codes + scales)
    block_density: float
    element_density: float
    kind: str = "linear"         # "linear" | "conv"
    m_scale: int = 1             # matmul rows per batch row (conv: H_out*W_out)
    # bytes the payload holds in memory (bit-packed leaves: their uint8
    # containers); None = same as compressed_bytes
    container_bytes: Optional[int] = None

    @property
    def realised_bytes(self) -> int:
        return self.compressed_bytes if self.container_bytes is None \
            else self.container_bytes


@dataclasses.dataclass
class CompressedModel:
    """``params`` drop into ``decode_step`` / ``prefill_step`` /
    ``ServeEngine`` together with ``patterns``, the static side-table
    (K, N) -> BlockSparsePattern.  For LeNet-style models ``layers`` holds
    the per-name payloads (``lenet_forward(..., compressed=cm.layers)``)
    and ``fusion`` the fusion plan derived at compile time."""

    params: Any
    patterns: Dict[Tuple[int, int], BlockSparsePattern]
    report: List[LayerReport]
    layers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fusion: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def storage_bytes(self) -> int:
        """Int8-container accounting: payload bytes of every layer plus
        each shared schedule's metadata once."""
        return sum(r.compressed_bytes for r in self.report) \
            + sum(p.meta_bytes for p in self.patterns.values())

    @property
    def container_storage_bytes(self) -> int:
        """Bytes the compiled model holds: bit-packed leaves count their
        uint8 containers."""
        return sum(r.realised_bytes for r in self.report) \
            + sum(p.meta_bytes for p in self.patterns.values())

    @property
    def dense_bytes(self) -> int:
        return sum(r.dense_bytes for r in self.report)

    @property
    def compression(self) -> float:
        return self.dense_bytes / max(1, self.storage_bytes)

    @property
    def byte_compression(self) -> float:
        return self.dense_bytes / max(1, self.container_storage_bytes)

    def policy_of(self, name: str) -> str:
        for r in self.report:
            if r.name == name:
                return r.policy
        raise KeyError(name)


# ------------------------------------------------------- conv <-> matrix


def conv_weight_matrix(w4: np.ndarray) -> np.ndarray:
    """(kh, kw, cin, cout) conv weight (or boolean mask) -> its
    (cin*kh*kw, cout) im2col matrix, channel major then kh, kw."""
    kh, kw, cin, cout = w4.shape
    return w4.transpose(2, 0, 1, 3).reshape(cin * kh * kw, cout)


def conv_weight_unmatrix(w2: torch.Tensor,
                         kernel: Tuple[int, int, int, int]) -> torch.Tensor:
    """Inverse of :func:`conv_weight_matrix`: (K, N) -> (kh, kw, cin, cout)."""
    kh, kw, cin, cout = kernel
    return w2.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3)


def _fit_block(K: int, N: int, block: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """Clip the rule block to the shape; None if it cannot tile (K, N)."""
    bk, bn = min(block[0], K), min(block[1], N)
    if bk < 1 or bn < 1 or K % bk or N % bn:
        return None
    return bk, bn


def _shared_bitmap(stack: np.ndarray, block: Tuple[int, int],
                   block_density: float) -> np.ndarray:
    """One block bitmap for a whole (L, K, N) stack: score by summed |w|."""
    L, K, N = stack.shape
    bk, bn = block
    score = np.abs(stack).reshape(L, K // bk, bk, N // bn, bn).sum(axis=(0, 2, 4))
    n_total = score.size
    n_keep = max(1, int(np.ceil(block_density * n_total)))
    flat = score.ravel()
    keep = np.argpartition(flat, n_total - n_keep)[n_total - n_keep:]
    bitmap = np.zeros(n_total, dtype=bool)
    bitmap[keep] = True
    return bitmap.reshape(score.shape)


def _element_mask(w: np.ndarray, bitmap: np.ndarray, block: Tuple[int, int],
                  in_block_density: float) -> np.ndarray:
    """Per-layer element mask under a fixed bitmap; >= 1 element survives in
    every present block."""
    K, N = w.shape
    bk, bn = block
    gb = w.reshape(K // bk, bk, N // bn, bn)
    if in_block_density >= 1.0:
        em = np.broadcast_to(bitmap[:, None, :, None], gb.shape)
        return em.reshape(K, N).copy()
    k_in = max(1, int(np.ceil(in_block_density * bk * bn)))
    m4 = np.zeros(gb.shape, dtype=bool)
    for r, c in zip(*np.nonzero(bitmap)):
        blk = np.abs(gb[r, :, c, :])
        thr = np.partition(blk.ravel(), blk.size - k_in)[blk.size - k_in]
        m4[r, :, c, :] = blk >= thr
    return m4.reshape(K, N)


def _mask_bitmap(mask: np.ndarray, block: Tuple[int, int]) -> np.ndarray:
    return pattern_from_mask(mask, block).bitmap


def choose_policy(
    K: int,
    N: int,
    *,
    rules: CompileRules,
    block_density: float,
    element_density: float,
    sparse_eligible: bool,
    spec: Optional[LayerSpec] = None,
) -> str:
    """Roofline-based per-layer policy pick (cost-model heuristic).

    Builds a decode-shaped LayerSpec and compares the three datapaths'
    latencies under ``rules.hw``; below ``rules.min_weight_elems`` a leaf
    stays dense.  ``spec`` overrides the default linear-shaped LayerSpec —
    conv leaves pass their own (MACs scaled by output H·W, real activation
    traffic).
    """
    if K * N < rules.min_weight_elems:
        return "dense"
    if spec is None:
        spec = decode_linear_spec(K, N, rules.batch_tokens)
    hw = rules.hw
    lat = {
        "dense": layer_latency(
            spec, FoldingConfig(parallelism=hw.lanes, unroll="factor",
                                quant_bits=16), hw)["total"],
        "quant": layer_latency(
            spec, FoldingConfig(parallelism=hw.lanes, unroll="factor",
                                quant_bits=rules.quant_bits), hw)["total"],
    }
    if sparse_eligible:
        lat["sparse"] = layer_latency(
            spec, FoldingConfig(parallelism=hw.lanes, unroll="sparse",
                                block_density=block_density,
                                element_density=element_density,
                                quant_bits=rules.quant_bits), hw)["total"]
    return min(lat, key=lat.get)


def _decide_policy(name: str, override: Optional[str], K: int, N: int,
                   rules: CompileRules, *,
                   block: Optional[Tuple[int, int]], block_density: float,
                   element_density: float,
                   spec: Optional[LayerSpec] = None) -> Tuple[str, int]:
    """Per-layer (policy, quant_bits): the explicit override, else the
    cost model's pick; ``"autotune"`` defers both to
    :func:`repro_torch.core.autotune.tuned_policy`; a cost-model "sparse"
    falls back to "quant" when the rule block cannot tile the shape.
    ``spec`` carries a conv leaf's cost inputs (see
    :func:`choose_policy`)."""
    valid = compile_policies()
    if override is not None and override not in valid + (AUTOTUNE_POLICY,):
        raise ValueError(
            f"{name}: unknown policy {override!r} — valid: "
            f"{valid + (AUTOTUNE_POLICY,)}")
    if override is not None and block is None and \
            payload_registry.policy_eliminates_blocks(override):
        raise ValueError(
            f"{name}: policy {override!r} was explicitly requested but "
            f"block {rules.block} cannot tile shape {(K, N)} — pick a "
            "dividing block or drop the override")
    if override == AUTOTUNE_POLICY:
        from .autotune import tuned_policy
        return tuned_policy(
            K, N, rules=rules, block_density=block_density,
            element_density=element_density,
            sparse_eligible=block is not None, spec=spec)
    policy = override or choose_policy(
        K, N, rules=rules, block_density=block_density,
        element_density=element_density, sparse_eligible=block is not None,
        spec=spec)
    if policy == "sparse" and block is None:  # cost-model fallback only
        policy = "quant"
    return policy, rules.quant_bits


@dataclasses.dataclass
class _LeafPlan:
    path: str
    parent: dict
    key: str
    shape: Tuple[int, int, int]  # (L, K, N) of the weight stack
    stacked: bool
    mask: Optional[np.ndarray]   # (L, K, N) bool or None
    block: Optional[Tuple[int, int]]
    bitmap: Optional[np.ndarray]
    policy: str
    bits: int
    bd: float
    ed: float


def _f32_stack(w) -> np.ndarray:
    """A weight (K, N) or stack (L, K, N) as a host (L, K, N) f32 array."""
    a = to_numpy_f32(w)
    return a if a.ndim == 3 else a[None]


def _iter_linears(tree: Any, path: str = "", in_linear_subtree: bool = False):
    """Yield (path, parent_dict, key) for every (compiled or raw) linear."""
    if not isinstance(tree, dict):
        return
    weight_leaves = payload_registry.weight_leaf_names()
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if (in_linear_subtree and k in _LINEAR_KEYS and isinstance(v, dict)
                and any(lk in v for lk in weight_leaves)):
            yield p, tree, k
        elif isinstance(v, dict):
            yield from _iter_linears(
                v, p, in_linear_subtree or k in _LINEAR_SUBTREES)


def _copy_spine(tree):
    """Copy the dict structure; tensor leaves are shared, never mutated."""
    if not isinstance(tree, dict):
        return tree
    return {k: _copy_spine(v) for k, v in tree.items()}


def compile_model(
    params: Any,
    cfg: Any,
    *,
    masks: Optional[Dict[str, np.ndarray]] = None,
    rules: CompileRules = CompileRules(),
    device=None,
) -> CompressedModel:
    """Lower a transformer parameter tree (dense, encoder, VLM, MoE or
    hybrid family) onto the compressed datapath; the compiled leaves land
    on ``device`` (CUDA unless ``device="cpu"``).

    ``masks`` maps leaf names ("wq", ...) or full paths ("blocks/attn/wq")
    to (L, K, N) / (K, N) boolean keep-masks; absent entries are derived by
    two-level pruning at ``rules.block_density`` x
    ``rules.in_block_density``.

    As in the reference, the MoE routed experts (``eg`` / ``eu`` / ``ed``)
    and the router are not lowered (their dispatch is data-dependent) and
    appear as dense report rows; the shared expert (``moe/shared``)
    compiles like any MLP.  A stub frontend's ``frontend_proj`` stays
    dense and unreported.  For the hybrid only the shared attention block
    (``shared_attn``, unstacked (K, N) leaves) and the head are lowered;
    its Mamba2 super-blocks stay dense, one aggregate report row.  The SSM
    family is refused, as by the reference: its projections are not
    lowered, so there is nothing to compile.
    """
    if cfg.family not in ("dense", "encoder", "vlm", "moe", "hybrid"):
        raise NotImplementedError(
            f"compile_model supports attention/MLP families, got "
            f"{cfg.family} — the reference does not lower the SSM "
            "family's projections")
    dev = resolve_device(device)
    patterns: Dict[Tuple[int, int], BlockSparsePattern] = {}
    report: List[LayerReport] = []
    consumed_mask_keys, consumed_policy_keys = set(), set()

    def _lookup(table, path, leaf, consumed):
        if not table:
            return None
        key = path if path in table else (leaf if leaf in table else None)
        if key is None:
            return None
        consumed.add(key)
        return table[key]

    new_params = _copy_spine(params)
    sites = []
    roots = [] if cfg.family == "hybrid" else ["blocks"]
    if "shared_attn" in params:
        roots.append("shared_attn")
    for root in roots:
        sites.extend(_iter_linears(new_params[root], root))
    if isinstance(params.get("head"), dict) and any(
            lk in params["head"]
            for lk in payload_registry.weight_leaf_names()):
        sites.append(("head", new_params, "head"))

    # Phase A — analyse each leaf: policy + (for sparse) its own bitmap.
    # A leaf's f32 host stack is made where it is needed and dropped after
    # (Phase C makes it again), so the host holds one stack at a time, not
    # the whole model in f32.
    plans: List[_LeafPlan] = []
    for path, parent, key in sites:
        leaf = parent[key]
        if "w" not in leaf:
            raise ValueError(
                f"{path}: leaf is already compiled ({sorted(leaf)}); "
                "compile_model expects a raw dense parameter tree — use "
                "decompress_model() first to recompile")
        stacked = len(leaf["w"].shape) == 3
        L, K, N = tuple(leaf["w"].shape) if stacked \
            else (1,) + tuple(leaf["w"].shape)
        m = _lookup(masks, path, key, consumed_mask_keys)
        mask = None
        if m is not None:
            mask = np.asarray(m, bool)
            mask = mask if mask.ndim == 3 else mask[None]
            if mask.shape[1:] != (K, N) or mask.shape[0] not in (1, L):
                raise ValueError(
                    f"{path}: mask shape {mask.shape} does not match "
                    f"weight stack {(L, K, N)}")
            if mask.shape[0] == 1 and L > 1:
                mask = np.broadcast_to(mask, (L, K, N)).copy()
        block = _fit_block(K, N, rules.block)
        bitmap = None
        if mask is not None and block is not None:
            bitmap = _mask_bitmap(mask[0], block)
            for ml in mask[1:]:
                bitmap |= _mask_bitmap(ml, block)
            bd = bitmap.sum() / bitmap.size
            ed = mask.sum() / mask.size
        else:
            bd = rules.block_density
            ed = rules.block_density * rules.in_block_density
        policy, bits = _decide_policy(
            path, _lookup(rules.policies, path, key, consumed_policy_keys),
            K, N, rules, block=block, block_density=bd, element_density=ed)
        if payload_registry.policy_eliminates_blocks(policy) and bitmap is None:
            bitmap = _shared_bitmap(_f32_stack(leaf["w"]), block,
                                    rules.block_density)
            bd = bitmap.sum() / bitmap.size
        plans.append(_LeafPlan(path, parent, key, (L, K, N), stacked, mask,
                               block, bitmap, policy, bits, float(bd),
                               float(ed)))

    valid = sorted(pl.path for pl in plans)
    unused = set(masks or {}) - consumed_mask_keys
    if unused:
        raise ValueError(
            f"masks keys matched no linear leaf: {sorted(unused)} — valid "
            f"keys are leaf names or full paths from {valid}; a typo here "
            "would silently drop pruning")
    unused = set(rules.policies or {}) - consumed_policy_keys
    if unused:
        raise ValueError(
            f"policies keys matched no linear leaf: {sorted(unused)} — "
            f"valid keys are leaf names or full paths from {valid}")

    # Phase B — one pattern per (K, N) shape: union of the leaf bitmaps.
    for pl in plans:
        if not payload_registry.policy_eliminates_blocks(pl.policy):
            continue
        K, N = pl.shape[1:]
        prev = patterns.get((K, N))
        bitmap = pl.bitmap.copy() if prev is None else prev.bitmap | pl.bitmap
        patterns[(K, N)] = pattern_from_bitmap((K, N), pl.block, bitmap)

    # Phase C — rewrite the leaves.
    for pl in plans:
        leaf = pl.parent[pl.key]
        L, K, N = pl.shape
        w0 = leaf["w"]
        dense_bytes = int(w0.numel() * w0.element_size())
        out = {k: v for k, v in leaf.items() if k != "w"}
        bd, ed = pl.bd, pl.ed
        eliminates = payload_registry.policy_eliminates_blocks(pl.policy)
        if not eliminates:
            bd = 1.0
            ed = 1.0 if pl.mask is None else pl.mask.sum() / pl.mask.size
        if pl.policy == "dense":
            if pl.mask is None:
                out["w"] = w0.to(dev)
            else:
                masked = _f32_stack(w0) * pl.mask
                w = masked if pl.stacked else masked[0]
                out["w"] = torch.from_numpy(w).to(device=dev, dtype=w0.dtype)
            comp_bytes = cont_bytes = dense_bytes
        else:
            pc = payload_registry.policy_compiler(pl.policy)
            mask, pattern = pl.mask, None
            stack = _f32_stack(w0)
            if eliminates:
                if mask is None:
                    mask = np.stack([
                        _element_mask(wl, pl.bitmap, pl.block,
                                      rules.in_block_density)
                        for wl in stack])
                pattern = patterns[(K, N)]
            leaves, comp_bytes, cont_bytes, ed_r = pc.compile_stack(
                stack, mask, pattern=pattern, bits=pl.bits, rules=rules)
            del stack, mask
            if ed_r is not None:
                ed = ed_r
            if pattern is not None:
                bd = pattern.block_density
            if not pl.stacked:
                leaves = {k: v[0] for k, v in leaves.items()}
            out.update({k: v.to(dev) for k, v in leaves.items()})
        pl.parent[pl.key] = out
        report.append(LayerReport(
            name=pl.path, policy=pl.policy, shape=(K, N), n_layers=L,
            dense_bytes=dense_bytes, compressed_bytes=int(comp_bytes),
            block_density=float(bd), element_density=float(ed),
            container_bytes=int(cont_bytes)))

    # the weights left dense on purpose (MoE routed experts + router), so
    # ``compression`` covers the whole model
    if cfg.family == "moe":
        moe = params["blocks"].get("moe", {})
        for k in ("router", "eg", "eu", "ed"):
            if isinstance(moe.get(k), dict) and "w" in moe[k]:
                w = moe[k]["w"]
                b = int(w.numel() * w.element_size())
                report.append(LayerReport(
                    name=f"blocks/moe/{k}", policy="dense",
                    shape=tuple(int(d) for d in w.shape[-2:]),
                    n_layers=math.prod(int(d) for d in w.shape[:-2]),
                    dense_bytes=b, compressed_bytes=b, block_density=1.0,
                    element_density=1.0))
    if cfg.family == "hybrid":
        # the Mamba2 super-blocks, not lowered: one aggregate dense row
        b = sum(int(t.numel() * t.element_size())
                for t in tree_leaves(params["blocks"]))
        report.append(LayerReport(
            name="blocks (ssm, not lowered)", policy="dense", shape=(0, 0),
            n_layers=0, dense_bytes=b, compressed_bytes=b,
            block_density=1.0, element_density=1.0))
    return CompressedModel(params=new_params, patterns=patterns, report=report)


# ------------------------------------------------------- per-name layers


def _payload_to(payload: Any, dev: torch.device) -> Any:
    """A compiled payload object with every tensor moved to ``dev`` (the
    payload dataclasses of every family; patterns stay host metadata)."""
    if isinstance(payload, torch.Tensor):
        return payload.to(dev)
    if not dataclasses.is_dataclass(payload) \
            or isinstance(payload, BlockSparsePattern):
        return payload
    return dataclasses.replace(payload, **{
        f.name: _payload_to(getattr(payload, f.name), dev)
        for f in dataclasses.fields(payload) if f.init})


def _conv_mask(name: str, mask, kernel, K: int, N: int,
               kind: str) -> Optional[np.ndarray]:
    """A layer mask as an im2col (K, N) bool array; conv masks may be
    kernel-shaped (kh, kw, cin, cout)."""
    if mask is None:
        return None
    mask = np.asarray(mask, bool)
    if kind == "conv" and mask.ndim == 4:
        if mask.shape != tuple(kernel):
            raise ValueError(
                f"{name}: conv mask shape {mask.shape} does not match the "
                f"kernel {tuple(kernel)}")
        mask = conv_weight_matrix(mask)
    if mask.shape != (K, N):
        raise ValueError(
            f"{name}: mask shape {mask.shape} does not match the layer — "
            f"expected {(K, N)}"
            + (f" (im2col) or kernel-shaped {tuple(kernel)}"
               if kind == "conv" else ""))
    return mask


def _compile_one(name: str, w: np.ndarray, mask: Optional[np.ndarray],
                 override: Optional[str], rules: "CompileRules",
                 block_rule: Tuple[int, int], dev: torch.device,
                 spec: Optional[LayerSpec] = None):
    """analyse -> decide -> pack for one (K, N) weight, as the reference's
    ``compile_lenet`` / ``compile_conv`` loop body (``spec``: a conv leaf's
    cost-model inputs).  Returns (payload or None, pattern or None, policy,
    bd, ed, code_bytes, container_bytes)."""
    K, N = w.shape
    block = _fit_block(K, N, block_rule)
    if mask is not None and block is not None:
        bitmap = _mask_bitmap(mask, block)
        bd, ed = bitmap.sum() / bitmap.size, mask.sum() / mask.size
    else:
        bd = rules.block_density
        ed = rules.block_density * rules.in_block_density
    policy, bits = _decide_policy(name, override, K, N, rules, block=block,
                                  block_density=bd, element_density=ed,
                                  spec=spec)
    dense_bytes = K * N * 4
    eliminates = payload_registry.policy_eliminates_blocks(policy)
    if not eliminates:
        bd = 1.0
        ed = 1.0 if mask is None else mask.sum() / mask.size
    payload, pattern = None, None
    if policy == "dense":
        if mask is not None:  # masked dense payload (plain tensor)
            payload = torch.from_numpy(w * mask)
        comp_bytes = cont_bytes = dense_bytes
    else:
        pc = payload_registry.policy_compiler(policy)
        if eliminates and mask is None:
            bitmap = _shared_bitmap(w[None], block, rules.block_density)
            mask = _element_mask(w, bitmap, block, rules.in_block_density)
        payload, pattern, comp_bytes, cont_bytes, bd_r, ed_r = \
            pc.compile_payload(w, mask, bits=bits, rules=rules, block=block)
        if bd_r is not None:
            bd = bd_r
        if ed_r is not None:
            ed = ed_r
    if payload is not None:
        payload = _payload_to(payload, dev)
    return payload, pattern, policy, bd, ed, comp_bytes, cont_bytes


def compile_lenet(
    params: Dict[str, Any],
    masks: Optional[Dict[str, Any]] = None,
    *,
    rules: CompileRules = CompileRules(block=(8, 4), min_weight_elems=512),
    blocks: Optional[Dict[str, Tuple[int, int]]] = None,
    device=None,
) -> CompressedModel:
    """Compress the whole LeNet-5 — convs and FC layers (Table-I workload).

    Every layer runs the same analyse -> decide -> pack pipeline; a conv is
    lowered onto its im2col matrix.  ``layers`` plugs into
    ``lenet_forward(params, x, compressed=cm.layers)``: a
    :class:`CompressedLinear` (sparse), :class:`QuantizedTensor` /
    :class:`PackedTensor` (quant) or masked dense tensor per linear, the
    same wrapped in a :class:`ConvPayload` per conv; an unmasked dense
    layer is absent.  Conv masks may be kernel-shaped or im2col-shaped; a
    ``masks`` / ``policies`` / ``blocks`` key naming no layer raises.
    The payloads land on ``device`` (CUDA unless ``device="cpu"``).
    """
    from ..models.lenet import (CONV_OUT_HW, LAYERS, lenet_fusion_plan,
                                lenet_layer_specs)

    dev = resolve_device(device)
    names = [n for n, _, _ in LAYERS]
    for label, d in (("masks", masks), ("policies", rules.policies),
                     ("blocks", blocks)):
        unknown = set(d or {}) - set(names)
        if unknown:
            raise ValueError(
                f"{label} keys matched no LeNet layer: {sorted(unknown)} — "
                f"compile_lenet lowers every layer of {names} (convs "
                "included); a typo here would silently drop the override")
    specs = {s.name: s for s in lenet_layer_specs(batch=rules.batch_tokens)}
    patterns: Dict[Tuple[int, int], BlockSparsePattern] = {}
    report: List[LayerReport] = []
    layers: Dict[str, Any] = {}
    for name, kind, shape in LAYERS:
        w = to_numpy_f32(params[name + "_w"])
        if kind == "conv":
            K, N = shape[0] * shape[1] * shape[2], shape[3]
            w = conv_weight_matrix(w)
            m_scale = int(np.prod(CONV_OUT_HW[name]))
            spec = specs[name]
        else:
            K, N = shape
            m_scale = 1
            spec = None  # linear leaves keep the default decode-shaped spec
        mask = _conv_mask(name, None if not masks else masks.get(name),
                          shape, K, N, kind)
        payload, pat, policy, bd, ed, comp_bytes, cont_bytes = _compile_one(
            name, w, mask, (rules.policies or {}).get(name), rules,
            (blocks or {}).get(name, rules.block), dev, spec)
        if pat is not None:
            patterns[(K, N)] = pat
        if payload is not None:
            layers[name] = (ConvPayload(payload=payload, kernel=tuple(shape))
                            if kind == "conv" else payload)
        report.append(LayerReport(
            name=name, policy=policy, shape=(K, N), n_layers=1,
            dense_bytes=K * N * 4, compressed_bytes=int(comp_bytes),
            block_density=float(bd), element_density=float(ed), kind=kind,
            m_scale=m_scale, container_bytes=int(cont_bytes)))
    return CompressedModel(params=params, patterns=patterns, report=report,
                           layers=layers, fusion=lenet_fusion_plan(layers))


def compile_conv(
    w4,
    *,
    strides: Tuple[int, int] = (1, 1),
    padding: str = "VALID",
    dilation: Tuple[int, int] = (1, 1),
    mask=None,
    rules: CompileRules = CompileRules(block=(8, 4), min_weight_elems=512),
    policy: Optional[str] = None,
    name: str = "conv",
    in_hw: Optional[Tuple[int, int]] = None,
    device=None,
) -> Tuple[ConvPayload, Optional[BlockSparsePattern], LayerReport]:
    """Compile ONE conv kernel ``(kh, kw, cin, cout)`` to a ConvPayload
    carrying any static ``strides`` / ``padding`` / ``dilation``.

    ``mask`` may be kernel-shaped or im2col-shaped.  ``in_hw`` (the input's
    spatial size) sets the report's ``m_scale``.  A dense policy keeps the
    (masked) im2col matrix as the payload.  Returns ``(conv_payload,
    pattern_or_None, report_row)``.
    """
    dev = resolve_device(device)
    w4 = to_numpy_f32(w4)
    if w4.ndim != 4:
        raise ValueError(
            f"{name}: expected a 4-d conv kernel (kh, kw, cin, cout), got "
            f"shape {w4.shape}")
    kernel = tuple(int(d) for d in w4.shape)
    kh, kw, cin, cout = kernel
    K, N = kh * kw * cin, cout
    w = conv_weight_matrix(w4)
    mask = _conv_mask(name, mask, kernel, K, N, "conv")
    payload, pattern, policy, bd, ed, comp_bytes, cont_bytes = _compile_one(
        name, w, mask, policy, rules, rules.block, dev)
    if payload is None:  # dense and unmasked: the matrix itself
        payload = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
    m_scale = 1
    if in_hw is not None:
        ho, wo = conv_out_hw(tuple(in_hw), (kh, kw), tuple(strides), padding,
                             tuple(dilation))
        m_scale = int(ho * wo)
    cp = ConvPayload(payload=payload, kernel=kernel,
                     strides=tuple(int(s) for s in strides), padding=padding,
                     dilation=tuple(int(d) for d in dilation))
    rep = LayerReport(
        name=name, policy=policy, shape=(K, N), n_layers=1,
        dense_bytes=K * N * 4, compressed_bytes=int(comp_bytes),
        block_density=float(bd), element_density=float(ed), kind="conv",
        m_scale=m_scale, container_bytes=int(cont_bytes))
    return cp, pattern, rep


def realised_densities(cm: CompressedModel) -> Dict[str, Tuple[float, float]]:
    """{layer name: (block_density, element_density)} the pass realised."""
    return {r.name: (float(r.block_density), float(r.element_density))
            for r in cm.report}


def _decompress_leaf(leaf, pattern, dtype, shape=None):
    fam = payload_registry.family_for_leaves(leaf)
    if fam is None or fam.decompress is None:
        return leaf
    return fam.decompress(leaf, pattern=pattern, shape=shape, dtype=dtype)


def decompress_model(cm: CompressedModel, *, dtype=torch.float32) -> Any:
    """Dense oracle: a plain-``w`` tree rebuilt from the compressed one
    (dequantised, blocks scattered back).  For a LeNet-style model
    (``cm.layers``) the param dict with each compressed ``<name>_w``
    replaced by its dense weight."""
    if cm.layers:
        out = dict(cm.params)
        for name, payload in cm.layers.items():
            inner = payload.payload if isinstance(payload, ConvPayload) \
                else payload
            fam = payload_registry.family_of_payload(inner)
            w = fam.payload_dense(inner).to(dtype)
            out[name + "_w"] = conv_weight_unmatrix(w, payload.kernel) \
                if isinstance(payload, ConvPayload) else w
        return out
    shape_of = {r.name: r.shape for r in cm.report}
    out = _copy_spine(cm.params)
    if not isinstance(out.get("blocks"), dict):
        return out   # a LeNet compile with no compressed layer
    for root in ("blocks", "shared_attn"):
        if not isinstance(out.get(root), dict):
            continue
        for path, parent, k in _iter_linears(out[root], root):
            pat = cm.patterns.get(shape_of.get(path))
            parent[k] = _decompress_leaf(parent[k], pat, dtype,
                                         shape=shape_of.get(path))
    if isinstance(out.get("head"), dict):
        out["head"] = _decompress_leaf(
            out["head"], cm.patterns.get(shape_of.get("head")), dtype,
            shape=shape_of.get("head"))
    return out
