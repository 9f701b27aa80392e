"""Activation-sparsity family: block-compacted float weights plus a
compile-time threshold-ReLU captured into the format itself.

Leaf form ``{"w_ablk": (P, bk, bn) float, "w_atau": () f32}`` plus the
static :class:`BlockSparsePattern` carried out of band; payload form
:class:`ActSparsePayload` (a float CompressedLinear + the threshold).

Weights are block-compacted as the ``sparse`` family's float path, and a
ReLU that follows the layer is sharpened into ``trelu(y, tau) = where(y >
tau, y, 0)``: small positives become exact zeros, so the next layer sees
sparse activations.  The threshold comes from
``CompileRules.act_threshold``.  With ``activation="relu"`` and a
threshold known on the host (a float, or a CPU scalar such as a payload's
unwrapped leaf), the ``("trelu", tau)`` epilogue runs fused in
``block_sparse_matmul``'s emit step.  A threshold that lives on the card
(a compiled model's leaf) is never read back to the host — that would
synchronise the device, and cannot run inside a captured step — so the
kernel runs without an activation and one ``torch.where`` follows it, the
reference's branch for a traced threshold.  With no activation, or
another one, execution is the float sparse path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ..sparsity import CompressedLinear, compress, decompress
from .sparse import _NEED_PATTERN, _sample_pattern, _validate_blocks
from .sparse import _decompress as _sparse_decompress


@dataclasses.dataclass
class ActSparsePayload:
    """Payload form: float block-sparse weights + static threshold."""

    cl: CompressedLinear
    tau: float = 0.0

    @property
    def pattern(self):
        return self.cl.pattern


def _host_tau(tau):
    """The threshold as a Python float when the host holds it, else None
    (a device tensor: reading it would synchronise the card)."""
    if isinstance(tau, torch.Tensor):
        return None if tau.is_cuda else float(tau)
    return float(tau)


# ----------------------------------------------------------------- execute


# the container tag of this family's tuned keys (the reference's)
ACTSPARSE_CONTAINER = "actsparse"


def _apply(p, x, *, pattern, cfg, bias, activation, compute_dtype, leaf,
           tag=""):
    if pattern is None:
        raise ValueError(_NEED_PATTERN)
    act, post_tau = activation, None
    if activation == "relu":
        tau = p["w_atau"]
        t = _host_tau(tau)
        if t is not None:
            act = ("trelu", t)  # fused into the kernel / plain emit step
        else:
            act, post_tau = None, tau
    cl = CompressedLinear(pattern=pattern, blocks=p["w_ablk"])
    K, N = pattern.shape
    y = _d.sparse_linear(x, cl, bias=bias, activation=act,
                         out_dtype=compute_dtype,
                         use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                         plan=_d.tuned_plan(cfg, tag + "sparse", x, K, N,
                                            pattern=pattern, leaf=leaf,
                                            container=ACTSPARSE_CONTAINER))
    if post_tau is not None:
        # trelu with tau >= 0 subsumes the ReLU: negatives are below tau
        y = torch.where(y > post_tau.to(y.dtype), y,
                        torch.zeros((), dtype=y.dtype, device=y.device))
    return y


# ------------------------------------------------------------------ payload


def _matches(payload):
    return isinstance(payload, ActSparsePayload)


def _from_payload(payload):
    if not _matches(payload):
        return None
    # the threshold stays a host scalar: the fused trelu takes it as is
    return {"w_ablk": payload.cl.blocks,
            "w_atau": torch.tensor(payload.tau, dtype=torch.float32)}, \
        payload.cl.pattern


def _payload_dense(payload):
    # the threshold transforms activations, not weights: the dense oracle
    # is the scattered blocks
    return decompress(payload.cl).to(torch.float32)


def _payload_kn(payload):
    return tuple(map(int, payload.cl.pattern.shape))


# --------------------------------------------------------------- decompress


def _decompress(leaf, *, pattern, shape, dtype):
    leaf = {("w_blk" if k == "w_ablk" else k): v
            for k, v in leaf.items() if k != "w_atau"}
    return _sparse_decompress(leaf, pattern=pattern, shape=shape,
                              dtype=dtype)


# ------------------------------------------------------------------- policy


def _threshold_of(rules) -> float:
    tau = float(getattr(rules, "act_threshold", 0.0))
    if tau < 0.0:
        raise ValueError(
            f"actsparse needs a non-negative act_threshold, got {tau} — "
            "trelu(y, tau) only subsumes the ReLU when tau >= 0")
    return tau


def _compile_stack(stack, masks, *, pattern, bits, rules):
    """Block-compact an (L, K, N) stack (float storage) + the threshold."""
    del bits
    tau = _threshold_of(rules)
    L, K, N = stack.shape
    blk_list = []
    total_bytes = 0
    nnz = 0
    for li in range(L):
        cl = compress(stack[li], np.asarray(masks[li]), pattern.block,
                      pattern=pattern, dtype=rules.dtype)
        blk_list.append(cl.blocks)
        total_bytes += cl.blocks.numel() * cl.blocks.element_size()
        nnz += cl.pattern.nnz
    leaves = {"w_ablk": torch.stack(blk_list),
              "w_atau": torch.full((L,), tau, dtype=torch.float32)}
    total_bytes += L * 4
    return leaves, int(total_bytes), int(total_bytes), nnz / (L * K * N)


def _compile_payload(w, mask, *, bits, rules, block):
    del bits
    tau = _threshold_of(rules)
    cl = compress(w, mask, block, dtype=rules.dtype)
    cont_bytes = cl.storage_bytes - cl.pattern.meta_bytes + 4
    return ActSparsePayload(cl=cl, tau=tau), cl.pattern, cont_bytes, \
        cont_bytes, cl.pattern.block_density, cl.pattern.element_density


# ------------------------------------------------------------------ samples


def _sample(rng: np.random.Generator):
    pattern = _sample_pattern(rng)
    P = pattern.n_blocks_present
    bk, bn = pattern.block
    return {"w_ablk": torch.as_tensor(rng.normal(size=(P, bk, bn)),
                                      dtype=torch.float32),
            "w_atau": torch.tensor(0.05, dtype=torch.float32)}, pattern


FAMILY = _reg.register(_reg.PayloadFamily(
    name="actsparse",
    key_leaf="w_ablk",
    leaf_names=("w_ablk", "w_atau"),
    apply=_apply,
    needs_pattern=True,
    matches=_matches,
    from_payload=_from_payload,
    decompress=_decompress,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    leaf_ndim={"w_ablk": 3, "w_atau": 0},
    # stored verbatim: a checkpoint refuses to widen the block container
    container_leaves=("w_ablk",),
    shard_tails={"w_ablk": "pattern", "w_atau": "replicate"},
    legacy_tp=("model", None, None),
    sample=_sample,
    validate=_validate_blocks("actsparse", "w_ablk"),
))

POLICY = _reg.register_policy(_reg.PolicyCompiler(
    name="actsparse",
    eliminates_blocks=True,
    compile_stack=_compile_stack,
    compile_payload=_compile_payload,
))
