"""Block-sparse families: scheduled block stacks (int8 or float) and the
bit-packed block container, plus the ``"sparse"`` policy compiler.

Leaf forms:

* ``sparse``        — ``{"w_blk": (P, bk, bn) [, "w_s": (N,) f32]}``
* ``sparse_packed`` — ``{"w_blkp": (P, ceil(bk/2), bn) uint8, "w_s"}``
  (int4x2) or ``(P, ceil(bk/4), bn)`` (int2x4), packed along the block rows

plus the static :class:`BlockSparsePattern`, carried out of band (the
compile pass's ``patterns`` table).  Payload form:
:class:`repro_torch.core.sparsity.CompressedLinear`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import dispatch as _d
from .. import payload_registry as _reg
from ..quant import (
    PACKED_CONTAINER,
    PackedTensor,
    container_tag,
    pack_codes,
    pack_int4,
    quantize,
    unpack_codes,
)
from ..sparsity import CompressedLinear, compress, decompress, pattern_from_mask
from ...kernels.sparse_matmul.ops import schedule_for
from ._util import fan_in_scales, he_init, int8_codes

_NEED_PATTERN = (
    "sparse linear needs its static pattern — pass the compile_sparse "
    "pattern table through decode_step/prefill_step (patterns=cm.patterns)")


def _apply_sparse(p, x, *, pattern, cfg, bias, activation, compute_dtype,
                  leaf, tag=""):
    if pattern is None:
        raise ValueError(_NEED_PATTERN)
    cl = CompressedLinear(pattern=pattern, blocks=p["w_blk"],
                          scales=p.get("w_s"))
    K, N = pattern.shape
    return _d.sparse_linear(x, cl, bias=bias, activation=activation,
                            out_dtype=compute_dtype,
                            use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                            plan=_d.tuned_plan(cfg, tag + "sparse", x, K, N,
                                               pattern=pattern, leaf=leaf))


def _container_per_byte(rows: int, bk: int):
    """Container width from the packed bk-axis rows: ``ceil(bk/2)`` ->
    int4x2, ``ceil(bk/4)`` -> int2x4.  int4x2 is checked first, so a tiny
    bk where both coincide resolves to the historical container."""
    if rows == (bk + 1) // 2:
        return 2
    if rows == -(-bk // 4):
        return 4
    return None


def _apply_sparse_packed(p, x, *, pattern, cfg, bias, activation,
                         compute_dtype, leaf, tag=""):
    if pattern is None:
        raise ValueError(_NEED_PATTERN)
    wp = p["w_blkp"]
    bk, bn = pattern.block
    per_byte = _container_per_byte(int(wp.shape[-2]), bk)
    if per_byte is None or wp.shape[-1] != bn:
        raise ValueError(
            f"packed sparse container block {tuple(wp.shape[-2:])} does not "
            f"match the pattern block {(bk, bn)} (expected "
            f"({(bk + 1) // 2}, {bn}) for int4x2 or ({-(-bk // 4)}, {bn}) "
            "for int2x4) — w_blkp leaves are packed along bk")
    width = 8 // per_byte
    cl = CompressedLinear(
        pattern=pattern,
        blocks=PackedTensor(data=wp, shape=(int(wp.shape[0]), bk, bn),
                            axis=1, bits=width, per_byte=per_byte),
        scales=p.get("w_s"), bits=width)
    K, N = pattern.shape
    return _d.sparse_linear(x, cl, bias=bias, activation=activation,
                            out_dtype=compute_dtype,
                            use_kernel=_d.use_kernel(cfg, x, leaf), leaf=leaf,
                            plan=_d.tuned_plan(cfg, tag + "sparse", x, K, N,
                                               pattern=pattern, leaf=leaf,
                                               container=container_tag(
                                                   per_byte)))


# ------------------------------------------------------------------ payload


def _matches_packed(payload):
    return isinstance(payload, CompressedLinear) and payload.packed \
        and payload.blocks.axis % 3 == 1


def _from_payload_packed(payload):
    if not _matches_packed(payload):
        return None
    leaves = {"w_blkp": payload.blocks.data}
    if payload.scales is not None:
        leaves["w_s"] = payload.scales
    return leaves, payload.pattern


def _matches(payload):
    return isinstance(payload, CompressedLinear)


def _from_payload(payload):
    if not isinstance(payload, CompressedLinear):
        return None
    # a bn-axis container (odd bk) unpacks to the int8 codes
    blocks = payload.block_values() if payload.packed else payload.blocks
    leaves = {"w_blk": blocks}
    if payload.scales is not None:
        leaves["w_s"] = payload.scales
    return leaves, payload.pattern


def _payload_dense(payload):
    return decompress(payload).to(torch.float32)


def _payload_kn(payload):
    return tuple(map(int, payload.pattern.shape))


# --------------------------------------------------------------- fused conv


def _conv_fused(cp, x, *, cfg, bias, activation, out_dtype, leaf, pool, M):
    """The block_sparse_conv entry (patches gathered in the kernel, pooled
    emit) over a pre-padded VALID input; shared by both container forms.
    ``twin`` returns None: the caller takes the im2col leg.  The
    ``fusedconv_sparse`` tuned lookup is the reference's (M = B·Ho·Wo)."""
    if not _d.use_kernel(cfg, x, leaf):
        return None
    payload = cp.payload
    pat = payload.pattern
    _d.fused_conv_entry(cfg, "fusedconv_sparse", cp, x, M, leaf,
                        payload.blocks.container if payload.packed else None,
                        pat)
    if payload.packed and payload.blocks.axis % 3 == 1 \
            and pat.block[0] % payload.blocks.per_byte == 0:
        blocks, packed = payload.blocks.data, payload.blocks.container
    elif payload.packed:  # a bn-axis container: the int8 codes, unpacked once
        blocks = _d.derived(payload, "block_values", x.device,
                            payload.block_values)
        packed = False
    else:
        blocks, packed = payload.blocks, False
    return _d.block_sparse_conv(
        x.to(out_dtype).contiguous(), blocks, schedule_for(pat, x.device),
        kernel_hw=cp.kernel[:2], scales=payload.scales, bias=bias,
        activation=activation, strides=cp.strides, dilation=cp.dilation,
        pool=pool, packed=packed, name=leaf or "block_sparse_conv")


# --------------------------------------------------------------- decompress


def _decompress(leaf, *, pattern, shape, dtype):
    del shape
    assert pattern is not None, "compiled sparse leaf without a pattern"
    blk = leaf["w_blk"]
    scales = leaf.get("w_s")
    stacked = blk.ndim == 4
    blks = blk if stacked else blk[None]
    scs = None if scales is None else (
        scales if scales.ndim == 2 else scales[None])
    ws = [decompress(CompressedLinear(
        pattern=pattern, blocks=blks[li],
        scales=None if scs is None else scs[li])) for li in range(blks.shape[0])]
    w = torch.stack(ws) if stacked else ws[0]
    out = {k: v for k, v in leaf.items() if k not in ("w_blk", "w_s")}
    out["w"] = w.to(dtype)
    return out


def _decompress_packed(leaf, *, pattern, shape, dtype):
    assert pattern is not None, "compiled sparse leaf without a pattern"
    wp = leaf["w_blkp"]
    bk = pattern.block[0]
    per_byte = _container_per_byte(int(wp.shape[-2]), bk)
    if per_byte is None:
        raise ValueError(
            f"w_blkp container rows {int(wp.shape[-2])} match neither the "
            f"int4x2 ({(bk + 1) // 2}) nor int2x4 ({-(-bk // 4)}) form for "
            f"pattern bk={bk}")
    blk = unpack_codes(wp, bk, axis=-2, bits=8 // per_byte)
    leaf = {**{k: v for k, v in leaf.items() if k != "w_blkp"}, "w_blk": blk}
    return _decompress(leaf, pattern=pattern, shape=shape, dtype=dtype)


# ----------------------------------------------------------------- autotune


def _tune_prepare(leaves, pattern, K):
    """A packed container is timed packed, in its kernel: the leaves as
    they are, and the container tag of their keys."""
    del K
    per_byte = _container_per_byte(int(leaves["w_blkp"].shape[-2]),
                                   pattern.block[0]) or 2
    return dict(leaves), container_tag(per_byte)


def _tune_operands(leaves, pattern):
    """(payload, blocks, packed tag) as the families' apply hands them to
    ``block_sparse_matmul`` through ``sparse_linear``."""
    if "w_blkp" in leaves:
        wp = leaves["w_blkp"]
        bk, bn = pattern.block
        per_byte = _container_per_byte(int(wp.shape[-2]), bk)
        cl = CompressedLinear(
            pattern=pattern,
            blocks=PackedTensor(data=wp, shape=(int(wp.shape[0]), bk, bn),
                                axis=1, bits=8 // per_byte,
                                per_byte=per_byte),
            scales=leaves.get("w_s"), bits=8 // per_byte)
        if bk % per_byte == 0:
            return cl, wp, cl.blocks.container
        return cl, cl.block_values(), False
    cl = CompressedLinear(pattern=pattern, blocks=leaves["w_blk"],
                          scales=leaves.get("w_s"))
    return cl, cl.blocks, False


def _tune_candidates(x, leaves, pattern):
    from ...kernels.sparse_matmul.kernel import bsm_candidates, packed_ratio

    _, blocks, packed = _tune_operands(leaves, pattern)
    bk, bn = pattern.block
    sched = schedule_for(pattern, x.device)
    return bsm_candidates(int(x.shape[0]), bk, bn, packed_ratio(packed),
                          sched.n_col_blocks, sched.max_blocks_per_col,
                          x.dtype == torch.bfloat16, blocks.data_ptr(),
                          blocks.element_size(), x.data_ptr())


def _tune_runner(cand, x, leaves, pattern):
    """One candidate ``(route, plan)`` on ``block_sparse_matmul``, or the
    plain version (None), on the operands of :func:`_tune_operands`."""
    from ...kernels.sparse_matmul.kernel import block_sparse_matmul

    cl, blocks, packed = _tune_operands(leaves, pattern)
    if cand is None:
        return lambda: _d.sparse_linear(x, cl, use_kernel=False)
    sched = schedule_for(pattern, x.device)
    return lambda: block_sparse_matmul(x, blocks, sched, scales=cl.scales,
                                       packed=packed, plan=cand,
                                       name="autotune")


def _leaf_kn(leaves, pattern):
    del leaves
    return tuple(map(int, pattern.shape))


# ------------------------------------------------------------------- policy


def _compile_stack(stack, masks, *, pattern, bits, rules):
    """Compress an (L, K, N) numpy stack onto a shared schedule.

    Returns (leaves, code_bytes, container_bytes, element_density)."""
    L, K, N = stack.shape
    block = pattern.block
    blk_list, scale_list = [], []
    total_bytes = 0
    nnz = 0
    for li in range(L):
        wl = stack[li]
        ml = np.asarray(masks[li])
        if rules.quantize_sparse:
            qt = quantize(torch.from_numpy(wl * ml), bits, axis=1)
            cl = compress(wl, ml, block, pattern=pattern,
                          quant_scales=qt.scales.reshape(-1).numpy(),
                          quant_bits=bits)
            scale_list.append(cl.scales)
            total_bytes += cl.scales.numel() * cl.scales.element_size()
        else:
            cl = compress(wl, ml, block, pattern=pattern, dtype=rules.dtype)
        blk_list.append(cl.blocks)
        total_bytes += cl.blocks.numel() * cl.blocks.element_size()
        nnz += cl.pattern.nnz
    blk = torch.stack(blk_list)
    cont_bytes = total_bytes
    if rules.quantize_sparse and bits <= 4:
        # bit-pack along bk: four per byte for <=2-bit codes when bk divides
        # by 4 (int2x4), else two per byte (int4x2)
        if bits <= 2 and block[0] % 4 == 0:
            w_blkp = pack_codes(blk, axis=2, bits=2)
        else:
            w_blkp = pack_int4(blk, axis=2)
        leaves = {"w_blkp": w_blkp}
        cont_bytes += int(w_blkp.numel()) - int(blk.numel())
    else:
        leaves = {"w_blk": blk}
    if scale_list:
        leaves["w_s"] = torch.stack(scale_list)
    return leaves, int(total_bytes), int(cont_bytes), nnz / (L * K * N)


def _compile_payload(w, mask, *, bits, rules, block):
    """One (K, N) weight to a :class:`CompressedLinear` payload (codes
    bit-packed at <= 4 bits).  Returns (payload, pattern, code_bytes,
    container_bytes, block_density, element_density)."""
    if rules.quantize_sparse:
        qt = quantize(torch.from_numpy(w * mask), bits, axis=1)
        cl = compress(w, mask, block,
                      quant_scales=qt.scales.reshape(-1).numpy(),
                      quant_bits=bits, pack=bits <= 4)
    else:
        cl = compress(w, mask, block, dtype=rules.dtype)
    cont_bytes = cl.storage_bytes - cl.pattern.meta_bytes
    comp_bytes = cont_bytes
    if cl.packed:
        comp_bytes += int(np.prod(cl.blocks.shape)) - int(cl.blocks.data.numel())
    return cl, cl.pattern, comp_bytes, cont_bytes, \
        cl.pattern.block_density, cl.pattern.element_density


# ------------------------------------------------------------------ samples


def _validate_blocks(name, key_leaf):
    """The compacted block leaf must hold exactly the pattern's present
    blocks."""

    def validate(p, pattern):
        w = p.get(key_leaf)
        if w is None or pattern is None:
            return
        P = pattern.n_blocks_present
        if w.shape[-3] != P:
            raise ValueError(
                f"{name} payload: block leaf {key_leaf!r} holds "
                f"{w.shape[-3]} blocks (shape {tuple(w.shape)}) but the "
                f"pattern has {P} present blocks — a truncated or "
                "mismatched block axis would scatter the wrong weights")

    return validate


def _sample_pattern(rng):
    mask = (rng.random(size=(16, 8)) < 0.6).astype(np.float32)
    mask[:8, :4] = 1.0  # keep at least one block fully present
    return pattern_from_mask(mask, (8, 4))


def _sample(rng):
    pattern = _sample_pattern(rng)
    P = pattern.n_blocks_present
    bk, bn = pattern.block
    return {"w_blk": torch.as_tensor(rng.normal(size=(P, bk, bn)),
                                     dtype=torch.float32)}, pattern


def _sample_packed(rng):
    pattern = _sample_pattern(rng)
    P = pattern.n_blocks_present
    bk, bn = pattern.block
    codes = torch.as_tensor(rng.integers(-8, 8, size=(P, bk, bn)),
                            dtype=torch.int8)
    N = pattern.shape[1]
    return {"w_blkp": pack_int4(codes, axis=1),
            "w_s": torch.full((N,), 1.0 / (7 * np.sqrt(16)),
                              dtype=torch.float32)}, pattern


PACKED_FAMILY = _reg.register(_reg.PayloadFamily(
    name="sparse_packed",
    key_leaf="w_blkp",
    leaf_names=("w_blkp", "w_s"),
    apply=_apply_sparse_packed,
    kind="sparse",
    container=PACKED_CONTAINER,
    needs_pattern=True,
    matches=_matches_packed,
    from_payload=_from_payload_packed,
    conv_fused=_conv_fused,
    decompress=_decompress_packed,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    tune_prepare=_tune_prepare,
    leaf_ndim={"w_blkp": 3, "w_s": 1},
    container_leaves=("w_blkp",),
    shard_tails={"w_blkp": "pattern"},
    legacy_tp=("model", None, None),
    sample=_sample_packed,
    validate=_validate_blocks("sparse_packed", "w_blkp"),
))

def _init_sparse(gen, K, N, *, dtype, pattern, lead):
    assert pattern is not None
    bk, bn = pattern.block
    return {"w_blk": he_init(gen, lead + (pattern.n_blocks_present, bk, bn),
                             dtype, K * pattern.block_density)}


def _init_sparse_int8(gen, K, N, *, dtype, pattern, lead):
    del dtype
    assert pattern is not None
    bk, bn = pattern.block
    return {"w_blk": int8_codes(gen, lead + (pattern.n_blocks_present, bk,
                                             bn)),
            "w_s": fan_in_scales(gen, lead + (N,), K)}


FAMILY = _reg.register(_reg.PayloadFamily(
    name="sparse",
    key_leaf="w_blk",
    leaf_names=("w_blk", "w_s"),
    apply=_apply_sparse,
    kind="sparse",
    needs_pattern=True,
    matches=_matches,
    from_payload=_from_payload,
    conv_fused=_conv_fused,
    decompress=_decompress,
    payload_dense=_payload_dense,
    payload_kn=_payload_kn,
    tune_candidates=_tune_candidates,
    tune_runner=_tune_runner,
    leaf_kn=_leaf_kn,
    leaf_ndim={"w_blk": 3, "w_s": 1},
    # float blocks on the unquantised path, int8 codes with w_s scales
    leaf_dtype_kinds={"w_blk": "fi"},
    shard_tails={"w_blk": "pattern"},
    legacy_tp=("model", None, None),
    sample=_sample,
    validate=_validate_blocks("sparse", "w_blk"),
    init_modes={"sparse": _init_sparse, "sparse_int8": _init_sparse_int8},
))

POLICY = _reg.register_policy(_reg.PolicyCompiler(
    name="sparse",
    eliminates_blocks=True,
    compile_stack=_compile_stack,
    compile_payload=_compile_payload,
))
