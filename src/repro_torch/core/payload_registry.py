"""Payload-family protocol + registry — one description per leaf format.

Every compressed-leaf format the datapath understands is one registered
:class:`PayloadFamily` (leaf names, payload types, execution, structural
lint, decompression), living in one module under
``repro_torch.core.families``.  Dispatch and the compile pass iterate this
registry instead of branching on family names.

Two registries live here: **families** (:func:`register`; match priority is
registration order, so packed container variants come before their unpacked
twins) and **policy compilers** (:func:`register_policy`: how
``compile_sparse`` lowers a weight stack onto a family's leaves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

__all__ = [
    "PayloadFamily",
    "PolicyCompiler",
    "all_families",
    "container_leaf_names",
    "ensure_registered",
    "family_for_leaf_name",
    "family_for_leaves",
    "family_of_payload",
    "init_leaves",
    "init_modes",
    "kind_family",
    "kind_needs_pattern",
    "pattern_leaf",
    "policy_compiler",
    "policy_eliminates_blocks",
    "policy_names",
    "register",
    "register_policy",
    "representative_leaves",
    "shard_info",
    "tunable_kinds",
    "unwrap_payload",
    "validate_leaves",
    "weight_leaf_names",
]


@dataclasses.dataclass(frozen=True)
class PayloadFamily:
    """One compressed-leaf format, self-described.

    * ``name`` / ``key_leaf`` / ``leaf_names`` — identity: a leaf dict
      belongs to the family iff ``key_leaf`` is in it.
    * ``apply(p, x, *, pattern, cfg, bias, activation, compute_dtype,
      leaf)`` — execute ``y = act(x @ W + b)``, kernel or plain version.
    * ``matches(payload)`` — does a payload object belong to the family;
      ``from_payload(payload)`` — its unwrap to ``(leaves, pattern)``
      (None when the payload is not this family's).
    * ``conv_fused(cp, x, *, cfg, bias, activation, out_dtype, leaf,
      pool)`` — the fused conv entry (patches gathered in the kernel) for
      a pre-padded VALID input; None when the family has none.
    * ``decompress(leaf, pattern, shape, dtype)`` — a plain ``{"w"}`` dict;
      ``payload_dense(payload)`` — a payload object densified to (K, N)
      f32; ``payload_kn(payload)`` — its logical (K, N).
    * ``leaf_ndim`` — unstacked ndim per leaf (stacked leaves carry one more
      leading axis); ``leaf_dtype_kinds`` — allowed dtype kinds where the
      storage dtype legitimately varies; ``sample(rng)`` — an exemplar
      ``(leaves, pattern)`` whose dtype kinds pin the others;
      ``validate(leaves, pattern)`` — cross-leaf lint, raising ValueError
      prefixed with the family name.
    * ``container_leaves`` — leaf names whose buffers are bit-exact storage
      containers, which the checkpointer must never widen.
    * ``shard_tails`` — leaf name -> "pattern" (pattern-aware tensor
      parallelism over the packed block axis) or "replicate"; leaves not
      listed follow the path-based rules of
      :mod:`repro_torch.launch.sharding`.  ``legacy_tp`` — the blind
      trailing spec applied to ``key_leaf`` when no pattern side-table is
      given.
    * ``kind`` — the datapath family of the reference's tune keys
      ("sparse" / "quant"; None: not tuned); ``container`` — the storage
      container tag ("int4x2", "int2x4"; None: unpacked); ``code_leaf`` —
      the leaf holding the quantised codes (defaults to ``key_leaf``).
    * The autotuner's hooks: ``tune_prepare(leaves, pattern, K)`` — the
      leaves the tuner times and their container tag (bit-packed families:
      the packed leaves as they are, timed in their kernel);
      ``tune_candidates(x, leaves, pattern)`` — the kernel's ``(route,
      plan)`` candidates at those operands, the rule's first;
      ``tune_runner(cand, x, leaves, pattern)`` — a thunk running one
      candidate (None: the plain version); ``leaf_kn(leaves, pattern)`` —
      the leaves' (K, N).  The last three live on each kind's unpacked
      family (:func:`kind_family`), which runs every container of the kind.
    * ``init_modes`` — ``models.blocks.linear_init`` mode name ->
      ``fn(generator, K, N, *, dtype, pattern, lead) -> leaves``: random
      leaves in the family's form drawn from a ``torch.Generator`` on its
      device, each with the leading axes ``lead`` (a layer stack).
    """

    name: str
    key_leaf: str
    leaf_names: Tuple[str, ...]
    apply: Optional[Callable] = None
    kind: Optional[str] = None
    container: Optional[str] = None
    needs_pattern: bool = False
    code_leaf: Optional[str] = None
    matches: Optional[Callable] = None
    from_payload: Optional[Callable] = None
    conv_fused: Optional[Callable] = None
    decompress: Optional[Callable] = None
    payload_dense: Optional[Callable] = None
    payload_kn: Optional[Callable] = None
    leaf_ndim: Mapping[str, int] = dataclasses.field(default_factory=dict)
    sample: Optional[Callable] = None
    validate: Optional[Callable] = None
    leaf_dtype_kinds: Mapping[str, str] = dataclasses.field(
        default_factory=dict)
    container_leaves: Tuple[str, ...] = ()
    shard_tails: Mapping[str, str] = dataclasses.field(default_factory=dict)
    legacy_tp: Optional[Tuple] = None
    tune_prepare: Optional[Callable] = None
    tune_candidates: Optional[Callable] = None
    tune_runner: Optional[Callable] = None
    leaf_kn: Optional[Callable] = None
    init_modes: Mapping[str, Callable] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.key_leaf not in self.leaf_names:
            raise ValueError(
                f"family {self.name!r}: key_leaf {self.key_leaf!r} must be "
                f"one of its leaf_names {self.leaf_names}")
        if self.code_leaf is None:
            object.__setattr__(self, "code_leaf", self.key_leaf)


@dataclasses.dataclass(frozen=True)
class PolicyCompiler:
    """How ``compile_sparse`` lowers weights under one policy name.

    ``compile_stack(stack, masks, *, pattern, bits, rules)`` takes an
    (L, K, N) numpy stack to ``(leaves, code_bytes, container_bytes, ed)``;
    ``compile_payload(w, mask, *, bits, rules, block)`` takes one (K, N)
    weight to ``(payload, pattern, code_bytes, container_bytes, bd, ed)``
    for the payload-style passes (``compile_lenet`` / ``compile_conv``;
    ``pattern``/``bd``/``ed`` are None for families without one);
    ``eliminates_blocks`` marks policies compacted against a shared
    :class:`BlockSparsePattern`.
    """

    name: str
    eliminates_blocks: bool = False
    compile_stack: Optional[Callable] = None
    compile_payload: Optional[Callable] = None


_FAMILIES: Dict[str, PayloadFamily] = {}
_ORDER: List[PayloadFamily] = []
_POLICIES: Dict[str, PolicyCompiler] = {}


def register(family: PayloadFamily) -> PayloadFamily:
    """Register a family; match priority is registration order."""
    if family.name in _FAMILIES:
        raise ValueError(f"payload family {family.name!r} already registered")
    for prev in _ORDER:
        if prev.key_leaf == family.key_leaf:
            raise ValueError(
                f"payload family {family.name!r} reuses key leaf "
                f"{family.key_leaf!r} already claimed by {prev.name!r}")
    _FAMILIES[family.name] = family
    _ORDER.append(family)
    return family


def register_policy(pc: PolicyCompiler) -> PolicyCompiler:
    if pc.name in _POLICIES:
        raise ValueError(f"policy compiler {pc.name!r} already registered")
    _POLICIES[pc.name] = pc
    return pc


def ensure_registered() -> None:
    """Import the built-in family modules (idempotent)."""
    if not _FAMILIES:
        from . import families  # noqa: F401  (registers on import)


def all_families() -> Tuple[PayloadFamily, ...]:
    ensure_registered()
    return tuple(_ORDER)


def family_for_leaves(p: Mapping[str, Any]) -> Optional[PayloadFamily]:
    """The family owning a parameter-leaf dict (None = no weight leaf)."""
    for fam in all_families():
        if fam.key_leaf in p:
            return fam
    return None


def dtype_kind(dtype: torch.dtype) -> str:
    """'f' float, 'u' unsigned (bit-packed container), 'i' signed codes."""
    if dtype.is_floating_point:
        return "f"
    if dtype in (torch.uint8, torch.bool):
        return "u"
    return "i"


_DTYPE_KINDS: Dict[str, Dict[str, str]] = {}


def _sample_dtype_kinds(fam: PayloadFamily) -> Dict[str, str]:
    kinds = _DTYPE_KINDS.get(fam.name)
    if kinds is None:
        if fam.sample is None:
            kinds = {}
        else:
            import numpy as np

            leaves, _ = fam.sample(np.random.default_rng(0))
            kinds = {k: dtype_kind(v.dtype) for k, v in leaves.items()}
        _DTYPE_KINDS[fam.name] = kinds
    return kinds


_KIND_DESC = {"f": "float", "i": "signed-integer (codes)",
              "u": "unsigned-integer (bit-packed container)"}

# signatures (family, leaf shapes/dtypes, pattern geometry) already linted:
# validation reads metadata only, so a signature that passed once passes
# again, and the per-call cost in eager execution is one dict lookup
_VALIDATED: set = set()


def _signature(fam: PayloadFamily, p: Mapping[str, Any], pattern: Any):
    leaves = tuple((k, tuple(v.shape), v.dtype) for k, v in p.items()
                   if hasattr(v, "dtype"))
    pat = None if pattern is None else (
        tuple(pattern.shape), tuple(pattern.block), pattern.n_blocks_present)
    return fam.name, leaves, pat


def validate_leaves(p: Mapping[str, Any],
                    pattern: Any = None) -> Optional[PayloadFamily]:
    """Structural lint of a compressed leaf dict before execution.

    Checks per-leaf ndim against ``leaf_ndim`` (one extra leading axis
    allowed for stacked leaves), per-leaf dtype kind against the family's
    exemplar, then the family's own ``validate`` hook.  Raises ValueError
    naming the family and leaf; returns the matched family (None when no
    weight leaf is present).  Metadata only, and memoised on it.
    """
    fam = family_for_leaves(p)
    if fam is None:
        return None
    sig = _signature(fam, p, pattern)
    if sig in _VALIDATED:
        return fam
    kinds = _sample_dtype_kinds(fam)
    for k, v in p.items():
        if k not in fam.leaf_names or not hasattr(v, "dtype"):
            continue
        nd = fam.leaf_ndim.get(k)
        if nd is not None and v.ndim not in (nd, nd + 1):
            raise ValueError(
                f"{fam.name} payload: leaf {k!r} has ndim {v.ndim} "
                f"(shape {tuple(v.shape)}), expected {nd} (or {nd + 1} "
                "stacked) — this leaf does not belong to the family's "
                "declared geometry")
        want = fam.leaf_dtype_kinds.get(k) or kinds.get(k)
        got = dtype_kind(v.dtype)
        if want is not None and got not in want:
            desc = " or ".join(_KIND_DESC.get(w, w) for w in want)
            raise ValueError(
                f"{fam.name} payload: leaf {k!r} has dtype {v.dtype}, "
                f"expected a {desc} leaf — a cast (checkpoint widening "
                "/ dtype drift) corrupted the stored format")
    if fam.validate is not None:
        fam.validate(p, pattern)
    _VALIDATED.add(sig)
    return fam


def init_modes() -> Dict[str, Callable]:
    """Every registered family's init modes (a later family's name wins, as
    in the reference's registry)."""
    modes: Dict[str, Callable] = {}
    for fam in all_families():
        modes.update(fam.init_modes)
    return modes


def init_leaves(mode: str, generator: torch.Generator, K: int, N: int, *,
                dtype, pattern=None, lead: Tuple[int, ...] = ()
                ) -> Dict[str, Any]:
    """Random leaves of one (K, N) linear in init mode ``mode`` (with the
    leading axes ``lead``), for ``models.blocks.linear_init``: each family
    contributes its modes, so a new format is initialisable without
    touching the model code."""
    modes = init_modes()
    if mode not in modes:
        raise ValueError(
            f"unknown linear mode {mode!r} — registered: {sorted(modes)}")
    return modes[mode](generator, K, N, dtype=dtype, pattern=pattern,
                       lead=tuple(lead))


def family_for_leaf_name(name: str) -> Optional[PayloadFamily]:
    """The family that emits leaf ``name`` (key leaves match first, so a
    shared scales leaf resolves to the first family declaring it)."""
    for fam in all_families():
        if name == fam.key_leaf:
            return fam
    for fam in all_families():
        if name in fam.leaf_names:
            return fam
    return None


def unwrap_payload(payload: Any):
    """``(family, leaves, pattern)`` for a payload object
    (CompressedLinear, PackedTensor, QuantizedTensor, PerChannelQuant,
    BFP8Tensor, ActSparsePayload, plain tensor), or ``(None, None, None)``
    when no family claims it.  Registration order is match priority."""
    for fam in all_families():
        if fam.from_payload is None:
            continue
        out = fam.from_payload(payload)
        if out is not None:
            leaves, pattern = out
            return fam, leaves, pattern
    return None, None, None


def family_of_payload(payload: Any) -> Optional[PayloadFamily]:
    """The family a payload object belongs to (first match in
    registration order), or None."""
    for fam in all_families():
        if fam.matches is not None and fam.matches(payload):
            return fam
    return None


def weight_leaf_names() -> Tuple[str, ...]:
    """Every registered key leaf."""
    return tuple(fam.key_leaf for fam in all_families())


def container_leaf_names() -> Tuple[str, ...]:
    """Leaf names whose buffers are bit-exact storage containers (the
    checkpointer must never widen them)."""
    return tuple(n for fam in all_families() for n in fam.container_leaves)


def shard_info(leaf_name: str) -> Tuple[Optional[str], bool]:
    """(shard mode, packed) for a leaf name: mode is "pattern" /
    "replicate" / None (= follow the path-based rules); packed marks a
    bit-packed container whose block axis holds nibble pairs."""
    for fam in all_families():
        mode = fam.shard_tails.get(leaf_name)
        if mode is not None:
            return mode, fam.container is not None
    return None, False


def pattern_leaf(p: Mapping[str, Any]) -> bool:
    """Does this leaf dict need the static pattern side-table?"""
    fam = family_for_leaves(p)
    return fam is not None and fam.needs_pattern


# ----------------------------------------------------------------- autotune


def kind_family(kind: str) -> Optional[PayloadFamily]:
    """The unpacked family of a tune kind ("sparse" / "quant"), whose
    hooks the tuner calls; container variants share its kind."""
    for fam in all_families():
        if fam.kind == kind and fam.container is None:
            return fam
    return None


def tunable_kinds() -> Tuple[str, ...]:
    """Every tune kind the registry knows (the policy names
    ``autotune_model`` tunes; the others it skips)."""
    out: List[str] = []
    for fam in all_families():
        if fam.kind is not None and fam.kind not in out:
            out.append(fam.kind)
    return tuple(out)


def kind_needs_pattern(kind: str) -> bool:
    fam = kind_family(kind)
    return fam is not None and fam.needs_pattern


def representative_leaves(leaf: Mapping[str, Any]) -> Dict[str, Any]:
    """Layer 0 of a stacked leaf dict (a leaf is stacked when its ndim is
    one above its family's declared ``leaf_ndim``): the tuner's view.
    Names no family declares are dropped."""
    ndim: Dict[str, int] = {}
    for fam in all_families():
        for k, n in fam.leaf_ndim.items():
            ndim.setdefault(k, n)
    return {k: (v[0] if v.ndim == ndim[k] + 1 else v)
            for k, v in leaf.items() if k in ndim}


def policy_compiler(name: str,
                    default: Any = "__raise__") -> Optional[PolicyCompiler]:
    ensure_registered()
    if name in _POLICIES:
        return _POLICIES[name]
    if default == "__raise__":
        raise KeyError(
            f"no registered policy compiler {name!r} — registered: "
            f"{sorted(_POLICIES)}")
    return default


def policy_names() -> Tuple[str, ...]:
    ensure_registered()
    return tuple(sorted(_POLICIES))


def policy_eliminates_blocks(name: str) -> bool:
    pc = policy_compiler(name, default=None)
    return pc is not None and pc.eliminates_blocks
