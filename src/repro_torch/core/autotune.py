"""The autotuner on the card — the port of ``repro.core.autotune``.

It closes the paper's Fig. 1 loop at the dispatch seam, as the reference's
does, with the TPU's row / column tiles replaced by the card's route plans:

  Fig. 1 step                         here
  ---------------------------------   ------------------------------------
  1. per-layer configuration space    each kernel's candidates beside its
                                      route rule: ``qmm_candidates``,
                                      ``bsm_candidates``, ``pda_candidates``
                                      (the rule's plan with one knob
                                      changed, and the tiled route)
  2. latency estimation               :func:`repro_torch.core.cost_model.
                                      tile_roofline` orders the candidates
  3. refinement against the           :func:`autotune_leaf` holds every
     realised design                  candidate against its plain version,
                                      then times it on the card with CUDA
                                      events, the leaf rotated over copies
                                      that overflow the L2; on the CPU the
                                      plain version is the only candidate
  4. emit the configuration           :class:`TunedTable`, on disk, keyed by
                                      (kind, shape, dtype, backend, schedule
                                      hash), handed to every call through
                                      ``DispatchConfig.tuned``

The bit-width axis is compile-time: :func:`tuned_policy` re-ranks it for
``policy="autotune"``, and :func:`dse_retune` is the DSE's retune move.

Where the port differs from the reference: the plain version is never a
candidate on the card (no CUDA tensor is sent to it), so every entry on a
``cuda:`` key names a kernel route; bit-packed containers are timed packed,
in their kernel; a candidate replaces the rule's plan only when its median
time beats the rule's by more than the spread of the rule's own timings and
by at least :data:`MIN_GAIN`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.flash_attention.decode_packed import (
    ATTN_BT_CANDIDATES as ATTN_BTS,
)
from . import payload_registry
from .cost_model import (
    H100_SXM,
    TPU_V5E,
    HWSpec,
    LayerSpec,
    decode_linear_spec,
    layer_latency,
    network_estimate,
    tile_roofline,
)
from .folding import FoldingConfig
from .sparsity import BlockSparsePattern

__all__ = [
    "AUTOTUNE_CACHE_ENV",
    "MIN_GAIN",
    "TuneOptions",
    "TunedConfig",
    "TunedTable",
    "autotune_attn",
    "autotune_leaf",
    "autotune_lenet",
    "autotune_model",
    "backend_tag",
    "bucket_m",
    "default_cache_path",
    "dse_retune",
    "load_table",
    "schedule_hash",
    "tune_key",
    "tuned_policy",
]

AUTOTUNE_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_CACHE = os.path.join("results", "autotune_torch.json")
_CACHE_VERSION = 1
# route -> ints of its plan (None: the route takes no plan)
ROUTE_PLAN_LEN = {"thin_m": 3, "tensor_core": 4, "tiled": None,
                  "split": None, "single": None}
# a candidate must beat the rule's plan by this share, and by the spread
MIN_GAIN = 0.02
# codes a byte of each bit-packed container
_PER_BYTE = {"int4x2": 2, "int2x4": 4}


def default_cache_path() -> str:
    return os.environ.get(AUTOTUNE_CACHE_ENV, _DEFAULT_CACHE)


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend_tag(device=None) -> str:
    """The backend of tune keys: ``"cpu"``, or ``"cuda:"`` and the card's
    name, so a CPU timing never serves a card lookup and one card's table
    never serves another card.  None: the current CUDA card if there is
    one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return "cuda:" + _card_name(index)


# ------------------------------------------------------------- tuned config


def _positive_ints(v, n: int, what: str) -> Tuple[int, ...]:
    if not isinstance(v, (list, tuple)) or len(v) != n or not all(
            isinstance(i, int) and not isinstance(i, bool) and i > 0
            for i in v):
        raise ValueError(f"{what}: a plan of {n} positive ints, got {v!r}")
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One leaf's chosen execution on one backend.

    ``use_kernel=False`` is the plain version (CPU entries only); else
    ``route`` names the kernel route ("thin_m", "tensor_core", "tiled" for
    the matmuls; "split", "single" for the attention read) and ``plan`` the
    route's plan NamedTuple as a tuple of ints (None for the routes without
    one).  ``bt`` is the attention read's kv tile.  ``measured_us`` is the
    winner's median time, ``predicted_us`` its roofline seed."""

    use_kernel: bool
    route: Optional[str] = None
    plan: Optional[Tuple[int, ...]] = None
    bt: Optional[int] = None
    measured_us: Optional[float] = None
    predicted_us: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["plan"] = None if self.plan is None else list(self.plan)
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TunedConfig":
        """Range-checked: a value-corrupted (but JSON-valid) entry raises
        ValueError, so the table loads empty — "retune", never a crash in
        a forward."""
        names = {f.name for f in dataclasses.fields(TunedConfig)}
        kw = {k: v for k, v in dict(d).items() if k in names}
        if not isinstance(kw.get("use_kernel"), bool):
            raise ValueError(f"bad TunedConfig entry: {d!r}")
        route, plan = kw.get("route"), kw.get("plan")
        if route is not None and route not in ROUTE_PLAN_LEN:
            raise ValueError(f"unknown route {route!r} in entry: {d!r}")
        if kw["use_kernel"] != (route is not None):
            raise ValueError(f"a kernel entry names its route, a plain "
                             f"one none: {d!r}")
        n = ROUTE_PLAN_LEN.get(route)
        if n is None:
            if plan is not None:
                raise ValueError(f"route {route!r} takes no plan: {d!r}")
        else:
            kw["plan"] = _positive_ints(plan, n, f"route {route!r}")
        if kw.get("bt") is not None and kw["bt"] not in ATTN_BTS:
            raise ValueError(f"illegal bt={kw['bt']!r} in entry: {d!r}")
        for k in ("measured_us", "predicted_us"):
            if kw.get(k) is not None:
                kw[k] = float(kw[k])
        return TunedConfig(**kw)


class TunedTable:
    """Key -> TunedConfig map with an on-disk JSON form.

    A plain class (identity hash and equality): it rides inside the frozen
    :class:`repro_torch.core.dispatch.DispatchConfig`.  ``load`` never
    raises on a missing or corrupted file — that means "retune".  ``log``
    records what the last tuning run did per key (a cache hit, or the
    candidates it timed); it is never saved."""

    def __init__(self, entries: Optional[Dict[str, TunedConfig]] = None,
                 path: Optional[str] = None):
        self.entries: Dict[str, TunedConfig] = dict(entries or {})
        self.path = path
        self.log: List[Dict[str, Any]] = []

    def get(self, key: str) -> Optional[TunedConfig]:
        return self.entries.get(key)

    def put(self, key: str, cfg: TunedConfig) -> None:
        self.entries[key] = cfg

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def n_timings(self) -> int:
        """Candidates the last tuning run timed (0: all from the cache)."""
        return sum(e.get("n_timed", 0) for e in self.log)

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path or default_cache_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        blob = {"version": _CACHE_VERSION,
                "entries": {k: v.to_json()
                            for k, v in sorted(self.entries.items())}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=2, sort_keys=True)
        os.replace(tmp, path)  # atomic: a crashed save never corrupts
        self.path = path
        return path

    @classmethod
    def load(cls, path: str) -> "TunedTable":
        table = cls(path=path)
        try:
            with open(path) as f:
                blob = json.load(f)
            if blob.get("version") != _CACHE_VERSION:
                return table
            for k, v in blob.get("entries", {}).items():
                table.entries[str(k)] = TunedConfig.from_json(v)
        except (OSError, ValueError, TypeError, AttributeError):
            table.entries.clear()  # missing / truncated / garbage: retune
        return table


_LOAD_MEMO: Dict[Tuple[str, float, int], TunedTable] = {}


def load_table(path: Optional[str] = None) -> TunedTable:
    """The table at ``path`` (default :func:`default_cache_path`), memoised
    on mtime and size; a missing file is an empty table."""
    path = path or default_cache_path()
    try:
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime, st.st_size)
    except OSError:
        return TunedTable(path=path)
    hit = _LOAD_MEMO.get(key)
    if hit is None:
        hit = TunedTable.load(path)
        _LOAD_MEMO.clear()  # one live file version is enough
        _LOAD_MEMO[key] = hit
    return hit


# --------------------------------------------------------------------- keys


# pattern -> its schedule hash: dispatch looks it up on every tuned call
_HASHES: "weakref.WeakKeyDictionary[BlockSparsePattern, str]" = \
    weakref.WeakKeyDictionary()


def schedule_hash(pattern: BlockSparsePattern) -> str:
    """Digest of the static schedule (shape, block, bitmap), the
    reference's string for the same pattern; once per pattern."""
    hit = _HASHES.get(pattern)
    if hit is None:
        h = hashlib.sha1()
        h.update(repr((tuple(int(d) for d in pattern.shape),
                       tuple(int(d) for d in pattern.block))).encode())
        h.update(np.packbits(np.asarray(pattern.bitmap, bool)).tobytes())
        hit = _HASHES[pattern] = h.hexdigest()[:16]
    return hit


def bucket_m(M: int) -> int:
    """M-bucket of tuned keys: the next power of two, capped at 8192, so
    decode rows keep exact buckets and large prefill row counts share."""
    M = max(1, int(M))
    b = 1
    while b < M and b < 8192:
        b *= 2
    return b


def _dtype_name(dtype) -> str:
    """``float32`` / ``bfloat16`` / ..., as ``jnp.dtype(...).name`` says."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return np.dtype(dtype).name


def tune_key(*, kind: str, M: int, K: int, N: int, dtype,
             backend: Optional[str] = None,
             pattern: Optional[BlockSparsePattern] = None,
             container: Optional[str] = None,
             leaf: Optional[str] = None) -> str:
    """Cache key ``kind:M<bucket>:K:N:dtype:backend:schedule`` plus an
    optional ``:container=`` tag (bit-packed and family containers never
    share entries with the int8 ones) and ``:leaf=`` suffix (the per-leaf
    override the lookup tries first); the reference's string for the same
    backend.  ``kind`` carries the op: ``conv_`` (im2col) and
    ``fusedconv_`` kinds never collide with linears.  ``backend`` defaults
    to :func:`backend_tag`."""
    backend = backend or backend_tag()
    sched = schedule_hash(pattern) if pattern is not None else "dense"
    base = (f"{kind}:M{bucket_m(M)}:K{int(K)}:N{int(N)}:"
            f"{_dtype_name(dtype)}:{backend}:{sched}")
    if container is not None:
        base = f"{base}:container={container}"
    return base if leaf is None else f"{base}:leaf={leaf}"


# -------------------------------------------------------------- measurement


@dataclasses.dataclass(frozen=True)
class TuneOptions:
    """Search effort: ``max_measured`` candidates timed per key at most
    (the rule's plan always, the rest in roofline order), each ``iters``
    timings after ``warmup`` runs; ``hw`` prices the roofline seed."""

    max_measured: int = 6
    iters: int = 10
    warmup: int = 2
    hw: HWSpec = H100_SXM


def _n_copies(nbytes: int, cap: int = 64) -> int:
    """Copies of an operand that together exceed the 50 MB L2 well."""
    return int(min(cap, max(2, math.ceil(128e6 / max(nbytes, 1)))))


def _nbytes(tensors) -> int:
    return sum(int(t.numel() * t.element_size()) for t in tensors
               if isinstance(t, torch.Tensor))


def _time_fn(make_call: Callable[[int], Callable[[], Any]], n: int,
             iters: int, warmup: int, device: torch.device) -> List[float]:
    """``iters`` timings in microseconds of one call; ``make_call(i)`` is
    the call on the i-th of ``n`` copies of its operands.

    On the card the ``n`` calls are captured in one CUDA graph (no host
    time between launches), replayed ``warmup`` times, then once per
    timing between CUDA events: copies that overflow the L2 make each call
    read its operands from device memory, as a serving step does.  On the
    CPU each timing is one call on the host clock."""
    if device.type != "cuda":
        call = make_call(0)
        for _ in range(max(1, warmup)):
            call()
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            out.append((time.perf_counter() - t0) * 1e6)
        return out
    calls = [make_call(i) for i in range(n)]
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for call in calls:   # first calls: libraries loaded, then captured
            call()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    for _ in range(max(1, warmup)):
        graph.replay()
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / n)
    del graph
    return out


def _tolerance(y: torch.Tensor, ref: torch.Tensor) -> float:
    """One bf16 output step (2^-7 of max|ref|), or the f32 sum-order error
    (1e-4 of it): the kernels' tolerance against their plain versions."""
    scale = float(ref.float().abs().max()) + 1e-6
    return (2 ** -7 if y.dtype == torch.bfloat16 else 1e-4) * scale


def _check_against_plain(y, ref, what: str) -> float:
    err = float((y.float() - ref.float()).abs().max())
    tol = _tolerance(y, ref)
    if not err <= tol:
        raise RuntimeError(
            f"autotune: {what} differs from its plain version by {err} > "
            f"{tol} — a plan the kernel computes wrongly")
    return err


def _median(v: Sequence[float]) -> float:
    return float(np.median(np.asarray(v, float)))


def _pick(rule, timed):
    """The rule's candidate unless another's median beats the rule's by
    more than the spread of the rule's own timings and by at least
    :data:`MIN_GAIN`; then the fastest such."""
    base = _median(rule["samples"])
    spread = max(rule["samples"]) - min(rule["samples"])
    best = rule
    for t in timed:
        m = _median(t["samples"])
        if m < base - spread and m <= (1 - MIN_GAIN) * base \
                and m < _median(best["samples"]):
            best = t
    return best


def _predict_us(kind: str, route: Optional[str], plan, *, M: int, K: int,
                N: int, pattern: Optional[BlockSparsePattern],
                weight_bits: int, ratio: int, hw: HWSpec) -> float:
    """Roofline seed of one candidate (:func:`tile_roofline`): ``bm`` the
    plan's rows (M on thin-M, ``m_tile`` on the tensor cores, the tiled
    kernel's row tile), ``bk`` / ``bn`` the plan's (the pattern's block for
    a sparse leaf), ``n_blocks`` the pattern's present blocks.  None route:
    the plain version, one call over the whole problem."""
    from ..kernels.sparse_matmul.kernel import TC_K_STEP, rows_per_cta

    sparse = payload_registry.kind_needs_pattern(kind)
    n_blocks = pattern.n_blocks_present if sparse else None
    if sparse:
        bk, bn = pattern.block
    elif route == "thin_m":
        bn, bk = plan[0], plan[2] * ratio
    elif route == "tensor_core":
        bn, bk = plan[1], plan[3] * TC_K_STEP
    else:
        bk = 128 if K % 128 == 0 else K
        bn = 128 if N % 128 == 0 else N
    if route is None:
        s = tile_roofline(M=M, K=K, N=N, bm=min(128, max(8, M)), bk=bk,
                          bn=bn, n_blocks=n_blocks, weight_bits=weight_bits,
                          hw=hw, launch=False)
    else:
        bm = {"thin_m": M, "tensor_core": plan[0] if plan else M}.get(
            route, rows_per_cta(M))
        s = tile_roofline(M=M, K=K, N=N, bm=bm, bk=bk, bn=bn,
                          n_blocks=n_blocks, weight_bits=weight_bits, hw=hw)
    return s * 1e6


def _copy_leaf(leaf: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in leaf.items()}


def _family_of_kind(kind: str):
    family = kind
    for prefix in ("fusedconv_", "conv_"):
        if kind.startswith(prefix):
            family = kind[len(prefix):]
            break
    fam = payload_registry.kind_family(family)
    if fam is None or fam.tune_runner is None:
        raise ValueError(
            f"unknown tune kind {kind!r} — tunable kinds: "
            f"{payload_registry.tunable_kinds()}")
    return family, fam


def autotune_leaf(
    kind: str,
    x: torch.Tensor,
    leaf: Dict[str, torch.Tensor],
    *,
    pattern: Optional[BlockSparsePattern] = None,
    weight_bits: int = 8,
    options: TuneOptions = TuneOptions(),
    table: Optional[TunedTable] = None,
    key: Optional[str] = None,
    container: Optional[str] = None,
) -> TunedConfig:
    """Tune one compiled leaf at the rows of ``x``.

    ``kind`` is "sparse" (needs ``pattern``) or "quant", optionally
    prefixed ``conv_`` for an im2col'd conv leaf (the same matmul; only the
    key differs).  An entry already in ``table`` under ``key`` returns at
    once (no timing).  On the card the candidates are the kernel's plans
    at these operands (``tune_candidates`` of the kind's family), the
    rule's own always timed and the others in roofline order up to
    ``options.max_measured``; each is first held against the plain
    version (a mismatch raises).  On the CPU the plain version is the only
    candidate.  A bit-packed container is timed packed, in its kernel, its
    key tagged with the container."""
    family, fam = _family_of_kind(kind)
    M, K_x = int(np.prod(x.shape[:-1], dtype=int)), int(x.shape[-1])
    lf = payload_registry.family_for_leaves(leaf)
    if lf is not None and lf.tune_prepare is not None:
        leaf, cont = lf.tune_prepare(leaf, pattern, K_x)
        container = container or cont
    K, N = fam.leaf_kn(leaf, pattern)
    per_byte = _PER_BYTE.get(container, 1)
    if -(-K_x // per_byte) * per_byte != -(-K // per_byte) * per_byte:
        raise ValueError(f"autotune: x has K={K_x}, the leaf {K}")
    K = K_x
    if key is None:
        key = tune_key(kind=kind, M=M, K=K, N=N, dtype=x.dtype,
                       backend=backend_tag(x.device), pattern=pattern,
                       container=container)
    if table is not None:
        hit = table.get(key)
        if hit is not None:
            table.log.append({"key": key, "cached": True, "n_timed": 0})
            return hit

    pred = functools.partial(_predict_us, family, M=M, K=K, N=N,
                             pattern=pattern, weight_bits=weight_bits,
                             ratio=per_byte, hw=options.hw)
    plain = fam.tune_runner(None, x, leaf, pattern)
    n = _n_copies(_nbytes(leaf.values())) if x.is_cuda else 1
    copies = [leaf] + [_copy_leaf(leaf) for _ in range(n - 1)]
    timed: List[Dict[str, Any]] = []
    if x.is_cuda:
        cands = [c for c in fam.tune_candidates(x, leaf, pattern)
                 if c[1] is None or min(c[1]) > 0]  # storable plans only
        rule, rest = cands[0], sorted(cands[1:],
                                      key=lambda c: pred(c[0], c[1]))
        ref = plain()
        for route, plan in [rule] + rest[:max(0, options.max_measured - 1)]:
            what = f"{key} route {route} plan {plan}"
            err = _check_against_plain(
                fam.tune_runner((route, plan), x, leaf, pattern)(), ref, what)
            samples = _time_fn(
                lambda i, c=(route, plan): fam.tune_runner(
                    c, x, copies[i], pattern),
                n, options.iters, options.warmup, x.device)
            timed.append({"route": route, "plan": plan, "samples": samples,
                          "err": err, "predicted_us": pred(route, plan)})
        won = _pick(timed[0], timed[1:])
        winner = TunedConfig(
            use_kernel=True, route=won["route"],
            plan=None if won["plan"] is None else tuple(won["plan"]),
            measured_us=_median(won["samples"]),
            predicted_us=won["predicted_us"])
    else:
        samples = _time_fn(lambda i: plain, 1, options.iters, options.warmup,
                           x.device)
        timed.append({"route": None, "plan": None, "samples": samples,
                      "err": 0.0, "predicted_us": pred(None, None)})
        winner = TunedConfig(use_kernel=False, measured_us=_median(samples),
                             predicted_us=timed[0]["predicted_us"])
    if table is not None:
        table.put(key, winner)
        table.log.append({
            "key": key, "cached": False, "n_timed": len(timed),
            "candidates": [{"route": t["route"],
                            "plan": None if t["plan"] is None
                            else list(t["plan"]),
                            "median_us": _median(t["samples"]),
                            "spread_us": max(t["samples"]) - min(t["samples"]),
                            "predicted_us": t["predicted_us"],
                            "max_abs_err": t["err"]} for t in timed]})
    return winner


# ------------------------------------------------- packed-attention tuning


def autotune_attn(
    *,
    B: int,
    T: int,
    H: int,
    Hkv: int,
    Dh: int,
    x_dtype=torch.float32,
    packed: bool = True,
    options: TuneOptions = TuneOptions(),
    table: Optional[TunedTable] = None,
    key: Optional[str] = None,
    save: bool = True,
    seed: int = 0,
    device=None,
) -> TunedConfig:
    """Tune the quantised-cache attention read (kind ``attn_packed``): the
    kv tile ``bt`` of :data:`ATTN_BTS`, at the serving shape (B slots, one
    query row each, a T-row cache of int4x2 codes, or int8 codes with
    ``packed=False`` — the ``int4`` cache, keyed ``container=int4``).

    The engine pins one ``bt`` for its lifetime but reads the cache at
    bucketed extents 32, 64, … T as slots fill, so a candidate's cost is
    its time summed over those extents.  On the card each ``bt`` runs the
    kernel on the route ``pda_candidates`` names (held against the plain
    version first); on the CPU, the plain ``tiled_packed_attention``.  The
    default tile (``ATTN_BT_DEFAULT``) is the rule's candidate."""
    from ..device import resolve_device
    from ..kernels.flash_attention.decode_packed import (
        packed_decode_attention,
        pda_candidates,
        tiled_packed_attention,
    )
    from .dispatch import ATTN_BT_DEFAULT
    from .quant import pack_int4

    dev = resolve_device(device)
    if key is None:
        key = tune_key(kind="attn_packed", M=B, K=T, N=H * Dh, dtype=x_dtype,
                       backend=backend_tag(dev),
                       container=None if packed else "int4")
    if table is not None:
        hit = table.get(key)
        if hit is not None:
            table.log.append({"key": key, "cached": True, "n_timed": 0})
            return hit

    rng = np.random.default_rng(seed)
    codes_k = torch.as_tensor(rng.integers(-7, 8, size=(B, T, Hkv, Dh)),
                              dtype=torch.int8)
    codes_v = torch.as_tensor(rng.integers(-7, 8, size=(B, T, Hkv, Dh)),
                              dtype=torch.int8)
    if packed:
        codes_k, codes_v = pack_int4(codes_k, axis=-1), pack_int4(codes_v,
                                                                  axis=-1)
    cache = [t.to(dev).contiguous() for t in (
        codes_k, codes_v,
        torch.as_tensor(rng.uniform(0.01, 0.2, (B, T, Hkv)),
                        dtype=torch.float32),
        torch.as_tensor(rng.uniform(0.01, 0.2, (B, T, Hkv)),
                        dtype=torch.float32))]
    q = torch.as_tensor(rng.normal(size=(B, 1, H, Dh)), dtype=x_dtype,
                        device=dev)
    extents = []
    e = 32
    while e < T:
        extents.append(e)
        e *= 2
    extents.append(T)
    lens = {e: torch.full((B, 1), min(T, e), dtype=torch.int32, device=dev)
            for e in extents}
    on_cuda = dev.type == "cuda"
    n = _n_copies(_nbytes(cache)) if on_cuda else 1
    copies = [cache] + [[t.clone() for t in cache] for _ in range(n - 1)]

    def call(route, bt, c):
        k, v, ks, vs = c
        if route is None:
            return lambda: [tiled_packed_attention(
                q, k[:, :e], v[:, :e], ks[:, :e], vs[:, :e], lens[e], bt=bt,
                packed=packed) for e in extents]
        return lambda: [packed_decode_attention(
            q, k[:, :e], v[:, :e], ks[:, :e], vs[:, :e], lens[e], bt=bt,
            packed=packed, route=route, name=key) for e in extents]

    timed = []
    if on_cuda:
        kv_addr = cache[0].data_ptr() | cache[1].data_ptr() \
            | int(cache[0].stride(0))
        cands = pda_candidates(B, 1, H, Hkv, Dh, T, kv_addr, packed)
    else:
        cands = [(None, bt) for bt in ATTN_BTS]
    for route, bt in cands:
        err = 0.0
        if on_cuda:
            ys, refs = call(route, bt, cache)(), call(None, bt, cache)()
            err = max(_check_against_plain(
                y, r, f"{key} route {route} bt {bt} extent {e}")
                for y, r, e in zip(ys, refs, extents))
        samples = _time_fn(lambda i, r=route, b=bt: call(r, b, copies[i]), n,
                           options.iters, options.warmup, dev)
        timed.append({"route": route, "bt": bt, "samples": samples,
                      "err": err})
    rule = next(t for t in timed if t["bt"] == ATTN_BT_DEFAULT)
    won = _pick(rule, [t for t in timed if t is not rule])
    winner = TunedConfig(use_kernel=on_cuda, route=won["route"], bt=won["bt"],
                         measured_us=_median(won["samples"]))
    if table is not None:
        table.put(key, winner)
        table.log.append({
            "key": key, "cached": False, "n_timed": len(timed),
            "candidates": [{"route": t["route"], "bt": t["bt"],
                            "median_us": _median(t["samples"]),
                            "spread_us": max(t["samples"]) - min(t["samples"]),
                            "max_abs_err": t["err"]} for t in timed]})
        if save and table.path:
            table.save()
    return winner


# ---------------------------------------------------------- whole-model API


def _leaf_by_path(tree: Any, path: str) -> Dict[str, Any]:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _payload_leaf(payload) -> Optional[Dict[str, torch.Tensor]]:
    """Leaf-dict view of a compiled payload (a conv's im2col matmul for a
    :class:`ConvPayload`), through the same ``unwrap_payload`` the
    dispatch uses; None for a family that is not tuned."""
    from .dispatch import ConvPayload

    if isinstance(payload, ConvPayload):
        payload = payload.payload
    fam, leaves, _ = payload_registry.unwrap_payload(payload)
    if fam is None or fam.kind is None:
        return None
    return dict(leaves)


def autotune_model(
    cm,
    *,
    M,
    x_dtype=torch.float32,
    options: TuneOptions = TuneOptions(),
    path: Optional[str] = None,
    save: bool = True,
    seed: int = 0,
    per_leaf: bool = False,
) -> TunedTable:
    """Tune every compiled sparse / quant leaf of a CompressedModel at
    ``M`` rows (decode: the engine's slots; prefill: B*T), or at each of a
    sequence of row counts, each under its own :func:`bucket_m` key.

    Loads the table at ``path`` first — keys already there are not timed
    again (``n_timings() == 0`` on a warm table) — and saves the merged
    table back.  One key serves every leaf of one shape and schedule
    (``per_leaf=True``: one key per leaf instead).  Conv leaves tune as
    their im2col matmul under ``conv_`` kinds at ``M * m_scale`` rows.
    ``x`` is drawn from ``seed`` on each leaf's device, in ``x_dtype``."""
    path = path or default_cache_path()
    table = TunedTable.load(path)
    table.log = []
    rng = np.random.default_rng(seed)
    Ms = (M,) if isinstance(M, (int, np.integer)) else tuple(M)
    done = set()
    tunable = payload_registry.tunable_kinds()
    for r in cm.report:
        if r.policy not in tunable:
            continue
        K, N = r.shape
        kind = ("conv_" if r.kind == "conv" else "") + r.policy
        pattern = cm.patterns.get((K, N)) \
            if payload_registry.kind_needs_pattern(r.policy) else None
        if cm.layers:  # LeNet-style payloads
            leaf = _payload_leaf(cm.layers.get(r.name))
            if leaf is None:
                continue
        else:
            leaf = payload_registry.representative_leaves(
                _leaf_by_path(cm.params, r.name))
        lf = payload_registry.family_for_leaves(leaf)
        container = lf.container if lf is not None else None
        dev = next(iter(leaf.values())).device
        for M_rows in Ms:
            M_leaf = int(M_rows) * max(1, int(r.m_scale))
            key = tune_key(kind=kind, M=M_leaf, K=K, N=N, dtype=x_dtype,
                           backend=backend_tag(dev), pattern=pattern,
                           container=container,
                           leaf=r.name if per_leaf else None)
            if key in done:
                continue
            done.add(key)
            x = torch.as_tensor(rng.normal(size=(M_leaf, K)), dtype=x_dtype,
                                device=dev)
            if container is not None:
                wbits = 8 // _PER_BYTE.get(container, 2)
            else:
                w = leaf.get(lf.code_leaf) if lf is not None else None
                wbits = 8 if w is not None and w.dtype == torch.int8 else 32
            autotune_leaf(kind, x, leaf, pattern=pattern, weight_bits=wbits,
                          options=options, table=table, key=key,
                          container=container)
    if save:
        table.save(path)
    return table


def autotune_lenet(cm, *, M: int, **kw) -> TunedTable:
    """:func:`autotune_model` for a ``compile_lenet`` result.  Its conv
    entries are ``conv_*`` keys, read by the im2col path; the fused convs
    look up ``fusedconv_*`` keys, as the reference's do, so these entries
    do not reach the fused forward."""
    return autotune_model(cm, M=M, **kw)


# --------------------------------------- compile-time bit-width re-ranking


def tuned_policy(
    K: int,
    N: int,
    *,
    rules,
    block_density: float,
    element_density: float,
    sparse_eligible: bool,
    spec: Optional[LayerSpec] = None,
) -> Tuple[str, int]:
    """Per-layer (policy, quant_bits) behind ``policy="autotune"``: the
    candidates {dense(16), quant(8), quant(4), sparse(8), sparse(4)}
    ranked by ``network_estimate`` of a decode-shaped one-layer network
    under ``rules.hw`` (conv leaves pass their own ``spec``); below
    ``rules.min_weight_elems`` a leaf stays dense."""
    if K * N < rules.min_weight_elems:
        return "dense", 16
    if spec is None:
        spec = decode_linear_spec(K, N, rules.batch_tokens)
    hw = rules.hw
    cands: List[Tuple[str, int, FoldingConfig]] = [
        ("dense", 16, FoldingConfig(parallelism=hw.lanes, unroll="factor",
                                    quant_bits=16)),
        ("quant", 8, FoldingConfig(parallelism=hw.lanes, unroll="factor",
                                   quant_bits=8)),
        ("quant", 4, FoldingConfig(parallelism=hw.lanes, unroll="factor",
                                   quant_bits=4)),
    ]
    if sparse_eligible:
        for bits in (8, 4):
            cands.append(("sparse", bits, FoldingConfig(
                parallelism=hw.lanes, unroll="sparse",
                block_density=block_density,
                element_density=element_density, quant_bits=bits)))
    best = min(cands, key=lambda c: network_estimate([spec], [c[2]], hw).ii)
    return best[0], best[1]


def dse_retune(spec: LayerSpec, cfg: FoldingConfig,
               hw: HWSpec = TPU_V5E) -> Optional[FoldingConfig]:
    """Bottleneck retune move for :func:`repro_torch.core.dse.run_dse`:
    the quant bit-width ({16, 8, 4}) re-ranked by ``layer_latency`` under
    the current unroll; None when the current config is already best."""
    best_lat, best = None, None
    for bits in (16, 8, 4):
        trial = cfg.replace(quant_bits=bits)
        lat = layer_latency(spec, trial, hw)["total"]
        if best_lat is None or lat < best_lat:
            best_lat, best = lat, trial
    if best is None or best == cfg:
        return None
    return best
