"""Batched serving engine: continuous batching, in one of two modes
chosen by the model family at construction.

* **Chunked interleave** (the attention-only families: dense, vlm).
  Prompts run through :func:`repro_torch.models.model.prefill_step` in
  fixed-size chunks (``prefill_chunk`` tokens, the per-step prefill
  budget), writing straight into the cache container; every engine step
  advances ONE prefilling slot by one chunk AND every decoding slot by one
  token (``decode_step`` with an ``active`` mask), so a long prompt never
  stalls the decoding slots.  The first generated token comes from the
  final chunk's logits.  A prompt whose chunk schedule cannot fit the
  cache (``ceil(P/C)·C > max_len``) falls back to a token drip for that
  request.
* **Token drip** (moe, ssm, hybrid).  Exactly one token for every slot
  each step through ``decode_step`` with no ``active`` mask, prompts fed
  one token at a time (``prefill_chunk`` is ignored): a MoE router's
  static capacity depends on the token count and a recurrent state must
  advance token by token, so these families keep the reference's legacy
  path.  Idle slots step too, writing garbage their next admission resets
  (rows past their length; recurrent state); their attention reads are
  held to the step's extent.  An encoder has no decode cache and is
  refused.

The cache is a tree (the recurrent families nest their states); every
walk over it — a slot's reset, the prefill gather / scatter,
``cache_bytes`` — takes each leaf's slot axis from
:func:`~repro_torch.models.model.cache_batch_axes`, never from a size.
Prefill gathers the slot's batch-of-one cache, runs the chunk on it and
scatters it back, so a chunk write cannot touch a neighbouring slot.
Cache reads are bounded to a power-of-two extent (``_bucket_t``) with the
kv tile size pinned at startup — the packed read skips dead tiles, so the
bound changes the work, never the result.  The SSM family has no
attention read, so its drip has one bucket.

On a CUDA device each step is captured once per bucket, as the reference
compiles one step per bucket: the first decode step (prefill chunk, drip
step) at a new bucket runs eagerly, as the real step, and is then
captured into a ``torch.cuda.CUDAGraph``; every later step at that bucket
replays the graph.  The step's inputs (tokens, ``active``, ``n_valid``,
the prefill slot) live in static device buffers filled by ``copy_`` before
each step; the cache is updated in place, so its addresses never move.
All graphs share one memory pool, so each step's logits are read (argmax
to the host) before the next step runs.  The CPU path runs eagerly.

``stats()`` reports per-phase step counts, token counts and per-step
wall-clock, and the graphs: their count, capture seconds and pool bytes;
each :class:`Request` carries ``t_submit`` / ``t_first`` / ``t_done``
stamps (TTFT = t_first - t_submit).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.compile_sparse import CompressedModel
from ..core.dispatch import ATTN_BT_DEFAULT, resolve
from ..device import resolve_device
from ..kernels import add_launch_counts, launch_counts
from ..models.config import ArchConfig
from ..models.model import cache_batch_axes, decode_step, init_cache, prefill_step
from ..tree import tree_leaves, tree_map

# families whose prompts run through the chunked prefill path; the others
# take the token drip
_CHUNKED_FAMILIES = ("dense", "vlm")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int = 16
    out: Optional[List[int]] = None  # generated tokens
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every engine on ``device`` warms up and captures on.
    One for the process: each stream that runs a cuBLAS call keeps its own
    workspace for as long as the process lives."""
    return torch.cuda.Stream(device)


class CapturedStep:
    """One step captured into a CUDA graph on ``stream``, its memory from
    ``pool``; ``replay()`` runs it and returns its static output.

    The launch counters tick in Python, where a wrapper launches, so a
    capture would count its kernels once and a replay never: the capture's
    counts are taken back and added again on every replay instead.  A
    failed capture raises."""

    def __init__(self, fn: Callable[[], torch.Tensor], pool, stream):
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = fn()
        finally:
            after = launch_counts()
            self.launches = {k: after[k] - before[k] for k in after}
            add_launch_counts({k: -n for k, n in self.launches.items()})

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.out


class ServeEngine:
    """``params`` may be a raw parameter tree or a
    :class:`repro_torch.core.compile_sparse.CompressedModel`, served
    straight from its compacted leaves with its pattern table.  Params must
    live on ``device`` (CUDA unless ``device="cpu"``).

    ``dispatch`` picks kernel or plain version for the compiled leaves
    ("auto" | "kernel" | "twin", None = ``REPRO_TORCH_DISPATCH``).
    ``kv_cache`` is ``"float"``, ``"int4"`` (int8 codes + per-row scales)
    or ``"int4x2"`` (the same codes bit-packed two per byte); the quantised
    containers are read at a kv tile of :data:`ATTN_BT_DEFAULT` rows,
    pinned for the engine's lifetime, and give the same tokens.
    ``packed_read`` is their read: ``"fused"`` (codes -> attention in the
    packed attention kernel) or ``"unpack"`` (the whole container decoded,
    then the plain read).  ``capture`` runs the steps as CUDA graphs, one
    per bucket: None captures on CUDA and runs eagerly on the CPU, False
    runs eagerly, True on the CPU raises.

    ``autotune``: False, True (tune the compiled model's leaves at M =
    ``batch_slots`` with ``autotune_options``, through the on-disk table of
    :func:`repro_torch.core.autotune.default_cache_path`), or a
    :class:`~repro_torch.core.autotune.TunedTable` used as it is.  The
    table rides on the dispatch config with its lookups pinned to
    ``batch_slots`` rows (prefill chunks read the decode entries; thin-M
    plans do not depend on M); a quantised cache of a chunked family takes
    its kv tile from :func:`~repro_torch.core.autotune.autotune_attn`,
    pinned for the engine's lifetime (the drip keeps the default, as the
    reference's does).  Captured steps capture the tuned plans, so a replay
    launches what the eager step launches.
    """

    def __init__(self, params, cfg: ArchConfig, *, batch_slots: int = 4,
                 max_len: int = 256, patterns=None, dispatch=None,
                 autotune=False, autotune_options=None,
                 kv_cache: str = "float", prefill_chunk: int = 16,
                 packed_read: str = "fused", device=None,
                 capture: Optional[bool] = None):
        cm = params if isinstance(params, CompressedModel) else None
        if cm is not None:
            patterns = cm.patterns if patterns is None else patterns
            params = cm.params
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed']['w'].device}, the engine "
                f"runs on {self.device}")
        is_cuda = self.device.type == "cuda"
        if capture and not is_cuda:
            raise ValueError(
                f"capture=True needs a CUDA device; the engine runs on "
                f"{self.device}, where steps run eagerly")
        self.capture = is_cuda if capture is None else bool(capture)
        self.params = params
        self.patterns = patterns
        self.dispatch = resolve(dispatch)
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.kv_cache = kv_cache
        self.packed_read = packed_read
        self.prefill_chunk = max(1, int(prefill_chunk))
        self._chunked = cfg.family in _CHUNKED_FAMILIES
        self._bt = ATTN_BT_DEFAULT if kv_cache in ("int4", "int4x2") else None
        if autotune is not False and autotune is not None:
            self._autotune(cm, autotune, autotune_options,
                           params["embed"]["w"].dtype)
        self.cache = init_cache(cfg, batch_slots, max_len, kv_cache=kv_cache,
                                device=self.device)
        self._batch_axes = cache_batch_axes(cfg, kv_cache=kv_cache)
        # the steps' inputs: static device buffers (a graph reads them at
        # fixed addresses), filled from pinned host copies on CUDA
        self._inputs = {
            "tok": torch.zeros((batch_slots, 1), dtype=torch.int32),
            "act": torch.zeros((batch_slots,), dtype=torch.int32),
            "ptok": torch.zeros((1, self.prefill_chunk), dtype=torch.int32),
            "nv": torch.zeros((1,), dtype=torch.int32),
            "slot": torch.zeros((1,), dtype=torch.int64),
        }
        self._staging = {k: v.pin_memory() for k, v in self._inputs.items()} \
            if is_cuda else {}
        self._inputs = {k: v.to(self.device) for k, v in self._inputs.items()}
        self._graphs: Dict[Tuple[str, int], CapturedStep] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._stream = _capture_stream(self.device) if self.capture else None
        self._capture_s = 0.0
        self._graph_bytes = 0
        self.active: Dict[int, Request] = {}
        self.prompt_pos: Dict[int, int] = {}
        self.remaining: Dict[int, int] = {}
        self.last_tok = np.zeros((batch_slots, 1), np.int32)
        self.queue: List[Request] = []
        self._unreturned: List[Request] = []
        self._phase: Dict[int, str] = {}     # slot -> "prefill" | "decode"
        self._len = np.zeros(batch_slots, np.int64)  # host mirror of length
        self._order: List[int] = []          # prefill FIFO (admission order)
        self._stats = {"prefill_steps": 0, "decode_steps": 0,
                       "prefill_tokens": 0, "decode_tokens": 0,
                       "prefill_ms": [], "decode_ms": []}

    def _autotune(self, cm, autotune, options, x_dtype) -> None:
        """Attach the tuned table (tuning ``cm`` first unless one is given)
        with lookups pinned to ``batch_slots`` rows, and pin the kv tile
        of a quantised cache from the tuned attention read."""
        from ..core.autotune import (
            TuneOptions,
            TunedTable,
            autotune_attn,
            autotune_model,
        )

        options = options or TuneOptions()
        if isinstance(autotune, TunedTable):
            table = autotune
        elif cm is None:
            raise ValueError(
                "ServeEngine(autotune=True) needs a CompressedModel — a raw "
                "parameter tree has no compiled leaves to tune")
        else:
            table = autotune_model(cm, M=self.slots, x_dtype=x_dtype,
                                   options=options)
        self.dispatch = dataclasses.replace(self.dispatch, tuned=table,
                                            m_bucket=self.slots)
        if self._bt is not None and self._chunked:
            cfg = self.cfg
            self._bt = autotune_attn(
                B=self.slots, T=self.max_len, H=cfg.n_heads,
                Hkv=cfg.n_kv_heads, Dh=cfg.head_dim, x_dtype=x_dtype,
                packed=self.kv_cache == "int4x2", options=options,
                table=table, device=self.device).bt or ATTN_BT_DEFAULT

    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        needed = len(req.prompt) + max(0, req.max_new_tokens - 1)
        if needed > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt ({len(req.prompt)} tokens) + "
                f"max_new_tokens ({req.max_new_tokens}) needs {needed} cache "
                f"positions but max_len is {self.max_len} — the cache would "
                "silently wrap; raise max_len or trim the request")
        req.out = []
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        self._unreturned.append(req)

    def cache_bytes(self) -> int:
        """Resident bytes of the decode cache (all leaves, scales included)."""
        return sum(int(t.numel() * t.element_size())
                   for t in tree_leaves(self.cache))

    def stats(self) -> Dict:
        """Per-phase counters: step counts, token counts, per-step ms; and
        the captured steps: ``graphs`` (one per phase and bucket),
        ``capture_s`` (seconds spent capturing) and ``graph_pool_bytes``
        (device memory the captures reserved)."""
        out = dict(self._stats)
        out["prefill_ms"] = list(self._stats["prefill_ms"])
        out["decode_ms"] = list(self._stats["decode_ms"])
        out.update(graphs=len(self._graphs), capture_s=self._capture_s,
                   graph_pool_bytes=self._graph_bytes)
        return out

    def tokens_processed(self) -> int:
        """Total tokens pushed through the model (prefill + decode)."""
        return int(self._stats["prefill_tokens"]
                   + self._stats["decode_tokens"])

    def _reset_slot(self, slot: int):
        """Zero one slot of every cache leaf along its batch axis."""
        tree_map(lambda leaf, ax: leaf.select(ax, slot).zero_(), self.cache,
                 self._batch_axes)

    def _chunk_fits(self, req: Request) -> bool:
        C = self.prefill_chunk
        return -(-len(req.prompt) // C) * C <= self.max_len

    def _admit(self):
        free = [s for s in range(self.slots) if s not in self.active]
        while free and self.queue:
            slot = free.pop(0)
            req = self.queue.pop(0)
            self._reset_slot(slot)
            self.active[slot] = req
            self.remaining[slot] = req.max_new_tokens
            self._len[slot] = 0
            if self._chunked and self._chunk_fits(req):
                self._phase[slot] = "prefill"
                self.prompt_pos[slot] = 0
                self._order.append(slot)
            else:
                # token drip: a family that does not chunk, or a prompt
                # whose rounded-up chunk schedule overruns the cache
                self._phase[slot] = "decode"
                self.prompt_pos[slot] = 1
                self.last_tok[slot, 0] = int(req.prompt[0])

    def _bucket_t(self, t: int) -> int:
        """Power-of-two cache-read extent covering ``t`` positions (floor
        32, capped at max_len)."""
        b = 32
        while b < t:
            b *= 2
        return min(b, self.max_len)

    def _finish(self, slot: int, now: float) -> bool:
        if self.remaining[slot] > 0:
            return False
        req = self.active[slot]
        req.t_done = now
        del self.active[slot], self.remaining[slot], self.prompt_pos[slot]
        self._phase.pop(slot, None)
        return True

    def _fill(self, name: str, values) -> None:
        """Copy host values into the static step input ``name``."""
        dst = self._inputs[name]
        src = torch.from_numpy(np.ascontiguousarray(
            np.asarray(values).reshape(tuple(dst.shape))))
        stage = self._staging.get(name)
        if stage is not None:
            # every step ends reading its logits on the host, after this
            # copy, so the pinned buffer is free again by the next step
            src = stage.copy_(src)
        dst.copy_(src, non_blocking=stage is not None)

    def _decode_fn(self, tb: int) -> torch.Tensor:
        inp = self._inputs
        logits, _ = decode_step(
            self.params, self.cfg, self.cache, inp["tok"],
            patterns=self.patterns, dispatch=self.dispatch, active=inp["act"],
            t_bound=tb, bt=self._bt, packed_read=self.packed_read)
        return logits

    def _prefill_fn(self, tb: int) -> torch.Tensor:
        """The one-slot chunk: gather the slot's batch-of-one cache, run
        the chunk, scatter it back (the slot is a device index, so one
        graph serves every slot)."""
        inp, axes = self._inputs, self._batch_axes
        sub = tree_map(lambda leaf, ax: leaf.index_select(ax, inp["slot"]),
                       self.cache, axes)
        logits, _ = prefill_step(
            self.params, self.cfg, sub, inp["ptok"], patterns=self.patterns,
            dispatch=self.dispatch, n_valid=inp["nv"], t_bound=tb, bt=self._bt,
            packed_read=self.packed_read)
        tree_map(lambda leaf, s, ax: leaf.index_copy_(ax, inp["slot"], s),
                 self.cache, sub, axes)
        return logits

    def _drip_fn(self, tb: int) -> torch.Tensor:
        """One token for every slot, idle ones included (no ``active``
        mask, as the reference's legacy step)."""
        logits, _ = decode_step(
            self.params, self.cfg, self.cache, self._inputs["tok"],
            patterns=self.patterns, dispatch=self.dispatch, t_bound=tb,
            bt=self._bt, packed_read=self.packed_read)
        return logits

    def phase_fn(self, phase: str) -> Callable[[int], torch.Tensor]:
        """The eager step of ``phase`` ("decode" | "prefill" | "drip") at a
        bucket, over the static inputs."""
        return {"decode": self._decode_fn, "prefill": self._prefill_fn,
                "drip": self._drip_fn}[phase]

    def _step_logits(self, phase: str, tb: int) -> torch.Tensor:
        """Logits of one ``phase`` step ("decode" | "prefill" | "drip") at
        bucket ``tb`` over the static inputs: eager, or the bucket's graph.
        The first step at a bucket runs eagerly on the capture stream
        (which builds the kernel libraries and sets up every library handle
        for it), then is captured: capture records without running, so the
        cache advances once."""
        fn = functools.partial(self.phase_fn(phase), tb)
        if not self.capture:
            return fn()
        g = self._graphs.get((phase, tb))
        if g is not None:
            return g.replay()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self._graphs[(phase, tb)] = CapturedStep(fn, self._pool, self._stream)
        self._capture_s += time.perf_counter() - t0
        self._graph_bytes += torch.cuda.memory_reserved(self.device) - reserved
        return out

    def _step_prefill(self):
        """Advance the oldest prefilling slot by one chunk."""
        slot = self._order[0]
        req = self.active[slot]
        C = self.prefill_chunk
        pos = self.prompt_pos[slot]
        nv = min(C, len(req.prompt) - pos)
        toks = np.zeros((1, C), np.int32)
        toks[0, :nv] = req.prompt[pos:pos + nv]
        tb = self._bucket_t(int(self._len[slot]) + C)
        t0 = time.perf_counter()
        self._fill("ptok", toks)
        self._fill("nv", nv)
        self._fill("slot", slot)
        logits = self._step_logits("prefill", tb)
        nxt = int(torch.argmax(logits[0, nv - 1]).item())  # syncs
        now = time.perf_counter()
        self._stats["prefill_steps"] += 1
        self._stats["prefill_tokens"] += nv
        self._stats["prefill_ms"].append((now - t0) * 1e3)
        self.prompt_pos[slot] = pos + nv
        self._len[slot] += nv
        if self.prompt_pos[slot] == len(req.prompt):
            # the first generated token is the final chunk's last valid row
            self._order.pop(0)
            self._phase[slot] = "decode"
            if self.remaining[slot] > 0:
                self.last_tok[slot, 0] = nxt
                req.out.append(nxt)
                req.t_first = now
                self.remaining[slot] -= 1
            self._finish(slot, now)

    def _step_decode(self, dec_slots: List[int], phase: str = "decode"):
        """One token for every decoding slot; the others are masked out.
        ``phase="drip"`` steps every slot, idle ones included (no mask):
        the token drip of a family that does not chunk.  The SSM family
        reads no attention cache: one bucket (0) for all its steps."""
        tb = 0 if self.cfg.family == "ssm" else \
            self._bucket_t(max(int(self._len[s]) for s in dec_slots) + 1)
        t0 = time.perf_counter()
        self._fill("tok", self.last_tok)
        if phase == "decode":
            act = np.zeros(self.slots, np.int32)
            act[dec_slots] = 1
            self._fill("act", act)
        logits = self._step_logits(phase, tb)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        now = time.perf_counter()
        self._stats["decode_steps"] += 1
        self._stats["decode_tokens"] += len(dec_slots)
        self._stats["decode_ms"].append((now - t0) * 1e3)
        for slot in dec_slots:
            req = self.active[slot]
            self._len[slot] += 1
            pos = self.prompt_pos[slot]
            if pos < len(req.prompt):
                # token drip: still feeding the prompt
                self.last_tok[slot, 0] = int(req.prompt[pos])
                self.prompt_pos[slot] = pos + 1
                continue
            if self.remaining[slot] > 0:
                self.last_tok[slot, 0] = int(nxt[slot])
                req.out.append(int(nxt[slot]))
                if req.t_first is None:
                    req.t_first = now
                self.remaining[slot] -= 1
            self._finish(slot, now)

    def step(self) -> int:
        self._admit()
        if not self.active:
            return 0
        if not self._chunked:
            self._step_decode(sorted(self.active), "drip")
            return len(self.active)
        # the decode set is taken BEFORE the prefill advances: a slot that
        # finishes its prompt this step got its first token from the chunk
        dec_slots = sorted(s for s, ph in self._phase.items()
                           if ph == "decode" and s in self.active)
        if self._order:
            self._step_prefill()
        if dec_slots:
            self._step_decode(dec_slots)
        return len(self.active)

    def run(self) -> List[Request]:
        """Drain the engine; returns every request submitted since the
        last ``run()``."""
        while self.queue or self.active:
            self.step()
        out, self._unreturned = self._unreturned, []
        return out
