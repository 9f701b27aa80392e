"""Batched serving engine: continuous batching with chunked prefill.

Prompts run through :func:`repro_torch.models.model.prefill_step` in
fixed-size chunks (``prefill_chunk`` tokens, the per-step prefill budget),
writing straight into the cache container; every engine step advances ONE
prefilling slot by one chunk AND every decoding slot by one token
(``decode_step`` with an ``active`` mask), so a long prompt never stalls
the decoding slots.  The first generated token comes from the final
chunk's logits.  A prompt whose chunk schedule cannot fit the cache
(``ceil(P/C)·C > max_len``) falls back to a token drip for that request.

Prefill works on a batch-of-one view of the slot's cache, so a chunk write
cannot touch a neighbouring slot.  Cache reads are bounded to a
power-of-two extent (``_bucket_t``) with the kv tile size pinned at
startup — the packed read skips dead tiles, so the bound changes the work,
never the result.  PyTorch runs eagerly: the bucket is only the read
extent, nothing is compiled per bucket.

``stats()`` reports per-phase step counts, token counts and per-step
wall-clock; each :class:`Request` carries ``t_submit`` / ``t_first`` /
``t_done`` stamps (TTFT = t_first - t_submit).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.compile_sparse import CompressedModel
from ..core.dispatch import ATTN_BT_DEFAULT, resolve
from ..device import resolve_device
from ..models.config import ArchConfig
from ..models.model import cache_batch_axes, decode_step, init_cache, prefill_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (T,) int32
    max_new_tokens: int = 16
    out: Optional[List[int]] = None  # generated tokens
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class ServeEngine:
    """``params`` may be a raw parameter tree or a
    :class:`repro_torch.core.compile_sparse.CompressedModel`, served
    straight from its compacted leaves with its pattern table.  Params must
    live on ``device`` (CUDA unless ``device="cpu"``).

    ``dispatch`` picks kernel or plain version for the compiled leaves
    ("auto" | "kernel" | "twin", None = ``REPRO_TORCH_DISPATCH``).
    ``kv_cache`` is ``"float"`` or ``"int4x2"`` (bit-packed int4 codes +
    per-row scales, read by the packed attention kernel at a kv tile of
    :data:`ATTN_BT_DEFAULT` rows, pinned for the engine's lifetime).
    """

    def __init__(self, params, cfg: ArchConfig, *, batch_slots: int = 4,
                 max_len: int = 256, patterns=None, dispatch=None,
                 kv_cache: str = "float", prefill_chunk: int = 16,
                 device=None):
        if isinstance(params, CompressedModel):
            patterns = params.patterns if patterns is None else patterns
            params = params.params
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed']['w'].device}, the engine "
                f"runs on {self.device}")
        self.params = params
        self.patterns = patterns
        self.dispatch = resolve(dispatch)
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.kv_cache = kv_cache
        self.prefill_chunk = max(1, int(prefill_chunk))
        self._bt = ATTN_BT_DEFAULT if kv_cache == "int4x2" else None
        self.cache = init_cache(cfg, batch_slots, max_len, kv_cache=kv_cache,
                                device=self.device)
        self._batch_axes = cache_batch_axes(cfg, kv_cache=kv_cache)
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
                   for t in self.cache.values())

    def stats(self) -> Dict:
        """Per-phase counters: step counts, token counts, per-step ms."""
        out = dict(self._stats)
        out["prefill_ms"] = list(self._stats["prefill_ms"])
        out["decode_ms"] = list(self._stats["decode_ms"])
        return out

    def tokens_processed(self) -> int:
        """Total tokens pushed through the model (prefill + decode)."""
        return int(self._stats["prefill_tokens"]
                   + self._stats["decode_tokens"])

    def _reset_slot(self, slot: int):
        """Zero one slot of every cache leaf along its batch axis."""
        for k, leaf in self.cache.items():
            leaf.select(self._batch_axes[k], slot).zero_()

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
            if self._chunk_fits(req):
                self._phase[slot] = "prefill"
                self.prompt_pos[slot] = 0
                self._order.append(slot)
            else:
                # token drip: the rounded-up chunk schedule overruns the cache
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

    def _as_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        sub = {k: leaf.narrow(self._batch_axes[k], slot, 1)
               for k, leaf in self.cache.items()}
        t0 = time.perf_counter()
        logits, _ = prefill_step(
            self.params, self.cfg, sub, self._as_device(toks),
            patterns=self.patterns, dispatch=self.dispatch,
            n_valid=self._as_device(np.array([nv], np.int32)), t_bound=tb,
            bt=self._bt)
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

    def _step_decode(self, dec_slots: List[int]):
        """One token for every decoding slot; the others are masked out."""
        act = np.zeros(self.slots, np.int32)
        act[dec_slots] = 1
        tb = self._bucket_t(max(int(self._len[s]) for s in dec_slots) + 1)
        t0 = time.perf_counter()
        logits, _ = decode_step(
            self.params, self.cfg, self.cache, self._as_device(self.last_tok),
            patterns=self.patterns, dispatch=self.dispatch,
            active=self._as_device(act), t_bound=tb, bt=self._bt)
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
                # drip fallback: still feeding the prompt
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
