"""Sub-quadratic sequence blocks: mLSTM / sLSTM (xLSTM) and Mamba2 (SSD).

The full-sequence forward runs the chunkwise-parallel forms (chunks of
:data:`CHUNK` positions, a Python loop over chunks in place of the
reference's ``lax.scan``); decode runs the one-step recurrences over
explicit state caches, which it updates IN PLACE.  The gates follow the
reference (``repro.models.ssm``): sigmoid input gates, no exponential
stabiliser.  q, k, v, the gates and every state are f32; the mixed output
is cast to the activation dtype before the output projection.

This is plain torch on the card too: the reference computes these
recurrences in plain ``jnp`` outside any Pallas kernel.  Every projection
goes through the compressed-linear dispatch with the step's ``dispatch``.
Above-diagonal decay terms are masked by select before the ``exp`` (a
multiply by a 0/1 mask would turn their ``inf`` into NaN).

A placed (DTensor) input runs each block's leg in
:mod:`repro_torch.core.sharded` (``mamba2``, ``mlstm``, ``slstm``), whose
local functions and layouts are this module's: at a ``model`` axis of one
rank the unplaced arithmetic itself (:func:`_mamba_mix`, :func:`_mlstm_mix`,
:func:`_slstm_run`), past it each rank's part (:func:`mamba_part` on the
rank's channels of :func:`mamba_layout`; :func:`mlstm_state_part` /
:func:`mlstm_out_part` on its key slice of :func:`mlstm_layout`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import sharded
from .blocks import _dtype
from .config import ArchConfig
from .layers import Params, linear_apply, linear_init

__all__ = ["CHUNK", "MAMBA_CONV", "MAMBA_HEADDIM", "mamba2_apply",
           "mamba2_cache_init", "mamba2_init", "mamba_layout", "mamba_part",
           "mlstm_apply", "mlstm_cache_init", "mlstm_init", "mlstm_layout",
           "mlstm_out_part", "mlstm_state_part", "slstm_apply",
           "slstm_cache_init", "slstm_init"]

CHUNK = 256
MAMBA_HEADDIM = 64
MAMBA_CONV = 4

F32 = torch.float32


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|)), no threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _pad_chunks(x: torch.Tensor, L: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``x`` to a multiple of ``L``."""
    pad = (-x.shape[1]) % L
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def _ssm_mode(cfg: ArchConfig) -> str:
    """The SSM projections' init mode: int8 under an int8 datapath, else
    dense (the reference plumbs sparse patterns through attention and the
    MLP only)."""
    return "int8" if cfg.linear_mode in ("int8", "sparse_int8") else "dense"


def _causal(L: int, device) -> torch.Tensor:
    return torch.ones((L, L), dtype=torch.bool, device=device).tril()


# ======================================================================= mLSTM


def mlstm_init(gen: torch.Generator, cfg: ArchConfig,
               lead: Tuple[int, ...] = ()) -> Params:
    D, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    dt, m = _dtype(cfg), _ssm_mode(cfg)
    return {
        "wq": linear_init(gen, D, di, dtype=dt, mode=m, lead=lead),
        "wk": linear_init(gen, D, di, dtype=dt, mode=m, lead=lead),
        "wv": linear_init(gen, D, di, dtype=dt, mode=m, lead=lead),
        "wif": linear_init(gen, D, 2 * H, dtype=dt, lead=lead),  # i, f gates
        "wo": linear_init(gen, di, D, dtype=dt, mode=m, lead=lead),
        "wog": linear_init(gen, D, di, dtype=dt, lead=lead),      # out gate
    }


def _mlstm_gates(gif: torch.Tensor, H: int):
    """The log input and forget gates (B, T, H) from ``wif``'s output (B,
    T, 2H): the i gates, then the f gates."""
    B, T, _ = gif.shape
    g = gif.to(F32).reshape(B, T, 2, H)
    return _log_sigmoid(g[:, :, 0]), _log_sigmoid(g[:, :, 1])


def _mlstm_mix(q, k, v, gif, og, H: int, S=None, n=None) -> torch.Tensor:
    """The mLSTM between its projections: ``q``, ``k``, ``v``, ``og`` (B,
    T, di) and ``gif`` (B, T, 2H) as the linears give them; returns y (B, T,
    di) f32, the out gate applied.  With ``S`` (B, H, P, P) and ``n`` (B,
    H, P) one recurrent step (T == 1), both updated in place; without, the
    chunkwise form from a zero state.  One rank's parts over every key
    feature and output column (:func:`mlstm_state_part`,
    :func:`mlstm_out_part`)."""
    P = q.shape[-1] // H
    scores, inter, innr = mlstm_state_part(q, k, v, gif, H, P, S, n)
    return mlstm_out_part(scores, inter, innr, v, gif, og, 0, P)


def mlstm_state_part(q, k, v, gif, H: int, P: int, S=None, n=None):
    """A rank's part of the mLSTM on its slice of the key feature axis
    (:func:`repro_torch.core.sharded.mlstm`): ``q``, ``k`` (B, T, H·Pr)
    hold columns ``[p0, p0 + Pr)`` of every head (``P`` the whole head
    width), ``v`` (B, T, H·P) all of them, ``gif`` (B, T, 2H).  The
    products over the key features are partial sums over the slice, and
    the carried state is the slice's rows, so the ranks' parts add up to
    one process's.

    Returns ``(scores, inter, innr)`` in f32: the chunks' partial ``q·kᵀ``
    (B, NC, H, L, L), before the decay mask; the partial inter-chunk terms
    ``qd @ S`` (B, T, H·P) and ``qd · n`` (B, T, H).  With ``S`` (B, H, Pr,
    P) and ``n`` (B, H, Pr), one recurrent step (T == 1) that updates both
    in place, and ``scores`` None."""
    B, T, _ = q.shape
    Pr = q.shape[-1] // H
    q = q.reshape(B, T, H, Pr).to(F32) / math.sqrt(P)
    k = k.reshape(B, T, H, Pr).to(F32)
    v = v.reshape(B, T, H, P).to(F32)
    li, lf = _mlstm_gates(gif, H)
    if S is not None:
        f = torch.exp(lf[:, 0])[..., None, None]
        i = torch.exp(li[:, 0])[..., None, None]
        q0, k0, v0 = q[:, 0], k[:, 0], v[:, 0]
        S.mul_(f).add_(i * (k0[..., :, None] * v0[..., None, :]))
        n.mul_(f[..., 0]).add_(i[..., 0] * k0)
        inter = (q0[..., None, :] @ S)[..., 0, :]        # (B, H, P)
        return None, inter.reshape(B, 1, H * P), (q0 * n).sum(-1)[:, None]
    L = min(CHUNK, T)
    qp, kp, vp = (_pad_chunks(a, L) for a in (q, k, v))
    lip, lfp = _pad_chunks(li, L), _pad_chunks(lf, L)
    NC = qp.shape[1] // L

    def resh(a):  # (B, NC*L, H, X) -> (NC, B, H, L, X)
        return a.reshape(B, NC, L, H, -1).permute(1, 0, 3, 2, 4)

    qc, kc, vc = resh(qp), resh(kp), resh(vp)
    lic = lip.reshape(B, NC, L, H).permute(1, 0, 3, 2)
    lfc = lfp.reshape(B, NC, L, H).permute(1, 0, 3, 2)
    S = q.new_zeros((B, H, Pr, P))
    n = q.new_zeros((B, H, Pr))
    scores, inter, innr = [], [], []
    for c in range(NC):
        qb, kb = qc[c], kc[c]
        cum = torch.cumsum(lfc[c], dim=-1)
        scores.append(qb @ kb.transpose(-1, -2))         # (B, H, L, L)
        qd = qb * torch.exp(cum)[..., None]
        inter.append(qd @ S)                             # (B, H, L, P)
        innr.append((qd @ n[..., None])[..., 0])         # (B, H, L)
        w = torch.exp(cum[..., -1:] - cum + lic[c])
        kw = kb * w[..., None]
        d_all = torch.exp(cum[..., -1])
        S = d_all[..., None, None] * S + kw.transpose(-1, -2) @ vc[c]
        n = d_all[..., None] * n + kw.sum(dim=-2)
    inter = torch.stack(inter).permute(1, 0, 3, 2, 4).reshape(
        B, NC * L, H * P)[:, :T]
    innr = torch.stack(innr).permute(1, 0, 3, 2).reshape(B, NC * L, H)[:, :T]
    return torch.stack(scores, dim=1), inter, innr


def mlstm_out_part(scores, inter, innr, v, gif, og, h0: int, P: int):
    """A rank's output columns of the mLSTM from the summed parts of
    :func:`mlstm_state_part`: ``inter``, ``v`` and ``og`` (B, T, C) hold
    the rank's C columns, which start at column ``h0·P + p0`` of head
    ``h0`` and are whole heads or part of that one; ``scores`` (B, NC, H,
    L, L) (None for a recurrent step) and ``innr`` (B, T, H) are whole.
    The intra-chunk output and normaliser are the decayed scores against
    the rank's columns of v; returns y (B, T, C) f32, normalised and
    gated."""
    B, T, C = inter.shape
    H = gif.shape[-1] // 2
    Pl = min(P, C)
    Hl = C // Pl
    heads = slice(h0, h0 + Hl)
    num = inter.reshape(B, T, Hl, Pl)
    den = innr[..., heads]
    if scores is not None:
        NC, L = scores.shape[1], scores.shape[-1]
        vp = _pad_chunks(v.reshape(B, T, Hl, Pl).to(F32), L)
        vc = vp.reshape(B, NC, L, Hl, Pl).permute(0, 1, 3, 2, 4)
        # the decay of every head, as one process sums it, then the rank's
        li, lf = (_pad_chunks(g, L).reshape(B, NC, L, H).permute(0, 1, 3, 2)
                  for g in _mlstm_gates(gif, H))
        cum = torch.cumsum(lf, dim=-1)[:, :, heads]
        lic = li[:, :, heads]
        diff = cum[..., :, None] - cum[..., None, :] + lic[..., None, :]
        A = torch.exp(torch.where(_causal(L, v.device), diff,
                                  torch.full_like(diff, float("-inf"))))
        s = scores[:, :, heads] * A                      # (B, NC, Hl, L, L)
        y_in = (s @ vc).permute(0, 1, 3, 2, 4).reshape(B, NC * L, Hl, Pl)
        n_in = (s @ s.new_ones((L, 1)))[..., 0].permute(0, 1, 3, 2)
        num = y_in[:, :T] + num
        den = n_in.reshape(B, NC * L, Hl)[:, :T] + den
    y = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    return y.reshape(B, T, C) * torch.sigmoid(og.to(F32))


@functools.lru_cache(maxsize=None)
def mlstm_layout(H: int, P: int, n: int, r: int, device) -> Dict:
    """Rank ``r`` of ``n``'s part of the placed mLSTM
    (:func:`repro_torch.core.sharded.mlstm`), made once a device: key
    features ``[p0, p1)`` (:func:`~repro_torch.core.sharded.even_range` of
    P) of every head, ``take`` the :class:`~repro_torch.core.sharded.
    ColTake` of those q / k columns; its output columns ``[c0, c1)`` of the
    H·P from head ``h0`` where n divides them (``cols_cut``), else all."""
    keys = [(np.arange(H)[:, None] * P
             + np.arange(*sharded.even_range(P, n, s))[None]).reshape(-1)
            for s in range(n)]
    di = H * P
    cut = di % n == 0
    c0, c1 = sharded.even_range(di, n, r) if cut else (0, di)
    p0, p1 = sharded.even_range(P, n, r)
    return {"take": sharded.col_take(keys, di, r, device), "p0": p0,
            "p1": p1, "cols_cut": cut, "c0": c0, "c1": c1,
            "h0": sharded.regular_heads(c0, c1, P)[0]}


def mlstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Optional[Dict] = None, dispatch=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, T, D) -> (B, T, D).  With ``cache`` ({"S": (B, H, P, P), "n":
    (B, H, P)}, T == 1) one recurrent step, the state updated in place and
    returned; without, the chunkwise form from a zero state (returns
    None).  A placed x runs :func:`repro_torch.core.sharded.mlstm`."""
    H = cfg.n_heads

    def proj(name):
        return linear_apply(p[name], x, dispatch=dispatch,
                            leaf=f"mlstm/{name}")

    q, k, v, gif, og = (proj(n) for n in ("wq", "wk", "wv", "wif", "wog"))
    if sharded.is_dtensor(x):
        P = cfg.d_inner // H
        y = sharded.mlstm(
            q, k, v, gif, og, H=H, cache=cache, dtype=x.dtype,
            whole=lambda *a, S=None, n=None: _mlstm_mix(*a, H, S, n),
            layout=lambda *a: mlstm_layout(H, P, *a),
            state_part=mlstm_state_part, out_part=mlstm_out_part)
    else:
        y = _mlstm_mix(q, k, v, gif, og, H,
                       *((cache["S"], cache["n"]) if cache is not None
                         else ())).to(x.dtype)
    return linear_apply(p["wo"], y, dispatch=dispatch,
                        leaf="mlstm/wo"), cache


def mlstm_cache_init(cfg: ArchConfig, batch: int,
                     lead: Tuple[int, ...] = (), device=None) -> Dict:
    H, P = cfg.n_heads, cfg.d_inner // cfg.n_heads
    return {"S": torch.zeros(lead + (batch, H, P, P), dtype=F32,
                             device=device),
            "n": torch.zeros(lead + (batch, H, P), dtype=F32, device=device)}


# ======================================================================= sLSTM


def slstm_init(gen: torch.Generator, cfg: ArchConfig,
               lead: Tuple[int, ...] = ()) -> Params:
    D, H = cfg.d_model, cfg.n_heads
    P = D // H
    dt = _dtype(cfg)
    r = torch.randn(lead + (H, P, 4 * P), generator=gen, dtype=F32,
                    device=gen.device)
    return {
        "wx": linear_init(gen, D, 4 * D, dtype=dt, lead=lead),
        # recurrent weights, block-diagonal per head: (H, P, 4P)
        "r": (r / math.sqrt(P)).to(dt),
        "b": torch.zeros(lead + (4 * D,), dtype=dt, device=gen.device),
    }


def _slstm_step(r32, b32, H, xw, state):
    """xw: (B, 4D) the step's W x_t; state: h, c, n each (B, D) f32;
    ``r32`` / ``b32`` the recurrent weights and bias in f32."""
    h, c, n = state
    B, D = h.shape
    P = D // H
    rh = torch.bmm(h.reshape(B, H, P).transpose(0, 1), r32)   # (H, B, 4P)
    rh = rh.transpose(0, 1).reshape(B, 4 * D)
    g = xw.to(F32) + rh + b32
    i, f, z, o = torch.chunk(g, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    z = torch.tanh(z)
    c = f * c + i * z
    n = f * n + i
    h = o * (c / torch.clamp_min(n, 1.0))
    return h, c, n


def _slstm_run(xw, r, b, H: int, cache: Optional[Dict] = None):
    """The sLSTM after its input projection: ``xw`` (B, T, 4D) -> the h
    states (B, T, D) f32.  With ``cache`` ({"h", "c", "n"}: (B, D) f32, T
    == 1) one step, the state updated in place; without, a loop of T steps
    from a zero state."""
    r32, b32 = r.to(F32), b.to(F32)
    if cache is not None:
        h, c, n = _slstm_step(r32, b32, H, xw[:, 0],
                              (cache["h"], cache["c"], cache["n"]))
        cache["h"].copy_(h)
        cache["c"].copy_(c)
        cache["n"].copy_(n)
        return h[:, None]
    B, T, D4 = xw.shape
    z = xw.new_zeros((B, D4 // 4), dtype=F32)
    state, hs = (z, z, z), []
    for t in range(T):
        state = _slstm_step(r32, b32, H, xw[:, t], state)
        hs.append(state[0])
    return torch.stack(hs, dim=1)


def slstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Optional[Dict] = None, dispatch=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, T, D) -> the h states (B, T, D) in x's dtype.  With ``cache``
    ({"h", "c", "n"}: (B, D) f32, T == 1) one step, the state updated in
    place; without, a loop of T steps from a zero state.  A placed x runs
    :func:`repro_torch.core.sharded.slstm`."""
    xw = linear_apply(p["wx"], x, dispatch=dispatch, leaf="slstm/wx")
    H = cfg.n_heads
    if sharded.is_dtensor(xw):
        return sharded.slstm(
            xw, p["r"], p["b"], cache=cache, dtype=x.dtype,
            run=lambda xw_, r_, b_, c_: _slstm_run(xw_, r_, b_, H, c_)), \
            cache
    return _slstm_run(xw, p["r"], p["b"], H, cache).to(x.dtype), cache


def slstm_cache_init(cfg: ArchConfig, batch: int,
                     lead: Tuple[int, ...] = (), device=None) -> Dict:
    return {k: torch.zeros(lead + (batch, cfg.d_model), dtype=F32,
                           device=device) for k in ("h", "c", "n")}


# ====================================================================== Mamba2


def mamba2_init(gen: torch.Generator, cfg: ArchConfig,
                lead: Tuple[int, ...] = ()) -> Params:
    D, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = di // MAMBA_HEADDIM
    dt, m = _dtype(cfg), _ssm_mode(cfg)
    d_xbc = di + 2 * N
    dev = gen.device
    conv = torch.randn(lead + (MAMBA_CONV, d_xbc), generator=gen, dtype=F32,
                       device=dev)
    return {
        "win": linear_init(gen, D, di + d_xbc + H, dtype=dt, mode=m,
                           lead=lead),                     # z, xBC, dt
        "conv": (conv * 0.1).to(dt),
        "a_log": torch.zeros(lead + (H,), dtype=F32, device=dev),
        "d_skip": torch.ones(lead + (H,), dtype=F32, device=dev),
        "dt_bias": torch.zeros(lead + (H,), dtype=F32, device=dev),
        "wout": linear_init(gen, di, D, dtype=dt, mode=m, lead=lead),
    }


def _mamba_conv(zxd: torch.Tensor, conv_w: torch.Tensor, dt_bias, N: int,
                P: int, conv_state: Optional[torch.Tensor] = None):
    """Everything between ``win`` and the scan, for Hl heads of P channels:
    ``zxd`` (B, T, 2·Hl·P + 2N + Hl) laid out as ``win``'s output — z, then
    xBC (x, B, C), then dt — and ``conv_w`` (W, Hl·P + 2N) the conv
    kernel of those xBC channels.  The causal width-4 conv over xBC (f32,
    from ``conv_state`` (B, 3, Hl·P + 2N) or zeros), then SiLU; softplus on
    dt.  Returns z, xs (B, T, Hl, P), Bm, Cm (B, T, N), dt (B, T, Hl) and
    the new conv state (the window's last 3 rows; None for a zero-start
    sequence shorter than 3)."""
    B, T, width = zxd.shape
    Hl = (width - 2 * N) // (2 * P + 1)
    dl = Hl * P
    z = zxd[..., :dl]
    xBC = zxd[..., dl:2 * dl + 2 * N]
    dt_raw = zxd[..., 2 * dl + 2 * N:]
    kern = conv_w.to(F32)                           # (W, d_xbc)
    xf = xBC.to(F32)
    W = MAMBA_CONV
    if conv_state is None:
        window = torch.cat([xf.new_zeros((B, W - 1, xf.shape[-1])), xf], 1)
        new_state = window[:, -(W - 1):] if T >= W - 1 else None
    else:
        window = torch.cat([conv_state, xf], dim=1)  # (B, W-1+T, d)
        new_state = window[:, -(W - 1):]
    conv = sum(window[:, i:i + T] * kern[i] for i in range(W))
    conv = _silu(conv)
    xs = conv[..., :dl].reshape(B, T, Hl, P)
    Bm = conv[..., dl:dl + N]
    Cm = conv[..., dl + N:]
    dtv = _softplus(dt_raw.to(F32) + dt_bias)       # (B, T, Hl)
    return z, xs, Bm, Cm, dtv, new_state


def _mamba_proj(p: Params, cfg: ArchConfig, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None, dispatch=None):
    """The shared projection, then :func:`_mamba_conv` over all the
    heads.  Returns z, xs (B, T, H, 64), Bm, Cm (B, T, N), dt (B, T, H) and
    the new conv state."""
    zxd = linear_apply(p["win"], x, dispatch=dispatch, leaf="mamba/win")
    return _mamba_conv(zxd, p["conv"], p["dt_bias"], cfg.ssm_state,
                       MAMBA_HEADDIM, conv_state)


def _mamba_ssd(z, xs, Bm, Cm, dtv, a_log, d_skip,
               S: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SSD scan of :func:`_mamba_conv`'s outputs over their Hl heads
    (``a_log``, ``d_skip`` (Hl,)), the skip and the z gate: y (B, T, Hl·P)
    f32.  With ``S`` (B, Hl, P, N) one recurrent step (T == 1) that
    updates it in place; without, the chunkwise form from a zero state."""
    B, T, Hl, P = xs.shape
    N = Bm.shape[-1]
    A = -torch.exp(a_log)                           # (Hl,) negative
    if S is not None:
        d0, x0 = dtv[:, 0], xs[:, 0]
        dec = torch.exp(A * d0)                     # (B, H)
        dBx = (d0[..., None] * x0)[..., :, None] * Bm[:, 0][:, None, None, :]
        S.mul_(dec[..., None, None]).add_(dBx)
        y = (S @ Cm[:, 0][:, None, :, None])[..., 0]  # (B, H, P)
        y = y + d_skip[None, :, None] * x0
        return y.reshape(B, 1, Hl * P) * _silu(z.to(F32))

    L = min(CHUNK, T)
    # padded steps have dt = x = B = 0: they never reach the output
    xs_p, Bp, Cp, dp = (_pad_chunks(a, L) for a in (xs, Bm, Cm, dtv))
    NC = xs_p.shape[1] // L
    xc = xs_p.reshape(B, NC, L, Hl, P).permute(1, 0, 3, 2, 4)  # (NC,B,H,L,P)
    Bc = Bp.reshape(B, NC, L, N).permute(1, 0, 2, 3)           # (NC,B,L,N)
    Cc = Cp.reshape(B, NC, L, N).permute(1, 0, 2, 3)
    dc = dp.reshape(B, NC, L, Hl).permute(1, 0, 3, 2)          # (NC,B,H,L)
    causal = _causal(L, xs.device)
    S = xs.new_zeros((B, Hl, P, N))
    ys = []
    for c in range(NC):
        xb, Bb, Cb, db = xc[c], Bc[c], Cc[c], dc[c]
        la = torch.cumsum(A[None, :, None] * db, dim=-1)     # (B,H,L) <= 0
        diff = la[..., :, None] - la[..., None, :]           # (B,H,L,L)
        M = torch.exp(torch.where(causal, diff,
                                  torch.full_like(diff, float("-inf")))) \
            * db[..., None, :]
        cb = Cb @ Bb.transpose(-1, -2)                       # (B,L,L)
        y_in = (M * cb[:, None]) @ xb                        # (B,H,L,P)
        y_x = (Cb[:, None] @ S.transpose(-1, -2))            # (B,H,L,P)
        ys.append(y_in + torch.exp(la)[..., None] * y_x)
        w = torch.exp(la[..., -1:] - la) * db                # (B,H,L)
        dBx = (xb * w[..., None]).transpose(-1, -2) @ Bb[:, None]  # (B,H,P,N)
        S = torch.exp(la[..., -1])[..., None, None] * S + dBx
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(
        B, NC * L, Hl * P)[:, :T]
    y = y + (d_skip[None, None, :, None] * xs).reshape(B, T, Hl * P)
    return y * _silu(z.to(F32))


def _mamba_mix(zxd, conv_w, dt_bias, a_log, d_skip, N: int, P: int,
               conv_state=None, S=None):
    """The Mamba2 block between ``win`` and ``wout`` on Hl heads of P
    channels (:func:`_mamba_conv`, then :func:`_mamba_ssd`): y (B, T, Hl·P)
    f32 and the new conv state.  On all the heads, the unplaced block; on
    a rank's channels, its part of the placed one
    (:func:`repro_torch.core.sharded.mamba2`)."""
    z, xs, Bm, Cm, dtv, new_state = _mamba_conv(zxd, conv_w, dt_bias, N, P,
                                                conv_state)
    return _mamba_ssd(z, xs, Bm, Cm, dtv, a_log, d_skip, S), new_state


@functools.lru_cache(maxsize=None)
def _mamba_cols(H: int, P: int, N: int, n: int, conv_cut: bool) -> tuple:
    """Each rank's block of a Mamba2 block of H heads of P channels and
    state N placed over n ranks (:func:`mamba_layout`), in numpy: its
    channels ``[c0, c1)`` of the di = H·P as Hl heads of Pl from head
    ``h0``; ``mine``, the ``win`` output columns of its block — its z, its
    x, all of B and C, its heads' dt — in the layout :func:`_mamba_conv`
    reads; ``conv``, the conv channels of its x and B, C; ``state``, the
    conv-state channels it writes (its shard ``conv_cut``, else all);
    ``raw``, the ``win`` columns of those; ``want``, the sorted union of
    ``mine`` and ``raw``, with ``at_mine`` / ``at_raw`` their positions in
    it."""
    di = H * P
    dxbc = di + 2 * N
    ar = np.arange
    out = []
    for r in range(n):
        c0, c1 = sharded.even_range(di, n, r)
        h0, Hl, Pl = sharded.regular_heads(c0, c1, P)
        mine = np.concatenate([ar(c0, c1), di + ar(c0, c1),
                               2 * di + ar(2 * N),
                               2 * di + 2 * N + ar(h0, h0 + Hl)])
        s0, s1 = sharded.even_range(dxbc, n, r) if conv_cut else (0, dxbc)
        raw = di + ar(s0, s1)
        want = np.union1d(mine, raw)
        out.append({"c0": c0, "c1": c1, "h0": h0, "Hl": Hl, "Pl": Pl,
                    "mine": mine,
                    "conv": np.concatenate([ar(c0, c1), di + ar(2 * N)]),
                    "state": (s0, s1), "want": want,
                    "at_mine": np.searchsorted(want, mine),
                    "at_raw": np.searchsorted(want, raw)})
    return tuple(out)


@functools.lru_cache(maxsize=None)
def mamba_layout(H: int, P: int, N: int, n: int, r: int, conv_cut: bool,
                 decode: bool, device) -> Dict:
    """Rank ``r`` of ``n``'s part of the placed Mamba2 block
    (:func:`repro_torch.core.sharded.mamba2`), its index tensors made once
    a device: ``c0``, ``c1``, ``h0``, ``Hl``, ``Pl`` and ``state`` as
    :func:`_mamba_cols` gives them; ``take``, the
    :class:`~repro_torch.core.sharded.ColTake` of the ``win`` columns it
    takes (``mine``, and decoding also the raw xBC of its conv-state
    shard), ``at_mine`` / ``at_raw`` their positions there; ``kern``, its
    conv channels; decoding, ``conv_take``, that of the conv-state
    channels its conv reads."""
    lays = _mamba_cols(H, P, N, n, conv_cut)
    lay = lays[r]
    di = H * P

    def idx(a):
        return torch.as_tensor(a, device=device)

    key = "want" if decode else "mine"
    out = {k: lay[k] for k in ("c0", "c1", "h0", "Hl", "Pl", "state")}
    out.update(take=sharded.col_take([lt[key] for lt in lays],
                                     2 * di + 2 * N + H, r, device),
               at_mine=idx(lay["at_mine"] if decode
                           else np.arange(len(lay["mine"]))),
               kern=idx(lay["conv"]))
    if decode:
        out.update(conv_take=sharded.col_take([lt["conv"] for lt in lays],
                                              di + 2 * N, r, device),
                   at_raw=idx(lay["at_raw"]))
    return out


def mamba_part(got, conv_w, dt_bias, a_log, d_skip, lay: Dict, N: int,
               P: int, conv_state=None, conv_out=None, S=None,
               S_own: bool = False) -> torch.Tensor:
    """A rank's part of the placed Mamba2 block
    (:func:`repro_torch.core.sharded.mamba2`) from the ``win`` columns
    ``lay["take"].cols`` that it took, ``got`` (B, T, ·), with its layout
    ``lay`` (:func:`mamba_layout`): :func:`_mamba_mix` on its block (its
    channels of the whole conv kernel ``conv_w`` and of the per-head
    vectors), from ``conv_state`` (its conv channels) and ``S`` — its
    heads' shard (``S_own``) or the whole state, of which it updates its
    channels in place.  Decoding, it writes its shard of the conv state,
    ``conv_out``, in place: the last 3 raw xBC rows.  Returns y (B, T,
    Hl·Pl) f32."""
    h0, Hl, Pl = lay["h0"], lay["Hl"], lay["Pl"]
    heads = slice(h0, h0 + Hl)
    if S is not None and not S_own:
        p0 = lay["c0"] - h0 * P
        S = S[:, heads, p0:p0 + Pl]
    y, _ = _mamba_mix(got.index_select(-1, lay["at_mine"]),
                      conv_w.index_select(-1, lay["kern"]), dt_bias[heads],
                      a_log[heads], d_skip[heads], N, Pl,
                      conv_state=conv_state, S=S)
    if conv_out is not None:
        raw = got.index_select(-1, lay["at_raw"]).to(conv_out.dtype)
        conv_out.copy_(torch.cat([conv_out, raw], 1)[:, 1 - MAMBA_CONV:])
    return y


def mamba2_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Optional[Dict] = None, dispatch=None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, T, D) -> (B, T, D).  With ``cache`` ({"S": (B, H, 64, N),
    "conv": (B, 3, d_xbc)}, T == 1) one recurrent step, both states
    updated in place; without, the chunkwise form from zero states
    (returns None).  A placed x runs :func:`repro_torch.core.sharded.
    mamba2`."""
    N = cfg.ssm_state
    zxd = linear_apply(p["win"], x, dispatch=dispatch, leaf="mamba/win")
    leaves = (p["conv"], p["dt_bias"], p["a_log"], p["d_skip"])
    if sharded.is_dtensor(zxd):
        H, P = cfg.d_inner // MAMBA_HEADDIM, MAMBA_HEADDIM
        y = sharded.mamba2(
            zxd, *leaves, cache=cache, dtype=x.dtype,
            whole=lambda *a, **kw: _mamba_mix(*a, N, P, **kw),
            layout=lambda *a: mamba_layout(H, P, N, *a),
            part=lambda *a, **kw: mamba_part(*a, N=N, P=P, **kw))
    else:
        y, new_state = _mamba_mix(
            zxd, *leaves, N, MAMBA_HEADDIM,
            *((cache["conv"], cache["S"]) if cache is not None else ()))
        if cache is not None:
            cache["conv"].copy_(new_state)
        y = y.to(x.dtype)
    return linear_apply(p["wout"], y, dispatch=dispatch,
                        leaf="mamba/wout"), cache


def mamba2_cache_init(cfg: ArchConfig, batch: int,
                      lead: Tuple[int, ...] = (), device=None) -> Dict:
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // MAMBA_HEADDIM
    return {"S": torch.zeros(lead + (batch, H, MAMBA_HEADDIM, N), dtype=F32,
                             device=device),
            "conv": torch.zeros(lead + (batch, MAMBA_CONV - 1, di + 2 * N),
                                dtype=F32, device=device)}
