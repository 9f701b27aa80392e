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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from .blocks import _dtype
from .config import ArchConfig
from .layers import Params, linear_apply, linear_init

__all__ = ["CHUNK", "MAMBA_CONV", "MAMBA_HEADDIM", "mamba2_apply",
           "mamba2_cache_init", "mamba2_init", "mlstm_apply",
           "mlstm_cache_init", "mlstm_init", "slstm_apply",
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


def _mlstm_chunk(q, k, v, li, lf):
    """One chunk of the chunkwise mLSTM, batched over (B, H).

    q, k, v: (B, H, L, P); li, lf: (B, H, L) log input / forget gates.
    Returns (y_intra, n_intra, S_c, n_c, cum): the chunk's own output and
    normaliser, its contribution to the carried state and normaliser, and
    the cumulative log forget gate."""
    L = q.shape[-2]
    cum = torch.cumsum(lf, dim=-1)                 # log prod_{u<=t} f_u
    # A[t, s] = exp(cum_t - cum_s + li_s) for s <= t
    diff = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    A = torch.exp(torch.where(_causal(L, q.device), diff,
                              torch.full_like(diff, float("-inf"))))
    s = (q @ k.transpose(-1, -2)) * A              # (B, H, L, L)
    y_intra = s @ v                                # (B, H, L, P)
    n_intra = (s @ s.new_ones((L, 1)))[..., 0]     # (B, H, L)
    w = torch.exp(cum[..., -1:] - cum + li)        # (B, H, L)
    kw = k * w[..., None]
    S_c = kw.transpose(-1, -2) @ v                 # (B, H, P, P)
    n_c = kw.sum(dim=-2)                           # (B, H, P)
    return y_intra, n_intra, S_c, n_c, cum


def mlstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Optional[Dict] = None, dispatch=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, T, D) -> (B, T, D).  With ``cache`` ({"S": (B, H, P, P), "n":
    (B, H, P)}, T == 1) one recurrent step, the state updated in place and
    returned; without, the chunkwise form from a zero state (returns
    None)."""
    B, T, _ = x.shape
    H, di = cfg.n_heads, cfg.d_inner
    P = di // H

    def proj(name):
        return linear_apply(p[name], x, dispatch=dispatch,
                            leaf=f"mlstm/{name}")

    q = proj("wq").reshape(B, T, H, P).to(F32) / math.sqrt(P)
    k = proj("wk").reshape(B, T, H, P).to(F32)
    v = proj("wv").reshape(B, T, H, P).to(F32)
    gif = proj("wif").to(F32).reshape(B, T, 2, H)
    li = _log_sigmoid(gif[:, :, 0])                # (B, T, H)
    lf = _log_sigmoid(gif[:, :, 1])
    og = torch.sigmoid(proj("wog").to(F32))

    if cache is not None:
        S, n = cache["S"], cache["n"]              # (B,H,P,P), (B,H,P)
        f = torch.exp(lf[:, 0])[..., None, None]   # (B,H,1,1)
        i = torch.exp(li[:, 0])[..., None, None]
        q0, k0, v0 = q[:, 0], k[:, 0], v[:, 0]
        kv = k0[..., :, None] * v0[..., None, :]
        S.mul_(f).add_(i * kv)
        n.mul_(f[..., 0]).add_(i[..., 0] * k0)
        num = (q0[..., None, :] @ S)[..., 0, :]    # (B,H,P)
        den = ((q0 * n).sum(dim=-1)).abs()[..., None]
        y = num / torch.clamp_min(den, 1.0)
        y = y.reshape(B, 1, di) * og
        return linear_apply(p["wo"], y.to(x.dtype), dispatch=dispatch,
                            leaf="mlstm/wo"), cache

    L = min(CHUNK, T)
    qp, kp, vp = (_pad_chunks(a, L) for a in (q, k, v))
    # padded steps have k = v = 0: they never reach the output
    lip, lfp = _pad_chunks(li, L), _pad_chunks(lf, L)
    NC = qp.shape[1] // L

    def resh(a):  # (B, NC*L, H, P) -> (NC, B, H, L, P)
        return a.reshape(B, NC, L, H, P).permute(1, 0, 3, 2, 4)

    qc, kc, vc = resh(qp), resh(kp), resh(vp)
    lic = lip.reshape(B, NC, L, H).permute(1, 0, 3, 2)   # (NC, B, H, L)
    lfc = lfp.reshape(B, NC, L, H).permute(1, 0, 3, 2)
    S = x.new_zeros((B, H, P, P), dtype=F32)
    n = x.new_zeros((B, H, P), dtype=F32)
    ys = []
    for c in range(NC):
        qb = qc[c]
        y_in, n_in, S_c, n_c, cum = _mlstm_chunk(qb, kc[c], vc[c], lic[c],
                                                 lfc[c])
        qd = qb * torch.exp(cum)[..., None]
        y = y_in + qd @ S
        den = (n_in + (qd @ n[..., None])[..., 0]).abs()
        ys.append(y / torch.clamp_min(den, 1.0)[..., None])
        d_all = torch.exp(cum[..., -1])                  # (B, H)
        S = d_all[..., None, None] * S + S_c
        n = d_all[..., None] * n + n_c
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, NC * L, di)[:, :T]
    y = y * og
    return linear_apply(p["wo"], y.to(x.dtype), dispatch=dispatch,
                        leaf="mlstm/wo"), None


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


def slstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                cache: Optional[Dict] = None, dispatch=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, T, D) -> the h states (B, T, D) in x's dtype.  With ``cache``
    ({"h", "c", "n"}: (B, D) f32, T == 1) one step, the state updated in
    place; without, a loop of T steps from a zero state."""
    B, T, D = x.shape
    xw = linear_apply(p["wx"], x, dispatch=dispatch, leaf="slstm/wx")
    r32, b32 = p["r"].to(F32), p["b"].to(F32)
    if cache is not None:
        h, c, n = _slstm_step(r32, b32, cfg.n_heads, xw[:, 0],
                              (cache["h"], cache["c"], cache["n"]))
        cache["h"].copy_(h)
        cache["c"].copy_(c)
        cache["n"].copy_(n)
        return h[:, None].to(x.dtype), cache
    z = x.new_zeros((B, D), dtype=F32)
    state, hs = (z, z, z), []
    for t in range(T):
        state = _slstm_step(r32, b32, cfg.n_heads, xw[:, t], state)
        hs.append(state[0])
    return torch.stack(hs, dim=1).to(x.dtype), None


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


def _mamba_proj(p: Params, cfg: ArchConfig, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None, dispatch=None):
    """The shared projection and the causal width-4 conv over xBC (f32,
    from ``conv_state`` (B, 3, d_xbc) or zeros), then SiLU; softplus on
    dt.  Returns z, xs (B, T, H, 64), Bm, Cm (B, T, N), dt (B, T, H) and
    the new conv state (the window's last 3 rows; None for a zero-start
    sequence shorter than 3)."""
    B, T, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // MAMBA_HEADDIM
    zxd = linear_apply(p["win"], x, dispatch=dispatch, leaf="mamba/win")
    z = zxd[..., :di]
    xBC = zxd[..., di:2 * di + 2 * N]
    dt_raw = zxd[..., 2 * di + 2 * N:]
    kern = p["conv"].to(F32)                        # (W, d_xbc)
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
    xs = conv[..., :di].reshape(B, T, H, MAMBA_HEADDIM)
    Bm = conv[..., di:di + N]
    Cm = conv[..., di + N:]
    dtv = _softplus(dt_raw.to(F32) + p["dt_bias"])  # (B, T, H)
    return z, xs, Bm, Cm, dtv, new_state


def mamba2_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Optional[Dict] = None, dispatch=None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, T, D) -> (B, T, D).  With ``cache`` ({"S": (B, H, 64, N),
    "conv": (B, 3, d_xbc)}, T == 1) one recurrent step, both states
    updated in place; without, the chunkwise form from zero states
    (returns None)."""
    B, T, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // MAMBA_HEADDIM
    P = MAMBA_HEADDIM
    A = -torch.exp(p["a_log"])                      # (H,) negative

    def out(y):
        return linear_apply(p["wout"], y.to(x.dtype), dispatch=dispatch,
                            leaf="mamba/wout")

    if cache is not None:
        z, xs, Bm, Cm, dtv, conv_state = _mamba_proj(
            p, cfg, x, conv_state=cache["conv"], dispatch=dispatch)
        S = cache["S"]                              # (B, H, P, N)
        d0, x0 = dtv[:, 0], xs[:, 0]
        dec = torch.exp(A * d0)                     # (B, H)
        dBx = (d0[..., None] * x0)[..., :, None] * Bm[:, 0][:, None, None, :]
        S.mul_(dec[..., None, None]).add_(dBx)
        y = (S @ Cm[:, 0][:, None, :, None])[..., 0]  # (B, H, P)
        y = y + p["d_skip"][None, :, None] * x0
        y = y.reshape(B, 1, di) * _silu(z.to(F32))
        cache["conv"].copy_(conv_state)
        return out(y), cache

    z, xs, Bm, Cm, dtv, _ = _mamba_proj(p, cfg, x, dispatch=dispatch)
    L = min(CHUNK, T)
    # padded steps have dt = x = B = 0: they never reach the output
    xs_p, Bp, Cp, dp = (_pad_chunks(a, L) for a in (xs, Bm, Cm, dtv))
    NC = xs_p.shape[1] // L
    xc = xs_p.reshape(B, NC, L, H, P).permute(1, 0, 3, 2, 4)  # (NC,B,H,L,P)
    Bc = Bp.reshape(B, NC, L, N).permute(1, 0, 2, 3)          # (NC,B,L,N)
    Cc = Cp.reshape(B, NC, L, N).permute(1, 0, 2, 3)
    dc = dp.reshape(B, NC, L, H).permute(1, 0, 3, 2)          # (NC,B,H,L)
    causal = _causal(L, x.device)
    S = x.new_zeros((B, H, P, N), dtype=F32)
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
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, NC * L, di)[:, :T]
    y = y + (p["d_skip"][None, None, :, None] * xs).reshape(B, T, di)
    y = y * _silu(z.to(F32))
    return out(y), None


def mamba2_cache_init(cfg: ArchConfig, batch: int,
                      lead: Tuple[int, ...] = (), device=None) -> Dict:
    di, N = cfg.d_inner, cfg.ssm_state
    H = di // MAMBA_HEADDIM
    return {"S": torch.zeros(lead + (batch, H, MAMBA_HEADDIM, N), dtype=F32,
                             device=device),
            "conv": torch.zeros(lead + (batch, MAMBA_CONV - 1, di + 2 * N),
                                dtype=F32, device=device)}
