"""The sequence-sharded KV cache: a cache whose T axis ``cache_specs`` cuts
over ``model`` (kv heads the axis does not divide), over the data axes (a
batch of one) or over both, written on each rank's range and read there,
the ranks' partial reads combined by their log-sum-exps.

Reduced llama3.2-1b (f32) under gloo at 2 and 4 ranks
(``tests/_sharding_workers.py``, ``kind="seq"``): one decode step, a
16-row prefill chunk that straddles ranks, three more decode steps, on
the float, int4 and int4x2 caches (fused reads, and int4x2's unpack
read).  Held against the one-process step (``REL`` = 1e-5 of the largest
magnitude, logits and every cache leaf: f32, only the order of sums
differs) and against the reference's steps on the same weights (f32
``rtol = atol = 1e-5``, as ``tests/_serve.py``).  At 4 ranks the last
rank's range holds no live key until the end, and at 2 ranks the second
holds none at the first step: every logit stays finite.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _sharding_workers import (SEQ_CASES, SEQ_CHUNKS, SEQ_READS,  # noqa: E402
                               SEQ_T, seq_config, seq_tokens, spawn_mesh)

REL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
# the mesh axes that cut T for each (mesh, kv heads, batch)
T_DIMS = {((1, 2), 1, 2): ["model"], ((2, 1), 2, 1): ["data"],
          ((1, 4), 2, 2): ["model"], ((1, 4), 2, 1): ["model"],
          ((2, 2), 2, 1): ["data"], ((2, 2), 1, 1): ["data", "model"],
          ((2, 2), 1, 2): ["model"]}


@pytest.fixture(scope="module", params=list(SEQ_CASES),
                ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param, kind="seq")


def _keys(shape):
    for hkv, B in SEQ_CASES[shape]:
        for kv, read in SEQ_READS:
            yield hkv, B, kv, read, f"h{hkv}b{B}/{kv}/{read}"


def test_seq_cache_matches_one_process(ranks):
    shape, res = ranks
    for hkv, B, kv, read, key in _keys(shape):
        assert res[f"{key}/t_dims"] == T_DIMS[(shape, hkv, B)], key
        assert res[f"{key}/finite"], key
        assert res[f"{key}/rel"] <= REL, (key, res[f"{key}/rel"])
        assert res[f"{key}/cache"] <= REL, (key, res[f"{key}/cache"])


@functools.cache
def _reference_logits(hkv: int, B: int, kv: str, read: str):
    """The reference's steps on the port's seed-0 weights (numpy), once a
    case for all the meshes that run it."""
    from repro.models import model as jm
    from repro.models.config import ArchConfig as JCfg
    from repro_torch.models import model as tm

    cfg = seq_config(hkv)
    jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    params = tm.init_params(cfg, seed=0, device="cpu")
    jp = _to_jax(params)
    cache = jm.init_cache(jcfg, B, SEQ_T, kv_cache=kv)
    toks = seq_tokens(cfg, B)
    out = []
    for lo, hi in SEQ_CHUNKS:
        fn = jm.prefill_step if hi - lo > 1 else jm.decode_step
        lg, cache = fn(jp, jcfg, cache, jnp.asarray(toks[:, lo:hi]),
                       dispatch="jnp", packed_read=read)
        out.append(np.asarray(lg))
    return out


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.float().numpy() if tree.dtype == torch.bfloat16
                       else tree.numpy()).astype(
        jnp.bfloat16 if tree.dtype == torch.bfloat16 else None)


def test_seq_cache_matches_reference(ranks):
    shape, res = ranks
    for hkv, B, kv, read, key in _keys(shape):
        if read == "unpack":
            continue        # the fused read of the same container is held
        ref = _reference_logits(hkv, B, kv, read)
        for got, want in zip(res[f"{key}/logits"], ref):
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)


def _kv_insert_ranks(T, n, upd, idx):
    """The sequence-sharded write on n ranks of a zero cache, concatenated,
    beside the one-process write."""
    from repro_torch.models.blocks import _kv_insert

    B = upd.shape[0]
    whole = _kv_insert(torch.zeros((B, T) + upd.shape[2:]), upd, idx.clone())
    t = T // n
    parts = [_kv_insert(torch.zeros((B, t) + upd.shape[2:]), upd,
                        idx.clone(), (r * t, T)) for r in range(n)]
    return whole, parts


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("C", [1, 5, 16])
def test_write_lands_only_on_the_owning_rank(n, C):
    """Each chunk row lands on the rank whose range holds its position and
    nowhere else; a chunk straddles ranks; an idle slot (length T) writes
    its clamped row at T - C as in one process."""
    T = 32
    rng = np.random.default_rng(C + n)
    upd = torch.from_numpy(rng.standard_normal((4, C, 2, 3))
                           .astype(np.float32)) + 1.0
    idx = torch.tensor([0, 6, 13, T], dtype=torch.int32)
    whole, parts = _kv_insert_ranks(T, n, upd, idx)
    assert torch.equal(torch.cat(parts, dim=1), whole)
    t = T // n
    for r, part in enumerate(parts):
        start = torch.clamp(idx.long(), 0, T - C)
        for b in range(4):
            rows = [p - r * t for p in range(int(start[b]), int(start[b]) + C)
                    if r * t <= p < (r + 1) * t]
            written = part[b].abs().sum(dim=(1, 2)) != 0
            assert written.nonzero().flatten().tolist() == rows, (r, b)


def _cache(rng, B, T, Hkv, Dh):
    codes = torch.from_numpy(rng.integers(-7, 8, (2, B, T, Hkv, Dh))
                             .astype(np.int8))
    scales = torch.from_numpy(rng.random((2, B, T, Hkv)).astype(np.float32))
    return codes, scales


def _direct_lse(q, k, lengths):
    B, C, H, Dh = q.shape
    G = H // k.shape[2]
    s = torch.einsum("bchd,bthd->bcht", q.double() / np.sqrt(Dh),
                     k.double().repeat_interleave(G, dim=2))
    live = torch.arange(k.shape[1])[None, None, None, :] \
        < lengths[:, :, None, None]
    return torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)


@pytest.mark.parametrize("packed", [True, False])
def test_plain_lse_is_the_log_sum_exp(packed):
    """The plain packed read's lse (and the float read's) against a direct
    log-sum-exp of the scaled scores; a row with no live key gives output
    0 and lse -inf, never NaN."""
    from repro_torch.core.quant import pack_int4
    from repro_torch.kernels.flash_attention.decode_packed import (
        tiled_packed_attention)
    from repro_torch.models.layers import attention_lse

    rng = np.random.default_rng(3)
    B, C, H, Hkv, Dh, T = 2, 3, 4, 2, 16, 40
    (kc, vc), (ks, vs) = _cache(rng, B, T, Hkv, Dh)
    q = torch.from_numpy(rng.standard_normal((B, C, H, Dh))
                         .astype(np.float32))
    lengths = torch.tensor([[5, 0, 17], [40, 1, 0]], dtype=torch.int32)
    k_store = pack_int4(kc, axis=-1) if packed else kc
    v_store = pack_int4(vc, axis=-1) if packed else vc
    o, lse = tiled_packed_attention(q, k_store, v_store, ks, vs, lengths,
                                    bt=16, packed=packed, return_lse=True)
    kf = kc.float() * ks[..., None]
    vf = vc.float() * vs[..., None]
    want = _direct_lse(q, kf, lengths)
    dead = (lengths == 0)[:, :, None].expand_as(lse)
    assert torch.isneginf(lse[dead]).all() and (o[dead[..., None].expand_as(
        o)] == 0).all()
    np.testing.assert_allclose(lse[~dead].numpy(), want[~dead].numpy(),
                               rtol=1e-5, atol=1e-5)
    o2, lse2 = attention_lse(q, kf, vf, lengths)
    assert not torch.isnan(o2).any()
    np.testing.assert_allclose(lse2[~dead].numpy(), want[~dead].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.isneginf(lse2[dead]).all()


@pytest.mark.parametrize("n", [2, 4])
def test_partial_reads_combine_to_the_whole_read(n):
    """Reads of n ranges of the cache, each with its local extents (0 for
    a range past a row's length), combined by ``seq_combine`` (over a
    stack of the parts, as the card's phase does), equal the whole cache's
    read; the combined lse is the parts' log-sum-exp."""
    from repro_torch.core.sharded import seq_combine
    from repro_torch.kernels.flash_attention.decode_packed import (
        tiled_packed_attention)

    rng = np.random.default_rng(4)
    B, C, H, Hkv, Dh, T = 2, 4, 4, 2, 16, 64
    (kc, vc), (ks, vs) = _cache(rng, B, T, Hkv, Dh)
    q = torch.from_numpy(rng.standard_normal((B, C, H, Dh))
                         .astype(np.float32))
    lengths = torch.tensor([[3, 4, 5, 6], [20, 21, 22, 23]],
                           dtype=torch.int32)
    whole = tiled_packed_attention(q, kc, vc, ks, vs, lengths, bt=16,
                                   packed=False)
    t = T // n
    parts = []
    for r in range(n):
        sl = slice(r * t, (r + 1) * t)
        ext = torch.clamp(lengths - r * t, 0, t)
        parts.append(tiled_packed_attention(
            q, kc[:, sl], vc[:, sl], ks[:, sl], vs[:, sl], ext, bt=16,
            packed=False, return_lse=True))
    o, lse = seq_combine(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        lambda t, op: t.amax(dim=0) if op == "max" else t.sum(dim=0))
    assert not torch.isnan(o).any()
    np.testing.assert_allclose(o.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
