"""The flash op at a query offset (a sequence-sharded rank's rows) vs the
JAX reference's ``chunked_attention(..., q_offset=...)`` on the same numpy
inputs: the kernel wrapper's plain version, the autograd op's forward and
its gradients, and the rank split that ``core/sharded.py`` ``attn_full``
makes under ``seq_shard``.

q's row i sits at position ``q_offset + i``; causal masking keeps ``kpos <=
q_offset + qpos`` and non-causal calls ignore the offset.  Tolerance f32
``rtol=1e-5, atol=1e-6``, forward values and gradients alike (the packages
sum the same products in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.layers import chunked_attention as j_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention as t_op  # noqa: E402
from repro_torch.models.layers import chunked_attention as t_chunked  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
HKV, DH = 2, 16


def _qkv(B, Tq, Tk, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Tq, H, DH)).astype(np.float32),
            rng.normal(size=(B, Tk, HKV, DH)).astype(np.float32),
            rng.normal(size=(B, Tk, HKV, DH)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (q_offset, G, Tq, extra keys past q_offset + Tq): Tk = q_offset + Tq (the
# rank's keys end with its rows) at G 1, and Tk beyond them at G 4; no Tk
# is a multiple of the kernel's 64-key tile
SHAPES = [(off, G, Tq, extra) for off in (0, 7, 64, 100)
          for G, Tq, extra in ((1, 24, 0), (4, 40, 37))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("off,G,Tq,extra", SHAPES)
def test_plain_version_and_op_match_reference_at_offset(causal, off, G, Tq,
                                                        extra):
    Tk = off + Tq + extra
    q, k, v = _qkv(2, Tq, Tk, HKV * G, seed=off * 31 + Tq + G)
    want = np.asarray(j_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, q_offset=off))
    plain = tk.flash_attention_plain(*_t(q, k, v), causal=causal,
                                     q_offset=off)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    # the wrapper and the op take the plain version for CPU tensors
    got = t_op(*_t(q, k, v), causal, off)
    np.testing.assert_array_equal(got.detach().numpy(), plain.numpy())
    np.testing.assert_array_equal(
        tk.flash_attention_fwd(*_t(q, k, v), causal=causal,
                               q_offset=off).numpy(), plain.numpy())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G,off,Tq,Tk", [(1, 7, 24, 31), (4, 100, 40, 177),
                                         (4, 64, 24, 88)])
def test_op_gradients_at_offset_match_reference(causal, G, off, Tq, Tk):
    """The op's backward (``chunked_attention`` recomputed at the offset)
    vs ``jax.vjp`` of the reference's ``chunked_attention`` at it."""
    q, k, v = _qkv(2, Tq, Tk, HKV * G, seed=G + off)
    g = np.random.default_rng(off).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: j_chunked(a, b, c, causal=causal,
                                               q_offset=off),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    t_op(*leaves, causal, off).backward(torch.from_numpy(g))
    for name, t, j in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("n,T", [(2, 32), (2, 33), (4, 18), (4, 13), (4, 9)])
def test_rank_split_equals_the_whole_call(n, T):
    """Each rank's ``torch.chunk`` rows of q (``ceil(T / n)`` a rank, the
    last shorter or, at T 9, empty) against the whole k and v at its
    chunk's offset, as ``sharded.attn_full`` runs them: out and dq
    concatenated, dk and dv summed (the leg's ``Partial``), equal to the
    whole causal call."""
    q, k, v = _t(*_qkv(2, T, T, HKV * 4, seed=T * n))
    g = torch.from_numpy(np.random.default_rng(T).normal(
        size=q.shape).astype(np.float32))

    def fwd_bwd(q_, k_, v_, g_, off):
        q_, k_, v_ = (t.detach().requires_grad_() for t in (q_, k_, v_))
        o = t_op(q_, k_, v_, True, off)
        return (o.detach(),) + torch.autograd.grad(o, (q_, k_, v_), g_)

    whole = fwd_bwd(q, k, v, g, 0)
    parts, off = [], 0
    chunks = list(zip(torch.chunk(q, n, dim=1), torch.chunk(g, n, dim=1)))
    chunks += [(q[:, T:], g[:, T:])] * (n - len(chunks))   # empty ranks
    for q_r, g_r in chunks:
        parts.append(fwd_bwd(q_r, k, v, g_r, off))
        plain = tk.flash_attention_plain(q_r, k, v, q_offset=off)
        np.testing.assert_array_equal(parts[-1][0].numpy(), plain.numpy())
        off += q_r.shape[1]
    got = [torch.cat([p[i] for p in parts], dim=1) for i in (0, 1)]
    got += [sum(p[i] for p in parts) for i in (2, 3)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n,T", [(2, 33), (4, 18), (4, 9)])
def test_placed_leg_at_each_rank_equals_the_whole_call(n, T):
    """``attn_full_dispatch`` on DTensors as ``seq_shard`` places them — q
    ``Shard(1)`` over ``model``, k and v replicated — at each rank of a
    fake (1, n) group (its collectives move nothing, so each rank's local
    work is what that rank computes): the rank's rows start where DTensor
    cuts T (``sharded.local_extent``: the ``torch.chunk`` pieces, at T 9
    an empty last rank), the output keeps q's global shape, and the local
    out and dq concatenated, the partial dk and dv summed, equal the whole
    causal call."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.core import sharded
    from repro_torch.core.dispatch import attn_full_dispatch
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_mesh

    q, k, v = _t(*_qkv(2, T, T, HKV * 4, seed=T + n))
    g = torch.from_numpy(np.random.default_rng(n).normal(
        size=q.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = t_chunked(*leaves, causal=True)
    whole = (o.detach(),) + torch.autograd.grad(o, leaves, g)
    cuts = [len(c) for c in torch.arange(T).chunk(n)]
    parts, start = [], 0
    for r, rows in enumerate(cuts + [0] * (n - len(cuts))):
        with fake_group(n, rank=r):
            mesh = make_mesh((1, n), ("data", "model"), "cpu")
            leaves = [t.clone().requires_grad_()
                      for t in (q[:, start:start + rows], k, v)]
            qd = DTensor.from_local(leaves[0], mesh, [Replicate(), Shard(1)],
                                    run_check=False, shape=q.shape,
                                    stride=q.stride())
            kd, vd = (DTensor.from_local(t, mesh, [Replicate()] * 2,
                                         run_check=False)
                      for t in leaves[1:])
            assert sharded.local_extent(qd, 1) == (start, rows)
            od = attn_full_dispatch(qd, kd, vd, causal=True)
            assert od.shape == q.shape and od.placements == qd.placements
            o = od.to_local()
            parts.append((o.detach(),) + torch.autograd.grad(
                o, leaves, g[:, start:start + rows]))
        start += rows
    got = [torch.cat([p[i] for p in parts], dim=1) for i in (0, 1)]
    got += [sum(p[i] for p in parts) for i in (2, 3)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL,
                                   err_msg=name)


def test_offset_moves_the_causal_mask():
    """At an offset every row sees the keys up to its absolute position:
    the whole keys at offset Tk - Tq equal the last Tq rows of the whole
    call, which offset 0 does not."""
    q, k, v = _t(*_qkv(1, 40, 40, HKV, seed=3))
    whole = t_chunked(q, k, v, causal=True)
    tail = tk.flash_attention_plain(q[:, 24:], k, v, q_offset=24)
    np.testing.assert_allclose(tail.numpy(), whole[:, 24:].numpy(), **TOL)
    at0 = tk.flash_attention_plain(q[:, 24:], k, v)
    assert np.abs(at0.numpy() - whole[:, 24:].numpy()).max() > 1e-2


@pytest.mark.parametrize("off", [-1, 2 ** 30 + 1])
def test_wrapper_rejects_an_offset_out_of_range(off):
    q, k, v = _t(*_qkv(1, 8, 8, HKV, seed=0))
    with pytest.raises(ValueError, match="q_offset"):
        tk.flash_attention_fwd(q, k, v, q_offset=off)

