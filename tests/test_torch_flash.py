"""Port flash attention (kernel wrapper's plain version, naive oracle,
``chunked_attention``, the autograd op and its dispatch route) vs the JAX
reference on the same numpy inputs.

Tolerances: f32 ``rtol=1e-5, atol=1e-6`` for forward values (the packages
sum the same products in different orders); gradients ``rtol=1e-4,
atol=1e-5``, because the backward chains several f32 einsums whose
rounding compounds.  bf16 outputs within one bf16 step (2^-7 of the
largest value).

Causal alignment: the kernel (and ``chunked_attention`` at ``q_offset=0``)
keeps ``kpos <= qpos`` with both counted from position 0; the naive oracle
``flash_attention_ref`` aligns the last query with the last key
(``tril(k=Tk-Tq)``).  They agree when ``Tq == Tk``, as on the training
path; ``test_causal_alignment_differs_from_the_oracle_when_tq_ne_tk``
pins the difference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention as j_kernel  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_op  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref  # noqa: E402
from repro.models.layers import chunked_attention as j_chunked  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import dispatch as tdisp  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention as t_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as t_ref  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models.layers import chunked_attention as t_chunked  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# tests/test_flash_attention.py's SWEEP, plus a Tq != Tk case each way
SWEEP = [
    # B, Tq, Tk, H, Hkv, Dh, bq, bk, causal
    (2, 128, 128, 4, 2, 32, 64, 64, True),
    (1, 256, 256, 8, 8, 16, 128, 128, True),
    (2, 128, 128, 4, 1, 32, 32, 64, False),
    (1, 128, 128, 2, 2, 64, 128, 32, True),
    (1, 128, 256, 4, 2, 16, 64, 64, False),
    (2, 256, 128, 4, 2, 16, 64, 64, True),
]


def _qkv(B, Tq, Tk, H, Hkv, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Tq, H, Dh)).astype(np.float32),
            rng.normal(size=(B, Tk, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, Tk, Hkv, Dh)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,Dh,bq,bk,causal", SWEEP)
def test_plain_version_matches_the_pallas_kernel(B, Tq, Tk, H, Hkv, Dh, bq, bk,
                                                 causal):
    q, k, v = _qkv(B, Tq, Tk, H, Hkv, Dh, seed=B * 7 + H)
    want = j_kernel(*_j(q, k, v), causal=causal, bq=bq, bk=bk, interpret=True)
    # the wrapper takes the plain version for CPU tensors
    got = tk.flash_attention_fwd(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        got.numpy(), tk.flash_attention_plain(*_t(q, k, v),
                                              causal=causal).numpy())


def test_plain_version_bf16_matches_the_pallas_kernel():
    q, k, v = _qkv(1, 128, 128, 4, 2, 32, seed=3)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_kernel(*jb, causal=True, interpret=True), np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in jb]
    got = tk.flash_attention_plain(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Tq,Tk", [(64, 64), (48, 80), (80, 48)])
def test_naive_oracle_matches_reference(causal, Tq, Tk):
    q, k, v = _qkv(2, Tq, Tk, 4, 2, 16, seed=Tq + Tk)
    want = j_ref(*_j(q, k, v), causal=causal)
    got = t_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 7])
@pytest.mark.parametrize("Tk,kv_chunk", [(96, 1024), (100, 32), (64, 64)])
def test_chunked_attention_matches_reference(causal, q_offset, Tk, kv_chunk):
    q, k, v = _qkv(2, 24, Tk, 8, 2, 16, seed=Tk + q_offset)
    kw = dict(causal=causal, q_offset=q_offset, kv_chunk=kv_chunk)
    want = j_chunked(*_j(q, k, v), **kw)
    got = t_chunked(*_t(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_alignment_differs_from_the_oracle_when_tq_ne_tk():
    q, k, v = _qkv(1, 64, 128, 4, 2, 16, seed=5)
    tq, tkk, tv = _t(q, k, v)
    plain = tk.flash_attention_plain(tq, tkk, tv, causal=True)
    np.testing.assert_allclose(
        plain.numpy(), t_chunked(tq, tkk, tv, causal=True).numpy(), **TOL)
    oracle = t_ref(tq, tkk, tv, causal=True)
    np.testing.assert_allclose(
        oracle.numpy(),
        t_chunked(tq, tkk, tv, causal=True, q_offset=128 - 64).numpy(), **TOL)
    assert np.abs(plain.numpy() - oracle.numpy()).max() > 1e-2


def test_op_gradient_matches_reference():
    """The op's backward (chunked_attention recomputed under autograd) vs
    jax.grad of the reference op (Pallas forward, chunked-XLA backward)."""
    q, k, v = _qkv(1, 128, 128, 4, 2, 16, seed=1)
    w = np.random.default_rng(2).normal(size=(1, 128, 4, 16)).astype(
        np.float32)

    def j_loss(q, k, v):
        return jnp.sum(j_op(q, k, v, True, True) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*_j(q, k, v))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    (t_op(*leaves, True) * torch.from_numpy(w)).sum().backward()
    for t, j in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD_TOL)


def test_op_backward_is_autograd_through_chunked_attention():
    q, k, v = _qkv(2, 40, 40, 4, 1, 8, seed=4)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 40, 4, 8)).astype(np.float32))
    grads = []
    for fn in (lambda a, b, c: t_op(a, b, c, True),
               lambda a, b, c: t_chunked(a, b, c, causal=True)):
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_full_attention_route():
    q, k, v = _t(*_qkv(1, 32, 32, 4, 2, 8, seed=7))
    want = t_chunked(q, k, v, causal=True)
    for mode in ("auto", "twin"):
        got = tdisp.attn_full_dispatch(q, k, v, causal=True, dispatch=mode)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="kernel"):
        tdisp.attn_full_dispatch(q, k, v, causal=True, dispatch="kernel")


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q, k, v = _t(*_qkv(1, 16, 16, 6, 4, 8))
    with pytest.raises(ValueError, match="multiple"):
        tk.flash_attention_fwd(q, k, v)
    q, k, v = _t(*_qkv(1, 16, 0, 4, 2, 8))
    with pytest.raises(ValueError, match="Tk=0"):
        tk.flash_attention_fwd(q, k, v)


# ------------------------------------------------------------------ routes


def _route_case(case):
    """q, k, v (bf16 unless the case says otherwise) laid out as ``case``
    names."""
    B, T, H, Hkv = 2, 24, 4, 2
    dt = torch.float32 if case == "f32" else torch.float16 \
        if case == "f16" else torch.bfloat16
    Dh = {"dh16": 16, "dh40": 40, "dh80": 80, "dh96": 96, "dh128": 128,
          "dh256": 256, "dh80_f32": 80, "dh96_rows_of_97": 96}.get(case, 64)
    if case == "dh80_f32":
        dt = torch.float32
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, T, H, Dh), generator=g).to(dt)
    k = torch.randn((B, T, Hkv, Dh), generator=g).to(dt)
    v = torch.randn((B, T, Hkv, Dh), generator=g).to(dt)
    if case == "q_head_slice":       # q read through a view over heads
        q = torch.randn((B, T, 2 * H, Dh), generator=g).to(dt)[:, :, H:]
    elif case in ("rows_of_65", "dh96_rows_of_97"):
        # rows are not whole 16-byte copies
        q = torch.randn((B, T, H, Dh + 1), generator=g).to(dt)[..., :Dh]
    elif case == "base_off_by_one":  # a base pointer 2 bytes past alignment
        q = torch.empty(q.numel() + 8, dtype=dt)[1:1 + q.numel()].view(
            q.shape).copy_(q)
    elif case == "dh_strided":       # Dh is not the unit-stride dimension
        k = k.transpose(1, 3).contiguous().transpose(1, 3)
    elif case == "k_f32":
        k = k.float()
    elif case == "odd_batch_stride_b1":  # a size-1 dimension's stride is moot
        q = q[:1].as_strided((1, T, H, Dh), (7, H * Dh, Dh, 1))
        k, v = k[:1], v[:1]
    return q, k, v


@pytest.mark.parametrize("case,route", [
    ("dh64", "tensor_core"), ("dh80", "tensor_core"), ("dh96", "tensor_core"),
    ("dh128", "tensor_core"), ("dh80_f32", "cuda_core"),
    ("dh96_rows_of_97", "cuda_core"),
    ("q_head_slice", "tensor_core"), ("odd_batch_stride_b1", "tensor_core"),
    ("f32", "cuda_core"), ("f16", "cuda_core"), ("k_f32", "cuda_core"),
    ("dh16", "cuda_core"), ("dh40", "cuda_core"), ("dh256", "cuda_core"),
    ("rows_of_65", "cuda_core"), ("base_off_by_one", "cuda_core"),
    ("dh_strided", "cuda_core"),
])
def test_flash_route_shape_rule(case, route):
    assert tk.flash_route(*_route_case(case)) == route


def test_training_path_takes_the_tensor_core_route(monkeypatch):
    """The q, k and v that the training forward hands the attention at
    llama3.2-1b's head layout (Dh 64, GQA, bf16) go to the tensor cores."""
    cfg = dataclasses.replace(t_reduced("llama3.2-1b"), head_dim=64,
                              d_model=128, param_dtype="bfloat16")
    seen = []
    full = tblocks.attn_full_dispatch

    def spy(q, k, v, **kw):
        seen.append((tk.flash_route(q, k, v), q.dtype, tuple(q.shape)))
        return full(q, k, v, **kw)

    monkeypatch.setattr(tblocks, "attn_full_dispatch", spy)
    params = tm.init_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)), dtype=torch.int32)
    tm.forward(params, cfg, {"tokens": toks})
    assert len(seen) == cfg.n_layers
    assert all(r == "tensor_core" and dt == torch.bfloat16 and s[-1] == 64
               for r, dt, s in seen), seen


# The reduced configs at their full-width head dims (hubert-xlarge and
# zamba2-2.7b Dh 80, phi-3-vision-4.2b Dh 96), bf16, and each one's batch.
def _frames(cfg, rng):
    return {"frame_embeds": torch.as_tensor(rng.standard_normal(
        (2, 32, cfg.d_model)), dtype=torch.bfloat16)}


def _tokens(cfg, rng):
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)),
                                      dtype=torch.int32)}


def _prefixed(cfg, rng):
    return {**_tokens(cfg, rng), "prefix_embeds": torch.as_tensor(
        rng.standard_normal((2, 8, cfg.d_model)), dtype=torch.bfloat16)}


@pytest.mark.parametrize("arch,head_dim,batch", [
    ("hubert-xlarge", 80, _frames), ("zamba2-2.7b", 80, _tokens),
    ("phi-3-vision-4.2b", 96, _prefixed)])
def test_dh80_and_dh96_forwards_take_the_tensor_core_route(
        monkeypatch, arch, head_dim, batch):
    """The q, k and v that the bf16 forwards of the encoder, the hybrid and
    the VLM hand the attention at their head dims go to the tensor cores,
    one call a layer (the hybrid: one a super-block)."""
    cfg = dataclasses.replace(t_reduced(arch), head_dim=head_dim,
                              param_dtype="bfloat16")
    seen = []
    full = tblocks.attn_full_dispatch

    def spy(q, k, v, **kw):
        seen.append((tk.flash_route(q, k, v), q.dtype, tuple(q.shape)))
        return full(q, k, v, **kw)

    monkeypatch.setattr(tblocks, "attn_full_dispatch", spy)
    params = tm.init_params(cfg, seed=0, device="cpu")
    tm.forward(params, cfg, batch(cfg, np.random.default_rng(0)))
    assert len(seen) == tm.n_superblocks(cfg)
    assert all(r == "tensor_core" and dt == torch.bfloat16
               and s[-1] == head_dim for r, dt, s in seen), seen


def test_cpu_calls_count_no_route():
    for attr in ("launches", "launches_tc", "launches_cc"):
        setattr(tk, attr, 0)
    q, k, v = _t(*_qkv(1, 16, 16, 4, 2, 64))
    tk.flash_attention_fwd(*(t.to(torch.bfloat16) for t in (q, k, v)))
    assert (tk.launches, tk.launches_tc, tk.launches_cc) == (0, 0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_flash_kernel_matches_plain_version(cuda_device):
    dev = cuda_device
    for causal, (Tq, Tk), Dh, dt in ((True, (100, 100), 64, torch.float32),
                                     (False, (70, 130), 16, torch.bfloat16),
                                     (True, (257, 257), 128, torch.bfloat16)):
        q, k, v = (t.to(dev, dt) for t in _t(*_qkv(2, Tq, Tk, 8, 2, Dh)))
        y = tk.flash_attention_fwd(q, k, v, causal=causal)
        ref = tk.flash_attention_plain(q, k, v, causal=causal)
        top = float(ref.float().abs().max())
        tol = (2 ** -7 if dt == torch.bfloat16 else 1e-5) * top
        assert float((y.float() - ref.float()).abs().max()) <= tol
