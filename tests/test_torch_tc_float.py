"""Float blocks (actsparse, the float sparse path) on ``block_sparse_matmul``'s
thin-M and tensor-core routes, held on the CPU against the JAX reference.

The leaves are compiled by ``repro`` itself (``compile_conv``, 256 x 256
weights of 128 x 128 blocks from a numpy seed, one block absent) and run
through its ``dispatch="jnp"`` path, the f32 dot the Pallas kernel
computes.  The kernels run only on a card (``chip_smoke.py``); here their
arithmetic is replayed in plain PyTorch on the same numbers:

* the tensor-core route (bf16 x past 16 rows): each f32 weight split into
  two bf16 terms, ``hi = bf16(w)`` and ``lo = bf16(w - hi)``
  (``split_bf16``, the device's ``tcm::split``), both terms' products of
  the exact bf16 x summed in f32 over each 64-row step of a block and the
  step's sum added to the range's f32 sum (the device promotes its tensor
  cores' sum every step), ranges added in order; bf16 blocks one exact
  term.  Tolerance ``1e-5 * max|ref|``: ``hi + lo`` keeps each weight to
  2^-16 of itself (checked), so a dot moves by about 2^-17 of its terms,
  plus the f32 sum order;
* the thin-M route (M <= 16, f32 or bf16 x): f32 FMAs of the weights
  themselves over each range, ranges added in order; the same tolerance
  (the f32 sum order alone).

Under actsparse's ReLU (the fused ``("trelu", tau)``) an output may land on
the other side of tau only where the reference's f32 pre-activation lies
within ``1e-5 * max|pre|`` of it (``chip_smoke.py``'s ``TC_FLIP_BAND``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_sparse as jc  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core import payload_registry as jreg  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402
from repro_torch.kernels.sparse_matmul.ref import split_bf16  # noqa: E402

K = N = 256
BLOCK = (128, 128)
TAU = 0.05
REL = 1e-5          # of max|ref|: the split and the f32 sum order
FLIP_BAND = 1e-5    # of max|pre| about tau: chip_smoke.TC_FLIP_BAND

# (policy, blocks dtype): actsparse and the float sparse path
LEAVES = [("actsparse", "float32"), ("actsparse", "bfloat16"),
          ("sparse", "float32"), ("sparse", "bfloat16")]


def _compile(policy, dtype, seed=0):
    """The reference's payload of a seeded 256 x 256 weight with block
    (1, 0) masked out: (payload, blocks f32 (P, bk, bn), pattern)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    mask = rng.random(size=(K, N)) < 0.7
    mask[128:, :128] = False                       # an absent block
    rules = jc.CompileRules(block=BLOCK, min_weight_elems=0,
                            act_threshold=TAU, quantize_sparse=False,
                            dtype=dtype)
    cp, _, _ = jc.compile_conv(w.reshape(1, 1, K, N), mask=mask,
                               policy=policy, rules=rules)
    _, leaves, pat = jreg.unwrap_payload(cp.payload)
    key = "w_ablk" if policy == "actsparse" else "w_blk"
    blocks = np.array(jnp.asarray(leaves[key], jnp.float32))
    assert blocks.shape[0] == pat.n_blocks_present == 3
    return cp.payload, blocks, pat


def _reference(payload, x, activation=None):
    return np.asarray(jd.payload_dispatch(payload, jnp.asarray(x),
                                          dispatch="jnp",
                                          activation=activation),
                      np.float64)


def _ranges(sched, per):
    col_ptr = sched.col_ptr.numpy()
    return [[(lo, min(lo + per, col_ptr[c + 1]))
             for lo in range(col_ptr[c], col_ptr[c + 1], per)]
            for c in range(sched.n_col_blocks)]


def _replay(x, terms, sched, per, step=None):
    """Per column block, each range's f32 sum of x . (the block's terms),
    the ranges added in order; with ``step``, each ``step`` rows of a
    block summed over the terms first, then added to the range's sum."""
    bk, bn = BLOCK
    step = step or bk
    srows, pidx = sched.rows.numpy(), sched.pidx.numpy()
    y = torch.zeros((x.shape[0], sched.n_col_blocks * bn))
    for c, rs in enumerate(_ranges(sched, per)):
        for lo, hi in rs:
            part = torch.zeros((x.shape[0], bn))
            for q in range(lo, hi):
                for k0 in range(0, bk, step):
                    xk = x[:, srows[q] * bk + k0:srows[q] * bk + k0 + step]
                    s = torch.zeros((x.shape[0], bn))
                    for t in terms:
                        s = s + xk @ t[pidx[q]][k0:k0 + step]
                    part = part + s
            y[:, c * bn:(c + 1) * bn] += part
    return y


def _schedule(pat):
    nR, nC = pat.bitmap.shape
    return tsk.make_schedule(np.asarray(pat.block_rows),
                             np.asarray(pat.block_cols), nR, nC, "cpu")


def _within(y, ref, what):
    err = np.abs(y.numpy().astype(np.float64) - ref)
    assert err.max() <= REL * np.abs(ref).max(), (what, float(err.max()))


def test_split_keeps_each_weight_to_2_pow_minus_16():
    _, blocks, _ = _compile("actsparse", "float32")
    w = torch.from_numpy(blocks)
    hi, lo = split_bf16(w)
    assert hi.dtype == lo.dtype == torch.bfloat16
    rest = (w.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -16 * w.double().abs()).all())
    # bf16 blocks split into themselves and zeros
    hb, lb = split_bf16(w.to(torch.bfloat16))
    assert torch.equal(hb, w.to(torch.bfloat16)) and not lb.any()


@pytest.mark.parametrize("M", [17, 40, 512])
@pytest.mark.parametrize("policy,dtype", LEAVES)
def test_tc_split_matches_the_reference(policy, dtype, M):
    payload, blocks, pat = _compile(policy, dtype)
    sched = _schedule(pat)
    eb = 4 if dtype == "float32" else 2
    route, plan = tsk.bsm_route(M, *BLOCK, 1, sched.n_col_blocks,
                                sched.max_blocks_per_col, True, 0, eb)
    assert route == "tensor_core"
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        torch.bfloat16).float()                  # bf16 x, exact in f32
    hi, lo = split_bf16(torch.from_numpy(blocks))
    pre = _replay(x, (hi.float(), lo.float()), sched, plan.blocks_per_range,
                  step=tsk.TC_K_STEP)
    ref = _reference(payload, x.numpy())
    _within(pre, ref, f"{policy} {dtype} M={M}")
    if policy == "actsparse":   # the fused trelu: flips only near tau
        y = tsk.apply_activation(pre, ("trelu", TAU)).numpy()
        want = _reference(payload, x.numpy(), activation="relu")
        near = np.abs(ref - TAU) <= FLIP_BAND * np.abs(ref).max()
        off = np.abs(y - want) > REL * np.abs(ref).max()
        assert not (off & ~near).any()


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("policy,dtype", LEAVES)
def test_thin_m_float_blocks_match_the_reference(policy, dtype, M):
    payload, blocks, pat = _compile(policy, dtype, seed=1)
    sched = _schedule(pat)
    eb = 4 if dtype == "float32" else 2
    for x_bf16 in (False, True):
        route, plan = tsk.bsm_route(M, *BLOCK, 1, sched.n_col_blocks,
                                    sched.max_blocks_per_col, x_bf16, 0, eb)
        assert route == "thin_m"
    rng = np.random.default_rng(M + 1)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    y = _replay(x, (torch.from_numpy(blocks),), sched,
                plan.blocks_per_range)
    _within(y, _reference(payload, x.numpy()), f"{policy} {dtype} M={M}")
    # the wrapper's plain version on CPU tensors: the same numbers
    w = torch.from_numpy(blocks).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)
    got = tsk.block_sparse_matmul(x, w, sched)
    _within(got, _reference(payload, x.numpy()), "wrapper")
