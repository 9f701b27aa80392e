"""The staged route of the port's fused FC stack (``fc_stack_matmul``),
held on the CPU: ``fcs_route`` case by case and at LeNet's shapes, each
plan's ownership of rows, columns and the K walk replayed from
``FcsPlan``, and the plan's K split and part order replayed in plain
PyTorch against ``repro``'s Pallas ``fc_stack_matmul`` in interpret mode
on identical numpy inputs.

The kernel runs only on a card (``chip_smoke.py`` and the ``gpu`` test of
``tests/test_torch_conv.py``).  Its order, as replayed here: per output
row and column, f32 FMAs over the K part's k rows in order, from 0; the
parts' sums added in part order; then the bias and the activation, in f32,
before the next layer.  The K split depends on K alone.  Tolerance: f32
``rtol=1e-5, atol=1e-6``, as in ``tests/test_torch_conv.py``: only the
order of summation differs, on outputs of size O(1).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.fc_stack import fc_stack_matmul as j_fcs  # noqa: E402
from repro_torch.kernels import fc_stack as tfk  # noqa: E402
from repro_torch.kernels.sparse_matmul.kernel import apply_activation  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
F32 = torch.float32

# LeNet-5's fc1 -> fc2 -> fc3 (models/lenet.py) and chip_smoke.py's other
# sweep stacks
LENET = (256, 120, 84, 10)
SWEEP = (300, 64, 33, 7)
WIDE = (40, 500)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- the rule


def test_lenet_fc_stack_takes_staged_and_fills_the_card():
    """At B = 256 LeNet's stack takes the staged route with 2 rows a CTA:
    128 CTAs, one wave of the card, each staging every weight column."""
    route, plan = tfk.fcs_route(256, LENET, F32)
    assert route == "staged"
    assert (plan.tm, plan.grid) == (2, 128)
    assert plan.grid <= tfk.FCS_SMS
    assert plan.ks == (16, 8, 6) and plan.per == (16, 16, 16)
    assert plan.threads == 512 and plan.smem <= tfk._SMEM_MAX
    staged = sum(tfk._round4(k) * tfk._round4(n)
                 for k, n in zip(LENET, LENET[1:]))
    assert staged == 256 * 120 + 120 * 84 + 84 * 12   # fc3 padded to 12


# (case, M, dims, x dtype, route, rows a CTA)
RULE_CASES = [
    ("lenet, one row", 1, LENET, F32, "staged", 2),
    ("lenet, 7 rows", 7, LENET, F32, "staged", 2),
    ("lenet, 64 rows", 64, LENET, F32, "staged", 2),
    ("lenet, 256 rows", 256, LENET, F32, "staged", 2),
    ("lenet bf16", 256, LENET, torch.bfloat16, "staged", 2),
    ("sweep stack", 7, SWEEP, F32, "staged", 2),
    ("sweep stack bf16", 256, SWEEP, torch.bfloat16, "staged", 2),
    ("one wide layer", 256, WIDE, F32, "staged", 2),
    ("many rows: 16 a CTA would not fit", 4096, LENET, F32, "staged", 4),
    ("600 rows: 8 a CTA would not fit", 600, LENET, F32, "staged", 4),
    ("at the shared-memory limit", 256, (116, 432), F32, "staged", 2),
    ("one column group past the limit", 256, (116, 436), F32, "stream", 0),
    ("too wide for a CTA", 256, (512, 128), F32, "stream", 0),
    ("too wide for a CTA, square", 256, (384, 384), F32, "stream", 0),
    ("too wide for shared memory", 256, (2048, 2048), F32, "stream", 0),
    ("too wide, three layers", 256, (4096, 1024, 10), F32, "stream", 0),
    ("f16 x", 256, LENET, torch.float16, "stream", 0),
    ("nine layers", 4, (8,) * 10, F32, "stream", 0),
]


@pytest.mark.parametrize("case,M,dims,dtype,route,tm", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_fcs_route_rule(case, M, dims, dtype, route, tm):
    got, plan = tfk.fcs_route(M, dims, dtype)
    assert got == route
    assert (plan is None) == (route == "stream")
    wave = next((t for t in tfk.FCS_TMS if -(-M // t) <= tfk.FCS_SMS),
                tfk.FCS_TMS[-1])
    fits = [t for t in tfk.FCS_TMS if t <= wave and
            tfk.fcs_plan(M, dims, t).smem <= tfk._SMEM_MAX]
    if plan is None:
        # stream only where no plan fits (or the dtype or depth is not taken)
        assert not fits or dtype not in (F32, torch.bfloat16) or \
            len(dims) - 1 > tfk.MAX_LAYERS
        return
    # the most rows a CTA, up to one wave's, that fit shared memory: the
    # stack and plan's bytes included, since the kernel has no static
    # shared memory
    assert plan.tm == tm == max(fits)
    assert plan.smem <= tfk._SMEM_MAX
    assert plan.smem == tfk.FCS_ARGS + 4 * (
        2 * tm * plan.stride
        + sum(tfk._round4(k) * tfk._round4(n) + tfk._round4(n)
              for k, n in zip(dims, dims[1:]))
        + max(ks * tm * tfk._round4(n) for ks, n in zip(plan.ks, dims[1:])))
    assert plan.grid == -(-M // tm)
    kmax = max(tfk._round4(k) for k in dims[:-1])
    assert plan.stride >= kmax and plan.stride % 32 == 4
    for k, ks, per in zip(dims[:-1], plan.ks, plan.per):
        assert (ks, per) == tfk.k_split(k)


def test_the_limit_case_uses_every_byte():
    """The edge case of the rule table needs all 227 KB of a CTA: the
    chip sweep launches it (``chip_smoke.py`` FCS_STACKS)."""
    _, plan = tfk.fcs_route(256, (116, 432), F32)
    assert plan.smem == tfk._SMEM_MAX


@pytest.mark.parametrize("K", [1, 4, 5, 33, 40, 64, 84, 120, 256, 300, 500,
                               1024])
def test_k_split_covers_k_in_parts_of_4(K):
    """Parts of a multiple of 4 rows, about FCS_PART each, none empty, the
    last reaching round4(K)."""
    ks, per = tfk.k_split(K)
    assert per % 4 == 0 and per <= tfk.FCS_PART + 3
    assert (ks - 1) * per < tfk._round4(K) <= ks * per
    assert ks <= -(-K // tfk.FCS_PART)


def test_cpu_calls_count_no_fc_stack_route():
    """On the CPU the wrapper takes its plain version: no counter moves."""
    tfk.launches = tfk.launches_staged = tfk.launches_stream = 0
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(3, 12)).astype(np.float32))
    ws = [_t(rng.normal(size=(12, 6)).astype(np.float32)),
          _t(rng.normal(size=(6, 3)).astype(np.float32))]
    tfk.fc_stack_matmul(x, ws, [None, None], ["relu", None])
    assert (tfk.launches, tfk.launches_staged, tfk.launches_stream) == \
        (0, 0, 0)


# ---------------------------------------------------- ownership, replayed


def _replay(plan, M, dims):
    """Replay the kernel's index arithmetic (csrc/fc_stack.cu
    fcs_staged_kernel) over every CTA and slot.

    Returns, per layer, {(row, column): [emitting (CTA, item)]} for the
    rows below M and columns below N, and {(CTA, row, column): [k rows
    walked, part after part]} for every item a CTA computes."""
    outs, walks = [], []
    for l, N in enumerate(dims[1:]):
        K4 = tfk._round4(dims[l])
        G, ks, per = -(-N // 4), plan.ks[l], plan.per[l]
        items = plan.tm // 2 * G
        out, walk = {}, {}
        for cta in range(plan.grid):
            for s in range(ks * items):
                kp, it = divmod(s, items)
                rp, g = divmod(it, G)
                k0, k1 = kp * per, min(K4, (kp + 1) * per)
                for i in (0, 1):
                    r = cta * plan.tm + 2 * rp + i
                    for j in range(4):
                        c = 4 * g + j
                        walk.setdefault((cta, r, c), []).extend(
                            range(k0, k1))
                        if kp == 0 and r < M and c < N:
                            out.setdefault((r, c), []).append((cta, it))
        outs.append(out)
        walks.append(walk)
    return outs, walks


OWNER_CASES = [
    (256, LENET, 2),
    (256, LENET, 8),
    (7, LENET, 2),
    (19, LENET, 4),          # ragged rows
    (5, LENET, 2),
    (9, SWEEP, 4),           # K 300, 64, 33: parts of 16, 16, 12
    (3, WIDE, 2),
    (6, (12, 6, 3), 4),      # fewer columns than a group of 4
]


@pytest.mark.parametrize("M,dims,tm", OWNER_CASES)
def test_every_output_has_one_owner_and_each_part_walks_its_k_once(
        M, dims, tm):
    """Every (row, column) of every layer is emitted by exactly one (CTA,
    item), each row by one row tile, and each item's K parts walk k = 0
    .. round4(K) - 1 once, in order, part after part."""
    plan = tfk.fcs_plan(M, dims, tm)
    outs, walks = _replay(plan, M, dims)
    for l, N in enumerate(dims[1:]):
        want = {(r, c) for r in range(M) for c in range(N)}
        assert set(outs[l]) == want
        assert all(len(v) == 1 for v in outs[l].values())
        K4 = tfk._round4(dims[l])
        assert all(w == list(range(K4)) for w in walks[l].values())
        rows = {r for (_, r, _) in walks[l]}
        assert set(range(M)) <= rows
    # the row tiles cover the rows once: tile t is rows t*tm .. t*tm+tm-1
    assert plan.grid == -(-M // tm) and (plan.grid - 1) * tm < M


# ----------------------------------------------------- the arithmetic order


def _staged_order(x, ws, bs, acts, plan):
    """The staged kernel's arithmetic in plain PyTorch: per layer, per K
    part, products added one k row at a time from 0 (torch's mul-add
    rounds twice where the kernel's FMA rounds once: within TOL); the
    parts added in part order; bias; activation."""
    h = x
    for l, (w, b, act) in enumerate(zip(ws, bs, acts)):
        K = w.shape[0]
        acc = None
        for kp in range(plan.ks[l]):
            part = torch.zeros((h.shape[0], w.shape[1]))
            for k in range(kp * plan.per[l], min(K, (kp + 1) *
                                                  plan.per[l])):
                part = part + h[:, k:k + 1] * w[k]
            acc = part if acc is None else acc + part
        if b is not None:
            acc = acc + b
        h = apply_activation(acc, act)
    return h


@pytest.mark.parametrize("dims,acts,biased,M,tm", [
    (LENET, ["relu", "relu", None], (True, True, True), 5, 2),
    (SWEEP, ["silu", ("trelu", 0.1), "gelu"], (False, True, False), 3, 2),
    (WIDE, [None], (True,), 4, 4),
    ((12, 6, 3), ["gelu", None], (True, False), 6, 4),
])
def test_staged_order_matches_the_reference(dims, acts, biased, M, tm):
    """The staged plan's K split, with its parts added in part order,
    computes the Pallas kernel's function within f32 TOL.  This holds the
    plan's split and the order replay written here, not the CUDA kernel:
    at this tolerance any summation order passes.  The kernel itself is
    held against its plain version on the card (``chip_smoke.py`` and the
    ``gpu`` test of ``tests/test_torch_conv.py``)."""
    rng = np.random.default_rng(sum(dims) + M)
    ws = [(rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
          for k, n in zip(dims, dims[1:])]
    bs = [rng.normal(size=n).astype(np.float32) if on else None
          for n, on in zip(dims[1:], biased)]
    x = rng.normal(size=(M, dims[0])).astype(np.float32)
    plan = tfk.fcs_plan(M, dims, tm)
    # the order is the K split's alone: the rule's plan splits K alike
    _, rule_plan = tfk.fcs_route(M, dims, F32)
    assert (rule_plan.ks, rule_plan.per) == (plan.ks, plan.per)
    got = _staged_order(_t(x), [_t(w) for w in ws],
                        [None if b is None else _t(b) for b in bs], acts,
                        plan)
    want = j_fcs(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                 [None if b is None else jnp.asarray(b) for b in bs],
                 tuple(acts), bm=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
