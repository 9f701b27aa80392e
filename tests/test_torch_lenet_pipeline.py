"""The port's Fig. 1 LeNet-5 workflow (``repro_torch.train.lenet_pipeline``)
against the reference composed from ``repro``'s own functions, as the
reference's Table-I driver composes them (its training loop, global and
block-aware pruning, stored-bits accounting, whole-model and FC-only
compiles, DSE rows).

Inputs: ``repro``'s ``init_lenet(PRNGKey(0))`` carried across with
``params_from_numpy``, and the synthetic digits, byte-equal in one process.
Tolerances: losses f32 ``rtol=1e-5``; parameters after 4 AdamW steps f32
``rtol=1e-5, atol=1e-6`` but for a few weights AdamW amplifies (below);
cost-model estimates ``rtol=1e-9`` (plain Python floats on the same
specs); masks, bytes, policies and top-1 counts exactly.

The amplified weights: the two packages sum the convolutions' and
matmuls' products in other orders, so gradients differ by f32 rounding,
and AdamW divides each gradient by its own running magnitude
(``m̂ / √v̂`` is ±1 at the first step whatever the gradient's size).  A
weight whose gradient is near the rounding level can therefore move by up
to ``lr_t`` either way at each step: its gap is bounded by ``2 Σ lr_t``
and by nothing tighter.  Over 12 hash salts (the digits' batches differ by
process) the dense steps from the initial weights left at most 46 of
44,426 weights past ``TOL`` (the largest gap 1.44e-5), the masked QAT
steps none (4.9e-7).  So at most ``AMPLIFIED_SHARE`` of the weights may
leave ``TOL``, each within ``2 Σ lr_t``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import compile_sparse as jc  # noqa: E402
from repro.data.synthetic import synthetic_digits as j_digits  # noqa: E402
from repro.models import lenet as jl  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.core import TPU_V5E as T_TPU_V5E  # noqa: E402
from repro_torch.core import compile_lenet as t_compile  # noqa: E402
from repro_torch.core import realised_densities as t_realised  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.train import lenet_pipeline as lp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
AMPLIFIED_SHARE = 5e-3
STEPS = 4
# stored bits at the operating point's mask counts over dense f32 bits
# (BENCH_lenet_table1.json ``stored_bits_compression``)
STORED_BITS_COMPRESSION = 52.04474067088003
J_RULES = jc.CompileRules(block=(8, 4), min_weight_elems=0, quant_bits=4)


def _j_train(steps, params, masks=None, seed0=0, lr=2e-3, qat=None):
    """The reference's training loop, returning the step losses too."""
    task = j_digits(seed=0, noise=1.1)
    cfg = jopt.AdamWConfig(lr=lr, weight_decay=0.0, warmup_steps=5,
                           total_steps=steps)
    opt = jopt.adamw_init(params, cfg)
    wmasks = None
    if masks:
        wmasks = {k: (jnp.asarray(masks[k[:-2]])
                      if k.endswith("_w") and k[:-2] in masks else None)
                  for k in params}

    @jax.jit
    def step_fn(p, o, x, y):
        loss, g = jax.value_and_grad(jl.lenet_loss)(p, x, y, masks, qat)
        p, o, _ = jopt.adamw_update(g, o, p, cfg, masks=wmasks)
        return p, o, loss

    losses = []
    for s in range(steps):
        x, y = task.batch(seed0 + s, 64)
        params, opt, loss = step_fn(params, opt, jnp.asarray(x),
                                    jnp.asarray(y))
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in params.items()}, np.array(losses)


def _j_prune_masks(params):
    masks = {n: jcore.block_aware_prune(params[n + "_w"], lp.BLOCK[n],
                                        block_density=0.5,
                                        in_block_density=lp.FC_IN_BLOCK_DENSITY)
             for n in ("fc1", "fc2", "fc3")}
    for n in ("conv1", "conv2"):
        w4 = params[n + "_w"]
        m2 = jcore.block_aware_prune(np.asarray(jcore.conv_weight_matrix(w4)),
                                     lp.CONV_BLOCK[n],
                                     block_density=lp.CONV_BLOCK_DENSITY)
        masks[n] = np.asarray(jcore.conv_weight_unmatrix(m2, w4.shape))
    return masks


def _j_stored_bits(masks=None):
    total = 0.0
    for name, _, shape in jl.LAYERS:
        n = int(np.prod(shape))
        if masks and name in masks:
            total += int(np.asarray(masks[name]).sum()) * 4 + n / 64
        else:
            total += n * 32
    return total


def _pruned(params, masks):
    out = {k: v.copy() for k, v in params.items()}
    for n, m in masks.items():
        out[n + "_w"] = out[n + "_w"] * m
    return out


def _t(tree):
    return params_from_numpy(tree, device="cpu")


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def both():
    """4 dense steps, the reference-trained weights' masks, then 4 masked
    int4 QAT steps from the same pruned weights, in each package."""
    p0 = {k: np.asarray(v) for k, v in
          jl.init_lenet(jax.random.PRNGKey(0)).items()}
    jd, jd_loss = _j_train(STEPS, {k: jnp.asarray(v) for k, v in p0.items()})
    td, _, td_loss = lp.train_lenet(STEPS, params=_t(p0), device="cpu")
    masks = _j_prune_masks(jd)
    pp = _pruned(jd, masks)
    jq, jq_loss = _j_train(STEPS, {k: jnp.asarray(v) for k, v in pp.items()},
                           masks=masks, seed0=2000, lr=1.5e-3,
                           qat=lp.QAT_BITS)
    tq, _, tq_loss = lp.train_lenet(STEPS, masks=masks, params=_t(pp),
                                    seed0=2000, lr=1.5e-3, qat=lp.QAT_BITS,
                                    device="cpu")
    return dict(dense=(jd, jd_loss, _np(td), td_loss.numpy()),
                masked_qat=(jq, jq_loss, _np(tq), tq_loss.numpy()),
                masks=masks)


def _lr_sum(lr, steps=STEPS, warmup=5):
    """Σ lr_t over the first ``steps`` AdamW steps, all inside the warmup."""
    assert steps <= warmup
    return sum(lr * t / warmup for t in range(1, steps + 1))


@pytest.mark.parametrize("phase", ["dense", "masked_qat"])
def test_train_steps_match_reference(both, phase):
    jp, jloss, tp, tloss = both[phase]
    assert tloss.shape == (STEPS,)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    bound = 2 * _lr_sum(2e-3 if phase == "dense" else 1.5e-3)
    n_out = n_all = 0
    for k in jp:
        gap = np.abs(tp[k] - jp[k])
        out = gap > TOL["atol"] + TOL["rtol"] * np.abs(jp[k])
        assert (gap[out] <= bound).all(), (k, float(gap.max()), bound)
        n_out += int(out.sum())
        n_all += gap.size
    assert n_out <= AMPLIFIED_SHARE * n_all, (n_out, n_all)
    if phase == "masked_qat":
        for n, m in both["masks"].items():
            assert not jp[n + "_w"][~m].any() and not tp[n + "_w"][~m].any(), n


def test_prune_masks_match_reference_element_for_element(both):
    jd = both["dense"][0]
    got = lp.prune_masks(_t(jd))
    want = both["masks"]
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].dtype == bool and got[n].shape == want[n].shape, n
        assert np.array_equal(got[n], want[n]), n


def test_stored_bits_match_reference_and_the_pinned_ratio(both):
    masks, jd = both["masks"], both["dense"][0]
    assert lp.stored_bits(jd) == _j_stored_bits()
    assert lp.stored_bits(jd, masks) == _j_stored_bits(masks)
    ratio = lp.stored_bits(jd) / lp.stored_bits(jd, masks)
    assert ratio == STORED_BITS_COMPRESSION
    # every layer is masked: the quant_bits branch is never taken
    assert lp.stored_bits(jd, masks, quant_bits=8) == \
        lp.stored_bits(jd, masks)


def _compiles(both, which):
    jq, masks = both["masked_qat"][0], both["masks"]
    if which == "whole":
        kw = dict(blocks={**lp.BLOCK, **lp.CONV_BLOCK})
        m, jrules, trules = masks, J_RULES, lp.WHOLE_MODEL_RULES
    else:
        kw = dict(blocks=lp.BLOCK)
        m = {n: masks[n] for n in ("fc1", "fc2", "fc3")}
        pol = {"conv1": "dense", "conv2": "dense"}
        jrules = dataclasses.replace(J_RULES, policies=pol)
        trules = dataclasses.replace(lp.WHOLE_MODEL_RULES, policies=pol)
    jcm = jc.compile_lenet({k: jnp.asarray(v) for k, v in jq.items()}, m,
                           rules=jrules, **kw)
    tcm = t_compile(_t(jq), m, rules=trules, device="cpu", **kw)
    return jcm, tcm


@pytest.fixture(scope="module")
def compiles(both):
    return {w: _compiles(both, w) for w in ("whole", "fc_only")}


@pytest.mark.parametrize("which", ["whole", "fc_only"])
def test_compiles_match_reference(compiles, which):
    jcm, tcm = compiles[which]
    fields = ("name", "kind", "policy", "shape", "m_scale", "dense_bytes",
              "compressed_bytes", "realised_bytes", "block_density",
              "element_density")
    rows = lambda cm: [tuple(getattr(r, f) for f in fields)  # noqa: E731
                       for r in cm.report]
    assert rows(tcm) == rows(jcm)
    assert sorted(tcm.layers) == sorted(jcm.layers)
    assert tcm.byte_compression == jcm.byte_compression
    assert tcm.compression == jcm.compression
    assert tcm.container_storage_bytes == jcm.container_storage_bytes
    code, cont = lp.container_vs_int8_bytes(tcm)
    jcode = sum(int(np.prod(p.blocks.shape)) for p in
                (q.payload if isinstance(q, jcore.ConvPayload) else q
                 for q in jcm.layers.values()) if p.packed)
    assert code == jcode and cont > 0 and code == 2 * cont
    if which == "whole":
        assert tcm.byte_compression >= lp.BYTE_COMPRESSION_FLOOR
        assert tcm.byte_compression > compiles["fc_only"][1].byte_compression


@pytest.fixture(scope="module")
def fig1():
    torch.manual_seed(0)
    return lp.run(hw=T_TPU_V5E, device="cpu", steps=STEPS,
                  finetune_steps=STEPS)


@pytest.fixture(scope="module")
def j_rows(fig1):
    """The reference's six estimates on the port run's weights, and its
    whole-model compile of the run's pruned weights."""
    hw = jcore.TPU_V5E
    weights = {n: fig1.params[n + "_w"].numpy() for n in ("fc1", "fc2", "fc3")}
    ref = jcore.global_magnitude_prune(
        {k: v.reshape(-1, v.shape[-1]) for k, v in weights.items()},
        lp.PRUNE_SPARSITY)
    dens = {n: (0.6, max(0.02, 1 - jcore.sparsity_of(ref[n]))) for n in ref}
    specs = jl.lenet_layer_specs(batch=1, densities={
        "conv1": (0.5, 0.25), "conv2": (0.5, 0.2), **dens})
    base = jcore.balanced_folding_baseline(specs, hw, lp.BUDGET)
    res = jcore.run_dse(specs, resource_budget=lp.BUDGET)
    cfgs = {
        "auto_folding": base,
        "auto_pruning": [c.replace(quant_bits=8) for c in base],
        "unfold": [jcore.FoldingConfig(parallelism=hw.lanes, unroll="factor")
                   for _ in specs],
        "unfold_pruning": [jcore.FoldingConfig(
            parallelism=hw.lanes, unroll="sparse",
            block_density=s.max_block_density,
            element_density=s.max_element_density, quant_bits=8)
            for s in specs],
        "proposed": res.configs,
    }
    out = {k: (jcore.network_estimate(specs, c, hw), None)
           for k, c in cfgs.items()}
    out["proposed"] = (out["proposed"][0], res)
    jcm = jc.compile_lenet(
        {k: jnp.asarray(v.numpy()) for k, v in fig1.pruned_params.items()},
        fig1.masks, blocks={**lp.BLOCK, **lp.CONV_BLOCK}, rules=J_RULES)
    specs_r = jcore.apply_realised_densities(specs,
                                             jc.realised_densities(jcm))
    res_r = jcore.run_dse(specs_r, resource_budget=lp.BUDGET)
    out["proposed_realised"] = (
        jcore.network_estimate(specs_r, res_r.configs, hw), res_r)
    return out, jcm


STRATEGIES = ["auto_folding", "auto_pruning", "unfold", "unfold_pruning",
              "proposed", "proposed_realised"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_row_matches_reference_estimates(fig1, j_rows, strategy):
    assert [r["strategy"] for r in fig1.rows] == STRATEGIES
    want, jcm = j_rows
    est, res = want[strategy]
    row = next(r for r in fig1.rows if r["strategy"] == strategy)
    np.testing.assert_allclose(row["latency_us"], est.latency * 1e6,
                               rtol=1e-9)
    np.testing.assert_allclose(row["throughput_fps"], est.throughput,
                               rtol=1e-9)
    np.testing.assert_allclose(row["resource_bytes"], est.resource,
                               rtol=1e-9)
    assert row["bottleneck"] == est.bottleneck
    if res is not None:
        assert row["sparse_layers"] == ",".join(res.sparse_layers)
    if strategy == "proposed":
        assert row["dse_moves"] == len(res.trace) - 1
    if strategy == "proposed_realised":
        assert row["compression"] == jcm.byte_compression
        assert t_realised(fig1.cm_whole) == jc.realised_densities(jcm)
        assert row["bench"]["stored_bits_compression"] == \
            STORED_BITS_COMPRESSION
    elif strategy in ("auto_folding", "unfold"):
        assert row["compression"] == 1.0
    else:
        assert row["compression"] == STORED_BITS_COMPRESSION


def _j_accuracy(params, masks=None, compressed=None, qat=None):
    """The reference's top-1, its forward jitted (one XLA compile in place
    of eager dispatch's one a primitive: the same logits, bit for bit, on
    these inputs)."""
    x, y = j_digits(seed=0, noise=1.1).batch(*lp.TEST_BATCH, split="test")
    fwd = jax.jit(lambda p, xx: jl.lenet_forward(
        p, xx, masks=masks, compressed=compressed, qat_bits=qat))
    logits = fwd({k: jnp.asarray(v) for k, v in params.items()},
                 jnp.asarray(x))
    return float((jnp.argmax(logits, -1) == jnp.asarray(y)).mean())


@pytest.mark.parametrize("which", ["dense", "pruned_masked",
                                   "whole_compressed"])
def test_accuracy_matches_reference(fig1, j_rows, which):
    """Top-1 on the 1024 test digits: the dense forward, the masked int4
    QAT forward, and the whole-model compile's fused forward on the plain
    versions (``dispatch="twin"``) against the reference's jnp twins."""
    bench = fig1.rows[-1]["bench"]
    if which == "dense":
        p = _np(fig1.params)
        want = _j_accuracy(p)
        got = lp.accuracy(fig1.params, fig1.task)
        assert bench["accuracy_dense"] == got
    elif which == "pruned_masked":
        p = _np(fig1.pruned_params)
        want = _j_accuracy(p, masks=fig1.masks, qat=lp.QAT_BITS)
        got = lp.accuracy(fig1.pruned_params, fig1.task, masks=fig1.masks,
                          qat=lp.QAT_BITS)
        assert bench["accuracy_pruned_masked"] == got
    else:
        p = _np(fig1.pruned_params)
        jcm = j_rows[1]
        want = _j_accuracy(p, compressed=jcm.layers)
        got = lp.accuracy(fig1.pruned_params, fig1.task,
                          compressed=fig1.cm_whole.layers, dispatch="twin")
        assert bench["accuracy_whole_compressed"] == got
    assert got == want


def test_run_returns_the_artefacts(fig1):
    """The run hands back what a caller deploys: pruned weights exactly zero
    where masked, both compiles on the fusion plan, falling-shape losses of
    the right length."""
    assert fig1.losses["dense"].shape == (STEPS,)
    assert fig1.losses["finetune"].shape == (STEPS,)
    assert bool(torch.isfinite(fig1.losses["finetune"]).all())
    for n, m in fig1.masks.items():
        assert not fig1.pruned_params[n + "_w"][torch.from_numpy(~m)].any()
    assert fig1.cm_whole.fusion == {"conv1": {"pool": ("avg", 2)},
                                    "conv2": {"pool": ("avg", 2)},
                                    "fc_stack": ("fc1", "fc2", "fc3")}
    assert "conv1" not in fig1.cm_fc.layers and "fc1" in fig1.cm_fc.layers
