"""Port training path (forward / loss, AdamW with frozen masks, the train
and prefill steps, pruning, fake quantisation, token data, the launcher) vs
the JAX reference on the same numpy inputs, at ``reduced_config`` size
(2 layers, d_model 64, f32).

Tolerances: f32 values ``rtol=1e-5, atol=1e-6`` (the packages sum the same
products in different orders); bf16 AdamW moments: see
``test_adamw_update_matches_reference``.  Integer outputs — tokens, labels, masks —
are equal byte for byte.  The bf16 train step compares within 1e-2
relative: XLA and PyTorch round bf16 matmul outputs at different points
(XLA's CPU dot accumulates bf16 products in f32 and rounds once, PyTorch's
CPU bf16 matmul may round partial sums), and one bf16 step is 2^-8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core.quant import fake_quant as j_fake_quant  # noqa: E402
from repro.core.sparsity import compression_ratio as j_cr  # noqa: E402
from repro.data.synthetic import token_batch as j_token_batch  # noqa: E402
from repro.models import lenet as jlenet  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.core.quant import fake_quant as t_fake_quant  # noqa: E402
from repro_torch.core.sparsity import compression_ratio as t_cr  # noqa: E402
from repro_torch.data.synthetic import synthetic_digits  # noqa: E402
from repro_torch.data.synthetic import token_batch as t_token_batch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import lenet as tlenet  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = "llama3.2-1b"
MLP = ("wg", "wu", "wd")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _assert_trees_close(got, want, **tol):
    flat = dict(tree_items(got))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(flat)
    for path, leaf in paths:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_allclose(_np(flat[key]), _np(leaf), **tol,
                                   err_msg="/".join(key))


def _pair(**over):
    jcfg = dataclasses.replace(j_reduced(ARCH), **over)
    tcfg = dataclasses.replace(t_reduced(ARCH), **over)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


def _batch(B=4, T=32, vocab=128, step=0):
    toks, labels = j_token_batch(step, B, T, vocab)
    labels[0, :5] = -1          # masked positions
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _mlp_masks(params_np, block=(16, 32)):
    """block_aware_prune masks of every stacked MLP weight (numpy)."""
    out = {}
    for name in MLP:
        w = np.asarray(params_np["blocks"]["mlp"][name]["w"], np.float32)
        out[name] = np.stack([tpr.block_aware_prune(
            w[i], block, block_density=0.5, in_block_density=0.5)
            for i in range(w.shape[0])])
    return out


def _mask_trees(params, masks_np):
    """The same masks as the reference's full-structure tree (None where a
    leaf is not masked) and as the port's sparse dict."""
    def j_leaf(path, _):
        keys = [getattr(k, "key", None) for k in path]
        if keys[:2] == ["blocks", "mlp"] and keys[2] in masks_np:
            return jnp.asarray(masks_np[keys[2]])
        return None
    jmasks = jax.tree_util.tree_map_with_path(j_leaf, params)
    tmasks = {"blocks": {"mlp": {n: {"w": torch.from_numpy(m)}
                                 for n, m in masks_np.items()}}}
    return jmasks, tmasks


# ------------------------------------------------------------ forward / loss


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grads_match_reference(remat):
    jcfg, tcfg, jp, tp = _pair(remat=remat)
    jb, tb = _batch()
    np.testing.assert_allclose(tm.forward(tp, tcfg, tb).detach().numpy(),
                               np.asarray(jm.forward(jp, jcfg, jb)), **TOL)
    jv, jg = jax.value_and_grad(jm.loss_fn)(jp, jcfg, jb)
    trainable, frozen = ttr._split_trainable(tp)
    tv = tm.loss_fn(ttr._merge(trainable, frozen), tcfg, tb)
    leaves = [t for _, t in tree_items(trainable)]
    grads = torch.autograd.grad(tv, leaves)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    tgrads = {p: g for (p, _), g in zip(tree_items(trainable), grads)}
    _assert_trees_close(_unflat(tgrads), jg, **TOL)


def _unflat(flat):
    out = {}
    for path, leaf in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def test_prefill_step_is_the_last_position_of_forward():
    _, tcfg, _, tp = _pair()
    _, tb = _batch()
    got = ttr.make_prefill_step(tcfg)(tp, tb)
    assert not got.requires_grad
    torch.testing.assert_close(got, tm.forward(tp, tcfg, tb)[:, -1].detach(),
                               rtol=0, atol=0)


# ------------------------------------------------------------------ AdamW


def test_schedule_matches_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 100, 130):
        np.testing.assert_allclose(
            float(topt.schedule(topt.AdamWConfig(**cfg), step)),
            float(jopt.schedule(jopt.AdamWConfig(**cfg), step)), **TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    _, _, jp, tp = _pair()
    masks_np = _mlp_masks(jp)
    jmasks, tmasks = _mask_trees(jp, masks_np)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5,
              state_dtype=state_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jst, tst = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    rng = np.random.default_rng(0)
    for _ in range(4):
        g = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.05, jp)
        jg = jax.tree_util.tree_map(lambda a, p: jnp.asarray(a, p.dtype), g,
                                    jp)
        tg = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jg),
                                       "cpu")
        jp, jst, jmet = jopt.adamw_update(jg, jst, jp, jcfg, masks=jmasks)
        tp, tst, tmet = topt.adamw_update(tg, tst, tp, tcfg, masks=tmasks)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    if state_dtype == "bfloat16":
        # an f32 moment one ulp apart (XLA may fuse m * b1 + (1 - b1) * g
        # into one FMA) can round to the neighbouring bf16 value, and the
        # flip carries into later steps: moments within two bf16 steps of
        # each leaf's largest moment, params within one step of lr per
        # update
        _assert_trees_close(tp, jp, rtol=1e-5, atol=4 * kw["lr"] * 2 ** -8)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                {"m": jst["m"], "v": jst["v"]})[0]:
            want = _np(leaf)
            got = tst
            for k in path:
                got = got[k.key]
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=2 ** -7 * np.abs(want).max())
    else:
        _assert_trees_close(tp, jp, **TOL)
        _assert_trees_close(tst, jst, **TOL)
    assert tst["m"]["embed"]["w"].dtype == (
        torch.bfloat16 if state_dtype == "bfloat16" else torch.float32)
    for n, m in masks_np.items():
        w = tp["blocks"]["mlp"][n]["w"].numpy()
        assert np.all(w[~m] == 0) and np.any(w[m] != 0)


def test_adamw_minimises_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=100, min_lr_frac=1.0, grad_clip=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = topt.adamw_init(params, cfg)
    for _ in range(200):
        params, opt, _ = topt.adamw_update({"x": 2 * params["x"]}, opt, params,
                                           cfg)
    assert float((params["x"] ** 2).sum()) < 1e-3


# ------------------------------------------------------------- train step


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    jcfg, tcfg, jp, tp = _pair()
    jmasks, tmasks = _mask_trees(jp, _mlp_masks(jp))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt.AdamWConfig(**kw), n_micro,
                                        jmasks))
    tstep = ttr.make_train_step(tcfg, topt.AdamWConfig(**kw), n_micro, tmasks)
    jst = jopt.adamw_init(jp, jopt.AdamWConfig(**kw))
    tst = topt.adamw_init(tp, topt.AdamWConfig(**kw))
    for step in range(2):
        jb, tb = _batch(step=step)
        jp, jst, jmet = jstep(jp, jst, jb)
        tp, tst, tmet = tstep(tp, tst, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL,
                                       err_msg=k)
    _assert_trees_close(tp, jp, **TOL)
    _assert_trees_close(tst, jst, **TOL)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_bf16_train_step_matches_reference(n_micro):
    """bf16 weights: grads keep bf16 with one micro-batch and accumulate in
    f32 with two, in both packages (tolerance: module docstring)."""
    jcfg, tcfg, jp, tp = _pair(param_dtype="bfloat16")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt.AdamWConfig(**kw), n_micro))
    tstep = ttr.make_train_step(tcfg, topt.AdamWConfig(**kw), n_micro)
    jb, tb = _batch()
    _, _, jmet = jstep(jp, jopt.adamw_init(jp, jopt.AdamWConfig(**kw)), jb)
    tp2, _, tmet = tstep(tp, topt.adamw_init(tp, topt.AdamWConfig(**kw)), tb)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-2,
                                   err_msg=k)
    assert tp2["blocks"]["mlp"]["wg"]["w"].dtype == torch.bfloat16


def test_pick_n_micro_matches_reference():
    cfg = t_reduced(ARCH)
    for gb in (1, 2, 4, 6, 8, 12, 256):
        for dp in (d for d in (1, 2, 4) if gb % d == 0):
            assert ttr.pick_n_micro(cfg, gb, dp) == jtr.pick_n_micro(
                j_reduced(ARCH), gb, dp)


# ------------------------------------------------- pruning, quant, data


def test_token_batch_is_byte_equal():
    for kw in (dict(step=0, batch=4, seq=16, vocab=100),
               dict(step=5, batch=3, seq=64, vocab=128256, seed=1, shard=2)):
        for a, b in zip(t_token_batch(**kw), j_token_batch(**kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_pruning_masks_are_byte_equal():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    for bd, ibd in ((0.25, 0.5), (0.5, 1.0), (0.1, 0.3)):
        a = tpr.block_aware_prune(w, (16, 32), block_density=bd,
                                  in_block_density=ibd)
        b = jpr.block_aware_prune(w, (16, 32), block_density=bd,
                                  in_block_density=ibd)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert tpr.sparsity_of(a) == jpr.sparsity_of(b)
    np.testing.assert_array_equal(tpr.layer_magnitude_prune(w, 0.7),
                                  jpr.layer_magnitude_prune(w, 0.7))
    ws = {"a": w, "b": w[:10] * 3, "c": w[:, :5]}
    pr = lambda n: n != "c"
    ta = tpr.global_magnitude_prune(ws, 0.6, prunable=pr)
    ja = jpr.global_magnitude_prune(ws, 0.6, prunable=pr)
    for n in ws:
        np.testing.assert_array_equal(ta[n], ja[n])
    with pytest.raises(ValueError, match="divisible"):
        tpr.block_aware_prune(w, (10, 32), block_density=0.5)


def test_apply_masks_and_masked_update_match_reference():
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(size=(4, 6)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    m = {"a": rng.random((4, 6)) < 0.5, "b": None}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tmk = {"a": torch.from_numpy(m["a"]), "b": None}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jmk = {"a": jnp.asarray(m["a"]), "b": None}
    for tf, jf in ((tpr.apply_masks, jpr.apply_masks),
                   (tpr.masked_update, jpr.masked_update)):
        got, want = tf(tp, tmk), jf(jp, jmk)
        for k in p:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("bits,axis", [(8, -1), (4, -1), (4, 0), (2, 1)])
def test_fake_quant_forward_and_straight_through_gradient(bits, axis):
    w = np.random.default_rng(bits).normal(size=(6, 5, 4)).astype(np.float32)
    want = j_fake_quant(jnp.asarray(w), bits, axis)
    wt = torch.from_numpy(w).requires_grad_()
    got = t_fake_quant(wt, bits, axis)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    g = np.random.default_rng(9).normal(size=w.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda x: jnp.sum(j_fake_quant(x, bits, axis) * g))(
        jnp.asarray(w))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(wt.grad.numpy(), g)


def test_fake_quant_of_a_vector_quantises_each_element():
    w = np.array([0.3, -1.7, 2.2], np.float32)
    np.testing.assert_allclose(
        t_fake_quant(torch.from_numpy(w), 4, 0).numpy(),
        np.asarray(j_fake_quant(jnp.asarray(w), 4, 0)), **TOL)


def test_compression_ratio_matches_reference():
    for kw in (dict(shape=(256, 120), nnz=4000),
               dict(shape=(64, 64), nnz=0, bits=4, block_meta_bits=16),
               dict(shape=(128, 8), nnz=77, bits=2, index_bits_per_nnz=1.5)):
        assert t_cr(**kw) == j_cr(**kw)


# ------------------------------------------------------------------ LeNet


def test_lenet_qat_forward_matches_reference():
    jparams = jlenet.init_lenet(jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    x, y = synthetic_digits(0).batch(0, 16)
    bits = {"conv1": 8, "conv2": 4, "fc1": 4, "fc3": 2}
    np.testing.assert_allclose(
        tlenet.lenet_forward(tparams, torch.from_numpy(x),
                             qat_bits=bits).numpy(),
        np.asarray(jlenet.lenet_forward(jparams, jnp.asarray(x),
                                        qat_bits=bits)), **TOL)
    np.testing.assert_allclose(
        float(tlenet.lenet_loss(tparams, torch.from_numpy(x),
                                torch.from_numpy(y), qat_bits=bits)),
        float(jlenet.lenet_loss(jparams, jnp.asarray(x), jnp.asarray(y),
                                qat_bits=bits)), **TOL)


def _lenet_step(params, opt, x, y, cfg, masks=None):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = tlenet.lenet_loss(leaves, x, y, masks)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    wmasks = None if masks is None else {
        k: (masks[k[:-2]] if k.endswith("_w") and k[:-2] in masks else None)
        for k in params}
    params, opt, _ = topt.adamw_update(grads, opt, params, cfg, masks=wmasks)
    return params, opt, float(loss.detach())


def test_lenet_training_loss_decreases():
    task = synthetic_digits(seed=0)
    params = tlenet.init_lenet(seed=0, device="cpu")
    cfg = topt.AdamWConfig(lr=2e-3, weight_decay=0.0, warmup_steps=5,
                           total_steps=60, grad_clip=1.0)
    opt = topt.adamw_init(params, cfg)
    losses = []
    for step in range(60):
        x, y = task.batch(step, 64)
        params, opt, loss = _lenet_step(params, opt, torch.from_numpy(x),
                                        torch.from_numpy(y), cfg)
        losses.append(loss)
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5])
    x, y = task.batch(10_000, 256, split="test")
    with torch.no_grad():
        pred = tlenet.lenet_forward(params, torch.from_numpy(x)).argmax(-1)
    assert float((pred.numpy() == y).mean()) > 0.9


def test_masked_training_preserves_sparsity():
    """Re-sparse fine-tuning: pruned weights stay exactly zero."""
    task = synthetic_digits(seed=0)
    params = tlenet.init_lenet(seed=0, device="cpu")
    mask = tpr.block_aware_prune(params["fc1_w"].numpy(), (16, 24),
                                 block_density=0.5, in_block_density=0.5)
    masks = {"fc1": torch.from_numpy(mask)}
    params["fc1_w"] = params["fc1_w"] * masks["fc1"]
    cfg = topt.AdamWConfig(lr=2e-3, weight_decay=0.1, warmup_steps=0,
                           total_steps=20)
    opt = topt.adamw_init(params, cfg)
    for step in range(10):
        x, y = task.batch(step, 32)
        params, opt, _ = _lenet_step(params, opt, torch.from_numpy(x),
                                     torch.from_numpy(y), cfg, masks)
    w = params["fc1_w"].numpy()
    assert np.abs(w[~mask]).max() == 0.0
    assert np.abs(w[mask]).sum() > 0.0
    assert abs(tpr.sparsity_of(w != 0) - tpr.sparsity_of(mask)) < 1e-6


# --------------------------------------------------------------- launcher


def test_launcher_trains_on_the_cpu(tmp_path):
    runner = tlaunch.main(["--arch", ARCH, "--steps", "3", "--batch", "4",
                           "--seq", "16", "--device", "cpu", "--ckpt",
                           str(tmp_path), "--ckpt-every", "2"])
    assert len(runner.metrics_log) == 3
    assert all(np.isfinite(m["loss"]) for m in runner.metrics_log)
    assert runner.ckpt.all_steps() == [2, 3]


def test_launcher_needs_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", ARCH, "--steps", "1", "--ckpt",
                      str(tmp_path)])
