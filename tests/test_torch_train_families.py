"""Training the MoE, SSM, hybrid, encoder and VLM families: the port's
gradients vs the JAX reference's on the same numpy inputs, at the
reference's ``reduced_config`` sizes (f32 weights, bf16 norm gains) with
its weights carried across.

* the loss and every trainable leaf's gradient of ``loss_fn`` (through
  ``make_train_step``'s ``_split_trainable`` / ``_merge``) against
  ``jax.value_and_grad(repro.models.model.loss_fn)``, with remat on and
  off on both sides: the stacked expert leaves, the mLSTM / sLSTM stacks,
  the hybrid's tied ``shared_attn`` (its gradient the sum over the
  super-blocks that use it), the frontends' projection; a leaf the loss
  does not reach (the encoder's token embedding) has a zero gradient in
  both;
* the MoE router's top-k sets of every token at every layer equal the
  reference's (a flip fails, no tolerance absorbs it);
* AdamW over leaves of more than ``UPDATE_CHUNK`` elements, updated a
  slice at a time, is bitwise the one-piece update, masks included;
* the SSM and hybrid gradients stay finite over whole 256-position chunks,
  where the reference's ``exp`` before its select overflows.

Tolerances (``tests/_train_families.py``): f32 ``rtol=1e-5, atol=1e-6``;
xlstm-1.3b's f32 leaves within 5e-5 of the leaf's largest gradient
(measured 1.2e-5: the chunkwise mLSTM's summation order); bf16 leaves
within one bf16 step of their largest value.  The masked train steps are
in ``test_torch_train_families_step.py``.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_families import (  # noqa: E402,F401
    ARCHS, MOE_ARCHS, TOL, assert_leaves_close, batch, one_thread, pair)
from repro.models import model as jm  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402


pytestmark = pytest.mark.usefixtures("one_thread")


def _unflat(flat):
    out = {}
    for path, leaf in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, remat):
    jcfg, tcfg, jp, tp = pair(arch, remat=remat)
    jb, tbatch = batch(tcfg, 2, 32, 0)
    jv, jg = jax.value_and_grad(jm.loss_fn)(jp, jcfg, jb)
    trainable, frozen = ttr._split_trainable(tp)
    tv = tm.loss_fn(ttr._merge(trainable, frozen), tcfg, tbatch)
    items = list(tree_items(trainable))
    grads = torch.autograd.grad(tv, [t for _, t in items], allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), **TOL)
    assert_leaves_close(arch, _unflat({p: g for (p, _), g in
                                       zip(items, grads)}), jg, "grad")
    # nothing of the caller's tree was touched by the split
    assert all(not t.requires_grad for _, t in tree_items(tp))
    if arch == "hubert-xlarge":   # the token embedding is unused
        assert float(np.abs(np.asarray(jg["embed"]["w"])).max()) == 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_topk_sets_match_reference(arch, monkeypatch):
    """Every token's set of top-k experts at every layer, recorded inside
    the reference's forward (``jax.lax.top_k`` wrapped with a debug
    callback) and the port's (``moe_route`` wrapped), over the B·T tokens
    of a train micro-batch."""
    jcfg, tcfg, jp, tp = pair(arch)
    jb, tbatch = batch(tcfg, 2, 32, 1)
    j_ids, t_ids = [], []
    top_k = jax.lax.top_k

    def j_top_k(x, k):
        vals, ids = top_k(x, k)
        jax.debug.callback(lambda a: j_ids.append(np.asarray(a)), ids,
                           ordered=True)
        return vals, ids

    route = tb.moe_route

    def t_route(*a, **kw):
        out = route(*a, **kw)
        t_ids.append(out[0].numpy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_top_k)
    monkeypatch.setattr(tb, "moe_route", t_route)
    jax.block_until_ready(jm.loss_fn(jp, jcfg, jb))
    with torch.no_grad():
        tm.loss_fn(tp, tcfg, tbatch)
    assert len(t_ids) == len(j_ids) == tcfg.n_layers
    for layer, (a, b) in enumerate(zip(t_ids, j_ids)):
        np.testing.assert_array_equal(np.sort(a, -1), np.sort(b, -1),
                                      err_msg=f"layer {layer}")


def test_chunked_adamw_is_bitwise_the_one_piece_update(monkeypatch):
    """A stacked (L, E, K, N) leaf with a mask and a bf16 leaf, updated
    whole and a slice of ``UPDATE_CHUNK`` elements at a time (a chunk that
    does not divide the leaf): equal bit for bit, pruned entries zero."""
    rng = np.random.default_rng(0)
    p = {"e": torch.from_numpy(rng.normal(size=(2, 3, 8, 16)).astype(
        np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))}
    mask = torch.from_numpy(rng.random((2, 3, 8, 16)) < 0.5)
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    grads = [{k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(
        np.float32)) for k, v in p.items()} for _ in range(3)]
    outs = []
    for chunk in (topt.UPDATE_CHUNK, 100):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        params, st = dict(p), topt.adamw_init(p, cfg)
        for g in grads:
            params, st, _ = topt.adamw_update(g, st, params, cfg,
                                              masks={"e": mask})
        outs.append((params, st))
    (pa, sa), (pb, sb) = outs
    for k in p:
        assert torch.equal(pa[k], pb[k]) and pa[k].dtype == p[k].dtype
        assert torch.equal(sa["m"][k], sb["m"][k])
        assert torch.equal(sa["v"][k], sb["v"][k])
    assert bool((pa["e"][~mask] == 0).all()) and bool(
        (pa["e"][mask] != 0).any())


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
def test_gradients_stay_finite_over_whole_chunks(arch):
    """At T 512 (two whole 256-position chunks) the decay terms above a
    chunk's diagonal leave f32's range.  The reference's ``where(causal,
    exp(diff), 0)`` then has 0 · inf = NaN gradients (measured on the CPU
    at this size: 12 of xlstm-1.3b's 14 leaves, 17 of zamba2-2.7b's 19);
    the port selects before the ``exp``, so its loss and every gradient
    stay finite."""
    _, tcfg, _, tp = pair(arch)
    _, tbatch = batch(tcfg, 1, 512, 2)
    trainable, frozen = ttr._split_trainable(tp)
    loss = tm.loss_fn(ttr._merge(trainable, frozen), tcfg, tbatch)
    items = list(tree_items(trainable))
    grads = torch.autograd.grad(loss, [t for _, t in items])
    assert bool(torch.isfinite(loss))
    for (path, _), g in zip(items, grads):
        assert bool(torch.isfinite(g).all()), "/".join(path)
