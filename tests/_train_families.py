"""Shared cases of the new families' training tests
(``test_torch_train_families*.py``): the reduced configs with the
reference's weights carried across as numpy, batches, and the frozen
masks on each family's stacked leaves.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import model as jm
from repro_torch import interop
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.pruning import block_aware_prune
from repro_torch.tree import tree_items

ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b", "xlstm-1.3b", "zamba2-2.7b",
         "hubert-xlarge", "phi-3-vision-4.2b"]
MOE_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
TOL = dict(rtol=1e-5, atol=1e-6)
# xlstm-1.3b's f32 leaves: the chunkwise mLSTM sums its chunk products in
# another order than XLA (its forward differs by ~7e-6 of the largest
# output, tests/test_torch_ssm.py), and the backward carries that through 7
# mLSTM layers and the sLSTM's recurrence: measured within 1.2e-5 of each
# leaf's largest gradient (T 32, remat on and off; embed/w, slstm/wx and
# slstm/b the widest), held to 5e-5 of it.
XLSTM_REL = 5e-5
# a bf16 leaf (the norm gains, bf16 in every config) within one bf16 step
# of its largest value: a gradient or update an f32 ulp apart may round to
# the neighbouring bf16 value
BF16_STEP = 2.0 ** -8
# The stacked leaves each family trains under frozen masks: the routed
# experts (L, E, K, N); the mLSTM projections (L, 7, K, N); the Mamba2
# output projection (L, 6, K, N) and the tied shared block's MLP (K, N);
# the MLP (L, K, N) of the encoder and the VLM.
MASKED = {
    "moe": [("blocks", "moe", n, "w") for n in ("eg", "eu", "ed")],
    "ssm": [("blocks", "mlstm", n, "w") for n in ("wq", "wk", "wv", "wo")],
    "hybrid": [("blocks", "mamba", "wout", "w")]
    + [("shared_attn", "mlp", n, "w") for n in ("wg", "wu", "wd")],
    "encoder": [("blocks", "mlp", n, "w") for n in ("wu", "wd")],
    "vlm": [("blocks", "mlp", n, "w") for n in ("wg", "wu", "wd")],
}
PRUNE = dict(block=(16, 16), block_density=0.5, in_block_density=0.5)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the reduced configs' ops are
    tiny, and the workers of a parallel run share the cores (an xlstm-1.3b
    checkpoint round trip beside seven busy processes: 49 s with the
    default threads, 8 s with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _j_params(arch, param_dtype):
    """The reference's weights from ``PRNGKey(0)`` (one jitted init: the
    op-by-op init takes seconds a config)."""
    jcfg = dataclasses.replace(j_reduced(arch), param_dtype=param_dtype)
    return jax.jit(jm.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)


def pair(arch, **over):
    """The reference's and the port's reduced config (with ``over``), the
    reference's weights from ``PRNGKey(0)`` and the same as tensors."""
    jcfg = dataclasses.replace(j_reduced(arch), **over)
    tcfg = dataclasses.replace(t_reduced(arch), **over)
    jp = _j_params(arch, jcfg.param_dtype)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


def batch(cfg, B, T, seed):
    """The reference's and the port's batch: frame embeddings (encoder) or
    tokens, with prefix embeddings for the VLM; labels with masked
    positions."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.frontend == "frame":
        b["frame_embeds"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
        if cfg.frontend == "patch":
            b["prefix_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[:, :3] = -1
    b["labels"] = labels
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def np32(x):
    """A tensor or array as numpy f32 (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def stacked_masks(tree, paths, **prune):
    """``block_aware_prune`` masks, one per 2-D slice of each leaf at
    ``paths`` (numpy, the leaf's shape)."""
    out = {}
    for path in paths:
        w = np32(get(tree, path))
        flat = w.reshape(-1, *w.shape[-2:])
        out[path] = np.stack([block_aware_prune(s, **(prune or PRUNE))
                              for s in flat]).reshape(w.shape)
    return out


def mask_trees(jparams, masks_np):
    """The masks as the reference's full-structure tree (None where a leaf
    is not masked) and as the port's sparse nested dict."""
    def j_leaf(path, _):
        key = tuple(getattr(k, "key", None) for k in path)
        return jnp.asarray(masks_np[key]) if key in masks_np else None
    jmasks = jax.tree_util.tree_map_with_path(j_leaf, jparams)
    tmasks = {}
    for path, m in masks_np.items():
        d = tmasks
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = torch.from_numpy(m)
    return jmasks, tmasks


# AdamW's update divides m_hat by sqrt(v_hat) + eps, so where a gradient
# lies near zero its f32 rounding (the packages sum in other orders) moves
# that element's update by up to lr.  Measured after two steps (lr 1e-3):
# at most 44 of 327,424 f32 parameters (xlstm-1.3b; 4 elsewhere) beyond
# ``TOL``, the widest 0.11 lr (xlstm-1.3b ``mlstm/wif``; 0.027 lr
# elsewhere), while both moments hold ``TOL``.  So at most 1 in 1,000 f32
# parameters may leave ``TOL``, and none by more than lr / 4 a step.
ADAM_SHARE, ADAM_LR = 1e-3, 0.25


def _leaf_pairs(got, want):
    flat = dict(tree_items(got))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sorted(flat) == sorted(
        tuple(str(getattr(k, "key", k)) for k in p) for p, _ in paths)
    for path, leaf in paths:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        yield "/".join(key), flat[key], np32(flat[key]), np32(leaf)


def _tol(arch, t, want):
    top = float(np.abs(want).max()) if want.size else 0.0
    if t.dtype == torch.bfloat16:
        return dict(rtol=0, atol=BF16_STEP * top)
    if arch == "xlstm-1.3b":
        return dict(rtol=TOL["rtol"], atol=max(TOL["atol"], XLSTM_REL * top))
    return TOL


def assert_leaves_close(arch, got, want, what, like=None):
    """Every leaf of the port's tree ``got`` against the reference's
    ``want`` (same paths): f32 leaves within ``TOL`` (xlstm-1.3b within
    ``XLSTM_REL`` of the leaf's largest value), bf16 leaves within one bf16
    step of theirs; ``like`` (the parameters, for their AdamW moments) gives
    each leaf's dtype in place of its own."""
    dtypes = dict(tree_items(like if like is not None else got))
    for name, _, a, b in _leaf_pairs(got, want):
        t = dtypes[tuple(name.split("/"))]
        np.testing.assert_allclose(a, b, **_tol(arch, t, b),
                                   err_msg=f"{what} {name}")


def assert_params_close(arch, got, want, lr, steps):
    """Parameters after ``steps`` AdamW steps at ``lr``: as
    :func:`assert_leaves_close`, except that at most ``ADAM_SHARE`` of the
    f32 elements may leave their tolerance, each by no more than
    ``ADAM_LR · lr`` a step."""
    out, total = 0, 0
    for name, t, a, b in _leaf_pairs(got, want):
        tol = _tol(arch, t, b)
        if t.dtype == torch.bfloat16:
            np.testing.assert_allclose(a, b, **tol, err_msg=f"param {name}")
            continue
        out += int((np.abs(a - b) > tol["atol"] + tol["rtol"]
                    * np.abs(b)).sum())
        total += a.size
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=ADAM_LR * lr * steps + tol["atol"],
                                   err_msg=f"param {name}")
    assert out <= ADAM_SHARE * total, (out, total)
