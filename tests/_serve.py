"""Shared cases of the port's serving tests (``test_torch_serve*.py``):
the tiny transformer pair (the reference's weights carried across as
numpy) and its compiles, the serving pair, the cache comparison and the
engine drive.  The costly pairs are built once a process, whichever of the
files asks first.

Logits: f32 ``rtol=1e-5, atol=1e-5`` (the two packages sum matmul products
in different orders).  Integer cache containers (packed codes) must be
equal byte for byte; their f32 scales within the same tolerance.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import compile_sparse as jc
from repro.models import model as jm
from repro.models.config import ArchConfig as JCfg
from repro_torch import interop
from repro_torch.core import compile_sparse as tc
from repro_torch.models.config import ArchConfig as TCfg

from _train_families import one_thread  # noqa: F401  (the tests' fixture)

TOL = dict(rtol=1e-5, atol=1e-5)
POLICIES = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
            "wg": "sparse", "wu": "sparse", "wd": "sparse"}
KV_READS = [("float", "fused"), ("int4", "fused"), ("int4", "unpack"),
            ("int4x2", "fused"), ("int4x2", "unpack"), ("float", "unpack")]


def pair(**over):
    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab=96,
              param_dtype="float32", tie_embeddings=True)
    kw.update(over)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


def compile_pair(jcfg, tcfg, jp, tp, block):
    kw = dict(block=block, block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, quant_bits=4, policies=POLICIES)
    jcm = jc.compile_model(jp, jcfg, rules=jc.CompileRules(**kw))
    tcm = tc.compile_model(tp, tcfg, rules=tc.CompileRules(**kw),
                           device="cpu")
    return jcm, tcm


@functools.cache
def _tiny():
    jcfg, tcfg, jp, tp = pair()
    jcm, tcm = compile_pair(jcfg, tcfg, jp, tp, (32, 32))
    return jcfg, tcfg, jp, tp, jcm, tcm


@functools.cache
def _serve_pair():
    jcfg, tcfg, jp, tp = pair(d_model=256, n_heads=4, n_kv_heads=2,
                              head_dim=64, d_ff=512, vocab=512)
    return (jcfg, tcfg, jp, tp), compile_pair(jcfg, tcfg, jp, tp, (128, 128))


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.fixture(scope="module")
def serve_pair():
    return _serve_pair()


def cache_np(cache):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in cache.items()}


def check_caches(jcache, tcache):
    j, t = cache_np(jcache), cache_np(tcache)
    assert sorted(j) == sorted(t)
    for k in j:
        if j[k].dtype.kind == "f":
            np.testing.assert_allclose(t[k], j[k], **TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def serve(engine_cls, req_cls, params, cfg, prompts, **kw):
    eng = engine_cls(params, cfg, **kw)
    for i, p in enumerate(prompts):
        eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=6))
    done = eng.run()
    return eng, [r.out for r in sorted(done, key=lambda r: r.uid)]
