"""Port prefill and decode steps vs the JAX reference, every cache
container under both reads, with and without the compiled payloads (the
cases and tolerances: ``tests/_serve.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serve import (  # noqa: E402,F401
    KV_READS, TOL, check_caches, one_thread, tiny)
from repro.models import model as jm  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("kv,read", KV_READS)
def test_prefill_and_decode_steps_match_reference(tiny, kv, read, compiled):
    """Every container under both reads (the float cache ignores the read)
    against the reference: codes exact, scales and logits within TOL."""
    jcfg, tcfg, jp, tp, jcm, tcm = tiny
    jparams, tparams = (jcm.params, tcm.params) if compiled else (jp, tp)
    jpat, tpat = (jcm.patterns, tcm.patterns) if compiled else (None, None)
    B, T = 3, 16
    jcache = jm.init_cache(jcfg, B, T, kv_cache=kv)
    tcache = tm.init_cache(tcfg, B, T, kv_cache=kv, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 96, size=(B, 8)).astype(np.int32)
    nv = np.array([8, 5, 0], np.int32)
    jl, jcache = jm.prefill_step(jparams, jcfg, jcache, jnp.asarray(toks),
                                 patterns=jpat, dispatch="jnp",
                                 n_valid=jnp.asarray(nv), t_bound=16, bt=8,
                                 packed_read=read)
    tl, tcache = tm.prefill_step(tparams, tcfg, tcache, torch.from_numpy(toks),
                                 patterns=tpat, n_valid=torch.from_numpy(nv),
                                 t_bound=16, bt=8, packed_read=read)
    for b in range(B):
        np.testing.assert_allclose(tl[b, :nv[b]].numpy(),
                                   np.asarray(jl)[b, :nv[b]], **TOL)
    check_caches(jcache, tcache)
    for step in range(3):
        tok = rng.integers(0, 96, size=(B, 1)).astype(np.int32)
        act = np.array([1, 1, step % 2], np.int32)
        jl, jcache = jm.decode_step(jparams, jcfg, jcache, jnp.asarray(tok),
                                    patterns=jpat, dispatch="jnp",
                                    active=jnp.asarray(act), t_bound=16, bt=8,
                                    packed_read=read)
        tl, tcache = tm.decode_step(tparams, tcfg, tcache,
                                    torch.from_numpy(tok), patterns=tpat,
                                    active=torch.from_numpy(act), t_bound=16,
                                    bt=8, packed_read=read)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        check_caches(jcache, tcache)
