"""The port's serving engine vs the JAX reference's engine: tokens, step
counts and cache bytes for every container under both reads, with and
without the compiled payloads (the cases: ``tests/_serve.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serve import (  # noqa: E402,F401
    KV_READS, one_thread, serve, serve_pair)
from repro.serve.engine import Request as JReq, ServeEngine as JEng  # noqa: E402
from repro_torch.kernels.flash_attention import decode_packed as tdp  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tqk  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402
from repro_torch.serve.engine import Request as TReq, ServeEngine as TEng  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("kv,read", KV_READS[:5])
def test_serve_engine_tokens_match_reference(serve_pair, compiled, kv, read):
    """The engine's tokens, step counts and cache bytes against the
    reference engine, for every container under both reads."""
    (jcfg, tcfg, jp, tp), (jcm, tcm) = serve_pair
    jparams, tparams = (jcm, tcm) if compiled else (jp, tp)
    rng = np.random.default_rng(1)
    # the 50-token prompt's 16-row chunk schedule (64 rows) overruns the
    # 60-row cache, so it is dripped token by token
    prompts = [rng.integers(0, 512, size=int(n)).astype(np.int32)
               for n in (3, 17, 40, 9, 50, 33)]
    kw = dict(batch_slots=3, max_len=60, prefill_chunk=16, kv_cache=kv,
              packed_read=read)
    jeng, jout = serve(JEng, JReq, jparams, jcfg, prompts, dispatch="jnp",
                        **kw)
    for mod in (tsk, tqk, tdp):
        mod.launches = 0
    teng, tout = serve(TEng, TReq, tparams, tcfg, prompts, device="cpu", **kw)
    assert tout == jout
    assert (tsk.launches, tqk.launches, tdp.launches) == (0, 0, 0)
    assert teng.cache_bytes() == jeng.cache_bytes()
    js, ts_ = jeng.stats(), teng.stats()
    for k in ("prefill_steps", "decode_steps", "prefill_tokens",
              "decode_tokens"):
        assert ts_[k] == js[k], k
    assert teng.tokens_processed() == jeng.tokens_processed()
    assert ts_["prefill_tokens"] == sum(len(p) for p in prompts) - 50
