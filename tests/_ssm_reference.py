"""The reference's drip (``repro.models.model.decode_step``, JAX, plain
``jnp``) on the port's seed-0 weights, carried across as numpy, for the
placed drips of ``tests/test_torch_{hybrid,xlstm}_sharding_serve.py``."""
import functools

import numpy as np


@functools.cache
def reference_drip(arch: str) -> list:
    """The reference's :data:`_ssm_workers.DRIP_STEPS` decode steps'
    logits from an empty float cache of 4 slots and 16 rows, on the
    stock reduced config's seed-0 port weights and the drip's tokens."""
    import jax.numpy as jnp
    from repro.models import model as jm
    from repro.models.config import ArchConfig as JCfg

    from _ssm_workers import DRIP_STEPS, configs, drip_tokens
    from repro_torch.models import model as tm
    from repro_torch.tree import tree_map

    cfg = configs(arch)["stock"]
    jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if str(t.dtype) == "torch.bfloat16" else jnp.float32),
        tm.init_params(cfg, seed=0, device="cpu"))
    cache = jm.init_cache(jcfg, 4, 16, kv_cache="float")
    toks = drip_tokens(cfg)
    out = []
    for i in range(DRIP_STEPS):
        lg, cache = jm.decode_step(jp, jcfg, cache,
                                   jnp.asarray(toks[:, i:i + 1]),
                                   dispatch="jnp")
        out.append(np.asarray(lg, np.float32))
    return out


def assert_matches_reference(got: list, arch: str, rel: float) -> None:
    want = reference_drip(arch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()), (arch, err)
