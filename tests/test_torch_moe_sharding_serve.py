"""The MoE family's placed serving path and its layer: reduced olmoe-1b-7b
and qwen2-moe-a2.7b (f32) on DTensors under gloo at world sizes 2 and 4
on the CPU (``tests/_moe_workers.py``, ``kind="moe_serve"``).

* ``make_prefill_step`` and two ``make_serve_step`` calls, as the dry-run
  calls them, within ``REL`` of one process.
* The drip: five decode steps from an empty cache of a compiled model
  (quant attention projections; qwen2-moe-a2.7b's shared expert as sparse
  blocks under stripe masks, pattern-sharded over a ``model`` axis of 2)
  with the float and int4x2 caches, logits and every cache leaf within
  ``REL`` = 1e-5 of one process (relative to the largest magnitude).
* The layer (``moe_apply`` on a placed input of 4 × 8 tokens, T over
  ``model`` too in the ``seq`` case) at capacity factors 0.25 (C = 8:
  entries dropped, and the drop count is checked above 0), 1.05 (C = 17,
  which 2 data ranks do not divide) and the config's 1.25 (C = 20):
  within ``REL`` of one process, every rank's keep mask the one-process
  mask, the output placed like its input; rank 0's expert products at
  most ``6·E·ceil(C/d)·D·(Fe/m)`` FLOPs (``OpCosts``: no rank computes
  another's capacity rows or ``Fe`` columns); and the gathered output
  within ``REL`` of the reference's ``moe_apply`` on the same inputs.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _moe_workers import (ARCHS, KV, LAYER_CASES, layer_config,  # noqa: E402
                          layer_input, layer_params)
from _sharding_workers import spawn_mesh  # noqa: E402

REL = 1e-5
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
CASES = list(LAYER_CASES)


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    return request.param, spawn_mesh(request.param, kind="moe_serve")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drip_matches_one_process(ranks, arch):
    shape, res = ranks
    dr = res[arch]["drip"]
    for kv in KV:
        assert dr[f"{kv}/logits"] <= REL, (shape, arch, kv, dr)
        assert dr[f"{kv}/cache"] <= REL, (shape, arch, kv, dr)
    shared = arch == "qwen2-moe-a2.7b"
    assert dr["shared_compiled"] == (3 if shared else 0), dr
    # wg, wu (64 x 32) and wd (32 x 64) hold 4 blocks each, so a leaf
    # matches both patterns; both partition 2 ways, wd's not 4 ways
    assert dr["pattern_sharded"] == (3 if shared and shape[1] == 2 else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_serve_steps_match_one_process(ranks, arch):
    """``make_prefill_step`` and ``make_serve_step``, as the dry-run calls
    them, on the seed-0 tree."""
    shape, res = ranks
    st = res[arch]["steps"]
    assert st["prefill"] <= REL and st["serve"] <= REL, (shape, arch, st)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_drops_what_one_process_drops(ranks, arch, case):
    shape, res = ranks
    c = res[arch][case]
    assert c["rel"] <= REL, (shape, arch, case, c["rel"])
    assert c["keep_equal"] and c["routings"] == 2, c
    assert c["C"] == {"drop": 8, "ragged": 17}.get(case, 20)
    assert (c["drops"] > 0) if case == "drop" else True, c
    # the output placed as its input: B over data, T over model in "seq"
    assert c["placements"] == ["S(0)", "S(1)" if LAYER_CASES[case][3]
                               else "R"], c["placements"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_work_per_rank(ranks, arch, case):
    """Each rank's routed products cover its capacity rows of every expert
    on its ``Fe`` columns only."""
    shape, res = ranks
    c = res[arch][case]
    assert (c["d"], c["m"]) == shape
    assert 0 < c["bmm_flops"] <= c["bmm_bound"], c
    # every rank runs ceil(C / d) rows of each expert (the last rank's
    # padded), so the ranks' sum exceeds one process's by the padding only
    pad = -c["C"] % c["d"]
    assert c["bmm_flops"] * shape[0] * shape[1] == \
        c["bmm_one_process"] * (c["C"] + pad) // c["C"], c


@functools.cache
def _reference(arch: str, case: str):
    """The reference's ``moe_apply`` on layer 0's seed-0 parameters and the
    case's input (numpy), once for all the meshes."""
    import jax.numpy as jnp
    from repro.models import blocks as jb
    from repro.models.config import ArchConfig as JCfg

    from repro_torch.tree import tree_map

    cf, B, T, _ = LAYER_CASES[case]
    cfg = layer_config(arch, cf)
    jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), layer_params(cfg))
    return np.asarray(jb.moe_apply(jp, jcfg, jnp.asarray(
        layer_input(cfg, B, T))))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(ranks, arch, case):
    _, res = ranks
    want = _reference(arch, case)
    got = res[arch][case]["y"]
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= REL * float(np.abs(want).max())
