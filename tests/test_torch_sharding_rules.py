"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), leaf by leaf, on the stub meshes
(16, 16) ``(data, model)``, (2, 16, 16) ``(pod, data, model)`` and (4, 2).

* ``param_specs`` (raw and sanitised, FSDP on and off) and the ZeRO
  moments' specs of all ten configs at reduced size, raw, and compiled
  under the int4x2 serving rules and under the family map (the same
  weights in both packages, carried across as numpy; the SSM family is not
  compiled by either), with the pattern side-table;
* ``batch_specs``, ``cache_specs`` (the float tree, batch 0, 1 and 128) and
  ``sanitize_specs``; the port's int4 / int4x2 cache leaves take the spec
  of their ``k`` / ``v`` (codes) or it less the head dim (scales);
* ``schedule_shardable`` / ``_pattern_tail`` on uniform and lopsided
  patterns, ``shard_info`` and ``legacy_tp`` of every family, and
  ``placements``' map from a spec to DTensor placements.

A spec is a tuple in the port and a ``PartitionSpec`` in the reference;
``tuple(P)`` is compared.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, reduced_config as j_reduced  # noqa: E402
from repro.core import compile_sparse as jc  # noqa: E402
from repro.core import payload_registry as jreg  # noqa: E402
from repro.core.sparsity import pattern_from_bitmap as j_pfb  # noqa: E402
from repro.core.sparsity import shared_pattern as j_shared  # noqa: E402
from repro.launch import sharding as js  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import payload_registry as treg  # noqa: E402
from repro_torch.core.sparsity import pattern_from_bitmap as t_pfb  # noqa: E402
from repro_torch.core.sparsity import shared_pattern as t_shared  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as ts  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402


class FakeMesh:
    """Axis-name / size stub, as the reference's tests build it."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = {"16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model")),
          "4x2": FakeMesh((4, 2), ("data", "model"))}
SERVE = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
         "wg": "sparse", "wu": "sparse", "wd": "sparse"}
FAMILY_MAP = {"wq": "perchannel", "wo": "perchannel", "wk": "bfp8",
              "wv": "bfp8", "wg": "actsparse", "wu": "actsparse",
              "wd": "actsparse"}
COMPILES = {"int4x2": (dict(quant_bits=4), SERVE),
            "family_map": (dict(quant_bits=8, act_threshold=0.05),
                           FAMILY_MAP)}
COMPILED = [a for a in ARCH_IDS if j_reduced(a).family != "ssm"]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif tree is not None:
        yield path, tree


def _assert_specs_equal(port, ref):
    fp, fr = dict(_flat(port)), dict(_flat(ref))
    assert sorted(fp) == sorted(fr)
    for path, spec in fr.items():
        assert fp[path] == tuple(spec), (path, fp[path], spec)


def _both_specs(tp, jp, tcfg, jcfg, tpat=None, jpat=None):
    for mesh in MESHES.values():
        for fsdp in (True, False):
            t = ts.param_specs(tp, tcfg, mesh, fsdp=fsdp, patterns=tpat)
            j = js.param_specs(jp, jcfg, mesh, fsdp=fsdp, patterns=jpat)
            _assert_specs_equal(t, j)
            _assert_specs_equal(ts.sanitize_specs(t, tp, mesh),
                                js.sanitize_specs(j, jp, mesh))
        tz = ts.param_specs(tp, tcfg, mesh, zero=True, patterns=tpat)
        jz = js.param_specs(jp, jcfg, mesh, zero=True, patterns=jpat)
        _assert_specs_equal(ts.opt_state_specs(None, tz),
                            js.opt_state_specs(None, jz))
        _assert_specs_equal(
            ts.opt_specs(tp, tcfg, mesh, tpat),
            js.opt_state_specs(None, js.sanitize_specs(jz, jp, mesh)))


@pytest.fixture(scope="module")
def raw():
    out = {}
    for arch in ARCH_IDS:
        jcfg, tcfg = j_reduced(arch), t_reduced(arch)
        jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, tcfg, jp, interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_reference(raw, arch):
    jcfg, tcfg, jp, tp = raw[arch]
    _both_specs(tp, jp, tcfg, jcfg)
    # the port's own init draws another tree of the same shapes
    own = tm.init_params(tcfg, device="cpu")
    for mesh in MESHES.values():
        _assert_specs_equal(ts.param_specs(own, tcfg, mesh),
                            js.param_specs(jp, jcfg, mesh))


def _leaf_names(tree):
    return {k for path, _ in _flat(tree) for k in path}


@pytest.mark.parametrize("rules", list(COMPILES))
@pytest.mark.parametrize("arch", COMPILED)
def test_compiled_specs_equal_reference(raw, arch, rules):
    jcfg, tcfg, jp, tp = raw[arch]
    kw, pols = COMPILES[rules]
    names = _leaf_names(tp)
    pols = {k: v for k, v in pols.items() if k in names}
    kw = dict(block=(16, 16), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, policies=pols, **kw)
    jcm = jc.compile_model(jp, jcfg, rules=jc.CompileRules(**kw))
    tcm = tc.compile_model(tp, tcfg, rules=tc.CompileRules(**kw),
                           device="cpu")
    assert sorted(jcm.patterns) == sorted(tcm.patterns)
    _both_specs(tcm.params, jcm.params, tcfg, jcfg, tcm.patterns,
                jcm.patterns)
    # the blind legacy rule when no side-table is given
    for mesh in MESHES.values():
        _assert_specs_equal(ts.param_specs(tcm.params, tcfg, mesh),
                            js.param_specs(jcm.params, jcfg, mesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    for mesh in MESHES.values():
        _assert_specs_equal(ts.batch_specs(tcfg, mesh),
                            js.batch_specs(jcfg, mesh))
        if not tcfg.supports_decode:
            continue
        for batch in (0, 1, 128):
            _assert_specs_equal(ts.cache_specs(tcfg, mesh, batch=batch),
                                js.cache_specs(jcfg, mesh, batch=batch))


@pytest.mark.parametrize("kv", ["float", "int4", "int4x2"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b",
                                  "olmoe-1b-7b"])
def test_quantised_cache_specs_cover_the_port_cache(arch, kv):
    """Every leaf of the port's cache gets a spec of its rank; codes share
    their k / v spec and scales drop its head-dim entry, so both shard on
    the same head or sequence axis."""
    cfg = t_reduced(arch)
    cache = tm.init_cache(cfg, 4, 32, kv, device="meta")
    for mesh in MESHES.values():
        for batch in (0, 1):
            specs = ts.cache_specs(cfg, mesh, batch=batch, kv_cache=kv)
            fl, fs = dict(_flat(cache)), dict(_flat(specs))
            assert sorted(fl) == sorted(fs)
            for path, leaf in fl.items():
                assert len(fs[path]) == leaf.ndim, (path, fs[path])
            kvtree = specs.get("attn", specs)
            kspec = ts.cache_specs(cfg, mesh, batch=batch)
            kspec = kspec.get("attn", kspec)["k"]
            for name, spec in kvtree.items():
                if name == "length":
                    continue
                want = kspec[:-1] if name in ("k_s", "v_s") else kspec
                assert spec == want, (name, spec, want)
            sane = dict(_flat(ts.sanitize_specs(specs, cache, mesh)))
            for path, leaf in fl.items():
                for dim, ax in zip(leaf.shape, sane[path]):
                    assert ax is None or dim % tmesh.mesh_size(mesh, ax) == 0


def test_schedule_shardable_and_pattern_tail_match_reference():
    bm_lop = np.zeros((8, 8), bool)
    bm_lop[0] = True
    bm_two = np.zeros((8, 8), bool)
    bm_two[::2, :4] = True            # even rows: shards by 2 and 4
    cases = [
        (t_shared(256, 256, (32, 32), 0.5), j_shared(256, 256, (32, 32), 0.5)),
        (t_shared(256, 512, (32, 32), 0.5), j_shared(256, 512, (32, 32), 0.5)),
        (t_pfb((256, 256), (32, 32), bm_lop),
         j_pfb((256, 256), (32, 32), bm_lop)),
        (t_pfb((256, 256), (32, 32), bm_two),
         j_pfb((256, 256), (32, 32), bm_two)),
        (t_pfb((256, 256), (32, 32), np.zeros((8, 8), bool)),
         j_pfb((256, 256), (32, 32), np.zeros((8, 8), bool))),
    ]
    seen = set()
    for tp, jp in cases:
        for n in (1, 2, 3, 4, 8, 16):
            got = ts.schedule_shardable(tp, n)
            assert got == js.schedule_shardable(jp, n), (tp.shape, n)
            seen.add(got)
        P, (bk, bn) = tp.n_blocks_present, tp.block
        for packed in (False, True):
            shape = (3, P, bk // 2 if packed else bk, bn)
            for n in (1, 2, 4):
                assert ts._pattern_tail(shape, {tp.shape: tp}, n, packed) \
                    == tuple(js._pattern_tail(shape, {jp.shape: jp}, n,
                                              packed))
    assert seen == {True, False}
    assert not ts.schedule_shardable(cases[2][0], 2)
    assert ts.schedule_shardable(cases[3][0], 4)


def test_shard_info_and_legacy_tp_match_reference_for_every_family():
    tf = {f.name: f for f in treg.all_families()}
    jf = {f.name: f for f in jreg.all_families()}
    assert list(tf) == list(jf)
    for name, f in jf.items():
        assert dict(tf[name].shard_tails) == dict(f.shard_tails), name
        assert tf[name].legacy_tp == f.legacy_tp, name
        for leaf in f.leaf_names:
            assert treg.shard_info(leaf) == jreg.shard_info(leaf), leaf
    assert ts._family_tp_rules() == [(k, tuple(s)) for k, s in
                                      js._family_tp_rules()]


def test_tp_rules_and_fsdp_extend_match_reference():
    for pstr in ("blocks/attn/wq/w", "blocks/attn/wo/w", "blocks/mlp/wd/w",
                 "embed/w", "final_norm/g", "blocks/slstm/wx/w", "head/w",
                 "blocks/moe/eg/w", "blocks/mlp/wg/w_blkp",
                 "blocks/mlp/wg/w_atau", "blocks/attn/wo/w_s"):
        for ndim in (0, 1, 2, 3, 4):
            assert ts._tp_spec(pstr, ndim) == tuple(js._tp_spec(pstr, ndim)), \
                (pstr, ndim)
    for spec, shape, dp, n in (((None, "model"), (4096, 4096), ("data",), 16),
                               ((None, None), (10, 6), ("data",), 16),
                               ((None, "model"), (1000, 4096), ("data",), 16),
                               ((None, None, None), (2, 64, 128),
                                ("pod", "data"), 32)):
        assert ts._fsdp_extend(spec, shape, dp, n) == \
            tuple(js._fsdp_extend(spec, shape, dp, n))


def test_placements_map_specs_to_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    m2, m3 = MESHES["16x16"], MESHES["2x16x16"]
    assert ts.placements(("data", "model"), m2) == [Shard(0), Shard(1)]
    assert ts.placements((None, "model"), m2) == [Replicate(), Shard(1)]
    assert ts.placements((None, None), m2) == [Replicate(), Replicate()]
    assert ts.placements((("pod", "data"), None, "model"), m3) == \
        [Shard(0), Shard(0), Shard(2)]
    assert ts.placements(("model", None), FakeMesh((4,), ("data",))) == \
        [Replicate()]                  # an axis the mesh lacks
    with pytest.raises(ValueError, match="axis order"):
        ts.placements((("data", "pod"), None), m3)
    with pytest.raises(ValueError, match="twice"):
        ts.placements(("model", "model"), m2)
    assert tmesh.data_axes(m3) == ("pod", "data")
    assert tmesh.mesh_size(m3, ("pod", "data")) == 32
    assert tmesh.mesh_size(((4, 2), ("data", "model")), "model") == 2
