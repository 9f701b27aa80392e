"""The port's architecture registry, ``SHAPES``, parameter counts and LM
layer IR vs the JAX reference.

Configs, shapes, counts and layer specs are plain Python data and
arithmetic in both packages, so they must be EQUAL; ``run_dse`` on the
specs too (the same float arithmetic in the same order).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import lm_ir as jlm  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import dse as tdse  # noqa: E402
from repro_torch.core import lm_ir as tlm  # noqa: E402
from repro_torch.models import config as tmc  # noqa: E402

DENSE = ["llama3-405b", "qwen1.5-4b", "starcoder2-7b", "llama3.2-1b"]
# the encoder, MoE, SSM, hybrid and VLM configs (ported beside the dense ones)
NEW = ["hubert-xlarge", "qwen2-moe-a2.7b", "olmoe-1b-7b", "xlstm-1.3b",
       "zamba2-2.7b", "phi-3-vision-4.2b"]
PORTED = DENSE + NEW
# the budget of tests/test_lm_ir.py's DSE case
BUDGET = 12 * 2 ** 30


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _port_fields_of(jcfg, tcfg):
    return {k: getattr(jcfg, k) for k in _fields(tcfg)}


def test_registry_is_the_references_dense_entries_in_order():
    """The reference's registry, all ten entries in its order."""
    assert tconfigs.ARCH_IDS == PORTED
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(tconfigs.ARCH_IDS) == 10
    assert tconfigs.SHAPES is tmc.SHAPES and tconfigs.ShapeSpec is tmc.ShapeSpec
    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        assert tconfigs.get_config(arch).family in ("ssm", "hybrid")
    with pytest.raises(KeyError, match="the port has"):
        tconfigs.get_config("mamba-7b")


@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference_field_by_field(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert _fields(tcfg) == _port_fields_of(jcfg, tcfg)
    module = tconfigs._MODULES[arch]
    assert module == jconfigs._MODULES[arch]
    assert tconfigs.get_config(module) is tcfg
    jr, tr = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    assert _fields(tr) == _port_fields_of(jr, tr)


def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tmc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jmc.SHAPES.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_shapes_and_parameter_counts_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert [s.name for s in tcfg.applicable_shapes()] == \
        [s.name for s in jcfg.applicable_shapes()]
    assert tcfg.supports_decode == jcfg.supports_decode
    assert tcfg.subquadratic == jcfg.subquadratic
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    jr, tr = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    assert tr.param_count() == jr.param_count()


@pytest.mark.parametrize("family", ["encoder", "vlm"])
def test_encoder_and_vlm_counts_and_shapes_equal_reference(family):
    """The encoder and VLM branches on the dense fields."""
    kw = dict(name="t", family=family, n_layers=3, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=96, vocab=50, act="gelu")
    jcfg, tcfg = jmc.ArchConfig(**kw), tmc.ArchConfig(**kw)
    assert [s.name for s in tcfg.applicable_shapes()] == \
        [s.name for s in jcfg.applicable_shapes()]
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for shape in jcfg.applicable_shapes():
        assert [dataclasses.asdict(s) for s in tlm.lm_layer_specs(
            tcfg, shape)] == \
            [dataclasses.asdict(s) for s in jlm.lm_layer_specs(jcfg, shape)]


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_unported_families_raise_naming_item_8(family):
    """The MoE, SSM and hybrid branches (the last two once refused):
    counts and layer specs as the reference's, on configs of their own
    fields."""
    kw = dict(name="t", family=family, n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=64)
    cfg = tmc.ArchConfig(**kw)
    assert cfg.subquadratic == (family != "moe")
    if family == "moe":
        kw.update(n_experts=6, top_k=2, d_expert=24, n_shared_experts=1)
    elif family == "ssm":
        kw.update(n_layers=4, ssm_variant="mlstm", slstm_every=2, d_ff=0)
    else:
        kw.update(n_layers=6, ssm_variant="mamba2", ssm_state=16,
                  attn_every=3)
    cfg, jcfg = tmc.ArchConfig(**kw), jmc.ArchConfig(**kw)
    if family != "moe":
        assert cfg.d_inner == jcfg.d_inner == 2 * cfg.d_model
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if family == "moe":
        assert cfg.active_param_count() < cfg.param_count()
    for shape in ("train_4k", "long_500k"):
        assert [dataclasses.asdict(s) for s in tlm.lm_layer_specs(
            cfg, tmc.SHAPES[shape])] == \
            [dataclasses.asdict(s) for s in jlm.lm_layer_specs(
                jcfg, jmc.SHAPES[shape])]


CELLS = [(arch, s.name) for arch in PORTED
         for s in jconfigs.get_config(arch).applicable_shapes()]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_lm_layer_specs_and_dse_equal_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js = jlm.lm_layer_specs(jcfg, jmc.SHAPES[shape])
    ts = tlm.lm_layer_specs(tcfg, tmc.SHAPES[shape])
    assert [dataclasses.asdict(s) for s in ts] == \
        [dataclasses.asdict(s) for s in js]
    L = tcfg.n_layers
    # attention + MLP a layer; one SSM spec a layer; the hybrid's shared
    # attention + MLP every attn_every layers, Mamba2 the others
    n = {"ssm": L, "hybrid": L + L // max(tcfg.attn_every, 1)}.get(
        tcfg.family, 2 * L)
    assert len(ts) == n + 1 and not ts[-1].prunable
    jr = jdse.run_dse(js, resource_budget=BUDGET)
    tr = tdse.run_dse(ts, resource_budget=BUDGET)
    assert tr.sparse_layers == jr.sparse_layers
    assert [dataclasses.asdict(c) for c in tr.configs] == \
        [dataclasses.asdict(c) for c in jr.configs]
    assert tr.trace == jr.trace
    assert dataclasses.asdict(tr.estimate) == dataclasses.asdict(jr.estimate)
    assert dataclasses.asdict(tr.baseline) == dataclasses.asdict(jr.baseline)


def test_core_exports_lm_layer_specs_beside_run_dse():
    from repro_torch import core
    assert core.lm_layer_specs is tlm.lm_layer_specs
    assert core.run_dse is tdse.run_dse
