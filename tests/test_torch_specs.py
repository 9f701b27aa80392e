"""The port's meta-device specs (``repro_torch.launch.specs``) and the
dry-run's per-rank bytes and variants (``repro_torch.launch.dryrun``)
against the reference's (``repro.launch.specs`` / ``repro.launch.dryrun``).

* ``input_specs``, ``param_shapes``, ``opt_shapes`` and ``cache_shapes``
  of all ten configs at full size, for every applicable shape, equal the
  reference's ``jax.eval_shape`` trees leaf by leaf (shape and dtype), and
  every leaf is a meta tensor (nothing allocated);
* the per-rank bytes of parameters, moments, batch and cache that the
  dry-run reads from the local shards at (16, 16) and (2, 16, 16) — under
  the fake process group, in a process of its own — equal exactly a
  reckoning from the reference's ``param_specs`` / ``batch_specs`` /
  ``cache_specs`` / ``sanitize_specs`` on the stub meshes of
  ``tests/test_sharding.py``;
* ``apply_variant`` gives the reference's config, microbatch override
  and flags for every token.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS, get_config as j_config  # noqa: E402
from repro.launch import sharding as js  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.config import SHAPES as J_SHAPES  # noqa: E402
from repro.train.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.launch import dryrun as td  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models.config import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig as TAdamW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its import-time side
    effect: it sets ``XLA_FLAGS`` to force 512 host devices, which would
    reach every later JAX test of this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun
_DT = {torch.float32: "float32", torch.bfloat16: "bfloat16",
       torch.int32: "int32", torch.int8: "int8", torch.uint8: "uint8"}


class FakeMesh:
    """Axis-name/size stub (``tests/test_sharding.py``'s)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = {False: FakeMesh((16, 16), ("data", "model")),
          True: FakeMesh((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    return {} if tree is None else {path: tree}


def _same(ttree, jtree, what):
    t, j = _flat(ttree), _flat(jtree)
    assert sorted(t) == sorted(j), (what, sorted(set(t) ^ set(j)))
    for k in j:
        assert t[k].device.type == "meta", (what, k)
        assert tuple(t[k].shape) == tuple(j[k].shape), (what, k)
        assert _DT[t[k].dtype] == np.dtype(j[k].dtype).name, (what, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_trees(arch):
    jcfg, tcfg = j_config(arch), t_config(arch)
    jp, tp = jspecs.param_shapes(jcfg), tspecs.param_shapes(tcfg)
    _same(tp, jp, "params")
    dt = jcfg.opt_state_dtype
    _same(tspecs.opt_shapes(tcfg, tp, TAdamW(state_dtype=dt)),
          jspecs.opt_shapes(jcfg, jp, JAdamW(state_dtype=dt)), "opt")
    shapes = [s.name for s in tcfg.applicable_shapes()]
    assert shapes == [s.name for s in jcfg.applicable_shapes()]
    for name in shapes:
        js_, ts_ = J_SHAPES[name], T_SHAPES[name]
        _same(tspecs.input_specs(tcfg, ts_), jspecs.input_specs(jcfg, js_),
              f"inputs {name}")
        if ts_.kind == "decode":
            _same(tspecs.cache_shapes(tcfg, ts_),
                  jspecs.cache_shapes(jcfg, js_), f"cache {name}")


def _axis(mesh, ax) -> int:
    if ax is None:
        return 1
    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
    names = mesh.axis_names
    return math.prod(mesh.devices.shape[names.index(a)] for a in axes)


def _reckon(shape_tree, spec_tree, mesh) -> int:
    """Bytes of one rank's shards: each leaf's size over the ranks of the
    axes its (reference) spec names."""
    shapes = _flat(shape_tree)
    specs = _flat(spec_tree)
    total = 0
    for k, leaf in shapes.items():
        spec = specs.get(k, P())
        n = math.prod(_axis(mesh, ax) for ax in tuple(spec))
        size = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        assert size % n == 0, k
        total += size // n
    return total


def _reference_bytes(arch, shape_name, multi_pod):
    cfg = j_config(arch)
    mesh = MESHES[multi_pod]
    shape = J_SHAPES[shape_name]
    pshapes = jspecs.param_shapes(cfg)
    pspecs = js.sanitize_specs(js.param_specs(pshapes, cfg, mesh, fsdp=True),
                               pshapes, mesh)
    out = {"params": _reckon(pshapes, pspecs, mesh), "opt": 0, "cache": 0}
    binputs = jspecs.input_specs(cfg, shape)
    bspecs = js.sanitize_specs(
        {k: v for k, v in js.batch_specs(cfg, mesh).items() if k in binputs},
        binputs, mesh)
    if shape.kind == "train":
        oshapes = jspecs.opt_shapes(cfg, pshapes,
                                    JAdamW(state_dtype=cfg.opt_state_dtype))
        out["opt"] = _reckon(oshapes, {"m": pspecs, "v": pspecs,
                                       "step": P()}, mesh)
    if shape.kind == "decode":
        cshapes = jspecs.cache_shapes(cfg, shape)
        cspecs = js.sanitize_specs(
            js.cache_specs(cfg, mesh, batch=shape.global_batch), cshapes,
            mesh)
        out["cache"] = _reckon(cshapes, cspecs, mesh)
        dp = js.data_axes(mesh)
        dp_size = math.prod(_axis(mesh, a) for a in dp)
        tok = P(dp if len(dp) > 1 else dp[0], None)
        if shape.global_batch % dp_size:
            tok = P(None, None)
        bspecs = {"tokens": tok}
    out["batch"] = _reckon(binputs, bspecs, mesh)
    return out


# every config's applicable cells, both meshes, placed under the fake
# group in a process of its own (the group is process-global)
_PLACE = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as d
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES
out = {}
for mp in (False, True):
    with d.fake_group(512 if mp else 256):
        mesh = make_production_mesh(multi_pod=mp, device="cpu")
        for a in ARCH_IDS:
            cfg = get_config(a)
            for s in cfg.applicable_shapes():
                _, b = d.place_cell(cfg, s, mesh)
                out[f"{a}|{s.name}|{int(mp)}"] = b
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_bytes():
    res = subprocess.run([sys.executable, "-c", _PLACE], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_bytes_equal_the_reference_reckoning(port_bytes, arch,
                                                      multi_pod):
    for s in j_config(arch).applicable_shapes():
        got = port_bytes[f"{arch}|{s.name}|{int(multi_pod)}"]
        assert got == _reference_bytes(arch, s.name, multi_pod), \
            (arch, s.name)


VARIANTS = ["baseline", "", "int8", "gsparse", "gsparse25", "gsparseint8",
            "gsparseint840", "sparse", "sparse30", "sparseint8",
            "sparseint860", "seqshard", "noremat", "nofsdp", "nmicro4",
            "int8+seqshard+nmicro2", "sparse25+noremat+nofsdp"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_variant_matches_the_reference(variant):
    jd = _reference_dryrun()
    for arch in ("llama3.2-1b", "olmoe-1b-7b"):
        jcfg, jn, jflags = jd.apply_variant(j_config(arch), variant)
        tcfg, tn, tflags = td.apply_variant(t_config(arch), variant)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
                (variant, f.name)
        assert (tn, tflags) == (jn, jflags)


def test_apply_variant_refuses_an_unknown_token():
    for fn, cfg in ((_reference_dryrun().apply_variant,
                     j_config("llama3.2-1b")),
                    (td.apply_variant, t_config("llama3.2-1b"))):
        with pytest.raises(ValueError, match="unknown variant token"):
            fn(cfg, "int8+fp4")
