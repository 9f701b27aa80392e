"""The port's autotuner (``repro_torch.core.autotune``) against the
reference's ``repro.core.autotune`` on the same numpy inputs.

Keys, the bit-width re-ranking (``tuned_policy``), the DSE retune move and
``policy="autotune"`` compiles must be the reference's exactly; the
route-plan candidates must each pass the kernels' own plan checks; on the
CPU the only candidate is the plain version, so a tuned engine serves the
untuned engine's tokens.
"""
import dataclasses
import itertools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as ja  # noqa: E402
from repro.core import compile_sparse as jc  # noqa: E402
from repro.core import cost_model as jcm_  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import payload_registry as jreg  # noqa: E402
from repro.core.sparsity import shared_pattern as j_shared  # noqa: E402
from repro.models import lenet as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models.config import ArchConfig as JCfg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import autotune as ta  # noqa: E402
from repro_torch.core import compile_sparse as tc  # noqa: E402
from repro_torch.core import cost_model as tcm_  # noqa: E402
from repro_torch.core import dispatch as td  # noqa: E402
from repro_torch.core import dse as tdse  # noqa: E402
from repro_torch.core import payload_registry as treg  # noqa: E402
from repro_torch.core.sparsity import shared_pattern as t_shared  # noqa: E402
from repro_torch.kernels import check_plan  # noqa: E402
from repro_torch.kernels.flash_attention import decode_packed as tdp  # noqa: E402
from repro_torch.kernels.quant_matmul import kernel as tqk  # noqa: E402
from repro_torch.kernels.sparse_matmul import kernel as tsk  # noqa: E402
from repro_torch.models import lenet as tl  # noqa: E402
from repro_torch.models.config import ArchConfig as TCfg  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

CFG = dict(name="tune", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128, vocab=96,
           param_dtype="float32", tie_embeddings=True)
SERVE_POLICIES = {"wq": "quant", "wk": "quant", "wv": "quant", "wo": "quant",
                  "wg": "sparse", "wu": "sparse", "wd": "sparse"}
FAST = ta.TuneOptions(iters=2, warmup=1, max_measured=2)
HWS = {"tpu_v5e": (jcm_.TPU_V5E, tcm_.TPU_V5E),
       "h100_sxm": (jcm_.HWSpec(**dataclasses.asdict(tcm_.H100_SXM)),
                    tcm_.H100_SXM)}
LENET_BLOCKS = {"fc1": (8, 4), "fc2": (8, 4), "fc3": (4, 2), "conv1": (5, 2),
                "conv2": (10, 4)}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JCfg(**CFG), TCfg(**CFG)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, tp


def _serve_compile(models, bits=4, block=(32, 32)):
    jcfg, tcfg, jp, tp = models
    kw = dict(block=block, block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, quant_bits=bits, policies=SERVE_POLICIES)
    return (jc.compile_model(jp, jcfg, rules=jc.CompileRules(**kw)),
            tc.compile_model(tp, tcfg, rules=tc.CompileRules(**kw),
                             device="cpu"))


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv(ta.AUTOTUNE_CACHE_ENV, str(tmp_path / "tuned.json"))
    monkeypatch.delenv(td.DISPATCH_ENV, raising=False)


# -------------------------------------------------------------------- keys


KEY_CASES = {
    "dense": dict(kind="quant", M=8, K=2048, N=512),
    "sparse": dict(kind="sparse", M=3, K=64, N=128, pattern=(0.5,)),
    "int4x2": dict(kind="quant", M=512, K=256, N=128, container="int4x2"),
    "int2x4": dict(kind="sparse", M=16, K=64, N=128, pattern=(0.25,),
                   container="int2x4"),
    "conv": dict(kind="conv_sparse", M=1152, K=150, N=16, pattern=(0.5,)),
    "leaf": dict(kind="quant", M=9000, K=64, N=64, leaf="blocks/attn/wq"),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["cpu", "cuda:NVIDIA H100 80GB HBM3"])
def test_keys_are_the_references(case, dtype, backend):
    kw = dict(KEY_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if "pattern" in kw:
        (density,) = kw.pop("pattern")
        block = (10, 4) if kw["K"] == 150 else (32, 32)
        jkw["pattern"] = j_shared(kw["K"], kw["N"], block, density)
        tkw["pattern"] = t_shared(kw["K"], kw["N"], block, density)
        assert ta.schedule_hash(tkw["pattern"]) == \
            ja.schedule_hash(jkw["pattern"])
    jkey = ja.tune_key(dtype=getattr(jnp, dtype), backend=backend, **jkw)
    tkey = ta.tune_key(dtype=getattr(torch, dtype), backend=backend, **tkw)
    assert tkey == jkey
    assert ta.bucket_m(kw["M"]) == ja.bucket_m(kw["M"])


@pytest.mark.parametrize("M", [0, 1, 3, 8, 9, 16, 512, 513, 8192, 10 ** 6])
def test_bucket_m_is_the_references(M):
    assert ta.bucket_m(M) == ja.bucket_m(M)


def test_conv_and_per_leaf_keys_never_collide():
    pat = t_shared(64, 128, (32, 32), 0.5)
    kw = dict(M=4, K=64, N=128, dtype=torch.float32, backend="cpu")
    base = ta.tune_key(kind="sparse", pattern=pat, **kw)
    conv = ta.tune_key(kind="conv_sparse", pattern=pat, **kw)
    fused = ta.tune_key(kind="fusedconv_sparse", pattern=pat, **kw)
    leafed = ta.tune_key(kind="sparse", pattern=pat, leaf="conv1", **kw)
    assert len({base, conv, fused, leafed}) == 4
    assert leafed.startswith(base + ":leaf=")
    assert ta.tune_key(kind="conv_quant", **kw) != \
        ta.tune_key(kind="quant", **kw)
    # a CPU timing never serves a card lookup, nor one card another
    assert len({ta.tune_key(kind="quant", M=4, K=64, N=128,
                            dtype=torch.float32, backend=b)
                for b in ("cpu", "cuda:A", "cuda:B")}) == 3
    assert ta.backend_tag("cpu") == "cpu"


def test_registry_hooks_are_the_references():
    assert treg.tunable_kinds() == jreg.tunable_kinds()
    for kind in treg.tunable_kinds():
        assert treg.kind_family(kind).name == jreg.kind_family(kind).name
        assert treg.kind_needs_pattern(kind) == jreg.kind_needs_pattern(kind)
    stacked = {"w_qp": torch.zeros((3, 4, 8), dtype=torch.uint8),
               "w_s": torch.ones((3, 8)), "b": torch.zeros(8)}
    rep = treg.representative_leaves(stacked)
    assert sorted(rep) == ["w_qp", "w_s"] and rep["w_qp"].shape == (4, 8)


# ----------------------------------------------------------- table + cache


def test_table_round_trip(tmp_path):
    path = str(tmp_path / "t.json")
    t = ta.TunedTable()
    t.put("a", ta.TunedConfig(use_kernel=True, route="thin_m",
                              plan=(128, 18, 60), measured_us=8.5,
                              predicted_us=1.0))
    t.put("b", ta.TunedConfig(use_kernel=True, route="split", bt=32))
    t.put("c", ta.TunedConfig(use_kernel=False, measured_us=3.0))
    t.put("d", ta.TunedConfig(use_kernel=True, route="tiled"))
    t.save(path)
    back = ta.TunedTable.load(path)
    assert back.entries == t.entries
    assert ta.load_table(path).entries == t.entries


GARBAGE = [
    "",
    "{not json",
    '{"version": 99, "entries": {}}',
    '{"version": 1, "entries": {"k": {"use_kernel": 1}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true, "route": "fast"}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true, "route": "thin_m",'
    ' "plan": [128, 4]}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true, "route": '
    '"tensor_core", "plan": [64, 128, 0, 8]}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true, "route": "thin_m",'
    ' "plan": [128, -1, 60]}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true, "route": "tiled",'
    ' "plan": [1]}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true, "route": "split",'
    ' "bt": 48}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": false, "route": '
    '"tiled"}}}',
    '{"version": 1, "entries": {"k": {"use_kernel": true}}}',
]


@pytest.mark.parametrize("garbage", GARBAGE)
def test_corrupted_cache_is_empty_not_crash(tmp_path, models, garbage):
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        f.write(garbage)
    assert len(ta.TunedTable.load(path)) == 0
    # and the tuner retunes straight through it
    _, tcm = _serve_compile(models)
    table = ta.autotune_model(tcm, M=2, options=FAST, path=path)
    assert len(table) > 0 and table.n_timings() > 0


def test_second_run_hits_cache_zero_retiming(tmp_path, models):
    path = str(tmp_path / "cache.json")
    _, tcm = _serve_compile(models)
    t1 = ta.autotune_model(tcm, M=(2, 32), options=FAST, path=path)
    assert t1.n_timings() > 0
    t2 = ta.autotune_model(tcm, M=(2, 32), options=FAST, path=path)
    assert t2.n_timings() == 0
    assert t1.entries == t2.entries
    t3 = ta.autotune_model(tcm, M=8, options=FAST, path=path)
    assert t3.n_timings() > 0


def test_cpu_table_holds_plain_entries_on_the_references_keys(models):
    """On the CPU the plain version is the only candidate: every entry is
    ``use_kernel=False`` on a ``cpu`` key, and the keys are the ones the
    reference's tuner writes for the same compile (packed containers
    tagged)."""
    jcm, tcm = _serve_compile(models)
    table = ta.autotune_model(tcm, M=(1, 64), options=FAST, save=False)
    jt = ja.autotune_model(jcm, M=(1, 64), options=ja.TuneOptions(
        iters=1, warmup=1, max_measured=1), save=False,
        path="/nonexistent/t.json")
    assert sorted(table.entries) == sorted(jt.entries)
    assert any(":container=int4x2" in k for k in table.entries)
    for key, e in table.entries.items():
        assert ":cpu:" in key and not e.use_kernel and e.route is None
        assert e.measured_us > 0 and e.predicted_us > 0
    for log in table.log:
        assert log["n_timed"] == 1 and log["candidates"][0]["route"] is None


def test_resolve_autotune_loads_the_table(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    t = ta.TunedTable()
    t.put("k", ta.TunedConfig(use_kernel=False, measured_us=1.0))
    t.save(path)
    cfg = td.resolve("autotune")
    assert cfg.mode == "auto" and "k" in cfg.tuned
    monkeypatch.setenv(td.DISPATCH_ENV, "autotune")
    env = td.resolve(None)
    assert env.mode == "auto" and env.tuned is cfg.tuned   # memoised
    monkeypatch.setenv(ta.AUTOTUNE_CACHE_ENV, str(tmp_path / "none.json"))
    empty = td.resolve("autotune")
    assert empty.tuned is not None and len(empty.tuned) == 0
    hash(empty)   # stays hashable
    with pytest.raises(ValueError, match="m_bucket"):
        td.DispatchConfig(m_bucket=0)


def test_cuda_key_entry_naming_the_plain_version_raises():
    """No CUDA tensor is sent to the plain version: an entry with
    ``use_kernel=False`` raises on a CUDA tensor (a CPU one takes it)."""
    entry = ta.TunedConfig(use_kernel=False, measured_us=1.0)
    card = types.SimpleNamespace(is_cuda=True, device="cuda:0")
    with pytest.raises(ValueError, match="blocks/attn/wq.*use_kernel=False"):
        td._kernel_entry(entry, card, "blocks/attn/wq", "quant")
    assert td._kernel_entry(entry, torch.zeros(1), "x", "quant") is None
    kern = ta.TunedConfig(use_kernel=True, route="tiled")
    assert td._kernel_entry(kern, card, "x", "quant") is kern


def test_per_leaf_entry_beats_the_shared_one():
    pat = t_shared(64, 128, (32, 32), 0.5)
    kw = dict(kind="sparse", M=4, K=64, N=128, dtype=torch.float32,
              backend="cpu", pattern=pat)
    t = ta.TunedTable()
    shared = ta.TunedConfig(use_kernel=True, route="tiled", measured_us=1.0)
    mine = ta.TunedConfig(use_kernel=True, route="thin_m", plan=(1, 2, 1))
    t.put(ta.tune_key(**kw), shared)
    t.put(ta.tune_key(leaf="special", **kw), mine)
    cfg = td.DispatchConfig(tuned=t)
    look = dict(kind="sparse", M=4, K=64, N=128, x_dtype=torch.float32,
                device=torch.device("cpu"), pattern=pat)
    assert td._tuned_entry(cfg, leaf="special", **look) is mine
    assert td._tuned_entry(cfg, leaf="other", **look) is shared
    assert td._tuned_entry(cfg, **look) is shared
    pinned = td.DispatchConfig(tuned=t, m_bucket=4)
    assert td._tuned_entry(pinned, **{**look, "M": 3000}) is shared


# -------------------------------------------------------------- candidates


QMM_SHAPES = [(M, K, N, ratio, bf16)
              for M in (1, 8, 16, 17, 128, 512)
              for K, N in ((2048, 2048), (2048, 512), (8192, 2048),
                           (192, 96))
              for ratio in (1, 2, 4) for bf16 in (True, False)]
BSM_SHAPES = [(M, bk, bn, ratio, nC, maxb, bf16, eb)
              for M in (1, 8, 16, 17, 512)
              for bk, bn, nC, maxb in ((128, 128, 64, 8), (128, 128, 16, 13),
                                       (64, 256, 8, 3), (8, 4, 6, 2))
              for ratio in (1, 2) for bf16 in (True, False)
              for eb in (1, 4)]


@pytest.mark.parametrize("shape", QMM_SHAPES[::3] + QMM_SHAPES[1::7])
def test_qmm_candidates_pass_check_plan(shape):
    M, K, N, ratio, bf16 = shape
    cands = tqk.qmm_candidates(M, K, N, ratio, bf16, 256, 256)
    assert cands[0] == tqk.qmm_route(M, K, N, ratio, bf16, 256, 256)
    assert len(set(cands)) == len(cands) and ("tiled", None) in cands
    for route, plan in cands:
        check_plan("quant_matmul", route, plan, (M, K, N, ratio, bf16, 256,
                                                 256))
        if M <= tqk.THIN_M_MAX:
            assert route != "tensor_core"
        if route == "thin_m":   # the pinned decode bucket serves M <= 16
            check_plan("quant_matmul", route, plan, (16, K, N, ratio, bf16,
                                                     256, 256))
    if not bf16 and M > tqk.THIN_M_MAX:
        assert cands == [("tiled", None)]


@pytest.mark.parametrize("shape", BSM_SHAPES[::3])
def test_bsm_candidates_pass_check_plan(shape):
    M, bk, bn, ratio, nC, maxb, bf16, eb = shape
    args = (M, bk, bn, ratio, nC, maxb, bf16, 256, eb, 256)
    cands = tsk.bsm_candidates(*args)
    assert cands[0] == tsk.bsm_route(*args)
    assert len(set(cands)) == len(cands) and ("tiled", None) in cands
    for route, plan in cands:
        check_plan("block_sparse_matmul", route, plan, args)
        if M <= tsk.THIN_M_MAX:
            assert route != "tensor_core"
        if route == "thin_m" and (route, plan) != cands[0]:
            check_plan("block_sparse_matmul", route, plan, (16,) + args[1:])
    # packed codes must be 1-byte; f32 x past 16 rows is the tiled route's
    if (eb != 1 and ratio != 1) or (not bf16 and M > tsk.THIN_M_MAX):
        assert cands == [("tiled", None)]


@pytest.mark.parametrize("C,G,Dh", [(1, 4, 64), (16, 4, 64), (1, 9, 128),
                                    (16, 9, 128), (1, 1, 96), (1, 1, 80),
                                    (16, 1, 96)])
def test_pda_candidates_pass_check_plan(C, G, Dh):
    B, Hkv, T = 8, 4, 512
    H = Hkv * G
    cands = tdp.pda_candidates(B, C, H, Hkv, Dh, T)
    assert [bt for _, bt in cands] == [16, 32, 64, 128]
    rule = "single" if tdp.pda_plan(B, C, H, Hkv, Dh, T, 64) is None \
        else "split"
    assert (rule, 64) in cands
    for route, bt in cands:
        check_plan("packed_decode_attention", route, None,
                   (B, C, H, Hkv, Dh, T, bt, 0, True))
        # every built (Dh, bt) splits, at any C·G (in row groups)
        assert (route == "split") == ((Dh, bt) in tdp.SPLIT_SHAPES)


ILLEGAL = [
    ("quant_matmul", "tensor_core", (64, 128, 1, 32),
     (8, 2048, 2048, 2, True, 0, 0), "M > 16"),
    ("quant_matmul", "tensor_core", (64, 128, 1, 32),
     (64, 2048, 2048, 2, False, 0, 0), "bf16"),
    ("quant_matmul", "tensor_core", (96, 128, 1, 32),
     (64, 2048, 2048, 2, True, 0, 0), "tiles"),
    ("quant_matmul", "tensor_core", (64, 128, 3, 32),
     (64, 2048, 2048, 2, True, 0, 0), "splits"),
    ("quant_matmul", "tensor_core", (64, 128, 1, 32),
     (64, 2048, 2048, 2, True, 0, 8), "aligned"),
    ("quant_matmul", "thin_m", (128, 18, 60),
     (17, 2048, 2048, 2, True, 0, 0), "M <= 16"),
    ("quant_matmul", "thin_m", (128, 1, 1024),
     (8, 2048, 2048, 2, True, 0, 0), "byte rows"),
    ("quant_matmul", "thin_m", (128, 18), (8, 2048, 2048, 2, True, 0, 0),
     "3 "),
    ("quant_matmul", "tiled", (1,), (8, 64, 64, 1, True, 0, 0), "no plan"),
    ("quant_matmul", "fast", None, (8, 64, 64, 1, True, 0, 0), "unknown"),
    ("block_sparse_matmul", "thin_m", (64, 1, 1),
     (16, 128, 128, 2, 64, 64, True, 0, 1, 0), "stage"),
    ("block_sparse_matmul", "thin_m", (1, 8, 1),
     (8, 128, 128, 2, 64, 8, True, 0, 4, 0), "unpacked f32 / bf16"),
    ("block_sparse_matmul", "thin_m", (2, 3, 1),
     (8, 128, 128, 2, 64, 8, True, 0, 1, 0), "cover"),
    ("block_sparse_matmul", "tensor_core", (64, 128, 1, 8),
     (512, 128, 128, 2, 64, 8, True, 0, 1, 0), "steps"),
    ("block_sparse_matmul", "tensor_core", (64, 128, 8, 1),
     (512, 8, 4, 1, 6, 2, True, 0, 1, 0), "bk"),
    # 144 query rows split in row groups, but not over 8-byte aligned
    # codes at Dh 128; Dh 96 has no bt 16 build
    ("packed_decode_attention", "split", None,
     (1, 16, 144, 16, 128, 512, 64, 8, True), "query rows"),
    ("packed_decode_attention", "split", None,
     (8, 1, 32, 8, 96, 512, 16, 0, True), "Dh"),
    ("packed_decode_attention", "single", (1, 8),
     (8, 1, 32, 8, 64, 512, 64, 0, True), "no plan"),
]


@pytest.mark.parametrize("kernel,route,plan,shape,said", ILLEGAL)
def test_check_plan_rejects_an_illegal_plan(kernel, route, plan, shape,
                                            said):
    with pytest.raises(ValueError, match="leaf7") as e:
        check_plan(kernel, route, plan, shape, name="leaf7")
    assert said in str(e.value)


# float blocks (f32: 4 bytes an element, bf16: 2), unpacked: the thin-M
# route at decode rows, the tensor-core route for bf16 x past 16 rows
LEGAL_FLOAT = [
    ("thin_m", (1, 8, 1), (8, 128, 128, 1, 64, 8, True, 256, 4, 0)),
    ("thin_m", (2, 4, 1), (16, 128, 128, 1, 64, 8, False, 8, 2, 0)),
    ("tensor_core", (64, 128, 2, 4), (512, 128, 128, 1, 64, 8, True, 256, 4,
                                      512)),
    ("tensor_core", (128, 128, 4, 2), (512, 128, 128, 1, 64, 8, True, 256,
                                       2, 512)),
]


@pytest.mark.parametrize("route,plan,shape", LEGAL_FLOAT)
def test_check_plan_accepts_a_float_block_plan(route, plan, shape):
    check_plan("block_sparse_matmul", route, plan, shape, name="leaf7")
    assert tsk.bsm_plan_error(route, plan, *shape) is None


def test_wrappers_raise_on_an_illegal_plan_and_fall_back_when_tuned():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, 64)), dtype=torch.float32)
    w = torch.as_tensor(rng.integers(-7, 8, (64, 128)), dtype=torch.int8)
    s = torch.full((128,), 0.01)
    bad = ("tensor_core", (64, 128, 1, 1))
    with pytest.raises(ValueError, match="blocks/mlp/wq"):
        tqk.quant_matmul(x, w, s, plan=bad, name="blocks/mlp/wq")
    want = tqk.quant_matmul(x, w, s)
    torch.testing.assert_close(
        tqk.quant_matmul(x, w, s, plan=bad, tuned=True), want, rtol=0,
        atol=0)
    good = tqk.qmm_candidates(8, 64, 128, 1, False)[1]
    torch.testing.assert_close(tqk.quant_matmul(x, w, s, plan=good), want,
                               rtol=0, atol=0)
    pat = t_shared(64, 128, (32, 32), 0.5)
    from repro_torch.kernels.sparse_matmul.ops import schedule_for
    sched = schedule_for(pat, "cpu")
    blocks = torch.as_tensor(rng.normal(size=(pat.n_blocks_present, 32, 32)),
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="leaf9"):
        tsk.block_sparse_matmul(x, blocks, sched,
                                plan=("tensor_core", (64, 128, 1, 1)),
                                name="leaf9")
    # f32 blocks take the thin-M route at decode rows: its plan is legal
    rule = tsk.bsm_candidates(8, 32, 32, 1, sched.n_col_blocks,
                              sched.max_blocks_per_col, False, 256, 4, 256)
    assert rule[0][0] == "thin_m"
    torch.testing.assert_close(
        tsk.block_sparse_matmul(x, blocks, sched, plan=rule[0], name="leaf9"),
        tsk.block_sparse_matmul(x, blocks, sched), rtol=0, atol=0)


# --------------------------------------------------- policy="autotune"


GRID = list(itertools.product(
    [(8, 8), (64, 64), (512, 512), (2048, 8192), (150, 16)],
    [(0.25, 0.1), (0.5, 0.25), (1.0, 1.0)], [True, False], [1, 64],
    [0, 4096]))


@pytest.mark.parametrize("hw", list(HWS))
def test_tuned_policy_equals_reference(hw):
    jhw, thw = HWS[hw]
    for (K, N), (bd, ed), elig, bt, floor in GRID:
        jr = jc.CompileRules(batch_tokens=bt, min_weight_elems=floor, hw=jhw)
        tr = tc.CompileRules(batch_tokens=bt, min_weight_elems=floor, hw=thw)
        kw = dict(block_density=bd, element_density=ed, sparse_eligible=elig)
        assert ta.tuned_policy(K, N, rules=tr, **kw) == \
            ja.tuned_policy(K, N, rules=jr, **kw), (K, N, bd, ed, elig, bt)
        spec = dict(name="c", kind="conv", flops=2.0 * K * N * 576,
                    weight_elems=K * N, act_bytes=4.0 * 576 * (K + N))
        assert ta.tuned_policy(K, N, rules=tr, spec=tcm_.LayerSpec(**spec),
                               **kw) == \
            ja.tuned_policy(K, N, rules=jr, spec=jcm_.LayerSpec(**spec), **kw)


@pytest.mark.parametrize("hw", list(HWS))
@pytest.mark.parametrize("budget", [8e6, 2e5, 64e6])
def test_dse_retune_and_run_dse_equal_reference(hw, budget):
    jhw, thw = HWS[hw]
    dens = {"conv1": (0.8, 0.4), "fc1": (0.5, 0.125), "fc2": (0.5, 0.125)}
    js = jl.lenet_layer_specs(batch=4, densities=dens)
    ts = tl.lenet_layer_specs(batch=4, densities=dens)
    for j, t in zip(js, ts):
        for unroll, bits in itertools.product(("factor", "sparse"),
                                              (16, 8, 4)):
            jf = jdse.FoldingConfig(parallelism=16, unroll=unroll,
                                    quant_bits=bits)
            tf = tdse.FoldingConfig(parallelism=16, unroll=unroll,
                                    quant_bits=bits)
            jo, to = ja.dse_retune(j, jf, jhw), ta.dse_retune(t, tf, thw)
            assert (to is None) == (jo is None)
            if to is not None:
                assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    jr = jdse.run_dse(js, hw=jhw, resource_budget=budget,
                      retune=ja.dse_retune)
    tr = tdse.run_dse(ts, hw=thw, resource_budget=budget,
                      retune=ta.dse_retune)
    assert tr.trace == jr.trace
    assert [dataclasses.asdict(c) for c in tr.configs] == \
        [dataclasses.asdict(c) for c in jr.configs]
    assert dataclasses.asdict(tr.estimate) == dataclasses.asdict(jr.estimate)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _np(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("hw", list(HWS))
def test_compile_model_autotune_equals_reference(models, hw):
    jcfg, tcfg, jp, tp = models
    jhw, thw = HWS[hw]
    kw = dict(block=(32, 32), block_density=0.5, in_block_density=0.5,
              min_weight_elems=0, policies={k: "autotune"
                                            for k in SERVE_POLICIES})
    jcm = jc.compile_model(jp, jcfg, rules=jc.CompileRules(hw=jhw, **kw))
    tcm = tc.compile_model(tp, tcfg, rules=tc.CompileRules(hw=thw, **kw),
                           device="cpu")
    assert [dataclasses.asdict(r) for r in tcm.report] == \
        [dataclasses.asdict(r) for r in jcm.report]
    tl_ = dict(_leaves(tcm.params))
    for path, a in _leaves(jcm.params):
        np.testing.assert_array_equal(_np(tl_[path]), _np(a),
                                      err_msg=str(path))
    assert sorted(tcm.patterns) == sorted(jcm.patterns)


def test_compile_lenet_and_conv_autotune_equal_reference():
    jp = jl.init_lenet(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu")
    kw = dict(block=(8, 4), min_weight_elems=0, block_density=0.5,
              policies={n: "autotune" for n in LENET_BLOCKS})
    jcm = jc.compile_lenet(jp, blocks=LENET_BLOCKS,
                           rules=jc.CompileRules(**kw))
    tcm = tc.compile_lenet(tp, blocks=LENET_BLOCKS,
                           rules=tc.CompileRules(**kw), device="cpu")
    assert [dataclasses.asdict(r) for r in tcm.report] == \
        [dataclasses.asdict(r) for r in jcm.report]
    assert (tcm.storage_bytes, tcm.container_storage_bytes) == \
        (jcm.storage_bytes, jcm.container_storage_bytes)
    for name in LENET_BLOCKS:
        jd = jc.decompress_model(jcm)[name + "_w"]
        td_ = tc.decompress_model(tcm)[name + "_w"]
        np.testing.assert_array_equal(_np(td_), _np(jd), err_msg=name)
    w4 = np.random.default_rng(2).normal(size=(3, 3, 8, 32)).astype(
        np.float32)
    for bits in (4, 8):
        rkw = dict(block=(8, 4), min_weight_elems=0, quant_bits=bits)
        _, jpat, jrep = jc.compile_conv(w4, rules=jc.CompileRules(**rkw),
                                        policy="autotune", strides=(2, 2),
                                        in_hw=(16, 16))
        _, tpat, trep = tc.compile_conv(w4, rules=tc.CompileRules(**rkw),
                                        policy="autotune", strides=(2, 2),
                                        in_hw=(16, 16), device="cpu")
        assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
        assert (tpat is None) == (jpat is None)


# ------------------------------------------------------------ the seams


def test_lenet_table_keys_conv_leaves_apart_and_forward_unchanged(tmp_path):
    """``autotune_lenet`` writes ``conv_*`` keys at M·H_out·W_out rows (the
    reference's keys), which the fused convs (``fusedconv_*``) do not read:
    the tuned forward is the untuned one bit for bit."""
    jp = jl.init_lenet(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu")
    kw = dict(block=(8, 4), min_weight_elems=0, block_density=0.5,
              quant_bits=4)
    jcm = jc.compile_lenet(jp, blocks=LENET_BLOCKS,
                           rules=jc.CompileRules(**kw))
    tcm = tc.compile_lenet(tp, blocks=LENET_BLOCKS,
                           rules=tc.CompileRules(**kw), device="cpu")
    table = ta.autotune_lenet(tcm, M=2, options=FAST,
                              path=str(tmp_path / "l.json"))
    jt = ja.autotune_lenet(jcm, M=2, options=ja.TuneOptions(
        iters=1, warmup=1, max_measured=1), save=False,
        path=str(tmp_path / "j.json"))
    assert sorted(table.entries) == sorted(jt.entries)
    conv = [k for k in table.entries if k.startswith("conv_")]
    assert conv and any(":M2048:" in k for k in conv)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 28, 28, 1)),
                        dtype=torch.float32)
    with torch.no_grad():
        y0 = tl.lenet_forward(tp, x, compressed=tcm.layers, fusion=True)
        y1 = tl.lenet_forward(tp, x, compressed=tcm.layers, fusion=True,
                              dispatch=td.DispatchConfig(tuned=table))
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    per = ta.autotune_lenet(tcm, M=2, options=FAST, per_leaf=True,
                            path=str(tmp_path / "l.json"))
    assert {k.rsplit("leaf=", 1)[1] for k in per.entries if ":leaf=" in k} \
        >= {"conv1", "conv2"}


def test_autotune_attn_on_the_cpu_times_the_plain_read(tmp_path):
    table = ta.TunedTable(path=str(tmp_path / "a.json"))
    e = ta.autotune_attn(B=2, T=64, H=4, Hkv=2, Dh=16, options=FAST,
                         table=table, device="cpu")
    assert not e.use_kernel and e.route is None and e.bt in ta.ATTN_BTS
    assert table.n_timings() == 4
    key = ja.tune_key(kind="attn_packed", M=2, K=64, N=64,
                      dtype=jnp.float32, backend="cpu")
    assert key in table
    again = ta.TunedTable.load(table.path)
    again.log = []
    assert ta.autotune_attn(B=2, T=64, H=4, Hkv=2, Dh=16, options=FAST,
                            table=again, device="cpu") == e
    assert again.n_timings() == 0


@pytest.mark.parametrize("kv", ["float", "int4x2", "int4"])
def test_tuned_engine_serves_the_untuned_tokens(models, kv):
    _, tcfg, _, _ = models
    _, tcm = _serve_compile(models)
    prompts = [np.random.default_rng(i).integers(0, tcfg.vocab, n)
               .astype(np.int32) for i, n in enumerate((5, 19, 33))]

    def serve(**kw):
        eng = ServeEngine(tcm, tcfg, batch_slots=2, max_len=64,
                          kv_cache=kv, device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        return eng, [r.out for r in sorted(eng.run(), key=lambda r: r.uid)]

    _, want = serve()
    eng, got = serve(autotune=True, autotune_options=FAST)
    assert got == want
    assert eng.dispatch.m_bucket == 2 and len(eng.dispatch.tuned) > 0
    assert all(not e.use_kernel for e in eng.dispatch.tuned.entries.values())
    if kv != "float":
        assert eng._bt in ta.ATTN_BTS
    eng2, again = serve(autotune=eng.dispatch.tuned)
    assert again == want and eng2.dispatch.tuned is eng.dispatch.tuned
    with pytest.raises(ValueError, match="CompressedModel"):
        ServeEngine(tcm.params, tcfg, patterns=tcm.patterns, device="cpu",
                    autotune=True)


def test_tuned_dispatch_is_the_plain_result_on_the_cpu(models):
    """A CPU table (plain entries) leaves a tuned forward bitwise the
    untuned one; the im2col conv path looks up ``conv_`` keys."""
    from repro_torch.models import model as tm

    _, tcfg, _, _ = models
    _, tcm = _serve_compile(models)
    table = ta.autotune_model(tcm, M=4 * 8, options=FAST, save=False)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, tcfg.vocab, (4, 8)), dtype=torch.int32)}
    with torch.no_grad():
        y0 = tm.forward(tcm.params, tcfg, batch, patterns=tcm.patterns)
        y1 = tm.forward(tcm.params, tcfg, batch, patterns=tcm.patterns,
                        dispatch=td.DispatchConfig(tuned=table))
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    assert json.loads(json.dumps(
        {k: v.to_json() for k, v in table.entries.items()}))
