"""The dry-run (``repro_torch.launch.dryrun``) and its counts
(``repro_torch.launch.op_costs``) on the CPU.

Each case runs in a process of its own: the fake process group is
process-global.

* Reduced llama3.2-1b (f32; train 4 × 16 tokens, prefill 4 × 16, decode 4
  rows over a 32-row cache) on a fake (2, 2) ``("data", "model")`` mesh:
  the train, prefill and decode steps end ``ok``, and the per-device
  product FLOPs × 4 equal the unplaced step's one-process count (every
  product of this config splits evenly over batch and heads / columns /
  rows / vocab), ``mm`` and ``bmm`` each, exactly;
* the double-count trap: a DTensor product counted by torch's own
  ``FlopCounterMode`` gives the global count (or global plus local,
  depending on the torch version), ``OpCosts`` the local one only;
* reduced olmoe-1b-7b's train, prefill and decode cells on the same mesh
  end ``ok``, their products (the MoE leg's experts among them) split four
  ways; olmoe-1b-7b's full-size ``decode_32k`` cell from the command line;
* reduced xlstm-1.3b's and zamba2-2.7b's train, prefill and decode cells
  end ``ok``, their ``mm`` and ``bmm`` FLOPs a device equal to the legs'
  reckoning: every product split four ways but those each ``model`` rank
  repeats (the sLSTM's, and the Mamba2 chunks' ``C·Bᵀ``); xlstm-1.3b's
  and zamba2-2.7b's full-size ``decode_32k`` cells from the command line;
* a full-size cell through the command line (llama3.2-1b ``decode_32k``
  on (16, 16)) writes its record; an encoder's decode cell is skipped
  with the reference's reason;
* ``roofline_terms`` is the reference's arithmetic.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_CELLS = """
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun as d
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_costs import OpCosts
from repro_torch.launch.specs import cache_shapes, input_specs, opt_shapes
from repro_torch.launch.specs import param_shapes
from repro_torch.models.config import ShapeSpec
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train import trainer

cfg = reduced_config("llama3.2-1b")
shapes = [ShapeSpec("t", 16, 4, "train"), ShapeSpec("p", 16, 4, "prefill"),
          ShapeSpec("d", 32, 4, "decode")]


def one_process(cfg, s, n_micro):
    with OpCosts() as one:
        p, b = param_shapes(cfg), input_specs(cfg, s)
        if s.kind == "train":
            oc = AdamWConfig(state_dtype=cfg.opt_state_dtype)
            trainer.make_train_step(cfg, oc, n_micro)(
                p, opt_shapes(cfg, p, oc), b)
        elif s.kind == "prefill":
            trainer.make_prefill_step(cfg)(p, b)
        else:
            trainer.make_serve_step(cfg)(p, cache_shapes(cfg, s),
                                         b["tokens"])
    return one.record()


out = {}
with d.fake_group(4):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for s in shapes:
        placed, per_rank = d.place_cell(cfg, s, mesh)
        counts, n_micro = d.run_step(cfg, s, placed, mesh)
        rec = d.analyse(counts, n_chips=4, cfg=cfg, shape=s)
        out[s.kind] = {"placed": rec, "one": one_process(cfg, s, n_micro),
                       "bytes": per_rank, "n_micro": n_micro}
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    x = DTensor.from_local(torch.empty(64, 256, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(256, 512, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    with FlopCounterMode(display=False) as fc:
        x @ w
    with OpCosts() as oc:
        x @ w
    out["trap"] = {"torch": fc.get_total_flops(), "port": oc.flops,
                   "global": 2 * 128 * 256 * 1024}
    moe = reduced_config("olmoe-1b-7b")
    out["moe"] = {}
    for s in shapes:
        placed, per_rank = d.place_cell(moe, s, mesh)
        counts, n_micro = d.run_step(moe, s, placed, mesh)
        out["moe"][s.kind] = {"placed": counts,
                              "one": one_process(moe, s, n_micro),
                              "bytes": per_rank}
    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        c = reduced_config(arch)
        out[arch] = {}
        for s in shapes:
            placed, per_rank = d.place_cell(c, s, mesh)
            counts, n_micro = d.run_step(c, s, placed, mesh)
            out[arch][s.kind] = {"placed": counts, "n_micro": n_micro,
                                 "one": one_process(c, s, n_micro),
                                 "bytes": per_rank}
print(json.dumps(out))
"""


def _run(code, timeout=300):
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    return _run(_CELLS)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_cell_runs_and_splits_its_products_four_ways(cells, kind):
    c = cells[kind]
    placed, one = c["placed"], c["one"]
    assert placed["flops_per_device"] > 0
    assert set(placed["flops_by_op"]) == set(one["flops_by_op"])
    for op, f in one["flops_by_op"].items():
        assert placed["flops_by_op"][op] * 4 == f, (kind, op)
    assert placed["flops_per_device"] * 4 == one["flops_per_device"]
    assert placed["roofline"]["bound"] in ("compute", "memory", "collective")
    assert c["bytes"]["params"] > 0 and c["bytes"]["batch"] > 0
    assert (c["bytes"]["opt"] > 0) == (kind == "train")
    assert (c["bytes"]["cache"] > 0) == (kind == "decode")
    if kind != "decode":
        # data-parallel gradients / the vocab-sharded loss all-reduce
        assert sum(placed["collectives"].values()) > 0
        assert placed["attention_traffic_bytes"] > 0


def test_flop_counter_double_count_trap(cells):
    """torch's ``FlopCounterMode`` counts a DTensor product at its global
    shapes (plus, on some versions, the local call again); the port's
    counter counts each rank's local call only."""
    t = cells["trap"]
    assert t["port"] == t["global"] // 4
    assert t["torch"] in (t["global"], t["global"] + t["global"] // 4)


def _repeated(arch: str, kind: str):
    """The ``(mm, bmm)`` FLOPs of one process's reduced step (4 rows of 16
    tokens, or a decode row) that every ``model`` rank repeats on its
    batch rows, by the legs' design (``core/sharded.py``): the sLSTM, which
    the rules replicate over ``model`` — its input projection ``wx`` (mm)
    and a step's recurrent product ``h @ r`` (bmm, T steps) — and in a
    Mamba2 chunk the ``C·Bᵀ`` product of the B and C channels that every
    rank takes (a decode step has none).  Every other product splits
    four ways: batch over ``data``, heads / key features / columns /
    channels over ``model``.  Training adds the backward's two products a
    product (the first sLSTM step's h is a constant: one)."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    B, T = 4, 1 if kind == "decode" else 16
    train = kind == "train"
    if arch == "xlstm-1.3b":
        D, H = cfg.d_model, cfg.n_heads
        P = D // H
        layers = cfg.n_layers // cfg.slstm_every
        wx = 2 * B * T * D * 4 * D
        step = 2 * H * B * P * 4 * P
        return (layers * wx * (3 if train else 1),
                layers * step * (3 * T - 1 if train else T))
    if kind == "decode":
        return 0, 0
    cb = 2 * B * T * T * cfg.ssm_state * cfg.n_layers     # one chunk of T
    return 0, cb * (3 if train else 1)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-2.7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_ssm_cell_runs_and_splits_by_its_legs(cells, arch, kind):
    """Reduced xlstm-1.3b and zamba2-2.7b on the fake (2, 2) mesh: the
    placed step ends ``ok`` with each rank's products those of the legs'
    design — a quarter of one process's, plus half of what every
    ``model`` rank repeats (:func:`_repeated`) — and the legs' all-to-alls
    among its collectives."""
    c = cells[arch][kind]
    placed, one = c["placed"], c["one"]
    rep = dict(zip(("mm", "bmm"), _repeated(arch, kind)))
    assert set(placed["flops_by_op"]) == set(one["flops_by_op"]) == set(rep)
    for op, f in one["flops_by_op"].items():
        assert placed["flops_by_op"][op] * 4 == f + rep[op], (arch, kind, op)
    assert placed["collectives"]["all-to-all"] > 0
    assert c["bytes"]["params"] > 0
    assert (c["bytes"]["cache"] > 0) == (kind == "decode")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_moe_cell_runs_and_splits_its_products(cells, kind):
    """Reduced olmoe-1b-7b on the fake (2, 2) mesh: the MoE leg's expert
    products (and the attention's) split four ways exactly — each rank
    runs half of every expert's capacity rows (C even here) on half of its
    ``Fe`` columns — while every rank routes all the tokens (the router's
    product is not split)."""
    c = cells["moe"][kind]
    placed, one = c["placed"], c["one"]
    assert placed["flops_by_op"]["bmm"] * 4 == one["flops_by_op"]["bmm"]
    assert placed["flops_by_op"]["mm"] * 4 > one["flops_by_op"]["mm"]
    assert c["bytes"]["params"] > 0
    assert (c["bytes"]["cache"] > 0) == (kind == "decode")
    assert sum(placed["collectives"].values()) > 0


def _cli_cell(tmp_path, arch, shape):
    code = ("import sys; sys.path.insert(0, 'src')\n"
            "from repro_torch.launch import dryrun\n"
            f"dryrun.main(['--arch', {arch!r}, '--shape', {shape!r},"
            f" '--out', {str(tmp_path)!r}])\n"
            "print('{}')\n")
    _run(code)
    return json.loads((tmp_path / f"{arch}__{shape}__pod1.json").read_text())


def test_full_size_moe_decode_cell_from_the_command_line(tmp_path):
    """olmoe-1b-7b's ``decode_32k`` on (16, 16): the 16 kv heads over
    ``model`` (one a rank), the 128 slots over ``data`` (8 a rank), all
    32768 rows; every rank routes the 128 tokens (capacity 20: 2 rows of
    each expert a data rank, ranks 10-15 padding only)."""
    rec = _cli_cell(tmp_path, "olmoe-1b-7b", "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == 256
    assert rec["bytes_per_device"]["cache"] == \
        16 * 2 * 8 * 32768 * 1 * 128 * 2 + 16 * 8 * 4
    assert rec["flops_per_device"] > 0
    assert rec["collectives"]["reduce-scatter"] > 0
    assert "not a measurement" in rec["roofline"]["estimate"]


def test_full_size_ssm_decode_cells_from_the_command_line(tmp_path):
    """xlstm-1.3b's and zamba2-2.7b's ``decode_32k`` on (16, 16): the 128
    slots over ``data`` (8 a rank); the mLSTM state on 64 of 1024 key rows
    a rank, the Mamba2 state on 5 of 80 heads, its conv window on 328 of
    5248 channels, the shared attention's 32 kv heads 2 a rank."""
    rec = _cli_cell(tmp_path, "xlstm-1.3b", "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback")
    S, n = 6 * 7 * 8 * 4 * 64 * 1024 * 4, 6 * 7 * 8 * 4 * 64 * 4
    assert rec["bytes_per_device"]["cache"] == S + n + 3 * 6 * 8 * 2048 * 4
    assert rec["collectives"]["all-to-all"] > 0
    rec = _cli_cell(tmp_path, "zamba2-2.7b", "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback")
    kv = 2 * 9 * 8 * 32768 * 2 * 80 * 2 + 9 * 8 * 4
    S, conv = 9 * 6 * 8 * 5 * 64 * 64 * 4, 9 * 6 * 8 * 3 * 328 * 4
    assert rec["bytes_per_device"]["cache"] == kv + S + conv
    assert rec["flops_per_device"] > 0
    assert "not a measurement" in rec["roofline"]["estimate"]


def test_full_size_decode_cell_from_the_command_line(tmp_path):
    rec = _cli_cell(tmp_path, "llama3.2-1b", "decode_32k")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == 256
    # 8 kv heads over a model axis of 16: the cache is sequence-sharded,
    # 128 slots over 16 data ranks, 32768 rows over 16 model ranks
    assert rec["bytes_per_device"]["cache"] == \
        16 * 2 * 8 * 2048 * 8 * 64 * 2 + 16 * 8 * 4
    assert rec["collectives"]["all-reduce"] > 0
    assert "not a measurement" in rec["roofline"]["estimate"]


def test_encoder_decode_cell_is_skipped(tmp_path):
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", multi_pod=False,
                          out_dir=tmp_path)
    assert rec["status"] == "skipped"
    assert rec["reason"] == "encoder-only: no decode step exists"
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", multi_pod=True,
                          out_dir=tmp_path)
    assert rec["reason"].startswith("full-attention arch")


def test_roofline_terms_are_the_reference_arithmetic():
    from repro.launch.hlo_analysis import roofline_terms as jr
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.launch.dryrun import roofline_terms as tr

    for args in ((1e15, 3e12, 1e9), (1e12, 9e12, 0.0), (0.0, 1.0, 5e11)):
        want = jr(*args, n_chips=256, peak_flops=H100_SXM.peak_flops_bf16,
                  hbm_bw=H100_SXM.hbm_bw, ici_bw=H100_SXM.ici_bw)
        got = tr(*args, n_chips=256)
        assert {k: got[k] for k in want} == want
