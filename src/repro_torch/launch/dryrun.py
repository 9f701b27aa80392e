"""Multi-pod dry-run: place and run every (arch × shape × mesh) cell on
meta tensors, the port's counterpart of ``repro.launch.dryrun``.

Proves the distribution config is coherent without hardware: a rank of the
production mesh — (16, 16) ``("data", "model")``, or (2, 16, 16) with
``"pod"`` — is simulated in one CPU process under torch's fake process
group (world 256 or 512; its collectives move nothing).  Each cell's
parameters, AdamW moments, batch and cache are ``torch.device("meta")``
trees (:mod:`repro_torch.launch.specs`), placed as DTensors by the
sharding rules (:mod:`repro_torch.launch.sharding`), and the cell's step
runs once on them: ``make_train_step`` (``pick_n_micro``),
``make_prefill_step`` or ``make_serve_step``.  Nothing is allocated, and
a shape that only the data decides (``.item()``, ``nonzero``) raises.

Each cell's JSON record holds the per-rank bytes of parameters, moments,
batch and cache (read from the local shards, before the step runs, so a
cell whose step errors still has them) and the step's per-device counts
(:mod:`repro_torch.launch.op_costs`): FLOPs, traffic, collectives by kind;
the model FLOPs (6·N·tokens to train, 2·N·tokens to serve) and their ratio
to the counted FLOPs over all ranks; and ``roofline``, three terms from
the H100 SXM datasheet peaks (``core/cost_model.py`` ``H100_SXM``) — an
estimate, never a measurement.  A failing cell records ``status`` "error"
with its message and traceback, as the reference's ``run_cell`` does.

**The flash adjustment.**  On meta tensors every attention read runs its
plain version, which holds its score tensors in memory, so the count's
attention traffic includes the scores.  On the card the full-sequence
forward's flash kernel and the packed cache read keep them on chip (the
float cache read and the training backward, which recomputes the plain
``chunked_attention``, do not).  So, as the reference does for its Pallas
flash kernel, the record also carries ``roofline_flash``: the traffic of
the ``attention.flash`` and ``attention.packed`` ranges replaced by their
kernels' streaming of q, k, v and o once (one pass: the forward, and
``remat``'s recompute of it is counted as the plain forward is).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--out DIR] [--force] [--variant int8+seqshard]

Records go to ``results/dryrun_torch/<arch>__<shape>__<pod1|pod2>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from ..configs import ARCH_IDS, get_config
from ..core.cost_model import H100_SXM
from ..models.config import SHAPES
from ..train.optimizer import AdamWConfig
from ..train.trainer import (make_prefill_step, make_serve_step,
                             make_train_step, pick_n_micro)
from ..tree import tree_leaves
from .mesh import data_axes, make_production_mesh, mesh_size
from .op_costs import OpCosts
from .sharding import (batch_specs, cache_specs, param_specs, place_tree,
                       sanitize_specs)
from .specs import cache_shapes, input_specs, opt_shapes, param_shapes

__all__ = ["analyse", "apply_variant", "fake_group", "main", "place_cell",
           "roofline_terms", "run_cell", "run_step"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def apply_variant(cfg, variant: str):
    """Hillclimb variants: '+'-separated config mutations (the
    reference's tokens).

    int8      — int8 weight storage for every linear (QNN datapath)
    seqshard  — sequence/context parallelism for activations & attention
    nmicroN   — override gradient-accumulation microbatch count
    noremat   — disable activation checkpointing
    """
    n_micro_override = None
    flags = {"fsdp": True}
    for tok in variant.split("+"):
        if tok in ("", "baseline"):
            continue
        elif tok == "int8":
            cfg = dataclasses.replace(cfg, linear_mode="int8")
        elif tok.startswith("gsparseint8"):
            dens = float(tok[len("gsparseint8"):] or 50) / 100
            cfg = dataclasses.replace(cfg, linear_mode="gsparse_int8",
                                      sparse_density=dens)
        elif tok.startswith("gsparse"):
            dens = float(tok[len("gsparse"):] or 50) / 100
            cfg = dataclasses.replace(cfg, linear_mode="gsparse",
                                      sparse_density=dens)
        elif tok.startswith("sparseint8"):
            dens = float(tok[len("sparseint8"):] or 50) / 100
            cfg = dataclasses.replace(cfg, linear_mode="sparse_int8",
                                      sparse_density=dens)
        elif tok.startswith("sparse"):
            dens = float(tok[len("sparse"):] or 50) / 100
            cfg = dataclasses.replace(cfg, linear_mode="sparse",
                                      sparse_density=dens)
        elif tok == "seqshard":
            cfg = dataclasses.replace(cfg, seq_shard=True)
        elif tok == "noremat":
            cfg = dataclasses.replace(cfg, remat=False)
        elif tok == "nofsdp":
            flags["fsdp"] = False
        elif tok.startswith("nmicro"):
            n_micro_override = int(tok[len("nmicro"):])
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return cfg, n_micro_override, flags


def _skip_reason(cfg, shape_name):
    if not cfg.supports_decode:
        return "encoder-only: no decode step exists"
    return "full-attention arch: 512k decode requires sub-quadratic attention"


class fake_group:
    """``with fake_group(world):`` — torch's fake process group of
    ``world`` ranks in this process, as ``rank`` (0 by default; its
    collectives move nothing), torn down on exit.  It is process-global: it
    refuses to start beside another process group."""

    def __init__(self, world: int, rank: int = 0):
        self.world, self.rank = int(world), int(rank)

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError(
                "the dry-run's fake process group needs a process of its "
                f"own: a {dist.get_backend()} group is already started")
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                world_size=self.world)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        return False


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in tree_leaves(tree))


def place_cell(cfg, shape, mesh, *, fsdp: bool = True):
    """The cell's meta trees placed on ``mesh`` (under a started group):
    ``(placed, per_rank_bytes)`` with ``placed`` holding ``params``,
    ``batch``, and ``opt`` (train) or ``cache`` and ``tokens`` (decode).
    Specs as the reference's ``lower_cell``: parameters by ``param_specs``
    → ``sanitize_specs``; moments by the same specs (``{"m": pspecs, "v":
    pspecs, "step": ()}``); the batch by ``batch_specs``; the cache by
    ``cache_specs``, the decode tokens over the data axes where they
    divide the batch."""
    pshapes = param_shapes(cfg)
    pspecs = sanitize_specs(param_specs(pshapes, cfg, mesh, fsdp=fsdp),
                            pshapes, mesh)
    placed = {"params": place_tree(pshapes, pspecs, mesh)}
    binputs = input_specs(cfg, shape)
    bspecs = sanitize_specs({k: v for k, v in batch_specs(cfg, mesh).items()
                             if k in binputs}, binputs, mesh)
    if shape.kind == "train":
        oshapes = opt_shapes(cfg, pshapes,
                             AdamWConfig(state_dtype=cfg.opt_state_dtype))
        placed["opt"] = place_tree(
            oshapes, {"m": pspecs, "v": pspecs, "step": ()}, mesh)
    if shape.kind == "decode":
        cshapes = cache_shapes(cfg, shape)
        cspecs = sanitize_specs(
            cache_specs(cfg, mesh, batch=shape.global_batch), cshapes, mesh)
        placed["cache"] = place_tree(cshapes, cspecs, mesh)
        dp = data_axes(mesh)
        b = dp if len(dp) > 1 else dp[0]
        if shape.global_batch % mesh_size(mesh, dp):
            b = None
        bspecs = {"tokens": (b, None)}
    placed["batch"] = place_tree(binputs, bspecs, mesh)
    per_rank = {"params": _local_bytes(placed["params"]),
                "opt": _local_bytes(placed.get("opt", {})),
                "batch": _local_bytes(placed["batch"]),
                "cache": _local_bytes(placed.get("cache", {}))}
    return placed, per_rank


def run_step(cfg, shape, placed, mesh, n_micro_override=None):
    """Run the cell's step once on its placed meta trees, counting its
    operations; returns ``(counts, n_micro)``."""
    from torch.distributed.tensor.debug import CommDebugMode

    n_micro = None
    with CommDebugMode() as comm, OpCosts() as costs:
        if shape.kind == "train":
            n_micro = n_micro_override or pick_n_micro(
                cfg, shape.global_batch, mesh_size(mesh, data_axes(mesh)))
            opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
            make_train_step(cfg, opt_cfg, n_micro)(
                placed["params"], placed["opt"], placed["batch"])
        elif shape.kind == "prefill":
            make_prefill_step(cfg)(placed["params"], placed["batch"])
        else:
            make_serve_step(cfg)(placed["params"], placed["cache"],
                                 placed["batch"]["tokens"])
    rec = costs.record()
    # the collectives' counts by op, as DTensor's CommDebugMode sees them
    rec["collective_counts"] = {str(k): int(v) for k, v in
                                comm.get_comm_counts().items()}
    return rec, n_micro


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, *,
                   n_chips: int, per_device: bool = True,
                   peak_flops: float = H100_SXM.peak_flops_bf16,
                   hbm_bw: float = H100_SXM.hbm_bw,
                   ici_bw: float = H100_SXM.ici_bw) -> dict:
    """Three roofline terms in seconds from per-device counts (the
    reference's ``hlo_analysis.roofline_terms``, with the H100 SXM's
    datasheet peaks: an estimate)."""
    div = 1.0 if per_device else float(n_chips)
    compute = flops / div / peak_flops
    memory = hbm_bytes / div / hbm_bw
    collective = coll_bytes / ici_bw
    terms = {"compute": compute, "memory": memory, "collective": collective}
    terms["bound"] = max(("compute", "memory", "collective"),
                         key=lambda k: terms[k])
    terms["total"] = max(compute, memory, collective)
    terms["estimate"] = "H100 SXM datasheet peaks, not a measurement"
    return terms


def _attn_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.attn_every, 1)
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def analyse(counts: dict, *, n_chips: int, cfg, shape) -> dict:
    """The record's analysis of a step's counts: the roofline, the flash
    adjustment (see the module docstring) and the model FLOPs."""
    flops = counts["flops_per_device"]
    traffic = counts["traffic_bytes_per_device"]
    coll = counts["collective_bytes_per_device"]
    rec = dict(counts)
    rec["roofline"] = roofline_terms(flops, traffic, coll, n_chips=n_chips)
    attn = sum(v for k, v in counts["traffic_by_scope"].items()
               if k.startswith("attention"))
    if attn > 0:
        B = shape.global_batch
        T = shape.seq_len if shape.kind != "decode" else 1
        Dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        kv_T = shape.seq_len
        flash_io = (B * (2 * T * H * Dh + 2 * kv_T * Hkv * Dh) * 2.0
                    * _attn_layers(cfg)) / n_chips
        rec["roofline_flash"] = roofline_terms(
            flops, traffic - attn + flash_io, coll, n_chips=n_chips)
        rec["attention_traffic_bytes"] = attn
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * cfg.active_param_count() * tokens
    rec["model_flops_global"] = model_flops
    global_count = flops * n_chips
    rec["model_flops_ratio"] = model_flops / global_count \
        if global_count else None
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
             force: bool = False, variant: str = "baseline") -> dict:
    """One cell under its own fake group; its record (also written to
    ``out_dir``; an existing record is returned as it is unless
    ``force``)."""
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if variant != "baseline":
        tag += f"__{variant.replace('+', '_')}"
    out_file = out_dir / f"{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    n_chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "n_chips": n_chips, "variant": variant}
    try:
        cfg, n_micro_override, flags = apply_variant(get_config(arch),
                                                     variant)
        shape = SHAPES[shape_name]
        if shape not in cfg.applicable_shapes():
            rec.update(status="skipped", skipped=True,
                       reason=_skip_reason(cfg, shape_name))
        else:
            with fake_group(n_chips):
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device="cpu")
                t0 = time.time()
                placed, per_rank = place_cell(cfg, shape, mesh,
                                              fsdp=flags["fsdp"])
                rec["bytes_per_device"] = per_rank
                rec["t_place_s"] = round(time.time() - t0, 1)
                t0 = time.time()
                counts, n_micro = run_step(cfg, shape, placed, mesh,
                                           n_micro_override)
                rec["t_step_s"] = round(time.time() - t0, 1)
                rec["n_micro"] = n_micro
                rec.update(analyse(counts, n_chips=n_chips, cfg=cfg,
                                   shape=shape))
            rec["status"] = "ok"
    except Exception as e:  # a failure here is a gap in the port
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    for a, s, mp in cells:
        t0 = time.time()
        rec = run_cell(a, s, multi_pod=mp, out_dir=out_dir, force=args.force,
                       variant=args.variant)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" bound={r['bound']} total={r['total']:.3e}s (estimate)"
                     f" step={rec.get('t_step_s')}s")
        elif status == "error":
            extra = " " + rec.get("error", "")[:120]
        print(f"[{time.strftime('%H:%M:%S')}] {a} × {s} × "
              f"{'2pod' if mp else '1pod'}: {status}{extra} "
              f"({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
