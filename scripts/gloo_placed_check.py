#!/usr/bin/env python3
"""The placed (DTensor) steps' gloo checks without pytest or JAX, for a
machine whose torch differs from the one the tests ran under.

Spawns every mesh of ``tests/test_torch_sharding_apply.py`` (the dense
family), ``tests/test_torch_moe_sharding.py`` and
``tests/test_torch_moe_sharding_serve.py`` (the MoE family),
``tests/test_torch_{hybrid,xlstm}_sharding{,_serve}.py`` (the SSM and
hybrid families) and ``tests/test_torch_seq_cache.py`` (the
sequence-sharded cache) through
``tests/_sharding_workers.py`` on the CPU, then calls each of those files'
test functions that read the ranks' results (every parametrization), or,
for the sequence-sharded cache (whose file imports JAX), applies its
one-process checks here.  The tests against the reference (JAX) are not
run: they are the CPU test suite's.

Prints one JSON line per file and mesh (the tests passed, failed with
their messages, not run) and the torch version.  Runs on the CPU; imports
nothing of JAX.

Usage:  python3 scripts/gloo_placed_check.py [FILE ...]
(FILE: a test file's name without ``.py``, or ``test_torch_seq_cache``;
none: every file)
"""
from __future__ import annotations

import importlib
import inspect
import itertools
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

FILES = {"test_torch_sharding_apply": "apply",
         "test_torch_moe_sharding": "moe_train",
         "test_torch_moe_sharding_serve": "moe_serve",
         "test_torch_hybrid_sharding": "hybrid_train",
         "test_torch_hybrid_sharding_serve": "hybrid_serve",
         "test_torch_xlstm_sharding": "xlstm_train",
         "test_torch_xlstm_sharding_serve": "xlstm_serve"}
SEQ_REL = 1e-5


def cases(fn):
    """Every parametrization of ``fn`` beside ``ranks``, as kwargs."""
    grid = []
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            names = [n.strip() for n in mark.args[0].split(",")]
            grid.append([dict(zip(names, v if len(names) > 1 else (v,)))
                         for v in mark.args[1]])
    for combo in itertools.product(*grid):
        kw = {}
        for part in combo:
            kw.update(part)
        yield kw


def run_file(name: str, kind: str, spawn_mesh) -> None:
    mod = importlib.import_module(name)
    tests = [(n, f) for n, f in vars(mod).items() if n.startswith("test_")
             and "ranks" in inspect.signature(f).parameters
             and "reference" not in n]
    skipped = [n for n in vars(mod) if n.startswith("test_")
               and "reference" in n]
    for shape in mod.MESHES:
        t0 = time.perf_counter()
        res = spawn_mesh(shape, kind=kind)
        row = {"file": name, "mesh": list(shape), "passed": 0, "failed": [],
               "not_run": skipped}
        for n, f in tests:
            for kw in cases(f):
                tag = f"{n}{sorted(kw.values())}"
                try:
                    f(ranks=(shape, res), **kw)
                    row["passed"] += 1
                except Exception:
                    row["failed"].append(
                        f"{tag}: {traceback.format_exc(limit=1)[-300:]}")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


def run_seq(spawn_mesh) -> None:
    """``test_seq_cache_matches_one_process``'s checks (its file imports
    JAX for its reference test)."""
    from _sharding_workers import SEQ_CASES, SEQ_READS

    for shape in SEQ_CASES:
        t0 = time.perf_counter()
        res = spawn_mesh(shape, kind="seq")
        row = {"file": "test_torch_seq_cache", "mesh": list(shape),
               "passed": 0, "failed": [], "not_run": [
                   "test_seq_cache_matches_reference (JAX)"]}
        for hkv, B in SEQ_CASES[shape]:
            for kv, read in SEQ_READS:
                key = f"h{hkv}b{B}/{kv}/{read}"
                ok = res[f"{key}/finite"] and res[f"{key}/rel"] <= SEQ_REL \
                    and res[f"{key}/cache"] <= SEQ_REL
                if ok:
                    row["passed"] += 1
                else:
                    row["failed"].append(
                        f"{key}: rel {res[f'{key}/rel']} cache "
                        f"{res[f'{key}/cache']}")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)


def main() -> int:
    import torch

    from _sharding_workers import spawn_mesh

    only = set(sys.argv[1:])
    for name, kind in FILES.items():
        if not only or name in only:
            run_file(name, kind, spawn_mesh)
    if not only or "test_torch_seq_cache" in only:
        run_seq(spawn_mesh)
    print(json.dumps({"torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
