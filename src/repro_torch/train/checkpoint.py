"""Step-atomic checkpoints, in the on-disk format of
``repro.train.checkpoint``: a checkpoint written by either package restores
in the other.

Layout (one directory per step)::

    ckpt_dir/
      step_000000123/
        manifest.json        # step, n_hosts, keys, shapes, dtypes, extra
        host_0.npz           # flat key -> array, keys the dict paths
        ...                  # host_1.npz ... one file per host
        COMMIT               # written last: a checkpoint without it is torn

* **Atomicity** — writers dump into ``step_N.tmp`` and rename after the
  COMMIT marker is in place; restore ignores directories without COMMIT.
* **Hosts** — ``n_hosts`` processes (the ranks of a started process group)
  write one checkpoint together: host ``h`` writes the leaves whose place
  in the sorted key list is ``h`` modulo ``n_hosts``, each whole, with
  their global shapes in host 0's manifest.  A placed (DTensor) leaf is
  gathered by every rank (a collective) and written by its host.  The
  hosts meet at a barrier before host 0 commits.  Restore reads every
  host's file, so a checkpoint restores on any number of hosts and any
  mesh.
* **Async** — ``save_async`` copies the tensors to host memory in the
  calling thread and hands them to one worker thread; the training loop
  blocks only on the previous save.  With more than one host it writes in
  the calling thread: the hosts' barriers are collectives.
* **Dtypes** — bf16 has no numpy dtype, so it is stored widened to f32 and
  cast back to the template leaf's dtype on restore.  Container leaves,
  named by the payload registry (the bit-packed ``w_qp`` / ``w_blkp`` /
  ``w_q2``, the int8 codes ``w_pc`` / ``w_bfp`` and actsparse's block
  stack ``w_ablk``), are saved verbatim; one that would need widening (a
  bf16 ``w_ablk``) is a ``TypeError``, never a silent cast.
* **Placement** — each restored tensor goes to the device of its template
  leaf; ``placements`` (a tree of ``(mesh, placements)``, from
  :func:`repro_torch.launch.sharding.specs_placements`) or a DTensor
  template leaf places it as a DTensor again — each rank keeps its shard
  of the whole array (elastic: any mesh works).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import payload_registry
from ..core.sharded import is_dtensor, place
from ..tree import tree_items, tree_map

__all__ = ["Checkpointer"]

PyTree = Any

_SEP = "::"


# torch dtypes whose tensors become npz arrays as they are
_NPZ_NATIVE = (torch.float16, torch.float32, torch.float64, torch.int8,
               torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)


def _whole(leaf):
    """A leaf as one whole host tensor; a DTensor is gathered (every rank
    must call this for it)."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
        else torch.as_tensor(np.asarray(leaf))


def _flatten(tree: PyTree, host_id: int = 0, n_hosts: int = 1
             ) -> Dict[str, np.ndarray]:
    """Host ``host_id``'s share of the flat key -> array dict: the leaves
    at its places (mod ``n_hosts``) of the sorted key list."""
    flat = {}
    containers = payload_registry.container_leaf_names()
    items = sorted(tree_items(tree), key=lambda kv: _SEP.join(kv[0]))
    for i, (path, leaf) in enumerate(items):
        mine = i % n_hosts == host_id
        if is_dtensor(leaf) or mine:   # a DTensor gathers on every rank
            t = _whole(leaf)
        if not mine:
            continue
        key = _SEP.join(path)
        if t.dtype not in _NPZ_NATIVE:
            # npz cannot hold bf16 — store widened; restore casts back to
            # the template leaf dtype.  Integer containers (int8 codes,
            # uint8 int4x2 buffers) are npz-native and must stay verbatim:
            # one reaching this branch is a hard error, not a silent cast.
            if path[-1] in containers:
                raise TypeError(
                    f"{key}: bit-exact container leaf has non-npz-native "
                    f"dtype {t.dtype} — widening would corrupt the packed "
                    "round trip; store containers in an npz-native integer "
                    "dtype")
            t = t.to(torch.float32)
        flat[key] = t.numpy()
    return flat


def _meta(tree: PyTree) -> Dict[str, tuple]:
    """Every leaf's key -> (global shape, stored numpy dtype name), read off
    the tree without copying data (bf16 is stored widened to f32)."""
    out = {}
    for path, leaf in tree_items(tree):
        dt = leaf.dtype if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(np.asarray(leaf)).dtype
        dt = dt if dt in _NPZ_NATIVE else torch.float32
        out[_SEP.join(path)] = (
            [int(d) for d in getattr(leaf, "shape", ())],
            str(torch.empty(0, dtype=dt).numpy().dtype))
    return out


def _unflatten(template: PyTree, flat: Dict[str, np.ndarray],
               placements: PyTree = None, path=()) -> PyTree:
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, None if placements is None
                              else placements.get(k), path + (str(k),))
                for k, v in template.items()}
    if template is None:
        return None
    arr = torch.from_numpy(np.array(flat[_SEP.join(path)]))
    if isinstance(template, torch.Tensor):
        arr = arr.to(device=template.device, dtype=template.dtype)
    if placements is None and is_dtensor(template):
        placements = (template.device_mesh, template.placements)
    if placements is not None:
        mesh, pl = placements
        arr = place(arr, mesh, pl)
    return arr


def _barrier(n_hosts: int) -> None:
    if n_hosts > 1:
        import torch.distributed as dist
        dist.barrier()


class Checkpointer:
    """Host ``host_id`` of ``n_hosts``' view of the checkpoints in
    ``directory``, the newest ``keep`` kept.  With ``n_hosts > 1`` the hosts
    are the ranks of a started process group, each with its own
    Checkpointer on the same directory, and every save is collective: all
    of them call it, with the same tree."""

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1):
        if not 0 <= host_id < n_hosts:
            raise ValueError(f"host_id {host_id} outside 0..{n_hosts - 1}")
        self.dir = Path(directory)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: PyTree, *, extra: Optional[dict] = None):
        self.wait()
        self._save_sync(step, state, extra or {})

    def save_async(self, step: int, state: PyTree, *,
                   extra: Optional[dict] = None):
        self.wait()  # double-buffer: block only on the *previous* save
        # a copy even of a CPU tensor: the caller may update it in place;
        # placed leaves are gathered here, in the calling thread (a
        # collective every rank makes in the same order)
        host_state = tree_map(
            lambda t: _whole(t).clone() if is_dtensor(t)
            else t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else t, state)
        if self.n_hosts > 1:
            # the hosts meet at barriers, collectives that belong on the
            # thread that runs the training step's
            self._save_sync(step, host_state, extra or {})
            return
        self._thread = threading.Thread(
            target=self._save_sync, args=(step, host_state, extra or {}))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, step: int, state: PyTree, extra: dict):
        final = self.dir / f"step_{step:09d}"
        tmp = self.dir / f"step_{step:09d}.tmp"
        if self.host_id == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        _barrier(self.n_hosts)
        flat = _flatten(state, self.host_id, self.n_hosts)
        np.savez(tmp / f"host_{self.host_id}.npz", **flat)
        _barrier(self.n_hosts)
        if self.host_id == 0:
            every = _meta(state)
            manifest = {
                "step": step,
                "n_hosts": self.n_hosts,
                "keys": sorted(every),
                "shapes": {k: v[0] for k, v in every.items()},
                "dtypes": {k: v[1] for k, v in every.items()},
                **extra,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "COMMIT").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        _barrier(self.n_hosts)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self):
        if not self.dir.exists():
            return []
        out = []
        for d in sorted(self.dir.iterdir()):
            if d.name.startswith("step_") and not d.name.endswith(".tmp") \
                    and (d / "COMMIT").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, *, step: Optional[int] = None,
                placements: PyTree = None):
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and device, and is placed as a DTensor by
        ``placements`` (a tree of ``(mesh, placements)``; elastic: any mesh
        works) or, without one, like a DTensor template leaf.  Returns
        (state, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        flat: Dict[str, np.ndarray] = {}
        for f in sorted(d.glob("host_*.npz")):
            with np.load(f) as z:
                for k in z.files:
                    flat[k] = z[k]
        state = _unflatten(template, flat, placements)
        manifest = json.loads((d / "manifest.json").read_text())
        return state, manifest
