"""Step-atomic checkpoints, in the on-disk format of
``repro.train.checkpoint``: a checkpoint written by either package restores
in the other.

Layout (one directory per step)::

    ckpt_dir/
      step_000000123/
        manifest.json        # step, n_hosts, keys, shapes, dtypes, extra
        host_0.npz           # flat key -> array, keys the dict paths
        COMMIT               # written last: a checkpoint without it is torn

* **Atomicity** — writers dump into ``step_N.tmp`` and rename after the
  COMMIT marker is in place; restore ignores directories without COMMIT.
* **Async** — ``save_async`` copies the tensors to host memory in the
  calling thread and hands them to one worker thread; the training loop
  blocks only on the previous save.
* **Dtypes** — bf16 has no numpy dtype, so it is stored widened to f32 and
  cast back to the template leaf's dtype on restore.  Container leaves,
  named by the payload registry (the bit-packed ``w_qp`` / ``w_blkp`` /
  ``w_q2``, the int8 codes ``w_pc`` / ``w_bfp`` and actsparse's block
  stack ``w_ablk``), are saved verbatim; one that would need widening (a
  bf16 ``w_ablk``) is a ``TypeError``, never a silent cast.
* **Placement** — each restored tensor goes to the device of its template
  leaf (the reference's mesh re-sharding has no one-card counterpart).
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
from ..tree import tree_items, tree_map

__all__ = ["Checkpointer"]

PyTree = Any

_SEP = "::"


# torch dtypes whose tensors become npz arrays as they are
_NPZ_NATIVE = (torch.float16, torch.float32, torch.float64, torch.int8,
               torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    flat = {}
    containers = payload_registry.container_leaf_names()
    for path, leaf in tree_items(tree):
        key = _SEP.join(path)
        t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
            else torch.as_tensor(np.asarray(leaf))
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


def _unflatten(template: PyTree, flat: Dict[str, np.ndarray],
               path=()) -> PyTree:
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, path + (str(k),))
                for k, v in template.items()}
    if template is None:
        return None
    arr = torch.from_numpy(np.array(flat[_SEP.join(path)]))
    if isinstance(template, torch.Tensor):
        return arr.to(device=template.device, dtype=template.dtype)
    return arr


class Checkpointer:
    """One host's checkpoints in ``directory``, the newest ``keep`` kept.
    The port runs on one host: it writes ``host_0.npz`` and
    ``n_hosts = 1``."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: PyTree, *, extra: Optional[dict] = None):
        self.wait()
        self._save_sync(step, state, extra or {})

    def save_async(self, step: int, state: PyTree, *,
                   extra: Optional[dict] = None):
        self.wait()  # double-buffer: block only on the *previous* save
        # a copy even of a CPU tensor: the caller may update it in place
        host_state = tree_map(
            lambda t: t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else t, state)
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
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = _flatten(state)
        np.savez(tmp / "host_0.npz", **flat)
        manifest = {
            "step": step,
            "n_hosts": 1,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            **extra,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMIT").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

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

    def restore(self, template: PyTree, *, step: Optional[int] = None):
        """Restore into the structure of ``template``: each leaf takes the
        template leaf's dtype and device.  Returns (state, manifest)."""
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
        state = _unflatten(template, flat)
        manifest = json.loads((d / "manifest.json").read_text())
        return state, manifest
