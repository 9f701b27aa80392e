"""Activation sharding hints (sequence / context parallelism).

``hint(x, spec)`` redistributes a DTensor activation to the placements of
``spec`` (a sharding-rule spec, :mod:`repro_torch.launch.sharding`) on its
own mesh, dropping the axes that mesh lacks, as the reference's
``with_sharding_constraint`` hint does; a plain tensor (one process, CPU
tests) passes through untouched.  The data axes that ``spec`` does not
name keep their placement: the batch stays sharded over them (the
reference's hints name only ``model``; GSPMD would otherwise gather the
batch).  This is how the configuration's
activation folding (``cfg.seq_shard``) reaches the model code without
threading a mesh through it.
"""
from __future__ import annotations

from ..core.sharded import is_dtensor

__all__ = ["hint", "seq_shard_hint"]


def hint(x, spec):
    """``x`` redistributed to ``spec`` where ``x`` is a DTensor."""
    if not is_dtensor(x):
        return x
    from ..launch.mesh import data_axes
    from ..launch.sharding import placements

    names = set(x.device_mesh.mesh_dim_names or ())
    fixed = []
    for ax in tuple(spec) + (None,) * (x.ndim - len(tuple(spec))):
        if isinstance(ax, (tuple, list)):
            keep = tuple(a for a in ax if a in names)
            fixed.append(keep if keep else None)
        else:
            fixed.append(ax if ax in names else None)
    mesh = x.device_mesh
    want = placements(tuple(fixed[:x.ndim]), mesh)
    named = {a for ax in fixed for a in (ax if isinstance(ax, tuple)
                                         else (ax,)) if a is not None}
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in data_axes(mesh) and name not in named:
            want[i] = x.placements[i]
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def seq_shard_hint(x, enabled: bool):
    """Sequence parallelism: shard the T axis of (B, T, D) over
    ``model``."""
    if not enabled:
        return x
    return hint(x, (None, "model", None))
