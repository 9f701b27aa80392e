"""Per-device operation counts of a step run on meta tensors: the port's
counterpart of the reference's HLO analysis (``repro.launch.hlo_analysis``,
which parses XLA's optimized HLO text and has no torch meaning, so it is
not ported).

:class:`OpCosts` is a ``TorchDispatchMode`` that sees every operation a
step dispatches and counts, by the reference's definitions
(``hlo_analysis.py:14-21``):

* ``flops`` — the products' FLOPs (``torch.utils.flop_counter``'s formulas
  for ``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention);
* ``traffic_bytes`` — a fusion-optimal HBM estimate: operand and output
  bytes of the products, output bytes of gathers (index, gather,
  embedding, sort), the update bytes of scatters and cache writes
  (``index_put_``, ``scatter``, ``index_add_``, ``index_copy_``) and the
  output bytes of collectives; elementwise chains are taken as fused;
* ``collectives`` — output bytes by kind (all-gather, all-reduce,
  reduce-scatter, all-to-all, collective-permute);
* ``traffic_by_scope`` — the traffic of the operations run inside a
  ``torch.profiler.record_function`` range, keyed by the range: while the
  mode counts, the attention reads of :mod:`repro_torch.core.dispatch`
  name theirs (``attention.flash``, ``attention.packed``:
  ``dispatch.NAMED_RANGES``).

**Local operations only.**  On a DTensor the mode sees each operation
three ways: the DTensor-level call (global shapes), the sharding
propagation's shape inference (``FakeTensor`` arguments, global shapes)
and the local call on each rank's shard.  Only the last is what a device
runs: the mode returns ``NotImplemented`` for a DTensor-level call (so
DTensor runs and desugars it into local operations and collectives, which
the mode then sees) and skips any call on ``FakeTensor`` arguments.
Counting all three would add the global count to the local one (torch's
own ``FlopCounterMode`` counts the DTensor-level call).  The bodies of
``local_map`` run on local tensors and count as they are.

An operation outside ATen and the collectives (a custom op, whose cost the
mode cannot know) raises instead of counting 0.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["COLLECTIVE_KINDS", "OpCosts"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_GATHERS = {"index", "index_select", "gather", "embedding", "sort",
            "take_along_dim", "_unsafe_index"}
# scatter-like writes: the argument that holds the written values
_SCATTERS = {"index_put": "values", "index_put_": "values",
             "_index_put_impl_": "values", "scatter": "src",
             "scatter_": "src", "scatter_add": "src", "scatter_add_": "src",
             "index_add": "source", "index_add_": "source",
             "index_copy": "source", "index_copy_": "source",
             "masked_scatter": "source", "masked_scatter_": "source"}
_NAMESPACES = {"aten", "prims", "profiler", "_c10d_functional", "c10d",
               "c10d_functional", "_dtensor"}


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(a, FakeTensor) for a in tree_leaves(args))


class OpCosts(TorchDispatchMode):
    """Count a region's per-device FLOPs, traffic and collectives (see the
    module docstring).  After the region: :attr:`flops`,
    :attr:`traffic_bytes`, :attr:`collectives` (bytes by kind),
    :attr:`traffic_by_scope`, :attr:`flops_by_op`, and :meth:`record` for
    all of them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.traffic_bytes = 0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
        self.traffic_by_scope: Dict[str, int] = defaultdict(int)
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self._scopes = []

    def __enter__(self):
        from ..core import dispatch

        self._ranges, dispatch.NAMED_RANGES = dispatch.NAMED_RANGES, True
        return super().__enter__()

    def __exit__(self, *exc):
        from ..core import dispatch

        dispatch.NAMED_RANGES = self._ranges
        return super().__exit__(*exc)

    def _traffic(self, n: int) -> None:
        self.traffic_bytes += n
        for s in set(self._scopes):
            self.traffic_by_scope[s] += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns not in _NAMESPACES:
            raise RuntimeError(
                f"no cost formula for {func}: a custom op must be counted at "
                "its wrapper, or run its plain version on meta tensors")
        if ns == "profiler":
            if name == "_record_function_enter_new":
                self._scopes.append(str(args[0]))
            elif name == "_record_function_exit" and self._scopes:
                self._scopes.pop()
            return out
        if _is_fake((args, kwargs)):
            return out      # DTensor's sharding propagation: global shapes
        packet = func._overloadpacket
        if packet in self._formulas:
            f = int(self._formulas[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[name] += f
            self._traffic(sum(_bytes(a) for a in tree_leaves((args, kwargs)))
                          + sum(_bytes(o) for o in tree_leaves(out)))
        elif name in _KIND and ns != "aten":
            kind = _KIND[name]
            n = sum(_bytes(o) for o in tree_leaves(out))
            self.collectives[kind] = self.collectives.get(kind, 0) + n
            self._traffic(n)
        elif name in _GATHERS:
            self._traffic(sum(_bytes(o) for o in tree_leaves(out)))
        elif name in _SCATTERS:
            src = kwargs.get(_SCATTERS[name])
            if src is None:
                src = args[2] if name.startswith(("index_put", "_index_put")) \
                    else args[-1]
            self._traffic(sum(_bytes(t) for t in tree_leaves(src)))
        return out

    @property
    def collective_bytes(self) -> int:
        return sum(self.collectives.values())

    def record(self) -> dict:
        return {"flops_per_device": self.flops,
                "traffic_bytes_per_device": self.traffic_bytes,
                "traffic_by_scope": dict(self.traffic_by_scope),
                "collective_bytes_per_device": self.collective_bytes,
                "collectives": dict(self.collectives),
                "flops_by_op": dict(self.flops_by_op)}
