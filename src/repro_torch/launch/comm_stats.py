"""Per-device roofline terms read from a dispatch trace: the counterpart of
``repro.launch.hlo_stats``, which parses XLA's partitioned HLO text.
PyTorch has no HLO; a step traced over DTensors (``Recorder``) sees what
each rank would run instead:

- every ``_c10d_functional`` collective DTensor issues, with its local
  shapes and its group's size;
- every op on DTensors, whose FLOPs come from ``torch.utils.
  flop_counter``'s registry on the global shapes, scaled to one device:
  ×1/size for every mesh dim on which the output is ``Shard`` or
  ``Partial`` (the work is split there, not repeated);
- every op on plain (local) tensors: the bytes it reads and writes (each
  input read once, each output written once; views, allocations and
  collectives move none), its FLOPs where it is not part of a DTensor op,
  and the live local bytes, whose maximum is the trace's peak.  K4, K5
  and K6 are such ops on the meta device (``torch.ops.repro_torch.*``,
  each with its FLOPs in the registry), called on local shards.

The bytes are unfused, per aten op: a sum over the ops a rank would run
one at a time, not XLA's ``bytes accessed`` of fused HLO.

For each collective the per-device bytes on the wire follow the ring
model of ``hlo_stats``:

    all-reduce       2·(g-1)/g · bytes(operand)
    all-gather       (g-1)/g   · bytes(output)
    reduce-scatter   (g-1)/g   · bytes(operand)
    all-to-all       (g-1)/g   · bytes(operand)
    collective-permute           bytes(operand)

where g is the group size; the raw (unweighted) operand bytes are kept
for reference.
"""
from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the _c10d_functional ops and the ring model's kinds
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "wait_tensor", "_wrap_tensor_autograd", "detach", "lift_fresh"}


@dataclass
class CollectiveStats:
    per_device_bytes: float = 0.0  # ring-weighted wire bytes per device
    raw_bytes: float = 0.0         # unweighted operand/output bytes
    count: int = 0
    by_kind: Dict[str, float] = field(default_factory=dict)
    ops: List[dict] = field(default_factory=list)


def collective_stats(records: Iterable[dict], total_devices: int,
                     keep_ops: bool = False) -> CollectiveStats:
    """``records``: ``{"kind", "operand_bytes", "output_bytes", "group"}``
    per collective (``group`` 0 or missing: all ``total_devices``)."""
    stats = CollectiveStats()
    for r in records:
        kind = r["kind"]
        operand_bytes, out_bytes = r.get("operand_bytes", 0), r.get("output_bytes", 0)
        g = r.get("group") or total_devices
        frac = (g - 1) / g if g > 1 else 0.0
        if kind == "all-reduce":
            wire = 2.0 * frac * (operand_bytes or out_bytes)
            raw = operand_bytes or out_bytes
        elif kind == "all-gather":
            wire = frac * out_bytes
            raw = out_bytes
        elif kind == "reduce-scatter":
            wire = frac * (operand_bytes or out_bytes * g)
            raw = operand_bytes or out_bytes * g
        elif kind in ("all-to-all", "ragged-all-to-all"):
            wire = frac * (operand_bytes or out_bytes)
            raw = operand_bytes or out_bytes
        else:  # collective-permute
            wire = float(operand_bytes or out_bytes)
            raw = operand_bytes or out_bytes
        stats.per_device_bytes += wire
        stats.raw_bytes += raw
        stats.count += 1
        stats.by_kind[kind] = stats.by_kind.get(kind, 0.0) + wire
        if keep_ops:
            stats.ops.append({"kind": kind, "bytes": raw, "group": g})
    return stats


def op_histogram(trace: Iterable[str]) -> Dict[str, int]:
    """Counts of each op in a dispatch trace (``Recorder.trace``)."""
    return dict(Counter(trace))


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """A collective's group size: from its group's name (its last string
    argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, type) and issubclass(t, DTensor)


def _is_fake_type(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, type) and issubclass(t, FakeTensor)


def _flops(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry

    fn = flop_registry.get(func._overloadpacket)
    if fn is None:
        return 0.0
    return float(fn(*args, **kwargs, out_val=out))


def _split_factor(out) -> int:
    """How many ways a DTensor output's work is split: the product of the
    mesh dims on which it is ``Shard`` or ``Partial``."""
    t = next((x for x in _tensors(out) if hasattr(x, "placements")), None)
    if t is None:
        return 1
    n = 1
    for m, p in enumerate(t.placements):
        if p.is_shard() or p.is_partial():
            n *= t.device_mesh.shape[m]
    return n


class _Local(TorchDispatchMode):
    """The ops DTensor runs on local shards: bytes, collectives, memory."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented  # let DTensor run it; its local ops come back here
        if any(_is_fake_type(t) for t in types):
            return func(*args, **kwargs)  # DTensor's shape propagation
        out = func(*args, **kwargs)
        self.rec._local_op(func, args, kwargs, out, count_flops=False)
        return out


class Recorder(TorchDispatchMode):
    """Records a step traced over DTensors (or plain tensors): per-device
    ``flops``, ``bytes`` and collective ``records``, the live local bytes'
    ``peak``, and the ``trace`` of op names (DTensor ops, ``dtensor:``
    before their names, and the local ops they run)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.records: List[dict] = []
        self.trace: List[str] = []
        self.live = 0
        self.peak = 0
        self._local = _Local(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            with self._local:
                out = func(*args, **kwargs)
            self.trace.append(f"dtensor:{func}")
            self.flops += _flops(func, args, kwargs, out) / _split_factor(out)
            return out
        if any(_is_fake_type(t) for t in types):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._local_op(func, args, kwargs, out, count_flops=True)
        return out

    def _local_op(self, func, args, kwargs, out, count_flops: bool) -> None:
        name = func.__name__.split(".")[0]
        ns = func.namespace
        self.trace.append(str(func))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if ns == "_c10d_functional" and name in _KINDS:
            self.records.append({
                "kind": _KINDS[name], "op": name,
                "operand_bytes": sum(_nbytes(t) for t in ins),
                "output_bytes": sum(_nbytes(t) for t in outs),
                "group": _group_size(args),
            })
            self._alloc(outs)
            return
        if name in _FREE or func.is_view or ns == "_c10d_functional":
            return
        if count_flops:
            self.flops += _flops(func, args, kwargs, out)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        in_ids = {id(t) for t in ins}
        self._alloc([t for t in outs if id(t) not in in_ids])  # in place: no new bytes

    def _alloc(self, outs) -> None:
        for t in outs:
            n = _nbytes(t)
            if not n:
                continue
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


def local_bytes(tree) -> int:
    """The bytes one rank holds of a tree's tensors (a DTensor's local
    shard)."""
    return int(sum(_nbytes(getattr(t, "_local_tensor", t)) for t in _tensors(tree)))
