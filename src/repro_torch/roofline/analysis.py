"""Roofline analysis on the card's constants (`roofline/hw.py`).

Three terms per (arch x shape x mesh), all in seconds:

  compute    = FLOPs per device / 989 TFLOP/s (bf16, dense)
  memory     = bytes per device / 3.35 TB/s
  collective = per-device collective wire bytes / 450 GB/s (NVLink)

The counts come from `count_costs`, which runs a function on meta tensors
(nothing is allocated, no kernel runs) and counts what it must do, by a
definition chosen so that the count reads the same work whatever
implements it:

  FLOPs : matrix-class operations only, by `FlopCounterMode`'s registry
          (`torch.utils.flop_counter.flop_registry`: `mm`, `addmm`, `bmm`,
          `baddbmm`, convolution, scaled-dot-product attention), read per
          dispatched op.  Elementwise work and reductions are not counted.
  bytes : the function's compulsory traffic — every tensor it receives
          (parameters, inputs, caches) read once, and every tensor it
          returns or writes in place (outputs, new cache rows, gradients)
          written once.  Intermediates are not counted: an implementation
          may keep them on chip.  A received tensor counts at most its own
          size, and only the part that is read (a gather of embedding rows
          reads those rows); a tensor written in place counts the region
          written (one cache row), at most its size.

So `bytes` is a lower bound on any implementation's traffic.  That departs
on purpose from the reference, whose XLA `bytes accessed` counts every
fused operation's operands and results, intermediates included: a fused
kernel must never read as faster than its own bound.

Collective bytes follow the standard ring accounting per op
(`ring_wire_bytes`), where n is the group size:

  all-reduce        2 * size * (n-1)/n
  all-gather        out_size * (n-1)/n
  reduce-scatter    out_size * (n-1)
  all-to-all        size * (n-1)/n
  collective-permute size

On a mesh of one card there is nothing to communicate: every term is 0.
The reference's `cost_properties` and `parse_collectives` read XLA's
compiled artifacts (its cost analysis and its optimized HLO text); a torch
program has neither, so they have no counterpart here — `count_costs`
takes the place of the first, and `collective_stats` of the second's
accounting, for ops a caller lists.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hw import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def ring_wire_bytes(op: str, size: float, n: int) -> float:
    """Bytes one device puts on the wire for one collective of `size` bytes
    (the result's size) over a group of `n` devices."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if op == "all-gather":
        return size * (n - 1) / n
    if op == "reduce-scatter":
        return float(size * (n - 1))
    if op == "all-to-all":
        return size * (n - 1) / n
    if op == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    wire_bytes: float  # per device
    by_op: dict[str, float]

    def total_ops(self) -> int:
        return sum(self.counts.values())


def collective_stats(ops: Iterable[tuple[str, float, int]]) -> CollectiveStats:
    """Wire accounting of (op, size in bytes, group size) triples; groups of
    one device move nothing and are not counted."""
    counts: dict[str, int] = {}
    by_op: dict[str, float] = {}
    total = 0.0
    for op, size, n in ops:
        if n <= 1:
            continue
        wire = ring_wire_bytes(op, size, n)
        counts[op] = counts.get(op, 0) + 1
        by_op[op] = by_op.get(op, 0.0) + wire
        total += wire
    return CollectiveStats(counts, total, by_op)


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_counts: dict[str, int]
    collective_by_op: dict[str, float]
    model_flops: float  # 6·N_active·D (global, per step)
    memory_per_device: dict[str, float]  # "argument", "output"

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted global FLOPs (remat / dispatch waste)."""
        counted = self.flops_per_device * self.chips
        return self.model_flops / counted if counted else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound: useful
        FLOPs / (chips x peak x step_s)."""
        denom = self.chips * PEAK_FLOPS_BF16 * self.step_s
        return self.model_flops / denom if denom else 0.0

    def to_json(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_counts": self.collective_counts,
            "collective_by_op": self.collective_by_op,
            "model_flops": self.model_flops,
            "memory_per_device": self.memory_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck, "step_s": self.step_s,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def hbm_per_device(r: Roofline) -> float:
    m = r.memory_per_device
    return (m.get("argument", 0.0) + m.get("output", 0.0) + m.get("temp", 0.0)
            - m.get("alias", 0.0))


# ---------------------------------------------------------------------------
# Counting on the meta device
# ---------------------------------------------------------------------------


def meta(tree):
    """A tree of `(shape, dtype)` leaves (or tensors) as meta tensors."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: meta(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    shape, dtype = tree
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def tensors(tree) -> list[torch.Tensor]:
    """The tensor leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a view spans (a broadcast dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


_aten = torch.ops.aten
# in-place ops that overwrite their destination without reading it
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.index_put_,
               _aten._index_put_impl_, _aten.index_copy_, _aten.masked_fill_,
               _aten.index_fill_, _aten.masked_scatter_}
# ops that read only the part of their first argument they gather
_GATHERS = {_aten.embedding, _aten.index, _aten.index_select, _aten.gather}
_SCATTERS = {_aten.scatter_, _aten.scatter_add_, _aten.scatter_reduce_}


class _Traffic(TorchDispatchMode):
    """Counts the matrix FLOPs of an op stream and the bytes it reads from
    and writes into a set of input storages.  (`FlopCounterMode` itself
    tracks modules with gradient hooks that `torch.autograd.grad` refuses;
    its registry is read here per op instead.)"""

    def __init__(self, inputs: list[torch.Tensor]):
        super().__init__()
        self.cap: dict[int, int] = {}
        seen = set()
        for t in inputs:
            if id(t) in seen:
                continue
            seen.add(id(t))
            k = _key(t)
            self.cap[k] = min(self.cap.get(k, 0) + _distinct_bytes(t),
                              t.untyped_storage().nbytes() or _distinct_bytes(t))
        self.read: dict[int, int] = {}
        self.written: dict[int, int] = {}
        self.flops = 0

    def _written(self, func, t, args, kwargs) -> int:
        packet = func.overloadpacket
        if packet in (_aten.index_put_, _aten._index_put_impl_):
            return _aten.index.Tensor(args[0], args[1]).numel() * t.element_size()
        if packet in _SCATTERS:
            index = args[2] if len(args) > 2 else kwargs["index"]
            return index.numel() * t.element_size()
        if packet is _aten.index_copy_:
            return args[3].numel() * t.element_size()
        return _distinct_bytes(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        schema = func._schema.arguments
        pairs = list(zip(schema, args))
        by_name = {a.name: a for a in schema}
        pairs += [(by_name[k], v) for k, v in kwargs.items() if k in by_name]
        for arg, value in pairs:
            for t in tensors(value):
                k = _key(t)
                if k not in self.cap:
                    continue
                alias = arg.alias_info
                if alias is not None and alias.is_write:
                    self.written[k] = self.written.get(k, 0) + self._written(
                        func, t, args, kwargs)
                    accumulate = packet in (_aten.index_put_, _aten._index_put_impl_) \
                        and bool(args[3] if len(args) > 3 else kwargs.get("accumulate"))
                    if arg.name == "out" or (packet in _OVERWRITES and not accumulate):
                        continue
                    self.read[k] = self.read.get(k, 0) + _distinct_bytes(t)
                elif alias is not None:
                    continue  # a view: nothing is read
                elif packet in _GATHERS and arg is schema[0] \
                        and isinstance(out, torch.Tensor):
                    self.read[k] = self.read.get(k, 0) + out.numel() * t.element_size()
                else:
                    self.read[k] = self.read.get(k, 0) + _distinct_bytes(t)
        return out

    def total(self, outputs: list[torch.Tensor]) -> int:
        moved = sum(min(n, self.cap[k]) for k, n in self.read.items())
        moved += sum(min(n, self.cap[k]) for k, n in self.written.items())
        fresh: dict[int, int] = {}
        for t in outputs:
            k = _key(t)
            if k in self.cap:
                continue  # an input handed back: its writes are counted
            fresh[k] = max(fresh.get(k, 0), _distinct_bytes(t))
        return moved + sum(fresh.values())


def count_costs(fn, *args, **kwargs) -> tuple[float, float]:
    """(FLOPs, bytes) of `fn(*args, **kwargs)` on meta tensors, by the
    definition in the module docstring.  Every tensor leaf of `args` and
    `kwargs` (dicts, lists, tuples) counts as received; what `fn` returns
    counts as written unless it is a received tensor handed back."""
    inputs = tensors(list(args)) + tensors(kwargs)
    for t in inputs:
        if t.device.type != "meta":
            raise ValueError("count_costs runs on meta tensors; got one on "
                             f"{t.device}")
    traffic = _Traffic(inputs)
    with traffic:
        out = fn(*args, **kwargs)
    return float(traffic.flops), float(traffic.total(tensors(out)))
