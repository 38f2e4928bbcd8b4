"""Logical-axis sharding: map model logical axes to mesh axes.

Rules are a plain dict {logical_axis: None | mesh_axis | (mesh_axes...)}
woven by the parallelization aspects (core/strategies/parallelization.py).
The default production layout (AutoShard) is Megatron-TP on
vocab/heads/mlp x FSDP on embed over data x DP batch over (pod, data), with
per-arch fallbacks for non-divisible head counts (KV replicated +
sequence-sharded caches).

A spec is a tuple with one entry per tensor dimension: None (whole), a mesh
axis, or a tuple of mesh axes — entry for entry the reference's
`PartitionSpec`.  A `NamedSharding` pairs a spec with its mesh; its
`shard_shape` is the block one device holds.  On a mesh of one card every
spec places the whole tensor on the card (`checkpoint/checkpointer.place`);
on the abstract production meshes the same rules give the per-device shapes
the dry run's memory arithmetic reads; on a live mesh (`launch/mesh.make_mesh`)
`local_shard` takes each rank's block and `gather_shards` puts the blocks
back together.  A live mesh runs the Megatron layout only (`megatron_tp`,
`embed` unsharded): `check_layout` refuses the FSDP layouts.

Everything here is shape-aware: a dim smaller than its mesh-axis extent is
left unsharded rather than relying on padding for parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.launch.mesh import Mesh, is_live
from repro_torch.nn.module import Module, flatten_specs, param_axes

Spec = tuple  # per-dim entries: None | mesh axis | tuple of mesh axes


def _axes_tuple(v) -> tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(a for a in v if a)
    return (v,)


def _mesh_extent(mesh: Mesh, axes: tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def logical_to_pspec(
    axes: tuple[str | None, ...],
    rules: Mapping[str, Any],
    mesh: Mesh,
    shape: tuple[int, ...] | None = None,
) -> Spec | None:
    """The spec for one tensor; None if nothing shards."""
    entries: list[Any] = []
    used: set[str] = set()
    any_sharded = False
    for i, logical in enumerate(axes):
        mapped = _axes_tuple(rules.get(logical)) if logical else ()
        mapped = tuple(a for a in mapped if a in mesh.shape and a not in used)
        # shape-aware: drop trailing mesh axes until the dim divides
        while mapped and shape is not None and (
            shape[i] < _mesh_extent(mesh, mapped)
            or shape[i] % _mesh_extent(mesh, mapped)
        ):
            mapped = mapped[:-1]
        if mapped:
            used.update(mapped)
            entries.append(mapped if len(mapped) > 1 else mapped[0])
            any_sharded = True
        else:
            entries.append(None)
    if not any_sharded:
        return None
    return tuple(entries)


def shard_shape(global_shape: tuple[int, ...], spec: Spec, mesh: Mesh) -> tuple[int, ...]:
    """The block of a tensor of `global_shape` one device holds under
    `spec` (missing trailing entries: whole)."""
    out = []
    for i, n in enumerate(global_shape):
        entry = spec[i] if i < len(spec) else None
        extent = _mesh_extent(mesh, _axes_tuple(entry))
        if n % extent:
            raise ValueError(f"dim {i} of {global_shape} does not divide into "
                             f"{extent} shards ({entry!r})")
        out.append(n // extent)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: Spec = ()

    def shard_shape(self, global_shape: tuple[int, ...]) -> tuple[int, ...]:
        return shard_shape(global_shape, self.spec, self.mesh)

    def splits(self, axis: str) -> bool:
        """Whether a dim of the tensor is split over the mesh axis `axis`."""
        return any(axis in _axes_tuple(entry) for entry in self.spec)


def param_shardings(model: Module, mesh: Mesh, rules: Mapping[str, Any]):
    """NamedSharding tree matching the param tree."""
    shapes = iter(spec.shape for spec in flatten_specs(model).values())

    def leaf(tree):
        if isinstance(tree, Mapping):
            return {k: leaf(v) for k, v in tree.items()}
        spec = logical_to_pspec(tree, rules, mesh, next(shapes))
        return NamedSharding(mesh, spec if spec is not None else ())

    return leaf(param_axes(model))


# ---------------------------------------------------------------------------
# Input sharding assignment (by leaf name)
# ---------------------------------------------------------------------------

_CACHE_LEAVES = {"k", "v", "ck", "cv"}


def _leaf_shape(leaf) -> tuple[int, ...]:
    """A `(shape, dtype)` pair's or a tensor's shape."""
    if isinstance(leaf, tuple):
        return tuple(leaf[0])
    return tuple(leaf.shape)


def input_shardings(spec_tree, mesh: Mesh, rules: Mapping[str, Any]):
    """Shardings for step inputs: tokens/labels/embeds/frames, caches, states.

    `spec_tree` holds `(shape, dtype)` leaves or tensors.  Cache K/V tensors
    are (..., B, S, K, D): batch over the DP axes; KV heads over model when
    the rule maps them, else the sequence dim over model (sequence-sharded
    long-context cache for KV-poor archs).
    """
    batch = _axes_tuple(rules.get("batch"))
    kvh = _axes_tuple(rules.get("kv_heads"))
    kvs = _axes_tuple(rules.get("kv_seq"))

    def assign(name: str, shape: tuple[int, ...]) -> NamedSharding:
        rank = len(shape)
        spec: list[Any] = [None] * rank

        def put(dim: int, axes: tuple[str, ...]):
            while axes:
                extent = _mesh_extent(mesh, axes)
                if shape[dim] >= extent and shape[dim] % extent == 0:
                    spec[dim] = axes if len(axes) > 1 else axes[0]
                    return
                axes = axes[:-1]

        if name in ("tokens", "labels", "positions"):
            put(0, batch)
        elif name in ("embeds", "frames", "enc"):
            put(0, batch)
        elif name in _CACHE_LEAVES and rank >= 4:
            put(rank - 4, batch)
            placed_kv = False
            if kvh and shape[rank - 2] % _mesh_extent(mesh, kvh) == 0 and \
                    shape[rank - 2] >= _mesh_extent(mesh, kvh):
                put(rank - 2, kvh)
                placed_kv = spec[rank - 2] is not None
            if not placed_kv:
                put(rank - 3, kvs)
        elif name == "wkv" and rank >= 4:  # (L?, B, H, C, C)
            put(rank - 4, batch)
        elif name == "x_prev" and rank >= 2:
            put(rank - 2, batch)
        elif name in ("lru", "conv") and rank >= 2:
            put(0 if rank == 2 else rank - 3, batch)
        # "index", "pos", "kv_pos": tiny metadata, replicated
        return NamedSharding(mesh, tuple(spec))

    def walk(tree, name: str):
        if tree is None:
            return None
        if isinstance(tree, Mapping):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        return assign(name, _leaf_shape(tree))

    return walk(spec_tree, "")


def validate_mesh_rules(mesh: Mesh, rules: Mapping[str, Any]) -> None:
    for key, val in rules.items():
        for a in _axes_tuple(val):
            if a not in mesh.shape:
                raise ValueError(f"rule {key!r} -> {val!r}: axis {a!r} not in mesh "
                                 f"{dict(mesh.shape)}")


# ---------------------------------------------------------------------------
# Shards of a live mesh
# ---------------------------------------------------------------------------


def _block(mesh: Mesh, axes: tuple[str, ...]) -> int:
    """This rank's block index along a dim sharded over `axes` (row-major
    in the entry's own order, as the reference's PartitionSpec reads)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coord(a)
    return i


def local_shard(x: torch.Tensor, sharding: NamedSharding, mesh: Mesh | None = None) -> torch.Tensor:
    """The block of `x` (the whole tensor) this rank of `mesh` (default: the
    sharding's) holds: a contiguous copy whenever it is not all of `x`."""
    mesh = mesh or sharding.mesh
    out = x
    for dim, entry in enumerate(sharding.spec):
        axes = _axes_tuple(entry)
        if not axes:
            continue
        n = out.shape[dim] // _mesh_extent(mesh, axes)
        out = out.narrow(dim, _block(mesh, axes) * n, n)
    return out.contiguous() if out is x else out.clone(memory_format=torch.contiguous_format)


def gather_shards(x: torch.Tensor, sharding: NamedSharding, mesh: Mesh | None = None) -> torch.Tensor:
    """The inverse of `local_shard`: the whole tensor on every rank, each
    block as its rank held it."""
    from repro_torch.distributed.collectives import all_gather

    mesh = mesh or sharding.mesh
    for dim, entry in enumerate(sharding.spec):
        for a in reversed(_axes_tuple(entry)):  # the innermost axis first
            x = all_gather(x, mesh, a, dim)
    return x


def tree_shards(tree, shardings, fn):
    """`fn(leaf, sharding)` over a tree and its sharding tree."""
    if isinstance(tree, Mapping):
        return {k: tree_shards(v, shardings[k], fn) for k, v in tree.items()}
    return fn(tree, shardings)


MESH_LAYOUTS_ITEM = "ROADMAP Queue 1 item 15a"


def check_layout(mesh: Mesh | None, rules: Mapping[str, Any], layout: str | None = None) -> None:
    """A live mesh of more than one rank runs the Megatron layout
    (`megatron_tp`: batch over data, heads / kv_heads / mlp / vocab over
    model, `embed` whole).  The FSDP layouts — `fsdp_sp`, `dp_fsdp`, or any
    rule that shards a weight's `embed` axis — raise."""
    if not is_live(mesh):
        return
    if layout not in (None, "megatron_tp"):
        raise NotImplementedError(
            f"the {layout!r} layout on a live mesh: only megatron_tp runs there "
            f"({MESH_LAYOUTS_ITEM}: the FSDP layouts)")
    for key in ("embed", "layers", "experts", "kv_seq", "seq_act", "res_seq"):
        if any(a in mesh.shape and mesh.shape[a] > 1 for a in _axes_tuple(rules.get(key))):
            raise NotImplementedError(
                f"rule {key!r} -> {rules.get(key)!r} shards over a live mesh axis: "
                f"only the Megatron layout runs there ({MESH_LAYOUTS_ITEM}: the FSDP "
                "and sequence-sharded layouts)")
