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
back together.  A live mesh runs AutoShard's three layouts (`check_layout`
says what it still refuses): Megatron's (`megatron_tp`, its `embed` whole or
split over the batch axes; a MoE layer's experts replicated, each expert's
`mlp` dim split over `model`), `dp_fsdp` and `fsdp_sp`, whose KV caches and
page pools are split over `kv_seq` (`seq_share`).  A weight split on its
`embed` dim is an FSDP block: `gather_plan` lists those dims, and the model
gathers them where the weight is used (`gather_tree`), never keeping a
gathered copy.

Everything here is shape-aware: a dim smaller than its mesh-axis extent is
left unsharded rather than relying on padding for parameters.  So under
`fsdp_sp` a vocab the sequence axis does not divide (whisper-small's 51865,
internvl2-1b's 151655) leaves the embedding table and the head whole in
their vocab dim on every rank, as GSPMD lays out the reference's rules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.launch.mesh import Mesh, is_live
from repro_torch.nn.module import Module, _flat_leaves, flatten_specs, param_axes

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

    def axes(self) -> tuple[str, ...]:
        """Every mesh axis of more than one rank some dim of the tensor is
        split over (`data`, `model` or both), in the spec's order."""
        return tuple(a for entry in self.spec for a in _axes_tuple(entry)
                     if self.mesh.shape.get(a, 1) > 1)

    def dim_axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes of more than one rank that split dim `dim` (none
        where the spec leaves it whole; a spec of the param tree has an
        entry for every dim, or none)."""
        entry = self.spec[dim] if -len(self.spec) <= dim < len(self.spec) else None
        return tuple(a for a in _axes_tuple(entry) if self.mesh.shape.get(a, 1) > 1)


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


def block_coords(sharding: NamedSharding, mesh: Mesh | None = None) -> tuple[int, ...]:
    """This rank's block index along each dim the spec of `sharding` names
    (0 along a whole dim; () for a replicated tensor)."""
    mesh = mesh or sharding.mesh
    return tuple(_block(mesh, _axes_tuple(entry)) if entry is not None else 0
                 for entry in sharding.spec)


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


# ---------------------------------------------------------------------------
# FSDP: weights gathered where they are used
# ---------------------------------------------------------------------------

FSDP_AXIS = "embed"  # the logical axis every FSDP layout splits


def gather_plan(model: Module, mesh: Mesh, rules: Mapping[str, Any]):
    """A tree shaped like the param tree: for each leaf, `((dim, axes),
    ...)` — the dims whose logical axis is `embed` and which the rules
    split on the live `mesh`, with the axes they are split over.  None when
    no leaf has one (Megatron's layout with `embed` whole): nothing is
    gathered then.  Cached on the model per mesh and rules."""
    if not is_live(mesh):
        return None
    key = (mesh.axis_names, mesh.axis_sizes, mesh.coords,
           tuple(sorted((k, repr(v)) for k, v in rules.items())))
    cache = model.__dict__.setdefault("_gather_plans", {})
    if key not in cache:
        shardings = param_shardings(model, mesh, rules)

        def walk(sh, axes):
            if isinstance(sh, Mapping):
                return {k: walk(sh[k], axes[k]) for k in sh}
            return tuple((d, _axes_tuple(entry)) for d, (entry, name)
                         in enumerate(zip(sh.spec, axes))
                         if name == FSDP_AXIS and entry is not None)

        plan = walk(shardings, param_axes(model))
        cache[key] = plan if any(_flat_leaves(plan)) else None
    return cache[key]


def gather_tree(tree, plan, mesh: Mesh | None, lead: int = 0):
    """`tree` with every FSDP dim of `plan` gathered (differentiably:
    `collectives.fsdp_gather`).  `lead`: the leading dims the leaves have
    lost against the plan's (1 for one layer's slice of a stacked tree).
    A None plan returns `tree` itself."""
    if plan is None or tree is None:
        return tree
    from repro_torch.distributed.collectives import fsdp_gather

    if isinstance(tree, Mapping):
        return {k: gather_tree(v, plan[k], mesh, lead) for k, v in tree.items()}
    for dim, axes in plan:
        tree = fsdp_gather(tree, mesh, axes, dim - lead)
    return tree


def seq_axis(mesh: Mesh | None, rules: Mapping[str, Any]) -> str | None:
    """The mesh axis `fsdp_sp` splits the residual stream's sequence over
    (`res_seq`), when it spans ranks of a live mesh; else None."""
    axes = _axes_tuple(rules.get("res_seq"))
    if len(axes) == 1 and is_live(mesh) and mesh.shape.get(axes[0], 1) > 1:
        return axes[0]
    return None


def live_axes(mesh: Mesh, value) -> tuple[str, ...]:
    """The axes of a rule's value that span more than one rank of `mesh`."""
    return tuple(a for a in _axes_tuple(value) if mesh.shape.get(a, 1) > 1)


def grad_axes(mesh: Mesh, rules: Mapping[str, Any]) -> tuple[tuple[str, ...], int]:
    """(the axes a gradient is summed over, the count it is divided by):
    the axes whose ranks hold other tokens — the batch's, and under
    `fsdp_sp` the sequence's — and the extent of the batch's axes, over
    which the ranks' losses are the terms of the mean (the ranks of a
    sequence-parallel axis add up one loss)."""
    batch = live_axes(mesh, rules.get("batch"))
    seq = seq_axis(mesh, rules)
    axes = batch + ((seq,) if seq and seq not in batch else ())
    return axes, _mesh_extent(mesh, batch)


def kv_seq_axis(mesh: Mesh | None, rules: Mapping[str, Any]) -> str | None:
    """The mesh axis `fsdp_sp` splits the KV caches' and page pools'
    sequence over (`kv_seq`), when it spans ranks of a live mesh; else None."""
    axes = _axes_tuple(rules.get("kv_seq"))
    if len(axes) == 1 and is_live(mesh) and mesh.shape.get(axes[0], 1) > 1:
        return axes[0]
    return None


def seq_share(mesh: Mesh | None, rules: Mapping[str, Any],
              length: int) -> tuple[int, int, int] | None:
    """This rank's share of a cache dim of `length` slots split over
    `kv_seq`: `(sub, span, phase)`, where the rank's slot l holds the
    dim's slot `(l // sub) * span + phase + l % sub`.  A dense cache is one
    span (`length` = T: the rank's contiguous block `[phase, phase + sub)`,
    the block `input_shardings` gives its sequence dim); a page pool's
    `length` is the page size, and the rank holds slots `[phase, phase +
    sub)` of every page.  None where the dim stays whole: off a live mesh,
    with `kv_seq` unset, or a length the axis does not divide (the rules'
    shape-aware drop)."""
    axis = kv_seq_axis(mesh, rules)
    if axis is None:
        return None
    n = mesh.shape[axis]
    if length < n or length % n:
        return None
    sub = length // n
    return sub, length, mesh.coord(axis) * sub


MESH_LAYOUTS_ITEM = "ROADMAP Queue 1 item 15a"
SEQ_MEGATRON_ITEM = "ROADMAP Queue 1 item 15a-iii"


def check_layout(mesh: Mesh | None, rules: Mapping[str, Any],
                 layout: str | None = None) -> None:
    """A live mesh of more than one rank runs AutoShard's three layouts:
    `megatron_tp` (its `embed` whole or split over the batch's axes),
    `dp_fsdp` and `fsdp_sp`, for training and serving alike.  It refuses the
    Korthikanti residuals and sequence-split caches under Megatron, an FSDP
    split over an axis whose ranks hold the same tokens (its gathered
    gradient would add copies), and rules no layout of AutoShard sets (a
    split layer stack or expert axis)."""
    if not is_live(mesh):
        return
    layout = layout or "megatron_tp"
    if layout not in ("megatron_tp", "dp_fsdp", "fsdp_sp"):
        raise ValueError(f"unknown layout {layout!r}")
    for key in ("layers", "experts"):
        if live_axes(mesh, rules.get(key)):
            raise NotImplementedError(
                f"rule {key!r} -> {rules.get(key)!r} shards over a live mesh axis: no "
                "layout of AutoShard splits it (a MoE layer's experts stay replicated, "
                "tensor-parallel inside: ROADMAP Queue 1 item 15b)")
    if layout == "fsdp_sp":
        if seq_axis(mesh, rules) is None or live_axes(mesh, rules.get("seq_act")) != \
                live_axes(mesh, rules.get("res_seq")):
            raise NotImplementedError(
                "fsdp_sp on a live mesh splits the residual stream and the activations "
                f"over one axis (res_seq == seq_act): {dict(rules)}")
        for key in ("heads", "kv_heads", "mlp"):
            if live_axes(mesh, rules.get(key)):
                raise NotImplementedError(
                    f"fsdp_sp with rule {key!r} -> {rules.get(key)!r}: its blocks' "
                    "weights are whole or FSDP blocks, not tensor-parallel")
        kv = live_axes(mesh, rules.get("kv_seq"))
        if kv and kv != live_axes(mesh, rules.get("res_seq")):
            raise NotImplementedError(
                f"fsdp_sp with rule 'kv_seq' -> {rules.get('kv_seq')!r}: the caches split "
                "over the residual stream's sequence axis or stay whole")
    else:
        for key in ("kv_seq", "seq_act", "res_seq"):
            if live_axes(mesh, rules.get(key)):
                raise NotImplementedError(
                    f"rule {key!r} -> {rules.get(key)!r} under {layout}: sequence-"
                    f"sharded residuals and caches run under fsdp_sp only "
                    f"({SEQ_MEGATRON_ITEM})")
    tokens, _ = grad_axes(mesh, rules)
    stray = [a for a in live_axes(mesh, rules.get(FSDP_AXIS)) if a not in tokens]
    if stray:
        raise NotImplementedError(
            f"rule 'embed' -> {rules.get(FSDP_AXIS)!r} under {layout}: an FSDP split over "
            f"{stray}, whose ranks hold the same tokens, would add the copies of one "
            f"gradient ({MESH_LAYOUTS_ITEM})")
