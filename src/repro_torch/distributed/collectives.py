"""Collectives over a named axis of a live mesh (`launch/mesh.make_mesh`).

The reference writes no collective: XLA's partitioner puts them into the
program from the sharding constraints.  The port runs each rank's shard
eagerly, so the collectives are written here and called where GSPMD put
them for the reference's Megatron layout: an all-reduce after each
row-parallel product and the vocab-sharded embedding, the log-sum-exp of
the vocab-sharded loss, a gather of K/V heads that a tensor-parallel axis
splits, the data-parallel mean of the gradients, and rank 0's host
decisions broadcast to every rank.

On an axis of one rank (or no mesh) every function returns its input.  The
gloo backend reduces 16-bit floats in fp32 (exact where one rank holds the
only non-zero term, as the vocab-sharded embedding's rows do; one rounding
where partial products add).  gloo moves CUDA tensors for all-reduce and
broadcast only, so an all-gather of CUDA tensors over gloo is staged through
the host.

Every call is counted, by kind and by axis, with the bytes each rank sent
(`counts`, `reset_counts`): the port's form of the reference's
`parse_collectives(...).counts`.  The counts are this process's, i.e. one
rank's.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh, is_live, is_parallel

_COUNTS: dict[str, dict[str, dict[str, int]]] = {}


def counts() -> dict[str, dict[str, dict[str, int]]]:
    """{kind: {axis: {"calls": n, "bytes": b}}} since the last reset."""
    return {k: {a: dict(v) for a, v in by_axis.items()} for k, by_axis in _COUNTS.items()}


def reset_counts() -> None:
    _COUNTS.clear()


def _count(kind: str, axis: str, t: torch.Tensor) -> None:
    row = _COUNTS.setdefault(kind, {}).setdefault(axis, {"calls": 0, "bytes": 0})
    row["calls"] += 1
    row["bytes"] += t.numel() * t.element_size()


def _dist():
    import torch.distributed as dist

    return dist


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, mesh: Mesh | None, axis: str, op: str = "sum") -> torch.Tensor:
    """The reduction of `x` over the ranks of `axis`, on every one of them
    (a new tensor; `x` is left as it was)."""
    if not is_parallel(mesh, axis):
        return x
    dist = _dist()
    widen = mesh.backend == "gloo" and x.dtype in (torch.bfloat16, torch.float16)
    out = x.to(torch.float32) if widen else x.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.group(axis))
    _count("all_reduce", axis, out)
    return out.to(x.dtype) if widen else out


def all_gather(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int) -> torch.Tensor:
    """The ranks' `x` along `axis`, concatenated on `dim` in rank order, on
    every rank: bit for bit each rank's block."""
    if not is_parallel(mesh, axis):
        return x
    dist = _dist()
    staged = mesh.backend == "gloo" and x.device.type == "cuda"
    src = (x.cpu() if staged else x).contiguous()
    raw = src.view(torch.uint8)  # a gather copies bits, whatever the type
    parts = [torch.empty_like(raw) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, raw, group=mesh.group(axis))
    _count("all_gather", axis, raw)
    out = torch.cat([p.view(src.dtype) for p in parts], dim=dim)
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, mesh: Mesh | None, axis: str | None = None) -> torch.Tensor:
    """`x` as the first rank of `axis` (None: of the whole mesh) holds it,
    written into `x` on every other rank."""
    if not is_live(mesh) or (axis is not None and not is_parallel(mesh, axis)):
        return x
    dist = _dist()
    group = None if axis is None else mesh.group(axis)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(x, src, group=group)
    _count("broadcast", axis or "world", x)
    return x


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's `obj` (anything that pickles) on every rank of the mesh:
    how rank 0's host decisions reach the other ranks."""
    if not is_live(mesh):
        return obj
    dist = _dist()
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    row = _COUNTS.setdefault("broadcast_object", {}).setdefault(
        "world", {"calls": 0, "bytes": 0})
    row["calls"] += 1
    return box[0]


def barrier(mesh: Mesh | None) -> None:
    """Every rank of the mesh waits for the others (nothing off a live mesh)."""
    if is_live(mesh):
        _dist().barrier()


# ---------------------------------------------------------------------------
# Differentiable forms (Megatron's conjugate pair, and the gather)
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        # every rank used the whole tensor its own way: the gradient of this
        # rank's block is its block of the sum over ranks
        total = all_reduce(g.contiguous(), ctx.mesh, ctx.axis)
        mine = total.narrow(ctx.dim, ctx.mesh.coord(ctx.axis) * ctx.n, ctx.n)
        return mine.contiguous(), None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over `axis`.  Where a
    replicated activation enters column-parallel products."""
    if not is_parallel(mesh, axis):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh | None, axis: str) -> torch.Tensor:
    """All-reduce (sum) forward; the gradient passed as it is.  Where
    row-parallel partial products add into a replicated activation."""
    if not is_parallel(mesh, axis):
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int) -> torch.Tensor:
    """All-gather on `dim` forward; each rank's block of the summed gradient
    backward."""
    if not is_parallel(mesh, axis):
        return x
    return _GatherFrom.apply(x, mesh, axis, dim)
