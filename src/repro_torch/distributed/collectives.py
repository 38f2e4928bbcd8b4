"""Collectives over a named axis of a live mesh (`launch/mesh.make_mesh`).

The reference writes no collective: XLA's partitioner puts them into the
program from the sharding constraints.  The port runs each rank's shard
eagerly, so the collectives are written here and called where GSPMD put
them for the reference's Megatron layout: an all-reduce after each
row-parallel product and the vocab-sharded embedding, the log-sum-exp of
the vocab-sharded loss, a gather of K/V heads that a tensor-parallel axis
splits, the data-parallel mean of the gradients, and rank 0's host
decisions broadcast to every rank.  Under the FSDP layouts a weight's
`embed` dim is split as well: `fsdp_gather` puts it together where it is
used, and its backward hands each rank its block of the gradient summed
over the gather's axes (a reduce-scatter).

On an axis of one rank (or no mesh) every function returns its input.  The
gloo backend reduces 16-bit floats in fp32 (exact where one rank holds the
only non-zero term, as the vocab-sharded embedding's rows do; one rounding
where partial products add).  gloo moves CUDA tensors for all-reduce and
broadcast only, so an all-gather of CUDA tensors over gloo is staged through
pinned host buffers, and gloo's reduce-scatter is written as
point-to-point sends of each rank's block (gloo has no reduce-scatter of
its own in every torch).

Every call is counted, by kind and by axis, with the bytes each rank sent
(`counts`, `reset_counts`): the port's form of the reference's
`parse_collectives(...).counts`.  FSDP's traffic is counted apart from
Megatron's, as the kinds `fsdp_gather` and `fsdp_reduce_scatter`, and the
`max` reductions of the int8 scales (a row-parallel weight's columns, a
split gradient's rows) as `all_reduce_max`, and the merge of the ranks'
partial attention under `fsdp_sp` serving (`combine_attention`) as
`attention_combine`.  The counts are this process's, i.e. one rank's.
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


def _count(kind: str, axis: str, t: torch.Tensor, share: float = 1.0) -> None:
    """One call of `kind` over `axis` that sent `share` of `t`'s bytes."""
    row = _COUNTS.setdefault(kind, {}).setdefault(axis, {"calls": 0, "bytes": 0})
    row["calls"] += 1
    row["bytes"] += int(t.numel() * t.element_size() * share)


def _dist():
    import torch.distributed as dist

    return dist


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: torch.Tensor, mesh: Mesh | None, axis: str, op: str = "sum") -> torch.Tensor:
    """The reduction of `x` over the ranks of `axis`, on every one of them
    (a new tensor; `x` is left as it was).  A sum is counted as
    `all_reduce`, another op under its own kind (`all_reduce_max`)."""
    if not is_parallel(mesh, axis):
        return x
    dist = _dist()
    widen = mesh.backend == "gloo" and x.dtype in (torch.bfloat16, torch.float16)
    out = x.to(torch.float32) if widen else x.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.group(axis))
    _count("all_reduce" if op == "sum" else f"all_reduce_{op}", axis, out)
    return out.to(x.dtype) if widen else out


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A host copy of a CUDA tensor in page-locked memory (PyTorch's
    caching host allocator keeps and reuses the buffers): the copies to and
    from the card run at the link's rate, not at pageable memory's."""
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x)


def all_gather(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int,
               kind: str = "all_gather") -> torch.Tensor:
    """The ranks' `x` along `axis`, concatenated on `dim` in rank order, on
    every rank: bit for bit each rank's block.  Counted under `kind`.  A
    CUDA tensor over gloo goes through pinned host buffers, and only the
    other ranks' blocks come back to the card."""
    if not is_parallel(mesh, axis):
        return x
    dist = _dist()
    staged = mesh.backend == "gloo" and x.device.type == "cuda"
    src = _pinned(x.contiguous()) if staged else x.contiguous()
    raw = src.view(torch.uint8)  # a gather copies bits, whatever the type
    parts = [torch.empty(raw.shape, dtype=torch.uint8, device=raw.device, pin_memory=staged)
             for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, raw, group=mesh.group(axis))
    _count(kind, axis, raw)
    if not staged:
        return torch.cat([p.view(src.dtype) for p in parts], dim=dim)
    n, me = x.shape[dim], mesh.coord(axis)
    shape = list(x.shape)
    shape[dim] = n * len(parts)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for j, p in enumerate(parts):
        out.narrow(dim, j * n, n).copy_(x if j == me else p.view(x.dtype))
    return out


def reduce_scatter(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int) -> torch.Tensor:
    """This rank's block on `dim` of the sum of `x` over the ranks of
    `axis` (the blocks in rank order, as `all_gather` joins them).  NCCL
    reduce-scatters; over gloo each rank sends every other rank that rank's
    block and adds the blocks it receives to its own (16-bit floats sent
    as they are and added in fp32; a CUDA tensor's blocks staged through
    pinned host buffers and added on the card)."""
    if not is_parallel(mesh, axis):
        return x
    dist = _dist()
    n, me, group = mesh.shape[axis], mesh.coord(axis), mesh.group(axis)
    size = x.shape[dim] // n
    _count("fsdp_reduce_scatter", axis, x, (n - 1) / n)  # every block but its own
    if mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((size, *src.shape[1:]), dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim).contiguous()
    staged = x.device.type == "cuda"
    blocks = list(x.split(size, dim))
    got = [None] * n
    ops = []
    for j in range(n):
        if j != me:
            peer = dist.get_global_rank(group, j)
            send = _pinned(blocks[j].contiguous()) if staged else blocks[j].contiguous()
            got[j] = torch.empty(send.shape, dtype=send.dtype, pin_memory=staged)
            ops += [dist.P2POp(dist.isend, send, peer, group),
                    dist.P2POp(dist.irecv, got[j], peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    # the blocks move as they are; the sum is taken in fp32 for 16-bit floats,
    # on the tensor's own device
    widen = x.dtype in (torch.bfloat16, torch.float16)
    mine = blocks[me].to(torch.float32) if widen else blocks[me].clone()
    for j in range(n):
        if j != me:
            mine += got[j].to(x.device)
    return mine.to(x.dtype) if widen else mine


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


def on_rank_zero(fn, mesh: Mesh | None):
    """`fn()` off a live mesh; on one, rank 0's `fn()` on every rank (the
    others do not call it): a host decision only rank 0 makes."""
    if not is_live(mesh):
        return fn()
    return broadcast_object(fn() if mesh.rank == 0 else None, mesh)


def barrier(mesh: Mesh | None) -> None:
    """Every rank of the mesh waits for the others (nothing off a live mesh)."""
    if is_live(mesh):
        _dist().barrier()


def merge_attention(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Partial attentions over disjoint shares of the keys merged in the
    order of their leading dim: `o` (n, ..., D) and `lse` (n, ...), each
    partial normalised over its share, `lse = m + log l` (-inf where a share
    saw nothing).  M = max lse, w_r = exp(lse_r - M), o = sum_r w_r o_r /
    sum_r w_r, the sums taken in order in fp32 (0 where no share saw a
    key)."""
    o, lse = o.to(torch.float32), lse.to(torch.float32)
    M = torch.amax(lse, dim=0)
    Mu = torch.where(M == -torch.inf, torch.zeros_like(M), M)
    num = torch.zeros_like(o[0])
    den = torch.zeros_like(lse[0])
    for r in range(o.shape[0]):
        w = torch.exp(lse[r] - Mu)
        num = num + w[..., None] * o[r]
        den = den + w
    return num / torch.clamp(den, min=1e-30)[..., None]


def combine_attention(o: torch.Tensor, lse: torch.Tensor, mesh: Mesh | None,
                      axis: str) -> torch.Tensor:
    """The attention over every rank's share of the keys from this rank's
    `o` (B, S, H, D) and its `lse` (B, S, H), both fp32 and normalised over
    its own share: one all-gather of `(o, lse)` over `axis` (B·S·H·(D + 1)
    floats a rank, counted as `attention_combine`), merged in rank order
    (`merge_attention`): the same bits on every rank, fp32."""
    if not is_parallel(mesh, axis):
        return o.to(torch.float32)
    packed = torch.cat([o.to(torch.float32), lse.to(torch.float32)[..., None]], dim=-1)
    parts = all_gather(packed[None], mesh, axis, 0, kind="attention_combine")
    return merge_attention(parts[..., :-1], parts[..., -1])


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


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim, kind="fsdp_gather")

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SeqBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = x.shape[dim] // mesh.shape[axis]
        return x.narrow(dim, mesh.coord(axis) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


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


def fsdp_gather(x: torch.Tensor, mesh: Mesh | None, axes: tuple[str, ...],
                dim: int) -> torch.Tensor:
    """A weight's FSDP block made whole on `dim`, split there over `axes`
    (row-major, as `sharding.local_shard` splits it): gathered over the
    innermost axis first.  Backward: this rank's block of the gradient
    summed over `axes` (a reduce-scatter per axis, outermost first), so the
    gradient of an FSDP leaf comes out already summed over the ranks of
    `axes`."""
    for axis in reversed(axes):
        if is_parallel(mesh, axis):
            x = _FsdpGather.apply(x, mesh, axis, dim)
    return x


def seq_block(x: torch.Tensor, mesh: Mesh | None, axis: str, dim: int) -> torch.Tensor:
    """This rank's block on `dim` of a tensor every rank of `axis` holds
    whole and alike (the sequence-parallel split of a replicated activation);
    backward: the ranks' gradient blocks gathered, so every rank holds the
    whole tensor's gradient, as it holds the whole tensor."""
    if not is_parallel(mesh, axis):
        return x
    return _SeqBlock.apply(x, mesh, axis, dim)
