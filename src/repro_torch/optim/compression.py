"""int8 gradient compression with error feedback.

Across cards the int8 representation (plus one fp32 scale per tensor row) is
what would cross the slowest link; numerically the transform is quantize ->
dequantize with the residual carried to the next step (error feedback),
which is what is implemented here, as in the reference.

On a live mesh each rank compresses its block of the summed gradient: a
row's scale is the |max| over the whole row, all-reduced with `max` over
the mesh axes that split the last dim (exact), and whether a leaf passes
through is read from the whole leaf's size, so a rank's codes, scales and
residual are the one-device ones for its block, bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import all_reduce
from repro_torch.optim.tree import leaves, rebuild


def quantize_int8(g: torch.Tensor, mesh=None,
                  row_axes: tuple[str, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last dim) symmetric int8; rounds half to even, as
    `jnp.round` does.  `row_axes`: the axes of `mesh` that split the last
    dim, over which each row's |max| is taken."""
    absmax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    for axis in row_axes:
        absmax = all_reduce(absmax, mesh, axis, op="max")
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(g: torch.Tensor, ef: torch.Tensor, *, mesh=None,
                row_axes: tuple[str, ...] = (),
                numel: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one fp32 tensor: (the dequantized
    gradient, the new residual).  Scalars and tensors under 128 elements
    pass through.  On a live mesh `g` is this rank's block of a leaf of
    `numel` elements whose last dim `row_axes` split."""
    if g.ndim == 0 or (g.numel() if numel is None else numel) < 128:
        return g, ef
    corrected = g + ef
    q, scale = quantize_int8(corrected, mesh, row_axes)
    deq = dequantize_int8(q, scale)
    return deq, corrected - deq


def ef_compress_tree(grads, ef_tree):
    outs = [ef_compress(g, e) for g, e in zip(leaves(grads), leaves(ef_tree))]
    return (rebuild(grads, [o[0] for o in outs]),
            rebuild(grads, [o[1] for o in outs]))


def compressed_bytes(tree) -> int:
    """Wire bytes if the tree crossed a link int8-compressed."""
    total = 0
    for leaf in leaves(tree):
        if leaf.ndim == 0 or leaf.numel() < 128:
            total += leaf.numel() * 4
        else:
            rows = leaf.numel() // leaf.shape[-1]
            total += leaf.numel() + rows * 4  # int8 payload + fp32 scales
    return total
